"""signalfd emulation: virtual signals delivered as a readable descriptor.

The reference models signals through its pth substrate (rpth's signal
handling) and the process_emu layer; in the split-process design a signal
raised inside the simulation (raise()/kill() on the virtual pid) is routed
by the shim to the simulator, which queues it for the process — signalfd(2)
semantics for the subset Tor-class event loops use (block the signal, put
the signalfd in epoll, read 128-byte signalfd_siginfo records):

* each descriptor carries a signal-number mask;
* a blocked pending signal is ONE process-wide instance: EVERY open
  signalfd whose mask matches becomes readable, and the FIRST read (from
  any of them) consumes the shared instance — after which the others stop
  being readable (unless more pending signals match them).  Two epoll loops
  watching signalfds with overlapping masks therefore both wake, and
  exactly one wins the read — the kernel's behavior;
* standard signals (1-31) coalesce to one pending instance; real-time
  signals (>= 32) queue each raise.

Records are 128-byte signalfd_siginfo structs with ssi_signo filled and
the sender fields zero (the only in-sim senders are the process itself and
the simulator).
"""

from __future__ import annotations

import struct
from collections import deque
from typing import Optional

from .base import Descriptor, S_READABLE

SIGINFO_SIZE = 128


class SharedSignalPending:
    """The per-process pending-signal store every signalfd of the process
    shares (the kernel's per-process pending set).  Owns the routing:
    deliver() marks ALL matching fds readable; consume() pops the first
    instance matching the reading fd's mask and refreshes every sibling's
    readable bit."""

    def __init__(self):
        self.pending: deque = deque()
        self.fds: list = []

    def register(self, fd: "SignalFD") -> None:
        self.fds.append(fd)
        # signalfd(2) reports already-pending signals immediately: a fd
        # opened while a matching signal sits in the process pending set is
        # readable from the start
        if any(fd.matches(p) for p in self.pending):
            fd.adjust_status(S_READABLE, True)

    def _live(self) -> list:
        live = [s for s in self.fds if not s.closed]
        self.fds = live
        return live

    def deliver(self, signo: int) -> int:
        """Queue one pending instance and wake every matching signalfd.
        Returns the number of matching fds (0 = caller falls back to its
        recorded handler)."""
        matched = [s for s in self._live() if s.matches(signo)]
        if not matched:
            return 0
        if not (signo < 32 and signo in self.pending):
            self.pending.append(signo)   # standard signals coalesce
        # mark matched fds readable even on the coalesced path: a fd opened
        # between the original raise and this one must still wake
        for s in matched:
            s.adjust_status(S_READABLE, True)
        return len(matched)

    def consume(self, fd: "SignalFD") -> Optional[int]:
        """First read wins: pop the oldest pending signal matching ``fd``'s
        mask, then recompute every sibling's readable status against what
        remains pending."""
        signo = None
        for i, s in enumerate(self.pending):
            if fd.matches(s):
                signo = s
                del self.pending[i]
                break
        if signo is None:
            return None
        for s in self._live():
            s.adjust_status(
                S_READABLE, any(s.matches(p) for p in self.pending))
        return signo


class SignalFD(Descriptor):
    def __init__(self, host, handle: int, mask: int,
                 shared: Optional[SharedSignalPending] = None):
        super().__init__(host, handle, "signalfd")
        self.mask = int(mask)          # bit (signo-1) set = in mask
        # standalone fallback queue (direct constructions without a
        # process-shared store keep the old single-fd behavior)
        self.pending: deque = deque()
        self.shared = shared
        if shared is not None:
            shared.register(self)

    def matches(self, signo: int) -> bool:
        return 1 <= signo <= 64 and bool(self.mask >> (signo - 1) & 1)

    def deliver(self, signo: int) -> bool:
        if self.closed or not self.matches(signo):
            return False
        if self.shared is not None:
            # process-shared routing: deliver through the store so every
            # matching sibling wakes too
            return self.shared.deliver(signo) > 0
        # standard signals (1-31) coalesce: the kernel keeps ONE pending
        # instance per signal, so a second raise before the first read is
        # invisible; real-time signals (>=32) queue each instance
        if signo < 32 and signo in self.pending:
            return True
        self.pending.append(signo)
        self.adjust_status(S_READABLE, True)
        return True

    def read_siginfo(self) -> Optional[bytes]:
        if self.shared is not None:
            signo = self.shared.consume(self)
            if signo is None:
                return None
        else:
            if not self.pending:
                return None
            signo = self.pending.popleft()
            if not self.pending:
                self.adjust_status(S_READABLE, False)
        # struct signalfd_siginfo: u32 ssi_signo, s32 ssi_errno, s32
        # ssi_code, then ids/addresses we zero-fill, padded to 128 bytes
        return struct.pack("<Iii", signo, 0, 0).ljust(SIGINFO_SIZE, b"\0")
