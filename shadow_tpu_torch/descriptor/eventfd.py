"""eventfd emulation: a 64-bit counter descriptor.

Reference analog: the reference's interposer forwards eventfd to the
kernel because its plugins share one OS process; in the split-process
design every fd an app can epoll on must be a simulator descriptor, so
eventfd is modeled here with kernel semantics (eventfd(2)):

* the object is a uint64 counter;
* write(8 bytes LE) adds to the counter; blocks (or EAGAIN) if the sum
  would exceed 0xFFFFFFFFFFFFFFFE;
* read(8 bytes) returns-and-resets the counter (or decrements by one in
  EFD_SEMAPHORE mode); blocks (or EAGAIN) at zero;
* readable iff counter > 0; writable iff counter < max.

This is the thread-pool wakeup primitive Tor-class binaries (libevent)
put in their epoll sets — the dual-execution torserver scenario drives it
(tests/native_src/testapp.c).
"""

from __future__ import annotations

from typing import Optional

from .base import Descriptor, S_READABLE, S_WRITABLE

EFD_MAX = 0xFFFFFFFFFFFFFFFE


class EventFD(Descriptor):
    def __init__(self, host, handle: int, initval: int = 0,
                 semaphore: bool = False):
        super().__init__(host, handle, "eventfd")
        self.counter = int(initval) & 0xFFFFFFFFFFFFFFFF
        self.semaphore = semaphore
        self.adjust_status(S_WRITABLE, True)
        if self.counter > 0:
            self.adjust_status(S_READABLE, True)

    def read_value(self) -> Optional[int]:
        """One read(2): the value to return, or None if it would block."""
        if self.counter == 0:
            return None
        val = 1 if self.semaphore else self.counter
        self.counter -= val
        if self.counter == 0:
            self.adjust_status(S_READABLE, False)
        self.adjust_status(S_WRITABLE, True)
        return val

    def write_value(self, val: int):
        """One write(2): True if accepted, False if it would block,
        None for EINVAL (value 0xFFFFFFFFFFFFFFFF is never writable —
        eventfd(2)).  S_WRITABLE stays asserted while counter < max
        (kernel POLLOUT semantics: a write of 1 would succeed) — a
        blocked LARGE write therefore can't wait on the status bit; the
        RPC layer retries it on a virtual-time tick instead."""
        val = int(val)
        if val < 0 or val > EFD_MAX:
            return None
        if self.counter + val > EFD_MAX:
            return False
        if val:
            self.counter += val
            self.adjust_status(S_READABLE, True)
            if self.counter >= EFD_MAX:
                self.adjust_status(S_WRITABLE, False)
        return True
