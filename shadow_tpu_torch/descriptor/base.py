"""Descriptor object model: the virtual-kernel side of file descriptors.

Mirrors the reference's single-inheritance C hierarchy
(host/descriptor/descriptor.h:14-59 base with status bits + epoll listener
set; transport.h:16-42 send/recv vtable; socket.h:20-78 buffers + binding):

    Descriptor -> Transport -> Socket -> {TCP, UDP}
    Descriptor -> {Epoll, Timer, Channel(pipe)}

Status bits drive everything: when a descriptor's READABLE/WRITABLE set
changes, listeners (epoll instances and blocked green threads) are notified,
which is what resumes virtual processes (descriptor_adjustStatus -> epoll
notify -> process_continue in the reference).
"""

from __future__ import annotations

from collections import deque
from typing import Callable, List, Optional, Set

# >>> simgen:begin region=status-bits spec=293c930bb679 body=dab61b8b2aea
# Status bits (reference descriptor.h DS_*).
S_NONE = 0
S_ACTIVE = 1
S_READABLE = 2
S_WRITABLE = 4
S_CLOSED = 8
# <<< simgen:end region=status-bits


class Descriptor:
    # the C plane a descriptor's state lives in — always None for Python
    # descriptors; NativeSocket (duck-typed, not a subclass) carries the
    # real plane.  Class-level so process._dispatch's native-block routing
    # reads it as a plain attribute on every blocking syscall.
    plane = None

    def __init__(self, host, handle: int, kind: str):
        self.host = host
        self.handle = handle
        self.kind = kind          # "tcp"/"udp"/"epoll"/"timer"/"pipe"...
        self.status = S_NONE
        self._listeners: List[Callable[["Descriptor", int], None]] = []
        self.closed = False

    # -- status ------------------------------------------------------------
    def adjust_status(self, bits: int, on: bool) -> None:
        old = self.status
        if on:
            self.status |= bits
        else:
            self.status &= ~bits
        changed = old ^ self.status
        if changed:
            for listener in list(self._listeners):
                listener(self, changed)

    def has_status(self, bits: int) -> bool:
        return (self.status & bits) == bits

    def add_listener(self, cb: Callable[["Descriptor", int], None]) -> None:
        if cb not in self._listeners:
            self._listeners.append(cb)

    def remove_listener(self, cb) -> None:
        if cb in self._listeners:
            self._listeners.remove(cb)

    # -- lifecycle ---------------------------------------------------------
    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        self.adjust_status(S_ACTIVE | S_READABLE | S_WRITABLE, False)
        self.adjust_status(S_CLOSED, True)
        if self.host is not None:
            self.host.descriptor_table_remove(self.handle)

    def __repr__(self) -> str:  # pragma: no cover
        return f"{type(self).__name__}(fd={self.handle})"


class Transport(Descriptor):
    """send/recv vtable layer (transport.c)."""

    def send_user_data(self, data: bytes, dst_ip: int = 0, dst_port: int = 0) -> int:
        raise NotImplementedError

    def receive_user_data(self, nbytes: int):
        """Returns (data, src_ip, src_port) or None if nothing available."""
        raise NotImplementedError


class Socket(Transport):
    """Buffers + naming common to TCP/UDP (socket.c/.h).

    Packet queues carry simulated Packets; byte accounting throttles against
    configured buffer sizes.  ``peek/pull_out_packet`` feed the interface
    send loop; ``push_in_packet`` is the arrival entry point.
    """

    def __init__(self, host, handle: int, kind: str, recv_buf_size: int,
                 send_buf_size: int):
        super().__init__(host, handle, kind)
        self.recv_buf_size = recv_buf_size
        self.send_buf_size = send_buf_size
        self.in_packets: deque = deque()
        self.in_bytes = 0
        self.out_packets: deque = deque()
        self.out_bytes = 0
        # naming
        self.bound_ip: Optional[int] = None
        self.bound_port: Optional[int] = None
        self.peer_ip: Optional[int] = None
        self.peer_port: Optional[int] = None
        self.unix_path: Optional[str] = None
        # (iface, binding-key) pairs maintained by NetworkInterface.associate
        self._associations: List[tuple] = []
        self.adjust_status(S_ACTIVE, True)

    # -- naming ------------------------------------------------------------
    @property
    def is_bound(self) -> bool:
        return self.bound_port is not None

    def bind_to(self, ip: int, port: int) -> None:
        self.bound_ip = ip
        self.bound_port = port

    def release_bindings(self) -> None:
        """Drop every interface binding this socket holds (frees its ports/
        4-tuples for reuse while the descriptor may stay open)."""
        for iface, key in list(self._associations):
            iface.disassociate_key(key, self)
        self._associations.clear()

    def close(self) -> None:
        """Release every interface binding this socket holds, then close."""
        if self.closed:
            return
        self.release_bindings()
        super().close()

    # -- output queue (interface side) ------------------------------------
    def add_out_packet(self, packet) -> None:
        self.out_packets.append(packet)
        self.out_bytes += packet.total_size
        packet.add_status("SND_SOCKET_BUFFERED")

    def peek_out_packet(self):
        return self.out_packets[0] if self.out_packets else None

    def pull_out_packet(self):
        if not self.out_packets:
            return None
        p = self.out_packets.popleft()
        self.out_bytes -= p.total_size
        return p

    def has_out_space(self, nbytes: int) -> bool:
        return self.out_bytes + nbytes <= self.send_buf_size

    # -- input queue -------------------------------------------------------
    def push_in_packet(self, packet) -> None:
        raise NotImplementedError  # protocol-specific (process_packet)

    def drop_packet(self, packet) -> None:
        packet.add_status("RCV_SOCKET_DROPPED")

    def has_in_space(self, nbytes: int) -> bool:
        return self.in_bytes + nbytes <= self.recv_buf_size
