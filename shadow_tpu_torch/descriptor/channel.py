"""Channel: pipes and socketpairs as linked in-memory byte queues
(reference host/descriptor/channel.c + utility/byte_queue.c)."""

from __future__ import annotations

from ..utils.byte_queue import ByteQueue
from .base import S_READABLE, S_WRITABLE, Transport


class Channel(Transport):
    """One end of a pipe/socketpair.  ``link`` joins two ends; writes to one
    end land in the other's read buffer."""

    def __init__(self, host, handle: int, writable: bool = True,
                 readable: bool = True, buffer_size: int = 65536):
        super().__init__(host, handle, "pipe")
        self.buffer = ByteQueue()
        self.buffer_size = buffer_size
        self.linked: "Channel" = None
        self.can_read = readable
        self.can_write = writable
        self.adjust_status(S_WRITABLE if writable else 0, True)

    @staticmethod
    def new_pipe(host, read_handle: int, write_handle: int):
        r = Channel(host, read_handle, writable=False, readable=True)
        w = Channel(host, write_handle, writable=True, readable=False)
        r.linked = w
        w.linked = r
        return r, w

    @staticmethod
    def new_socketpair(host, handle_a: int, handle_b: int):
        a = Channel(host, handle_a)
        b = Channel(host, handle_b)
        a.linked = b
        b.linked = a
        return a, b

    def send_user_data(self, data: bytes, dst_ip: int = 0, dst_port: int = 0) -> int:
        if not self.can_write or self.linked is None or self.linked.closed:
            raise BrokenPipeError("EPIPE")
        peer = self.linked
        space = peer.buffer_size - len(peer.buffer)
        if space <= 0:
            return 0  # EWOULDBLOCK
        chunk = data[:space]
        peer.buffer.push(chunk)
        peer.adjust_status(S_READABLE, True)
        if len(peer.buffer) >= peer.buffer_size:
            self.adjust_status(S_WRITABLE, False)
        return len(chunk)

    def receive_user_data(self, nbytes: int):
        if not self.can_read:
            raise OSError("EBADF: read end only")
        data = self.buffer.pop(nbytes)
        if not data:
            if self.linked is None or self.linked.closed:
                return b"", 0, 0  # EOF
            return None  # EWOULDBLOCK
        if len(self.buffer) == 0:
            self.adjust_status(S_READABLE, False)
        if self.linked is not None:
            self.linked.adjust_status(S_WRITABLE, True)
        return data, 0, 0

    def close(self) -> None:
        if self.linked is not None and not self.linked.closed:
            # peer sees EOF (readable with empty buffer) / EPIPE
            self.linked.adjust_status(S_READABLE, True)
        super().close()
