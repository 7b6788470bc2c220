"""Chunked FIFO byte buffer (reference utility/byte_queue.c)."""

from __future__ import annotations

from collections import deque


class ByteQueue:
    def __init__(self):
        self._chunks: deque = deque()
        self._len = 0

    def __len__(self) -> int:
        return self._len

    def push(self, data: bytes) -> None:
        if data:
            self._chunks.append(bytes(data))
            self._len += len(data)

    def pop(self, nbytes: int) -> bytes:
        if nbytes <= 0 or self._len == 0:
            return b""
        out = bytearray()
        while self._chunks and len(out) < nbytes:
            chunk = self._chunks[0]
            take = nbytes - len(out)
            if len(chunk) <= take:
                out += chunk
                self._chunks.popleft()
            else:
                out += chunk[:take]
                self._chunks[0] = chunk[take:]
        self._len -= len(out)
        return bytes(out)

    def peek(self, nbytes: int) -> bytes:
        out = bytearray()
        for chunk in self._chunks:
            if len(out) >= nbytes:
                break
            out += chunk[:nbytes - len(out)]
        return bytes(out)
