"""Retransmit tally: sacked/retransmitted/lost sequence-range bookkeeping.

Capability parity with the reference's C++ ``shadow-remora`` library
(host/descriptor/tcp_retransmit_tally.cc/.h): sorted disjoint interval sets
over the TCP sequence space with a dup-ACK-threshold-3 loss rule
(reference header :68).  Two interchangeable backends:

* :class:`NativeTally` — ctypes binding to ``libshadow_tally.so`` built from
  ``native/retransmit_tally.cc`` (``make -C native``), mirroring the
  reference's native implementation choice;
* :class:`PyTally` — pure-Python fallback with identical semantics, used
  when the shared library has not been built.

``make_tally()`` picks the native backend when available.
"""

from __future__ import annotations

import ctypes
import os
from typing import List, Tuple

_LIB = None
_LIB_TRIED = False


def _load_native():
    global _LIB, _LIB_TRIED
    if _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "native", "libshadow_tally.so")
    if not os.path.exists(path):
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    lib.tally_new.restype = ctypes.c_void_p
    lib.tally_free.argtypes = [ctypes.c_void_p]
    for name in ("tally_mark_sacked", "tally_mark_retransmitted", "tally_mark_lost"):
        getattr(lib, name).argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64]
    lib.tally_advance_una.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.tally_update_lost.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                      ctypes.c_int64, ctypes.c_int]
    lib.tally_lost_count.argtypes = [ctypes.c_void_p]
    lib.tally_lost_count.restype = ctypes.c_int
    lib.tally_get_lost.argtypes = [ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_int64), ctypes.c_int]
    lib.tally_get_lost.restype = ctypes.c_int
    lib.tally_clear_lost.argtypes = [ctypes.c_void_p]
    lib.tally_total_sacked.argtypes = [ctypes.c_void_p]
    lib.tally_total_sacked.restype = ctypes.c_int64
    lib.tally_total_lost.argtypes = [ctypes.c_void_p]
    lib.tally_total_lost.restype = ctypes.c_int64
    lib.tally_is_sacked.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64]
    lib.tally_is_sacked.restype = ctypes.c_int
    lib.tally_highest_sacked.argtypes = [ctypes.c_void_p]
    lib.tally_highest_sacked.restype = ctypes.c_int64
    _LIB = lib
    return lib


Range = Tuple[int, int]


def _insert(ranges: List[Range], b: int, e: int) -> None:
    """Merge [b,e) into a sorted disjoint list in place."""
    if b >= e:
        return
    out: List[Range] = []
    i, n = 0, len(ranges)
    while i < n and ranges[i][1] < b:
        out.append(ranges[i])
        i += 1
    while i < n and ranges[i][0] <= e:
        b = min(b, ranges[i][0])
        e = max(e, ranges[i][1])
        i += 1
    out.append((b, e))
    out.extend(ranges[i:])
    ranges[:] = out


def _subtract(ranges: List[Range], b: int, e: int) -> None:
    if b >= e:
        return
    out: List[Range] = []
    for rb, re_ in ranges:
        if re_ <= b or rb >= e:
            out.append((rb, re_))
            continue
        if rb < b:
            out.append((rb, b))
        if re_ > e:
            out.append((e, re_))
    ranges[:] = out


class PyTally:
    """Pure-Python interval-set tally (semantics == native backend)."""

    def __init__(self):
        self.sacked: List[Range] = []
        self.retransmitted: List[Range] = []
        self.lost: List[Range] = []

    def close(self) -> None:
        pass

    def mark_sacked(self, b: int, e: int) -> None:
        _insert(self.sacked, b, e)
        _subtract(self.lost, b, e)
        _subtract(self.retransmitted, b, e)

    def mark_retransmitted(self, b: int, e: int) -> None:
        _insert(self.retransmitted, b, e)
        _subtract(self.lost, b, e)

    def mark_lost(self, b: int, e: int) -> None:
        _insert(self.lost, b, e)
        _subtract(self.retransmitted, b, e)
        for rb, re_ in self.sacked:
            _subtract(self.lost, rb, re_)

    def advance_una(self, una: int) -> None:
        lo = -(1 << 62)
        _subtract(self.sacked, lo, una)
        _subtract(self.retransmitted, lo, una)
        _subtract(self.lost, lo, una)

    def update_lost(self, una: int, nxt: int, dup_acks: int) -> None:
        """Dup-ACK >= 3: [una, highest_sacked) minus sacked minus
        retransmitted becomes lost (reference tally semantics, threshold
        tcp_retransmit_tally.h:68)."""
        if dup_acks < 3 or not self.sacked:
            return
        hi = self.sacked[-1][1]
        if hi <= una:
            return
        gap: List[Range] = [(una, hi)]
        for rb, re_ in self.sacked:
            _subtract(gap, rb, re_)
        for rb, re_ in self.retransmitted:
            _subtract(gap, rb, re_)
        for rb, re_ in gap:
            _insert(self.lost, rb, re_)

    def lost_ranges(self) -> List[Range]:
        return list(self.lost)

    def clear_lost(self) -> None:
        self.lost = []

    def total_sacked(self) -> int:
        return sum(e - b for b, e in self.sacked)

    def total_lost(self) -> int:
        return sum(e - b for b, e in self.lost)

    def is_sacked(self, b: int, e: int) -> bool:
        return any(rb <= b and e <= re_ for rb, re_ in self.sacked)

    def highest_sacked(self) -> int:
        return self.sacked[-1][1] if self.sacked else -1


class NativeTally:
    """ctypes front-end to native/retransmit_tally.cc."""

    __slots__ = ("_h", "_lib")

    def __init__(self, lib):
        self._lib = lib
        self._h = lib.tally_new()

    def close(self) -> None:
        if self._h:
            self._lib.tally_free(self._h)
            self._h = None

    __del__ = close

    # All entry points are no-ops on a closed handle: teardown can race with
    # late ACK processing in the same event (use-after-free guard).
    def mark_sacked(self, b: int, e: int) -> None:
        if self._h:
            self._lib.tally_mark_sacked(self._h, b, e)

    def mark_retransmitted(self, b: int, e: int) -> None:
        if self._h:
            self._lib.tally_mark_retransmitted(self._h, b, e)

    def mark_lost(self, b: int, e: int) -> None:
        if self._h:
            self._lib.tally_mark_lost(self._h, b, e)

    def advance_una(self, una: int) -> None:
        if self._h:
            self._lib.tally_advance_una(self._h, una)

    def update_lost(self, una: int, nxt: int, dup_acks: int) -> None:
        if self._h:
            self._lib.tally_update_lost(self._h, una, nxt, dup_acks)

    def lost_ranges(self) -> List[Range]:
        if not self._h:
            return []
        n = self._lib.tally_lost_count(self._h)
        if n == 0:
            return []
        buf = (ctypes.c_int64 * (2 * n))()
        got = self._lib.tally_get_lost(self._h, buf, n)
        return [(buf[2 * i], buf[2 * i + 1]) for i in range(got)]

    def clear_lost(self) -> None:
        if self._h:
            self._lib.tally_clear_lost(self._h)

    def total_sacked(self) -> int:
        return self._lib.tally_total_sacked(self._h) if self._h else 0

    def total_lost(self) -> int:
        return self._lib.tally_total_lost(self._h) if self._h else 0

    def is_sacked(self, b: int, e: int) -> bool:
        return bool(self._lib.tally_is_sacked(self._h, b, e)) if self._h else False

    def highest_sacked(self) -> int:
        return self._lib.tally_highest_sacked(self._h) if self._h else -1


def make_tally():
    lib = _load_native()
    if lib is not None:
        return NativeTally(lib)
    return PyTally()


def native_available() -> bool:
    return _load_native() is not None
