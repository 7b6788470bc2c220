"""Object lifecycle counters and the shutdown leak report.

Capability of the reference's ObjectCounter (core/support/object_counter.c):
per-type new/free tallies kept per worker, merged into the engine at exit,
with a leak report if any type has new != free (slave.c:238-239).
"""

from __future__ import annotations

import threading
from collections import defaultdict
from typing import Dict


class ObjectCounter:
    def __init__(self):
        self._new: Dict[str, int] = defaultdict(int)
        self._free: Dict[str, int] = defaultdict(int)

    def count_new(self, kind: str, n: int = 1) -> None:
        self._new[kind] += n

    def count_free(self, kind: str, n: int = 1) -> None:
        self._free[kind] += n

    def merge(self, other: "ObjectCounter") -> None:
        for k, v in other._new.items():
            self._new[k] += v
        for k, v in other._free.items():
            self._free[k] += v

    def leaks(self) -> Dict[str, int]:
        out = {}
        # sorted: the leak dict reaches the metrics summary JSON and the
        # shutdown report — byte-stable output across runs (SIM003)
        for k in sorted(set(self._new) | set(self._free)):
            d = self._new[k] - self._free[k]
            if d != 0:
                out[k] = d
        return out

    def report(self) -> str:
        lines = ["object counts (new/free):"]
        for k in sorted(set(self._new) | set(self._free)):
            n, f = self._new[k], self._free[k]
            flag = "" if n == f else "  <-- LEAK"
            lines.append(f"  {k:<16} {n:>10} / {f:>10}{flag}")
        return "\n".join(lines)

    def summary(self) -> Dict[str, object]:
        """The shutdown report in metrics-summary form (obs/metrics.py):
        the leak map plus per-type [new, free] pairs — the SAME numbers
        report() formats for the log, so the two surfaces cannot drift."""
        return {
            "object_leaks": dict(self.leaks()),
            "object_counts": {k: [self._new[k], self._free[k]]
                              for k in sorted(set(self._new)
                                              | set(self._free))},
        }
