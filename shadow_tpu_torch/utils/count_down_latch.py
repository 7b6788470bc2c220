"""CountDownLatch — the round-barrier primitive.

Same semantics as the reference's mutex+condvar latch
(utility/count_down_latch.c:12-17): N parties count down; waiters release
when the count hits zero; the latch is then reset for the next round by the
coordinator.
"""

from __future__ import annotations

import threading


class CountDownLatch:
    def __init__(self, count: int):
        self._initial = count
        self._count = count
        self._generation = 0
        self._cond = threading.Condition()

    def count_down(self) -> None:
        with self._cond:
            self._count -= 1
            if self._count == 0:
                self._cond.notify_all()

    def await_(self) -> None:
        with self._cond:
            gen = self._generation
            while self._count > 0 and self._generation == gen:
                self._cond.wait()

    def count_down_await(self) -> None:
        with self._cond:
            self._count -= 1
            if self._count == 0:
                self._cond.notify_all()
                return
            gen = self._generation
            while self._count > 0 and self._generation == gen:
                self._cond.wait()

    def reset(self) -> None:
        with self._cond:
            self._count = self._initial
            self._generation += 1
