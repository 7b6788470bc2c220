"""timerfd emulation backed by scheduled tasks (reference
host/descriptor/timer.c): settable one-shot/periodic expiration, readable
when expirations are pending, read() returns-and-clears the expiration
count."""

from __future__ import annotations

from ..core.task import Task
from .base import Descriptor, S_READABLE
from ..core.worker import current_worker


class Timer(Descriptor):
    def __init__(self, host, handle: int):
        super().__init__(host, handle, "timer")
        self.expire_count = 0
        self.interval_ns = 0
        self.next_expire_time = -1
        self._generation = 0  # invalidates stale scheduled tasks on re-arm

    def arm(self, initial_ns: int, interval_ns: int = 0) -> None:
        """timerfd_settime: initial_ns relative; 0 disarms."""
        self._generation += 1
        self.interval_ns = interval_ns
        if initial_ns <= 0:
            self.next_expire_time = -1
            return
        w = current_worker()
        now = w.now if w is not None else 0
        self.next_expire_time = now + initial_ns
        if w is not None:
            w.schedule_task(Task(_timer_expire_task, self, self._generation,
                                 name="timer_expire"),
                            initial_ns, dst_host=self.host)

    def disarm(self) -> None:
        self.arm(0)

    def _on_expire(self, generation: int) -> None:
        if generation != self._generation or self.closed:
            return
        self.expire_count += 1
        self.adjust_status(S_READABLE, True)
        if self.interval_ns > 0:
            w = current_worker()
            if w is not None:
                self.next_expire_time = w.now + self.interval_ns
                w.schedule_task(Task(_timer_expire_task, self, self._generation,
                                     name="timer_expire"),
                                self.interval_ns, dst_host=self.host)

    def read_expirations(self) -> int:
        n = self.expire_count
        self.expire_count = 0
        self.adjust_status(S_READABLE, False)
        return n


def _timer_expire_task(timer: Timer, generation: int) -> None:
    timer._on_expire(generation)
