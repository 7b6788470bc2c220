"""Host CPU delay model.

Capability of the reference's CPU (host/cpu.c): converts measured wall-clock
execution time into virtual CPU delay by the ratio of the simulated host's
frequency to the machine's frequency (cpu.c:26-47), and blocks event
execution when accumulated delay exceeds a threshold (cpu_isBlocked; used by
event.c:75-84 to defer events).  Disabled when frequency == 0 or
threshold < 0 (the common configuration).
"""

from __future__ import annotations

import time as _walltime


class CPU:
    def __init__(self, frequency_khz: int, raw_frequency_khz: int,
                 threshold_ns: int, precision_ns: int):
        self.frequency_khz = frequency_khz
        self.raw_frequency_khz = raw_frequency_khz or frequency_khz or 1
        self.threshold_ns = threshold_ns
        self.precision_ns = max(1, precision_ns)
        self.now = 0
        self.time_cpu_available = 0
        self._measure_start = None

    @property
    def enabled(self) -> bool:
        return self.frequency_khz > 0 and self.threshold_ns >= 0

    def start_measurement(self) -> None:
        if self.enabled:
            self._measure_start = _walltime.perf_counter_ns()

    def stop_measurement(self) -> None:
        if self.enabled and self._measure_start is not None:
            elapsed = _walltime.perf_counter_ns() - self._measure_start
            self._measure_start = None
            self.add_delay(elapsed)

    def add_delay(self, raw_ns: int) -> None:
        """Scale measured ns by frequency ratio and round to precision."""
        if not self.enabled:
            return
        scaled = raw_ns * self.raw_frequency_khz / self.frequency_khz
        q = int(scaled / self.precision_ns) * self.precision_ns
        self.time_cpu_available += q

    def update_time(self, now: int) -> None:
        self.now = now
        if self.time_cpu_available < now:
            self.time_cpu_available = now

    def get_delay(self) -> int:
        return max(0, self.time_cpu_available - self.now)

    def is_blocked(self) -> bool:
        return self.enabled and self.get_delay() > self.threshold_ns
