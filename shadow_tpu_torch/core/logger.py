"""Simulation logger: sim-time-stamped records, async buffered, round-flushed.

Capability parity with the reference's ShadowLogger pipeline
(core/logger/shadow_logger.c): records carry BOTH wall-clock and simulated
time; producers append to per-thread buffers; a flush (invoked by the engine
at round boundaries, slave.c:445-450) sorts records by (sim_time, thread) and
emits them, so multi-threaded runs produce stable, comparable logs.  The
determinism test (tests/test_determinism.py) diffs these logs between two
identically-seeded runs, exactly like the reference's
determinism*_compare.cmake + strip_log_for_compare.py gate.
"""

from __future__ import annotations

import sys
import threading
import time as _walltime
from typing import List, Optional, TextIO, Tuple

LEVELS = {"error": 0, "critical": 1, "warning": 2, "message": 3, "info": 4,
          "debug": 5, "trace": 6}


class LogRecord:
    __slots__ = ("sim_time", "wall_time", "thread", "level", "domain", "text")

    def __init__(self, sim_time, wall_time, thread, level, domain, text):
        self.sim_time = sim_time
        self.wall_time = wall_time
        self.thread = thread
        self.level = level
        self.domain = domain
        self.text = text

    def format(self) -> str:
        if self.sim_time is None or self.sim_time < 0:
            st = "n/a"
        else:
            secs, ns = divmod(self.sim_time, 1_000_000_000)
            h, rem = divmod(secs, 3600)
            m, s = divmod(rem, 60)
            st = f"{h:02d}:{m:02d}:{s:02d}.{ns:09d}"
        return f"{self.wall_time:.6f} [{self.thread}] {st} [{self.level}] [{self.domain}] {self.text}"


class SimLogger:
    def __init__(self, stream: Optional[TextIO] = None, level: str = "message",
                 buffered: bool = True):
        self.stream = stream if stream is not None else sys.stderr
        self.level = LEVELS.get(level, 3)
        self.buffered = buffered
        self._lock = threading.Lock()
        self._records: List[LogRecord] = []
        self._start = _walltime.monotonic()

    def set_level(self, level: str) -> None:
        self.level = LEVELS.get(level, 3)

    def would_log(self, level: str) -> bool:
        return LEVELS.get(level, 3) <= self.level

    def log(self, level: str, domain: str, text: str, sim_time: Optional[int] = None,
            thread: Optional[str] = None) -> None:
        if LEVELS.get(level, 3) > self.level:
            return
        if sim_time is None:
            # Pull the worker clock if one is active on this thread.
            from . import worker as _worker_mod
            w = _worker_mod.current_worker()
            sim_time = w.now if w is not None else -1
        rec = LogRecord(sim_time, _walltime.monotonic() - self._start,
                        thread or threading.current_thread().name, level, domain, text)
        if self.buffered:
            with self._lock:
                self._records.append(rec)
        else:
            with self._lock:
                self.stream.write(rec.format() + "\n")

    def pending(self) -> int:
        """Buffered record count — the round loop's dirty check (ISSUE 10
        compacted flush): a quiet round skips the flush entirely on one
        attribute read.  Unlocked on purpose: a record appended during the
        read is flushed one round later, which the sort-by-sim-time output
        contract is indifferent to."""
        return len(self._records)

    def flush(self) -> None:
        """Sort buffered records by (sim_time, thread) and emit (reference
        logger helper sorts by time then thread, logger_helper.c).  Free
        when nothing is buffered — the engine calls this once per round."""
        if not self._records:
            return
        with self._lock:
            records, self._records = self._records, []
        records.sort(key=lambda r: (r.sim_time if r.sim_time is not None else -1, r.thread))
        with self._lock:
            for r in records:
                self.stream.write(r.format() + "\n")
            try:
                self.stream.flush()
            except Exception:
                pass

    # Convenience levels
    def error(self, domain, text, **kw):   self.log("error", domain, text, **kw)
    def warning(self, domain, text, **kw): self.log("warning", domain, text, **kw)
    def message(self, domain, text, **kw): self.log("message", domain, text, **kw)
    def info(self, domain, text, **kw):    self.log("info", domain, text, **kw)
    def debug(self, domain, text, **kw):   self.log("debug", domain, text, **kw)


_default: Optional[SimLogger] = None

# Fleet lanes (ISSUE 18) run one engine per THREAD in a shared process;
# the process-global default would interleave every lane's records into
# one stream (and one lane's log_tail would leak into another's fuzz
# verdict).  A thread sets its own logger here and get_logger() prefers
# it — the process-global behavior is unchanged for every existing
# single-engine caller.
_tls = threading.local()


def get_logger() -> SimLogger:
    overlay = getattr(_tls, "logger", None)
    if overlay is not None:
        return overlay
    global _default
    if _default is None:
        _default = SimLogger()
    return _default


def set_logger(logger: SimLogger) -> None:
    global _default
    _default = logger


def set_thread_logger(logger: Optional[SimLogger]) -> None:
    """Route this THREAD's get_logger() to ``logger`` (None clears the
    overlay, falling back to the process-global default)."""
    _tls.logger = logger
