"""Sim-time tracing: spans + instants into a bounded flight-recorder ring,
exported as Chrome trace-event JSON (Perfetto-loadable).

Every record carries BOTH clocks:

* **wall time** (``ts``/``dur``, microseconds since tracer start) — what
  Perfetto renders, and what profiling reads (dispatch latency, overlap);
* **sim time** (``args.sim_ns``) — the virtual clock, which is
  deterministic: two identically-seeded runs produce identical sim-time
  event streams (tests/test_obs.py mirrors the log-diff determinism gate
  over the trace stream, wall fields excluded).

Storage is a ring buffer per track (thread) — the flight-recorder
property: memory is bounded however long the run, and the recent past is
always available for a post-mortem.  Supervision watchdogs dump the last-N
spans on any recovery (``dump_recent``), so a fault arrives with its
timeline attached.  Sharded runs (parallel/procs.py) ``drain()`` each
shard's ring into the parent, which merges them onto per-shard tracks
(Chrome ``pid`` = shard id) and writes one file.

The disabled path returns a shared null span: one attribute check + one
no-op context manager per call site, pinned ~0 by bench.py's
``obs_overhead_sec`` column.
"""

from __future__ import annotations

import json
import threading
import time as _walltime
from collections import deque
from typing import Dict, List, Optional

DEFAULT_RING = 65536     # events kept per track (flight-recorder depth)


class _NullSpan:
    """Shared no-op context manager for the disabled path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class _Span:
    """One live span: records a Chrome 'X' (complete) event on exit."""

    __slots__ = ("_tracer", "name", "cat", "sim_ns", "args", "_t0")

    def __init__(self, tracer, name, cat, sim_ns, args):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.sim_ns = sim_ns
        self.args = args

    def __enter__(self):
        self._t0 = _walltime.perf_counter()
        return self

    def __exit__(self, *exc):
        self._tracer.complete(self.name, self.cat, self._t0,
                              _walltime.perf_counter(), self.sim_ns,
                              self.args)
        return False


class Tracer:
    def __init__(self, enabled: bool = False, path: Optional[str] = None,
                 ring: Optional[int] = None, shard_id: int = 0,
                 label: Optional[str] = None):
        self.enabled = enabled
        self.path = path
        # a zero/negative depth would make deque(maxlen=...) raise at the
        # FIRST recorded span, deep into the run — fall back to the default
        self.ring = ring if (ring and ring > 0) else DEFAULT_RING
        self.shard_id = shard_id
        # Chrome pid -> display name; foreign pids (ingested shard events)
        # default to "shard N" at export
        self.pid_labels = {shard_id: label or f"shard {shard_id}"}
        self._t0 = _walltime.perf_counter()
        self._rings: Dict[str, deque] = {}
        self._foreign: List[dict] = []    # ingested (e.g. shard) events
        self._lock = threading.Lock()
        self.dropped = 0                  # events evicted by ring bounds

    # -- recording ---------------------------------------------------------
    def _sim_now(self) -> int:
        """Fallback sim clock when the call site didn't pass one: the
        active worker's virtual time (same source the logger uses)."""
        from ..core import worker as _worker_mod
        w = _worker_mod.current_worker()
        return w.now if w is not None else -1

    def _record(self, ev: dict) -> None:
        """Append one event to its track's ring.  The lock covers the
        append so readers (events/drain/recent — notably the flight-
        recorder dump inside a supervised recovery on ANOTHER thread)
        never iterate a deque mid-mutation."""
        with self._lock:
            ring = self._rings.get(ev["tid"])
            if ring is None:
                ring = self._rings.setdefault(ev["tid"],
                                              deque(maxlen=self.ring))
            if len(ring) == ring.maxlen:
                self.dropped += 1
            ring.append(ev)

    def complete(self, name: str, cat: str, t0: float, t1: float,
                 sim_ns: Optional[int], args: Optional[dict],
                 tid: Optional[str] = None) -> None:
        """Record a finished span [t0, t1] (perf_counter seconds).
        ``tid`` overrides the track — the device plane's sim-correlated
        ``device-sim`` track (obs/profiler.py) gets its own lane in the
        merged Chrome trace instead of interleaving with the engine
        thread's round spans."""
        if sim_ns is None:
            sim_ns = self._sim_now()
        self._record({"name": name, "cat": cat, "ph": "X",
                      "ts": round((t0 - self._t0) * 1e6, 3),
                      "dur": round((t1 - t0) * 1e6, 3),
                      "pid": self.shard_id,
                      "tid": tid or threading.current_thread().name,
                      "args": dict(args, sim_ns=sim_ns) if args
                      else {"sim_ns": sim_ns}})

    def span(self, name: str, cat: str = "sim",
             sim_ns: Optional[int] = None, args: Optional[dict] = None):
        """Context manager timing a span; a shared no-op when disabled."""
        if not self.enabled:
            return NULL_SPAN
        return _Span(self, name, cat, sim_ns, args)

    def instant(self, name: str, cat: str = "sim",
                sim_ns: Optional[int] = None,
                args: Optional[dict] = None) -> None:
        if not self.enabled:
            return
        if sim_ns is None:
            sim_ns = self._sim_now()
        self._record({"name": name, "cat": cat, "ph": "i", "s": "t",
                      "ts": round((_walltime.perf_counter() - self._t0)
                                  * 1e6, 3),
                      "pid": self.shard_id,
                      "tid": threading.current_thread().name,
                      "args": dict(args, sim_ns=sim_ns) if args
                      else {"sim_ns": sim_ns}})

    # -- reading / merging -------------------------------------------------
    def _collect_locked(self) -> List[dict]:
        out: List[dict] = []
        for ring in self._rings.values():
            out.extend(ring)
        out.extend(self._foreign)
        return out

    def events(self) -> List[dict]:
        """Every buffered event (local rings + ingested), unsorted."""
        with self._lock:
            return self._collect_locked()

    def drain(self) -> List[dict]:
        """Take + clear every buffered event — the shard side of the merge
        protocol (parallel/procs.py ships these in its 'final' message)."""
        with self._lock:
            out = self._collect_locked()
            self._rings.clear()
            self._foreign = []
        return out

    @property
    def epoch(self) -> float:
        """Absolute monotonic-clock seconds of this tracer's ts=0 origin
        (perf_counter at construction).  Shipped over the procs protocol so
        the parent can align each shard's events onto ITS timeline — on
        Linux CLOCK_MONOTONIC is shared across processes, so the shift is
        exact."""
        return self._t0

    def ingest(self, events: List[dict],
               epoch: Optional[float] = None) -> None:
        """Merge another tracer's drained events (parent side: each shard's
        events arrive with their own ``pid`` and land on per-shard tracks).
        ``epoch`` is the source tracer's :attr:`epoch`; when given, event
        timestamps are re-based onto THIS tracer's origin so the merged
        file's tracks share one wall timeline (without it, each shard's
        ts=0 would be its own construction instant — seconds of skew)."""
        shift_us = 0.0 if epoch is None else (epoch - self._t0) * 1e6
        if shift_us:
            events = [dict(e, ts=round(e["ts"] + shift_us, 3))
                      for e in events]
        with self._lock:
            self._foreign.extend(events)

    def recent(self, n: int = 30) -> List[dict]:
        """The flight recorder's last-``n`` events, oldest first."""
        evs = self.events()
        evs.sort(key=lambda e: e["ts"])
        return evs[-n:]

    def dump_recent(self, domain: str, reason: str, n: int = 30) -> int:
        """Log the flight recorder's recent spans — called by supervision
        watchdogs on any recovery so the fault carries its timeline.
        Returns the number of spans dumped."""
        from ..core.logger import get_logger
        log = get_logger()
        evs = self.recent(n)
        if not evs:
            log.warning(domain,
                        f"flight recorder: no spans buffered ({reason}; "
                        "run with --trace to record timelines)")
            return 0
        log.warning(domain,
                    f"flight recorder: last {len(evs)} spans before "
                    f"recovery ({reason}):")
        for ev in evs:
            sim = ev.get("args", {}).get("sim_ns", -1)
            dur = ev.get("dur", 0.0)
            log.warning(domain,
                        f"  [flight-recorder] +{ev['ts'] / 1e3:.3f}ms "
                        f"dur={dur / 1e3:.3f}ms sim={sim / 1e9:.6f}s "
                        f"{ev['cat']}:{ev['name']} "
                        f"(shard {ev['pid']}, {ev['tid']})")
        return len(evs)

    # -- export ------------------------------------------------------------
    def chrome_events(self) -> List[dict]:
        """Chrome trace-event list: metadata (process/thread names) +
        buffered events sorted by (pid, tid, ts) — monotonic timestamps
        per track, as Perfetto expects."""
        evs = sorted(self.events(),
                     key=lambda e: (e["pid"], e["tid"], e["ts"]))
        pids = sorted({e["pid"] for e in evs})
        tracks = sorted({(e["pid"], e["tid"]) for e in evs})
        meta: List[dict] = []
        for pid in pids:
            meta.append({"name": "process_name", "ph": "M", "pid": pid,
                         "tid": "",
                         "args": {"name": self.pid_labels.get(
                             pid, f"shard {pid}")}})
        for pid, tid in tracks:
            meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                         "tid": tid, "args": {"name": tid}})
        return meta + evs

    def export(self, path: Optional[str] = None) -> Optional[str]:
        """Write the Chrome trace JSON; returns the path (None if tracing
        is disabled or no path was configured)."""
        path = path or self.path
        if not self.enabled or not path:
            return None
        blob = {
            "traceEvents": self.chrome_events(),
            "displayTimeUnit": "ms",
            "otherData": {
                "producer": "shadow-tpu flight recorder",
                "ring_per_track": self.ring,
                "events_dropped_by_ring": self.dropped,
            },
        }
        with open(path, "w") as f:
            json.dump(blob, f)
        return path


_default: Optional[Tracer] = None


def get_tracer() -> Tracer:
    global _default
    if _default is None:
        _default = Tracer(enabled=False)
    return _default


def set_tracer(tracer: Tracer) -> None:
    global _default
    _default = tracer
