"""Unified metrics registry: counters/gauges/histograms/sources, scraped on
a round cadence to JSONL plus a final summary.

One registry per run (module-global, installed like the logger).  Existing
telemetry becomes *sources* instead of keeping its own format:

* ``core/counters.py`` ObjectCounter — per-type new/free tallies + the
  shutdown leak report land in the final summary (``object_leaks``);
* ``core/supervision.py`` SupervisionStats — watchdog fires/recoveries;
* ``host/tracker.py`` heartbeats — the SAME values the legacy
  ``[shadow-heartbeat]`` log line carries (the line keeps printing, and
  tools/plot_log.py keeps scraping it; the registry aggregates);
* ``core/engine.py`` ``[engine-heartbeat]`` getrusage lines — ditto;
* the device plane + tpu policy phase timings (``flush_sec``,
  ``device_wait_sec``, ``pipeline_overlap_sec``) — bench.py reads these
  from ``scrape()`` instead of re-deriving them with ad-hoc timers.

``enabled`` gates only the per-event recording paths (heartbeat capture,
profiler observes); registration and :meth:`scrape` always work, so tools
can read phase timings from a run that never wrote a metrics file.

Thread safety (simrace's first customer, ISSUE 5): the registry is
scraped from the engine loop but its instruments are incremented from
watchdog helper threads (the dispatch-collect guard), worker threads
(spans/heartbeats on threaded schedulers) and supervision recovery
paths.  ONE registry RLock covers instrument mutation, instrument
creation, heartbeat capture and the scrape snapshot, so a scrape never
reads a histogram mid-update and concurrent ``inc()`` never loses
counts (tests/test_concurrency_stress.py hammers exactly this).
Reentrant because a gauge/source callable read under the scrape lock
may itself touch the registry.
"""

from __future__ import annotations

import json
import threading
import time as _walltime
from typing import Callable, Dict, List, Optional


class Counter:
    """Monotonic count (thread-safe under the registry lock)."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str, lock: Optional[threading.RLock] = None):
        self.name = name
        self.value = 0
        self._lock = lock if lock is not None else threading.RLock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.value += n


class Gauge:
    """Point-in-time value: either ``set()`` or a callable read at scrape."""

    __slots__ = ("name", "value", "fn", "_lock")

    def __init__(self, name: str, fn: Optional[Callable] = None,
                 lock: Optional[threading.RLock] = None):
        self.name = name
        self.value = 0
        self.fn = fn
        self._lock = lock if lock is not None else threading.RLock()

    def set(self, v) -> None:
        with self._lock:
            self.value = v

    def read(self):
        if self.fn is not None:
            return self.fn()
        with self._lock:
            return self.value


class Histogram:
    """Streaming distribution: count/sum/min/max + power-of-two buckets
    (bucket key k counts observations in [2^k, 2^(k+1)); everything below
    1 — sub-unit fractions, zero, negatives — lands in bucket key -1, so
    pick units that put interesting values above 1, e.g. microseconds).
    Enough to read latency tails without per-observation storage.

    The final snapshot additionally estimates p50/p95/p99 (ISSUE 15):
    linear interpolation inside the covering power-of-two bucket,
    clamped to the observed [min, max] — quantization error is bounded
    by the bucket width (a factor of two), which is exactly the
    resolution the tails are read at."""

    __slots__ = ("name", "count", "total", "min", "max", "buckets",
                 "_lock")

    def __init__(self, name: str, lock: Optional[threading.RLock] = None):
        self.name = name
        self.count = 0
        self.total = 0.0
        self.min = None
        self.max = None
        self.buckets: Dict[int, int] = {}
        self._lock = lock if lock is not None else threading.RLock()

    def observe(self, v: float) -> None:
        with self._lock:
            self.count += 1
            self.total += v
            if self.min is None or v < self.min:
                self.min = v
            if self.max is None or v > self.max:
                self.max = v
            k = -1 if v < 1 else int(v).bit_length() - 1
            self.buckets[k] = self.buckets.get(k, 0) + 1

    def _quantile_locked(self, q: float) -> float:
        """Estimate quantile ``q`` from the power-of-two buckets (lock
        held): walk the cumulative counts to the covering bucket,
        interpolate linearly inside it, clamp to observed [min, max]."""
        target = q * self.count
        run = 0
        for k, n in sorted(self.buckets.items()):
            run += n
            if run >= target:
                lo = 0.0 if k < 0 else float(2 ** k)
                hi = 1.0 if k < 0 else float(2 ** (k + 1))
                frac = 1.0 - (run - target) / n
                v = lo + (hi - lo) * frac
                return min(max(v, self.min), self.max)
        return self.max

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            if not self.count:
                return {"count": 0}
            return {"count": self.count, "sum": self.total,
                    "min": self.min, "max": self.max,
                    "mean": self.total / self.count,
                    # percentile summaries (ISSUE 15): the tail columns
                    # trace_report --metrics prints; schema pinned by
                    # tests/test_simprof.py
                    "p50": round(self._quantile_locked(0.50), 3),
                    "p95": round(self._quantile_locked(0.95), 3),
                    "p99": round(self._quantile_locked(0.99), 3),
                    "buckets": {str(k): v
                                for k, v in sorted(self.buckets.items())}}


class MetricsRegistry:
    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        # ONE reentrant lock shared by every instrument (see the module
        # docstring): scrape holds it across the whole instrument
        # snapshot, so a single scrape record is internally consistent
        self._lock = threading.RLock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._sources: Dict[str, Callable[[], Dict]] = {}
        self._host_hb: Dict[str, Dict] = {}     # host -> last heartbeat vals
        self._engine_hb: Dict = {}              # last engine heartbeat vals
        self._summary_info: Dict = {}           # summary-only payloads

    # -- instrument construction (idempotent by name) ----------------------
    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name, self._lock)
            return c

    def gauge(self, name: str, fn: Optional[Callable] = None) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(name, fn, self._lock)
            elif fn is not None:
                g.fn = fn
            return g

    def histogram(self, name: str) -> Histogram:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram(name, self._lock)
            return h

    def source(self, name: str, fn: Callable[[], Dict]) -> None:
        """Register a scrape-time provider returning {metric: value};
        later registrations under one name replace earlier ones (a re-run
        engine re-registers cleanly)."""
        with self._lock:
            self._sources[name] = fn

    # -- heartbeat promotion (the legacy log lines' values, shared) --------
    def record_host_heartbeat(self, host_name: str, vals: Dict) -> None:
        """Tracker heartbeat: store the SAME dict the log line was formatted
        from.  Scrape aggregates across hosts (sums), so a 10k-host run
        scrapes a handful of totals, not 10k series."""
        if not self.enabled:
            return
        with self._lock:
            self._host_hb[host_name] = vals

    def record_engine_heartbeat(self, vals: Dict) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._engine_hb = vals

    def set_summary_info(self, key: str, value) -> None:
        """Attach a summary-only payload (e.g. the ObjectCounter leak
        report) emitted with the final summary record."""
        with self._lock:
            self._summary_info[key] = value

    # -- scraping ----------------------------------------------------------
    def scrape(self) -> Dict:
        """One flat {metric: value} snapshot (histograms expand to nested
        dicts).  Works whether or not the registry is enabled."""
        # sorted everywhere: instrument registration order differs between
        # engine configurations, and the scrape reaches user-visible JSONL
        # — explicit ordering keeps reports byte-stable across runs.
        # The registry lock is held across the whole snapshot (reentrant:
        # gauge fns / sources read back through it), so one scrape record
        # is internally consistent even under concurrent increments.
        out: Dict = {}
        with self._lock:
            for name, c in sorted(self._counters.items()):
                out[name] = c.value
            for name, g in sorted(self._gauges.items()):
                try:
                    out[name] = g.read()
                except Exception as e:  # a broken gauge must not kill a run
                    out[name] = f"gauge_error: {e!r}"
            for name, h in sorted(self._histograms.items()):
                out[name] = h.snapshot()
            for sname, fn in sorted(self._sources.items()):
                try:
                    vals = fn() or {}
                except Exception as e:  # broken source must not kill a run
                    vals = {f"{sname}.scrape_error": repr(e)}
                out.update(vals)
            if self._host_hb:
                agg: Dict[str, int] = {}
                for vals in self._host_hb.values():
                    for k, v in vals.items():
                        if isinstance(v, (int, float)):
                            agg[k] = agg.get(k, 0) + v
                out.update({f"tracker.{k}": v
                            for k, v in sorted(agg.items())})
                out["tracker.hosts_reporting"] = len(self._host_hb)
            if self._engine_hb:
                out.update({f"engine_heartbeat.{k}": v
                            for k, v in sorted(self._engine_hb.items())})
        return out

    def summary(self) -> Dict:
        """The final-summary payload: a scrape + the summary-only info
        (leak report, supervision ledger, plane stats...).  One lock
        hold across both (reentrant into scrape) so the record cannot
        pair fresh info with a scrape from a different instant."""
        with self._lock:
            return {"metrics": self.scrape(), **dict(self._summary_info)}


class MetricsWriter:
    """JSONL writer on a round cadence: one record every ``every_rounds``
    engine rounds (0/1 = every round), plus a final ``summary`` record.
    The file is line-delimited so a crashed run still leaves every record
    written before the crash readable."""

    DEFAULT_EVERY = 50

    def __init__(self, path: str, every_rounds: int = 0):
        self.path = path
        self.every_rounds = int(every_rounds) or self.DEFAULT_EVERY
        self.records_written = 0
        self._t0 = _walltime.monotonic()
        # truncate up front so a run that crashes before the first cadence
        # point doesn't leave a stale previous run's file lying around
        with open(self.path, "w"):
            pass

    def _append(self, record: Dict) -> None:
        with open(self.path, "a") as f:
            f.write(json.dumps(record, sort_keys=True) + "\n")
        self.records_written += 1

    def maybe_write(self, registry: MetricsRegistry, rounds_done: int,
                    sim_time_ns: int) -> bool:
        if rounds_done % self.every_rounds:
            return False
        self._append({"round": rounds_done,
                      "sim_time_ns": int(sim_time_ns),
                      "wall_s": round(_walltime.monotonic() - self._t0, 6),
                      "metrics": registry.scrape()})
        return True

    def write_summary(self, registry: MetricsRegistry, rounds_done: int,
                      sim_time_ns: int) -> None:
        self._append({"summary": True,
                      "round": rounds_done,
                      "sim_time_ns": int(sim_time_ns),
                      "wall_s": round(_walltime.monotonic() - self._t0, 6),
                      **registry.summary()})


def read_metrics_file(path: str) -> List[Dict]:
    """Parse a metrics JSONL file back into records (tools/tests)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def fleet_source(fleet_plane) -> Callable[[], Dict]:
    """Scrape-time provider for the shared fleet plane (ISSUE 18).

    The ``fleet.*`` namespace an engine run as a batch lane exposes:
    ``fleet.lanes`` (peak concurrent lanes), ``fleet.lane_occupancy``
    (mean filled fraction of the batched launches), ``fleet.launches`` /
    ``fleet.lane_dispatches`` / ``fleet.launches_amortized`` (how many
    per-lane dispatches each device launch carried), and
    ``fleet.shape_classes`` / ``fleet.compiles`` (how many programs XLA
    actually built — the re-arm-without-recompile proof).  The values
    are PLANE-global (every lane of one fleet scrapes the same numbers),
    which is why the fuzz oracles' scrape filter deliberately excludes
    the namespace: it describes the co-schedule, not the scenario."""
    def _scrape() -> Dict:
        return fleet_plane.metrics()
    return _scrape


_default: Optional[MetricsRegistry] = None


def get_metrics() -> MetricsRegistry:
    global _default
    if _default is None:
        _default = MetricsRegistry(enabled=False)
    return _default


def set_metrics(registry: MetricsRegistry) -> None:
    global _default
    _default = registry
