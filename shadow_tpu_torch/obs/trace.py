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

Beside the rings the tracer keeps exact totals per span name (count and
seconds, :meth:`Tracer.totals`) that ring evictions never touch: a
reader of where the time went reads those, labels moments by the span
open then (:meth:`Tracer.labels_at`) and sums the seconds spans cover
(:meth:`Tracer.covered`).  While a tracer is the process's enabled
tracer, and until the run it was built for ends, it also records every
pause of the garbage collector as a ``gc`` span on the thread that
triggered it.

One tracer may serve many runs: :func:`install` makes it the process's
tracer, and every run whose options name no trace path records into it
(each thread on its own track: a fleet's lanes on ``fleet-N``) instead
of building its own.  Spans stamp ``perf_counter``, which on Linux is
``time.monotonic``'s clock (``CLOCK_MONOTONIC``): ``epoch + ts`` is a
monotonic time.

The disabled path returns a shared null span: one attribute check + one
no-op context manager per call site.
"""

from __future__ import annotations

import bisect
import gc
import json
import threading
import time as _walltime
from collections import Counter, deque
from typing import Dict, List, Optional, Tuple

DEFAULT_RING = 65536     # events kept per track (flight-recorder depth)
# spans the host stamps around the card's work (a dispatch in flight, the
# device-sim track's windows): they say what the card did, not the host,
# so they never label a moment
CARD_SPANS = frozenset(("device.inflight", "device.window"))
# the prefix of the boot's spans; the collector's time under one is
# totalled apart as GC_BOOT
BOOT = "boot."
GC_BOOT = "gc.boot"


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


class _BootSpan(_Span):
    """A ``boot.*`` span: counted open on its thread while it runs, so
    that the collector's pauses inside it are totalled apart."""

    __slots__ = ()

    def __enter__(self):
        tls = self._tracer._tls
        tls.boot = getattr(tls, "boot", 0) + 1
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._tracer._tls.boot -= 1


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
        # reentrant: the collector's hook records from inside whatever
        # allocation set it off, which may be one made under this lock
        self._lock = threading.RLock()
        self.dropped = 0                  # events evicted by ring bounds
        # name -> [count, seconds] of every span recorded, evicted or not
        self._totals: Dict[str, list] = {}
        # track -> end (us) of the latest event its ring evicted
        self._lost_until: Dict[str, float] = {}
        # per thread: open boot spans, the running collection's start
        self._tls = threading.local()

    # -- recording ---------------------------------------------------------
    def _sim_now(self) -> int:
        """Fallback sim clock when the call site didn't pass one: the
        active worker's virtual time (same source the logger uses)."""
        from ..core import worker as _worker_mod
        w = _worker_mod.current_worker()
        return w.now if w is not None else -1

    def _record(self, ev: dict) -> None:
        """Append one event to its track's ring and, for a span, add its
        seconds to its name's total.  The lock covers the append so
        readers (events/drain/recent — notably the flight-recorder dump
        inside a supervised recovery on ANOTHER thread) never iterate a
        deque mid-mutation."""
        with self._lock:
            ring = self._rings.get(ev["tid"])
            if ring is None:
                ring = self._rings.setdefault(ev["tid"],
                                              deque(maxlen=self.ring))
            if len(ring) == ring.maxlen:
                self.dropped += 1
                old = ring[0]
                self._lost_until[ev["tid"]] = max(
                    self._lost_until.get(ev["tid"], 0.0),
                    old["ts"] + old.get("dur", 0.0))
            ring.append(ev)
            if ev["ph"] == "X":
                self._add_total(ev["name"], ev["dur"] / 1e6)

    def _add_total(self, name: str, seconds: float) -> None:
        with self._lock:
            tot = self._totals.get(name)
            if tot is None:
                tot = self._totals[name] = [0, 0.0]
            tot[0] += 1
            tot[1] += seconds

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
        cls = _BootSpan if name.startswith(BOOT) else _Span
        return cls(self, name, cat, sim_ns, args)

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

    # -- the garbage collector -------------------------------------------
    def _on_gc(self, phase: str, info: dict) -> None:
        """``gc.callbacks`` hook: one ``gc`` span a collection, on the
        thread that set it off, with its generation; its seconds also go
        to GC_BOOT's total when a boot span is open on that thread."""
        tls = self._tls
        if phase == "start":
            tls.gc_t0 = _walltime.perf_counter()
            return
        t0 = getattr(tls, "gc_t0", None)
        if t0 is None:
            return              # hooked while this collection ran
        tls.gc_t0 = None
        t1 = _walltime.perf_counter()
        self.complete("gc", "gc", t0, t1, -1,
                      {"generation": info["generation"]})
        if getattr(tls, "boot", 0):
            self._add_total(GC_BOOT, t1 - t0)

    def _hook_gc(self, on: bool) -> None:
        if on and self._on_gc not in gc.callbacks:
            gc.callbacks.append(self._on_gc)
        elif not on and self._on_gc in gc.callbacks:
            gc.callbacks.remove(self._on_gc)

    def end_run(self) -> None:
        """The run this tracer was built for has ended: unless it is the
        installed tracer, it records no more of the collector's pauses
        (it stays readable, and the process's, until the next run)."""
        if installed() is not self:
            self._hook_gc(False)

    # -- totals and labels -------------------------------------------------
    def totals(self) -> Dict[str, Tuple[int, float]]:
        """(count, seconds) of every span recorded, by name, exact
        however many events the rings evicted; GC_BOOT holds the
        collections made under an open boot span."""
        with self._lock:
            return {k: (v[0], v[1]) for k, v in self._totals.items()}

    def _host_spans(self) -> Dict[tuple, list]:
        """Each track's host spans (start, end, name) in us from the
        epoch, by start, a span before the spans it holds."""
        tracks: Dict[tuple, list] = {}
        for ev in self.events():
            if ev["ph"] == "X" and ev["name"] not in CARD_SPANS:
                tracks.setdefault((ev["pid"], ev["tid"]), []).append(
                    (ev["ts"], ev["ts"] + ev["dur"], ev["name"]))
        for spans in tracks.values():
            spans.sort(key=lambda sp: (sp[0], -sp[1]))
        return tracks

    def labels_at(self, times) -> List[Optional[str]]:
        """The innermost host span open at each of ``times``
        (``time.monotonic`` times): each track's innermost (latest-
        started) open span, and of those the name most tracks are in (a
        tie goes to the first name in order); None where none is open.  A
        name ends in ``?`` where a ring had evicted events that ended
        after that time, so a span inside it may be missing.  One pass
        over the events, however many times."""
        tracks = self._host_spans()
        with self._lock:
            lost = max(self._lost_until.values(), default=None)
        nxt = dict.fromkeys(tracks, 0)
        stacks = {k: [] for k in tracks}      # each track's open spans
        labels: List[Optional[str]] = [None] * len(times)
        for i in sorted(range(len(times)), key=times.__getitem__):
            us = (times[i] - self._t0) * 1e6
            votes: Counter = Counter()
            for k, spans in tracks.items():
                stack, j = stacks[k], nxt[k]
                while j < len(spans) and spans[j][0] <= us:
                    stack.append(spans[j])
                    j += 1
                nxt[k] = j
                while stack and stack[-1][1] <= us:
                    stack.pop()
                if stack:
                    votes[stack[-1][2]] += 1
            if votes:
                top = max(votes.values())
                name = min(n for n, v in votes.items() if v == top)
                labels[i] = name + "?" if lost is not None \
                    and us <= lost else name
        return labels

    def label_at(self, t: float) -> Optional[str]:
        """:meth:`labels_at` of one time."""
        return self.labels_at([t])[0]

    def covered(self, stretches) -> List[float]:
        """The seconds of each stretch (start, end) (``time.monotonic``
        times) that a host span of any track covers: where the host was
        busy while, say, the card sat idle."""
        union: List[list] = []
        for a, b, _name in sorted(sp for spans in
                                  self._host_spans().values()
                                  for sp in spans):
            if union and a <= union[-1][1]:
                union[-1][1] = max(union[-1][1], b)
            else:
                union.append([a, b])
        starts = [u[0] for u in union]
        out = []
        for a, b in stretches:
            a, b = (a - self._t0) * 1e6, (b - self._t0) * 1e6
            k = max(bisect.bisect_right(starts, a) - 1, 0)
            us = 0.0
            while k < len(union) and union[k][0] < b:
                us += max(0.0, min(b, union[k][1]) - max(a, union[k][0]))
                k += 1
            out.append(us / 1e6)
        return out

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
_installed = False


def get_tracer() -> Tracer:
    global _default
    if _default is None:
        _default = Tracer(enabled=False)
    return _default


def set_tracer(tracer: Tracer) -> None:
    """Make ``tracer`` the process's tracer (for this run; see
    :func:`install`), the collector's hook following it while it is
    enabled."""
    global _default, _installed
    if _default is not None:
        _default._hook_gc(False)
    _default = tracer
    _installed = False
    tracer._hook_gc(tracer.enabled)


def install(tracer: Tracer) -> Tracer:
    """Make ``tracer`` the process's tracer for every run to come: runs
    whose options name no trace path record into it rather than build
    their own, until :func:`set_tracer` or another install replaces
    it."""
    global _installed
    set_tracer(tracer)
    _installed = True
    return tracer


def installed() -> Optional[Tracer]:
    """The tracer :func:`install` put in place, or None."""
    return _default if _installed else None
