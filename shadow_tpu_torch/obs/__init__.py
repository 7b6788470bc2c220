"""Flight-recorder observability plane (ISSUE 3).

The reference scatters its visibility across per-host tracker heartbeats
(host/tracker.c), getrusage engine heartbeats (slave.c:390-411), and the
shutdown object-lifecycle leak report; our port additionally has a device
pipeline and supervision seams with timing worth keeping.  This package
gives all of them one structured home with three cooperating layers:

* :mod:`obs.trace`   — spans/instants carrying BOTH sim-time and wall-time,
  recorded into a bounded per-track ring buffer (a flight recorder: the
  recent past is always available, memory is always bounded), exported as
  Chrome trace-event JSON (``--trace PATH``, loadable in Perfetto);
* :mod:`obs.metrics` — a registry of counters/gauges/histograms/sources
  scraped on a round cadence to JSONL plus a final summary
  (``--metrics PATH --metrics-every N``), absorbing the ObjectCounter,
  SupervisionStats, tracker heartbeats, and device-plane stats as sources
  instead of leaving each its own ad-hoc format;
* :mod:`obs.profiler` — device-plane hooks (dispatch/collect latency
  histograms, bytes per flush, pipeline-overlap efficiency) feeding both.

Everything is OFF by default and the disabled path is a handful of
attribute checks per round (pinned by bench.py's ``obs_overhead_sec``
column); simulation state is never touched, so digests are identical with
observability on or off (tests/test_obs.py pins this).
"""

from __future__ import annotations

import time as _walltime


def configure_observability(options, shard_id=None, label=None):
    """Build + install the global tracer/registry from run options.

    Called by Engine.__init__ (and the procs parent, which passes an
    explicit ``shard_id`` past the shard range plus ``label='parent'``)
    the same way the CLI installs the logger: per run, module-global, so
    distant modules (tracker, device plane, native plugins) reach it
    without threading an engine reference through every signature.
    Returns ``(tracer, registry, metrics_writer_or_None)``.
    """
    from .metrics import MetricsRegistry, MetricsWriter, set_metrics
    from .trace import Tracer, set_tracer

    if shard_id is None:
        shard_id = int(getattr(options, "shard_id", 0) or 0)
    trace_path = getattr(options, "trace_path", None)
    tracer = Tracer(enabled=bool(trace_path), path=trace_path,
                    ring=int(getattr(options, "trace_ring", 0) or 0) or None,
                    shard_id=shard_id, label=label)
    set_tracer(tracer)
    metrics_path = getattr(options, "metrics_path", None)
    registry = MetricsRegistry(enabled=bool(metrics_path))
    set_metrics(registry)
    writer = None
    # shard engines record but never write files: their rings/scrapes ride
    # the procs final message and the parent owns the merged outputs (N
    # children appending to one path would interleave garbage)
    if metrics_path and int(getattr(options, "shard_count", 1) or 1) == 1:
        writer = MetricsWriter(
            metrics_path,
            int(getattr(options, "metrics_every_rounds", 0) or 0))
    return tracer, registry, writer


# measuring the disabled path must itself stay cheap: each hook form is
# timed over at most this many iterations and scaled linearly to the
# requested count (the loops are constant-cost, so the extrapolation is
# exact to measurement noise)
_CALIBRATION_CAP = 200_000


def disabled_overhead_sec(span_hooks: int, enabled_checks: int = 0) -> float:
    """Measure the DISABLED observability plane's cost in its two actual
    forms: ``span_hooks`` null-span enter/exits (the ~6 fixed engine hooks
    per round) plus ``enabled_checks`` bare ``get_tracer()``+``.enabled``
    probes (the per-process-resume / per-RPC guard form, which never
    constructs a span when off).  bench.py prices the engine hooks at the
    run's round count and the guard checks at the run's EVENT count — an
    upper bound on resumes, so ``obs_overhead_sec`` is a conservative
    measured pin that the disabled path rounds to zero."""
    from .trace import Tracer, get_tracer, set_tracer

    span_hooks = max(0, int(span_hooks))
    enabled_checks = max(0, int(enabled_checks))
    tracer = Tracer(enabled=False)
    total = 0.0
    n = min(span_hooks, _CALIBRATION_CAP)
    if n:
        t0 = _walltime.perf_counter()
        for _ in range(n):
            with tracer.span("obs.overhead", "bench"):
                pass
        total += (_walltime.perf_counter() - t0) * (span_hooks / n)
    n = min(enabled_checks, _CALIBRATION_CAP)
    if n:
        prev = get_tracer()
        set_tracer(tracer)
        try:
            t0 = _walltime.perf_counter()
            for _ in range(n):
                if get_tracer().enabled:
                    pass  # pragma: no cover - tracer is disabled
            total += (_walltime.perf_counter() - t0) * (enabled_checks / n)
        finally:
            set_tracer(prev)
    return total
