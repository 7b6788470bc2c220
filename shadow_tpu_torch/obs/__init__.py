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
attribute checks per round; simulation state is never touched, so digests
are identical with observability on or off (tests/test_torch_obs.py pins
this).  A tracer installed for the whole process (``trace.install``)
outlives the runs made under it.
"""

from __future__ import annotations


def configure_observability(options, shard_id=None, label=None):
    """Build + install the global tracer/registry from run options.

    Called by Engine.__init__ (and the procs parent, which passes an
    explicit ``shard_id`` past the shard range plus ``label='parent'``)
    the same way the CLI installs the logger: per run, module-global, so
    distant modules (tracker, device plane, native plugins) reach it
    without threading an engine reference through every signature.
    A tracer installed for the whole process stays in place for a run
    whose options name no trace path (so every engine of a fleet records
    into the one installed tracer).
    Returns ``(tracer, registry, metrics_writer_or_None)``.
    """
    from .metrics import MetricsRegistry, MetricsWriter, set_metrics
    from .trace import Tracer, set_tracer
    from .trace import installed as installed_tracer

    if shard_id is None:
        shard_id = int(getattr(options, "shard_id", 0) or 0)
    trace_path = getattr(options, "trace_path", None)
    tracer = None if trace_path else installed_tracer()
    if tracer is None:
        tracer = Tracer(enabled=bool(trace_path), path=trace_path,
                        ring=int(getattr(options, "trace_ring", 0) or 0)
                        or None, shard_id=shard_id, label=label)
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
