"""Device-plane profiling: dispatch/collect latency histograms, bytes per
flush, and pipeline-overlap efficiency.

Hooked by parallel/device_plane.py at its three pipeline edges:

* **dispatch** (``advance``) — host-side launch cost (batch packing +
  kernel dispatch call), steps/injections per window;
* **in-flight** — the wall between launch and collect start: the time the
  device computed BEHIND host round work (the overlap the async pipeline
  exists to create);
* **collect** (``consume``) — blocking materialization of the packed flush
  buffer, and its size in bytes (the per-dispatch device->host transfer).

The latency *distributions* live here (per-phase visibility is what made
the IPU architecture legible by microbenchmarking, arXiv:1912.03413, and
what later dispatch-scheduling work optimizes, arXiv:2505.09764); the
overlap *totals* and ``overlap_efficiency`` are published ONCE, by
``DeviceTrafficPlane.stats()`` (the ``plane.*`` scrape namespace), so the
number cannot drift between two computations.

Everything feeds the metrics registry under ``device.*``; span emission
rides the tracer so a ``--trace`` run sees each dispatch's timeline in
Perfetto.  With observability disabled every hook is an attribute check.
"""

from __future__ import annotations

from .metrics import get_metrics
from .trace import get_tracer


class DeviceProfiler:
    """Per-plane profiling state; constructed by DeviceTrafficPlane."""

    def __init__(self):
        self.tracer = get_tracer()
        registry = get_metrics()
        self.enabled = registry.enabled or self.tracer.enabled
        self.dispatch_us = registry.histogram("device.dispatch_launch_us")
        self.collect_us = registry.histogram("device.collect_blocked_us")
        self.flush_bytes = registry.histogram("device.flush_bytes")
        # launch attribution (ISSUE 15, shadow_tpu/prof/): per-launch
        # predicted-vs-measured device cost from the calibrated model,
        # and the loud stale-model counter — populated only when a cost
        # model actually loaded (on_window's predicted is None otherwise)
        self.pred_us = registry.histogram("prof.launch_predicted_us")
        self.meas_us = registry.histogram("prof.launch_measured_us")
        self.model_stale = registry.counter("prof.model_stale")
        self.launches_checked = registry.counter("prof.launches_checked")

    # -- hooks (called from the device plane) ------------------------------
    def on_dispatch(self, t0_ns: int, t1_ns: int, steps: int,
                    injections: int, dispatch_idx: int,
                    sim_ns: int) -> None:
        """Host-side launch cost of one window dispatch ([t0, t1] are
        perf_counter_ns stamps around advance()'s dispatch section)."""
        if not self.enabled:
            return
        self.dispatch_us.observe((t1_ns - t0_ns) / 1e3)
        if self.tracer.enabled:
            self.tracer.complete(
                "device.dispatch", "device", t0_ns / 1e9, t1_ns / 1e9,
                sim_ns, {"dispatch": dispatch_idx, "steps": steps,
                         "injections": injections})

    def on_collect(self, launch_wall_ns: int, collect_start_ns: int,
                   blocked_ns: int, nbytes: int, dispatch_idx: int,
                   sim_ns: int) -> None:
        """``launch_wall_ns``/``collect_start_ns`` are perf_counter_ns
        stamps from the plane; their gap is the overlap the pipeline
        bought, rendered as the ``device.inflight`` span."""
        if not self.enabled:
            return
        self.collect_us.observe(blocked_ns / 1e3)
        self.flush_bytes.observe(nbytes)
        if self.tracer.enabled:
            self.tracer.complete("device.inflight", "device",
                                 launch_wall_ns / 1e9,
                                 collect_start_ns / 1e9, sim_ns,
                                 {"dispatch": dispatch_idx,
                                  "flush_bytes": nbytes,
                                  "blocked_us": round(blocked_ns / 1e3, 1)})

    def on_window(self, launch_ns: int, end_ns: int, blocked_ns: int,
                  steps: int, granule_ms: int,
                  predicted_us, band: float, sim_base_ns: int,
                  exchange_mode: str) -> None:
        """Per-launch attribution (ISSUE 15): pair the model's predicted
        device cost with the measured launch->collect-end wall, count
        band violations in ``prof.model_stale``, and emit the
        sim-correlated ``device.window`` span onto the dedicated
        ``device-sim`` Chrome-trace track.

        The measured span UPPER-bounds the kernel wall (the pipeline
        overlaps host work inside it), so the band check is one-sided
        by default: ``measured < predicted / band`` proves the model
        OVERpredicts (the kernel finished inside a span band-times
        shorter than predicted).  UNDERprediction is only judged when
        the collect blocked for most of the span — there the span IS
        the kernel wall — so host-heavy rounds cannot false-positive
        the counter."""
        if predicted_us is None and not self.enabled:
            return
        measured_us = (end_ns - launch_ns) / 1e3
        self.meas_us.observe(measured_us)
        if predicted_us is not None:
            self.pred_us.observe(predicted_us)
            self.launches_checked.inc()
            over = measured_us * band < predicted_us
            blocked_dominated = blocked_ns * 2 >= (end_ns - launch_ns)
            under = blocked_dominated and measured_us > predicted_us * band
            if over or under:
                self.model_stale.inc()
        if self.tracer.enabled:
            self.tracer.complete(
                "device.window", "device-sim", launch_ns / 1e9,
                end_ns / 1e9, sim_base_ns,
                {"steps": steps,
                 "sim_span_ms": steps * granule_ms,
                 "exchange_mode": exchange_mode,
                 "measured_us": round(measured_us, 1),
                 "predicted_us": round(predicted_us, 1)
                 if predicted_us is not None else None},
                tid="device-sim")
