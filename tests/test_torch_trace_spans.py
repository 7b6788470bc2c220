"""The port's tracer as the one recorder of a whole window of runs.

An installed tracer outlives the runs made under it: two fleet lanes
record their boot, barrier and loop spans into it on their own tracks,
and no lane's engine replaces it.  A run's own ``--trace PATH`` tracer
holds that run's spans, boot included, and stops recording the collector
when the run ends.  Its per-name totals stay exact after its rings drop
events, its spans share ``time.monotonic``'s clock, the garbage
collector's pauses are spans (apart under a boot span), a moment is
labelled by the innermost span open then, and the seconds spans cover
are summed.
"""

import gc
import io
import json
import time

import pytest

from shadow_tpu_torch.obs import configure_observability
from shadow_tpu_torch.obs import trace as obs_trace
from shadow_tpu_torch.obs.trace import GC_BOOT, Tracer

BOOT_SPANS = ("boot.topology", "boot.hosts", "boot.plane.scan",
              "boot.plane.layout", "boot.schedule")
LOOP_SPANS = ("collect", "dispatch.launch", "round", "flush", "teardown")


@pytest.fixture
def fresh():
    """A test that installs a tracer leaves a disabled one."""
    yield
    obs_trace.set_tracer(Tracer(enabled=False))


def _gc_hooks():
    """The tracers' collector hooks in ``gc.callbacks``."""
    return [cb for cb in gc.callbacks
            if getattr(cb, "__func__", None) is Tracer._on_gc]


def _lane_run(lane, seed):
    """A 300-host Tor network, every transfer a device-plane chain, as a
    fleet lane on the CPU; returns its engine's tracer."""
    from shadow_tpu_torch.core.controller import Controller
    from shadow_tpu_torch.core.logger import SimLogger, set_thread_logger
    from shadow_tpu_torch.core.options import Options
    from shadow_tpu_torch.scale import genscen
    set_thread_logger(SimLogger(stream=io.StringIO(), level="warning"))
    try:
        cfg = genscen.tor(n_hosts=300, stoptime=4, stagger_waves=2,
                          seed=seed)
        opts = Options(scheduler_policy="global", device="cpu", workers=0,
                       seed=seed, host_table="on", heartbeat_interval_sec=0,
                       stop_time_sec=4, log_level="warning")
        opts._fleet_lane = lane
        ctl = Controller(opts, cfg)
        assert ctl.run() == 0
        assert ctl.engine.device_plane.dispatches > 0
        return ctl.engine.tracer
    finally:
        set_thread_logger(None)


def test_fleet_lanes_record_into_the_installed_tracer(fresh):
    from shadow_tpu_torch.fleet import FleetDriver, FleetPlane
    tracer = obs_trace.install(Tracer(enabled=True))
    plane = FleetPlane(device="cpu")
    used = FleetDriver(lanes=2, plane=plane).run(
        [lambda lane: _lane_run(lane, 5), lambda lane: _lane_run(lane, 6)])
    assert used == [tracer, tracer]
    assert obs_trace.get_tracer() is tracer
    assert obs_trace.installed() is tracer
    names = {}
    for ev in tracer.events():
        names.setdefault(ev["tid"], set()).add(ev["name"])
    for track in ("fleet-0", "fleet-1"):
        assert set(BOOT_SPANS + LOOP_SPANS + ("fleet.wait", "gc")) \
            <= names[track], (track, names[track])
    # an engine that found the collector on ran two full collections
    # around its loop, on its lane's track (the switch is the process's:
    # a lane whose loop starts while another's runs finds it off)
    full = [ev for ev in tracer.events()
            if ev["name"] == "gc" and ev["args"]["generation"] == 2]
    assert full and {ev["tid"] for ev in full} <= {"fleet-0", "fleet-1"}
    # a wait a lane dispatch, a launch span a launch
    stats = plane.metrics()
    tot = tracer.totals()
    assert tot["fleet.wait"][0] == stats["fleet.lane_dispatches"] > 0
    assert tot["fleet.launch"][0] == stats["fleet.launches"] > 0
    assert tot["fleet.wait"][1] >= 0 and tot["fleet.launch"][1] > 0
    assert tot["boot.topology"][0] == tot["boot.hosts"][0] \
        == tot["boot.plane.layout"][0] == 2
    # the lanes' engines ended their runs, not the installed tracer
    assert _gc_hooks() == [tracer._on_gc]
    assert 0 < tot[GC_BOOT][1] <= tot["gc"][1]
    assert tracer.label_at(time.monotonic()) is None


def test_span_clock_brackets_a_monotonic_stamp():
    """Spans stamp perf_counter, the harness time.monotonic: one clock
    on Linux, so epoch + ts places a span among monotonic stamps."""
    tracer = Tracer(enabled=True)
    with tracer.span("boot.hosts", "boot"):
        time.sleep(0.002)
        stamp = time.monotonic()
        time.sleep(0.002)
    (ev,) = tracer.events()
    start = tracer.epoch + ev["ts"] / 1e6
    end = start + ev["dur"] / 1e6
    assert start < stamp < end
    assert stamp - start > 0.001 and end - stamp > 0.001
    assert tracer.label_at(stamp) == "boot.hosts"


def test_totals_stay_exact_after_the_ring_drops():
    tracer = Tracer(enabled=True, ring=4)
    t, durs = 100.0, [0.25 * (i + 1) for i in range(10)]
    for d in durs:
        tracer.complete("round", "engine", t, t + d, 0, None)
        t += d
    tracer.complete("flush", "engine", t, t + 0.5, 0, None)
    assert tracer.dropped == 7 and len(tracer.events()) == 4
    assert tracer.totals() == {"round": (10, sum(durs)), "flush": (1, 0.5)}


def _gaps_labelled(tracer, gaps):
    """Idle gaps (start, seconds) on the monotonic clock, each labelled by
    the span open at its middle."""
    return tracer.labels_at([a + d / 2 for a, d in gaps])


def test_idle_gaps_take_the_innermost_open_span():
    tracer = Tracer(enabled=True)
    e = tracer.epoch

    def span(name, a, b, tid):
        tracer.complete(name, "x", e + a, e + b, 0, None, tid=tid)

    # one thread: the boot, a collection inside it, a round; a dispatch in
    # flight (the card's work) never labels
    span("gc", 2, 3, "MainThread")
    span("boot.hosts", 1, 5, "MainThread")
    span("device.inflight", 5.5, 8, "MainThread")
    span("round", 6, 7, "MainThread")
    gaps = [(e + a, d) for a, d in ((1, 0.5), (2, 1), (3.5, 1), (5.4, 0.4),
                                    (6, 1), (9, 1))]
    assert _gaps_labelled(tracer, gaps) \
        == ["boot.hosts", "gc", "boot.hosts", None, "round", None]
    # lanes: the name most lanes are in, a tie to the first name
    span("fleet.wait", 10, 12, "fleet-0")
    span("fleet.wait", 10.5, 12, "fleet-1")
    span("boot.plane.layout", 9, 13, "fleet-2")
    span("boot.plane.layout", 10.8, 13, "fleet-3")
    assert tracer.label_at(e + 10.6) == "fleet.wait"
    assert tracer.label_at(e + 11) == "boot.plane.layout"
    assert tracer.label_at(e + 12.5) == "boot.plane.layout"


def test_a_label_says_where_the_ring_dropped():
    tracer = Tracer(enabled=True, ring=2)
    e = tracer.epoch
    for a in (1, 2, 3):
        tracer.complete("round", "engine", e + a, e + a + 0.5, 0, None,
                        tid="MainThread")
    tracer.complete("boot.hosts", "boot", e + 0.5, e + 4, 0, None,
                    tid="MainThread")
    # the round at 1-1.5 was evicted: what was open then is not known
    assert tracer.label_at(e + 1.2) == "boot.hosts?"
    assert tracer.label_at(e + 2.2) == "boot.hosts?"
    assert tracer.label_at(e + 3.2) == "round"
    assert tracer.label_at(e + 3.7) == "boot.hosts"


def test_collector_pauses_are_spans(fresh):
    tracer = obs_trace.install(Tracer(enabled=True))
    was = gc.isenabled()
    gc.disable()
    try:
        gc.collect()
        with tracer.span("boot.hosts", "boot"):
            gc.collect(1)
    finally:
        if was:
            gc.enable()
    paused = [ev for ev in tracer.events() if ev["name"] == "gc"]
    assert [ev["args"]["generation"] for ev in paused] == [2, 1]
    tot = tracer.totals()
    assert tot["gc"][0] == 2
    assert tot[GC_BOOT][0] == 1
    assert tot[GC_BOOT][1] == pytest.approx(paused[1]["dur"] / 1e6,
                                            abs=1e-6)
    obs_trace.set_tracer(Tracer(enabled=False))
    assert tracer._on_gc not in gc.callbacks


def test_configure_keeps_what_was_installed(fresh, tmp_path):
    from shadow_tpu_torch.core.options import Options
    tracer = obs_trace.install(Tracer(enabled=True))
    got, registry, writer = configure_observability(Options())
    assert got is tracer and writer is None
    again = configure_observability(Options())
    assert again[0] is tracer and again[1] is not registry
    # a run that names its own trace path keeps its meaning
    path = str(tmp_path / "trace.json")
    own = configure_observability(Options(trace_path=path))[0]
    assert own is not tracer and own.enabled and own.path == path
    assert obs_trace.installed() is None
    # with nothing installed each run builds its own, disabled
    a = configure_observability(Options())[0]
    b = configure_observability(Options())[0]
    assert a is not b and not a.enabled and not b.enabled


def _trace_run(path, seed):
    """A small Tor network on the CPU with its own ``--trace PATH``."""
    from shadow_tpu_torch.core import logger
    from shadow_tpu_torch.core.configuration import parse_xml
    from shadow_tpu_torch.core.controller import Controller
    from shadow_tpu_torch.core.options import Options
    from shadow_tpu_torch.tools.workloads import tor_network
    logger.set_logger(logger.SimLogger(stream=io.StringIO(),
                                       level="warning"))
    try:
        cfg = parse_xml(tor_network(8, n_clients=5, n_servers=2, stoptime=5,
                                    stream_spec="512:20200",
                                    device_data=True))
        cfg.stop_time_sec = 5
        ctl = Controller(Options(scheduler_policy="global", workers=0,
                                 seed=seed, stop_time_sec=5, device="cpu",
                                 log_level="warning", trace_path=path), cfg)
        assert ctl.run() == 0
    finally:
        logger.set_logger(logger.SimLogger())
    with open(path) as f:
        return ctl.engine.tracer, json.load(f)["traceEvents"]


def test_each_traced_run_writes_its_own_boot(fresh, tmp_path):
    """Two ``--trace PATH`` runs in one process: each file holds its own
    run's boot, topology first, and no run leaves the collector hooked."""
    obs_trace.set_tracer(Tracer(enabled=False))
    runs = [_trace_run(str(tmp_path / f"t{i}.json"), 3 + i)
            for i in range(2)]
    assert runs[0][0] is not runs[1][0]
    for tracer, events in runs:
        names = [e["name"] for e in events if e.get("ph") == "X"]
        assert names.count("boot.topology") == 1
        assert {"boot.hosts", "boot.schedule", "teardown"} <= set(names)
        topo = next(e for e in events if e["name"] == "boot.topology")
        hosts = next(e for e in events if e["name"] == "boot.hosts")
        assert topo["ts"] + topo["dur"] <= hosts["ts"]
        assert tracer.totals()["boot.topology"][0] == 1
    assert _gc_hooks() == []
    # what a later collection would have recorded goes nowhere
    before = runs[1][0].totals().get("gc", (0, 0.0))[0]
    gc.collect()
    assert runs[1][0].totals().get("gc", (0, 0.0))[0] == before


def test_many_labels_in_one_pass_and_the_seconds_spans_cover():
    tracer = Tracer(enabled=True)
    e = tracer.epoch

    def span(name, a, b, tid):
        tracer.complete(name, "x", e + a, e + b, 0, None, tid=tid)

    span("boot.hosts", 1, 5, "MainThread")
    span("gc", 2, 3, "MainThread")
    span("device.inflight", 5, 9, "MainThread")
    span("round", 6, 7, "MainThread")
    span("round", 6.5, 8, "fleet-0")
    span("fleet.wait", 10, 12, "fleet-0")
    times = [e + t for t in (11, 0.5, 2.5, 6.2, 4, 7.5, 9, 1)]
    labels = tracer.labels_at(times)
    assert labels == ["fleet.wait", None, "gc", "round", "boot.hosts",
                      "round", None, "boot.hosts"]
    assert labels == [tracer.label_at(t) for t in times]
    # the union of every track's host spans; the card's never count
    got = tracer.covered([(e + 0, e + 2.5), (e + 4.5, e + 6.75),
                          (e + 8, e + 11), (e + 12, e + 13)])
    assert got == pytest.approx([1.5, 1.25, 1.0, 0.0], abs=1e-6)
