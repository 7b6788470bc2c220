"""The trace-determinism gate of the port's flight recorder.

The port twin of ``tests/test_obs.py``'s determinism and parity gates: two
identically seeded device-plane runs of the port on the CPU (a small Tor
network with device-mode clients) write the same sim-time trace stream,
wall fields excluded, with the engine, device, plugin and boot spans in
it; and observability on and off leaves the state digest unchanged.  The
port's stream is also held to the JAX package's on the same run, less the
boot and teardown spans the JAX package does not record.
"""

import importlib
import io
import json

from shadow_tpu_torch.core.checkpoint import state_digest


def _run_device(tmp_path, tag, stop=60, seed=3, trace=True, metrics=True,
                pkg="shadow_tpu_torch"):
    """The small tor device-plane workload of tests/test_obs.py with
    observability on, run by ``pkg`` (the port on the CPU, or the JAX
    package); returns (ctrl, trace_path)."""
    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")

    logger = mod("core.logger")
    logger.set_logger(logger.SimLogger(stream=io.StringIO(),
                                       level="message"))
    try:
        xml = mod("tools.workloads").tor_network(
            8, n_clients=5, n_servers=2, stoptime=stop,
            stream_spec="512:20200", device_data=True)
        cfg = mod("core.configuration").parse_xml(xml)
        cfg.stop_time_sec = stop
        tp = str(tmp_path / f"trace_{tag}.json") if trace else None
        mp_ = str(tmp_path / f"metrics_{tag}.jsonl") if metrics else None
        kw = {"device": "cpu"} if pkg == "shadow_tpu_torch" else {}
        opts = mod("core.options").Options(
            scheduler_policy="global", workers=0, seed=seed,
            stop_time_sec=stop, log_level="message",
            heartbeat_interval_sec=10, trace_path=tp, metrics_path=mp_,
            metrics_every_rounds=20, **kw)
        ctrl = mod("core.controller").Controller(opts, cfg)
        assert ctrl.run() == 0
    finally:
        logger.set_logger(logger.SimLogger())
    return ctrl, tp


# events the wall clock decides: the wall-gated engine heartbeat and the
# garbage collector's pauses
WALL_EVENTS = ("engine.heartbeat", "gc")


def _port_only(name):
    """The spans the port records and the JAX package does not."""
    return name.startswith("boot.") or name == "teardown"


def _sim_stream(path):
    """Per-track ordered (name, cat, ph, sim_ns) tuples: every wall field
    excluded, and the events the wall clock decides dropped."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["pid"], e["tid"], e["name"], e["cat"], e["ph"],
             e.get("args", {}).get("sim_ns"))
            for e in events
            if e.get("ph") != "M" and e["name"] not in WALL_EVENTS]


def test_trace_simtime_stream_deterministic(tmp_path):
    c1, tp1 = _run_device(tmp_path, "det1")
    c2, tp2 = _run_device(tmp_path, "det2")
    s1, s2 = _sim_stream(tp1), _sim_stream(tp2)
    assert s1 == s2, "sim-time trace streams differ between seeded runs"
    # the gate compared something substantial: engine, device and plugin
    # spans, at more than one virtual time, from a run that dispatched
    names = {t[2] for t in s1}
    assert {"round", "device.dispatch", "plugin.continue", "boot.topology",
            "boot.hosts", "boot.plane.scan", "boot.plane.layout",
            "boot.plane.upload", "boot.schedule", "teardown"} <= names
    assert len({t[5] for t in s1}) > 2
    assert c1.engine.device_plane.dispatches > 0
    assert state_digest(c1.engine) == state_digest(c2.engine)


def test_digest_parity_with_obs_enabled(tmp_path):
    on, _tp = _run_device(tmp_path, "obs_on")
    off, _tp2 = _run_device(tmp_path, "obs_off", trace=False, metrics=False)
    assert state_digest(on.engine) == state_digest(off.engine), \
        "observability changed simulation state"


def test_trace_stream_equals_the_jax_packages(tmp_path):
    port, tp = _run_device(tmp_path, "port")
    ref, tp_ref = _run_device(tmp_path, "jax", pkg="shadow_tpu")
    port_stream = [t for t in _sim_stream(tp) if not _port_only(t[2])]
    assert port_stream == _sim_stream(tp_ref)
    from shadow_tpu.core.checkpoint import state_digest as jax_digest
    assert state_digest(port.engine) == jax_digest(ref.engine)
