"""The port's device traffic plane end to end on the CPU, against the JAX
package.

The small tor config of tests/test_device_plane.py (8 relays, 5 device-mode
clients, 2 servers, stream 512:20200, stop 60) through the port with
``--device cpu`` (the kernels' plain versions) must give the state digest,
events, rounds, forwards and completed flows of both the JAX package's
device plane (on one device: ``tpu_devices=1``, since tests/conftest.py
gives JAX 8 virtual devices and the sharded layout otherwise) and its
``--device-plane=numpy`` twin — under ``global`` and ``tpu``, at K = 1 and
K = 8, pipelined and ``--device-plane-sync``, across a checkpoint and
``--resume``, and through the ``--fault-inject device-dispatch:2`` drill.
A real dispatch failure ends the run instead.
"""

import glob
import io

import pytest

import shadow_tpu.core.checkpoint as jckpt
import shadow_tpu.core.configuration as jconf
import shadow_tpu.core.controller as jctl
import shadow_tpu.core.logger as jlog
import shadow_tpu.core.options as jopt
import shadow_tpu_torch.core.checkpoint as tckpt
import shadow_tpu_torch.core.configuration as tconf
import shadow_tpu_torch.core.controller as tctl
import shadow_tpu_torch.core.logger as tlog
import shadow_tpu_torch.core.options as topt
from shadow_tpu_torch import cli
from shadow_tpu_torch.tools.workloads import tor_network

PACKAGES = {"jax": (jconf, jctl, jopt, jckpt),
            "torch": (tconf, tctl, topt, tckpt)}
_LOGGERS = {"jax": jlog, "torch": tlog}


def fresh_logger(pkg):
    """Give ``pkg`` a logger of its own for the next run.  The process-wide
    default binds ``sys.stderr`` when it is first made, and under pytest that
    may be a capture an earlier test has since closed."""
    mod = _LOGGERS[pkg]
    mod.set_logger(mod.SimLogger(stream=io.StringIO(), level="warning"))
STOP = 60
XML = tor_network(8, n_clients=5, n_servers=2, stoptime=STOP,
                  stream_spec="512:20200", device_data=True)
PARITY = ("digest", "events", "rounds", "forwards", "completed",
          "dispatches")


def run(pkg, policy="global", mode="device", xml=XML, **extra):
    conf, ctl, opt, ckpt = PACKAGES[pkg]
    cfg = conf.parse_xml(xml)
    cfg.stop_time_sec = STOP
    if pkg == "torch":
        extra.setdefault("device", "cpu")
    elif mode == "device":
        extra.setdefault("tpu_devices", 1)
    c = ctl.Controller(opt.Options(scheduler_policy=policy, workers=0,
                                   seed=3, stop_time_sec=STOP,
                                   log_level="warning", device_plane=mode,
                                   **extra), cfg)
    fresh_logger(pkg)
    assert c.run() == 0
    st = c.engine.device_plane.stats()
    return {"digest": ckpt.state_digest(c.engine),
            "events": c.engine.events_executed,
            "rounds": c.engine.rounds_executed,
            "forwards": st["forwards"], "completed": st["completed"],
            "dispatches": st["dispatches"], "mode": st["mode"],
            "recoveries": st["recoveries"], "demoted": st["demoted"],
            "plane": c.engine.device_plane}


@pytest.fixture(scope="module")
def jax_ref():
    dev = run("jax", mode="device")
    twin = run("jax", mode="numpy")
    assert dev["completed"] == 5 and dev["forwards"] > 0
    for key in PARITY:
        assert dev[key] == twin[key], key
    return dev


@pytest.mark.parametrize("policy", ["global", "tpu"])
@pytest.mark.parametrize("k", [1, 8])
@pytest.mark.parametrize("sync", [False, True])
def test_port_equals_jax_device_and_numpy(jax_ref, policy, k, sync):
    port = run("torch", policy=policy, superwindow_rounds=k,
               device_plane_sync=sync)
    for key in PARITY:
        assert port[key] == jax_ref[key], key
    assert port["mode"] == "device" and port["recoveries"] == 0


def test_port_numpy_mode_equals_jax(jax_ref):
    port = run("torch", mode="numpy")
    for key in PARITY:
        assert port[key] == jax_ref[key], key
    assert port["mode"] == "numpy"


def test_checkpoint_and_resume(jax_ref, tmp_path):
    """A run that writes round-stamped snapshots, and a run resumed from
    the last of them, both reach the uninterrupted run's digest."""
    ckdir = str(tmp_path / "ck")
    full = run("torch", superwindow_rounds=8, checkpoint_every_rounds=40,
               checkpoint_dir=ckdir)
    assert full["digest"] == jax_ref["digest"]
    snaps = sorted(glob.glob(ckdir + "/checkpoint_r*.ckpt"))
    assert snaps
    resumed = run("torch", superwindow_rounds=8, resume_path=snaps[-1])
    assert resumed["digest"] == jax_ref["digest"]


def test_fault_drill_recovers_to_the_same_digest(jax_ref):
    port = run("torch", fault_inject="device-dispatch:2")
    for key in PARITY:
        assert port[key] == jax_ref[key], key
    assert port["recoveries"] == 1 and port["demoted"] is True
    assert port["mode"] == "numpy"


def test_repromote_drill_climbs_back(jax_ref):
    port = run("torch", fault_inject="demote-repromote:2",
               repromote_after=3)
    assert port["digest"] == jax_ref["digest"]
    assert port["plane"].stats()["repromoted"] is True
    assert port["mode"] == "device"


def test_a_real_launch_failure_ends_the_run(monkeypatch):
    """No hidden fallback: a dispatch that raises at launch is not
    recovered on the numpy twin."""
    import shadow_tpu_torch.ops.torcells_device as td

    def broken(*_a, **_k):
        raise RuntimeError("torcells_span kernel launch failed: CUDA "
                           "error 719")
    monkeypatch.setattr(td, "torcells_step_window_flush", broken)
    with pytest.raises(RuntimeError, match="CUDA error 719"):
        run("torch")


def test_a_real_collect_failure_ends_the_run(monkeypatch):
    """A failure surfacing at collect (a CUDA error, a watchdog timeout)
    re-raises; only the injected drill's poisoned handle is recovered."""
    from shadow_tpu_torch.parallel import device_plane as dp

    def broken(self, engine, handle):
        raise TimeoutError("device dispatch did not complete")
    monkeypatch.setattr(dp.DeviceTrafficPlane, "_collect_flush", broken)
    with pytest.raises(TimeoutError):
        run("torch")


def test_cli_runs_device_clients_on_cpu(tmp_path, jax_ref):
    conf = tmp_path / "tor.xml"
    conf.write_text(XML)
    rc = cli.main([str(conf), "--scheduler-policy=tpu", "--device", "cpu",
                   "--data-directory", str(tmp_path / "data"),
                   "--log-level", "warning", "--seed", "3"])
    assert rc == 0


def test_warmup_launches_once_and_leaves_the_plane_untouched():
    """warmup() builds and runs the step once on throwaway zero state of
    the plane's shapes, and leaves the plane's state and counts as they
    were."""
    from shadow_tpu_torch.parallel.device_plane import build_plane_from_engine
    cfg = tconf.parse_xml(XML)
    c = tctl.Controller(topt.Options(workers=0, seed=3, stop_time_sec=STOP,
                                     log_level="warning", device="cpu"), cfg)
    c.setup()
    plane = build_plane_from_engine(c.engine)
    plane.warmup()
    assert plane._state is None and plane.dispatches == 0
    assert not plane._inflight and plane.device_calls == 0
