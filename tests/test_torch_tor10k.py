"""The tor10k device-plane slice at full size on the CPU (marker ``slow``:
three runs of one to a few minutes each, outside the tier-1 gate).

This is how chip_smoke.py's EXPECTED10K constants were made and how to
remake them: ``tor_network(10000, stoptime=64, device_data=True)`` (20,500
hosts, 10,000 device-mode clients; the plane holds F = 100,000 flows, C =
20,000 chains, H = 30,494 nodes) under ``--scheduler-policy=tpu``,
``workers=0``, ``seed=1``.  The JAX package's device plane on one XLA CPU
device and its ``--device-plane=numpy`` twin give the state digest,
events, rounds, completed flows, forwards, dispatches and hop launches,
and must agree; the port's run on the CPU (``--device cpu``, the kernels'
plain versions) must give the same.  Run with
``python -m pytest -m slow tests/test_torch_tor10k.py``.
"""

import pytest

import chip_smoke
from test_torch_device_plane import PACKAGES

pytestmark = pytest.mark.slow


def run(pkg, mode):
    conf, ctl, opt, ckpt = PACKAGES[pkg]
    from shadow_tpu_torch.tools.workloads import tor_network
    t = chip_smoke.TOR10K
    cfg = conf.parse_xml(tor_network(t["n_relays"], stoptime=t["stoptime"],
                                     device_data=True))
    # tpu_devices=1: tests/conftest.py gives JAX 8 virtual devices, which
    # would put its plane on the sharded layout
    extra = {"device": "cpu"} if pkg == "torch" else {"dataplane": "python"}
    c = ctl.Controller(opt.Options(
        scheduler_policy="tpu", workers=0, seed=t["seed"], tpu_devices=1,
        stop_time_sec=t["stoptime"], log_level="warning", device_plane=mode,
        **extra), cfg)
    assert c.run() == 0
    e = c.engine
    st = e.device_plane.stats()
    kern = e.scheduler.policy._kernel
    assert st["mode"] == mode and st["recoveries"] == 0
    assert kern.host_calls == 0
    return {"digest": ckpt.state_digest(e), "events": e.events_executed,
            "rounds": e.rounds_executed, "completed": st["completed"],
            "forwards": st["forwards"], "dispatches": st["dispatches"],
            "hop_calls": kern.device_calls}


@pytest.mark.parametrize("pkg,mode", [("jax", "device"), ("jax", "numpy"),
                                      ("torch", "device")])
def test_tor10k_matches_chip_smoke_constants(pkg, mode):
    assert run(pkg, mode) == chip_smoke.EXPECTED10K
