"""The sweep's lane 1 at full size on the CPU (marker ``slow``: three runs
of half a minute to a few minutes each, outside the tier-1 gate).

This is how chip_smoke.py's EXPECTED_SWEEP1 constants were made and how to
remake them: the genscen ``tor10k`` preset drawn with seed 1 (10,000
hosts: 1,000 relays, 100 servers, 8,900 clients on seeded 3-hop circuits;
the plane holds F = 89,000 flows, C = 17,800 chains, H = 19,000 nodes,
every transfer a processless 5-hop device chain), stoptime 300, under
``--scheduler-policy=global`` with the host table on, ``workers=0``,
``seed=1``.  The JAX package's device plane on one XLA CPU device and its
``--device-plane=numpy`` twin give the state digest, events, rounds,
completed flows, forwards and dispatches, and must agree; the port's run
on the CPU (``--device cpu``, the kernels' plain versions) must give the
same.  Run with ``python -m pytest -m slow tests/test_torch_sweep.py``.
"""

import pytest

import chip_smoke
from test_torch_device_plane import PACKAGES

pytestmark = pytest.mark.slow


def run(pkg, mode):
    conf, ctl, opt, ckpt = PACKAGES[pkg]
    if pkg == "torch":
        from shadow_tpu_torch.scale import genscen
    else:
        from shadow_tpu.scale import genscen
    s = chip_smoke.SWEEP
    cfg = genscen.build(s["preset"], seed=1, stoptime=s["stoptime"])
    # tpu_devices=1: tests/conftest.py gives JAX 8 virtual devices
    extra = {"device": "cpu"} if pkg == "torch" else {"dataplane": "python"}
    c = ctl.Controller(opt.Options(
        scheduler_policy="global", workers=0, seed=1, tpu_devices=1,
        host_table="on", heartbeat_interval_sec=0,
        stop_time_sec=s["stoptime"], log_level="warning", device_plane=mode,
        **extra), cfg)
    assert c.run() == 0
    e = c.engine
    st = e.device_plane.stats()
    assert st["mode"] == mode and st["recoveries"] == 0
    assert st["completed"] == st["circuits"] == 8900
    assert e.host_table.materialized_count == 0
    return {"digest": ckpt.state_digest(e), "events": e.events_executed,
            "rounds": e.rounds_executed, "completed": st["completed"],
            "forwards": st["forwards"], "dispatches": st["dispatches"]}


@pytest.mark.parametrize("pkg,mode", [("jax", "device"), ("jax", "numpy"),
                                      ("torch", "device")])
def test_sweep_lane1_matches_chip_smoke_constants(pkg, mode):
    assert run(pkg, mode) == chip_smoke.EXPECTED_SWEEP1
