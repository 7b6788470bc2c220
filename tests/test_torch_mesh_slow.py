"""The mesh at the scale points (marker ``slow``: runs of one to a few
minutes each, outside the tier-1 gate).

* tor200 (``tor_network(200, stoptime=60, device_data=True)``) at D = 8,
  K = 1 and K = 8: the port's sharded run on the CPU equals the JAX
  package's sharded run (digest, events, rounds, forwards, dispatches and
  ``mesh.*``) and the port's single-table run, exchange on the device
  side.
* tor10k at ``--tpu-devices 8`` under ``tpu`` (chip_smoke.py's tor10k
  mesh slice): the JAX package's run gives EXPECTED10K (as its sharded run
  equals its single-device run) and EXPECTED_MESH10K; the port's CPU run
  gives the same, on one device and over 2 CPU "cards" (the mesh over
  cards, parallel/mesh/cards.py, that chip_smoke.py's mesh-cards phase
  runs over 2 aliased cards).  This is how those constants are remade:
  ``python -m pytest -m slow tests/test_torch_mesh_slow.py``.
"""

import pytest

import chip_smoke
from shadow_tpu_torch.tools import workloads
from test_torch_device_plane import PACKAGES
from test_torch_mesh_plane import assert_equal_runs, assert_mesh_contract, run

pytestmark = pytest.mark.slow


@pytest.mark.parametrize("k", [1, 8])
def test_tor200_sharded_equals_jax_and_single(k):
    xml = workloads.tor_network(200, stoptime=60, device_data=True)
    port = run("torch", xml, 60, tpu_devices=8, superwindow_rounds=k)
    assert_mesh_contract(port)
    assert_equal_runs(port, run("jax", xml, 60, tpu_devices=8,
                                superwindow_rounds=k))
    assert port["digest"] == run("torch", xml, 60, tpu_devices=1,
                                 superwindow_rounds=k)["digest"]


@pytest.mark.parametrize("pkg", ["jax", "torch", "torch-cards"])
def test_tor10k_mesh_matches_chip_smoke_constants(pkg):
    cards = pkg == "torch-cards"
    pkg = pkg.split("-")[0]
    conf, ctl, opt, ckpt = PACKAGES[pkg]
    t = chip_smoke.TOR10K
    cfg = conf.parse_xml(workloads.tor_network(
        t["n_relays"], stoptime=t["stoptime"], device_data=True))
    extra = {"device": "cpu"} if pkg == "torch" else {"dataplane": "python"}
    if cards:
        extra["mesh_cards"] = ("cpu",) * chip_smoke.MESH10K_CARDS
    c = ctl.Controller(opt.Options(
        scheduler_policy="tpu", workers=0, seed=t["seed"],
        tpu_devices=chip_smoke.MESH10K_SHARDS, stop_time_sec=t["stoptime"],
        log_level="warning", device_plane="device", **extra), cfg)
    assert c.run() == 0
    e = c.engine
    st = e.device_plane.stats()
    got = {"digest": ckpt.state_digest(e), "events": e.events_executed,
           "rounds": e.rounds_executed, "completed": st["completed"],
           "forwards": st["forwards"], "dispatches": st["dispatches"],
           "hop_calls": e.scheduler.policy._kernel.device_calls}
    assert got == chip_smoke.EXPECTED10K
    scrape = e.metrics.scrape()
    assert {k: scrape[k] for k in chip_smoke.EXPECTED_MESH10K} == \
        chip_smoke.EXPECTED_MESH10K
    assert scrape["mesh.host_bounces"] == 0
    if cards:
        assert e.device_plane._cards.n_cards == chip_smoke.MESH10K_CARDS
