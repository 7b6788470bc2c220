"""The port's sharded traffic plane end to end on the CPU, against the JAX
package's mesh on its 8 virtual XLA devices.

The generated star scenario of tests/test_meshplane.py (6 device-mode bulk
clients of 192 MiB each, stop 120) with ``--tpu-devices D``: the port's
run (``--device cpu``: D shards on the CPU through the plain mesh version)
must give the JAX package's sharded run's state digest, events, rounds,
forwards, completed flows, dispatches and ``mesh.*`` metrics, and the
port's own single-table run's digest — at K = 1 and K = 8, uneven D = 3,
``--device-plane-sync``, across a checkpoint and ``--resume``, through the
``device-dispatch:2`` drill (demoted to the numpy twin: host bounces
counted), the ``device-lost`` re-shard 8->7 and 2->1, and with
``--exchange-mode`` forced each way.  ``mesh.cost_model`` is the one metric
that differs by design: the JAX package refuses its checked-in cost model on
this box, the port has none (ROADMAP A7).  The tor config runs in
tests/test_torch_mesh_tor.py.
"""

import glob

import pytest

import shadow_tpu_torch.parallel.device_plane as tplane
from shadow_tpu_torch.tools import workloads
from test_torch_device_plane import PACKAGES, fresh_logger

STAR_XML = workloads.star_bulk(6, stoptime=120, bulk_bytes=192 * 1024 * 1024,
                               device_data=True)
PARITY = ("digest", "events", "rounds", "forwards", "completed",
          "dispatches")
# the cost-model status: "refused" in the JAX package (its COSTMODEL.json
# is fingerprinted to another box), "absent" in the port (ROADMAP A7)
NOT_COMPARED = ("mesh.cost_model",)

_CACHE: dict = {}


def run(pkg, xml=STAR_XML, stop=120, **kw):
    """One run, cached by (package, config, options): runs are
    deterministic, and several gates share them."""
    key = (pkg, xml, stop, tuple(sorted(kw.items())))
    if key in _CACHE:
        return _CACHE[key]
    conf, ctl, opt, ckpt = PACKAGES[pkg]
    cfg = conf.parse_xml(xml)
    cfg.stop_time_sec = stop
    extra = dict(kw)
    if pkg == "torch":
        extra.setdefault("device", "cpu")
    c = ctl.Controller(opt.Options(
        scheduler_policy=extra.pop("policy", "global"), workers=0, seed=3,
        stop_time_sec=stop, log_level="warning",
        device_plane=extra.pop("mode", "device"), **extra), cfg)
    fresh_logger(pkg)
    assert c.run() == 0
    e = c.engine
    plane = e.device_plane
    st = plane.stats()
    out = {"digest": ckpt.state_digest(e), "events": e.events_executed,
           "rounds": e.rounds_executed, "forwards": st["forwards"],
           "completed": st["completed"], "dispatches": st["dispatches"],
           "mesh": {k: v for k, v in e.metrics.scrape().items()
                    if k.startswith("mesh.") and k not in NOT_COMPARED},
           "supervision": e.supervision.summary(), "plane": plane,
           "stats": st}
    _CACHE[key] = out
    return out


def assert_equal_runs(port, ref):
    for k in PARITY:
        assert port[k] == ref[k], k
    assert port["mesh"] == ref["mesh"]


def assert_mesh_contract(r, max_calls=3):
    plane = r["plane"]
    assert plane._shard is not None, "the mesh layout did not engage"
    assert r["mesh"]["mesh.host_bounces"] == 0
    assert r["mesh"]["mesh.cross_shard_cells"] > 0, \
        "no cells crossed shards — the exchange gate is vacuous"
    assert r["mesh"]["mesh.devices"] == plane._meshinfo.n_devices
    st = r["stats"]
    assert st["device_calls"] / max(st["dispatches"], 1) <= max_calls, st


@pytest.mark.parametrize("k", [1, 8])
def test_star_sharded_equals_jax_and_single(k):
    port = run("torch", tpu_devices=8, superwindow_rounds=k)
    assert_mesh_contract(port)
    assert_equal_runs(port, run("jax", tpu_devices=8, superwindow_rounds=k))
    single = run("torch", tpu_devices=1, superwindow_rounds=k)
    assert single["plane"]._shard is None
    assert port["digest"] == single["digest"]
    assert port["completed"] == 6
    if k == 8:
        assert port["stats"]["superwindows"] > 0
        assert port["digest"] == run("torch", tpu_devices=8)["digest"]


def test_star_sync_and_uneven_shards():
    """--device-plane-sync on the mesh (the serial oracle) and D = 3 (an
    uneven partition, one exchange leg) end where the JAX package's runs
    end."""
    sync = run("torch", tpu_devices=8, superwindow_rounds=8,
               device_plane_sync=True)
    assert sync["digest"] == run("jax", tpu_devices=8,
                                 superwindow_rounds=8)["digest"]
    uneven = run("torch", tpu_devices=3)
    assert uneven["plane"]._shard["n_shards"] == 3
    assert_equal_runs(uneven, run("jax", tpu_devices=3))


def test_star_checkpoint_and_resume(tmp_path):
    ckdir = str(tmp_path / "ck")
    full = run("torch", tpu_devices=8, superwindow_rounds=8,
               checkpoint_every_rounds=30, checkpoint_dir=ckdir)
    clean = run("jax", tpu_devices=8, superwindow_rounds=8)
    assert full["digest"] == clean["digest"]
    snaps = sorted(glob.glob(ckdir + "/checkpoint_r*.ckpt"))
    assert snaps, "the sharded K=8 run wrote no snapshots"
    resumed = run("torch", tpu_devices=8, superwindow_rounds=8,
                  resume_path=ckdir, checkpoint_dir=str(tmp_path / "ck2"))
    assert resumed["plane"]._shard is not None
    assert resumed["digest"] == clean["digest"]


def test_star_dispatch_drill_demotes_the_mesh():
    """device-dispatch:2 on the mesh: the failed dispatch replays on the
    numpy twin, the plane drops the mesh, and the demoted windows'
    cross-shard forwards count as host bounces — as in the JAX package."""
    port = run("torch", tpu_devices=8, fault_inject="device-dispatch:2")
    ref = run("jax", tpu_devices=8, fault_inject="device-dispatch:2")
    assert_equal_runs(port, ref)
    plane = port["plane"]
    assert plane.demoted and plane.mode == "numpy" and plane._shard is None
    assert port["mesh"]["mesh.host_bounces"] > 0
    assert port["mesh"]["mesh.demoted"] == 1
    assert port["digest"] == run("jax", tpu_devices=8)["digest"]


@pytest.mark.parametrize("n_dev", [8, 2])
def test_star_device_lost_reshards(n_dev):
    """device-lost:4 re-shards 8->7 (or 2->1: the single-table plane) at a
    quiesced round boundary, digest pinned across the re-layout."""
    port = run("torch", tpu_devices=n_dev, fault_inject="device-lost:4")
    assert_equal_runs(port, run("jax", tpu_devices=n_dev,
                                fault_inject="device-lost:4"))
    assert port["supervision"]["reshards"] == 1
    assert port["digest"] == run("jax", tpu_devices=n_dev)["digest"]
    plane = port["plane"]
    if n_dev == 2:
        assert plane._shard is None
    else:
        assert plane._meshinfo.n_devices == 7
        assert port["mesh"]["mesh.host_bounces"] == 0


@pytest.mark.parametrize("mode", ["fused", "ppermute"])
def test_star_exchange_mode_forced(mode):
    port = run("torch", tpu_devices=8, exchange_mode=mode)
    assert_equal_runs(port, run("jax", tpu_devices=8, exchange_mode=mode))
    assert port["mesh"]["mesh.exchange_mode"] == mode
    assert port["mesh"]["mesh.exchange_source"] == "forced"


def test_quiet_legs_variants_stay_within_budget():
    """The active-leg set only grows; once every chain is active the plane
    runs the full step, and the masked variants it made on the way stay
    within their budget of four."""
    r = run("torch", tpu_devices=8, exchange_mode="ppermute")
    plane = r["plane"]
    legs = r["mesh"]["mesh.exchange_legs"]
    assert plane._full_leg_bits == (1 << legs) - 1
    assert plane._active_leg_bits == plane._full_leg_bits
    assert r["mesh"]["mesh.legs_active"] == legs
    assert len(plane._sharded_variants) <= 4


def test_warmup_on_the_mesh_leaves_the_plane_untouched():
    """warmup() launches the sharded step once on throwaway padded state
    of the plane's shapes; the plane's own state stays unbuilt."""
    from shadow_tpu_torch.core import configuration
    from shadow_tpu_torch.core.controller import Controller
    from shadow_tpu_torch.core.options import Options
    ctl = Controller(Options(device="cpu", workers=0, seed=3,
                             stop_time_sec=120, log_level="warning",
                             tpu_devices=3),
                     configuration.parse_xml(STAR_XML))
    ctl.setup()
    plane = tplane.build_plane_from_engine(ctl.engine)
    calls = []
    step = plane._sharded_step
    plane._sharded_step = lambda *a: calls.append(a) or step(*a)
    plane.warmup()
    assert len(calls) == 1 and plane._state is None
    assert calls[0][1].shape == (len(plane._shard["src"]),)
