"""chip_smoke.py's tor1k and tor10k slices under ``global`` on the C data
plane, at full size on the CPU (marker ``slow``: a few minutes each,
outside the tier-1 gate).

The smoke's ``native`` phase holds these runs to EXPECTED and EXPECTED10K,
which were made under ``tpu`` on the Python plane.  The state digest does
not depend on the scheduler policy or the data plane; this is where that
is checked at these sizes: the JAX package under ``global`` with
``--dataplane=native`` (its device plane on one XLA CPU device for tor10k,
its wakes pushed into the C plane's event heap) and the port's CPU run of
the same give EXPECTED's digest, events, rounds and drops, and
EXPECTED10K's digest, events, completed flows and forwards.  The smoke's
``plugins`` phase holds its exec: and pool: runs to EXPECTED_PLUGINS,
made here from the JAX package under ``global`` (the binaries compiled
with cc into a temporary directory; the digest does not depend on where),
and the port's CPU runs under ``global`` and ``tpu`` give the same.  Run
with ``python -m pytest -m slow tests/test_torch_native_slices.py``.
"""

import os

import pytest

import chip_smoke
from test_torch_device_plane import PACKAGES, fresh_logger

pytestmark = pytest.mark.slow


def _run(pkg, cfg_xml, stop, seed, topology_text=None, **opts):
    conf, ctl, opt, ckpt = PACKAGES[pkg]
    fresh_logger(pkg)
    cfg = conf.parse_xml(cfg_xml)
    if topology_text:
        cfg.topology_text = topology_text
    extra = {"device": "cpu"} if pkg == "torch" else {}
    c = ctl.Controller(opt.Options(
        scheduler_policy="global", workers=0, seed=seed, tpu_devices=1,
        stop_time_sec=stop, log_level="warning", dataplane="native",
        **extra, **opts), cfg)
    assert c.run() == 0
    e = c.engine
    assert e.native_plane is not None
    out = {"digest": ckpt.state_digest(e), "events": e.events_executed,
           "rounds": e.rounds_executed,
           "drops": e.counters._new.get("packet_drop", 0)}
    if e.device_plane is not None:
        st = e.device_plane.stats()
        out.update(completed=st["completed"], forwards=st["forwards"],
                   dispatches=st["dispatches"])
    return out


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_tor1k_on_the_c_plane_matches_expected(pkg):
    from shadow_tpu_torch.tools.synth_topology import lossy_complete_graphml
    from shadow_tpu_torch.tools.workloads import tor_network
    t = chip_smoke.TOR1K
    got = _run(pkg, tor_network(t["n_relays"], stoptime=t["stoptime"]),
               t["stoptime"], t["seed"],
               topology_text=lossy_complete_graphml(t["graph_vertices"],
                                                    t["graph_seed"]))
    want = {k: chip_smoke.EXPECTED[k]
            for k in ("digest", "events", "rounds", "drops")}
    assert got == want


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_tor10k_on_the_c_plane_matches_expected10k(pkg):
    from shadow_tpu_torch.tools.workloads import tor_network
    t = chip_smoke.TOR10K
    got = _run(pkg, tor_network(t["n_relays"], stoptime=t["stoptime"],
                                device_data=True), t["stoptime"], t["seed"])
    for key in ("digest", "events", "completed", "forwards"):
        assert got[key] == chip_smoke.EXPECTED10K[key], key
    print(pkg, got)


@pytest.mark.parametrize("pkg,policy", [("jax", "global"),
                                        ("torch", "global"),
                                        ("torch", "tpu")])
def test_plugins_match_expected_plugins(pkg, policy, tmp_path):
    conf, ctl, opt, ckpt = PACKAGES[pkg]
    extra = {"device": "cpu"} if pkg == "torch" else {}
    for kind, path in chip_smoke.plugin_binaries(str(tmp_path)).items():
        fresh_logger(pkg)
        stop = chip_smoke.PLUGIN_STOP[kind]
        c = ctl.Controller(opt.Options(
            scheduler_policy=policy, seed=1, stop_time_sec=stop,
            log_level="warning",
            data_directory=os.path.join(tmp_path, f"{kind}-data"), **extra),
            conf.parse_xml(chip_smoke.plugin_config(kind, path)))
        assert c.run() == 0
        assert {p.exit_code for h in c.engine.hosts.values()
                for p in h.processes} == {0}
        assert {"digest": ckpt.state_digest(c.engine),
                "events": c.engine.events_executed} == \
            chip_smoke.EXPECTED_PLUGINS[kind]
