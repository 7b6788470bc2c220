"""The HostTable scale tier in the port, on the CPU, against the JAX package.

The table-parity set of ``tests/test_scale.py``: a simulation booted as
HostTable rows (``--host-table=on``) has the state digest of the same
simulation booted eagerly, in the port and in the JAX package alike —
the mixed small config (quiet rows, lazily promoted clients), tor200
under ``global`` and ``tpu``, the star workload's device-mode clients on
the device plane (``--device cpu``) and its numpy twin, and a mid-run
checkpoint resumed from a table-mode snapshot.  Then the generated
scenarios (processless ``<flow>``s on the device plane, nothing
materialized), the generators' determinism, and the ``mkscenario`` CLI.
Tolerance: none (digests).
"""

import glob
import io
import json
import pickle

import pytest

from shadow_tpu.core import configuration as jconfiguration
from shadow_tpu.core.checkpoint import state_digest as jstate_digest
from shadow_tpu.core.controller import Controller as JController
from shadow_tpu.core.logger import SimLogger as JSimLogger
from shadow_tpu.core.logger import set_logger as jset_logger
from shadow_tpu.core.options import Options as JOptions
from shadow_tpu.scale import genscen as jgenscen
from shadow_tpu_torch.core import configuration
from shadow_tpu_torch.core.checkpoint import state_digest
from shadow_tpu_torch.core.controller import Controller
from shadow_tpu_torch.core.logger import SimLogger, set_logger
from shadow_tpu_torch.core.options import Options
from shadow_tpu_torch.scale import genscen
from shadow_tpu_torch.tools import mkscenario
from shadow_tpu_torch.tools.workloads import star_bulk, tor_network

MIXED_XML = """<shadow stoptime="60">
  <plugin id="tgen" path="python:tgen" />
  <host id="server" bandwidthdown="102400" bandwidthup="102400">
    <process plugin="tgen" starttime="1" arguments="server 80" />
  </host>
  <host id="client" quantity="3" bandwidthdown="10240" bandwidthup="5120">
    <process plugin="tgen" starttime="5" arguments="client server 80 1024:204800" />
  </host>
  <host id="quiet" quantity="5" bandwidthdown="10240" bandwidthup="5120">
  </host>
</shadow>"""


def _run(xml, stop, table, policy="global", seed=7, **kw):
    """The port's run on the CPU; returns the controller."""
    set_logger(SimLogger(stream=io.StringIO(), level="warning"))
    cfg = configuration.parse_xml(xml) if isinstance(xml, str) else xml
    cfg.stop_time_sec = stop
    ctrl = Controller(Options(scheduler_policy=policy, workers=0,
                              stop_time_sec=stop, seed=seed,
                              host_table=table, dataplane="python",
                              device="cpu", **kw), cfg)
    assert ctrl.run() == 0
    return ctrl


def _jax_digest(xml, stop, table, policy="global", seed=7, **kw):
    """The JAX package's run of the same config."""
    jset_logger(JSimLogger(stream=io.StringIO(), level="warning"))
    cfg = jconfiguration.parse_xml(xml) if isinstance(xml, str) else xml
    cfg.stop_time_sec = stop
    ctrl = JController(JOptions(scheduler_policy=policy, workers=0,
                                stop_time_sec=stop, seed=seed,
                                host_table=table, dataplane="python", **kw),
                       cfg)
    assert ctrl.run() == 0
    return (jstate_digest(ctrl.engine), ctrl.engine.events_executed,
            ctrl.engine.rounds_executed)


def test_table_parity_mixed_small():
    """Quiet rows + lazily promoted clients: the port's table boot equals
    its eager boot and the JAX package's table boot; the quiet hosts never
    materialize."""
    off = _run(MIXED_XML, 60, "off")
    on = _run(MIXED_XML, 60, "on")
    got = (state_digest(on.engine), on.engine.events_executed,
           on.engine.rounds_executed)
    assert got == (state_digest(off.engine), off.engine.events_executed,
                   off.engine.rounds_executed)
    assert got == _jax_digest(MIXED_XML, 60, "on")
    table = on.engine.host_table
    assert table.materialized_count == 4
    assert table.unmaterialized_count() == 5
    assert off.engine.host_table is None


@pytest.mark.parametrize("policy", ["global", "tpu"])
def test_table_parity_tor200(policy):
    """305 hosts, circuit builds over real TCP: the port's table-mode run
    (global, and tpu with the hop's plain version) equals the JAX
    package's eager run."""
    xml = tor_network(200, n_clients=100, n_servers=5, stoptime=24,
                      stream_spec="512:20480")
    oracle = _jax_digest(xml, 24, "off")
    on = _run(xml, 24, "on", policy=policy)
    assert (state_digest(on.engine), on.engine.events_executed,
            on.engine.rounds_executed) == oracle


def test_table_parity_star_device_modes():
    """star (tgen device-mode clients, plugin-driven) under tpu: table on
    and off, the device plane (plain torch on the CPU) and its numpy twin
    all equal, and equal the JAX package's device-plane run."""
    xml = star_bulk(12, stoptime=60, bulk_bytes=512 * 1024,
                    device_data=True)
    oracle = _jax_digest(xml, 60, "on", policy="tpu",
                         device_plane="device")[0]
    for table, mode in (("off", "numpy"), ("on", "numpy"), ("on", "device")):
        ctrl = _run(xml, 60, table, policy="tpu", device_plane=mode)
        assert state_digest(ctrl.engine) == oracle, (table, mode)


def test_midrun_checkpoint_parity_and_resume(tmp_path):
    """Mid-run snapshots of a table-mode run match the eager run's, and a
    --resume from the table-mode snapshots replays to the same digest."""
    off_dir, on_dir = str(tmp_path / "off"), str(tmp_path / "on")
    off = _run(MIXED_XML, 60, "off", checkpoint_every_rounds=10,
               checkpoint_dir=off_dir)
    on = _run(MIXED_XML, 60, "on", checkpoint_every_rounds=10,
              checkpoint_dir=on_dir)
    assert state_digest(on.engine) == state_digest(off.engine)
    snaps_off = sorted(glob.glob(off_dir + "/*.ckpt"))
    snaps_on = sorted(glob.glob(on_dir + "/*.ckpt"))
    assert snaps_off and len(snaps_off) == len(snaps_on)
    for a, b in zip(snaps_off, snaps_on):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert pickle.load(fa)["digest"] == pickle.load(fb)["digest"]
    resumed = _run(MIXED_XML, 60, "on", resume_path=on_dir)
    assert resumed.engine.supervision.resume_verified
    assert state_digest(resumed.engine) == state_digest(off.engine)


def test_flows_without_table_refused():
    """Processless flows need the table: the eager boot refuses them."""
    cfg = genscen.star(4, stoptime=10)
    with pytest.raises(ValueError, match="flows need the host table"):
        _run(cfg, 10, "off")


@pytest.mark.parametrize("family,kw", [
    ("star", dict(n_clients=60, stoptime=60, stagger_waves=2,
                  stagger_step_sec=1.0)),
    ("tor", dict(n_hosts=120, stoptime=60, stagger_waves=2)),
    ("cdn", dict(n_clients=40, n_origins=2, stoptime=40, stagger_waves=1,
                 down_bytes=8192)),
])
def test_generated_flows_on_device_plane(family, kw):
    """Generated scenarios: every processless flow completes on the port's
    device plane (plain torch on the CPU) with no host materialized, and
    the digest equals its numpy twin's and the JAX package's."""
    def run(mode):
        set_logger(SimLogger(stream=io.StringIO(), level="warning"))
        cfg = genscen.build(family, **kw)
        ctrl = Controller(Options(scheduler_policy="global", workers=0,
                                  stop_time_sec=int(cfg.stop_time_sec),
                                  seed=7, host_table="on",
                                  heartbeat_interval_sec=0,
                                  device_plane=mode, device="cpu"), cfg)
        assert ctrl.run() == 0
        return ctrl
    dev = run("device")
    st = dev.engine.device_plane.stats()
    assert st["completed"] == st["circuits"] > 0
    assert dev.engine.host_table.materialized_count == 0
    digest = state_digest(dev.engine)
    assert digest == state_digest(run("numpy").engine)
    jset_logger(JSimLogger(stream=io.StringIO(), level="warning"))
    jcfg = jgenscen.build(family, **kw)
    jctrl = JController(JOptions(scheduler_policy="global", workers=0,
                                 stop_time_sec=int(jcfg.stop_time_sec),
                                 seed=7, host_table="on",
                                 heartbeat_interval_sec=0,
                                 device_plane="numpy"), jcfg)
    assert jctrl.run() == 0
    assert digest == jstate_digest(jctrl.engine)


def test_genscen_deterministic_and_equal_to_jax():
    for name in ("star10k", "tor10k", "cdn2k", "swarm500", "mixnet500"):
        d = genscen.config_digest(genscen.build(name))
        assert d == genscen.config_digest(genscen.build(name))
        assert d == jgenscen.config_digest(jgenscen.build(name))
    assert genscen.config_digest(genscen.build("tor10k", seed=1)) != \
        genscen.config_digest(genscen.build("tor10k", seed=2))
    with pytest.raises(ValueError, match="stoptme"):
        genscen.build("star", stoptme=5)


def test_mkscenario_summary_and_xml(capsys):
    assert mkscenario.main(["tor10k", "--seed", "3"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert got["scenario"] == "tor10k" and got["hosts"] == 10_000
    assert got["flows"] == 8_900
    assert got["digest"] == jgenscen.config_digest(
        jgenscen.build("tor10k", seed=3))
    assert mkscenario.main(["star2k", "--xml"]) == 0
    xml = capsys.readouterr().out
    cfg = configuration.parse_xml(xml)
    assert sum(h.quantity for h in cfg.hosts) == 2_001
    assert mkscenario.main(["nope"]) == 2
    assert mkscenario.main(["tor10k", "--seed"]) == 2
    assert mkscenario.main([]) == 2


def test_mkscenario_run_on_cpu(capsys):
    """``--run`` executes the scenario with the table on, on the port's
    ``--device`` (here the CPU), and returns the engine's exit code."""
    rc = mkscenario.main(["star2k", "--run", "--stop-time", "20",
                          "--device", "cpu", "--log-level", "warning"])
    assert rc == 0
