"""``--processes N`` in the port (parallel/procs.py, a verbatim copy whose
shards build the port's Controller) against the JAX package, on the CPU.

A run partitioned over 2 or 3 OS processes ends in the state digest and
event count of the JAX package's serial run of the same config and seed:
under ``global`` (each shard on the port's C data plane where it is
eligible, as in the reference) and under ``tpu`` (each shard's hops through
the port's hop wrapper, on the CPU here, its launches in the shard's
scrape).  Also: parent-assembled checkpoints, a shard that fails at setup
(surfaces, never hangs), the CLI's dispatch, the fuzz runner's ``procs``
mode, and the JAX package's tests/test_selfheal.py shard resurrections.
"""

import io
import json
import textwrap

import pytest

from shadow_tpu.core import configuration as jconfiguration
from shadow_tpu.core.checkpoint import state_digest as jdigest
from shadow_tpu.core.controller import Controller as JController
from shadow_tpu.core.logger import SimLogger as JSimLogger
from shadow_tpu.core.logger import set_logger as jset_logger
from shadow_tpu.core.options import Options as JOptions
from shadow_tpu_torch.core import configuration
from shadow_tpu_torch.core.logger import SimLogger, set_logger
from shadow_tpu_torch.core.options import Options
from shadow_tpu_torch.parallel.procs import ProcsController
from shadow_tpu_torch.tools import workloads

LOSSY_TOPO = """<topology><![CDATA[<?xml version="1.0" encoding="UTF-8"?>
<graphml xmlns="http://graphml.graphdrawing.org/xmlns">
<key id="d0" for="edge" attr.name="latency" attr.type="double"/>
<key id="d1" for="edge" attr.name="packetloss" attr.type="double"/>
<key id="d2" for="node" attr.name="bandwidthdown" attr.type="int"/>
<key id="d3" for="node" attr.name="bandwidthup" attr.type="int"/>
<graph edgedefault="undirected">
  <node id="n0"><data key="d2">10240</data><data key="d3">10240</data></node>
  <edge source="n0" target="n0"><data key="d0">25.0</data><data key="d1">0.02</data></edge>
</graph></graphml>]]></topology>"""

# the JAX package's tests/test_procs.py mix: lossy TCP bulk and UDP over 7
# hosts, cross-shard flows both ways under every 2- and 3-way partition
XML = textwrap.dedent("""\
    <shadow stoptime="60">
      {topo}
      <plugin id="tgen" path="python:tgen" />
      <plugin id="echo" path="python:echo" />
      <host id="server"><process plugin="tgen" starttime="1" arguments="server 80" /></host>
      <host id="c1"><process plugin="tgen" starttime="2" arguments="client server 80 1024:204800" /></host>
      <host id="c2"><process plugin="tgen" starttime="3" arguments="client server 80 2048:102400" /></host>
      <host id="c3"><process plugin="tgen" starttime="4" arguments="client server 80 4096:51200" /></host>
      <host id="u1"><process plugin="echo" starttime="1" arguments="udp server 9000" /></host>
      <host id="u2"><process plugin="echo" starttime="2" arguments="udp client u1 9000 12 700" /></host>
      <host id="u3"><process plugin="echo" starttime="3" arguments="udp client u1 9000 8 300" /></host>
    </shadow>
""").format(topo=LOSSY_TOPO)
TOR = workloads.tor_network(12, n_clients=6, n_servers=1, stoptime=40,
                            stream_spec="512:20480")


def _cfg(xml, stop, cfgmod=configuration):
    cfg = cfgmod.parse_xml(xml)
    cfg.stop_time_sec = stop
    return cfg


def _jax_serial(xml, stop, seed, **kw):
    jset_logger(JSimLogger(stream=io.StringIO(), level="warning"))
    ctrl = JController(JOptions(scheduler_policy="global", workers=0,
                                seed=seed, stop_time_sec=stop,
                                log_level="warning", **kw),
                       _cfg(xml, stop, jconfiguration))
    assert ctrl.run() == 0
    return ctrl


def _sharded(n, xml=XML, stop=60, seed=7, policy="global", **kw):
    set_logger(SimLogger(stream=io.StringIO(), level="warning"))
    ctrl = ProcsController(Options(device="cpu", scheduler_policy=policy,
                                   workers=0, seed=seed, stop_time_sec=stop,
                                   processes=n, log_level="warning", **kw),
                           _cfg(xml, stop))
    assert ctrl.run() == 0
    return ctrl


_JAX: dict = {}


def _jax_key(xml=XML, stop=60, seed=7):
    k = (xml, stop, seed)
    if k not in _JAX:
        eng = _jax_serial(xml, stop, seed).engine
        _JAX[k] = (jdigest(eng), eng.events_executed, eng.rounds_executed)
    return _JAX[k]


@pytest.mark.parametrize("n,policy", [(2, "global"), (3, "global"),
                                      (2, "tpu")])
def test_shards_equal_the_jax_serial_run(n, policy, tmp_path):
    metrics = tmp_path / "m.jsonl"
    sharded = _sharded(n, policy=policy, metrics_path=str(metrics))
    assert (sharded.digest, sharded.events_executed,
            sharded.rounds_executed) == _jax_key()
    summary = [json.loads(line) for line in metrics.read_text().splitlines()
               if '"shards"' in line][-1]
    shards = summary["shards"]
    assert len(shards) == n
    for scrape in shards:
        if policy == "tpu":
            # each shard's hops ran through its own hop kernel, on the
            # device it was given (the CPU here: --device cpu)
            assert scrape["hop.device"] == "cpu"
            assert scrape["policy.device_calls"] > 0
            assert scrape["policy.host_calls"] == 0
            assert scrape["hop.launches"] == 0   # the CPU runs no kernel
        else:
            assert "hop.launches" not in scrape
            assert scrape["native.round_windows"] > 0   # the C plane


def test_c_plane_shards_equal_the_jax_serial_native_run():
    """Three shards, each on the port's C data plane (cross-shard hops
    through the C outbox), end in the JAX package's serial C-plane
    digest."""
    jax = _jax_serial(TOR, 40, 42, dataplane="native").engine
    sharded = _sharded(3, xml=TOR, stop=40, seed=42)
    assert (sharded.digest, sharded.events_executed) == \
        (jdigest(jax), jax.events_executed)


def test_sharded_checkpoints_equal_the_jax_serial_writer(tmp_path):
    """Parent-assembled snapshots carry the digests of the JAX package's
    serial CheckpointWriter at the same boundaries."""
    from shadow_tpu.core.checkpoint import load_snapshot
    d_jax = tmp_path / "jax"
    _jax_serial(XML, 60, 7, checkpoint_interval_sec=2,
                checkpoint_dir=str(d_jax))
    d_port = tmp_path / "port"
    _sharded(2, checkpoint_interval_sec=2, checkpoint_dir=str(d_port))
    names = sorted(p.name for p in d_jax.iterdir())
    assert names and names == sorted(p.name for p in d_port.iterdir())
    for name in names:
        assert load_snapshot(str(d_jax / name))["digest"] == \
            load_snapshot(str(d_port / name))["digest"], name


def test_procs_requires_two():
    with pytest.raises(ValueError):
        ProcsController(Options(device="cpu", processes=1), _cfg(XML, 60))


def test_shard_failure_surfaces_not_hangs():
    bad = XML.replace('path="python:tgen"', 'path="python:nosuchapp"')
    set_logger(SimLogger(stream=io.StringIO(), level="warning"))
    ctrl = ProcsController(Options(device="cpu", workers=0, seed=7,
                                   stop_time_sec=30, processes=2),
                           _cfg(bad, 30))
    with pytest.raises(RuntimeError, match="shard failed"):
        ctrl.run()


def test_cli_dispatch(tmp_path):
    """``python -m shadow_tpu_torch.cli config.xml --processes 2`` routes
    through run_simulation to the sharded coordinator."""
    from shadow_tpu_torch.cli import main
    path = tmp_path / "cfg.xml"
    path.write_text(XML)
    assert main([str(path), "--processes", "2", "--stop-time", "30",
                 "--log-level", "warning", "--device", "cpu",
                 "--data-directory", str(tmp_path / "data")]) == 0


def test_fuzz_runner_procs_mode_equals_jax():
    """The fuzz runner's ``procs`` mode runs ProcsController (it was
    refused before), with the JAX runner's digest and events."""
    from shadow_tpu.fuzz import gen as jgen
    from shadow_tpu.fuzz import runner as jrunner
    from shadow_tpu_torch.fuzz import gen, runner
    spec = gen.draw_spec(3)
    assert spec == jgen.draw_spec(3)
    mode = gen._mode("procs", processes=2, events_comparable=False)
    ours = runner.run_one_mode(spec, mode, device="cpu")
    theirs = jrunner.run_one_mode(spec, mode)
    assert ours["rc"] == theirs["rc"] == 0, ours["log_tail"]
    assert (ours["digest"], ours["events"]) == \
        (theirs["digest"], theirs["events"])


# -- shard resurrection (the JAX package's tests/test_selfheal.py) ---------

def test_shard_killed_midrun_resurrected_digest_identical():
    res = _sharded(2, fault_inject="shard-exit-resurrect:1:3")
    assert (res.digest, res.events_executed) == _jax_key()[:2]
    s = res.supervision.summary()
    assert s["shard_deaths_detected"] == 1
    assert s["shard_resurrections"] == 1
    assert s["mttr_sec"] > 0 and s["recoveries"] >= 2


def test_resurrection_verified_at_checkpoint_boundary(tmp_path):
    res = _sharded(2, fault_inject="shard-exit-resurrect:0:20",
                   checkpoint_every_rounds=8,
                   checkpoint_dir=str(tmp_path / "ck"))
    assert res.digest == _jax_key()[0]
    assert res.supervision.shard_resurrections == 1


def test_resurrection_budget_exhaustion_aborts_loudly():
    set_logger(SimLogger(stream=io.StringIO(), level="warning"))
    ctrl = ProcsController(Options(device="cpu", workers=0, seed=7,
                                   stop_time_sec=60, processes=2,
                                   fault_inject="shard-exit-resurrect:1:3",
                                   max_resurrections=0), _cfg(XML, 60))
    with pytest.raises(RuntimeError, match="resurrection budget exhausted"):
        ctrl.run()
