"""The port's ``tpu`` policy end to end against the JAX package, on the CPU.

Case (a): the lossy 2-host config of tests/test_tpu_policy.py (its text,
copied).  The port's ``tpu`` run must equal the JAX package's ``tpu`` run
and the port's own ``global`` run on drops, server_in, client_out and
rounds — and on the state digest.  The helpers here also serve the tor
cases in test_torch_tpu_policy_tor.py and test_torch_tpu_policy_chunk.py
(split across files so xdist's loadfile spreads them).
"""

import textwrap

import pytest

import shadow_tpu.core.checkpoint as jckpt
import shadow_tpu.core.configuration as jconf
import shadow_tpu.core.controller as jctl
import shadow_tpu.core.options as jopt
import shadow_tpu.tools.workloads as jwork
import shadow_tpu_torch.core.checkpoint as tckpt
import shadow_tpu_torch.core.configuration as tconf
import shadow_tpu_torch.core.controller as tctl
import shadow_tpu_torch.core.options as topt
from shadow_tpu_torch.tools.synth_topology import lossy_complete_graphml

PACKAGES = {"jax": (jconf, jctl, jopt, jckpt),
            "torch": (tconf, tctl, topt, tckpt)}

LOSSY_TOPOLOGY = textwrap.dedent("""\
    <graphml xmlns="http://graphml.graphdrawing.org/xmlns">
      <key id="d0" for="node" attr.name="bandwidthdown" attr.type="int"/>
      <key id="d1" for="node" attr.name="bandwidthup" attr.type="int"/>
      <key id="d2" for="edge" attr.name="latency" attr.type="double"/>
      <key id="d3" for="edge" attr.name="packetloss" attr.type="double"/>
      <key id="d4" for="node" attr.name="ip" attr.type="string"/>
      <graph edgedefault="undirected">
        <node id="a"><data key="d0">10240</data><data key="d1">10240</data>
              <data key="d4">11.0.0.1</data></node>
        <node id="b"><data key="d0">10240</data><data key="d1">10240</data>
              <data key="d4">11.0.0.2</data></node>
        <edge source="a" target="b">
          <data key="d2">25.0</data><data key="d3">0.15</data>
        </edge>
        <edge source="a" target="a"><data key="d2">1.0</data></edge>
        <edge source="b" target="b"><data key="d2">1.0</data></edge>
      </graph>
    </graphml>
""")


def two_host_xml(n_msgs=40, stoptime=120, interval=0.05):
    return textwrap.dedent(f"""\
        <shadow stoptime="{stoptime}">
          <topology><![CDATA[{LOSSY_TOPOLOGY}]]></topology>
          <plugin id="src" path="python:source" />
          <plugin id="sink" path="python:sink" />
          <host id="server" iphint="11.0.0.1">
            <process plugin="sink" starttime="1" arguments="udp 8000" />
          </host>
          <host id="client" iphint="11.0.0.2">
            <process plugin="src"
                     starttime="2" arguments="udp server 8000 {n_msgs} 256 {interval}" />
          </host>
        </shadow>
    """)


def small_tor_xml():
    """A small tor_network (10 relays, 10 clients, 2 servers) on a seeded
    12-vertex complete lossy GraphML."""
    return jwork.tor_network(10, n_clients=10, n_servers=2, stoptime=20), \
        lossy_complete_graphml(12, 3)


def run(pkg, xml, policy, topology_text=None, seed=11, **extra):
    """Run one config through one package; returns the parity fields."""
    conf, ctl, opt, ckpt = PACKAGES[pkg]
    cfg = conf.parse_xml(xml)
    if topology_text is not None:
        cfg.topology_text = topology_text
    if pkg == "torch":
        extra.setdefault("device", "cpu")
    else:
        # the JAX package's C plane would engage under global; the
        # comparisons here are against its tpu runs, which never use it
        extra.setdefault("dataplane", "python")
    opts = opt.Options(scheduler_policy=policy, seed=seed,
                       stop_time_sec=cfg.stop_time_sec, log_level="warning",
                       **extra)
    c = ctl.Controller(opts, cfg)
    assert c.run() == 0
    e = c.engine
    out = {"digest": ckpt.state_digest(e),
           "events": e.events_executed,
           "rounds": e.rounds_executed,
           "drops": e.counters._new.get("packet_drop", 0)}
    server = e.host_by_name("server")
    client = e.host_by_name("client")
    if server is not None and client is not None:
        out["server_in"] = server.tracker.in_remote.packets_data
        out["client_out"] = client.tracker.out_remote.packets_data
    kern = getattr(e.scheduler.policy, "_kernel", None)
    if kern is not None:
        out["device_calls"] = kern.device_calls
        out["host_calls"] = kern.host_calls
    return out


PARITY = ("digest", "events", "rounds", "drops")


@pytest.fixture(scope="module")
def jax_two_host():
    return run("jax", two_host_xml(), "tpu")


def test_lossy_two_host_port_tpu_equals_jax_tpu_and_port_global(jax_two_host):
    port_tpu = run("torch", two_host_xml(), "tpu")
    port_global = run("torch", two_host_xml(), "global")
    assert jax_two_host["drops"] > 0, "the config must exercise lossy links"
    for key in PARITY + ("server_in", "client_out"):
        assert port_tpu[key] == jax_two_host[key], key
        assert port_global[key] == jax_two_host[key], key
    assert port_tpu["device_calls"] > 0 and port_tpu["host_calls"] == 0


@pytest.mark.parametrize("extra", [{"tpu_max_inflight": 1},
                                   {"tpu_max_inflight": 3, "workers": 2}])
def test_lossy_two_host_chunked_batches_match(jax_two_host, extra):
    """--tpu-max-inflight smaller than a round's batch splits it into
    several launches, all pending at once: the same result."""
    port = run("torch", two_host_xml(), "tpu", **extra)
    for key in PARITY + ("server_in", "client_out"):
        assert port[key] == jax_two_host[key], key


def test_seed_changes_the_loss_pattern(jax_two_host):
    other = run("torch", two_host_xml(), "tpu", seed=12)
    assert (other["drops"], other["server_in"]) != \
        (jax_two_host["drops"], jax_two_host["server_in"])
