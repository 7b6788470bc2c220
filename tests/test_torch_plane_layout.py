"""The port's device-plane layout against the JAX package's, array by array.

Each case boots one configuration in both packages (``Controller.setup``,
the same options and seed, on the CPU), then builds the device traffic
plane in numpy mode: the flow table (nodes, latencies, successors,
segments, chains, stages, entry and exit flows), the node buckets, the
granule and ring, each node's kind, and each host's node list (a live
host's tracker feed, a table row's registration) must be equal.  The
cases cover the processless table flows of a generated tor network,
star-bulk tgen clients, plugin tor clients on static and on ``auto:``
routes, ``dest_seed`` flows with many chains a host, live hosts mixed
with table rows, and a granule override.  An unknown host, or a name
that only aliases a table row, fails alike in both.
Tolerance: none (equality).
"""

import io

import numpy as np
import pytest

import shadow_tpu.core.configuration as jconf
import shadow_tpu.core.controller as jctl
import shadow_tpu.core.logger as jlog
import shadow_tpu.core.options as jopt
import shadow_tpu.parallel.device_plane as jplane
import shadow_tpu.scale.genscen as jgenscen
import shadow_tpu_torch.core.configuration as tconf
import shadow_tpu_torch.core.controller as tctl
import shadow_tpu_torch.core.logger as tlog
import shadow_tpu_torch.core.options as topt
import shadow_tpu_torch.parallel.device_plane as tplane
import shadow_tpu_torch.scale.genscen as tgenscen
from shadow_tpu_torch.tools.workloads import star_bulk, tor_network

PACKAGES = {"jax": (jconf, jctl, jlog, jopt, jplane, jgenscen),
            "torch": (tconf, tctl, tlog, topt, tplane, tgenscen)}
ARRAYS = ("flow_node", "flow_lat", "flow_lat_steps", "flow_succ",
          "seg_start", "flow_circ", "flow_stage", "first_flow", "last_flow",
          "refill", "capacity", "refill_step", "capacity_step",
          "_has_upload")
SCALARS = ("granule", "ring_len", "n_flows", "n_nodes", "n_chains")
STOP = 60


def _xml(text):
    return lambda conf, _genscen: conf.parse_xml(text)


def _gen(family, **kw):
    return lambda _conf, genscen: genscen.build(family, **kw)


TOR_SMALL = _gen("tor", n_hosts=120, stoptime=STOP, stagger_waves=2)
CASES = {
    "genscen_tor": (TOR_SMALL, "on", (), {}),
    "star_bulk_tgen": (_xml(star_bulk(12, stoptime=STOP, bulk_bytes=65536,
                                      device_data=True)), "off", (), {}),
    "tor_static_routes": (_xml(tor_network(
        8, n_clients=5, n_servers=2, stoptime=STOP, stream_spec="512:20200",
        device_data=True)), "on", (), {}),
    "tor_auto_routes": (_xml(tor_network(
        8, n_clients=5, n_servers=2, stoptime=STOP, stream_spec="512:20200",
        dirauth=True, device_data=True)), "off", (), {}),
    "swarm_dest_seed": (_gen("swarm", n_peers=40, pieces=3, stoptime=STOP),
                        "on", (), {}),
    "cdn_dest_seed": (_gen("cdn", n_clients=30, n_origins=2, stoptime=STOP),
                      "on", (), {}),
    "live_and_table_rows": (TOR_SMALL, "on",
                            ("relay3", "dest", "torclient5", "torclient60"),
                            {}),
    "granule_override": (TOR_SMALL, "on", (),
                         {"device_plane_granule_ms": 3}),
}


def _boot(pkg, make_cfg, table_mode, materialize=(), **extra):
    """``pkg``'s engine after ``Controller.setup``, with the rows named in
    ``materialize`` made live hosts."""
    conf, ctl, log, opt, _plane, genscen = PACKAGES[pkg]
    log.set_logger(log.SimLogger(stream=io.StringIO(), level="warning"))
    cfg = make_cfg(conf, genscen)
    cfg.stop_time_sec = STOP
    if pkg == "torch":
        extra["device"] = "cpu"
    c = ctl.Controller(opt.Options(scheduler_policy="global", workers=0,
                                   seed=7, stop_time_sec=STOP,
                                   host_table=table_mode,
                                   heartbeat_interval_sec=0,
                                   log_level="warning", device_plane="numpy",
                                   **extra), cfg)
    c.setup()
    for name in materialize:
        assert c.engine.host_table.materialize_by_name(name) is not None
    return c.engine


def _layout(pkg, make_cfg, table_mode, materialize=(), **extra):
    engine = _boot(pkg, make_cfg, table_mode, materialize, **extra)
    plane = PACKAGES[pkg][4].build_plane_from_engine(engine, mode="numpy")
    out = {k: np.asarray(getattr(plane, k)) for k in ARRAYS}
    out.update({k: int(getattr(plane, k)) for k in SCALARS})
    out["node_kind"] = [str(k) for k in plane.node_kind]
    feeds = {}
    for name, host in engine.hosts_by_name.items():
        feed = host.tracker._device_feed
        if feed is not None:
            assert feed[0] is plane
            feeds[name] = ("live", [int(i) for i in feed[1]])
    table = engine.host_table
    if table is not None:
        for row, nodes in table._dev_nodes.items():
            assert not table.materialized[row]
            feeds[table.name_of(row)] = ("row", [int(i) for i in nodes])
    out["feeds"] = feeds
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_layout_equals_jax(case):
    make_cfg, table_mode, materialize, extra = CASES[case]
    port = _layout("torch", make_cfg, table_mode, materialize, **extra)
    ref = _layout("jax", make_cfg, table_mode, materialize, **extra)
    assert port["n_flows"] > 0 and port["feeds"]
    for key, want in ref.items():
        got = port[key]
        if isinstance(want, np.ndarray):
            assert got.dtype == want.dtype, key
            assert np.array_equal(got, want), key
        else:
            assert got == want, key
    kinds = {k for k, _nodes in port["feeds"].values()}
    if materialize:
        assert kinds == {"live", "row"}
    if extra:
        assert port["granule"] == extra["device_plane_granule_ms"]


BAD_SERVER = """<shadow stoptime="60">
  <plugin id="tgen" path="python:tgen" />
  <host id="server" quantity="2" bandwidthdown="102400" bandwidthup="102400">
    <process plugin="tgen" starttime="1" arguments="server 80" />
  </host>
  <host id="client" quantity="3" bandwidthdown="10240" bandwidthup="5120">
    <process plugin="tgen" starttime="5"
             arguments="client {server} 80 1024:204800 device" />
  </host>
</shadow>"""


@pytest.mark.parametrize("table_mode,server", [
    ("off", "nosuch"), ("on", "nosuch"), ("on", "server01")])
def test_unknown_host_fails_as_in_jax(table_mode, server):
    """A route through a host nobody defines, or through a spelling that
    only aliases a table row (``server01`` for ``server1``), fails with the
    same error in both packages."""
    make_cfg = _xml(BAD_SERVER.format(server=server))
    errors = []
    for pkg in ("torch", "jax"):
        engine = _boot(pkg, make_cfg, table_mode)
        with pytest.raises(ValueError) as err:
            PACKAGES[pkg][4].build_plane_from_engine(engine, mode="numpy")
        errors.append(str(err.value))
    assert errors[0] == errors[1] == f"device plane: unknown host {server!r}"
