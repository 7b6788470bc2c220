"""Processless Tor experiments on the device traffic plane: the shape of
the benchmark's first cells.

A configuration file gives the relays, the servers and the clients with
their rates, the one vertex's latency and the stoptime; a mix gives the
clients' transfer sizes and arrival waves.  Every number reaches the
program (:func:`configuration`), and the plain reference
(``portbench/reference.py``) reads the same files.  An episode is one
whole experiment under the ``global`` policy on one card, its host table
on; its answers are the device plane's: each chain's completion, each
host's bytes sent and received, the cells forwarded, the circuits
completed.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from portbench import reference

KERNELS = {"serial": ("torcells_span", "pack_flush"),
           "fleet": ("torcells_span_batched", "pack_flush")}
PARTS = ("chains", "hosts", "forwards", "completed", "exit_code")
# a few hundred hosts, a few waves, seconds of simulated time
TINY_CONFIG = {"hosts": 300, "relays": 30, "servers": 3, "clients": 267,
               "stoptime_s": 6}
TINY_TRAFFIC = {"waves": 3}


# the groups of a configuration file: (host id, count key, up rate key,
# down rate key); the reference names the hosts the same way
GROUPS = (("relay", "relays", "relay_kibps", "relay_kibps"),
          ("dest", "servers", "server_kibps", "server_kibps"),
          ("torclient", "clients", "client_up_kibps", "client_down_kibps"))


def one_vertex_graphml(latency_ms: float) -> str:
    """A topology of one vertex whose self-loop takes ``latency_ms`` (a
    path between two of its hosts takes the loop twice)."""
    return (
        '<graphml xmlns="http://graphml.graphdrawing.org/xmlns">'
        '<key id="d0" for="edge" attr.name="latency" attr.type="double"/>'
        '<key id="d1" for="edge" attr.name="packetloss" attr.type="double"/>'
        '<key id="d2" for="node" attr.name="countrycode" '
        'attr.type="string"/>'
        '<key id="d3" for="node" attr.name="type" attr.type="string"/>'
        '<graph edgedefault="undirected">'
        '<node id="poi-1"><data key="d2">US</data><data key="d3">net</data>'
        '</node><edge source="poi-1" target="poi-1">'
        f'<data key="d0">{float(latency_ms)}</data>'
        '<data key="d1">0.0</data></edge></graph></graphml>')


def configuration(config: Dict, traffic: Dict, stoptime: int,
                  path_seed: int):
    """The program's ``Configuration`` of one experiment: a host group for
    the relays, the servers and the clients with the file's counts and
    rates, the file's one-vertex latency, and one ``FlowConfig`` for the
    clients carrying the mix's transfer sizes and arrival waves and the
    seeded draw of each client's circuit over the file's relays and
    servers."""
    from shadow_tpu_torch.core.configuration import (Configuration,
                                                     FlowConfig, HostConfig)
    counts = [int(config[key]) for _id, key, _up, _down in GROUPS]
    if sum(counts) != int(config["hosts"]) or counts[0] < 3 \
            or counts[1] < 1 or counts[2] < 1:
        raise ValueError(
            f"portbench: {config.get('name')}: relays, servers and clients "
            f"{counts} must be >= 3, >= 1, >= 1 and add up to hosts "
            f"{config['hosts']}")
    cfg = Configuration(stop_time_sec=stoptime,
                        topology_text=one_vertex_graphml(
                            config["vertex_latency_ms"]))
    for (host_id, _key, up, down), n in zip(GROUPS, counts):
        cfg.hosts.append(HostConfig(
            id=host_id, quantity=n,
            bandwidth_down_kibps=int(config[down]),
            bandwidth_up_kibps=int(config[up])))
    cfg.hosts[-1].flows.append(FlowConfig(
        dest="", start_time_sec=float(traffic["start_s"]),
        down_bytes=int(traffic["down_bytes"]),
        up_bytes=int(traffic["up_bytes"]),
        stagger_waves=int(traffic["waves"]),
        stagger_step_sec=float(traffic["step_s"]),
        tor_path_seed=path_seed, tor_relays=counts[0],
        tor_relay_prefix=GROUPS[0][0], tor_servers=counts[1],
        tor_server_prefix=GROUPS[1][0]))
    return cfg


def options(config: Dict, traffic: Dict, *, seed: int, stoptime: int,
            device: str, chips: int, control: bool):
    """One card whatever ``chips`` is; the control runs the plane at a
    2 ms tick (``--device-plane-granule-ms 2``)."""
    from shadow_tpu_torch.core.options import Options
    return Options(scheduler_policy="global", device=device,
                   workers=0, seed=seed, host_table="on",
                   heartbeat_interval_sec=0, stop_time_sec=stoptime,
                   log_level="warning",
                   device_plane_granule_ms=2 if control else 0)


def warm_stoptime(config: Dict, traffic: Dict) -> int:
    """The experiment cut to its first wave."""
    return int(traffic["start_s"]) + 1


def record(ctl) -> Dict:
    eng = ctl.engine
    plane = eng.device_plane
    table = eng.host_table
    n = eng.total_host_count()
    return {"dispatches": plane.dispatches,
            "device_ns": plane.device_ns,
            "granule": plane.granule,
            "chain_done": plane._chain_done.copy(),
            "forwards": int(plane.total_forwards),
            "completed": len(plane._done),
            "tx": table.tx_bytes[:n].copy(),
            "rx": table.rx_bytes[:n].copy(),
            # (name, quantity, first row, rows) of each host group;
            # never the groups themselves, which hold the engine
            "groups": [(g.hc.id, g.hc.quantity, g.first_row, g.count)
                       for g in table.groups]}


def done_ms(done: np.ndarray, granule: int) -> np.ndarray:
    """A chain's completion as the end of its tick in ms, -1 for none."""
    return np.where(done >= 0, (done + 1) * granule, -1)


def compare(rec: Dict, out: reference.Outcome,
            net: reference.Network) -> Dict[str, int]:
    """One episode's answers that differ from the reference's, by kind:
    the time each chain delivered its last cell (the end of its tick in
    ms, so a coarser tick cannot hide), each host's bytes sent and
    received as the plane's flush folded them into the host table, the
    cells forwarded, the circuits completed, and the exit code."""
    rows = {}
    for name, quantity, first, count in rec["groups"]:
        for q in range(count):
            rows[name if quantity == 1 else f"{name}{q + 1}"] = first + q
    idx = np.array([rows.get(nm, -1) for nm in net.host_names])
    missing = idx < 0
    idx = np.maximum(idx, 0)
    tx = np.where(missing, -1, rec["tx"][idx])
    rx = np.where(missing, -1, rec["rx"][idx])
    got = done_ms(rec["chain_done"], rec["granule"])
    want = done_ms(out.done_tick, out.granule_ms)
    off = len(want) if got.shape != want.shape else int((got != want).sum())
    return {"chains": off,
            "hosts": int(((tx != out.host_tx) | (rx != out.host_rx)).sum()),
            "forwards": int(rec["forwards"] != out.forwards),
            "completed": int(rec["completed"] != out.completed),
            "exit_code": int(rec["rc"] != 0)}


def check(rec: Dict, config: Dict, traffic: Dict, device):
    net = reference.tor_network(config, traffic, rec["draw_seed"])
    out = reference.simulate(net, device)
    return compare(rec, out, net), out
