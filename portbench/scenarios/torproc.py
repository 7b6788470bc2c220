"""Tor with processes under the ``tpu`` policy: a directory authority,
relays that publish weighted descriptors, clients that fetch the
consensus and build their circuits over TCP on a lossy graph, and bulk
data on the device plane.

A configuration file gives the host counts, the rates, the graph's size,
the bootstrap and the stoptime; a mix gives the clients' streams.
The program builds the network with its own generator
(``tools/workloads.tor_network(dirauth=True, device_data=True)``) on
``tools/synth_topology.lossy_complete_graphml``, both seeded with the
episode's draw seed; the numbers the generator fixes (the rates, the
start rule) are held to the files, so every number of a file reaches the
program or stops it.  An episode is one whole experiment under
``--scheduler-policy=tpu`` on one card, every round's packets hopped by
``packet_hop``, with the hop record on; its answers are held to
``portbench/reference_torproc.py``.
"""

from __future__ import annotations

import sys
from typing import Dict

import numpy as np

from portbench import reference_torproc as reference

KERNELS = {"serial": ("packet_hop", "torcells_span", "pack_flush")}
PARTS = ("paths", "hops", "chains", "apps", "exit_code")
# a 64-host network on 6 vertices, run until every client has finished
# (the generator starts clients in [5, 35) s whatever the network's size)
TINY_CONFIG = {"hosts": 64, "relays": 30, "servers": 3, "clients": 30,
               "vertices": 6, "stoptime_s": 40}
TINY_TRAFFIC: Dict = {}

# each host id's prefix in the generator, and the file's rates for it
GROUPS = (("dirauth", "dirauth_kibps", "dirauth_kibps"),
          ("relay", "relay_kibps", "relay_kibps"),
          ("dest", "server_kibps", "server_kibps"),
          ("torclient", "client_up_kibps", "client_down_kibps"))


def _refuse(config: Dict, what: str):
    raise ValueError(f"portbench: {config.get('name')}: {what}")


def configuration(config: Dict, traffic: Dict, stoptime: int,
                  draw_seed: int):
    """The generator's network with the file's counts and the mix's
    streams, its topology the lossy complete graph of the file's size;
    both from the draw seed."""
    from shadow_tpu_torch.core.configuration import parse_xml
    from shadow_tpu_torch.tools.synth_topology import lossy_complete_graphml
    from shadow_tpu_torch.tools.workloads import tor_network
    nr, ns, nc = (int(config[k]) for k in ("relays", "servers", "clients"))
    if int(config["dirauths"]) != 1 or 1 + nr + ns + nc != int(
            config["hosts"]) or nr < 3 or ns < 1 or nc < 1:
        _refuse(config, "one authority, >= 3 relays, >= 1 server and "
                "client, adding up to hosts")
    if (int(traffic["start_s"]), int(traffic["start_span_s"])) != (
            reference.START_S, reference.START_SPAN_S):
        _refuse(config, "the generator starts clients at whole seconds in "
                f"[{reference.START_S}, "
                f"{reference.START_S + reference.START_SPAN_S})")
    xml = tor_network(nr, n_clients=nc, n_servers=ns, stoptime=stoptime,
                      streams_per_client=int(traffic["streams"]),
                      stream_spec=f"{int(traffic['up_bytes'])}:"
                                  f"{int(traffic['down_bytes'])}",
                      seed=draw_seed, dirauth=True, device_data=True)
    cfg = parse_xml(xml)
    cfg.topology_text = lossy_complete_graphml(int(config["vertices"]),
                                               draw_seed)
    cfg.bootstrap_end_sec = float(config["bootstrap_s"])
    for hc in cfg.hosts:
        for prefix, up, down in GROUPS:
            if hc.id.startswith(prefix):
                if (hc.bandwidth_up_kibps, hc.bandwidth_down_kibps) != (
                        int(config[up]), int(config[down])):
                    _refuse(config, f"the generator gives {hc.id} "
                            f"{hc.bandwidth_up_kibps} / "
                            f"{hc.bandwidth_down_kibps} KiB/s up / down, "
                            f"the file {config[up]} / {config[down]}")
                break
    return cfg


def options(config: Dict, traffic: Dict, *, seed: int, stoptime: int,
            device: str, chips: int, control: bool):
    """One card; the hop record on.  The control runs without loss to the
    end, so that no packet is ever dropped."""
    from shadow_tpu_torch.core.options import Options
    return Options(scheduler_policy="tpu", device=device, workers=0,
                   seed=seed, tpu_devices=1, hop_record=True,
                   heartbeat_interval_sec=0, stop_time_sec=stoptime,
                   log_level="warning",
                   bootstrap_end_sec=(stoptime if control
                                      else int(config["bootstrap_s"])))


def warm_stoptime(config: Dict, traffic: Dict) -> int:
    """Past the first clients' circuits (they start at 5 s), so that the
    hop, the span and the flush have all launched."""
    return reference.START_S + 5


def record(ctl) -> Dict:
    eng = ctl.engine
    pol = eng.scheduler.policy
    plane = eng.device_plane
    # launches consumed before the run ended (the last round's launch may
    # still be pending: its results were never read)
    launches = pol.hop_record or []
    done = [e for e in launches if e.deliver is not None]
    cat = lambda field, dt: (
        np.concatenate([getattr(e, field) for e in done]).astype(dt)
        if done else np.zeros(0, dtype=dt))
    hosts = {h.name: h for h in eng.hosts.values()}
    clients, relays, cons, registered = {}, {}, [], []
    for name, h in hosts.items():
        proc = h.processes[0] if h.processes else None
        st = proc.app_state if proc is not None else None
        if name.startswith("torclient"):
            clients[name] = {
                "exit_code": proc.exit_code if proc is not None else None,
                "streams_ok": getattr(st, "streams_ok", -1),
                "bytes_up": getattr(st, "bytes_up", -1),
                "bytes_down": getattr(st, "bytes_down", -1),
                "consensus_relays": getattr(st, "consensus_relays", -1),
                "consensus_weight": getattr(st, "consensus_weight", -1),
                "fetched_ns": getattr(st, "fetched_ns", -1),
                "path": list(getattr(st, "path", []))}
        elif name.startswith("relay"):
            relays[name] = len(st.circuits) if st is not None else -1
        elif name == "dirauth" and st is not None:
            cons = sorted((n, int(p), int(w)) for n, (p, w) in st.items())
            # in the order the descriptors arrived
            registered = [(n, int(st.published_ns.get(n, -1))) for n in st]
    specs = plane.specs if plane is not None else []
    if plane is not None:
        inject, chain_done = plane.chain_steps()
    else:
        inject = chain_done = np.full(2 * len(specs), -1, dtype=np.int64)
    return {"hop_lanes": np.array([len(e.src) for e in done],
                                  dtype=np.int64),
            "hop_pending": sum(len(e.src) for e in launches
                               if e.deliver is None),
            "hop_src": cat("src", np.int32), "hop_dst": cat("dst", np.int32),
            "hop_uid": cat("uid", np.uint64),
            "hop_send": cat("send", np.int64),
            "hop_barrier": np.array([e.barrier for e in done],
                                    dtype=np.int64),
            "hop_deliver": cat("deliver", np.int64),
            "hop_keep": cat("keep", bool),
            # the policy's launches and waits on them, its host time
            "hop_calls": pol.kernel_calls,
            "hop_device_ns": pol.device_ns,
            "host_flush_ns": pol.host_flush_ns,
            "lanes_hopped": pol.lanes_hopped,
            "packets_dropped": pol.packets_dropped,
            "vertex_of_row": list(eng.topology.attached_vertices),
            "row_of_host": {n: int(h.topo_row) for n, h in hosts.items()},
            "consensus": cons, "registered": registered,
            "clients": clients, "relay_circuits": relays,
            "granule": plane.granule if plane is not None else 0,
            # the plane's dispatches and its blocking collects
            "dispatches": plane.dispatches if plane is not None else 0,
            "device_ns": plane.device_ns if plane is not None else 0,
            "reroutes": plane.reroutes if plane is not None else 0,
            "chain_clients": [s.client_name for s in specs for _ in (0, 1)],
            "plane_routes": {s.client_name: list(s.route_up)
                             for s in specs},
            "inject_step": inject, "chain_done": chain_done}


def check(rec: Dict, config: Dict, traffic: Dict, device):
    out = reference.simulate(rec, config, traffic, device)
    partial = sum(c["consensus_relays"] < int(config["relays"])
                  for c in rec["clients"].values())
    print(f"portbench: episode {rec['index']}: {partial} clients fetched a "
          f"partial consensus, the plane re-routed {rec['reroutes']}, "
          f"{rec['packets_dropped']} packets dropped", file=sys.stderr)
    return reference.compare(rec, out, config, traffic), out
