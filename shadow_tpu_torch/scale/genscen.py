"""Deterministic parameterized scenario generators for the scale tier.

Emits ``Configuration`` objects directly — a 100k-host scenario is a few
``HostConfig`` records with ``quantity`` + ``FlowConfig`` entries, not a
multi-megabyte XML string (the tor10k generator in tools/workloads.py
already spends seconds just formatting XML the parser then re-tokenizes).

Five families, mirroring the reference's experiment shapes plus the
production-traffic fleet (ROADMAP item 4):

* :func:`star`    — one fat server, N clients each pulling bulk bytes over
  the device-resident traffic plane (workload #2 scaled out; star10k /
  star100k).
* :func:`phold`   — the classic PDES scheduler benchmark (host-plane
  stress: every host runs a real plugin, so this measures materialization
  throughput rather than quiet-row capacity; phold100k).
* :func:`tor`     — the reference's Tor shape (~10% relays, ~1% servers,
  the rest clients on distinct seeded 3-hop circuits; tor100k) with all
  traffic as 5-hop device-plane chains.
* :func:`cdn`     — HTTP/1.1-shaped flash crowd: tens of thousands of
  clients hammering a few fat origins via seeded 2-hop chains (cdn20k);
  the contended resource is the origins' egress buckets.
* :func:`swarm`   — BitTorrent-style many-to-many piece exchange over a
  seeded uniform partner graph (swarm2k); the mesh partitioner's
  cut-fraction worst case.

All structure is seeded (numpy ``default_rng``) so a scenario built with
the same arguments is identical, and the per-client tor paths are derived
*vectorized* at table-reserve time (:func:`expand_flows`) — ONE
``FlowConfig`` describes 100k distinct circuits.

Usage: ``python -m shadow_tpu_torch.tools.mkscenario`` (CLI) or
``genscen.build("star100k")`` programmatically; tests/test_scale.py pins
determinism and shape.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..core import stime
from ..core.configuration import Configuration, FlowConfig, HostConfig, \
    ProcessConfig


def _distinct3(rng, n: int, upper: int):
    """n seeded triples of distinct ints in [0, upper), vectorized: draw
    from shrinking ranges and shift past earlier picks."""
    if upper < 3:
        raise ValueError(f"need >= 3 candidates, have {upper}")
    a = rng.integers(0, upper, n)
    b = rng.integers(0, upper - 1, n)
    b = b + (b >= a)
    c = rng.integers(0, upper - 2, n)
    lo = np.minimum(a, b)
    hi = np.maximum(a, b)
    c = c + (c >= lo)
    c = c + (c >= hi)
    return a, b, c


def expand_flows(table, grp) -> List[tuple]:
    """Expand a group's ``FlowConfig`` entries into per-row flow tuples
    ``(row, route_down, route_up, down_bytes, up_bytes, start_ns)`` for the
    device plane (scale/hosttable.py stores them; parallel/device_plane.py
    turns them into flow specs).  Routes are name tuples in chain order:
    star is the 2-hop pair (dest->client / client->dest), a ``path`` or
    tor-seeded spec is the 5-hop tor pair."""
    out: List[tuple] = []
    hc = grp.hc
    for fc in hc.flows:
        n = grp.count
        starts = np.full(n, stime.from_seconds(fc.start_time_sec),
                         dtype=np.int64)
        if fc.stagger_waves > 1 and fc.stagger_step_sec > 0:
            starts = starts + (np.arange(n) % fc.stagger_waves) \
                * stime.from_seconds(fc.stagger_step_sec)
        if fc.tor_path_seed is not None:
            rng = np.random.default_rng(fc.tor_path_seed)
            g, m, e = _distinct3(rng, n, fc.tor_relays)
            dests = rng.integers(0, max(fc.tor_servers, 1), n)
            rp, sp = fc.tor_relay_prefix, fc.tor_server_prefix
            for q in range(n):
                client = grp.name_of(q)
                guard = f"{rp}{int(g[q]) + 1}"
                middle = f"{rp}{int(m[q]) + 1}"
                exit_ = f"{rp}{int(e[q]) + 1}"
                # a quantity-1 group keeps its bare id as its host name
                # (the sub-100-host tor shape has ONE dest — fuzz-found)
                dest = sp if fc.tor_servers == 1 \
                    else f"{sp}{int(dests[q]) + 1}"
                out.append((grp.first_row + q,
                            (dest, exit_, middle, guard, client),
                            (client, guard, middle, exit_, dest),
                            fc.down_bytes, fc.up_bytes, int(starts[q])))
        elif fc.dest_seed is not None:
            # seeded 2-hop destination draw over <dest_prefix>1..dest_count
            # (cdn flash-crowd / swarm many-to-many): a draw landing on the
            # host itself shifts to the next name so a group can target its
            # own peers without ever flowing to itself
            if fc.dest_count < 1:
                raise ValueError(
                    f"flow on {hc.id!r}: dest_seed needs dest_count >= 1")
            rng = np.random.default_rng(fc.dest_seed)
            draws = rng.integers(0, fc.dest_count, n)
            for q in range(n):
                client = grp.name_of(q)
                d = int(draws[q])
                # quantity-1 dest groups keep their bare id as the name
                dest = fc.dest_prefix if fc.dest_count == 1 \
                    else f"{fc.dest_prefix}{d + 1}"
                if dest == client:
                    if fc.dest_count < 2:
                        raise ValueError(
                            f"flow on {hc.id!r}: dest_seed over a single-"
                            "host group cannot avoid self-flows")
                    dest = f"{fc.dest_prefix}{(d + 1) % fc.dest_count + 1}"
                out.append((grp.first_row + q,
                            (dest, client), (client, dest),
                            fc.down_bytes, fc.up_bytes, int(starts[q])))
        elif fc.path:
            hops = [h.strip() for h in fc.path.split(",") if h.strip()]
            if len(hops) != 3:
                raise ValueError(
                    f"flow path {fc.path!r}: tor-shaped flows need exactly "
                    "3 relays (guard,middle,exit)")
            guard, middle, exit_ = hops
            for q in range(n):
                client = grp.name_of(q)
                out.append((grp.first_row + q,
                            (fc.dest, exit_, middle, guard, client),
                            (client, guard, middle, exit_, fc.dest),
                            fc.down_bytes, fc.up_bytes, int(starts[q])))
        else:
            for q in range(n):
                client = grp.name_of(q)
                out.append((grp.first_row + q,
                            (fc.dest, client), (client, fc.dest),
                            fc.down_bytes, fc.up_bytes, int(starts[q])))
    return out


# ---------------------------------------------------------------------------
# scenario builders
# ---------------------------------------------------------------------------

def star(n_clients: int = 100_000, stoptime: int = 600,
         down_bytes: int = 64 * 1024, up_bytes: int = 0,
         start_sec: float = 2.0, stagger_waves: int = 8,
         stagger_step_sec: float = 1.0,
         server_bw_kibps: int = 4 * 1024 * 1024,
         client_down_kibps: int = 102400,
         client_up_kibps: int = 51200) -> Configuration:
    """star100k: one fat server, n processless clients each pulling
    ``down_bytes`` over the device plane.  Every client is a HostTable row
    for the whole run; the server's egress bucket is the contended
    resource (the torcells segment-cumsum's big segment)."""
    cfg = Configuration(stop_time_sec=stoptime)
    cfg.hosts.append(HostConfig(
        id="server", bandwidth_down_kibps=server_bw_kibps,
        bandwidth_up_kibps=server_bw_kibps))
    cfg.hosts.append(HostConfig(
        id="client", quantity=n_clients,
        bandwidth_down_kibps=client_down_kibps,
        bandwidth_up_kibps=client_up_kibps,
        flows=[FlowConfig(dest="server", start_time_sec=start_sec,
                          down_bytes=down_bytes, up_bytes=up_bytes,
                          stagger_waves=stagger_waves,
                          stagger_step_sec=stagger_step_sec)]))
    return cfg


def phold(n_hosts: int = 100_000, stoptime: int = 60,
          msgs_in_flight: int = 1, waves: int = 50,
          bw_kibps: int = 10240) -> Configuration:
    """phold100k: every host runs the real phold plugin (uniform
    all-to-all UDP).  A host-plane stress: hosts materialize in ``waves``
    staggered boot waves, measuring promotion throughput."""
    cfg = Configuration(stop_time_sec=stoptime)
    hc = HostConfig(id="phold", quantity=n_hosts,
                    bandwidth_down_kibps=bw_kibps,
                    bandwidth_up_kibps=bw_kibps)
    # one process config per boot wave would need per-row start times the
    # quantity expansion cannot express; a single start keeps the classic
    # phold shape (the reference's test_phold boots all hosts at once too)
    hc.processes.append(ProcessConfig(
        plugin="python:phold", start_time_sec=1.0,
        arguments=f"{n_hosts} {msgs_in_flight} 9000"))
    cfg.hosts.append(hc)
    return cfg


def tor(n_hosts: int = 100_000, stoptime: int = 600,
        down_bytes: int = 48 * 1024, up_bytes: int = 2 * 1024,
        start_sec: float = 2.0, stagger_waves: int = 16,
        stagger_step_sec: float = 1.0, seed: int = 42) -> Configuration:
    """tor100k on the reference's Tor shape: ~10% relays, ~1% fat servers,
    the rest clients — every client a distinct seeded 3-hop circuit, all
    traffic 5-hop device-plane chains, zero plugin processes."""
    n_relays = max(3, n_hosts // 10)
    n_servers = max(1, n_hosts // 100)
    n_clients = max(1, n_hosts - n_relays - n_servers)
    cfg = Configuration(stop_time_sec=stoptime)
    cfg.hosts.append(HostConfig(
        id="relay", quantity=n_relays,
        bandwidth_down_kibps=102400, bandwidth_up_kibps=102400))
    cfg.hosts.append(HostConfig(
        id="dest", quantity=n_servers,
        bandwidth_down_kibps=1048576, bandwidth_up_kibps=1048576))
    cfg.hosts.append(HostConfig(
        id="torclient", quantity=n_clients,
        bandwidth_down_kibps=51200, bandwidth_up_kibps=10240,
        flows=[FlowConfig(dest="", start_time_sec=start_sec,
                          down_bytes=down_bytes, up_bytes=up_bytes,
                          stagger_waves=stagger_waves,
                          stagger_step_sec=stagger_step_sec,
                          tor_path_seed=seed, tor_relays=n_relays,
                          tor_relay_prefix="relay",
                          tor_servers=n_servers,
                          tor_server_prefix="dest")]))
    return cfg


def cdn(n_clients: int = 20_000, n_origins: int = 4, stoptime: int = 120,
        down_bytes: int = 256 * 1024, up_bytes: int = 1024,
        start_sec: float = 2.0, stagger_waves: int = 2,
        stagger_step_sec: float = 1.0, seed: int = 1,
        origin_bw_kibps: int = 4 * 1024 * 1024,
        client_down_kibps: int = 102400,
        client_up_kibps: int = 20480) -> Configuration:
    """cdn20k: an HTTP/1.1-shaped flash crowd — tens of thousands of
    clients hammering a handful of fat origins at once.  Every client is a
    processless table row with ONE seeded 2-hop chain to a drawn origin
    (``dest_seed``), so the contended resource is the few origins' egress
    buckets (the segment-cumsum's few huge segments), the inverse of tor's
    many-small-segments shape."""
    if n_origins < 1:
        raise ValueError("cdn needs at least one origin")
    cfg = Configuration(stop_time_sec=stoptime)
    cfg.hosts.append(HostConfig(
        id="origin", quantity=n_origins,
        bandwidth_down_kibps=origin_bw_kibps,
        bandwidth_up_kibps=origin_bw_kibps))
    cfg.hosts.append(HostConfig(
        id="cdnclient", quantity=n_clients,
        bandwidth_down_kibps=client_down_kibps,
        bandwidth_up_kibps=client_up_kibps,
        flows=[FlowConfig(dest="", start_time_sec=start_sec,
                          down_bytes=down_bytes, up_bytes=up_bytes,
                          stagger_waves=stagger_waves,
                          stagger_step_sec=stagger_step_sec,
                          dest_seed=seed, dest_count=n_origins,
                          dest_prefix="origin")]))
    return cfg


def swarm(n_peers: int = 2_000, pieces: int = 4, stoptime: int = 120,
          piece_bytes: int = 64 * 1024, start_sec: float = 2.0,
          stagger_waves: int = 4, stagger_step_sec: float = 1.0,
          seed: int = 1, bw_down_kibps: int = 51200,
          bw_up_kibps: int = 25600) -> Configuration:
    """swarm2k: a BitTorrent-style many-to-many swarm — every peer
    exchanges ``pieces`` bidirectional transfers with seeded-drawn
    partners (self-draws shift to the next peer).  The uniform random
    partner graph is the mesh partitioner's worst case: cut fraction
    approaches (D-1)/D at D shards, so this is the cut-stress workload
    the cdn/star/tor shapes never produce."""
    if n_peers < 2:
        raise ValueError("swarm needs at least two peers")
    cfg = Configuration(stop_time_sec=stoptime)
    flows = [FlowConfig(dest="", start_time_sec=start_sec,
                        down_bytes=piece_bytes, up_bytes=piece_bytes,
                        stagger_waves=stagger_waves,
                        stagger_step_sec=stagger_step_sec,
                        dest_seed=seed * 7919 + k, dest_count=n_peers,
                        dest_prefix="peer")
             for k in range(pieces)]
    cfg.hosts.append(HostConfig(
        id="peer", quantity=n_peers, bandwidth_down_kibps=bw_down_kibps,
        bandwidth_up_kibps=bw_up_kibps, flows=flows))
    return cfg


def mixnet(n_hosts: int = 2_000, stoptime: int = 120,
           down_bytes: int = 16 * 1024, up_bytes: int = 2 * 1024,
           cover_cell_bytes: int = 512, cover_cells: int = 8,
           cover_interval_sec: float = 2.0, start_sec: float = 2.0,
           stagger_waves: int = 4, stagger_step_sec: float = 1.0,
           seed: int = 7) -> Configuration:
    """mixnet2k: an onion-route variant with constant-rate cover traffic
    (ROADMAP item 5's device-plane best case).  The tor shape — ~10%
    relays, ~1% fat exits, the rest clients on distinct seeded 3-hop
    circuits — plus, per client, ``cover_cells`` fixed-size cover cells
    fired at a constant ``cover_interval_sec`` cadence over distinct
    seeded circuits (a mixnet's loop cover: traffic flows whether or not
    payload does).  Every cell is a processless 5-hop device chain, so
    the plane carries cells-per-second x clients with zero host events —
    the highest chain-count-per-host shape in the family set."""
    if cover_cells < 1:
        raise ValueError("mixnet needs at least one cover cell")
    n_relays = max(3, n_hosts // 10)
    n_servers = max(1, n_hosts // 100)
    n_clients = max(1, n_hosts - n_relays - n_servers)
    cfg = Configuration(stop_time_sec=stoptime)
    cfg.hosts.append(HostConfig(
        id="mixrelay", quantity=n_relays,
        bandwidth_down_kibps=102400, bandwidth_up_kibps=102400))
    cfg.hosts.append(HostConfig(
        id="mixdest", quantity=n_servers,
        bandwidth_down_kibps=1048576, bandwidth_up_kibps=1048576))
    tor_kw = dict(tor_path_seed=seed, tor_relays=n_relays,
                  tor_relay_prefix="mixrelay", tor_servers=n_servers,
                  tor_server_prefix="mixdest")
    # the payload circuit, then the constant-rate cover cells — each cell
    # wave rides its own seeded circuit (route diversity is the point of
    # cover), launched at a fixed cadence with no stagger so the rate the
    # plane sees is genuinely constant per client
    flows = [FlowConfig(dest="", start_time_sec=start_sec,
                        down_bytes=down_bytes, up_bytes=up_bytes,
                        stagger_waves=stagger_waves,
                        stagger_step_sec=stagger_step_sec, **tor_kw)]
    for k in range(cover_cells):
        flows.append(FlowConfig(
            dest="", start_time_sec=start_sec + k * cover_interval_sec,
            down_bytes=cover_cell_bytes, up_bytes=cover_cell_bytes,
            **dict(tor_kw, tor_path_seed=seed * 8191 + k + 1)))
    cfg.hosts.append(HostConfig(
        id="mixclient", quantity=n_clients,
        bandwidth_down_kibps=51200, bandwidth_up_kibps=25600,
        flows=flows))
    return cfg


FAMILIES: Dict[str, object] = {
    "star": star, "phold": phold, "tor": tor, "cdn": cdn, "swarm": swarm,
    "mixnet": mixnet,
}

# name -> (family, preset kwargs).  build() MERGES overrides onto the
# preset (overrides win), so build("star10k", stoptime=5) is the 10k
# preset at stoptime 5, never the family default silently.
PRESETS: Dict[str, tuple] = {
    "star2k": ("star", dict(n_clients=2_000, stoptime=120,
                            stagger_waves=2)),
    "star10k": ("star", dict(n_clients=10_000, stoptime=300,
                             stagger_waves=4)),
    "star100k": ("star", dict(n_clients=100_000)),
    "phold10k": ("phold", dict(n_hosts=10_000)),
    "phold100k": ("phold", dict(n_hosts=100_000)),
    "tor10k": ("tor", dict(n_hosts=10_000, stoptime=300,
                           stagger_waves=8)),
    "tor100k": ("tor", dict(n_hosts=100_000)),
    "cdn2k": ("cdn", dict(n_clients=2_000, n_origins=3, stoptime=60)),
    "cdn20k": ("cdn", dict(n_clients=20_000, n_origins=4)),
    "swarm500": ("swarm", dict(n_peers=500, pieces=3, stoptime=60)),
    "swarm2k": ("swarm", dict(n_peers=2_000, pieces=4)),
    "mixnet500": ("mixnet", dict(n_hosts=500, stoptime=60,
                                 cover_cells=4)),
    "mixnet2k": ("mixnet", dict(n_hosts=2_000, cover_cells=8)),
}

# kept for callers that list/run the presets directly
NAMED: Dict[str, object] = {
    name: (lambda fam=fam, kw=kw: FAMILIES[fam](**kw))
    for name, (fam, kw) in PRESETS.items()
}


def _validate_overrides(fn, name: str, kw: Dict) -> None:
    """Reject unknown builder kwargs LOUDLY: a typo'd ``stoptme=`` must
    never silently build the default scenario — the fuzzer's repro files
    depend on override fidelity."""
    import inspect
    valid = set(inspect.signature(fn).parameters)
    unknown = sorted(set(kw) - valid)
    if unknown:
        raise ValueError(
            f"scenario {name!r}: unknown override(s) "
            f"{', '.join(unknown)}; valid: {', '.join(sorted(valid))}")


def family_fn(name: str):
    """The builder function behind a preset or family name."""
    if name in PRESETS:
        return FAMILIES[PRESETS[name][0]]
    for prefix in sorted(FAMILIES, key=len, reverse=True):
        if name.startswith(prefix):
            return FAMILIES[prefix]
    raise ValueError(f"unknown scenario {name!r}; "
                     f"known: {', '.join(sorted(PRESETS))}")


def build(name: str, **overrides) -> Configuration:
    """Build a named scenario.  A preset name (``star10k``) merges
    ``overrides`` onto the preset's kwargs; a family name (``star``) uses
    the overrides directly.  Unknown override names raise ValueError
    naming the valid set (never a silently-default scenario)."""
    fn = family_fn(name)
    kw = {**PRESETS[name][1], **overrides} if name in PRESETS \
        else dict(overrides)
    _validate_overrides(fn, name, kw)
    return fn(**kw)


def config_digest(cfg: Configuration) -> str:
    """Stable content digest of a Configuration (determinism gate for the
    generators: same arguments => same digest)."""
    import dataclasses
    import hashlib
    import json
    blob = json.dumps(dataclasses.asdict(cfg), sort_keys=True,
                      separators=(",", ":"), default=str).encode()
    return hashlib.sha256(blob).hexdigest()
