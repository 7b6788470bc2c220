"""Benchmark workload-config generator: the five BASELINE.md configs.

The reference's benchmark plan (BASELINE.json "configs") names five
workloads; this module generates runnable shadow_tpu XML configs for each,
parameterized so tests use small instances and benchmarks use full scale:

  1. two_host_echo()          — 2-host tgen echo (resource/examples analog)
  2. star_bulk(100)           — 100-host bulk transfer, single-AS star
  3. tor_network(1000, ...)   — 1k-relay Tor overlay, python:tor app
  4. tor_network(10000, topology=...) — 10k-host Tor on the reference's
     Internet GraphML (pass /root/reference/resource/topology.graphml.xml.xz)
  5. bitcoin_network(5000)    — 5k-node Bitcoin gossip

Usage: ``python -m shadow_tpu_torch.tools.workloads <name> [> config.xml]`` with
name in {echo2, star100, tor1k, tor10k, btc5k} or programmatically.

Determinism: all random structure (peer graphs, circuit paths) comes from a
seeded numpy Generator, so a config built with the same arguments is
byte-identical.
"""

from __future__ import annotations

import sys
from typing import List, Optional

import numpy as np


def two_host_echo(stoptime: int = 60) -> str:
    return f"""<shadow stoptime="{stoptime}">
  <plugin id="tgen" path="python:tgen" />
  <host id="server" bandwidthdown="102400" bandwidthup="102400">
    <process plugin="tgen" starttime="1" arguments="server 80" />
  </host>
  <host id="client" bandwidthdown="10240" bandwidthup="5120">
    <process plugin="tgen" starttime="2" arguments="client server 80 1024:1048576" />
  </host>
</shadow>
"""


def star_bulk(n_clients: int = 100, stoptime: int = 600,
              bulk_bytes: int = 10 * 1024 * 1024,
              device_data: bool = False) -> str:
    """Single-AS star: one big server, n clients each pulling bulk_bytes.
    ``device_data=True`` promotes the bulk phase to the device-resident
    traffic plane (the tgen handshake still runs over real TCP)."""
    dev = " device" if device_data else ""
    lines = [f'<shadow stoptime="{stoptime}">',
             '  <plugin id="tgen" path="python:tgen" />',
             '  <host id="server" bandwidthdown="1048576" bandwidthup="1048576">',
             '    <process plugin="tgen" starttime="1" arguments="server 80" />',
             '  </host>']
    for i in range(n_clients):
        lines.append(
            f'  <host id="client{i}" bandwidthdown="102400" bandwidthup="51200">\n'
            f'    <process plugin="tgen" starttime="2" '
            f'arguments="client server 80 256:{bulk_bytes}{dev}" />\n'
            '  </host>')
    lines.append('</shadow>')
    return "\n".join(lines) + "\n"


def tor_network(n_relays: int = 1000, n_clients: Optional[int] = None,
                n_servers: Optional[int] = None, stoptime: int = 600,
                streams_per_client: int = 3, stream_spec: str = "512:51200",
                topology_path: Optional[str] = None, seed: int = 42,
                dirauth: bool = False, device_data: bool = False) -> str:
    """Tor overlay: relays + clients with random 3-hop paths + destinations.

    Mirrors the shape of the reference's Tor experiments (shadow-plugin-tor
    topologies: ~10% exits/guards, ~1 client per relay, few fat servers).

    ``dirauth=True`` adds the directory bootstrap phase: a directory
    authority host, relays publishing bandwidth-weighted descriptors, and
    clients fetching the consensus and picking their own weighted paths
    (instead of config-assigned ones) — real Tor's startup behavior.

    ``device_data=True`` marks every client for the device-resident traffic
    plane (circuit build stays on the simulated control plane; the bulk
    download advances in HBM — parallel/device_plane.py).  Composes with
    ``dirauth=True``: auto: consensus paths are predicted at startup and
    cross-checked at runtime (resolve_auto_routes/check_route)."""
    # dirauth + device_data now compose: the device plane predicts each
    # auto: client's consensus path at startup from the config-determined
    # consensus and the client's derived path stream, and the runtime
    # cross-checks the fetched route (parallel/device_plane.py
    # resolve_auto_routes / check_route)
    rng = np.random.default_rng(seed)
    n_clients = n_clients if n_clients is not None else max(1, n_relays)
    n_servers = n_servers if n_servers is not None else max(1, n_relays // 20)
    lines = [f'<shadow stoptime="{stoptime}">']
    if topology_path:
        lines.append(f'  <topology path="{topology_path}" />')
    lines.append('  <plugin id="tor" path="python:tor" />')
    if dirauth:
        lines.append(
            '  <host id="dirauth" bandwidthdown="1048576" bandwidthup="1048576">\n'
            '    <process plugin="tor" starttime="1" arguments="dirauth 9030" />\n'
            '  </host>')
    for i in range(n_relays):
        relay_args, relay_start = "relay 9001", 1
        if dirauth:
            bw = int(rng.integers(50, 1000))
            relay_args, relay_start = f"relay 9001 dirauth:9030 {bw}", 2
        lines.append(
            f'  <host id="relay{i}" bandwidthdown="102400" bandwidthup="102400">\n'
            f'    <process plugin="tor" starttime="{relay_start}" '
            f'arguments="{relay_args}" />\n'
            '  </host>')
    for i in range(n_servers):
        lines.append(
            f'  <host id="dest{i}" bandwidthdown="1048576" bandwidthup="1048576">\n'
            f'    <process plugin="tor" starttime="1" arguments="server 80" />\n'
            '  </host>')
    for i in range(n_clients):
        if dirauth:
            path_s = "auto:dirauth:9030"
        else:
            path = rng.choice(n_relays, size=min(3, n_relays), replace=False)
            path_s = ",".join(f"relay{int(r)}" for r in path)
        dest = int(rng.integers(0, n_servers))
        start = 5 + int(rng.integers(0, 30))
        dev = " device" if device_data else ""
        lines.append(
            f'  <host id="torclient{i}" bandwidthdown="51200" bandwidthup="10240">\n'
            f'    <process plugin="tor" starttime="{start}" '
            f'arguments="client 9050 {path_s} dest{dest} 80 '
            f'{streams_per_client} {stream_spec}{dev}" />\n'
            '  </host>')
    lines.append('</shadow>')
    return "\n".join(lines) + "\n"


def bitcoin_network(n_nodes: int = 5000, n_peers: int = 8,
                    n_miners: int = 10, stoptime: int = 600,
                    block_interval: int = 60, block_bytes: int = 1_000_000,
                    blocks_per_miner: int = 3, seed: int = 42) -> str:
    """Bitcoin gossip: each node dials n_peers random earlier nodes (the
    standard random-graph construction; guarantees a connected overlay)."""
    rng = np.random.default_rng(seed)
    lines = [f'<shadow stoptime="{stoptime}">',
             '  <plugin id="btc" path="python:bitcoin" />']
    miners = set(int(x) for x in
                 rng.choice(n_nodes, size=min(n_miners, n_nodes),
                            replace=False))
    for i in range(n_nodes):
        if i == 0:
            peers = "-"
        else:
            k = min(n_peers, i)
            chosen = rng.choice(i, size=k, replace=False)
            peers = ",".join(f"node{int(p)}" for p in chosen)
        mine = (f" mine {block_interval} {block_bytes} {blocks_per_miner}"
                if i in miners else "")
        start = 1 + (i % 20)  # staggered boot, 20 waves
        lines.append(
            f'  <host id="node{i}" bandwidthdown="102400" bandwidthup="102400">\n'
            f'    <process plugin="btc" starttime="{start}" '
            f'arguments="{peers}{mine}" />\n'
            '  </host>')
    lines.append('</shadow>')
    return "\n".join(lines) + "\n"


def _reference_topology() -> str:
    """The Internet-scale GraphML for the tor10k workload: from
    $SHADOW_TPU_TOPOLOGY, or the conventional reference checkout path."""
    import os
    path = os.environ.get("SHADOW_TPU_TOPOLOGY",
                          "/root/reference/resource/topology.graphml.xml.xz")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"tor10k needs an Internet-scale GraphML topology; {path} does "
            "not exist — set $SHADOW_TPU_TOPOLOGY to one")
    return path


NAMED = {
    "echo2": lambda: two_host_echo(),
    "star100": lambda: star_bulk(100),
    "tor1k": lambda: tor_network(1000),
    "tor10k": lambda: tor_network(10000, topology_path=_reference_topology()),
    "btc5k": lambda: bitcoin_network(5000),
}


def main(argv: List[str]) -> int:
    if len(argv) < 1 or argv[0] not in NAMED:
        print(f"usage: python -m shadow_tpu_torch.tools.workloads "
              f"{{{','.join(NAMED)}}}", file=sys.stderr)
        return 2
    sys.stdout.write(NAMED[argv[0]]())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
