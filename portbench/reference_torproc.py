"""The plain reference of a Tor experiment with processes: the directory
bootstrap, the weighted paths, every packet hop and the device plane's
chains, worked out again from the benchmark's configuration and the
episode's seeds.

Nothing here imports the program under test or JAX: numpy for the draws
and the graph, plain torch for the hop lanes and the chains (on the card
in a benchmark run).  ``portbench/reference.py`` gives the constants of
the cells and the buckets.

What is restated, and from what:

* **the network** (``tools/workloads.tor_network(dirauth=True,
  device_data=True)``): one directory authority, the relays, the servers
  and the clients, in that order, host ids 1, 2, ...; ``numpy``'s
  ``default_rng(draw_seed)`` draws each relay's bandwidth weight in
  [50, 1000), then for each client its server in [0, servers) and its
  start in whole seconds in [5, 35).
* **the graph** (``tools/synth_topology.lossy_complete_graphml``, seeded
  with the draw seed): the vertices' bandwidth and loss, then every edge's
  latency (ms to 0.1) and loss, from one generator.  Paths as
  ``routing/topology.py`` defines them on a complete graph: the direct
  edge, its latency ``ceil(ms * 1e6)`` ns and its reliability
  ``(1 - edge loss) * (1 - src loss) * (1 - dst loss)``; between two hosts
  of one vertex the cheapest incident edge (the first in the file at the
  least latency) twice, reliability ``(1 - its loss) ** 2``; float32.
* **the randomness** (``core/rng.py``): Threefry-2x32 (20 rounds) keyed by
  64-bit keys; ``derive`` folds a label (a string by 64-bit FNV-1a) as
  the 64 bits ``threefry(key, label)``; a host's stream is ``derive(
  derive(seed, "root"), "host", id)``, its path stream that stream's
  ``derive(..., "device-circuit")``, the drop draw's key ``derive(root,
  "packet_drop")``; a stream's ``next_int(n)`` is its next 64 bits mod n.
* **the paths**: the authority's document is every relay's ``(name,
  9001, weight)`` sorted by name.  A client's consensus is the document
  as the authority held it when the client fetched: the relays whose
  descriptors had arrived by then.  When that was is the TCP stack's
  timing (a descriptor delayed by a lost packet), so the count of relays
  each client fetched is taken from the record, and held to the
  authority's registrations: the relays fetched are the first that many
  in the order the descriptors arrived (their summed weight the client's
  own), the last of them arrived no later than the client's fetch ended
  and the first left out after the client started.  A client's 3 hops
  are drawn without replacement over its consensus, each the first
  relay whose running weight sum exceeds ``next_int(total)``.
* **the hops**: for every lane of every recorded launch of the hop
  kernel, ``deliver = max(send + latency[src, dst], barrier)`` and
  ``keep = send < bootstrap_end or reliability >= 1 or u <= reliability``
  with ``u = (threefry(drop key, uid).x0 >> 8) * 2**-24`` in float32.
  Which vertex a host sits on is a seeded placement (the attach draw of
  the host's stream over the graph's vertices), not a property of the
  deployment: the row-to-vertex map is taken from the record, checked
  only to name distinct vertices of the graph.
* **the chains**: each client's download (server -> exit -> middle ->
  guard -> client) and upload (the reverse), ``ceil(down / 505)`` and
  ``ceil(up / 505)`` cells a stream, in the order of the clients, the
  download first; the plane's step of ``g`` ms, ``g = ceil((L + 1) /
  64)`` for the longest stage latency ``L`` in whole ms; a stage's
  latency ``max(latency_ns // 1e6, 1)`` ms rounded up to whole steps; a
  host's egress bucket paces the stages it sends from, its ingress bucket
  the stage that delivers to it, each refilled ``rate * 1024 // 1000 * g``
  bytes a step up to ``max(that / g + 1500, that)``, serving its queued
  cells greedily in (chain, stage) order; the span semantics of
  ``reference.py`` with a latency for each stage.  The step ``g`` is
  fixed when the plane is laid out, from the paths drawn over the whole
  document; a client whose consensus lacked a relay takes its own path,
  its stages' latencies in steps of that ``g``.  When a chain's cells
  enter is the TCP stack's timing, which no plain restatement short of a
  second simulator gives: the step at which the plane folded them in is
  taken from the record, and held only to fall no earlier than the
  client's start plus the least time its messages take (the consensus
  fetch, the connect to the guard, CREATE and the two EXTENDs, at the
  restated latencies), less the plane's 8-step dispatch cadence (a
  dispatch folds cells in at its base step, up to 7 steps before the
  activation).
* **the apps**: every client's circuit runs through its restated path,
  and its 3 streams count 3 x 512 bytes up and 3 x 51,200 down; every
  relay carries exactly the circuits the restated paths put through it;
  every client exits 0.

Every tolerance is zero.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from portbench.reference import MTU, PAYLOAD, TICK_NS, WIRE_BYTES

STAGES = 5
ORPORT = 9001
# the plane's dispatch cadence: a dispatch carries at least this many steps
BATCH_STEPS = 8
# the generator's fixed start rule: whole seconds in [5, 5 + 30)
START_S, START_SPAN_S = 5, 30
# each relay's bandwidth weight in [50, 1000)
WEIGHT_LO, WEIGHT_HI = 50, 1000

_M32 = 0xFFFFFFFF
_M64 = 0xFFFFFFFFFFFFFFFF
ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
PARITY = 0x1BD11BDA
FNV_BASIS = 1469598103934665603
FNV_PRIME = 1099511628211


# -- Threefry-2x32 and the streams -------------------------------------------

def threefry_int(k0: int, k1: int, c0: int, c1: int) -> Tuple[int, int]:
    """Threefry-2x32, 20 rounds, on Python ints (one block)."""
    k0 &= _M32
    k1 &= _M32
    ks = (k0, k1, (PARITY ^ k0 ^ k1) & _M32)
    x0 = (c0 + ks[0]) & _M32
    x1 = (c1 + ks[1]) & _M32
    for block in range(5):
        for r in ROTATIONS[4 * (block % 2):4 * (block % 2) + 4]:
            x0 = (x0 + x1) & _M32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _M32
            x1 ^= x0
        x0 = (x0 + ks[(block + 1) % 3]) & _M32
        x1 = (x1 + ks[(block + 2) % 3] + block + 1) & _M32
    return x0, x1


def threefry_torch(k0: int, k1: int, c0: torch.Tensor,
                   c1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same cipher over int64 tensors holding 32-bit lanes, masked
    back to 32 bits after every add and rotation."""
    k0 &= _M32
    k1 &= _M32
    ks = (k0, k1, (PARITY ^ k0 ^ k1) & _M32)
    x0 = (c0 + ks[0]) & _M32
    x1 = (c1 + ks[1]) & _M32
    for block in range(5):
        for r in ROTATIONS[4 * (block % 2):4 * (block % 2) + 4]:
            x0 = (x0 + x1) & _M32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _M32
            x1 = x1 ^ x0
        x0 = (x0 + ks[(block + 1) % 3]) & _M32
        x1 = (x1 + ks[(block + 2) % 3] + block + 1) & _M32
    return x0, x1


def bits64(key: int, counter: int) -> int:
    """64 bits from a 64-bit key and a 64-bit counter: x0 | x1 << 32."""
    x0, x1 = threefry_int(key & _M32, (key >> 32) & _M32,
                          counter & _M32, (counter >> 32) & _M32)
    return x0 | (x1 << 32)


def label_int(label) -> int:
    """A label as 64 bits: an int itself, a string its FNV-1a hash."""
    if not isinstance(label, str):
        return int(label) & _M64
    acc = FNV_BASIS
    for b in label.encode("utf-8"):
        acc = ((acc ^ b) * FNV_PRIME) & _M64
    return acc


def derive(key: int, *path) -> int:
    """A child key: each label folded in as ``bits64(key, label)``."""
    k = key & _M64
    for label in path:
        k = bits64(k, label_int(label))
    return k


class Stream:
    """A host's sequential stream: the counter's 64 bits in turn."""

    def __init__(self, key: int):
        self.key = key & _M64
        self.counter = 0

    def next_u64(self) -> int:
        v = bits64(self.key, self.counter)
        self.counter += 1
        return v

    def next_int(self, bound: int) -> int:
        return self.next_u64() % bound


# -- the network ---------------------------------------------------------------

@dataclass
class Network:
    """One episode's network as the configuration and its seeds give it."""
    names: List[str]              # every host, in host-id order (id = i + 1)
    up_kibps: np.ndarray
    down_kibps: np.ndarray
    relays: List[str]
    weights: np.ndarray           # each relay's consensus weight
    clients: List[str]
    client_ids: np.ndarray        # host ids
    dest: np.ndarray              # each client's server index
    start_ns: np.ndarray
    servers: List[str]
    dirauth: str
    streams: int
    up_bytes: int
    down_bytes: int
    stop_ns: int


def network(config: Dict, traffic: Dict, draw_seed: int) -> Network:
    nr, ns, nc = (int(config[k]) for k in ("relays", "servers", "clients"))
    rng = np.random.default_rng(draw_seed)
    weights = np.array([int(rng.integers(WEIGHT_LO, WEIGHT_HI))
                        for _ in range(nr)], dtype=np.int64)
    dest = np.empty(nc, dtype=np.int64)
    start = np.empty(nc, dtype=np.int64)
    for i in range(nc):
        dest[i] = int(rng.integers(0, ns))
        start[i] = START_S + int(rng.integers(0, START_SPAN_S))
    relays = [f"relay{i}" for i in range(nr)]
    servers = [f"dest{i}" for i in range(ns)]
    clients = [f"torclient{i}" for i in range(nc)]
    names = ["dirauth"] + relays + servers + clients
    up = np.concatenate([[config["dirauth_kibps"]],
                         np.full(nr, config["relay_kibps"]),
                         np.full(ns, config["server_kibps"]),
                         np.full(nc, config["client_up_kibps"])])
    down = np.concatenate([[config["dirauth_kibps"]],
                           np.full(nr, config["relay_kibps"]),
                           np.full(ns, config["server_kibps"]),
                           np.full(nc, config["client_down_kibps"])])
    return Network(names, up.astype(np.int64), down.astype(np.int64),
                   relays, weights, clients,
                   np.arange(1 + nr + ns, 1 + nr + ns + nc) + 1,
                   dest, start * 10 ** 9, servers, "dirauth",
                   int(traffic["streams"]), int(traffic["up_bytes"]),
                   int(traffic["down_bytes"]),
                   int(config["stoptime_s"]) * 10 ** 9)


# -- the graph -------------------------------------------------------------------

@dataclass
class Graph:
    """Per-vertex loss and, over every ordered pair of vertices, the path
    latency in ns and the reliability (float32)."""
    latency_ns: np.ndarray        # [V, V] int64
    reliability: np.ndarray       # [V, V] float32


def graph(n_vertices: int, seed: int) -> Graph:
    n = int(n_vertices)
    rng = np.random.default_rng(seed)
    rng.integers(10 * 1024, 1000 * 1024, size=n)          # bandwidth
    lossy = rng.random(n) < 0.8
    vloss = np.where(lossy, 0.0, np.round(rng.random(n) * 0.002, 6))
    iu, ju = np.triu_indices(n, k=1)
    lat_ms = np.round(rng.uniform(2.0, 150.0, size=iu.size), 1)
    plain = rng.random(iu.size) < 0.5
    eloss = np.where(plain, 0.0, np.round(rng.random(iu.size) * 0.005, 6))
    edge_ns = np.ceil(lat_ms * 1_000_000).astype(np.int64)
    edge_rel = 1.0 - eloss
    lat = np.zeros((n, n), dtype=np.int64)
    rel = np.ones((n, n), dtype=np.float64)
    lat[iu, ju] = lat[ju, iu] = edge_ns
    pair = edge_rel * (1.0 - vloss[iu])
    rel[iu, ju] = pair * (1.0 - vloss[ju])
    rel[ju, iu] = edge_rel * (1.0 - vloss[ju]) * (1.0 - vloss[iu])
    for v in range(n):
        inc = np.flatnonzero((iu == v) | (ju == v))   # in file order
        e = inc[np.argmin(edge_ns[inc])]
        lat[v, v] = 2 * edge_ns[e]
        rel[v, v] = edge_rel[e] * edge_rel[e]
    lat = np.where(lat <= 0, TICK_NS, lat)
    return Graph(lat, np.clip(rel, 0.0, 1.0).astype(np.float32))


# -- the paths ---------------------------------------------------------------------

def consensus(net: Network) -> List[Tuple[str, int, int]]:
    """The authority's document: every relay by name, sorted."""
    return sorted((name, ORPORT, int(w))
                  for name, w in zip(net.relays, net.weights))


def pick(stream: Stream, cons: Sequence[Tuple[str, int, int]],
         hops: int = 3) -> List[str]:
    """Weighted draws without replacement over ``cons``."""
    names = [c[0] for c in cons]
    w = np.array([c[2] for c in cons], dtype=np.int64)
    out = []
    for _ in range(min(hops, len(names))):
        acc = np.cumsum(w)
        draw = stream.next_int(max(int(acc[-1]), 1))
        i = int(np.searchsorted(acc, draw, side="right"))
        if i >= len(names):
            i = len(names) - 1
        out.append(names[i])
        names.pop(i)
        w = np.delete(w, i)
    return out


def paths(net: Network, engine_seed: int,
          fetched: Sequence[Sequence[Tuple[str, int, int]]]
          ) -> List[List[str]]:
    """Each client's (guard, middle, exit), drawn over the consensus it
    fetched."""
    root = derive(engine_seed, "root")
    return [pick(Stream(derive(derive(root, "host", int(hid)),
                               "device-circuit")), cons)
            for hid, cons in zip(net.client_ids, fetched)]


def fetched(net: Network, rec: Dict) -> Tuple[List[list], int]:
    """Each client's consensus, from the count of relays it fetched and
    the authority's registrations, and how many clients' records break
    the rules the module's docstring gives (each counted once)."""
    cons = consensus(net)
    by_name = {c[0]: c for c in cons}
    reg = [(str(n), int(t)) for n, t in rec["registered"]]
    names = [n for n, _t in reg]
    at = np.array([t for _n, t in reg], dtype=np.int64)
    usable = sorted(names) == sorted(by_name) and bool(
        np.all(np.diff(at) >= 0)) and bool(np.all(at >= 0))
    weight = np.cumsum([by_name[n][2] if n in by_name else 0
                        for n in names]) if names else np.zeros(0)
    out, off = [], 0
    for i, client in enumerate(net.clients):
        app = rec["clients"].get(client) or {}
        k = int(app.get("consensus_relays", -1))
        if not usable or not 3 <= k <= len(names):
            out.append(cons)
            off += 1
            continue
        kept = set(names[:k])
        out.append([c for c in cons if c[0] in kept])
        ok = (int(weight[k - 1]) == int(app.get("consensus_weight", -1))
              and at[k - 1] <= int(app.get("fetched_ns", -1))
              and (k == len(names) or at[k] > int(net.start_ns[i])))
        off += int(not ok)
    return out, off


# -- the hops ------------------------------------------------------------------------

def hop_lanes(g: Graph, vertex_of_row: np.ndarray, src: np.ndarray,
              dst: np.ndarray, uid: np.ndarray, send: np.ndarray,
              barrier: np.ndarray, drop_key: int, bootstrap_end_ns: int,
              device) -> Tuple[np.ndarray, np.ndarray]:
    """(deliver, keep) of every lane, with torch on ``device``."""
    dev = torch.device(device)
    v = torch.as_tensor(vertex_of_row, device=dev)
    s = v[torch.as_tensor(src.astype(np.int64), device=dev)]
    d = v[torch.as_tensor(dst.astype(np.int64), device=dev)]
    lat = torch.as_tensor(g.latency_ns, device=dev)[s, d]
    rel = torch.as_tensor(g.reliability, device=dev)[s, d]
    t = torch.as_tensor(send, device=dev)
    deliver = torch.maximum(t + lat, torch.as_tensor(barrier, device=dev))
    u64 = torch.as_tensor(uid.view(np.int64), device=dev)
    x0, _ = threefry_torch(drop_key & _M32, drop_key >> 32, u64 & _M32,
                           (u64 >> 32) & _M32)
    u = (x0 >> 8).to(torch.float32) * (1.0 / (1 << 24))
    keep = (t < bootstrap_end_ns) | (rel >= 1.0) | (u <= rel)
    return deliver.cpu().numpy(), keep.cpu().numpy()


# -- the chains ----------------------------------------------------------------------

@dataclass
class Chains:
    """The plane's chains: each stage's host and bucket, latency in steps,
    the cells each chain carries, and the step of the plane."""
    host: np.ndarray              # [C, 5] host index
    lat_steps: np.ndarray         # [C, 4] steps to the next stage
    cells: np.ndarray             # [C]
    granule: int
    refill: np.ndarray            # per bucket, a step
    capacity: np.ndarray
    node: np.ndarray              # [C, 5] bucket of each stage


def chains(net: Network, route_paths: List[List[str]], lat_ns: np.ndarray,
           row_of_host: np.ndarray,
           layout_paths: List[List[str]]) -> Chains:
    """``lat_ns`` is over hosts' rows, ``row_of_host`` a host's row; the
    step is fixed from ``layout_paths``, the paths drawn over the whole
    document."""
    index = {n: i for i, n in enumerate(net.names)}
    n_hosts = len(net.names)
    c = len(net.clients)

    def stage_ms(paths_):
        host = np.empty((2 * c, STAGES), dtype=np.int64)
        for i, (client, p) in enumerate(zip(net.clients, paths_)):
            up = [client, *p, net.servers[net.dest[i]]]
            host[2 * i + 1] = [index[h] for h in up]
            host[2 * i] = host[2 * i + 1][::-1]
        rows = row_of_host[host]
        return host, np.maximum(lat_ns[rows[:, :-1], rows[:, 1:]]
                                // TICK_NS, 1)

    _host, layout_ms = stage_ms(layout_paths)
    host, lat_ms = stage_ms(route_paths)
    g = max(1, -(-(int(layout_ms.max()) + 1) // 64))
    lat_steps = np.maximum(-(-lat_ms // g), 1)
    cells = np.empty(2 * c, dtype=np.int64)
    cells[0::2] = net.streams * max(1, math.ceil(net.down_bytes / PAYLOAD))
    cells[1::2] = net.streams * max(1, math.ceil(net.up_bytes / PAYLOAD))
    node = host.copy()
    node[:, -1] += n_hosts
    rate = np.concatenate([net.up_kibps, net.down_kibps])
    refill = rate * 1024 // (10 ** 9 // TICK_NS)
    capacity = refill + MTU
    return Chains(host, lat_steps, cells, g, refill * g,
                  np.maximum(capacity, refill * g), node)


class StageCells:
    """The cells over every chain's stages as tensors on ``device``,
    advanced a step at a time in place: ``reference.Cells`` with a latency
    for each stage (arrivals gathered from the ring at each stage's own
    delay)."""

    def __init__(self, ch: Chains, device):
        c = ch.host.shape[0]
        dev = torch.device(device)
        self.dev = dev
        self.c = c
        flat_node = ch.node.reshape(-1)
        order = np.lexsort((np.tile(np.arange(STAGES), c),
                            np.repeat(np.arange(c), STAGES), flat_node))
        sorted_node = flat_node[order]
        first = np.flatnonzero(np.r_[True, sorted_node[1:]
                                     != sorted_node[:-1]])
        run_first = np.repeat(first, np.diff(np.r_[first, len(order)]))
        t64 = lambda a: torch.as_tensor(np.asarray(a, dtype=np.int64),
                                        device=dev)
        self.order = t64(order)
        self.sorted_node = t64(sorted_node)
        self.run_base = t64(np.maximum(run_first - 1, 0))
        self.has_base = t64(run_first > 0)
        self.refill = t64(ch.refill)
        self.capacity = t64(ch.capacity)
        self.ring_len = int(ch.lat_steps.max()) + 2
        self.lat = t64(ch.lat_steps.reshape(-1))
        self.cols = t64(np.arange(c * (STAGES - 1)))
        i64 = torch.int64
        self.t = torch.zeros((), dtype=i64, device=dev)
        self.tokens = self.capacity.clone()
        self.queued = torch.zeros((c, STAGES), dtype=i64, device=dev)
        self.ring = torch.zeros((self.ring_len, c * (STAGES - 1)),
                                dtype=i64, device=dev)
        self.target = torch.zeros(c, dtype=i64, device=dev)
        self.delivered = torch.zeros(c, dtype=i64, device=dev)
        self.done = torch.full((c,), -1, dtype=i64, device=dev)
        self.spent = torch.zeros(len(ch.refill), dtype=i64, device=dev)
        self.served = torch.zeros(c * STAGES, dtype=i64, device=dev)
        self.graphs: Dict[int, object] = {}
        self.pool = None

    def inject(self, chains_: np.ndarray, cells: np.ndarray) -> None:
        idx = torch.as_tensor(chains_, device=self.dev)
        n = torch.as_tensor(cells, device=self.dev)
        self.queued[:, 0].index_add_(0, idx, n)
        self.target.index_add_(0, idx, n)

    def idle(self, steps: int) -> None:
        torch.minimum(self.capacity, self.tokens + self.refill * steps,
                      out=self.tokens)
        self.ring.zero_()

    def _step(self) -> None:
        lr = self.ring_len
        slot = (self.t - self.lat) % lr
        arrive = self.ring[slot, self.cols].view(self.c, STAGES - 1)
        self.queued[:, 1:] += arrive
        torch.minimum(self.capacity, self.tokens + self.refill,
                      out=self.tokens)
        room = torch.div(self.tokens, WIRE_BYTES,
                         rounding_mode="floor")[self.sorted_node]
        q = self.queued.view(-1)[self.order]
        csum = torch.cumsum(q, 0)
        ahead = csum - q - csum[self.run_base] * self.has_base
        served = torch.minimum((room - ahead).clamp_(min=0), q)
        self.spent.zero_()
        self.spent.index_add_(0, self.sorted_node, served * WIRE_BYTES)
        self.tokens -= self.spent
        self.served.index_copy_(0, self.order, served)
        s = self.served.view(self.c, STAGES)
        self.queued -= s
        self.delivered += s[:, -1]
        newly = (self.done < 0) & (self.target > 0) \
            & (self.delivered >= self.target)
        self.done.copy_(torch.where(newly, self.t, self.done))
        self.ring.index_copy_(0, (self.t % lr).view(1),
                              s[:, :-1].reshape(1, -1))
        self.t += 1

    def steps(self, t: int, k: int, graph_len: int) -> None:
        """Steps ``t`` .. ``t + k - 1``; on a card runs of ``graph_len``
        replay one CUDA graph, shorter ones a graph of one step."""
        self.t.fill_(t)
        if self.dev.type != "cuda":
            for _ in range(k):
                self._step()
            return
        n = k if k == graph_len else 1
        g = self.graphs.get(n)
        if g is None:
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g, pool=self.pool):
                for _ in range(n):
                    self._step()
            self.pool = g.pool()
            self.graphs[n] = g
            self.t.fill_(t)
        for _ in range(k // n):
            g.replay()

    def warm(self) -> None:
        """One eager step on the empty state, which changes nothing there,
        so that every operation has run before a graph records it."""
        self.t.fill_(0)
        self._step()
        self.ring.zero_()
        self.tokens.copy_(self.capacity)


def run_chains(ch: Chains, inject_step: np.ndarray, end_step: int, device,
               every: int = 32) -> np.ndarray:
    """Each chain's completion step, its cells entering at ``inject_step``
    (-1: never); stretches with no cell anywhere pass as idle steps."""
    cells = StageCells(ch, device)
    cells.warm()
    order = np.argsort(inject_step, kind="stable")
    order = order[inject_step[order] >= 0]
    at = inject_step[order]
    groups = np.flatnonzero(np.r_[True, at[1:] != at[:-1]]) \
        if len(at) else np.zeros(0, dtype=np.int64)
    bounds = np.r_[groups, len(at)]
    injected = 0
    t = int(at[0]) if len(at) else end_step
    for gi in range(len(groups)):
        start = int(at[bounds[gi]])
        nxt = int(at[bounds[gi + 1]]) if gi + 1 < len(groups) else end_step
        if start >= end_step:
            break
        if start > t:
            cells.idle(start - t)
            t = start
        pick_ = order[bounds[gi]:bounds[gi + 1]]
        cells.inject(pick_, ch.cells[pick_])
        injected += int(ch.cells[pick_].sum())
        stop = min(nxt, end_step)
        while t < stop:
            if t % every == 0 and int(cells.delivered.sum()) >= injected:
                break
            k = min(every - t % every, stop - t)
            cells.steps(t, k, every)
            t += k
    return cells.done.cpu().numpy()


def least_time_ns(lat: np.ndarray, client: int, dirauth: int,
                  path_: Sequence[int]) -> int:
    """The least time from a client's start to its activation: the
    consensus fetch (the connect, the request and the document), the
    connect to the guard, CREATE, and each EXTEND (to the endpoint, its
    connect and CREATE onward, and back), at the hop latencies
    ``lat[a, b]`` between the rows of the hosts given."""
    g, m, e = path_
    rt = lambda a, b: int(lat[a, b] + lat[b, a])
    fetch = 2 * rt(client, dirauth)
    guard = 2 * rt(client, g)
    ext1 = int(lat[client, g]) + 2 * rt(g, m) + int(lat[g, client])
    ext2 = (int(lat[client, g]) + int(lat[g, m]) + 2 * rt(m, e)
            + int(lat[m, g]) + int(lat[g, client]))
    return fetch + guard + ext1 + ext2


# -- the episode -----------------------------------------------------------------------

@dataclass
class Outcome:
    """What the reference worked out for one episode."""
    consensus: List[Tuple[str, int, int]]
    paths: List[List[str]]
    fetch_off: int                # clients whose consensus breaks the rules
    deliver: np.ndarray
    keep: np.ndarray
    lanes_by_launch: np.ndarray
    granule: int
    done_step: np.ndarray
    earliest_step: np.ndarray     # [C] the least injection step allowed
    relay_circuits: Dict[str, int]
    apps: Tuple[int, int, int]    # streams, bytes up, bytes down a client
    # the least time each recorded launch of the hop kernel takes needs
    # its lanes and distinct (src, dst) pairs
    pairs_by_launch: np.ndarray


def simulate(rec: Dict, config: Dict, traffic: Dict, device) -> Outcome:
    net = network(config, traffic, rec["draw_seed"])
    g = graph(config["vertices"], rec["draw_seed"])
    root = derive(rec["engine_seed"], "root")
    cons = consensus(net)
    got, fetch_off = fetched(net, rec)
    route = paths(net, rec["engine_seed"], got)
    layout = paths(net, rec["engine_seed"], [cons] * len(net.clients))
    # a row off the graph is counted by compare; here it is clipped
    vr = np.clip(np.asarray(rec["vertex_of_row"], dtype=np.int64), 0,
                 len(g.latency_ns) - 1)
    lanes = np.asarray(rec["hop_lanes"], dtype=np.int64)
    barrier = np.repeat(np.asarray(rec["hop_barrier"], dtype=np.int64),
                        lanes)
    deliver, keep = hop_lanes(
        g, vr, rec["hop_src"], rec["hop_dst"], rec["hop_uid"],
        rec["hop_send"], barrier, derive(root, "packet_drop"),
        int(config["bootstrap_s"]) * 10 ** 9, device)
    # the latency between hosts, through the rows the record placed them on
    lat_rows = g.latency_ns[np.ix_(vr, vr)]
    row = np.clip([rec["row_of_host"].get(n, 0) for n in net.names], 0,
                  len(vr) - 1).astype(np.int64)
    ch = chains(net, route, lat_rows, row, layout)
    grid = ch.granule * TICK_NS
    done = run_chains(ch, np.asarray(rec["inject_step"], dtype=np.int64),
                      net.stop_ns // grid, device)
    index = {n: i for i, n in enumerate(net.names)}
    earliest = np.empty(2 * len(net.clients), dtype=np.int64)
    for i, (client, p) in enumerate(zip(net.clients, route)):
        least = least_time_ns(lat_rows, row[index[client]],
                              row[index[net.dirauth]],
                              [row[index[h]] for h in p])
        earliest[2 * i:2 * i + 2] = ((int(net.start_ns[i]) + least) // grid
                                     - (BATCH_STEPS - 1))
    circuits = {r: 0 for r in net.relays}
    for p in route:
        for r in p:
            circuits[r] += 1
    per = (net.streams, net.streams * net.up_bytes,
           net.streams * net.down_bytes)
    pairs = []
    at = 0
    for n in lanes.tolist():
        s = np.asarray(rec["hop_src"][at:at + n], dtype=np.int64)
        d = np.asarray(rec["hop_dst"][at:at + n], dtype=np.int64)
        pairs.append(np.unique(s * (1 << 32) + d).size)
        at += n
    return Outcome(cons, route, fetch_off, deliver, keep, lanes, ch.granule,
                   done, earliest, circuits, per,
                   np.asarray(pairs, dtype=np.int64))


def compare(rec: Dict, out: Outcome, config: Dict,
            traffic: Dict) -> Dict[str, int]:
    """The episode's answers that differ from the reference's, by kind."""
    net = network(config, traffic, rec["draw_seed"])
    # paths: the authority's document, each client's consensus, its
    # runtime path and the route the plane's chains took
    got_cons = [tuple(x) for x in rec["consensus"]]
    paths_off = (sum(a != b for a, b in zip(got_cons, out.consensus))
                 + abs(len(got_cons) - len(out.consensus)) + out.fetch_off)
    for i, client in enumerate(net.clients):
        want = list(out.paths[i])
        app = rec["clients"].get(client)
        if app is None or list(app["path"]) != want:
            paths_off += 1
        route = rec["plane_routes"].get(client)
        if route != [client, *want, net.servers[net.dest[i]]]:
            paths_off += 1
    # hops: every lane's delivery and drop; a row off the graph, or a
    # launch whose lanes went unrecorded, counts each of its lanes
    n_vertices = int(config["vertices"])
    v = np.asarray(rec["vertex_of_row"], dtype=np.int64)
    bad_rows = ((v < 0) | (v >= n_vertices)).sum() \
        + (len(np.unique(v)) != len(v))
    lanes = np.asarray(rec["hop_lanes"], dtype=np.int64)
    n = int(lanes.sum())
    got_d = np.asarray(rec["hop_deliver"], dtype=np.int64)
    got_k = np.asarray(rec["hop_keep"], dtype=bool)
    if got_d.shape != (n,) or got_k.shape != (n,) \
            or out.deliver.shape != (n,):
        hops_off = max(n, 1)
    else:
        hops_off = int(((got_d != out.deliver) | (got_k != out.keep)).sum())
    rows = np.concatenate([np.asarray(rec["hop_src"]),
                           np.asarray(rec["hop_dst"])]) if n else \
        np.zeros(0, dtype=np.int64)
    hops_off += int(bad_rows) + int(((rows < 0) | (rows >= len(v))).sum())
    # chains: each completion step, and each injection no earlier than
    # the client's messages allow
    got = np.asarray(rec["chain_done"], dtype=np.int64)
    inj = np.asarray(rec["inject_step"], dtype=np.int64)
    chains_off = (len(out.done_step) if got.shape != out.done_step.shape
                  else int((got != out.done_step).sum()))
    chains_off += int(rec["granule"] != out.granule)
    if inj.shape == out.earliest_step.shape:
        chains_off += int(((inj >= 0) & (inj < out.earliest_step)).sum())
    else:
        chains_off += len(out.earliest_step)
    if list(rec["chain_clients"]) != [c for c in net.clients
                                      for _ in (0, 1)]:
        chains_off += 1
    # apps: each client's streams and bytes; each relay's circuits
    apps_off = 0
    streams, up, down = out.apps
    for client in net.clients:
        app = rec["clients"].get(client)
        if app is None or app["streams_ok"] != streams \
                or app["bytes_up"] != up or app["bytes_down"] != down:
            apps_off += 1
    for relay, want in out.relay_circuits.items():
        apps_off += int(rec["relay_circuits"].get(relay, -1) != want)
    exit_off = int(rec["rc"] != 0) + sum(
        int(rec["clients"].get(c, {}).get("exit_code") != 0)
        for c in net.clients)
    return {"paths": int(paths_off), "hops": int(hops_off),
            "chains": int(chains_off), "apps": int(apps_off),
            "exit_code": int(exit_off)}
