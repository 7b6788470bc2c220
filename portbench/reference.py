"""The plain reference: a processless Tor experiment's device traffic,
worked out again from the benchmark's own configuration.

Nothing here imports the program under test or JAX: the circuits, the
hosts' token buckets, the path latency, the tick schedule and the cells'
progress are all derived from the configuration and traffic files, with
numpy and plain torch operations only.

The model (the semantics the configuration states):

* every client runs one circuit of 3 distinct relays (guard, middle,
  exit) to one server, drawn with numpy's ``default_rng(path_seed)``;
  it downloads ``down_bytes`` over the chain server -> exit -> middle ->
  guard -> client and uploads ``up_bytes`` over the reverse chain, in
  cells of 505 payload bytes, 578 bytes on the wire;
* time runs in 1 ms ticks.  Each host has an egress bucket (its up rate)
  that paces the chain stages it sends from and an ingress bucket (its
  down rate) that paces the stage that delivers to it; a bucket refills
  ``rate * 1024 // 1000`` bytes a tick up to that plus one MTU, and serves
  its queued cells greedily in (chain, stage) order;
* a cell served at a stage arrives at the next stage after the path
  latency (the one vertex's 10 ms self-loop taken twice, 20 ticks);
* the engine's round loop decides when a client's cells enter: rounds of
  one lookahead (the path latency), a dispatch at least every 8 ticks,
  up to 8 quiet rounds merged into one dispatch that stops at the first
  merged round in which a chain completed, and injections folded in at a
  dispatch's first tick.  :class:`Schedule` restates that loop.

:func:`simulate` returns every chain's completion tick, the cells
forwarded, every host's bytes sent and received, and the ticks of each
dispatch (for the span kernel's roofline).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

TICK_NS = 1_000_000
CELL_BYTES = 512
CELL_HEADER = 7                  # circuit id (4), command (1), length (2)
PAYLOAD = CELL_BYTES - CELL_HEADER
WIRE_HEADER = 66                 # TCP + IP + Ethernet headers
WIRE_BYTES = CELL_BYTES + WIRE_HEADER
MTU = 1500
STAGES = 5                       # a chain's hops: 4 sends and a delivery
# the round loop's constants: ticks a dispatch carries at least, rounds
# merged into one dispatch at most, and the ring's reach in granules
MIN_DISPATCH_TICKS = 8
MERGED_ROUNDS = 8
RING_GRANULES = 64
FAR = 2 ** 63 - 1


@dataclass
class Network:
    """One experiment as the reference sees it: hosts, chains, starts."""
    host_names: List[str]
    bw_up: np.ndarray             # KiB/s per host
    bw_down: np.ndarray
    route: np.ndarray             # [C, 5] host index per stage
    cells: np.ndarray             # [C] cells a chain carries
    start_ns: np.ndarray          # [n_circuits] when a client starts
    latency_ns: int
    stop_ns: int


def tor_circuits(n_clients: int, n_relays: int, n_servers: int,
                 path_seed: int):
    """(guard, middle, exit, server) indices, 0-based: three distinct
    relays drawn from shrinking ranges and shifted past the earlier picks,
    then a server, all from one seeded numpy generator."""
    rng = np.random.default_rng(path_seed)
    a = rng.integers(0, n_relays, n_clients)
    b = rng.integers(0, n_relays - 1, n_clients)
    b = b + (b >= a)
    c = rng.integers(0, n_relays - 2, n_clients)
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    c = c + (c >= lo)
    c = c + (c >= hi)
    d = rng.integers(0, max(n_servers, 1), n_clients)
    return a, b, c, d


def tor_network(config: Dict, traffic: Dict, path_seed: int) -> Network:
    """The experiment a configuration and traffic mix describe."""
    nr, ns, nc = config["relays"], config["servers"], config["clients"]

    def names(prefix: str, n: int) -> List[str]:
        return [prefix] if n == 1 else [f"{prefix}{i + 1}" for i in range(n)]

    host_names = (names("relay", nr) + names("dest", ns)
                  + names("torclient", nc))
    bw_up = np.concatenate([
        np.full(nr, config["relay_kibps"]), np.full(ns, config["server_kibps"]),
        np.full(nc, config["client_up_kibps"])]).astype(np.int64)
    bw_down = np.concatenate([
        np.full(nr, config["relay_kibps"]), np.full(ns, config["server_kibps"]),
        np.full(nc, config["client_down_kibps"])]).astype(np.int64)
    g, m, e, d = tor_circuits(nc, nr, ns, path_seed)
    client = nr + ns + np.arange(nc)
    server = nr + d
    down = np.stack([server, e, m, g, client], axis=1)
    up = down[:, ::-1]
    route = np.empty((2 * nc, STAGES), dtype=np.int64)
    route[0::2] = down
    route[1::2] = up
    cells = np.empty(2 * nc, dtype=np.int64)
    cells[0::2] = max(1, math.ceil(traffic["down_bytes"] / PAYLOAD))
    cells[1::2] = math.ceil(traffic["up_bytes"] / PAYLOAD)
    q = np.arange(nc)
    start_ns = (round(traffic["start_s"] * 1e9)
                + (q % traffic["waves"]) * round(traffic["step_s"] * 1e9))
    return Network(host_names, bw_up, bw_down, route, cells,
                   start_ns.astype(np.int64),
                   2 * int(config["vertex_latency_ms"]) * TICK_NS,
                   int(config["stoptime_s"]) * 10 ** 9)


@dataclass
class Outcome:
    """What the reference worked out for one experiment."""
    done_tick: np.ndarray          # [C] tick a chain delivered its last cell
    forwards: int
    host_tx: np.ndarray            # [hosts] bytes sent
    host_rx: np.ndarray            # [hosts] bytes received
    completed: int                 # circuits with both chains delivered
    granule_ms: int
    dispatch_ticks: List[int] = field(default_factory=list)
    # the table's shape: flows, chains, buckets in use, ring slots
    shape: Tuple[int, int, int, int] = (0, 0, 0, 0)


class Cells:
    """The cells' state over the chains' stages, as tensors on ``device``,
    advanced tick by tick in place.  On a card a run of ticks is one
    replay of a CUDA graph of them (the same operations, recorded once
    per run length), so the host's launches do not set the pace."""

    def __init__(self, net: Network, granule: int, device):
        c = net.route.shape[0]
        n_hosts = len(net.host_names)
        self.dev = device
        self.c = c
        # node of a stage: the sender's egress bucket, or for the last
        # stage the receiver's ingress bucket
        node = net.route.copy()
        node[:, -1] += n_hosts
        rate = np.concatenate([net.bw_up, net.bw_down])
        refill = rate * 1024 // (10 ** 9 // TICK_NS)
        capacity = refill + MTU
        self.refill = torch.as_tensor(refill * granule, device=device)
        self.capacity = torch.as_tensor(
            np.maximum(capacity, refill * granule), device=device)
        # greedy order: by node, then chain, then stage
        flat_node = node.reshape(-1)
        chain = np.repeat(np.arange(c), STAGES)
        stage = np.tile(np.arange(STAGES), c)
        order = np.lexsort((stage, chain, flat_node))
        sorted_node = flat_node[order]
        first = np.flatnonzero(np.r_[True, sorted_node[1:] != sorted_node[:-1]])
        run_first = np.repeat(first, np.diff(np.r_[first, len(order)]))
        self.order = torch.as_tensor(order, device=device)
        self.sorted_node = torch.as_tensor(sorted_node, device=device)
        # a flow's run (its node's flows before it) starts after csum[base]
        self.run_base = torch.as_tensor(np.maximum(run_first - 1, 0),
                                        device=device)
        self.has_base = torch.as_tensor((run_first > 0).astype(np.int64),
                                        device=device)
        self.n_nodes = 2 * n_hosts
        lat_ticks = max(net.latency_ns // TICK_NS, 1)
        self.lat = -(-lat_ticks // granule)
        self.ring_len = self.lat + 2
        i64 = torch.int64
        self.t = torch.zeros((), dtype=i64, device=device)
        self.tokens = self.capacity.clone()
        self.queued = torch.zeros((c, STAGES), dtype=i64, device=device)
        self.ring = torch.zeros((self.ring_len, c, STAGES - 1), dtype=i64,
                                device=device)
        self.target = torch.zeros(c, dtype=i64, device=device)
        self.delivered = torch.zeros(c, dtype=i64, device=device)
        self.active = torch.zeros(c, dtype=torch.bool, device=device)
        self.done = torch.full((c,), -1, dtype=i64, device=device)
        self.node_sent = torch.zeros(self.n_nodes, dtype=i64, device=device)
        self.spent = torch.zeros(self.n_nodes, dtype=i64, device=device)
        self.served = torch.zeros(c * STAGES, dtype=i64, device=device)
        self.graphs: Dict[int, object] = {}
        self.pool = None
        self.n_done = 0

    def inject(self, chains: np.ndarray, cells: np.ndarray) -> None:
        idx = torch.as_tensor(chains, device=self.dev)
        n = torch.as_tensor(cells, device=self.dev)
        self.queued[:, 0].index_add_(0, idx, n)
        self.target.index_add_(0, idx, n)
        self.active[idx] = True

    def idle(self, ticks: int) -> None:
        """``ticks`` ticks with no cell anywhere: the buckets refill and
        the ring holds nothing."""
        torch.minimum(self.capacity, self.tokens + self.refill * ticks,
                      out=self.tokens)
        self.ring.zero_()

    def _tick(self) -> None:
        """Tick ``self.t``, then ``self.t`` += 1."""
        lr = self.ring_len
        arrive = self.ring.index_select(0, (self.t - self.lat) % lr)[0]
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
        self.node_sent += self.spent
        self.served.index_copy_(0, self.order, served)
        s = self.served.view(self.c, STAGES)
        self.queued -= s
        self.delivered += s[:, -1]
        newly = self.active & (self.delivered >= self.target)
        self.done.copy_(torch.where(newly, self.t, self.done))
        self.active ^= newly
        self.ring.index_copy_(0, self.t % lr,
                              s[:, :-1].contiguous().unsqueeze(0))
        self.t += 1

    def ticks(self, t: int, k: int, graph_len: int) -> None:
        """Ticks ``t`` .. ``t + k - 1``: on a card a run of ``graph_len``
        as one graph, a shorter run tick by tick through a graph of one."""
        self.t.fill_(t)
        if self.dev.type != "cuda":
            for _ in range(k):
                self._tick()
            return
        n = k if k == graph_len else 1
        graph = self.graphs.get(n)
        if graph is None:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=self.pool):
                for _ in range(n):
                    self._tick()
            self.pool = graph.pool()
            self.graphs[n] = graph
            self.t.fill_(t)
        for _ in range(k // n):
            graph.replay()

    def warm(self) -> None:
        """One eager tick on the empty state (a tick that changes nothing
        there), so every operation has run once before a graph records it."""
        self.t.fill_(0)
        self._tick()
        self.ring.zero_()

    def delivered_sum(self) -> int:
        return int(self.delivered.sum())

    def take_new_done(self) -> bool:
        """Whether a chain completed since the last call."""
        n = int((self.done >= 0).sum())
        out, self.n_done = n > self.n_done, n
        return out

    def forwards(self) -> int:
        """Cells served at any stage: each spent one wire cell's bytes."""
        return int(self.node_sent.sum()) // WIRE_BYTES


class Schedule:
    """The engine's round loop over a processless run, restated: which
    ticks each dispatch covers and which clients' cells it folds in."""

    def __init__(self, net: Network, cells: Cells, granule: int,
                 check_every: int = 32):
        self.net = net
        self.cells = cells
        self.grid = granule * TICK_NS
        self.lookahead = net.latency_ns
        self.end = net.stop_ns
        self.check_every = check_every
        order = np.lexsort((np.arange(len(net.start_ns)), net.start_ns))
        self.autos = [(int(net.start_ns[i]), int(i)) for i in order]
        self.pos = 0
        self.synced = 0
        self.pending: List[Tuple[int, int]] = []   # (chain, cells)
        self.started = False                        # state exists
        self.injected = 0
        self.dispatched = 0
        self.delivered_seen = 0
        self.banked = 0
        self.inflight = False
        # a merged dispatch: (targets, the round of each, the rounds' bounds)
        self.plan = None
        self.active_plan = None
        self.result = 0                  # the tick the last dispatch reached
        self.dispatch_ticks: List[int] = []

    # -- the plane's view ------------------------------------------------
    def busy(self) -> bool:
        return bool(self.pending) or self.inflight \
            or self.delivered_seen < self.dispatched

    def next_time(self) -> int:
        t = FAR
        if self.pos < len(self.autos):
            t = self.autos[self.pos][0]
        if self.busy():
            t = min(t, (self.synced + MIN_DISPATCH_TICKS) * self.grid)
        return t

    def stage(self, now: int) -> None:
        cells = self.net.cells
        while self.pos < len(self.autos) and self.autos[self.pos][0] <= now:
            circ = self.autos[self.pos][1]
            self.pos += 1
            self.pending.append((2 * circ, int(cells[2 * circ])))
            if cells[2 * circ + 1]:
                self.pending.append((2 * circ + 1, int(cells[2 * circ + 1])))
            self.injected += int(cells[2 * circ] + cells[2 * circ + 1])

    def merge(self, nxt: int) -> Optional[int]:
        """Merge up to MERGED_ROUNDS rounds from ``nxt`` into one dispatch:
        keeps (targets, the round of each target, the rounds' bounds) for
        the launch and returns the merged window's end; None where fewer
        than two rounds merge."""
        if not self.started or self.inflight:
            return None
        if not self.pending and self.delivered_seen >= self.dispatched:
            return None
        synced = self.synced
        bounds, targets, round_of = [], [], []
        ws = nxt
        for i in range(MERGED_ROUNDS):
            we = min(ws + self.lookahead, self.end)
            t_i = we // self.grid
            if t_i - synced >= MIN_DISPATCH_TICKS:
                targets.append(t_i)
                round_of.append(i)
                synced = t_i
            bounds.append((ws, we))
            nxt_dev = (synced + MIN_DISPATCH_TICKS) * self.grid
            if nxt_dev >= self.end:
                break
            ws = nxt_dev
        if len(bounds) < 2 or not targets:
            return None
        self.plan = (targets, round_of, bounds)
        return bounds[-1][1]

    # -- one round ---------------------------------------------------------
    def collect(self) -> None:
        if not self.inflight:
            return
        self.inflight = False
        t_stop = self.result
        self.delivered_seen = self.cells.delivered_sum()
        if self.active_plan is not None:
            targets = self.active_plan[0]
            if t_stop not in targets:
                raise AssertionError(f"dispatch stopped at {t_stop}, not "
                                     f"one of {targets}")
            self.synced = t_stop
            self.active_plan = None

    def launch(self, ws: int, we: int) -> None:
        if self.pos < len(self.autos):
            if not self.started and not self.pending and self.injected == 0:
                self.synced = max(self.synced, ws // self.grid)
            self.stage(ws)
        plan, self.plan = self.plan, None
        if plan is None:
            target = we // self.grid
            n = target - self.synced
            if n <= 0 and not self.pending:
                return
            n = max(n, 0)
            if not self.started:
                if not self.pending and self.injected == 0:
                    self.synced = target
                    return
                self.started = True
            elif not self.pending and self.delivered_seen >= self.dispatched:
                self.banked += n
                self.synced = target
                return
            if n < MIN_DISPATCH_TICKS:
                return
            targets = [target]
        else:
            targets = plan[0]
        if self.pending:
            chains = np.array([c for c, _n in self.pending], dtype=np.int64)
            cells = np.array([n for _c, n in self.pending], dtype=np.int64)
            self.cells.inject(chains, cells)
            self.dispatched += int(cells.sum())
            self.pending = []
        idle, self.banked = self.banked, 0
        if idle:
            self.cells.idle(idle)
        t0 = self.synced
        self.result = self.run(t0, targets)
        self.dispatch_ticks.append(self.result - t0)
        if plan is None:
            self.synced = targets[-1]
        else:
            self.active_plan = plan
        self.inflight = True

    def run(self, t: int, targets: List[int]) -> int:
        """Ticks from ``t`` through the boundaries ``targets``, stopping at
        the first boundary after a chain completed; returns the tick
        reached.  Stretches in which no cell is anywhere are skipped as
        idle ticks (checked every ``check_every`` ticks)."""
        cells = self.cells
        every = self.check_every
        cells.take_new_done()
        for bound in targets:
            while t < bound:
                if (t % every == 0
                        and cells.delivered_sum() >= self.dispatched):
                    cells.idle(bound - t)
                    t = bound
                    break
                k = min(every - t % every, bound - t)
                cells.ticks(t, k, every)
                t += k
            if cells.take_new_done():
                return t
        return t

    def loop(self) -> None:
        while True:
            self.collect()
            nxt = self.next_time()
            if nxt >= self.end or nxt >= FAR:
                break
            we = min(nxt + self.lookahead, self.end)
            merged = self.merge(nxt)
            if merged is not None:
                we = merged
            self.launch(nxt, we)


def granule_of(net: Network) -> int:
    lat_ticks = max(net.latency_ns // TICK_NS, 1)
    return max(1, -(-(lat_ticks + 1) // RING_GRANULES))


def simulate(net: Network, device) -> Outcome:
    """The experiment's device traffic, tick by tick on ``device``."""
    g = granule_of(net)
    cells = Cells(net, g, device)
    cells.warm()
    sched = Schedule(net, cells, g)
    sched.loop()
    n_hosts = len(net.host_names)
    done = cells.done.cpu().numpy()
    sent = cells.node_sent.cpu().numpy()
    has_up = net.cells[1::2] > 0
    both = (done[0::2] >= 0) & ((done[1::2] >= 0) | ~has_up)
    used = len(np.unique(net.route[:, :-1])) + len(np.unique(net.route[:, -1]))
    shape = (net.route.size, net.route.shape[0], used, cells.ring_len)
    return Outcome(done, cells.forwards(), sent[:n_hosts].copy(),
                   sent[n_hosts:].copy(), int(both.sum()), g,
                   sched.dispatch_ticks, shape)
