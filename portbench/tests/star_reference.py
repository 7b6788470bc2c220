"""The plain reference of the star scenario (``scenario_star.py``): one
server, every client pulling a download from it and sending an upload
to it, each transfer a 2-hop chain on the device plane.

Numpy only; nothing here imports the program.  The cells' progress over
a chain's two stages (the sender's egress bucket, then the receiver's
ingress bucket, the path latency between them) is worked out here; when
the cells enter is the engine's round loop, which
``portbench/reference.py``'s :class:`Schedule` restates, and that
restatement is reused unchanged.  The test copies this file to
``portbench/star_reference.py`` of a copy of the benchmark.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

from portbench.reference import (MTU, PAYLOAD, TICK_NS, WIRE_BYTES, Network,
                                 Schedule, granule_of)

# the program's built-in topology (no topology in the configuration): one
# vertex whose 10 ms self-loop a path between two hosts takes twice
PATH_LATENCY_NS = 20 * TICK_NS


def star_network(config: Dict, traffic: Dict) -> Network:
    nc = int(config["clients"])
    names: List[str] = ["server"] + (
        ["client"] if nc == 1 else [f"client{q + 1}" for q in range(nc)])
    bw_up = np.array([config["server_kibps"]]
                     + [config["client_up_kibps"]] * nc, dtype=np.int64)
    bw_down = np.array([config["server_kibps"]]
                       + [config["client_down_kibps"]] * nc, dtype=np.int64)
    client = 1 + np.arange(nc)
    route = np.zeros((2 * nc, 2), dtype=np.int64)
    route[0::2, 1] = client          # server -> client
    route[1::2, 0] = client          # client -> server
    cells = np.empty(2 * nc, dtype=np.int64)
    cells[0::2] = max(1, math.ceil(traffic["down_bytes"] / PAYLOAD))
    cells[1::2] = math.ceil(traffic["up_bytes"] / PAYLOAD)
    q = np.arange(nc)
    start_ns = (round(traffic["start_s"] * 1e9)
                + (q % traffic["waves"]) * round(traffic["step_s"] * 1e9))
    return Network(names, bw_up, bw_down, route, cells,
                   start_ns.astype(np.int64), PATH_LATENCY_NS,
                   int(config["stoptime_s"]) * 10 ** 9)


class Cells:
    """Cells over the chains' stages in numpy: each tick the cells due
    arrive, each bucket refills and serves its queue greedily in (chain,
    stage) order, and what a stage served reaches the next stage after
    the path latency."""

    def __init__(self, net: Network, granule: int):
        c, s = net.route.shape
        n = len(net.host_names)
        node = net.route.copy()
        node[:, -1] += n             # the last stage: the ingress bucket
        rate = np.concatenate([net.bw_up, net.bw_down])
        refill = rate * 1024 // (10 ** 9 // TICK_NS)
        self.refill = refill * granule
        self.capacity = np.maximum(refill + MTU, self.refill)
        self.tokens = self.capacity.copy()
        self.node = node
        self.c, self.s = c, s
        # greedy order: a bucket's stages by chain, then stage; a stage is
        # served what its bucket has room for after those ahead of it
        flat = node.reshape(-1)
        self.order = np.lexsort((np.tile(np.arange(s), c),
                                 np.repeat(np.arange(c), s), flat))
        self.sorted_node = flat[self.order]
        first = np.r_[True, self.sorted_node[1:] != self.sorted_node[:-1]]
        self.run_start = np.maximum.accumulate(
            np.where(first, np.arange(len(flat)), 0))
        self.lat = -(-max(net.latency_ns // TICK_NS, 1) // granule)
        self.queued = np.zeros((c, s), dtype=np.int64)
        # in flight: cells arriving at stage j + 1, by the tick they arrive
        self.flight: Dict[int, np.ndarray] = {}
        self.target = np.zeros(c, dtype=np.int64)
        self.delivered = np.zeros(c, dtype=np.int64)
        self.active = np.zeros(c, dtype=bool)
        self.done = np.full(c, -1, dtype=np.int64)
        self.sent = np.zeros(2 * n, dtype=np.int64)
        self.n_done = 0

    def inject(self, chains: np.ndarray, cells: np.ndarray) -> None:
        np.add.at(self.queued[:, 0], chains, cells)
        np.add.at(self.target, chains, cells)
        self.active[chains] = True

    def idle(self, ticks: int) -> None:
        self.tokens = np.minimum(self.capacity,
                                 self.tokens + self.refill * ticks)
        self.flight.clear()

    def tick(self, t: int) -> None:
        arrive = self.flight.pop(t, None)
        if arrive is not None:
            self.queued[:, 1:] += arrive
        self.tokens = np.minimum(self.capacity, self.tokens + self.refill)
        q = self.queued.reshape(-1)[self.order]
        before = np.cumsum(q) - q
        ahead = before - before[self.run_start]
        room = (self.tokens // WIRE_BYTES)[self.sorted_node]
        served = np.empty(self.c * self.s, dtype=np.int64)
        served[self.order] = np.minimum(np.maximum(room - ahead, 0), q)
        served = served.reshape(self.c, self.s)
        spent = np.bincount(self.node.reshape(-1),
                            weights=(served * WIRE_BYTES).reshape(-1),
                            minlength=len(self.tokens)).astype(np.int64)
        self.tokens -= spent
        self.sent += spent
        self.queued -= served
        self.delivered += served[:, -1]
        newly = self.active & (self.delivered >= self.target)
        self.done[newly] = t
        self.active &= ~newly
        if served[:, :-1].any():
            self.flight[t + self.lat] = served[:, :-1]

    def ticks(self, t: int, k: int, _graph_len: int) -> None:
        for i in range(k):
            self.tick(t + i)

    def delivered_sum(self) -> int:
        return int(self.delivered.sum())

    def take_new_done(self) -> bool:
        n = int((self.done >= 0).sum())
        out, self.n_done = n > self.n_done, n
        return out


def simulate(net: Network) -> Dict:
    """Each chain's completion tick, each host's bytes sent and
    received, the cells forwarded, the clients with both chains done."""
    g = granule_of(net)
    cells = Cells(net, g)
    Schedule(net, cells, g).loop()
    n = len(net.host_names)
    done = cells.done
    has_up = net.cells[1::2] > 0
    both = (done[0::2] >= 0) & ((done[1::2] >= 0) | ~has_up)
    return {"done_tick": done, "granule_ms": g,
            "host_tx": cells.sent[:n], "host_rx": cells.sent[n:],
            "forwards": int(cells.sent.sum()) // WIRE_BYTES,
            "completed": int(both.sum())}
