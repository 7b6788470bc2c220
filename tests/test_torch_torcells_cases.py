"""Inputs for the torcells step tests, made with numpy from a seed and
without JAX (the card's test file uses them too, and the machine with the
card has no JAX): a small flow table laid out by the port's
``build_flows`` — the JAX package's ``DeviceTorCells(n_relays=6,
n_circuits=20, seed=5, relay_bw_kibps=512, max_latency_ms=20)`` toy,
built the same way — and busy random states on it."""

import numpy as np

from shadow_tpu_torch.ops.bandwidth import bucket_params
from shadow_tpu_torch.ops.torcells_device import RING_DTYPE, build_flows


def toy_instance(n_relays=6, n_circuits=20, seed=5, relay_bw_kibps=512,
                 edge_bw_kibps=1 << 20, max_latency_ms=20):
    """Clients, relays (the contended resource) and servers; every
    circuit server -> exit -> middle -> guard -> client."""
    rng = np.random.default_rng(seed)
    n_clients = n_circuits
    n_servers = max(1, n_circuits // 50)
    h = n_clients + n_relays + n_servers
    lat = rng.integers(2, max_latency_ms, size=(h, h)).astype(np.int64)
    np.fill_diagonal(lat, 1)
    bw = np.full(h, edge_bw_kibps, dtype=np.int64)
    bw[n_clients:n_clients + n_relays] = relay_bw_kibps
    refill, cap = bucket_params(bw)
    route = np.empty((n_circuits, 5), dtype=np.int64)
    route[:, 4] = np.arange(n_circuits)
    route[:, 0] = n_clients + n_relays + rng.integers(0, n_servers,
                                                      size=n_circuits)
    picks = rng.random((n_circuits, n_relays)).argsort(axis=1)[:, :3]
    route[:, 1:4] = n_clients + picks
    fl = build_flows(route, lat)
    last = fl["flow_succ"] < 0
    first = fl["flow_stage"] == 0
    last_flow = np.empty(n_circuits, dtype=np.int64)
    last_flow[fl["flow_circ"][last]] = np.flatnonzero(last)
    first_flow = np.empty(n_circuits, dtype=np.int64)
    first_flow[fl["flow_circ"][first]] = np.flatnonzero(first)
    return {"tables": (fl["flow_node"], fl["flow_lat"], fl["flow_succ"],
                       fl["seg_start"], refill.astype(np.int64),
                       cap.astype(np.int64), last_flow),
            "ring_len": int(max_latency_ms) + 2, "f": n_circuits * 5,
            "h": h, "c": n_circuits, "first_flow": first_flow,
            "last_flow": last_flow}


def zero_state(inst, t0=0):
    f, h = inst["f"], inst["h"]
    return (np.int64(t0), np.zeros(f, np.int64),
            np.zeros((inst["ring_len"], f), RING_DTYPE),
            inst["tables"][5].copy(), np.zeros(f, np.int64),
            np.zeros(f, np.int64), np.full(f, -1, np.int64),
            np.zeros(h, np.int64))


def random_state(inst, seed, t0=500):
    """A busy state: cells queued and in flight, part-full buckets, exit
    flows part delivered with targets (some one cell from done), a few
    chains done already."""
    rng = np.random.default_rng(seed)
    f, h, lr = inst["f"], inst["h"], inst["ring_len"]
    last = inst["tables"][2] < 0
    cap = inst["tables"][5]
    delivered = np.where(last, rng.integers(0, 50, size=f), 0)
    target = np.where(last, delivered + rng.integers(1, 60, size=f), 0)
    near = last & (rng.random(f) < 0.2)
    target[near] = delivered[near] + 1
    done = np.full(f, -1, np.int64)
    pre = last & (rng.random(f) < 0.1)
    done[pre] = rng.integers(0, t0, size=int(pre.sum()))
    return (np.int64(t0), rng.integers(0, 30, size=f).astype(np.int64),
            rng.integers(0, 9, size=(lr, f)).astype(RING_DTYPE),
            (rng.random(h) * cap).astype(np.int64),
            delivered.astype(np.int64), target.astype(np.int64), done,
            rng.integers(0, 1 << 40, size=h).astype(np.int64))


def injection(inst, chains, cells):
    inj = np.zeros(inst["f"], np.int64)
    inj_t = np.zeros(inst["f"], np.int64)
    inj[inst["first_flow"][chains]] = cells
    inj_t[inst["last_flow"][chains]] = cells
    return inj, inj_t
