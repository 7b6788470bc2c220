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


def skewed_instance(n_circuits, n_relays, zipf, seed=7, empty_every=0,
                    max_latency_ms=12):
    """Circuits over relays picked with Zipf-like weights ``1 / (r+1) **
    zipf`` (three distinct relays a circuit), so a few relays pace many
    flows: a small stand-in for the real tables' skew (tor10k: median 1,
    max 37 flows a node; a sweep lane: max 116, most flows on nodes above
    32).  With ``empty_every = k``, every k-th node id paces no flow (its
    bucket still refills)."""
    rng = np.random.default_rng(seed)
    n_servers = max(1, n_circuits // 20)
    h = n_circuits + n_relays + n_servers
    lat = rng.integers(2, max_latency_ms, size=(h, h)).astype(np.int64)
    np.fill_diagonal(lat, 1)
    bw = np.full(h, 1 << 20, dtype=np.int64)
    bw[n_circuits:n_circuits + n_relays] = rng.integers(
        256, 2048, size=n_relays)
    refill, cap = bucket_params(bw)
    weights = 1.0 / (np.arange(n_relays) + 1.0) ** zipf
    weights /= weights.sum()
    route = np.empty((n_circuits, 5), dtype=np.int64)
    route[:, 4] = np.arange(n_circuits)
    route[:, 0] = n_circuits + n_relays + rng.integers(
        0, n_servers, size=n_circuits)
    for c in range(n_circuits):
        route[c, 1:4] = n_circuits + rng.choice(n_relays, size=3,
                                                replace=False, p=weights)
    fl = build_flows(route, lat)
    node_of = np.arange(h, dtype=np.int64)
    if empty_every:
        node_of = node_of + node_of // (empty_every - 1) + 1
        h2 = int(node_of[-1]) + 1
        keep = np.zeros(h2, dtype=bool)
        keep[node_of] = True
        r2 = rng.integers(1, 50_000, size=h2).astype(np.int64)
        c2 = r2 * 4
        r2[node_of], c2[node_of] = refill, cap
        refill, cap, h = r2, c2, h2
    flow_node = node_of[fl["flow_node"]]
    last = fl["flow_succ"] < 0
    first = fl["flow_stage"] == 0
    last_flow = np.empty(n_circuits, dtype=np.int64)
    last_flow[fl["flow_circ"][last]] = np.flatnonzero(last)
    first_flow = np.empty(n_circuits, dtype=np.int64)
    first_flow[fl["flow_circ"][first]] = np.flatnonzero(first)
    return {"tables": (flow_node, fl["flow_lat"], fl["flow_succ"],
                       fl["seg_start"], refill.astype(np.int64),
                       cap.astype(np.int64), last_flow),
            "ring_len": int(max_latency_ms) + 2, "f": n_circuits * 5,
            "h": h, "c": n_circuits, "first_flow": first_flow,
            "last_flow": last_flow}


def _block_seg_scan(vals, heads, carry, threads, fpt):
    """The tile body's block-wide segmented inclusive scan, as the kernel
    takes it: each thread's aggregate over its ``fpt`` flows, the threads'
    exclusive prefixes in order from ``carry``, then each thread's flows
    from its prefix (numpy across the threads).  Returns (inclusive sums,
    the running sum after the chunk)."""
    v = np.asarray(vals, dtype=np.int64).reshape(threads, fpt)
    hd = np.asarray(heads, dtype=bool).reshape(threads, fpt)
    agg = np.zeros(threads, dtype=np.int64)
    flag = np.zeros(threads, dtype=bool)
    for k in range(fpt):
        agg = np.where(hd[:, k], v[:, k], agg + v[:, k])
        flag |= hd[:, k]
    # the running sum after each thread, restarting at a thread with a head
    c = np.cumsum(agg)
    last = np.maximum.accumulate(np.where(flag, np.arange(threads), -1))
    run = np.where(last >= 0, c - (c - agg)[np.maximum(last, 0)],
                   int(carry) + c)
    r = np.r_[np.int64(carry), run[:-1]]
    incl = np.empty_like(v)
    for k in range(fpt):
        r = np.where(hd[:, k], v[:, k], r + v[:, k])
        incl[:, k] = r
    return incl.reshape(-1), int(run[-1])


def tile_kernel_span(state, inject, inject_target, targets, idle, refill,
                     capacity, node_off, meta, tiles, ring_len, threads=256,
                     fpt=2, xin=None, xbuf_len=0):
    """The span kernels' algorithm re-stated in numpy for one table (one
    lane): csrc/torcells_span.cu's loop around csrc/span_tile.cuh's tick
    body over the tile tables of ``ops.torcells_device.span_tile_tables``,
    with the kernel's chunk (``threads * fpt`` flows) as a parameter so a
    small table exercises the carries.  Per tick, every tile's flows in
    chunks: the arrivals, a node's cap_cells and tokens from its first
    flow's slot (or the chunk carry), the segmented scan of q restarting
    at seg_start heads, served, the sends, and the segmented scan of
    served restarting at node heads, whose value at a node's last flow is
    its spent.  Returns the 9-tuple of ``torcells_step_span_torch`` as
    numpy (t_stop and forwards ints).

    With ``xin`` (the mesh's receive slots, parallel/mesh/exchange.py
    ``exchange_routes``) it is csrc/mesh_span.cu's loop around the body's
    mesh cases over ``mesh_tile_tables``: a successor of -1 is a last
    stage, -2 sends nowhere, F + k sends into slot k of the tick's half of
    a double-buffered exchange buffer of ``xbuf_len`` slots a half; a
    receiving flow takes tick t - 1's cell from the other half at the
    start of tick t (into its ring cell of row t - 1, and into its arrival
    when that is the row it reads), a column marked -2 is set to 0 each
    tick, and after the loop one pass lands the last tick's receives and
    the refills of the nodes that pace no flow, one for every tick run.
    The cells received are returned as a tenth element."""
    size = 512 + 66
    t0, queued, ring, tokens, delivered, target, done_tick, node_sent = \
        [np.array(a) for a in state]
    refill = np.asarray(refill, dtype=np.int64)
    capacity = np.asarray(capacity, dtype=np.int64)
    queued += inject
    target += inject_target
    tokens = np.minimum(capacity, tokens + refill * int(idle))
    if int(idle) > 0:
        ring[:] = 0
    node, succ, al, word = (np.asarray(meta, dtype=np.int64)[:, i]
                            for i in range(4))
    noff, seg_head, tail = word >> 2, (word & 1) != 0, (word & 2) != 0
    mesh = xin is not None
    f_all = len(word)
    xbuf = np.zeros(2 * xbuf_len, dtype=np.int64)
    prev_row, cross = -1, 0
    chunk = threads * fpt
    bounds = [int(x) for x in np.asarray(targets)]
    t, idx, span_done, forwards = int(t0), 0, False, 0
    while t < bounds[-1]:
        row_t = t % ring_len
        send_half = (t & 1) * xbuf_len
        recv_half = xbuf_len - send_half
        any_new = False
        for ti in range(len(tiles) - 1):
            n0, f0, n_empty = (int(x) for x in tiles[ti][:3])
            n1, f1 = (int(x) for x in tiles[ti + 1][:2])
            if n_empty and not mesh:
                for n in range(n0, n1):
                    if node_off[n] == node_off[n + 1]:
                        tokens[n] = min(capacity[n], tokens[n] + refill[n])
            carry_q = carry_s = 0
            carry_cap = carry_tok = None
            for cb in range(f0, f1, chunk):
                j = cb + np.arange(chunk)
                act = j < f1
                q = np.zeros(chunk, dtype=np.int64)
                s_cap = np.zeros(chunk, dtype=np.int64)
                s_tok = np.zeros(chunk, dtype=np.int64)
                for p in np.flatnonzero(act):
                    jj = j[p]
                    rr = row_t - al[jj]
                    rr = rr + ring_len if rr < 0 else rr
                    arr = int(ring[rr, jj])
                    recv = mesh and xin[jj] >= 0 and prev_row >= 0
                    if recv:
                        xv = int(xbuf[recv_half + xin[jj]])
                        if rr == prev_row:
                            arr = xv
                    q[p] = queued[jj] + arr
                    if al[jj] == 0 or (mesh and xin[jj] == -2):
                        ring[row_t, jj] = 0
                    if recv:
                        ring[prev_row, jj] = xv
                        cross += xv
                    if noff[jj] == 0:
                        n = node[jj]
                        s_tok[p] = min(capacity[n], tokens[n] + refill[n])
                        s_cap[p] = s_tok[p] // size
                heads = act & seg_head[np.minimum(j, len(word) - 1)]
                incl, carry_q = _block_seg_scan(q, heads, carry_q, threads,
                                                fpt)
                served = np.zeros(chunk, dtype=np.int64)
                cap = np.zeros(chunk, dtype=np.int64)
                tok = np.zeros(chunk, dtype=np.int64)
                for p in np.flatnonzero(act):
                    jj = j[p]
                    h = p - noff[jj]
                    if h < 0:
                        assert carry_cap is not None, "no carry to read"
                    cap[p] = s_cap[h] if h >= 0 else carry_cap
                    tok[p] = s_tok[h] if h >= 0 else carry_tok
                    v = min(max(cap[p] - (incl[p] - q[p]), 0), q[p])
                    served[p] = v
                    queued[jj] = q[p] - v
                    forwards += v
                    if succ[jj] == -1 or (succ[jj] < 0 and not mesh):
                        delivered[jj] += v
                        if target[jj] > 0 and done_tick[jj] < 0 \
                                and delivered[jj] >= target[jj]:
                            done_tick[jj] = t
                            any_new = True
                    elif mesh and succ[jj] >= f_all:
                        xbuf[send_half + succ[jj] - f_all] = v
                    elif succ[jj] >= 0:
                        ring[row_t, succ[jj]] = v
                nheads = act & (noff[np.minimum(j, len(word) - 1)] == 0)
                spent, carry_s = _block_seg_scan(served, nheads, carry_s,
                                                 threads, fpt)
                for p in np.flatnonzero(act & tail[np.minimum(
                        j, len(word) - 1)]):
                    n = node[j[p]]
                    tokens[n] = tok[p] - spent[p] * size
                    node_sent[n] += spent[p] * size
                carry_cap, carry_tok = cap[-1], tok[-1]
        span_done = span_done or any_new
        prev_row = row_t
        t += 1
        if t == bounds[min(idx, len(bounds) - 1)]:
            idx += 1
            if span_done:
                break
            span_done = False
    out = (t, queued, ring, tokens, delivered, target, done_tick, node_sent,
           forwards)
    if not mesh:
        return out
    if t > int(t0):
        # the last tick's receives; the flowless nodes' refills, one a tick
        rx = np.flatnonzero(np.asarray(xin) >= 0)
        got = xbuf[((t - 1) & 1) * xbuf_len + np.asarray(xin)[rx]]
        ring[prev_row, rx] = got
        cross += int(got.sum())
        for n in np.flatnonzero(np.diff(node_off) == 0):
            for _ in range(t - int(t0)):
                tokens[n] = min(capacity[n], tokens[n] + refill[n])
    return out + (cross,)
