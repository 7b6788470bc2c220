"""csrc/torcells_run.cu's schedule restated in numpy, on the CPU, held to the
JAX package's ``torcells_run`` and the port's plain version.

The kernel runs the cell model to completion in one persistent launch over
the blocks of ``torcells_run_plan``: each block owns a contiguous run of
whole nodes for the whole run and keeps its flows' table words, queued and
delivered, and its nodes' tokens, cap_cells, refill and capacity resident
(shared memory; device memory in the global form). Per tick a block walks
its run in chunks of ``threads`` flows, a thread a flow: the arrivals from
the ring, a node's refill at its first flow (into the node's tokens and
cap_cells, read by its other flows after the first scan's barrier), the
block-wide segmented scan of q (each warp scanning the warps' totals
itself), served and the sends, the segmented scan of served whose value at
a node's last flow is its spent; on the int32 path (no flow starts below
zero and the cells in all fit in int32) served and spent come from the
first scan alone. Only the ring crosses blocks. It is never zeroed (here it
starts as garbage): a flow reads row (t - arr_lat) mod L only when arr_lat
> 0 and t >= arr_lat, which this restatement checks was written in this run
and is not the row the tick writes. Where every arrival latency lies in [2,
L - 2] and a block's run is one chunk, two ticks run between two barriers;
a row read was then written before the window's barrier, and when the first
tick's deliveries end the run the second tick's are taken back. Each warp
adds its delivered cells into its tick's word of one of three rotating
pairs, block 0 resets the next window's pair during this one, and every
thread adds the words to its own total after the barrier. Blocks run in a
new random order every window, each through all of the window's ticks
before the next, so no result depends on their order.

Held bit for bit (no tolerance: exact integers) at the size rule's plans
and at plans that force one block, several blocks, chunks and the global
form, on small ``DeviceTorCells`` instances, on the long-node table (nodes of
~600 flows, longer than a chunk: the scans' carries), under ``max_ticks``
cuts, and on both paths (a queued0 with flows below zero, or with more
cells than int32 holds, takes the int64 one).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import shadow_tpu.ops.torcells_device as jtd
import shadow_tpu_torch.ops.torcells_device as ttd

CELL = ttd.CELL_WIRE_BYTES


def _seg_incl(x, heads, carry):
    """Inclusive segmented scan of x restarting at heads, from carry."""
    c = np.cumsum(x)
    last = np.maximum.accumulate(np.where(heads, np.arange(len(x)), -1))
    return np.where(last >= 0, c - (c - x)[np.maximum(last, 0)],
                    int(carry) + c)


def _block_scan(vals, heads, carry, threads):
    """csrc/torcells_run.cu seg_scan over a chunk, a thread a flow: the
    warps' inclusive scans, every warp's scan of the warps' totals (the
    running sum after warp w: its scan, or carry plus it where no head came
    before), each thread's prefix, then its flow.  Returns (inclusive sums,
    the running sum after the chunk)."""
    nw = threads // 32
    wa, wf = vals.reshape(nw, 32), heads.reshape(nw, 32)
    lane_incl = np.stack([_seg_incl(wa[w], wf[w], 0) for w in range(nw)])
    lane_flag = np.maximum.accumulate(wf, axis=1)
    w_tot, w_flag = lane_incl[:, -1], lane_flag[:, -1]
    w_scan = _seg_incl(w_tot, w_flag, 0)
    after = np.where(np.maximum.accumulate(w_flag), w_scan, carry + w_scan)
    pre_w = np.r_[np.int64(carry), after[:-1]]
    ev = np.c_[np.zeros(nw, dtype=np.int64), lane_incl[:, :-1]]
    ef = np.c_[np.zeros(nw, dtype=bool), lane_flag[:, :-1]]
    before = np.where(ef, ev, pre_w[:, None] + ev).reshape(-1)
    return np.where(heads, vals, before + vals), int(after[-1])


def run_restated(queued0, meta, refill, capacity, ring_len, max_ticks,
                 plan, seed=0):
    """The kernel's schedule over ``plan`` (a ttd.RunPlan), in numpy.
    Returns (delivered [F], ticks, forwards, whether the int32 path ran)."""
    rng = np.random.default_rng(seed)
    meta = np.asarray(meta, dtype=np.int64)
    f = len(meta)
    node, succ, al, word = (meta[:, i] for i in range(4))
    noff, seg_head, tail = word >> 2, (word & 1) != 0, (word & 2) != 0
    ring = rng.integers(-2 ** 40, 2 ** 40, size=(ring_len, f))
    written = np.full((ring_len, f), -1, dtype=np.int64)   # at which tick
    bl = plan.blocks.astype(np.int64)
    g = len(bl) - 1
    threads = chunk = plan.threads
    assert threads % 32 == 0 and 32 <= threads <= ttd.RUN_MAX_THREADS
    assert plan.per_sync == 1 or plan.chunks == 1
    blocks = []
    for b in range(g):
        (n0, f0), (n1, f1) = bl[b, :2], bl[b + 1, :2]
        assert np.all(node[f0:f1] >= n0) and np.all(node[f0:f1] < n1)
        blocks.append({
            "f0": f0, "nf": f1 - f0, "n0": n0,
            "queued": np.array(queued0[f0:f1], dtype=np.int64),
            "delivered": np.zeros(f1 - f0, dtype=np.int64),
            "tokens": np.array(capacity[n0:n1], dtype=np.int64),
            # shared memory the kernel never initialises
            "cap_cells": rng.integers(-2 ** 40, 2 ** 40, size=n1 - n0),
            "refill": np.asarray(refill[n0:n1]),
            "capacity": np.asarray(capacity[n0:n1])})
        if plan.form != "global":
            assert (f1 - f0) * ttd.RUN_FLOW_BYTES \
                + (n1 - n0) * ttd.RUN_NODE_BYTES <= plan.smem
    assert bl[-1, 1] == f and all(b["nf"] <= plan.chunks * chunk
                                  for b in blocks)
    total = int(sum(int(b["queued"].sum()) for b in blocks))
    # the int32 path: no flow starts below zero, and the cells in all fit
    fast = all(bool((b["queued"] >= 0).all()) for b in blocks) \
        and total < 2 ** 31

    def block_tick(blk, t, since):
        """One tick of a block's run; every ring row it reads was written
        at tick t - arr_lat, before the window's barrier at ``since``.
        Returns (each warp's delivered cells, the flows' served cells,
        the cells served)."""
        f0, nf, n0 = blk["f0"], blk["nf"], blk["n0"]
        row_t = t % ring_len
        dlane = np.zeros(threads, dtype=np.int64)
        served = np.zeros(nf, dtype=np.int64)
        carry_q = carry_s = 0
        for cb in range(0, nf, chunk):
            lj = cb + np.arange(chunk)
            act = lj < nf
            j = f0 + np.minimum(lj, nf - 1)
            nl = node[j] - n0
            first = act & (noff[j] == 0)
            reads = act & (al[j] > 0) & (t >= al[j])
            rows = (row_t - al[j]) % ring_len
            assert np.all(written[rows[reads], j[reads]]
                          == t - al[j][reads])
            assert np.all(t - al[j][reads] < since)
            q = np.where(act, blk["queued"][np.minimum(lj, nf - 1)], 0)
            q = q + np.where(reads, ring[rows, j], 0)
            tok = np.minimum(blk["capacity"][nl],
                             blk["tokens"][nl] + blk["refill"][nl])
            blk["tokens"][nl[first]] = tok[first]
            cap = tok // CELL
            blk["cap_cells"][nl[first]] = \
                np.minimum(cap, total)[first] if fast else cap[first]
            incl, carry_q = _block_scan(q, act & seg_head[j], carry_q,
                                        threads)
            cap = blk["cap_cells"][nl]
            if fast:
                assert np.all((q >= 0) & (incl < 2 ** 31))

                def c(x):
                    return np.maximum(0, np.minimum(cap, x))
                s = np.where(act, c(incl) - c(incl - q), 0)
                ends = act & tail[j]
                blk["tokens"][nl[ends]] -= c(incl)[ends] * CELL
            else:
                s = np.where(act, np.clip(cap - (incl - q), 0, q), 0)
            live = lj[act]
            blk["queued"][live] = (q - s)[act]
            served[live] = s[act]
            last = act & (succ[j] < 0)
            blk["delivered"][lj[last]] += s[last]
            dlane += np.where(last, s, 0)
            send = act & (succ[j] >= 0)
            assert len(set(succ[j][send])) == int(send.sum())
            ring[row_t, succ[j][send]] = s[send]
            written[row_t, succ[j][send]] = t
            if not fast:
                spent, carry_s = _block_scan(s, act & (noff[j] == 0),
                                             carry_s, threads)
                ends = act & tail[j]
                blk["tokens"][nl[ends]] -= spent[ends] * CELL
        return dlane.reshape(threads // 32, 32).sum(1), served, \
            int(served.sum())

    words = np.zeros(6, dtype=np.int64)
    t = dsum = forwards = w = 0
    while dsum < total and t < max_ticks:
        k3 = w % 3
        ticks = 2 if plan.per_sync == 2 and t + 1 < max_ticks else 1
        undo = []
        # blocks run in a new order each window, each through all of the
        # window's ticks before the next starts: as far ahead of the others
        # as a block can get
        for b in rng.permutation(g):
            if b == 0:
                words[2 * ((k3 + 1) % 3):2 * ((k3 + 1) % 3) + 2] = 0
            for k in range(ticks):
                warps, served, fw = block_tick(blocks[b], t + k, t)
                forwards += fw
                words[2 * k3 + k] += int(warps[warps != 0].sum())
                if k == 1:
                    undo.append((blocks[b], served, fw))
        w += 1
        d0, d1 = int(words[2 * k3]), int(words[2 * k3 + 1])
        if ticks == 2 and dsum + d0 >= total:
            # the run ended after the first tick: the second is taken back
            for blk, served, fw in undo:
                last = succ[blk["f0"] + np.arange(blk["nf"])] < 0
                blk["delivered"][last] -= served[last]
                forwards -= fw
            t += 1
            break
        dsum += d0 + (d1 if ticks == 2 else 0)
        t += ticks
    delivered = np.zeros(f, dtype=np.int64)
    for blk in blocks:
        delivered[blk["f0"]:blk["f0"] + blk["nf"]] = blk["delivered"]
    return delivered, t, forwards, fast


def _instance(kw):
    return jtd.DeviceTorCells(**kw)


def _tables(ref):
    """(meta, node_off, window) of the instance's flow table, as
    RunTables makes them."""
    fl = ref.flows
    t = ttd.RunTables(*(torch.as_tensor(fl[k]) for k in (
        "flow_node", "flow_lat", "flow_succ", "seg_start")),
        len(ref.refill), ref.ring_len)
    return t.meta.numpy(), t.node_off_host, t.window


def _queued0(ref, cells, edit):
    """The bench's queued0 (``cells`` on every first stage), then ``edit``:
    "neg" puts a few flows below zero, "big" one flow past 2^31 cells."""
    fl = ref.flows
    q0 = np.where(fl["flow_stage"] == 0, cells, 0).astype(np.int64)
    if edit == "neg":
        q0[5::97] = -1
    elif edit == "big":
        q0[np.flatnonzero(fl["flow_stage"] == 0)[3]] = 2 ** 31 + 5
    return q0


def _jax_run(ref, q0, max_ticks):
    fl = ref.flows
    d, t, fw = jtd.torcells_run(
        jnp.asarray(q0), jnp.asarray(fl["flow_node"]),
        jnp.asarray(fl["flow_lat"]), jnp.asarray(fl["flow_succ"]),
        jnp.asarray(fl["seg_start"]), jnp.asarray(ref.refill),
        jnp.asarray(ref.capacity), ref.ring_len, jnp.int64(max_ticks))
    return np.asarray(d), int(t), int(fw)


SMALL = dict(n_relays=20, n_circuits=60, seed=3, relay_bw_kibps=512)
LONG = dict(n_relays=4, n_circuits=800, seed=41)

# (instance, cells, the edit of queued0, max_ticks, the plan: None for the
# size rule on a card of 6 SMs, else _plan_over's blocks and options; the
# form expected); a max_ticks below the run's length cuts it; 41 cells end
# the small instance's run after 795 ticks, the first of a two-tick window,
# so the window's second tick is taken back
CASES = {
    "one-block": (SMALL, 40, None, 40_000, dict(g=1), "grid"),
    "two-blocks": (SMALL, 40, None, 40_000, None, "grid"),
    "eight-blocks": (SMALL, 41, None, 40_000, dict(g=8), "grid"),
    "six-blocks": (SMALL, 41, None, 40_000, dict(g=6), "grid"),
    "global": (SMALL, 40, None, 40_000,
               dict(g=6, smem_max=1024, max_threads=32), "global"),
    "cut-two-blocks": (SMALL, 40, None, 150, None, "grid"),
    "cut-six-blocks": (SMALL, 40, None, 150, dict(g=6), "grid"),
    "cut-odd": (SMALL, 40, None, 151, dict(g=6), "grid"),
    "one-tick-a-sync": (SMALL, 40, None, 40_000, dict(g=6, window=1),
                        "grid"),
    "int64-negative": (SMALL, 40, "neg", 150, None, "grid"),
    "int64-large": (SMALL, 40, "big", 150, dict(g=6), "grid"),
    "long-node-chunks-of-64": (LONG, 2, None, 120,
                               dict(g=8, max_threads=64), "grid"),
    "long-node-chunks-of-128": (LONG, 2, None, 120,
                                dict(g=6, max_threads=128), "grid"),
    "long-node-global": (LONG, 2, None, 120,
                         dict(g=6, smem_max=4096, max_threads=128),
                         "global"),
    "long-node-int64": (LONG, 2, "neg", 120, dict(g=8, max_threads=64),
                        "grid"),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_restated_schedule_equals_jax_and_the_plain_version(name):
    kw, cells, edit, max_ticks, opts, form = CASES[name]
    ref = _instance(kw)
    meta, node_off, window = _tables(ref)
    assert window == 2
    if opts is None:
        plan = ttd.torcells_run_plan(node_off, 6, window)
    else:
        opts = dict({"window": window}, **opts)
        plan = ttd._plan_over(node_off, **opts)
        window = opts["window"]
        assert len(plan.blocks) - 1 == opts["g"]
    assert plan.form == form
    assert plan.per_sync == (window if plan.chunks == 1 else 1)
    q0 = _queued0(ref, cells, edit)
    jd, jt, jf = _jax_run(ref, q0, max_ticks)
    d, t, fw, fast = run_restated(q0, meta, ref.refill, ref.capacity,
                                  ref.ring_len, max_ticks, plan,
                                  seed=len(name))
    np.testing.assert_array_equal(d, jd)
    assert (t, fw) == (jt, jf) and t > 0
    assert fast == (edit is None)
    if cells == 41:
        assert t % 2 == 1 and plan.per_sync == 2
    if edit is None:
        assert t == max_ticks if max_ticks < 1000 else t < max_ticks
    fl = ref.flows
    pd, pt, pf = ttd.torcells_run_torch(
        *(torch.as_tensor(a) for a in (q0, fl["flow_node"], fl["flow_lat"],
                                       fl["flow_succ"], fl["seg_start"],
                                       ref.refill, ref.capacity)),
        ref.ring_len, max_ticks)
    np.testing.assert_array_equal(pd.numpy(), d)
    assert (int(pt), int(pf)) == (t, fw)


def test_plan_forms_and_blocks_follow_the_size_rule():
    tc = ttd.DeviceTorCells(200, 2000, seed=23, relay_bw_kibps=4096,
                            device="cpu")
    plan, blocks = tc.tables.plan(132)
    # the bench shape: 63 blocks of ~160 flows in the grid form, each run
    # one chunk of a thread a flow
    g = -(-tc.n_flows // ttd.RUN_BLOCK_FLOWS)
    assert plan.form == "grid" and len(plan.blocks) == g + 1
    assert plan.chunks == 1 and plan.threads % 32 == 0
    assert plan.per_sync == tc.tables.window == 2
    assert blocks.dtype == torch.int32 and blocks.shape == (g + 1, 4)
    assert plan.smem <= ttd.RUN_SMEM_MAX
    node_off = tc.tables.node_off_host
    assert plan.blocks[-1, 0] == len(tc.refill)
    assert plan.blocks[-1, 1] == tc.n_flows
    # every block starts at a node's first flow: whole nodes
    np.testing.assert_array_equal(node_off[plan.blocks[:, 0]],
                                  plan.blocks[:, 1])
    # a small table: a grid of a few blocks
    small = ttd.DeviceTorCells(20, 60, seed=3, relay_bw_kibps=512,
                               device="cpu").tables.plan(132)[0]
    assert small.form == "grid" and len(small.blocks) - 1 == 2
    # past the card's SMs: one block an SM
    big = ttd.torcells_run_plan(node_off, 16, 2)
    assert big.form == "grid" and len(big.blocks) - 1 == 16
    # a run longer than a block's threads is walked in chunks, one tick a
    # barrier
    chunked = ttd._plan_over(node_off, 16, 2, max_threads=256)
    assert chunked.chunks == -(-int(np.diff(chunked.blocks[:, 1]).max())
                               // 256) > 1
    assert chunked.per_sync == 1
    # a run too large for a block's shared memory: the global form
    huge = ttd._plan_over(node_off, 132, smem_max=1024)
    assert huge.form == "global" and huge.smem == 0
    assert huge.threads == ttd.RUN_MAX_THREADS
    assert tc.tables.plan(132)[0] is plan      # made once
