"""The device traffic plane's step in the port, on the CPU, against the JAX
package.

The port's dispatch ``torcells_step_window_flush`` (on CPU tensors: its
plain torch versions) must equal, bit for bit on all ten outputs, the JAX
package's ``torcells_step_window_flush_nodonate`` (or ``_capped`` with
caps) and its numpy twin ``torcells_step_window_numpy_flush``, on a small
``build_flows`` instance with inputs made by numpy from a seed.  The packed
flush alone (``pack_flush_torch``) is held to ``_pack_flush_jnp`` and
``pack_flush_np``.  The span kernels' algorithm (tiles of whole nodes, a
thread per flow, segmented scans with a carry across chunks), re-stated in
numpy by ``test_torch_torcells_cases.tile_kernel_span``, is held to the
plain version and the JAX function on single-flow nodes, a node longer
than a tile and a chunk, nodes with no flows, and tor10k-like and
sweep-like skew.  Tolerance: none (int64, exact).
"""

import functools
import os
import re

import numpy as np
import pytest
import torch

import shadow_tpu.ops.torcells_device as jtd
import shadow_tpu_torch.ops.torcells_device as ttd
from test_torch_torcells_cases import (injection, random_state,
                                       skewed_instance, tile_kernel_span,
                                       toy_instance, zero_state)

NAMES = ("t_stop", "queued", "ring", "tokens", "delivered", "target",
         "done_tick", "node_sent", "forwards", "flush")


@pytest.fixture(scope="module")
def inst():
    """20 circuits x 5 stages over 6 contended relays (the JAX package's
    toy instance, laid out as the plane lays a flow table out)."""
    out = toy_instance()
    ref = jtd.DeviceTorCells(n_relays=6, n_circuits=20, seed=5,
                             relay_bw_kibps=512, max_latency_ms=20)
    for a, key in zip(out["tables"][:4], ("flow_node", "flow_lat",
                                          "flow_succ", "seg_start")):
        np.testing.assert_array_equal(a, ref.flows[key])
    return out


def step_all(inst, state, inj, inj_t, targets, idle=0, caps=None):
    """One dispatch through the JAX kernel, the numpy twin (uncapped) and
    the port; asserts all equal and returns the numpy 10-tuple."""
    targets = np.asarray(targets, dtype=np.int64)
    tables, lr = inst["tables"], inst["ring_len"]
    copy = lambda st: tuple(np.array(a) for a in st)  # noqa: E731
    if caps is None:
        jout = jtd.torcells_step_window_flush_nodonate(
            *copy(state), inj, inj_t, targets, np.int64(idle), *tables,
            ring_len=lr)
    else:
        jout = jtd.torcells_step_window_flush_capped(
            *copy(state), inj, inj_t, targets, np.int64(idle), *tables,
            ring_len=lr, cap_chains=caps[0], cap_nodes=caps[1])
    jout = [np.asarray(o) for o in jout]
    tstate, ttables = ttd.from_jax_state(copy(state), tables, "cpu")
    tout = ttd.torcells_step_window_flush(
        *tstate, torch.from_numpy(inj), torch.from_numpy(inj_t), targets,
        idle, *ttables, ring_len=lr,
        cap_chains=None if caps is None else caps[0],
        cap_nodes=None if caps is None else caps[1])
    tout = [o.numpy() for o in tout]
    assert tout[2].dtype == np.int32
    for name, a, b in zip(NAMES, tout, jout):
        np.testing.assert_array_equal(a, b, err_msg=f"port vs JAX: {name}")
    if caps is None:
        nout = jtd.torcells_step_window_numpy_flush(
            *copy(state), inj, inj_t, targets, idle, *tables, lr)
        for name, a, b in zip(NAMES, tout, nout):
            np.testing.assert_array_equal(
                a, np.asarray(b), err_msg=f"port vs numpy twin: {name}")
    return jout


def test_k1_no_completion(inst):
    """One target, fresh injection on every chain: cells move but no
    chain can finish inside five ticks."""
    inj, inj_t = injection(inst, np.arange(inst["c"]), 40)
    out = step_all(inst, zero_state(inst), inj, inj_t, [5])
    assert int(out[0]) == 5 and out[9][2] == 0 and int(out[8]) > 0


def test_k8_clean_span_rolls_to_the_end(inst):
    """Eight one-tick boundaries with no completion: no halt."""
    inj, inj_t = injection(inst, np.arange(inst["c"]), 40)
    out = step_all(inst, zero_state(inst), inj, inj_t, np.arange(1, 9))
    assert int(out[0]) == 8 and out[9][2] == 0


@pytest.mark.parametrize("k", [1, 8])
def test_run_to_completion_in_dispatches(inst, k):
    """Dispatch after dispatch from a fresh injection until every chain
    is done: the K = 8 windows halt at the boundary after each completion,
    K = 1 windows roll; every step equal in all three."""
    inj, inj_t = injection(inst, np.arange(inst["c"]), 25)
    zero = np.zeros(inst["f"], np.int64)
    state = zero_state(inst)
    halts, done = 0, 0
    for _ in range(200):
        t0 = int(state[0])
        targets = t0 + 3 * np.arange(1, k + 1)
        out = step_all(inst, state, inj, inj_t, targets)
        inj = inj_t = zero
        halts += int(out[0]) < int(targets[-1])
        done += int(out[9][2])
        state = tuple(out[:8])
        if done == inst["c"]:
            break
    assert done == inst["c"]
    if k == 8:
        assert halts > 0


@pytest.mark.parametrize("seed", range(4))
def test_random_busy_state_k8(inst, seed):
    """A busy random state, eight boundaries: completions in the first
    sub-window halt the span there."""
    out = step_all(inst, random_state(inst, seed), *injection(
        inst, np.array([], dtype=np.int64), 0), 500 + 2 * np.arange(1, 9))
    assert out[9][2] > 0 and int(out[0]) < 516


def test_halt_at_completion_boundary(inst):
    """A chain finishes in the third sub-window: the span stops at that
    sub-window's end, not earlier, not later."""
    st = list(random_state(inst, 11))
    last = inst["tables"][2] < 0
    st[5] = np.where(last, st[4] + 10 ** 9, 0)   # nothing near done
    st[6] = np.full(inst["f"], -1, np.int64)
    st = tuple(st)
    targets = 500 + 2 * np.arange(1, 9)
    probe = step_all(inst, st, *injection(
        inst, np.array([], dtype=np.int64), 0), [516])
    # make exactly one chain finish at its delivered count after tick 504
    j = int(np.flatnonzero(last & (probe[4] > st[4]))[0])
    st[5][j] = st[4][j] + 1
    one = step_all(inst, st, *injection(
        inst, np.array([], dtype=np.int64), 0), targets)
    tick = int(one[6][j])
    assert tick >= 500
    assert int(one[0]) == targets[np.searchsorted(targets, tick + 1)]


def test_idle_fold_clears_the_ring(inst):
    """Banked idle ticks refill the buckets (capped) and clear the ring
    before the span runs."""
    st = random_state(inst, 3)
    out = step_all(inst, st, *injection(inst, np.array([], np.int64), 0),
                   [503], idle=7)
    assert int(out[0]) == 503


def test_injection_exactly_on_a_boundary(inst):
    """The second dispatch starts at the boundary the first stopped at and
    injects there: same state in all three, and the injected cells count
    in the target."""
    inj, inj_t = injection(inst, np.arange(0, inst["c"], 2), 30)
    out = step_all(inst, zero_state(inst), inj, inj_t, [6, 12])
    assert int(out[0]) == 12
    inj2, inj2_t = injection(inst, np.arange(1, inst["c"], 2), 17)
    out2 = step_all(inst, tuple(out[:8]), inj2, inj2_t,
                    12 + 4 * np.arange(1, 9))
    np.testing.assert_array_equal(out2[5], out[5] + inj2_t)


@pytest.mark.parametrize("overflow", [False, True])
def test_capped_flush(inst, overflow):
    """The capped flush: true counts in the header, entries past a cap
    dropped; flush_overflowed tells the two apart."""
    st = random_state(inst, 5)
    none = injection(inst, np.array([], np.int64), 0)
    full = step_all(inst, st, *none, 500 + 2 * np.arange(1, 9))
    n_done, n_touch = int(full[9][2]), int(full[9][3])
    assert n_done >= 2 and n_touch >= 2
    caps = ((n_done // 2, n_touch // 2) if overflow
            else (n_done + 1, n_touch + 2))
    out = step_all(inst, st, *none, 500 + 2 * np.arange(1, 9), caps=caps)
    assert jtd.flush_overflowed(out[9], *caps) is overflow
    assert len(out[9]) == ttd.flush_len(inst["c"], inst["h"], *caps)
    if not overflow:
        got = ttd.parse_flush(out[9], inst["c"], inst["h"], *caps)
        want = ttd.parse_flush(full[9], inst["c"], inst["h"])
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def _pack_inputs(kind, c=37, h=53, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "empty":
        return np.zeros(c, bool), np.full(c, -1, np.int64), \
            np.zeros(h, np.int64)
    if kind == "full":
        return np.ones(c, bool), rng.integers(0, 999, size=c), \
            rng.integers(1, 1 << 40, size=h)
    newly = rng.random(c) < 0.4
    return newly, np.where(newly, rng.integers(0, 999, size=c), -1), \
        np.where(rng.random(h) < 0.5, rng.integers(-50, 1 << 30, size=h), 0)


@pytest.mark.parametrize("kind", ["empty", "full", "random"])
@pytest.mark.parametrize("caps", [None, (5, 7), (100, 100), (0, 0)])
def test_pack_flush_matches_jax_and_numpy(kind, caps):
    import jax.numpy as jnp
    newly, done, delta = _pack_inputs(kind)
    kw = {} if caps is None else {"cap_chains": caps[0],
                                  "cap_nodes": caps[1]}
    want = np.asarray(jtd._pack_flush_jnp(
        jnp.int64(11), jnp.int64(22), jnp.int64(33), jnp.asarray(newly),
        jnp.asarray(done), jnp.asarray(delta), **kw))
    got = ttd.pack_flush(11, 22, 33, torch.from_numpy(newly),
                         torch.from_numpy(done), torch.from_numpy(delta),
                         **kw).numpy()
    np.testing.assert_array_equal(got, want)
    if caps is None:
        np.testing.assert_array_equal(
            got, ttd.pack_flush_np(11, 22, 33, newly, done, delta))


def test_from_jax_state_types(inst):
    st, tables = ttd.from_jax_state(zero_state(inst, 7), inst["tables"],
                                    "cpu")
    assert st[0] == 7 and isinstance(st[0], int)
    assert st[2].dtype == torch.int32 and st[1].dtype == torch.int64
    assert all(t.dtype == torch.int64 for t in tables)


def test_span_tables_refuse_what_the_kernel_cannot_walk(inst):
    """The span kernel scans each node's flows as one segment, reads
    arrivals from a ring row other than the one a tick writes, and indexes
    with 32-bit offsets: a table that breaks any is refused before any
    launch.  The tile table covers the flows in whole nodes."""
    fn, fl, fs, ss = (torch.from_numpy(a) for a in inst["tables"][:4])
    f, h, lr = inst["f"], inst["h"], inst["ring_len"]
    tab = ttd.SpanTables(fn, fl, fs, ss, h, lr)
    assert int(tab.node_off[-1]) == f
    np.testing.assert_array_equal(
        tab.arr_lat.numpy()[fs.numpy()[fs.numpy() >= 0]],
        fl.numpy()[fs.numpy() >= 0])
    meta, tiles, off = tab.meta.numpy(), tab.tiles.numpy(), \
        tab.node_off.numpy()
    assert meta.dtype == np.int32 and meta.shape == (f, 4)
    np.testing.assert_array_equal(meta[:, 0], fn.numpy())
    np.testing.assert_array_equal(meta[:, 1], fs.numpy())
    np.testing.assert_array_equal(meta[:, 2], tab.arr_lat.numpy())
    j = np.arange(f)
    np.testing.assert_array_equal(meta[:, 3] >> 2, j - off[fn.numpy()])
    np.testing.assert_array_equal((meta[:, 3] & ttd.SEG_HEAD) != 0,
                                  ss.numpy() == j)
    np.testing.assert_array_equal((meta[:, 3] & ttd.NODE_TAIL) != 0,
                                  j == off[fn.numpy() + 1] - 1)
    for tile_flows in (ttd.TILE_FLOWS, 7, 1):
        tiles = ttd.span_tile_tables(fn.numpy(), tab.arr_lat.numpy(),
                                     fs.numpy(), ss.numpy(), h, lr,
                                     tile_flows)[2]
        assert len(tiles) - 1 == max(1, -(-f // tile_flows))
        assert tuple(tiles[0, :2]) == (0, 0) and tuple(tiles[-1]) == (h, f,
                                                                      0, 0)
        assert (np.diff(tiles[:, 0]) >= 0).all()
        np.testing.assert_array_equal(tiles[:, 1], off[tiles[:, 0]])
    with pytest.raises(ValueError, match="sorted"):
        ttd.SpanTables(fn.flip(0), fl, fs, ss, h, lr)
    bad = ss.clone()
    bad[1] = 1 if int(ss[1]) == 0 else 0
    with pytest.raises(ValueError, match="segment"):
        ttd.SpanTables(fn, fl, fs, bad, h, lr)
    with pytest.raises(ValueError, match="arrival latency"):
        ttd.SpanTables(fn, fl, fs, ss, h, int(fl.max()))
    with pytest.raises(ValueError, match="32-bit offsets"):
        ttd.SpanTables(fn, fl, fs, ss, h, 2 ** 31 // f + 1)


@functools.lru_cache(maxsize=None)
def _tile_instance(case):
    """Small tables with the shapes the tile design must get right."""
    if case == "single-flow nodes":
        inst = dict(toy_instance())
        f = inst["f"]
        rng = np.random.default_rng(3)
        bw = rng.integers(256, 4096, size=f)
        refill, cap = ttd.bucket_params(bw)
        fn, lat, succ, _ss, _r, _c, last = inst["tables"]
        inst["tables"] = (np.arange(f, dtype=np.int64), lat, succ,
                          np.arange(f, dtype=np.int64),
                          refill.astype(np.int64), cap.astype(np.int64),
                          last)
        inst["h"] = f
        return inst
    return {"long node": lambda: skewed_instance(60, 6, 2.5),
            "empty nodes": lambda: skewed_instance(40, 8, 1.0,
                                                   empty_every=3),
            "tor10k-like skew": lambda: skewed_instance(150, 80, 0.6),
            "sweep-like skew": lambda: skewed_instance(150, 30, 1.3)}[case]()


TILE_CASES = ("single-flow nodes", "long node", "empty nodes",
              "tor10k-like skew", "sweep-like skew")
# (threads, flows a thread, tile flows): small chunks and tiles, so nodes
# run across chunk and tile boundaries, and the kernel's own
TILE_GEOMETRY = ((4, 2, 4), (16, 2, 24), (256, 2, ttd.TILE_FLOWS))


@pytest.mark.parametrize("geometry", TILE_GEOMETRY,
                         ids=lambda g: "x".join(map(str, g)))
@pytest.mark.parametrize("case", TILE_CASES)
def test_tile_restatement_matches_plain_and_jax(case, geometry):
    """The span kernels' tiled algorithm, re-stated in numpy, equals the
    plain version and the JAX package's span step bit for bit (all nine
    span outputs) on a busy state with an injection and eight boundaries
    (an idle fold on the empty-nodes table)."""
    inst = _tile_instance(case)
    threads, fpt, tile_flows = geometry
    fn, fl, fs, ss, refill, cap, _last = inst["tables"]
    f, h, lr = inst["f"], inst["h"], inst["ring_len"]
    tab = ttd.SpanTables(*(torch.from_numpy(a) for a in (fn, fl, fs, ss)),
                         h, lr)
    node_off, meta, tiles = ttd.span_tile_tables(
        fn, tab.arr_lat.numpy(), fs, ss, h, lr, tile_flows)
    lengths = np.diff(node_off)
    if case == "long node":
        assert lengths.max() > max(tile_flows, threads * fpt) or \
            threads * fpt > f
    if case == "empty nodes":
        assert (lengths == 0).sum() > 0 and tiles[:, 2].any()
    if case == "single-flow nodes":
        assert (lengths == 1).all()
    st = random_state(inst, 17)
    inj, inj_t = injection(inst, np.arange(0, inst["c"], 3), 30)
    targets = 500 + 3 * np.arange(1, 9)
    idle = 2 if case == "empty nodes" else 0
    got = tile_kernel_span(st, inj, inj_t, targets, idle, refill, cap,
                           node_off, meta, tiles, lr, threads, fpt)
    copy = lambda: tuple(np.array(a) for a in st)  # noqa: E731
    tstate, ttables = ttd.from_jax_state(copy(), inst["tables"], "cpu")
    plain = ttd.torcells_step_span_torch(
        *tstate, torch.from_numpy(inj), torch.from_numpy(inj_t), targets,
        idle, *ttables[:6], ring_len=lr)
    jout = jtd.torcells_step_window_flush_nodonate(
        *copy(), inj, inj_t, targets, np.int64(idle), *inst["tables"],
        ring_len=lr)
    for i, name in enumerate(NAMES[:9]):
        np.testing.assert_array_equal(np.asarray(got[i]),
                                      np.asarray(plain[i]), err_msg=name)
        np.testing.assert_array_equal(np.asarray(got[i]),
                                      np.asarray(jout[i]), err_msg=name)
    assert got[8] > 0 and got[0] > 500


@pytest.mark.parametrize("geometry", TILE_GEOMETRY,
                         ids=lambda g: "x".join(map(str, g)))
def test_tile_restatement_with_a_queue_below_zero(inst, geometry):
    """A flow whose queue is below zero behind more cells than its node's
    cap: served is min(max(cap - before, 0), q) = q, as JAX clips (the
    other order, max(min(., q), 0), would serve 0 and leave the queue
    below zero); the restatement, the plain version and JAX agree over one
    tick and over eight boundaries."""
    threads, fpt, tile_flows = geometry
    fn, fl, fs, ss, refill, cap, _last = inst["tables"]
    f, h, lr = inst["f"], inst["h"], inst["ring_len"]
    tab = ttd.SpanTables(*(torch.from_numpy(a) for a in (fn, fl, fs, ss)),
                         h, lr)
    node_off, meta, tiles = ttd.span_tile_tables(
        fn, tab.arr_lat.numpy(), fs, ss, h, lr, tile_flows)
    node = int(np.argmax(np.diff(node_off)))
    a, b = node_off[node], node_off[node] + 1
    assert ss[b] == ss[a]                   # one segment: a is ahead of b
    st = list(random_state(inst, 5))
    st[1] = st[1].copy()
    st[1][a], st[1][b] = 10 ** 6, -100      # no ring cell lifts b to 0
    st = tuple(st)
    inj, inj_t = injection(inst, np.array([], dtype=np.int64), 0)
    for targets in ([501], 500 + 3 * np.arange(1, 9)):
        targets = np.asarray(targets, dtype=np.int64)
        got = tile_kernel_span(st, inj, inj_t, targets, 0, refill, cap,
                               node_off, meta, tiles, lr, threads, fpt)
        jout = step_all(inst, st, inj, inj_t, targets)
        for i, name in enumerate(NAMES[:9]):
            np.testing.assert_array_equal(np.asarray(got[i]),
                                          np.asarray(jout[i]), err_msg=name)
        if len(targets) == 1:
            assert int(got[1][b]) == 0      # served the whole -q
    assert int(got[1][a]) > 0


def test_kernel_cell_size_matches_the_model():
    """The span kernels' tick body (csrc/span_tile.cuh) compiles in the
    wire size of a cell, its chunk and its meta flags; they must be the
    model's CELL_WIRE_BYTES and the wrapper's CHUNK_FLOWS, SEG_HEAD and
    NODE_TAIL."""
    path = os.path.join(os.path.dirname(ttd.__file__), "csrc",
                        "span_tile.cuh")
    with open(path, encoding="utf-8") as f:
        src = f.read()
    m = re.search(r"CELL_WIRE_BYTES = (\d+) \+ (\d+);", src)
    assert m and int(m.group(1)) + int(m.group(2)) == ttd.CELL_WIRE_BYTES
    const = {k: int(v) for k, v in re.findall(
        r"constexpr int (\w+) = (\d+);", src)}
    assert const["THREADS"] * const["FPT"] == ttd.CHUNK_FLOWS
    assert (const["SEG_HEAD"], const["NODE_TAIL"]) == (ttd.SEG_HEAD,
                                                        ttd.NODE_TAIL)


def test_cuda_dispatch_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        ttd.torcells_span(0, *(torch.zeros(1, dtype=torch.int64),) * 18,
                          ring_len=2)
