"""csrc/pack_flush.cu's tiled compaction restated in numpy, held to the
plain versions and to the JAX package on the CPU.

The kernel cuts each flush's C chain lanes and H node lanes into tiles
(256 threads x 4 contiguous lanes), takes the W flushes' tiles
grid-strided in one cooperative launch, writes each tile's count and
partial sum to a per-tile array, syncs the grid once, forms each tile's
base from the earlier tiles' counts in a fixed order, scatters the
selected lanes at base + rank below the cap, writes the zeros of its own
positions past the true count, and lets thread 0 of a flush's tile 0 write
the header.  :func:`tiled_pack` does the same, step for step, into a buffer
that starts as garbage (the wrapper's ``torch.empty``), and counts the
writes to every position: each is written exactly once.

It runs at the kernel's tile and at tiles of 4 and 32 lanes (so that small
C and H span many tiles; JAX at the kernel's tile only, as it compiles
each new shape), with a grid of a block a tile and a grid of 3
blocks (the path where a block reads a later tile again after the sync),
for the three entries (serial with caps, batched, mesh with nodes on no
shard, with and without caps), on pack_cases-style inputs (all empty, all full, random, capped
with overflow, capped to fit, a cap inside a later tile) at C and H on the
tile boundaries (1, tile - 1, tile, tile + 1, 7 tiles + 3).  Each result
equals ``pack_flush_np``, ``pack_flush_torch``, ``pack_flush_batched_torch``,
the mesh flush's plain form (``global_sent_torch`` + ``pack_flush_torch`` +
the cross slot) and the JAX package's ``_pack_flush_jnp``.
"""

import numpy as np
import pytest
import torch

from shadow_tpu.ops.torcells_device import _pack_flush_jnp
from shadow_tpu_torch.ops import torcells_device as td
from shadow_tpu_torch.parallel.mesh import exchange as ex

HEADER = td.FLUSH_HEADER
LANES = 4                      # csrc/pack_flush.cu LANES
GARBAGE = -0x5A5A5A5A5A5A5A5A  # what torch.empty may hold
TILES = (td.FLUSH_TILE, 32, 4)


def _trunc_div(a: int, b: int) -> int:
    """C's integer division (toward zero), as the kernel divides."""
    q = abs(a) // b
    return q if a >= 0 else -q


def tiled_pack(chain, node, header, w: int, c: int, h: int, cc: int,
               hh: int, row: int, tile: int, grid=None):
    """The kernel's compaction.  ``chain(w, lanes)`` and ``node(w,
    lanes)`` give a tile's (selected bool, value int64, partial sum);
    ``header(w, out, n_done, n_touched, chain_sum, node_sum)`` writes a
    flush's header.  Returns (buf [W, row], per-tile counts)."""
    threads = tile // LANES
    tc, th = -(-c // tile), -(-h // tile)
    nt = max(tc + th, 1)
    n_tiles = w * nt
    grid = n_tiles if grid is None else min(grid, n_tiles)
    buf = np.full((w, row), GARBAGE, dtype=np.int64)
    writes = np.zeros((w, row), dtype=np.int64)
    counts = np.full(n_tiles, GARBAGE, dtype=np.int64)
    sums = np.full(n_tiles, GARBAGE, dtype=np.int64)

    def where(ti):
        lane, k = divmod(ti, nt)
        chains = k < tc
        lo = (k if chains else k - tc) * tile
        n = c if chains else h
        return lane, k, chains, np.arange(lo, min(lo + tile, n))

    def scan(ti):
        """A tile's lanes, each lane's rank: the threads' counts scanned
        over the block, then the lane's place among its thread's four."""
        lane, k, chains, lanes = where(ti)
        sel, val, part = (chain if chains else node)(lane, lanes)
        pad = threads * LANES - len(lanes)
        s = np.concatenate([sel, np.zeros(pad, bool)]).reshape(threads,
                                                                LANES)
        per_thread = s.sum(axis=1)
        thread_rank = np.cumsum(per_thread) - per_thread
        rank = (thread_rank[:, None] + np.cumsum(s, axis=1) - s).reshape(-1)
        return sel, val, rank[:len(lanes)], int(sel.sum()), int(part)

    def write(lane, pos, v):
        buf[lane, pos] = v
        writes[lane, pos] += 1

    # 1. every tile's count and partial sum; a block keeps its first tile
    kept = {}
    for b in range(grid):
        for ti in range(b, n_tiles, grid):
            sel, val, rank, n, part = scan(ti)
            counts[ti], sums[ti] = n, part
            if ti == b:
                kept[b] = (sel, val, rank)
    # 2. the grid sync; 3. the scatter, the zero tail, the header
    for b in range(grid):
        for ti in range(b, n_tiles, grid):
            lane, k, chains, lanes = where(ti)
            sel, val, rank = kept[b] if ti == b else scan(ti)[:3]
            own = counts[lane * nt:lane * nt + tc + th]
            part = sums[lane * nt:lane * nt + tc + th]
            if chains:
                base, total, cap, sec = int(own[:k].sum()), \
                    int(own[:tc].sum()), cc, HEADER
            else:
                base, total, cap, sec = int(own[tc:k].sum()), \
                    int(own[tc:].sum()), hh, HEADER + 2 * cc
            pos = base + rank[sel]
            ok = pos < cap
            write(lane, sec + pos[ok], lanes[sel][ok])
            write(lane, sec + cap + pos[ok], val[sel][ok])
            tail = lanes[(lanes >= total) & (lanes < cap)]
            write(lane, sec + tail, 0)
            write(lane, sec + cap + tail, 0)
            if k == 0:
                header(lane, buf[lane], int(own[:tc].sum()),
                       int(own[tc:].sum()), int(part[:tc].sum()),
                       int(part[tc:].sum()))
                writes[lane, :HEADER] += 1
                if row > HEADER + 2 * cc + 2 * hh:      # the mesh's slot
                    writes[lane, row - 1] += 1
    assert (writes == 1).all(), "a position written other than once"
    return buf, counts


def _sizes(tile: int):
    s = (1, tile - 1, tile, tile + 1, 7 * tile + 3)
    return list(zip(s, reversed(s)))


def _cases(c: int, h: int, tile: int, seed: int):
    """pack_cases of chip_smoke.py: (name, newly, done_last, delta,
    caps)."""
    rng = np.random.default_rng(seed)
    yield ("all empty", np.zeros(c, bool), np.full(c, -1),
           np.zeros(h, np.int64), None)
    yield ("all full", np.ones(c, bool), rng.integers(0, 9999, size=c),
           rng.integers(1, 1 << 40, size=h), None)
    newly = rng.random(c) < 0.3
    delta = np.where(rng.random(h) < 0.6, rng.integers(1, 1 << 30, size=h),
                     0)
    done = np.where(newly, rng.integers(0, 9999, size=c), -1)
    yield "random", newly, done, delta, None
    nc, nh = int(newly.sum()), int((delta != 0).sum())
    yield "capped (overflow)", newly, done, delta, (nc // 2, nh // 2)
    yield "capped (fits)", newly, done, delta, (nc + 1, nh + 1)
    yield ("capped inside a later tile", newly, done, delta,
           (tile + tile // 2 + 1, 2 * tile + 3))


def serial_tiled(newly, done, delta, caps, tile, grid=None):
    c, h = len(newly), len(delta)
    cc = c if caps is None else min(caps[0], c)
    hh = h if caps is None else min(caps[1], h)

    def chain(_w, i):
        return newly[i], done[i], 0

    def node(_w, i):
        return delta[i] != 0, delta[i], 0

    def header(_w, out, n_done, n_touched, _cs, _ns):
        out[:HEADER] = (123456789, 987654321, n_done, n_touched, 4242)
    return tiled_pack(chain, node, header, 1, c, h, cc, hh,
                      HEADER + 2 * cc + 2 * hh, tile, grid)[0][0]


@pytest.mark.parametrize("tile", TILES)
def test_serial_tiles_equal_plain_and_jax(tile):
    for grid in (None, 3):
        for c, h in _sizes(tile):
            for name, newly, done, delta, caps in _cases(c, h, tile, c + h):
                got = serial_tiled(newly, done, delta, caps, tile, grid)
                kw = {} if caps is None else dict(cap_chains=caps[0],
                                                  cap_nodes=caps[1])
                args = (123456789, 987654321, 4242)
                want = td.pack_flush_torch(
                    *args, torch.as_tensor(newly),
                    torch.as_tensor(done.astype(np.int64)),
                    torch.as_tensor(delta.astype(np.int64)), **kw).numpy()
                np.testing.assert_array_equal(got, want, err_msg=name)
                # JAX compiles each new shape: once per input, at the
                # kernel's tile
                if grid is None and tile == td.FLUSH_TILE:
                    jax = np.asarray(_pack_flush_jnp(
                        *args, newly, done.astype(np.int64),
                        delta.astype(np.int64), **kw))
                    np.testing.assert_array_equal(got, jax, err_msg=name)
                if caps is None:
                    np.testing.assert_array_equal(got, td.pack_flush_np(
                        *args, newly, done, delta), err_msg=name)


def test_serial_at_the_tor10k_width():
    """C = 20,000, H = 30,494 (the tor10k plane) at the kernel's tile:
    20 + 30 tiles, a cap inside tile 1 and tile 2."""
    for name, newly, done, delta, caps in _cases(20000, 30494,
                                                 td.FLUSH_TILE, 21):
        got = serial_tiled(newly, done, delta, caps, td.FLUSH_TILE)
        kw = {} if caps is None else dict(cap_chains=caps[0],
                                          cap_nodes=caps[1])
        want = td.pack_flush_torch(
            123456789, 987654321, 4242, torch.as_tensor(newly),
            torch.as_tensor(done.astype(np.int64)),
            torch.as_tensor(delta.astype(np.int64)), **kw).numpy()
        np.testing.assert_array_equal(got, want, err_msg=name)


def _lane_state(w: int, f: int, c: int, h: int, rng, mode: str):
    """Batched-entry inputs: the state after a span and its entry
    snapshots, every lane a mode of pack_cases."""
    done_tick = rng.integers(-1, 9999, size=(w, f))
    if mode == "all empty":
        done_tick[:] = -1
    elif mode == "all full":
        done_tick = rng.integers(0, 9999, size=(w, f))
    last_flow = rng.integers(0, f, size=(w, c))
    done_in = np.where(rng.random((w, c)) < 0.4, -1, 5)
    if mode == "all full":
        done_in[:] = -1
    delivered = rng.integers(0, 1 << 30, size=(w, f))
    sent_in = rng.integers(0, 1 << 40, size=(w, h))
    moved = rng.random((w, h)) < {"all empty": 0.0, "all full": 1.0}.get(
        mode, 0.6)
    node_sent = sent_in + np.where(
        moved, rng.integers(1, 4000, size=(w, h)) * td.CELL_WIRE_BYTES, 0)
    return done_in, done_tick, last_flow, delivered, sent_in, node_sent


def batched_tiled(t_stop, done_in, done_tick, last_flow, delivered, sent_in,
                  node_sent, tile, grid=None):
    w, c = last_flow.shape
    h = node_sent.shape[1]
    fwd = np.zeros(w, np.int64)

    def chain(lane, i):
        dl = done_tick[lane, last_flow[lane, i]]
        return ((dl >= 0) & (done_in[lane, i] < 0), dl,
                delivered[lane, last_flow[lane, i]].sum())

    def node(lane, i):
        d = node_sent[lane, i] - sent_in[lane, i]
        return d != 0, d, d.sum()

    def header(lane, out, n_done, n_touched, dsum, nbytes):
        fwd[lane] = _trunc_div(nbytes, td.CELL_WIRE_BYTES)
        out[:HEADER] = (fwd[lane], dsum, n_done, n_touched, t_stop[lane])
    buf, _ = tiled_pack(chain, node, header, w, c, h, c, h,
                        HEADER + 2 * c + 2 * h, tile, grid)
    return buf, fwd


@pytest.mark.parametrize("tile", TILES)
def test_batched_tiles_equal_plain_and_jax(tile):
    rng = np.random.default_rng(tile)
    for grid in (None, 3):
        for c, h in _sizes(tile):
            for w, mode in ((1, "all empty"), (2, "all full"),
                            (3, "random")):
                f = c + 3
                st = _lane_state(w, f, c, h, rng, mode)
                t_stop = rng.integers(0, 1 << 20, size=w)
                got, fwd = batched_tiled(t_stop, *st, tile, grid)
                want, wfwd = td.pack_flush_batched_torch(
                    torch.as_tensor(t_stop),
                    *(torch.as_tensor(a) for a in st))
                np.testing.assert_array_equal(got, want.numpy())
                np.testing.assert_array_equal(fwd, wfwd.numpy())
                if grid is not None or tile != td.FLUSH_TILE:
                    continue
                done_in, done_tick, last_flow, delivered, sent_in, \
                    node_sent = st
                for lane in range(w):
                    dl = done_tick[lane][last_flow[lane]]
                    delta = node_sent[lane] - sent_in[lane]
                    jax = np.asarray(_pack_flush_jnp(
                        delta.sum() // td.CELL_WIRE_BYTES,
                        delivered[lane][last_flow[lane]].sum(),
                        t_stop[lane], (dl >= 0) & (done_in[lane] < 0), dl,
                        delta))
                    np.testing.assert_array_equal(got[lane], jax)


def _mesh_inputs(c: int, h: int, rng):
    """A mesh flush's inputs on D = 3 shards: node_src maps each shard's
    slots to global nodes (-1 for padding slots), and node 3 of every ten
    and about a tenth of the others sit on no shard (node_slot -1)."""
    d, hp, pad = 3, -(-h // 3) + 2, -(-c // 3) + 4
    on = np.flatnonzero((rng.random(h) >= 0.1) & (np.arange(h) % 10 != 3))
    slots = rng.permutation(d * hp)[:len(on)]
    node_src = np.full(d * hp, -1, np.int64)
    node_src[slots] = on
    node_slot = np.full(h, -1, np.int64)
    ok = np.flatnonzero(node_src >= 0)
    node_slot[node_src[ok]] = ok
    done_tick = rng.integers(-1, 9999, size=d * pad)
    last_flow = rng.integers(0, d * pad, size=c)
    done_in = np.where(rng.random(c) < 0.5, -1, 3)
    delivered = rng.integers(0, 1 << 30, size=d * pad)
    sent_in = rng.integers(0, 1 << 40, size=d * hp)
    node_sent = sent_in + np.where(rng.random(d * hp) < 0.6,
                                   rng.integers(1, 999, size=d * hp), 0)
    return (node_src, node_slot, done_tick, last_flow, done_in, delivered,
            sent_in, node_sent)


def mesh_tiled(heads, done_tick, delivered, node_sent, done_in, sent_in,
               last_flow, node_slot, tile, grid=None, caps=(None, None)):
    c, h = len(last_flow), len(node_slot)
    cc = c if caps[0] is None else min(caps[0], c)
    hh = h if caps[1] is None else min(caps[1], h)
    t_stop, forwards, cross = heads

    def chain(_w, i):
        dl = done_tick[last_flow[i]]
        return ((dl >= 0) & (done_in[i] < 0), dl,
                delivered[last_flow[i]].sum())

    def node(_w, i):
        s = node_slot[i]
        d = np.where(s >= 0, node_sent[s] - sent_in[s], 0)
        return d != 0, d, 0

    def header(_w, out, n_done, n_touched, dsum, _ns):
        out[:HEADER] = (forwards, dsum, n_done, n_touched, t_stop)
        out[HEADER + 2 * cc + 2 * hh] = cross
    return tiled_pack(chain, node, header, 1, c, h, cc, hh,
                      HEADER + 2 * cc + 2 * hh + 1, tile, grid)[0][0]


@pytest.mark.parametrize("tile", TILES)
def test_mesh_tiles_equal_plain_and_jax(tile):
    rng = np.random.default_rng(100 + tile)
    heads = (4242, 123456789, 777)
    for grid in (None, 3):
        for c, h in _sizes(tile):
            node_src, node_slot, done_tick, last_flow, done_in, delivered, \
                sent_in, node_sent = _mesh_inputs(c, h, rng)
            assert (node_slot < 0).any() or h < 4
            got = mesh_tiled(heads, done_tick, delivered, node_sent, done_in,
                             sent_in, last_flow, node_slot, tile, grid)
            # the plain form: exchange.py:mesh_span_flush_torch's flush half
            lf = torch.as_tensor(last_flow)
            nsrc = torch.as_tensor(node_src)
            done_last = torch.as_tensor(done_tick)[lf]
            newly = (done_last >= 0) & (torch.as_tensor(done_in) < 0)
            delta = ex.global_sent_torch(torch.as_tensor(node_sent), nsrc,
                                         h) \
                - ex.global_sent_torch(torch.as_tensor(sent_in), nsrc, h)
            want = torch.cat([td.pack_flush_torch(
                heads[1], torch.as_tensor(delivered)[lf].sum(), heads[0],
                newly, done_last, delta), torch.tensor([heads[2]])])
            np.testing.assert_array_equal(got, want.numpy())
            assert got[-1] == heads[2]
            if grid is not None or tile != td.FLUSH_TILE:
                continue
            jax = np.asarray(_pack_flush_jnp(
                heads[1], delivered[last_flow].sum(), heads[0],
                newly.numpy(), done_last.numpy(), delta.numpy()))
            np.testing.assert_array_equal(got[:-1], jax)


@pytest.mark.parametrize("tile", TILES)
def test_capped_mesh_tiles_equal_plain_and_jax(tile):
    """The mesh entry with caps (as the serial entry takes them): the
    trailing cross slot after the capped layout, caps below the true
    counts (entries dropped, the header's counts TRUE), inside a later
    tile, and above the counts."""
    rng = np.random.default_rng(300 + tile)
    heads = (4242, 123456789, 777)
    for grid in (None, 3):
        for c, h in _sizes(tile):
            node_src, node_slot, done_tick, last_flow, done_in, delivered, \
                sent_in, node_sent = _mesh_inputs(c, h, rng)
            for caps in ((1, 2), (max(c // 3, 1), max(h // 2, 1)),
                         (tile + 2, 2 * tile + 1), (c + 5, h + 5)):
                got = mesh_tiled(heads, done_tick, delivered, node_sent,
                                 done_in, sent_in, last_flow, node_slot,
                                 tile, grid, caps)
                lf = torch.as_tensor(last_flow)
                nsrc = torch.as_tensor(node_src)
                done_last = torch.as_tensor(done_tick)[lf]
                newly = (done_last >= 0) & (torch.as_tensor(done_in) < 0)
                delta = ex.global_sent_torch(torch.as_tensor(node_sent),
                                             nsrc, h) \
                    - ex.global_sent_torch(torch.as_tensor(sent_in), nsrc, h)
                want = torch.cat([td.pack_flush_torch(
                    heads[1], torch.as_tensor(delivered)[lf].sum(),
                    heads[0], newly, done_last, delta, *caps),
                    torch.tensor([heads[2]])])
                np.testing.assert_array_equal(got, want.numpy())
                assert len(got) == td.flush_len(c, h, *caps) + 1
                assert ex.mesh_flush_extra(got, c, h, *caps) == heads[2]
                if grid is not None or tile != td.FLUSH_TILE:
                    continue
                jax = np.asarray(_pack_flush_jnp(
                    heads[1], delivered[last_flow].sum(), heads[0],
                    newly.numpy(), done_last.numpy(), delta.numpy(),
                    *caps))
                np.testing.assert_array_equal(got[:-1], jax)


@pytest.mark.parametrize("w,c,h", [(1, 20000, 30494), (8, 32768, 32768),
                                   (1, 0, 0), (3, 1, 1025)])
def test_tile_count_is_the_wrappers(w, c, h):
    """flush_tiles (the wrapper's scratch) counts the restatement's
    tiles: 50 at the tor10k width, 512 at the sweep's class, W = 8."""
    counts = tiled_pack(lambda _w, i: (np.zeros(len(i), bool), i, 0),
                        lambda _w, i: (np.zeros(len(i), bool), i, 0),
                        lambda *a: None, w, c, h, c, h,
                        HEADER + 2 * c + 2 * h, td.FLUSH_TILE)[1]
    assert td.flush_tiles(w, c, h) == len(counts)
    scratch, n = td.flush_scratch(w, c, h, "cpu")
    assert n == len(counts) and scratch.shape == (2 * n,)
