"""csrc/packet_hop_sharded.cu's owner gather and its one-launch batch
layout restated in numpy, held to the plain versions and to the JAX
package on the CPU.

* The matrix layout: the JAX step gathers on every shard with a mask and
  sums over the shards (the psum); the kernel computes the owning shard
  ``s = src // rows_per`` and gathers once from it.  Every other shard's
  term is an exact zero, so the two agree — the one difference is a -0.0
  entry, which the sum turns into +0.0, and neither ``rel >= 1`` nor
  ``u <= rel`` (u >= 0) tells the two zeros apart: deliver and keep are
  equal bit for bit (:func:`test_minus_zero_differs_only_in_rel`).
* The batch layout: the D slices of the padded batch are the grid's y
  axis, a lane ``i = slice * w + x`` (w = B / D): one launch covers each
  lane exactly once.

At D in {1, 2, 3, 8} and A = 37 (a multiple of none but 1), with src and
dst rows out of range (clamped, as the kernel and the plain versions
clamp them), and reliabilities of exactly 0.0, -0.0 and 1.0.
"""

import numpy as np
import pytest
import torch

from shadow_tpu.ops.round_step import \
    ShardedPacketHopKernel as JShardedPacketHopKernel
from shadow_tpu_torch.ops import round_step as trs
from test_torch_scaleout import _Topo

A = 37
THREADS = 256                 # csrc/packet_hop_sharded.cu THREADS
DROP_KEY = 0xC0FFEE123456789A
BOOTSTRAP_END = 5_000_000_000
BARRIER = 7_000_000_000
SHARDS = (1, 2, 3, 8)


@pytest.fixture(scope="module")
def topo():
    rng = np.random.default_rng(11)
    lat = rng.integers(1_000_000, 50_000_000, (A, A)).astype(np.int64)
    rel = rng.uniform(0.0, 1.0, (A, A)).astype(np.float32)
    pick = rng.random((A, A))
    rel[pick < 0.25] = np.float32(1.0)
    rel[(pick >= 0.25) & (pick < 0.35)] = np.float32(0.0)
    rel[(pick >= 0.35) & (pick < 0.45)] = np.float32(-0.0)
    return _Topo(lat, rel)


def owner_gather(lat_rows, rel_rows, a: int, src, dst):
    """The kernel's gather: each lane's owning shard, one gather from
    it."""
    rows_per = lat_rows[0].shape[0]
    src = np.clip(src, 0, a - 1)
    dst = np.clip(dst, 0, a - 1)
    owner = src // rows_per
    assert owner.max() < len(lat_rows)
    local = src - owner * rows_per
    lat = np.empty(len(src), np.int64)
    rel = np.empty(len(src), np.float32)
    for s in np.unique(owner):
        m = owner == s
        lat[m] = lat_rows[s][local[m], dst[m]]
        rel[m] = rel_rows[s][local[m], dst[m]]
    return lat, rel


def launch_lanes(b: int, slices: int) -> np.ndarray:
    """The lanes a launch of grid (ceil(w / THREADS), slices) visits, in
    block order: lane = blockIdx.y * w + x for x < w."""
    w = b // slices
    out = []
    for y in range(slices):
        for bx in range(-(-w // THREADS)):
            x = np.arange(bx * THREADS, (bx + 1) * THREADS)
            out.append(y * w + x[x < w])
    return np.concatenate(out)


def kernel_hop(kern, cols, slices: int):
    """The kernel's hop on the padded columns: the lanes the launch visits,
    the owner gather, then the plain finish (the Threefry draw, keep,
    deliver)."""
    b = len(cols[0])
    lanes = launch_lanes(b, slices)
    assert np.array_equal(np.sort(lanes), np.arange(b)), \
        "a lane visited other than once"
    lat, rel = owner_gather([r.numpy() for r in kern.rows.lat],
                            [r.numpy() for r in kern.rows.rel], A,
                            cols[0][lanes], cols[1][lanes])
    t = [torch.as_tensor(c[lanes]) for c in cols]
    d, k = trs._finish_hop_torch(torch.as_tensor(lat), torch.as_tensor(rel),
                                 *t[2:], kern.key_lo, kern.key_hi,
                                 BOOTSTRAP_END, BARRIER)
    deliver = np.empty(b, np.int64)
    keep = np.empty(b, bool)
    deliver[lanes] = d.numpy()
    keep[lanes] = k.numpy()
    return deliver, keep


def _batch(n: int, seed: int, out_of_range: bool):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, A, n)
    dst = rng.integers(0, A, n)
    if out_of_range:
        src[::7] = np.array([-5, A, A + 100, -1])[np.arange(len(src[::7]))
                                                  % 4]
        dst[3::11] = A + 3
    return (src, dst, rng.integers(0, 2 ** 63, n).astype(np.uint64),
            rng.integers(BOOTSTRAP_END // 2, 2 * BOOTSTRAP_END, n))


@pytest.mark.parametrize("shard_matrix", [False, True])
@pytest.mark.parametrize("n_dev", SHARDS)
def test_owner_gather_equals_plain_and_jax(topo, n_dev, shard_matrix):
    t = trs.ShardedPacketHopKernel(topo, DROP_KEY, BOOTSTRAP_END, n_dev,
                                   shard_matrix=shard_matrix, device="cpu")
    assert t.rows.d == (n_dev if shard_matrix else 1)
    assert t.rows.rows_per == (-(-A // n_dev) if shard_matrix else A)
    slices = 1 if shard_matrix else n_dev
    j = JShardedPacketHopKernel(topo, DROP_KEY, BOOTSTRAP_END, n_dev,
                                shard_matrix=shard_matrix)
    for n, seed, oor in ((300, 1, False), (300, 2, True)):
        raw = _batch(n, seed, oor)
        b = t.bucket(n)
        cols = t.padded_batch(*raw, b)
        got = kernel_hop(t, cols, slices)
        tc = tuple(torch.from_numpy(c) for c in cols)
        keys = (t.key_lo, t.key_hi, BOOTSTRAP_END, BARRIER)
        plain = (trs.matrix_sharded_hop_reference(t.lat_rows, t.rel_rows, A,
                                                  tc, *keys)
                 if shard_matrix else trs.batch_sharded_hop_reference(
                     t.latency, t.reliability, tc, n_dev, *keys))
        wrapped = trs.packet_hop_sharded(t.rows, tc, *keys, slices=slices)
        for want in (plain, wrapped):
            np.testing.assert_array_equal(got[0], want[0].numpy())
            np.testing.assert_array_equal(got[1], want[1].numpy())
        if not oor:       # JAX wraps negative rows: in-range rows only
            jd, jk = j.step(*raw, BARRIER)
            np.testing.assert_array_equal(got[0][:n], jd)
            np.testing.assert_array_equal(got[1][:n], jk)
        assert 0 < got[1][:n].sum() < n


@pytest.mark.parametrize("n_dev", SHARDS)
def test_minus_zero_differs_only_in_rel(topo, n_dev):
    """Every packet on an entry of -0.0: the psum's sum of the shards'
    terms gives +0.0, the owner's gather -0.0, and deliver and keep are
    the same."""
    t = trs.ShardedPacketHopKernel(topo, DROP_KEY, BOOTSTRAP_END, n_dev,
                                   shard_matrix=True, device="cpu")
    rel = topo.reliability
    src, dst = np.nonzero((rel == 0) & np.signbit(rel))
    rng = np.random.default_rng(n_dev)
    raw = (src, dst, rng.integers(0, 2 ** 63, len(src)).astype(np.uint64),
           rng.integers(BOOTSTRAP_END, 2 * BOOTSTRAP_END, len(src)))
    cols = t.padded_batch(*raw, t.bucket(len(src)))
    _, own = owner_gather([r.numpy() for r in t.rows.lat],
                          [r.numpy() for r in t.rows.rel], A, cols[0],
                          cols[1])
    n = len(src)
    psum = np.zeros(len(cols[0]), np.float32)
    for s in range(n_dev):           # the JAX step's masked terms, summed
        local = np.clip(cols[0], 0, A - 1) - s * t.rows.rows_per
        mine = (local >= 0) & (local < t.rows.rows_per)
        psum = psum + np.where(mine, t.rel_rows[s].numpy()[
            np.clip(local, 0, t.rows.rows_per - 1),
            np.clip(cols[1], 0, A - 1)], np.float32(0.0))
    assert np.signbit(own[:n]).all() and not np.signbit(psum[:n]).any()
    assert np.array_equal(own, psum)              # equal as numbers
    got = kernel_hop(t, cols, 1)
    want = trs.matrix_sharded_hop_reference(
        t.lat_rows, t.rel_rows, A, tuple(torch.from_numpy(c) for c in cols),
        t.key_lo, t.key_hi, BOOTSTRAP_END, BARRIER)
    np.testing.assert_array_equal(got[0], want[0].numpy())
    np.testing.assert_array_equal(got[1], want[1].numpy())
    assert not got[1][:n].any()      # past bootstrap, rel 0: all dropped


@pytest.mark.parametrize("n_dev", SHARDS + (5,))
def test_one_launch_covers_every_slice(n_dev):
    """The batch layout's grid covers the bucket's D slices, every lane
    once, at buckets whose slices are not a multiple of the block."""
    t = trs.ShardedPacketHopKernel.from_arrays(
        np.zeros((A, A), np.int64), np.ones((A, A), np.float32), DROP_KEY,
        BOOTSTRAP_END, "cpu", n_devices=n_dev)
    for n in (1, 300, 3000):
        b = t.bucket(n)
        lanes = launch_lanes(b, n_dev)
        assert np.array_equal(np.sort(lanes), np.arange(b))
        slice_of = lanes // (b // n_dev)
        assert np.array_equal(np.unique(slice_of), np.arange(n_dev))
