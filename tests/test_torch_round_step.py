"""The port's hop step against the JAX package's, on the CPU.

Same [1+B, 3] batch, built with numpy from a seed, through
``packet_hop_packed_reference`` (and its wrapper, which takes the plain
version for CPU tensors) and the JAX ``packet_hop_step_packed``: deliver
and keep must be bit-exact over all B lanes, padding included.  The batch
covers reliabilities of exactly 1.0 and 0.0 and in between, n < B padding,
a bootstrap end that splits the batch, a barrier that clamps some lanes and
uids with the top bit set.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from shadow_tpu.ops import round_step as jrs
from shadow_tpu.routing.topology import Topology as JTopology
from shadow_tpu_torch.ops import round_step as trs
from shadow_tpu_torch.routing.topology import Topology as TTopology
from shadow_tpu_torch.tools.synth_topology import lossy_complete_graphml

A = 183
DROP_KEY = 0xC0FFEE123456789A
BOOTSTRAP_END = 5_000_000_000


def _matrices(seed):
    rng = np.random.default_rng(seed)
    lat = rng.integers(1_000_000, 150_000_000, size=(A, A), dtype=np.int64)
    rel = rng.random((A, A)).astype(np.float32)
    pick = rng.random((A, A))
    rel[pick < 0.3] = np.float32(1.0)
    rel[(pick >= 0.3) & (pick < 0.4)] = np.float32(0.0)
    return lat, rel


def _columns(seed, n):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, A, size=n, dtype=np.int32)
    dst = rng.integers(0, A, size=n, dtype=np.int32)
    uids = rng.integers(0, 2 ** 64, size=n, dtype=np.uint64)
    edge = np.array([2 ** 64 - 1, 0, 1, 2 ** 63], dtype=np.uint64)
    uids[:4] = edge[:min(n, 4)]
    times = rng.integers(BOOTSTRAP_END // 2, 2 * BOOTSTRAP_END, size=n,
                         dtype=np.int64)
    return src, dst, uids, times


def _packed(seed, n, b, barrier):
    src, dst, uids, times = _columns(seed, n)
    kern = trs.PacketHopKernel.from_arrays(*_matrices(seed), DROP_KEY,
                                           BOOTSTRAP_END, "cpu")
    return kern._pack(src, dst, uids, times, b, barrier)


def _jax_step(lat, rel, packed):
    d, k = jrs.packet_hop_step_packed(
        jnp.asarray(lat), jnp.asarray(rel), jnp.asarray(packed),
        jnp.uint32(DROP_KEY & 0xFFFFFFFF), jnp.uint32(DROP_KEY >> 32),
        jnp.int64(BOOTSTRAP_END))
    return np.asarray(d), np.asarray(k)


@pytest.mark.parametrize("n,b", [(1, 256), (200, 256), (400, 512),
                                 (512, 512), (1500, 2048)])
def test_packed_reference_bit_exact_vs_jax(n, b):
    lat, rel = _matrices(seed=n)
    src, dst, uids, times = _columns(n, n)
    # a barrier inside the delivery range clamps some lanes
    barrier = int(np.median(times)) + 50_000_000
    packed = _packed(n, n, b, barrier)
    d, k = trs.packet_hop_packed_reference(
        torch.from_numpy(lat), torch.from_numpy(rel), torch.from_numpy(packed),
        DROP_KEY & 0xFFFFFFFF, DROP_KEY >> 32, BOOTSTRAP_END)
    assert d.dtype == torch.int64 and k.dtype == torch.bool
    assert d.shape == (b,) and k.shape == (b,)
    jd, jk = _jax_step(lat, rel, packed)
    np.testing.assert_array_equal(d.numpy(), jd)
    np.testing.assert_array_equal(k.numpy(), jk)
    # the batch exercises every branch of keep and the clamp
    valid = slice(0, n)
    if n >= 200:
        assert not k.numpy()[valid].all() and k.numpy()[valid].any()
        assert (d.numpy()[valid] == barrier).any()
        assert (times < BOOTSTRAP_END).any() and (times >= BOOTSTRAP_END).any()
    assert not k.numpy()[n:].any()


def test_wrapper_takes_plain_version_for_cpu_tensors():
    lat, rel = _matrices(seed=5)
    packed = torch.from_numpy(_packed(5, 300, 512, 0))
    before = trs.packet_hop_packed.launches
    d, k = trs.packet_hop_packed(torch.from_numpy(lat), torch.from_numpy(rel),
                                 packed, DROP_KEY & 0xFFFFFFFF,
                                 DROP_KEY >> 32, BOOTSTRAP_END)
    rd, rk = trs.packet_hop_packed_reference(
        torch.from_numpy(lat), torch.from_numpy(rel), packed,
        DROP_KEY & 0xFFFFFFFF, DROP_KEY >> 32, BOOTSTRAP_END)
    assert torch.equal(d, rd) and torch.equal(k, rk)
    # the launch count counts kernel launches only
    assert trs.packet_hop_packed.launches == before


def _jax_topology(n_vertices=12, seed=3):
    topo = JTopology.from_graphml(lossy_complete_graphml(n_vertices, seed))
    for i in range(n_vertices):
        topo.attach_host(0x0B000001 + i, choice_rand=i)
    topo.finalize()
    return topo


@pytest.mark.parametrize("n", [1, 37, 256, 700])
def test_kernel_step_matches_jax_kernel_and_numpy(n):
    topo = _jax_topology()
    a = topo.latency_ns.shape[0]
    rng = np.random.default_rng(n)
    src = rng.integers(0, a, size=n, dtype=np.int32)
    dst = rng.integers(0, a, size=n, dtype=np.int32)
    uids = rng.integers(0, 2 ** 64, size=n, dtype=np.uint64)
    times = rng.integers(0, 4 * BOOTSTRAP_END, size=n, dtype=np.int64)
    barrier = int(np.median(times))
    port = trs.PacketHopKernel.from_arrays(topo.latency_ns, topo.reliability,
                                           DROP_KEY, BOOTSTRAP_END, "cpu")
    jax_k = jrs.PacketHopKernel(topo, DROP_KEY, BOOTSTRAP_END)
    d, k = port.step(src, dst, uids, times, barrier)
    jd, jk = jax_k.step(src, dst, uids, times, barrier)
    nd, nk = jax_k._step_numpy(src, dst, uids, times, barrier)
    pd, pk = port._step_numpy(src, dst, uids, times, barrier)
    for other_d, other_k in ((jd, jk), (nd, nk), (pd, pk)):
        np.testing.assert_array_equal(d, other_d)
        np.testing.assert_array_equal(k, other_k)
    assert d.shape == (n,) and k.shape == (n,)
    assert port.device_calls == 1 and port.buckets_seen == jax_k.buckets_seen


def test_port_topology_device_tensors_match_jax_matrices():
    jtopo = _jax_topology(9, seed=4)
    ttopo = TTopology.from_graphml(lossy_complete_graphml(9, 4))
    for i in range(9):
        ttopo.attach_host(0x0B000001 + i, choice_rand=i)
    ttopo.finalize()
    lat, rel = ttopo.device_tensors("cpu")
    assert lat.dtype == torch.int64 and rel.dtype == torch.float32
    np.testing.assert_array_equal(lat.numpy(), jtopo.latency_ns)
    np.testing.assert_array_equal(rel.numpy(), jtopo.reliability)
    assert ttopo.device_tensors("cpu")[0] is lat      # cached per device


def test_bucket_size_agrees():
    for n in [0, 1, 255, 256, 257, 511, 512, 513, 4096, 65536, 65537]:
        assert trs.bucket_size(n) == jrs.bucket_size(n)
    assert trs.MIN_BUCKET == jrs.MIN_BUCKET


def test_threshold_bypass_and_empty_launch():
    topo = _jax_topology()
    port = trs.PacketHopKernel.from_arrays(topo.latency_ns, topo.reliability,
                                           DROP_KEY, BOOTSTRAP_END, "cpu",
                                           device_threshold=100)
    src = np.zeros(10, dtype=np.int32)
    uids = np.arange(10, dtype=np.uint64)
    times = np.arange(10, dtype=np.int64)
    d, k = port.launch(src, src, uids, times, 0).wait()
    assert port.host_calls == 1 and port.device_calls == 0
    nd, nk = port._step_numpy(src, src, uids, times, 0)
    np.testing.assert_array_equal(d, nd)
    np.testing.assert_array_equal(k, nk)
    d, k = port.launch(src[:0], src[:0], uids[:0], times[:0], 0).wait()
    assert d.shape == (0,) and k.shape == (0,)


def test_threshold_refused_off_the_cpu():
    with pytest.raises(ValueError, match="--device cpu"):
        trs.PacketHopKernel.from_arrays(*_matrices(1), DROP_KEY,
                                        BOOTSTRAP_END, "meta",
                                        device_threshold=100)


def test_pack_into_reused_buffer_zeroes_padding():
    port = trs.PacketHopKernel.from_arrays(*_matrices(1), DROP_KEY,
                                           BOOTSTRAP_END, "cpu")
    src, dst, uids, times = _columns(1, 300)
    out = port._pack(src, dst, uids, times, 512, 7)
    reused = np.full_like(out, -1)
    port._pack(src[:20], dst[:20], uids[:20], times[:20], 512, 7, out=reused)
    fresh = port._pack(src[:20], dst[:20], uids[:20], times[:20], 512, 7)
    np.testing.assert_array_equal(reused, fresh)
