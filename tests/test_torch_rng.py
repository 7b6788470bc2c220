"""The port's plain threefry (int64 lanes masked to 32 bits) against the JAX
package's cipher and its numpy twin: bit-exact on seeded uint32 lanes,
including the 0 and 0xFFFFFFFF edges of lanes and keys."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from shadow_tpu.core import rng as jrng
from shadow_tpu_torch.core import rng as trng

EDGE = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF],
                dtype=np.uint32)
KEYS = [(0, 0), (0xFFFFFFFF, 0xFFFFFFFF), (0, 0xFFFFFFFF),
        (0x12345678, 0x9ABCDEF0)]


def _lanes(seed, n=2048):
    rng = np.random.default_rng(seed)
    c0 = rng.integers(0, 2 ** 32, size=n, dtype=np.uint64).astype(np.uint32)
    c1 = rng.integers(0, 2 ** 32, size=n, dtype=np.uint64).astype(np.uint32)
    # every pair of edge values appears in (c0, c1)
    e0, e1 = np.meshgrid(EDGE, EDGE)
    return (np.concatenate([e0.ravel(), c0]),
            np.concatenate([e1.ravel(), c1]))


def _t(a):
    return torch.from_numpy(a.astype(np.int64))


@pytest.mark.parametrize("k0,k1", KEYS)
def test_threefry_torch_bit_exact_vs_jax_and_numpy(k0, k1):
    c0, c1 = _lanes(seed=k0 ^ 0x5EED)
    x0, x1 = trng.threefry2x32_torch(k0, k1, _t(c0), _t(c1))
    assert x0.dtype == torch.int64 and x1.dtype == torch.int64
    n0, n1 = jrng.threefry2x32_np(k0, k1, c0, c1)
    j0, j1 = jrng.threefry2x32_jnp(jnp.uint32(k0), jnp.uint32(k1),
                                   jnp.asarray(c0), jnp.asarray(c1))
    np.testing.assert_array_equal(x0.numpy(), n0.astype(np.int64))
    np.testing.assert_array_equal(x1.numpy(), n1.astype(np.int64))
    np.testing.assert_array_equal(x0.numpy(), np.asarray(j0).astype(np.int64))
    np.testing.assert_array_equal(x1.numpy(), np.asarray(j1).astype(np.int64))


def test_threefry_torch_takes_tensor_keys():
    c0, c1 = _lanes(seed=3, n=64)
    a = trng.threefry2x32_torch(0xFFFFFFFF, 7, _t(c0), _t(c1))
    b = trng.threefry2x32_torch(torch.tensor(0xFFFFFFFF), torch.tensor(7),
                                _t(c0), _t(c1))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("key", [0, 0xFFFFFFFFFFFFFFFF, 0xDEADBEEF12345678])
def test_uniform_torch_pair_equals_uniform_np_as_f32(key):
    c0, c1 = _lanes(seed=11)
    u = trng.uniform_torch_pair(key, _t(c0), _t(c1))
    assert u.dtype == torch.float32
    counters = c0.astype(np.uint64) | (c1.astype(np.uint64) << np.uint64(32))
    expect = jrng.uniform_np(key, counters).astype(np.float32)
    np.testing.assert_array_equal(u.numpy(), expect)
    # and the JAX device twin gives the same bits
    np.testing.assert_array_equal(
        u.numpy(), np.asarray(jrng.uniform_jnp_pair(key, c0, c1)))
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0


def test_numpy_and_int_parts_are_the_jax_packages():
    """The numpy/int half of core/rng.py is copied unchanged: same bits."""
    ids = np.arange(100, dtype=np.uint64)
    assert trng.derive(99, "host", 3) == jrng.derive(99, "host", 3)
    np.testing.assert_array_equal(trng.derive_np(5, "x", ids),
                                  jrng.derive_np(5, "x", ids))
    a, b = trng.RandomSource(17), jrng.RandomSource(17)
    assert [a.next_u64() for _ in range(8)] == [b.next_u64() for _ in range(8)]
