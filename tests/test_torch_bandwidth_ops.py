"""Token-bucket admission in the port (``ops/bandwidth.py``), on the CPU,
against the JAX package and the event-driven host oracle.

The port's ``admit_sorted`` (on CPU tensors: its plain torch version) and
``BandwidthKernel`` must equal, bit for bit, the JAX package's
``admit_sorted`` / ``BandwidthKernel`` and the event-driven FIFO drain of
the JAX package's tests/test_bandwidth_ops.py (ported here), on its random
cases and on batches whose invalid lanes sit inside the batch, not only at
its end.  Tolerance: none (int64, exact).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import shadow_tpu.ops.bandwidth as jbw
import shadow_tpu_torch.ops.bandwidth as tbw
from shadow_tpu_torch.core import defs
from shadow_tpu_torch.ops.bandwidth import (REFILL_NS, BandwidthKernel,
                                            bucket_params)


def oracle_admit(dst_rows, sizes, arrive, tokens0, refill, capacity):
    """Event-driven FIFO drain per host, ticks at absolute 1 ms boundaries."""
    admits = np.zeros(len(dst_rows), dtype=np.int64)
    order = np.lexsort((np.arange(len(dst_rows)), arrive, dst_rows))
    state = {}   # dst -> [tick, tokens, last_admit]
    for i in order:
        d = int(dst_rows[i])
        a = int(arrive[i])
        size = int(sizes[i])
        ref = max(int(refill[d]), 1)
        cap = int(capacity[d])
        if d not in state:
            state[d] = [a // REFILL_NS, int(tokens0[d]), 0]
        tick, tok, last = state[d]
        start = max(a, last)
        stick = start // REFILL_NS
        tok = min(cap, tok + ref * (stick - tick))
        tick = stick
        while tok < size:            # wait tick by tick (the refill task)
            tick += 1
            tok = min(cap, tok + ref)
        admit = max(start, tick * REFILL_NS)
        tok -= size
        state[d] = [tick, tok, admit]
        admits[i] = admit
    return admits


def _random_case(rng, n_hosts=8, n_pkts=400, span_ns=20 * REFILL_NS):
    dst = rng.integers(0, n_hosts, size=n_pkts).astype(np.int32)
    sizes = rng.integers(60, defs.CONFIG_MTU + 1, size=n_pkts).astype(np.int64)
    arrive = rng.integers(10 * REFILL_NS, 10 * REFILL_NS + span_ns,
                          size=n_pkts).astype(np.int64)
    rates = rng.integers(80, 2000, size=n_hosts).astype(np.int64)  # KiB/s
    refill, capacity = bucket_params(rates)
    tokens0 = rng.integers(0, capacity + 1, size=n_hosts).astype(np.int64)
    return dst, sizes, arrive, tokens0, refill, capacity, rates


def test_bucket_params_equal_the_jax_package():
    rates = np.random.default_rng(3).integers(1, 10 ** 6, size=500)
    for a, b in zip(bucket_params(rates), jbw.bucket_params(rates)):
        np.testing.assert_array_equal(a, b)


def test_kernel_matches_event_driven_oracle_and_jax():
    rng = np.random.default_rng(17)
    for trial in range(5):
        dst, sizes, arrive, tokens0, refill, capacity, rates = \
            _random_case(rng)
        kern = BandwidthKernel(rates, device="cpu")
        got = kern.admit(dst, sizes, arrive, tokens0)
        assert kern.device_calls == 1
        want = oracle_admit(dst, sizes, arrive, tokens0, refill, capacity)
        jax_got = jbw.BandwidthKernel(rates).admit(dst, sizes, arrive,
                                                    tokens0)
        np.testing.assert_array_equal(got, want, err_msg=f"trial {trial}")
        np.testing.assert_array_equal(got, jax_got, err_msg=f"trial {trial}")


def test_capacity_cap_binds_across_idle_gaps():
    rates = np.array([100], dtype=np.int64)
    refill, capacity = bucket_params(rates)
    n = 20
    dst = np.zeros(n, dtype=np.int32)
    sizes = np.full(n, defs.CONFIG_MTU, dtype=np.int64)
    arrive = np.full(n, 2 * 10 ** 9, dtype=np.int64)
    tokens0 = capacity.copy()
    got = BandwidthKernel(rates, device="cpu").admit(dst, sizes, arrive,
                                                      tokens0)
    want = oracle_admit(dst, sizes, arrive, tokens0, refill, capacity)
    np.testing.assert_array_equal(got, want)
    assert (got > arrive).sum() > n // 2


def test_saturated_host_spreads_over_ticks():
    rates = np.array([1000], dtype=np.int64)
    refill, capacity = bucket_params(rates)
    n = 50
    dst = np.zeros(n, dtype=np.int32)
    sizes = np.full(n, defs.CONFIG_MTU, dtype=np.int64)
    arrive = np.full(n, 10 ** 9, dtype=np.int64)
    tokens0 = np.zeros(1, dtype=np.int64)
    got = BandwidthKernel(rates, device="cpu").admit(dst, sizes, arrive,
                                                      tokens0)
    want = oracle_admit(dst, sizes, arrive, tokens0, refill, capacity)
    np.testing.assert_array_equal(got, want)
    assert np.all(np.diff(np.sort(got)) >= 0)
    assert got.max() > got.min()


def _sorted_batch(rng, n_hosts, n, invalid_share):
    dst, sizes, arrive, tokens0, refill, capacity, _rates = _random_case(
        rng, n_hosts=n_hosts, n_pkts=n)
    order = np.lexsort((np.arange(n), arrive, dst))
    valid = rng.random(n) >= invalid_share
    return (dst[order], sizes[order], arrive[order], valid, tokens0, refill,
            capacity)


@pytest.mark.parametrize("n_hosts,n,invalid_share", [
    (8, 256, 0.3),       # long runs, invalid lanes inside them
    (64, 1024, 0.5),     # a run's host reappearing after invalid lanes
    (300, 512, 0.9),     # most lanes invalid
    (5, 300, 0.0),       # no invalid lane, N not a power of two
])
def test_interleaved_invalid_lanes_match_jax(n_hosts, n, invalid_share):
    """Invalid lanes leave the scan's carry untouched, so a run begins at a
    valid lane whose dst differs from the previous VALID lane's; the port
    must agree with the JAX scan lane for lane, 0 on invalid lanes."""
    rng = np.random.default_rng(n_hosts * 1000 + n)
    case = _sorted_batch(rng, n_hosts, n, invalid_share)
    want = np.asarray(jbw.admit_sorted(*(jnp.asarray(a) for a in case)))
    got = tbw.admit_sorted(*(torch.from_numpy(a) for a in case))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got.numpy()[~case[3]].any()


def test_a_host_interrupted_by_another_opens_a_new_run():
    """dst 0, 1, 0 (the scan resets at each change, sorted or not)."""
    dst = np.array([0, 0, 1, 0, 0], dtype=np.int32)
    sizes = np.full(5, 1500, dtype=np.int64)
    arrive = np.array([10, 11, 12, 13, 14], dtype=np.int64) * REFILL_NS
    valid = np.array([True, True, True, True, False])
    refill, capacity = bucket_params(np.array([500, 500]))
    tokens0 = np.array([1000, 3000], dtype=np.int64)
    case = (dst, sizes, arrive, valid, tokens0, refill, capacity)
    want = np.asarray(jbw.admit_sorted(*(jnp.asarray(a) for a in case)))
    got = tbw.admit_sorted(*(torch.from_numpy(a) for a in case)).numpy()
    np.testing.assert_array_equal(got, want)


def test_upload_views_every_part_back():
    parts = [np.arange(5, dtype=np.int64), np.arange(7, dtype=np.int64) * 3,
             np.arange(6, dtype=np.int32) - 2,
             np.array([True, False, True])]
    for a, b in zip(parts, tbw.upload(parts, torch.device("cpu"))):
        np.testing.assert_array_equal(b.numpy(), a)
        assert b.numpy().dtype == a.dtype
