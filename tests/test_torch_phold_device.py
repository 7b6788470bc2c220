"""Device-resident PHOLD in the port, on the CPU, against the JAX package.

The port's ``phold_run`` (on CPU tensors: its plain torch version) must
equal, bit for bit on the final hosts, times and hops, the JAX package's
``phold_run`` and its numpy twin on the JAX test's instance (32 hosts x 64
messages for 2 s, made by numpy from a seed); ``DevicePhold`` must build
the JAX class's arrays from the same seed.  Tolerance: none (exact).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import shadow_tpu.ops.phold_device as jpd
import shadow_tpu_torch.ops.phold_device as tpd


def test_plain_version_matches_jax_and_numpy_twin():
    port = tpd.DevicePhold(n_hosts=32, n_msgs=64, seed=11, device="cpu")
    ref = jpd.DevicePhold(n_hosts=32, n_msgs=64, seed=11)
    horizon = int(2e9)
    host, time, hops = port.run_device(horizon)
    assert host.dtype == np.int32 and time.dtype == np.int64
    j_host, j_time, j_hops = ref.run_device(horizon)
    n_host, n_time, n_hops = port.run_numpy(horizon)
    assert hops == j_hops == n_hops
    np.testing.assert_array_equal(host, j_host)
    np.testing.assert_array_equal(time, j_time)
    np.testing.assert_array_equal(host, n_host)
    np.testing.assert_array_equal(time, n_time)


@pytest.mark.parametrize("seed,n_hosts,n_msgs", [(3, 16, 40), (5, 2, 9),
                                                 (8, 64, 200)])
def test_functions_match_on_a_random_key_and_start(seed, n_hosts, n_msgs):
    """phold_run on raw arrays (non-zero start times, a random key, two
    hosts included) equals the JAX function."""
    rng = np.random.default_rng(seed)
    lat = rng.integers(1_000_000, 40_000_000,
                       size=(n_hosts, n_hosts)).astype(np.int64)
    np.fill_diagonal(lat, 0)
    host = rng.integers(0, n_hosts, size=n_msgs).astype(np.int32)
    time = rng.integers(0, 50_000_000, size=n_msgs).astype(np.int64)
    key = rng.integers(0, 2 ** 32, size=2, dtype=np.uint64).astype(np.uint32)
    horizon = 700_000_000
    j = jpd.phold_run(jnp.asarray(lat), jnp.asarray(host), jnp.asarray(time),
                      jnp.asarray(key), jnp.int64(horizon))
    t = tpd.phold_run(torch.from_numpy(lat), torch.from_numpy(host),
                      torch.from_numpy(time), key, horizon,
                      with_windows=True)
    assert t[0].dtype == torch.int32
    np.testing.assert_array_equal(t[0].numpy(), np.asarray(j[0]))
    np.testing.assert_array_equal(t[1].numpy(), np.asarray(j[1]))
    assert int(t[2]) == int(j[2])
    assert int(t[3]) > 0


def test_population_and_progress():
    p = tpd.DevicePhold(n_hosts=16, n_msgs=40, seed=3, device="cpu")
    host, time, hops = p.run_device(int(1e9))
    assert len(host) == 40
    assert (time >= int(1e9)).all()
    assert hops > 40
    assert host.min() >= 0 and host.max() < 16


def test_longer_horizon_only_adds_hops():
    p = tpd.DevicePhold(n_hosts=16, n_msgs=40, seed=5, device="cpu")
    _, _, hops1 = p.run_device(int(1e9))
    _, _, hops2 = p.run_device(int(3e9))
    assert hops2 > hops1


def test_a_horizon_already_passed_runs_no_window():
    p = tpd.DevicePhold(n_hosts=8, n_msgs=10, seed=2, device="cpu")
    host, time, hops, windows = tpd.phold_run(
        p.latency, torch.from_numpy(p.msg_host), torch.from_numpy(p.msg_time),
        (p.key_lo, p.key_hi), 0, with_windows=True)
    assert int(hops) == 0 and int(windows) == 0
    np.testing.assert_array_equal(host.numpy(), p.msg_host)


@pytest.mark.parametrize("n_hosts,n_msgs,seed", [(1024, 16384, 7),
                                                 (32, 64, 11)])
def test_classes_build_equal_arrays(n_hosts, n_msgs, seed):
    port = tpd.DevicePhold(n_hosts, n_msgs, seed=seed, device="cpu")
    ref = jpd.DevicePhold(n_hosts, n_msgs, seed=seed)
    np.testing.assert_array_equal(port.latency_np, ref.latency_np)
    np.testing.assert_array_equal(port.latency.numpy(), ref.latency_np)
    np.testing.assert_array_equal(port.msg_host, ref.msg_host)
    np.testing.assert_array_equal(port.msg_time, ref.msg_time)
    assert port.msg_host.dtype == ref.msg_host.dtype == np.int32
    assert (port.key_lo, port.key_hi) == (ref.key_lo, ref.key_hi)
