"""The phold kernel's window loop (csrc/phold.cu), re-stated in numpy and
held to the plain versions and the JAX package on the CPU.

The kernel has no CPU mode, so this test re-states its algorithm with its
constants as parameters: per window, passes of ``threads x bits`` messages
(thread ``tid`` tests messages ``base + tid + threads * i``, a mask word of
its ripe ones, the unripe times into a running minimum); in each warp of
``lanes`` threads, an exclusive scan of the mask words' popcounts places
the lanes' ripe messages in the warp's list, which the warp hops in rounds
of ``lanes`` entries, one a lane (the cipher and the latency gather once a
ripe message, the new times into the same minimum); the minimum opens the
next window.  With 4-lane warps nearly every window overflows a round, and
the first (every message ripe at time 0) runs in many.  Two flavours, as
the kernel has them: the whole state in one pass (shared memory,
M <= 18,773 on the card) and several passes (device memory, M > 32,768 on
the card, here cut to small passes).  Held bit-exact (int64, no tolerance)
to ``phold_run_numpy``, ``phold_run_torch`` and the JAX ``phold_run`` on
the final hosts and times, the hops and the windows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import shadow_tpu.ops.phold_device as jpd
import shadow_tpu_torch.ops.phold_device as tpd
from shadow_tpu_torch.core.rng import threefry2x32_np

INT64_MAX = np.iinfo(np.int64).max


def phold_waves(latency, msg_host, msg_time, key_lo, key_hi, horizon, *,
                threads, bits, lanes):
    """csrc/phold.cu's loop in numpy.  Returns (host int32, time int64,
    hops, windows)."""
    lat = np.asarray(latency, dtype=np.int64)
    h = lat.shape[0]
    host = np.asarray(msg_host, dtype=np.int64).copy()
    time = np.asarray(msg_time, dtype=np.int64).copy()
    m = len(time)
    pos_lat = lat[lat > 0]
    lookahead = int(pos_lat.min()) if pos_lat.size else 2 ** 62
    start = int(time.min())
    hops = counter = 0
    thread_of = np.arange(threads)[:, None]
    with np.errstate(over="ignore"):
        while start < horizon:
            end = int(np.int64(start) + np.int64(lookahead))   # int64 wrap
            lo = INT64_MAX
            for base in range(0, m, threads * bits):
                # 1. each thread's mask word, the unripe minimum
                ks = base + thread_of + threads * np.arange(bits)[None, :]
                inside = ks < m
                t = time[np.minimum(ks, m - 1)]
                ripe = inside & (t < end)
                if (inside & ~ripe).any():
                    lo = min(lo, int(t[inside & ~ripe].min()))
                cnt = ripe.sum(axis=1)
                for w0 in range(0, threads, lanes):
                    # 2. the warp's exclusive scan of its lanes' counts
                    wc = cnt[w0:w0 + lanes]
                    pos = np.cumsum(wc) - wc
                    total = int(wc.sum())
                    # 3. its list in rounds of one entry a lane
                    for r0 in range(0, total, lanes):
                        n = min(lanes, total - r0)
                        lst = np.full(n, -1, dtype=np.int64)
                        for lane in np.flatnonzero(wc):
                            p = int(pos[lane])
                            for i in np.flatnonzero(ripe[w0 + lane]):
                                if p >= r0 + lanes:
                                    break
                                if p >= r0:
                                    lst[p - r0] = ks[w0 + lane, i]
                                p += 1
                        assert (lst >= 0).all(), "a list slot left unwritten"
                        src = host[lst]
                        x0, _ = threefry2x32_np(
                            np.uint32(key_lo), np.uint32(key_hi),
                            lst.astype(np.uint32),
                            np.full(n, counter, dtype=np.uint32))
                        kq = (x0 % np.uint32(h - 1)).astype(np.int64)
                        dst = np.where(kq >= src, kq + 1, kq)
                        nt = time[lst] + lat[np.clip(src, 0, h - 1),
                                             np.minimum(dst, h - 1)]
                        time[lst] = nt
                        host[lst] = dst
                        lo = min(lo, int(nt.min()))
                    hops += total
            # 4. the block minimum opens the next window
            start = lo
            counter += 1
    return host.astype(np.int32), time, hops, counter


# (hosts, messages, horizon ns); per case the kernel's own constants
# (threads, bits, lanes) and small ones with 4-lane warps, in one pass and
# in several
CASES = [(32, 64, 2 * 10 ** 9), (64, 2000, 5 * 10 ** 8)]
SHAPES = {
    "kernel (1024 threads x 32, 32 lanes)": (1024, 32, 32),
    "one pass (shared memory), 4 lanes": (64, 32, 4),
    "passes (device memory), 4 lanes": (4, 8, 4),
}


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"{c[0]}x{c[1]}")
def instance(request):
    n_hosts, n_msgs, horizon = request.param
    p = tpd.DevicePhold(n_hosts, n_msgs, seed=n_hosts, device="cpu")
    j = jpd.phold_run(jnp.asarray(p.latency_np), jnp.asarray(p.msg_host),
                      jnp.asarray(p.msg_time),
                      jnp.asarray([p.key_lo, p.key_hi], dtype=jnp.uint32),
                      jnp.int64(horizon))
    plain = tpd.phold_run_torch(p.latency, torch.from_numpy(p.msg_host),
                                torch.from_numpy(p.msg_time),
                                (p.key_lo, p.key_hi), horizon,
                                with_windows=True)
    return p, horizon, j, plain


@pytest.mark.parametrize("shape", SHAPES)
def test_waves_equal_plain_versions_and_jax(instance, shape):
    p, horizon, j, plain = instance
    threads, bits, lanes = SHAPES[shape]
    if shape.startswith("one pass"):
        assert len(p.msg_time) <= threads * bits
    if shape.startswith("passes"):
        assert len(p.msg_time) > threads * bits
    host, time, hops, windows = phold_waves(
        p.latency_np, p.msg_host, p.msg_time, p.key_lo, p.key_hi, horizon,
        threads=threads, bits=bits, lanes=lanes)
    n_host, n_time, n_hops = p.run_numpy(horizon)
    np.testing.assert_array_equal(host, n_host)
    np.testing.assert_array_equal(time, n_time)
    assert hops == n_hops
    np.testing.assert_array_equal(host, plain[0].numpy())
    np.testing.assert_array_equal(time, plain[1].numpy())
    assert hops == int(plain[2]) and windows == int(plain[3])
    np.testing.assert_array_equal(host, np.asarray(j[0]))
    np.testing.assert_array_equal(time, np.asarray(j[1]))
    assert hops == int(j[2])
    # every message ripe in the first window, and windows after it
    assert hops > len(p.msg_time) and windows > 1
