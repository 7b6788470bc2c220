"""csrc/saturate.cu's schedule restated in numpy, on the CPU, held to the JAX
package's ``saturate_run`` and the port's plain version.

The kernel gives each host one thread.  A host whose own values allow it
(0 <= capacity, 0 <= refill, capacity + refill < 2^31, size < 2^31, 0 <=
qcap + 1 < 2^31, ticks < 2^31) takes the narrow path: the flow's active
range [first_tick, first_tick + n_pkts) clipped to [0, ticks] in int64 as
[a, b); the ticks before a skipped (nothing happens there); tokens carried
as the pair (w, r), tokens = w * size + r, refilled by the pair (refill //
size, refill % size) with one carry and capped by a lexicographic compare
against (capacity // size, capacity % size); every word 32 bits; from b on
the loop stops at the first tick that starts with an empty queue (looked
for every four ticks from a, and every tick in the last four); delivered
is the admitted packets less the queue.  Every other host runs the int64
loop of the JAX function.  :func:`restate_host` does the same, step for
step, and says which path a host took and the tick it stopped at.

Held bit for bit (no tolerance: exact integers) on chip_smoke.py's
``saturate_edge_cases``: ranges before 0, at or past ticks, empty or
wrapping; refill 0; capacity below size; refill at or above size (the
queue never builds); qcap 0 and -1; size 1; hosts past the narrow bounds
(capacity or refill >= 2^31, their sum >= 2^31, a negative refill or
capacity, size >= 2^31), each of which takes the int64 path.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import shadow_tpu.ops.saturate_device as jsd
import shadow_tpu_torch.ops.saturate_device as tsd

NARROW = 1 << 31
UNROLL = 4                     # csrc/saturate.cu UNROLL
I32 = (-(1 << 31), (1 << 31) - 1)
CASES = chip_smoke.saturate_edge_cases()
NAMES = [c[0] for c in CASES]


def _wrap64(x: int) -> int:
    return (x + (1 << 63)) % (1 << 64) - (1 << 63)


def _i32(*xs):
    for x in xs:
        assert I32[0] <= x <= I32[1], x


def _narrow(size, ref, cap, qcap, ticks) -> bool:
    return (0 <= cap < NARROW and 0 <= ref < NARROW and cap + ref < NARROW
            and size < NARROW and -1 <= qcap < NARROW - 1
            and ticks < NARROW)


def restate_host(f0, n, size, ref, cap, qcap, ticks):
    """One host as csrc/saturate.cu steps it: (delivered, dropped, queue,
    tokens, path, stop), ``stop`` the tick its loop ended at."""
    f1 = _wrap64(f0 + n)
    if not _narrow(size, ref, cap, qcap, ticks):
        tokens, queue, delivered, dropped, alive = cap, 0, 0, 0, False
        for t in range(ticks):
            arr = int(f0 <= t < f1)
            admit = min(arr, max(qcap + 1 - queue, 0))
            dropped += arr - admit
            queue += admit
            n1 = min(queue, tokens // size)
            queue -= n1
            tokens -= n1 * size
            delivered += n1
            if alive:
                tokens = min(cap, tokens + ref)
                n2 = min(queue, tokens // size)
                queue -= n2
                tokens -= n2 * size
                delivered += n2
            alive = queue > 0
        return delivered, dropped, queue, tokens, "int64", max(ticks, 0)
    end = max(ticks, 0)
    a = min(max(f0, 0), end)
    b = min(max(f1, a), end)
    cw, cr = divmod(cap, size)
    rw, rr = divmod(ref, size)
    q1 = qcap + 1
    w, r, queue, dropped, alive = cw, cr, 0, 0, False

    def tick(arr):
        nonlocal w, r, queue, dropped, alive
        admit = arr and queue < q1
        dropped += arr and not admit
        queue += admit
        n1 = min(queue, w)
        queue -= n1
        w -= n1
        assert min(queue, w) == 0          # so no refill drains nothing
        r2 = r + rr
        assert r2 < (1 << 32)              # a uint32 sum
        carry = r2 >= size
        r2 = r2 - size if carry else r2
        w2 = w + rw + carry
        over = w2 > cw or (w2 == cw and r2 > cr)
        if alive:
            w, r = (cw, cr) if over else (w2, r2)
        n2 = min(queue, w)
        queue -= n2
        w -= n2
        alive = queue > 0
        _i32(w, w2, queue, dropped)

    t = a
    while t <= end - UNROLL:
        if t >= b and queue == 0:
            break
        for u in range(UNROLL):
            tick(t + u < b)
        t += UNROLL
    while t < end:
        if t >= b and queue == 0:
            break
        tick(t < b)
        t += 1
    admitted = (b - a) - dropped
    return admitted - queue, dropped, queue, w * size + r, "narrow", t


def restate(first, npk, size, ref, cap, qcap, ticks):
    rows = [restate_host(int(f), int(n), size, int(rf), int(c), qcap, ticks)
            for f, n, rf, c in zip(first, npk, ref, cap)]
    outs = tuple(np.array([r[i] for r in rows], dtype=np.int64)
                 for i in range(4))
    return outs, [r[4] for r in rows], np.array([r[5] for r in rows])


def _jax(first, npk, size, ref, cap, qcap, ticks):
    out = jsd.saturate_run(jnp.asarray(first), jnp.asarray(npk),
                           jnp.int64(size), jnp.asarray(ref),
                           jnp.asarray(cap), jnp.int64(qcap),
                           jnp.int64(ticks))
    return tuple(np.asarray(o) for o in out)


@pytest.mark.parametrize("case", CASES, ids=NAMES)
def test_restatement_equals_jax_and_plain_version(case):
    name, first, npk, size, ref, cap, qcap, ticks = case
    got, paths, stop = restate(first, npk, size, ref, cap, qcap, ticks)
    want = _jax(first, npk, size, ref, cap, qcap, ticks)
    plain = tsd.saturate_run_torch(*(torch.as_tensor(x) for x in
                                     (first, npk)), size,
                                   torch.as_tensor(ref),
                                   torch.as_tensor(cap), qcap, ticks)
    for g, w, p, what in zip(got, want, plain,
                             ("delivered", "dropped", "queue", "tokens")):
        np.testing.assert_array_equal(g, w, err_msg=f"{name}: {what} vs JAX")
        np.testing.assert_array_equal(g, p.numpy(),
                                      err_msg=f"{name}: {what} vs plain")
    narrow, stepped = chip_smoke.saturate_steps(first, npk, size, ref, cap,
                                                qcap, ticks)
    np.testing.assert_array_equal(narrow, np.array(paths) == "narrow")
    a = np.clip(first, 0, max(ticks, 0))
    np.testing.assert_array_equal(stepped, np.where(narrow, stop - a,
                                                    ticks))


def test_edge_hosts_take_the_path_and_stop_they_should():
    name, first, npk, size, ref, cap, qcap, ticks = CASES[0]
    assert name == "edges" and ticks % UNROLL
    (delivered, dropped, queue, tokens), paths, stop = restate(
        first, npk, size, ref, cap, qcap, ticks)
    # the five hosts past the narrow bounds, and only they, take int64
    assert [i for i, p in enumerate(paths) if p == "int64"] == \
        list(range(16, 21))
    # ranges that are empty in [0, ticks): nothing stepped, initial state
    for i in (1, 2, 3, 4, 5, 6):
        assert stop[i] == np.clip(first[i], 0, ticks)
        assert (delivered[i], dropped[i], queue[i], tokens[i]) == \
            (0, 0, 0, cap[i])
    # a range from before 0 starts at 0
    assert delivered[0] + dropped[0] + queue[0] == 120 - 50
    # refill 0 or capacity under a packet: the queue never empties, the
    # loop runs to ticks
    for i in (7, 9, 10):
        assert stop[i] == ticks and queue[i] > 0
    assert delivered[9] == delivered[10] == 0
    assert delivered[7] == cap[7] // size
    # refill at or above size: the queue never builds, the loop stops in
    # the four ticks after the range
    for i in (11, 12):
        assert queue[i] == 0 and dropped[i] == 0
        b = first[i] + npk[i]
        assert b <= stop[i] < b + UNROLL
    # a range past ticks and a refill just under size: never quiet
    assert stop[13] == ticks and queue[13] > 0


def test_qcap_minus_one_admits_nothing_and_qcap_zero_one():
    by = {c[0]: c for c in CASES}
    _, first, npk, size, ref, cap, qcap, ticks = by["qcap -1"]
    (delivered, dropped, queue, _t), paths, _s = restate(
        first, npk, size, ref, cap, qcap, ticks)
    narrow = np.array(paths) == "narrow"     # a negative capacity drains
    assert not delivered[narrow].any() and not queue[narrow].any()
    assert dropped[0] == 120 - 50
    _, first, npk, size, ref, cap, qcap, ticks = by["qcap 0"]
    (_d, _dr, queue, _t), paths, _s = restate(first, npk, size, ref, cap,
                                              qcap, ticks)
    assert queue[np.array(paths) == "narrow"].max() == 1


def test_size_past_the_narrow_bound_takes_int64_everywhere():
    case = {c[0]: c for c in CASES}["size past 2^31"]
    _out, paths, _stop = restate(*case[1:])
    assert set(paths) == {"int64"}


def test_pair_arithmetic_is_floor_division_on_random_tokens():
    """The (w, r) refill and cap against int64 floor division, on random
    narrow operands at both ends of their range."""
    rng = np.random.default_rng(5)
    for _ in range(2000):
        size = int(rng.choice([1, 2, 999, 1000, 1001, NARROW - 1,
                               int(rng.integers(1, NARROW))]))
        cap = int(rng.integers(0, NARROW))
        ref = int(rng.integers(0, NARROW - cap))
        tokens = int(rng.integers(0, cap + 1))
        w, r = divmod(tokens, size)
        cw, cr = divmod(cap, size)
        rw, rr = divmod(ref, size)
        r2 = r + rr
        carry = r2 >= size
        r2 = r2 - size if carry else r2
        w2 = w + rw + carry
        if w2 > cw or (w2 == cw and r2 > cr):
            w2, r2 = cw, cr
        assert (w2, r2) == divmod(min(cap, tokens + ref), size)


@pytest.mark.parametrize("name", chip_smoke.PAIR_KERNELS)
def test_pairs_harness_reads_the_launch_signature(name):
    """``--pairs-against`` binds another tree's entry points with this
    tree's ctypes argument lists, and refuses a source whose launch
    signature differs: the signature it reads is the wrapper's argument
    list, pointer for pointer and int64 for int64, and an edit shows."""
    import ctypes
    import os
    mod = {"saturate": tsd,
           "admit_sorted": __import__("shadow_tpu_torch.ops.bandwidth",
                                      fromlist=["_ARGTYPES"])}[name]
    with open(os.path.join(os.path.dirname(mod.__file__), "csrc",
                           f"{name}.cu")) as f:
        src = f.read()
    sig = chip_smoke.launch_signature(src, name)
    params = sig.split(", ")
    assert len(params) == len(mod._ARGTYPES)
    for p, t in zip(params, mod._ARGTYPES):
        assert ("void*" in p) == (t is ctypes.c_void_p), p
        assert p.startswith("int64_t ") == (t is ctypes.c_int64), p
    edited = src.replace(f"{name}_launch(", f"{name}_launch(int lanes, ",
                         1)
    assert edited != src
    assert chip_smoke.launch_signature(edited, name) != sig
    assert chip_smoke.launch_signature("", name) is None
