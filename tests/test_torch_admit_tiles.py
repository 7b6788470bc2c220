"""csrc/admit_sorted.cu's tiled walk restated in numpy, on the CPU, held to the
JAX package's ``admit_sorted`` and the port's plain version.

A batch of more than ``ADMIT_LANES_MAX`` lanes takes the tiled kernel (a
smaller one the kernel of a thread a lane, which the card tests hold).
The kernel cuts the batch into tiles of ``ADMIT_TILE`` lanes, a block a
tile.  A block of 256 threads loads a span of 4 contiguous lanes a thread
(its tile and a halo of 256 lanes after it) and the 32 lanes before the
tile in one round trip, writes the 0 of each invalid lane of its own
tile, and compacts the span's valid lanes in order (an exclusive sum-scan
of the threads' counts gives each its position; the tile's come first).
If those 32 lanes are all invalid, warp 0 looks on back in device memory
for the last valid lane (32 lanes a step).  A valid tile lane opens a run
when its dst differs from the previous valid lane's (or there is none); a
second sum-scan lists the openers, so a run's packets are a known range
of compacted positions, the tile's last run's reaching into the halo up
to the first lane of another dst; thread p walks runs p, p + 256, ...,
their tables loaded at once.  An invalid lane whose dst differs from the
carried one (the valid lane's before it: a "reset lane", as JAX's scan
has it) marks the compacted position of the next valid lane with its
lane, the last such lane winning, and the walk reloads the run's tick,
tokens and admit from the marked lane before that position's packet (and
before the windows, for a mark at the span's end).  Past the span the last
run goes on over windows of 256 lanes that the block stages, reloading at
reset lanes and skipping the other invalid lanes.  Table rows follow
JAX's indexing (a negative dst counts from the end, then clamps).  A step divides by 10^6 with a multiply-high,
tracks the stick of its admit (the tick it leaves) instead of dividing
it, and takes k = ceil(kneed / ref) from a reciprocal of ref made once
per run where ref < 2^31, kneed + ref - 1 < 2^32 and |start| < 2^62, the
int64 division (and the admit's stick by division) otherwise.
:func:`tiled_admit` does the same, step for step, at any tile size, into
an output that starts as garbage, and counts the writes to every lane:
each is written once.

Held bit for bit (no tolerance: exact integers) on chip_smoke.py's
``admit_edge_cases`` (8,192 lanes: invalid lanes at every tile's first and
last lanes, a whole tile invalid inside a run, a run over three tile
boundaries, an unsorted batch whose dsts come back, refill 0, packets past
2^31 bytes, arrivals below 0 and past 2^62, padding, one host, no valid
lane) and ``admit_carry_case`` (an unsorted batch with invalid lanes of
other dsts, some negative or past H, inside runs) at the kernel's tile and
at tiles of 192 and 24 lanes, where runs cross one or many tiles.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from shadow_tpu.ops.bandwidth import admit_sorted as jax_admit_sorted
from shadow_tpu_torch.ops import bandwidth as bw

LANES = 4                      # csrc/admit_sorted.cu LANES
REFILL = bw.REFILL_NS
GARBAGE = -0x5A5A5A5A5A5A5A5A  # what torch.empty may hold
REFILL_MAGIC = 0x431BDE82D7B634DB  # csrc/admit_sorted.cu REFILL_MAGIC
TILES = (bw.ADMIT_TILE, 192, 24)
CASES = chip_smoke.admit_edge_cases()
NAMES = [c[0] for c in CASES]


def _wrap64(x: int) -> int:
    return (x + (1 << 63)) % (1 << 64) - (1 << 63)


def floor_refill(a: int) -> int:
    """The kernel's floor(a / 10^6): a multiply-high by REFILL_MAGIC on a,
    or on ~a = -a - 1 and complemented, for a < 0."""
    neg = a < 0
    x = ~a if neg else a
    q = (x * REFILL_MAGIC) >> 82
    return ~q if neg else q


def recip(d: int):
    """The kernel's Recip.init: (m, s1, s2) for d in [1, 2^31), m's
    quotient by a double reciprocal, its truncation fixed by one."""
    l = (d - 1).bit_length() if d > 1 else 0      # ceil(log2 d)
    num = ((1 << l) - d) << 32
    q = int(float(num) * (1.0 / float(d)))
    assert abs(q - num // d) <= 1
    if q * d > num:
        q -= 1
    elif (q + 1) * d <= num:
        q += 1
    assert q == num // d
    m = q + 1
    assert 0 < m < (1 << 32)
    return m, min(l, 1), max(l - 1, 0)


def recip_div(rc, u: int) -> int:
    m, s1, s2 = rc
    t = (m * u) >> 32                              # __umulhi
    return (t + ((u - t) >> s1)) >> s2


class Run:
    """One host run's carry, as the kernel's Run."""

    def __init__(self, ref0, cap, tok0, arr0, stats):
        self.ref = max(ref0, 1)
        self.cap = cap
        self.tok = tok0
        self.tick = floor_refill(int(arr0))
        self.prev = 0
        self.pstick = 0
        self.narrow = self.ref < (1 << 31)
        self.klim = (1 << 32) - self.ref
        self.rc = recip(self.ref if self.narrow else 1)
        self.stats = stats

    def reset(self, arr0, tok0):
        """A reset lane: the tick, tokens and admit reload."""
        self.tok = int(tok0)
        self.tick = floor_refill(int(arr0))
        self.prev = 0
        self.pstick = 0
        self.stats["resets"] += 1

    def step(self, size, arr):
        size, arr = int(size), int(arr)
        astick = floor_refill(arr)
        later = arr >= self.prev
        start = arr if later else self.prev
        stick = astick if later else self.pstick
        avail = min(self.cap, _wrap64(self.tok + self.ref
                                      * (stick - self.tick)))
        kneed = max(size - avail, 0)
        fast = (self.narrow and kneed <= self.klim
                and -(1 << 62) < start < (1 << 62))
        if fast:
            u = kneed + self.ref - 1
            assert 0 <= u < (1 << 32)
            k = recip_div(self.rc, u)
        else:
            k = (kneed + self.ref - 1) // self.ref
        self.stats["narrow" if fast else "wide"] += 1
        admit = _wrap64((stick + k) * REFILL) if kneed > 0 else start
        self.tok = min(_wrap64(avail + k * self.ref), self.cap) - size
        self.tick = stick + k if kneed > 0 else stick
        self.pstick = self.tick if fast else floor_refill(admit)
        self.prev = admit
        return admit


def row(d, h: int) -> int:
    """A table row as JAX indexes it (and the kernel's clamp_row)."""
    d = int(d)
    d = d + h if d < 0 else d
    return min(max(d, 0), h - 1)


def tiled_admit(dst, sizes, arrive, valid, tokens0, refill, capacity,
                tile: int):
    """The kernel's blocks, one after another: a block of ``tile // 3``
    threads stages a span of LANES lanes a thread, its tile and a halo of
    a lane a thread.  Returns (admits, stats)."""
    n, h = len(dst), len(refill)
    threads = tile // 3
    assert tile == 3 * threads and (LANES - 1) * threads == tile
    out = np.full(n, GARBAGE, dtype=np.int64)
    writes = np.zeros(n, dtype=np.int64)
    stats = {"narrow": 0, "wide": 0, "runs": 0, "crossed": 0,
             "look_steps": 0, "past_halo": 0, "resets": 0}

    def write(k, x):
        out[k] = x
        writes[k] += 1

    def reset(run, k):
        run.reset(arrive[k], tokens0[row(dst[k], h)])

    def walk(run, d, lanes):
        """A window: reloads at a reset lane, skips the other invalid
        lanes, stops at a valid lane of another dst (True)."""
        for k in lanes:
            if not valid[k]:
                if dst[k] != d:
                    reset(run, k)
                continue
            if dst[k] != d:
                return True
            write(k, run.step(sizes[k], arrive[k]))
        return False

    for t0 in range(0, n, tile):
        count = min(tile, n - t0)
        rest = n - t0 - count
        halo = min(threads, rest)
        v = np.asarray(valid[t0:t0 + count], dtype=bool)
        for k in np.flatnonzero(~v):
            write(t0 + k, 0)
        # the span's valid lanes compacted in order (a thread's LANES lanes
        # get consecutive positions from an exclusive sum-scan of the
        # counts), the tile's first
        span = np.asarray(valid[t0:t0 + count + halo], dtype=bool)
        per_thread = np.add.reduceat(span, np.arange(0, len(span), LANES))
        first = np.r_[0, np.cumsum(per_thread)[:-1]]
        in_span = np.flatnonzero(span)
        assert [first[k // LANES] + int(span[k - k % LANES:k].sum())
                for k in in_span] == list(range(len(in_span)))
        lanes = np.flatnonzero(v)
        if not lanes.size:
            continue
        # warp 0 loaded the 32 lanes before the tile with it; it looks on,
        # 32 a step, only when all of them are invalid
        found, top = -1, t0
        while top > 0:
            stats["look_steps"] += 1
            back = [k for k in range(top - 32, top) if k >= 0 and valid[k]]
            if back:
                found = back[-1]
                break
            top -= 32
        n_tile, n_span = len(lanes), len(in_span)
        c_dst = np.asarray(dst)[t0 + in_span]
        # the valid lane's dst before each compacted position (at 0 the
        # one before the tile, if any): a lane of another dst opens a run
        # if valid, and is a reset lane if not
        prev = np.r_[dst[found] if found >= 0 else 0, c_dst]

        def other(p, d):
            return (p == 0 and found < 0) or d != prev[p]

        opens = np.array([other(p, c_dst[p]) for p in range(n_tile)])
        # a reset lane marks the next valid lane's position (the count of
        # valid span lanes before it; n_span is the span's end) with its
        # span lane, the last one winning (atomicMax); position 0 is never
        # read, so it is not marked; a block with no mark walks without
        # reading them
        before = np.cumsum(np.r_[0, span])
        c_reset = np.full(n_span + 1, -1)
        for k in np.flatnonzero(~span):
            p = int(before[k])
            if p > 0 and other(p, dst[t0 + k]):
                c_reset[p] = max(c_reset[p], k)
        marked = (c_reset >= 0).any()
        # the last run's end: the first halo position of another dst
        ends = [p for p in range(n_tile, n_span) if c_dst[p] != c_dst[p - 1]]
        s_end = ends[0] if ends else n_span
        starts = np.flatnonzero(opens)
        stats["runs"] += len(starts)
        for p, j in enumerate(starts):
            e = starts[p + 1] if p + 1 < len(starts) else s_end
            d = int(c_dst[j])
            run = Run(int(refill[row(d, h)]), int(capacity[row(d, h)]),
                      int(tokens0[row(d, h)]), arrive[t0 + in_span[j]],
                      stats)
            written = writes[t0 + count:].sum()
            for c in range(j, e):
                if marked and c > j and c_reset[c] >= 0:
                    reset(run, t0 + c_reset[c])
                k = t0 + int(in_span[c])
                write(k, run.step(sizes[k], arrive[k]))
            # the tile's last run past the span: over windows of a lane a
            # thread that the block stages
            if e == n_span and rest > halo:
                stats["past_halo"] += 1
                if c_reset[n_span] >= 0:
                    reset(run, t0 + c_reset[n_span])
                w0 = t0 + count + halo
                done = False
                while not done and w0 < n:
                    done = walk(run, d, range(w0, min(w0 + threads, n)))
                    w0 += threads
            stats["crossed"] += writes[t0 + count:].sum() > written
    np.testing.assert_array_equal(writes, 1)
    return out, stats


def _jax(args):
    dst, sizes, arrive, valid, tok0, refill, cap = args
    return np.asarray(jax_admit_sorted(
        jnp.asarray(dst, dtype=jnp.int32), jnp.asarray(sizes),
        jnp.asarray(arrive), jnp.asarray(valid), jnp.asarray(tok0),
        jnp.asarray(refill), jnp.asarray(cap)))


@pytest.mark.parametrize("case", CASES, ids=NAMES)
def test_restatement_equals_jax_and_plain_version(case):
    name, args = case
    want = _jax(args)
    plain = bw.admit_sorted_torch(*(torch.as_tensor(a) for a in args))
    np.testing.assert_array_equal(plain.numpy(), want,
                                  err_msg=f"{name}: plain vs JAX")
    for tile in TILES:
        got, stats = tiled_admit(*args, tile)
        np.testing.assert_array_equal(got, want,
                                      err_msg=f"{name}, tile {tile}")
        runs, crossed, _l = chip_smoke.admit_runs(args[0], args[3], tile)
        assert (stats["runs"], stats["crossed"]) == (runs, crossed), tile
        if tile < bw.ADMIT_TILE and name != "no valid lane":
            assert crossed > 0, tile


def test_invalid_lanes_of_other_dsts_follow_jax():
    """An unsorted batch whose runs hold invalid lanes of other dsts (some
    of them negative or past H): the restatement at every tile size and
    the plain version equal JAX's scan, which reloads a run's tick, tokens
    and admit at each such lane.  The case exercises that: without its
    invalid lanes JAX's admits differ at some valid lanes."""
    (name, args), (_lname, lane_args) = chip_smoke.admit_carry_cases()
    dst, sizes, arrive, valid = args[:4]
    want = _jax(args)
    for a, w in ((args, want), (lane_args, _jax(lane_args))):
        plain = bw.admit_sorted_torch(*(torch.as_tensor(x) for x in a))
        np.testing.assert_array_equal(plain.numpy(), w, err_msg="plain")
    for tile in TILES:
        got, stats = tiled_admit(*args, tile)
        np.testing.assert_array_equal(got, want, err_msg=f"tile {tile}")
        assert stats["resets"] > 0, tile
    vi = np.flatnonzero(valid)
    packed = (dst[vi], sizes[vi], arrive[vi], np.ones(len(vi), dtype=bool),
              *args[4:])
    assert (_jax(packed) != want[vi]).any()
    assert (dst[~valid] < 0).any() and (dst[~valid] >= len(args[5])).any()


def _stats(name: str, tile: int = bw.ADMIT_TILE) -> dict:
    return tiled_admit(*dict(CASES)[name], tile)[1]


def test_edge_cases_reach_the_paths_they_name():
    s = _stats("packets past 2^31 bytes, caps under a packet")
    assert s["wide"] > 0 and s["narrow"] > 0
    assert _stats("arrivals below 0 and past 2^62")["wide"] > 0
    for name in ("one host", "refill 0", "unsorted, dsts that come back"):
        assert _stats(name)["wide"] == 0, name
    # the tile after the invalid one looks back over all of it
    assert _stats("a whole tile invalid inside a run")["look_steps"] \
        >= bw.ADMIT_TILE // 32
    three = _stats("one run over three tile boundaries")
    # all three runs cross a tile edge; the last two (2,100 lanes from
    # lane 1,000, the rest from 3,100) also go past their tiles' halos
    assert three["crossed"] == 3 and three["runs"] == 3
    assert three["past_halo"] == 2
    assert _stats("one host")["crossed"] == 1
    assert _stats("no valid lane")["runs"] == 0


def test_the_edge_batches_take_the_tiles():
    assert all(len(args[0]) == chip_smoke.ADMIT_EDGE_N > bw.ADMIT_LANES_MAX
               for _name, args in CASES)


def test_the_kernel_tile_is_the_sources():
    with open(bw.__file__.replace("bandwidth.py", "csrc/admit_sorted.cu")) \
            as f:
        src = f.read()
    assert "THREADS = 256;" in src and f"LANES = {LANES};" in src \
        and "SPAN = THREADS * LANES;" in src and "HALO = THREADS;" in src \
        and "TILE = SPAN - HALO;" in src
    assert bw.ADMIT_TILE == 256 * LANES - 256
    assert f"LANES_MAX = {bw.ADMIT_LANES_MAX};" in src


def test_refill_division_by_a_multiply_high_is_exact():
    """REFILL_MAGIC = ceil(2^82 / 10^6) with an error of at most 2^18, so
    the multiply-high is floor division for every 64-bit operand."""
    assert REFILL_MAGIC == -(-(1 << 82) // REFILL)
    assert REFILL_MAGIC * REFILL - (1 << 82) <= 1 << 18
    rng = np.random.default_rng(7)
    xs = [0, 1, -1, REFILL, -REFILL, REFILL - 1, -REFILL - 1,
          (1 << 63) - 1, -(1 << 63), (1 << 62), -(1 << 62)] \
        + [int(x) for x in rng.integers(-(1 << 63), (1 << 63) - 1,
                                        size=2000)] \
        + [k * REFILL + e for k in (1 << 40, -(1 << 40), 9223372036854,
                                    -9223372036854) for e in (-1, 0, 1)]
    for x in xs:
        if -(1 << 63) <= x < (1 << 63):
            assert floor_refill(x) == x // REFILL, x


def test_reciprocal_division_is_exact():
    rng = np.random.default_rng(3)
    ds = [1, 2, 3, 5, 7, 1000, 1023, 1024, 1025, (1 << 30) + 1,
          (1 << 31) - 1] + list(rng.integers(1, 1 << 31, size=300))
    for d in ds:
        d = int(d)
        rc = recip(d)
        us = [0, 1, d - 1, d, d + 1, (1 << 32) - 1, (1 << 32) - d,
              ((1 << 32) - 1) // d * d, ((1 << 32) - 1) // d * d - 1] \
            + [int(x) for x in rng.integers(0, 1 << 32, size=50)]
        for u in us:
            if 0 <= u < (1 << 32):
                assert recip_div(rc, u) == u // d, (u, d)
