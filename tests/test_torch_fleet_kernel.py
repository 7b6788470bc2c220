"""The fleet plane's batched step in the port, on the CPU, against the JAX
package.

On a ``DeviceTorCells(n_relays=8, n_circuits=24)`` flow table (laid out by
the port's ``build_flows`` as ``test_torch_torcells_cases.toy_instance``
does), W lanes with inputs made by numpy from a seed — lanes at different
spans and injections, a lane halting mid-span while others run on, an idle
fold, and the fleet's inert filler lane — go through the JAX package's
vmapped ``torcells_step_span_flush_batched`` (XLA on the CPU), its numpy
twin, and the port's plain batched version (and its copy of the twin):
all ten outputs bit-exact.  The fleet's padding (``_lane_tables``) and
``_repack_flush`` round trip is held to the unpadded serial step, and the
batched kernel's tiled algorithm (segment restarts inside a node's run,
where the padding flows are each their own segment, and chunk carries) is
re-stated in numpy and held to the plain version and the JAX function on
padded tables.  The kernels themselves run on the card only (marker
``cuda``), there also on a node longer than a tile and a skewed table.
Tolerance: none (int64, exact).
"""

import numpy as np
import pytest
import torch

import shadow_tpu_torch.ops.torcells_device as ttd
from shadow_tpu_torch.fleet import plane as fplane
from test_torch_torcells_cases import (injection, random_state,
                                       skewed_instance, tile_kernel_span,
                                       toy_instance, zero_state)

NAMES = ("t_stop", "queued", "ring", "tokens", "delivered", "target",
         "done_tick", "node_sent", "forwards", "flush")


def _jtd():
    # imported where used: the machine with the card has no JAX, and the
    # cuda case below runs there
    import shadow_tpu.ops.torcells_device as jtd
    return jtd


@pytest.fixture(scope="module")
def inst():
    return toy_instance(n_relays=8, n_circuits=24)


def test_table_is_the_jax_device_torcells(inst):
    ref = _jtd().DeviceTorCells(n_relays=8, n_circuits=24, seed=5,
                                relay_bw_kibps=512, max_latency_ms=20)
    for a, key in zip(inst["tables"][:4], ("flow_node", "flow_lat",
                                           "flow_succ", "seg_start")):
        np.testing.assert_array_equal(a, ref.flows[key])


def _lanes(inst, p=8):
    """(state, inject, inject_target, targets [p], idle) per lane."""
    f, c = inst["f"], inst["c"]
    zero = np.zeros(f, np.int64)
    lanes = []
    for k in (1, 3):   # different injections AND different spans
        inj, inj_t = injection(inst, np.arange(c), 40 * k)
        lanes.append((zero_state(inst), inj, inj_t,
                      np.full(p, 50 * k, np.int64), 0))
    # busy, 8 boundaries: halts at the first boundary after a completion
    lanes.append((random_state(inst, 3, t0=500), zero, zero,
                  500 + 3 * np.arange(1, p + 1), 0))
    # idle fold: banked ticks refill the buckets and clear the ring; an
    # injection lands on the dispatch's base boundary
    inj, inj_t = injection(inst, np.arange(0, c, 2), 17)
    lanes.append((random_state(inst, 4, t0=900), inj, inj_t,
                  900 + 5 * np.arange(1, p + 1), 6))
    return lanes


def _stack(inst, lanes, filler=0):
    """The 19 [W]-leading numpy operands: the lanes, then ``filler``
    copies of the fleet's inert filler lane (its tables from the fleet's
    shape class of these very shapes)."""
    f, h, c, lr = inst["f"], inst["h"], inst["c"], inst["ring_len"]
    p = len(lanes[0][3])
    rows = [(*st, inj, inj_t, tv, np.int64(idle), *inst["tables"])
            for st, inj, inj_t, tv, idle in lanes]
    if filler:
        cls = fplane._ShapeClass(f, h, c, p, lr)
        tables = tuple(t.numpy() for t in cls.filler_tables("cpu")[:7])
        z = np.zeros(f, np.int64)
        row = (np.int64(0), z, np.zeros((lr, f), ttd.RING_DTYPE),
               np.zeros(h, np.int64), z, z, np.full(f, -1, np.int64),
               np.zeros(h, np.int64), z, z, np.zeros(p, np.int64),
               np.int64(0), *tables)
        rows += [row] * filler
    return tuple(np.stack([np.asarray(r[i]) for r in rows])
                 for i in range(19))


def _port(batch, ring_len):
    t = [torch.from_numpy(np.array(a)) for a in batch]
    out = ttd.torcells_step_span_flush_batched(*t, ring_len=ring_len)
    return [o.numpy() for o in out]


def _assert_all_equal(outs, labels):
    for i, name in enumerate(NAMES):
        for lab, o in zip(labels[1:], outs[1:]):
            np.testing.assert_array_equal(
                np.asarray(o[i]), np.asarray(outs[0][i]),
                err_msg=f"{lab} vs {labels[0]}: {name}")


@pytest.mark.parametrize("filler", [0, 4])
def test_batched_step_port_vs_jax_vs_twin(inst, filler):
    """Four real lanes (and the filler rows a W = 8 launch tops up with):
    the port's plain batched version, its numpy twin, and the JAX
    package's vmapped kernel and twin agree bit for bit; lanes end at
    different t_stops (one halts mid-span), the filler never starts."""
    jtd = _jtd()
    lr = inst["ring_len"]
    batch = _stack(inst, _lanes(inst), filler)
    copy = lambda: tuple(np.array(a) for a in batch)  # noqa: E731
    jout = [np.asarray(o) for o in jtd.torcells_step_span_flush_batched(
        *copy(), ring_len=lr)]
    jtwin = jtd.torcells_step_span_batched_numpy(*copy(), ring_len=lr)
    ttwin = ttd.torcells_step_span_batched_numpy(*copy(), ring_len=lr)
    port = _port(batch, lr)
    assert port[2].dtype == np.int32
    _assert_all_equal([jout, port, jtwin, ttwin],
                      ["JAX", "port", "JAX twin", "port twin"])
    t_stop = port[0]
    ends = batch[10][:, -1]
    assert len(set(t_stop[:4].tolist())) == 4      # four different spans
    assert t_stop[2] < ends[2]                     # halted mid-span
    assert (t_stop[4:] == 0).all() and (port[8][4:] == 0).all()
    assert (port[9][:, 2] > 0)[:4].any()           # completions flushed


def test_batched_lane_equals_serial_step(inst):
    """Each lane of the batched plain version equals the serial plain
    step on its own row — the property the fleet's digest gate rides on."""
    lr = inst["ring_len"]
    lanes = _lanes(inst)
    port = _port(_stack(inst, lanes), lr)
    tables = tuple(torch.from_numpy(a) for a in inst["tables"])
    for w, (st, inj, inj_t, tv, idle) in enumerate(lanes):
        s = ttd.torcells_step_window_flush(
            int(st[0]), *(torch.from_numpy(np.array(a)) for a in st[1:]),
            torch.from_numpy(inj), torch.from_numpy(inj_t), tv, idle,
            *tables, ring_len=lr)
        for i, name in enumerate(NAMES):
            np.testing.assert_array_equal(
                port[i][w], np.asarray(s[i]), err_msg=f"lane {w}: {name}")


def _pad_lane(inst, lane, cls):
    """A real lane's operands padded into ``cls`` as the fleet plane
    stages them (zero state rows, done_tick -1, targets repeating)."""
    f, h = inst["f"], inst["h"]
    st, inj, inj_t, tv, idle = lane
    f2, h2 = cls.f2, cls.h2
    pv = fplane._pad_vec
    ring = np.zeros((cls.ring_len, f2), ttd.RING_DTYPE)
    ring[:, :f] = st[2]
    tables, derived = fplane._lane_tables(*inst["tables"], f2, h2, cls.c2,
                                          cls.ring_len)
    return ((st[0], pv(st[1], f2), ring, pv(st[3], h2), pv(st[4], f2),
             pv(st[5], f2), pv(st[6], f2, -1), pv(st[7], h2), pv(inj, f2),
             pv(inj_t, f2), pv(tv, cls.p2, int(tv[-1])), np.int64(idle),
             *tables), derived)


def test_padding_and_repack_round_trip(inst):
    """pad -> batched step -> slice rows and _repack_flush equals the
    unpadded serial step on every output (padding is inert)."""
    f, h, c, lr = inst["f"], inst["h"], inst["c"], inst["ring_len"]
    fp = fplane.FleetPlane(device="cpu")
    cls = fp._class_for(f, h, c, 8, lr)
    assert (cls.f2, cls.h2, cls.c2) == (128, 64, 32) and cls.f2 > f
    lanes = _lanes(inst)
    rows = [_pad_lane(inst, ln, cls)[0] for ln in lanes]
    batch = tuple(np.stack([np.asarray(r[i]) for r in rows])
                  for i in range(19))
    port = _port(batch, lr)
    serial = _port(_stack(inst, lanes), lr)
    for w in range(len(lanes)):
        got = (port[0][w], port[1][w][:f], port[2][w][:, :f],
               port[3][w][:h], port[4][w][:f], port[5][w][:f],
               port[6][w][:f], port[7][w][:h], port[8][w],
               fplane._repack_flush(port[9][w], cls.c2, cls.h2, c, h))
        for i, name in enumerate(NAMES):
            np.testing.assert_array_equal(got[i], serial[i][w],
                                          err_msg=f"lane {w}: {name}")
        # padding rows stayed inert
        assert not port[1][w][f:].any() and not port[4][w][f:].any()
        assert (port[6][w][f:] == -1).all() and not port[2][w][:, f:].any()


@pytest.mark.parametrize("geometry", [(4, 2, 4), (8, 2, 12),
                                      (256, 2, ttd.TILE_FLOWS)],
                         ids=lambda g: "x".join(map(str, g)))
def test_kernel_walk_matches_plain_on_padded_tables(inst, geometry):
    """The batched kernel's tiled algorithm on padded lanes (a node's run
    holds several segments: the padding flows; nodes cross chunks and
    tiles at the small geometries) equals the plain batched version and
    the JAX vmapped step bit for bit."""
    f, h, c, lr = inst["f"], inst["h"], inst["c"], inst["ring_len"]
    threads, fpt, tile_flows = geometry
    # a class with more padding flows than padding nodes, as the sweep's
    # (42,072 over 13,768), so padding nodes pace several segments
    cls = fplane._ShapeClass(256, 64, 32, 8, lr)
    assert cls.f2 - f > 2 * (cls.h2 - h)
    jtd = _jtd()
    for lane in _lanes(inst)[1:4]:
        row, _derived = _pad_lane(inst, lane, cls)
        arr_lat = ttd.arrival_latency(torch.from_numpy(row[13]),
                                      torch.from_numpy(row[14])).numpy()
        node_off, meta, tiles = ttd.span_tile_tables(
            row[12], arr_lat, row[14], row[15], cls.h2, lr, tile_flows)
        # a node whose run holds several segments (padding flows)
        heads = np.bincount(row[12][row[15] == np.arange(cls.f2)],
                            minlength=cls.h2)
        assert (heads > 1).any()
        batch = tuple(np.stack([np.asarray(row[i])]) for i in range(19))
        plain = _port(batch, lr)
        jout = jtd.torcells_step_span_flush_batched(
            *(np.array(a) for a in batch), ring_len=lr)
        got = tile_kernel_span(row[:8], row[8], row[9], row[10], row[11],
                               row[16], row[17], node_off, meta, tiles, lr,
                               threads, fpt)
        for i in range(9):
            np.testing.assert_array_equal(np.asarray(got[i]), plain[i][0],
                                          err_msg=NAMES[i])
            np.testing.assert_array_equal(np.asarray(got[i]),
                                          np.asarray(jout[i])[0],
                                          err_msg=NAMES[i])


def test_lane_span_tables_refuse_bad_tables(inst):
    fn, lat, succ, ss = (np.array(a) for a in inst["tables"][:4])
    h, lr = inst["h"], inst["ring_len"]
    node_off, meta, tiles = ttd.lane_span_tables(fn, lat, succ, ss, h, lr)
    assert node_off[0] == 0 and node_off[-1] == len(fn)
    assert (np.diff(node_off) >= 0).all()
    assert meta.shape == (len(fn), 4) and meta.dtype == np.int32
    np.testing.assert_array_equal(meta[:, 2], ttd.arrival_latency(
        torch.from_numpy(lat), torch.from_numpy(succ)).numpy())
    # every lane of a shape class gets the same tile count: F2 sets it
    cls = fplane._ShapeClass(128, 64, 32, 8, lr)
    f2_tiles = [fplane._lane_tables(*inst["tables"], cls.f2, cls.h2, cls.c2,
                                    lr)[1][2].shape,
                cls.filler_tables("cpu")[9].shape]
    n_tiles = max(1, -(-cls.f2 // ttd.TILE_FLOWS))
    assert f2_tiles[0] == f2_tiles[1] == (n_tiles + 1, 4)
    # a segment spanning two nodes: the node walk could not restate it
    bad = ss.copy()
    j = int(np.flatnonzero(np.diff(fn) != 0)[0]) + 1
    bad[j] = ss[j - 1]
    with pytest.raises(ValueError, match="contiguous run"):
        ttd.lane_span_tables(fn, lat, succ, bad, h, lr)
    with pytest.raises(ValueError, match=r"\[1, ring_len\)"):
        ttd.lane_span_tables(fn, lat, succ, ss, h, int(lat.max()))
    with pytest.raises(ValueError, match="sorted"):
        ttd.lane_span_tables(fn[::-1].copy(), lat, succ, ss, h, lr)


def test_batched_wrappers_refuse_cpu_for_kernels(inst):
    """The span kernel's wrapper takes CUDA tensors only; the batched pack
    and the dispatch take the plain versions on CPU tensors."""
    lr = inst["ring_len"]
    batch = [torch.from_numpy(np.array(a))
             for a in _stack(inst, _lanes(inst)[:1])]
    tables = ttd.BatchedSpanTables.build(batch[12], batch[13], batch[14],
                                         batch[15], inst["h"], lr)
    args = ttd.lane_args(batch[0], batch[11], batch[10], "cpu")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ttd.torcells_span_batched(*batch[1:10], batch[16], batch[17],
                                  batch[18], args, lr, tables)
    assert tuple(args.shape) == (1, 2 + 8)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    from shadow_tpu_torch.ops import _build
    try:
        _build.nvcc_path()
    except RuntimeError as e:
        pytest.skip(f"needs nvcc to build the kernel: {e}")
    return torch.device("cuda", 0)


# the kernels' own chunk is 512 flows: 800 circuits over 4 relays give
# every relay a run of ~600 flows, longer than a tile and a chunk; the
# skewed table has the sweep's shape at a small size
CARD_TABLES = {"long node": (800, 4, 2.0), "skewed": (2000, 150, 1.2)}


@pytest.mark.cuda
@pytest.mark.parametrize("table", ["toy", *CARD_TABLES])
def test_batched_kernels_bit_exact_on_card(inst, dev, table):
    """The batched span and pack kernels against the plain batched version
    on the same card tensors: four lanes plus four filler rows, on the toy
    table, a table with nodes longer than a tile, and a skewed one."""
    if table != "toy":
        inst = skewed_instance(*CARD_TABLES[table])
        longest = int(np.bincount(inst["tables"][0]).max())
        assert table != "long node" or longest > ttd.CHUNK_FLOWS
    lr = inst["ring_len"]
    batch = _stack(inst, _lanes(inst), 4)
    want = _port(batch, lr)
    s0 = ttd.torcells_span_batched.launches
    p0 = ttd.pack_flush_batched.launches
    out = ttd.torcells_step_span_flush_batched(
        *(torch.as_tensor(np.array(a), device=dev) for a in batch),
        ring_len=lr)
    torch.cuda.synchronize()
    assert ttd.torcells_span_batched.launches == s0 + 1
    assert ttd.pack_flush_batched.launches == p0 + 1
    for i, name in enumerate(NAMES):
        np.testing.assert_array_equal(out[i].cpu().numpy(), want[i],
                                      err_msg=name)
