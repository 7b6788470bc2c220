"""The mesh spread over several cards (parallel/mesh/cards.py), held to the
JAX package's mesh on its 8 virtual XLA devices, on the CPU.

* The card entry's schedule restated in numpy (:func:`restate`): each card
  runs its own shards alone for a lookahead window of W ticks, its
  cross-card cells written into an outbox row a tick, landed into their
  ring rows ``(w0 + k) mod L`` before the next window; windows end at the
  targets boundaries, where the halt is the OR over cards.  At W = 1, W
  > 1 (the layout's own), a boundary that cuts a window short with a halt
  on it, an idle fold, a masked leg and 'none', and 8 shards over 2 and 4
  cards: equal to the port's one-card plain mesh and to JAX's
  ``make_mesh_span_flush``, bit for bit.
* The plain over-cards step (``device_mesh(..., cards=[cpu] * k)``) on the
  same cases, against the same.
* The sharded hop over ``[cpu] * k``, batch- and row-sharded, against JAX's
  ``ShardedPacketHopKernel`` (``_make_batch_sharded_2out``,
  ``_make_matrix_sharded_hop_step``); no card's row slice holds all A
  rows.
* The tor config of tests/test_torch_mesh_tor.py at ``--tpu-devices 4``
  over 2 CPU "cards": the JAX run's digest, events and ``mesh.*``.
* The launch helper: with a stand-in launch, every card's launch runs with
  its card current (ops/_build.py ``on_card``), window by window; and
  ``check_tensor`` refuses a tensor on a card that is not current.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from shadow_tpu.ops.round_step import \
    ShardedPacketHopKernel as JShardedPacketHopKernel
from shadow_tpu.parallel.mesh import device_mesh as jdevice_mesh
from shadow_tpu.parallel.mesh import exchange as jex
from shadow_tpu_torch.ops import _build
from shadow_tpu_torch.ops import round_step as trs
from shadow_tpu_torch.ops.torcells_device import (CELL_WIRE_BYTES,
                                                  DeviceTorCells, RING_DTYPE)
from shadow_tpu_torch.parallel.mesh import cards as tcards
from shadow_tpu_torch.parallel.mesh import device_mesh
from shadow_tpu_torch.parallel.mesh import exchange as tex
from shadow_tpu_torch.parallel.mesh import partition as tpart
from shadow_tpu_torch.parallel.mesh.partition import pad_state
from test_torch_scaleout import _Topo

D = 8
CPU = torch.device("cpu")
# (targets, idle) of three chained dispatches: the first injects; the
# second's boundary at 141 cuts a window short at W = 2 (t0 = 40), and a
# completion halts the span there; the third folds 3 idle ticks
DISPATCHES = ((np.array([40]), 0), (np.array([141, 241, 541]), 0),
              (np.array([650, 660, 900]), 3))


@pytest.fixture(scope="module")
def toy():
    kw = dict(n_relays=6, n_circuits=20, seed=5, relay_bw_kibps=512,
              max_latency_ms=20)
    t = DeviceTorCells(device="cpu", **kw)
    fl = t.flows
    lay = tpart.build_mesh_layout(fl["flow_node"], fl["flow_lat"],
                                  fl["flow_succ"], fl["seg_start"],
                                  t.refill, t.capacity, D)
    last_flow = np.flatnonzero(np.asarray(fl["flow_succ"]) < 0)
    queued0 = np.where(np.asarray(fl["flow_stage"]) == 0, 30, 0)
    target0 = np.where(np.asarray(fl["flow_succ"]) < 0, 30, 0)
    fp, hp = len(lay["src"]), len(lay["refill"])
    state0 = (np.zeros(fp, np.int64), np.zeros((t.ring_len, fp), RING_DTYPE),
              lay["capacity"].copy(), np.zeros(fp, np.int64),
              np.zeros(fp, np.int64), np.full(fp, -1, np.int64),
              np.zeros(hp, np.int64))
    zp = np.zeros(fp, np.int64)
    injects = ((pad_state(lay, queued0.astype(np.int64)),
                pad_state(lay, target0.astype(np.int64))), (zp, zp), (zp, zp))
    return {"inst": t, "lay": lay, "last": lay["inv"][last_flow],
            "h": len(t.refill), "L": t.ring_len, "state0": state0,
            "injects": injects}


def _statics(lay):
    return tuple(lay[k] for k in ("flow_node_local", "succ_global",
                                  "seg_start_local", "refill", "capacity",
                                  "arr_lat", "shard_base"))


def _leg_mask(lay, masked):
    return tuple(k % 2 == 0 for k in range(lay["exchange"].legs)) \
        if masked else None


# -- the schedule restated in numpy -----------------------------------------

def restate(lay, ring_len, n_cards, window, t0, state, inject,
            inject_target, targets, idle, mode, leg_mask):
    """The card entry's dispatch in numpy: per card, per window, the
    card's own rows tick by tick (a successor on the card written into the
    card's ring row t mod L, counted into ``cross`` when it is on another
    shard; one on another card written into the outbox row of the tick);
    then every outbox landed into its receiving card's ring rows; at a
    boundary the OR over cards halts.  Returns (t_stop, the 7 state
    arrays, forwards, cross) in the global layout."""
    sched = lay["exchange"]
    pad, hp = int(lay["pad"]), int(lay["h_pad"])
    L = ring_len
    mode, active = tex.resolve_mode(sched, mode, leg_mask)
    succ = np.asarray(lay["succ_global"])
    leg = tex.leg_of_edges(succ, pad, sched)
    shard = np.arange(len(succ)) // pad
    card = shard * n_cards // D
    fed = succ >= 0

    def exchanged(j):
        if shard[j] == shard[succ[j]]:
            return True
        return mode == "fused" or (mode == "ppermute" and leg[j] in active)
    cards = []
    for c in range(n_cards):
        rows = np.flatnonzero(card == c)
        lo = rows[0]
        s0 = shard[lo]
        nodes = slice(s0 * hp, (s0 + len(rows) // pad) * hp)
        node = np.asarray(lay["flow_node_local"])[rows] \
            + (shard[rows] - s0) * hp
        seg = np.asarray(lay["seg_start_local"])[rows] \
            + (shard[rows] - s0) * pad
        ring = state[1][:, rows].astype(np.int64)
        if idle:
            ring[:] = 0
        cap = np.asarray(lay["capacity"])[nodes]
        rf = np.asarray(lay["refill"])[nodes]
        cards.append({
            "rows": rows, "lo": lo, "node": node, "seg": seg,
            "al": np.asarray(lay["arr_lat"])[rows], "last": ~fed[rows],
            "q": state[0][rows] + inject[rows], "ring": ring,
            "tok": np.minimum(cap, state[2][nodes] + rf * idle),
            "dl": state[3][rows].copy(),
            "tg": state[4][rows] + inject_target[rows],
            "dt": state[5][rows].copy(), "ns": state[6][nodes].copy(),
            "cap": cap, "rf": rf, "fwd_sum": 0, "cross": 0, "done": False})
    t = int(t0)
    for w0, w1, at_b in tcards.card_windows(t0, targets, window):
        outbox = []                       # (tick, receiving row, cells)
        for cd in cards:
            f = len(cd["rows"])
            for t in range(w0, w1):
                q = cd["q"] + cd["ring"][(t - cd["al"]) % L, np.arange(f)]
                tok = np.minimum(cd["cap"], cd["tok"] + cd["rf"])
                cells = tok[cd["node"]] // CELL_WIRE_BYTES
                csum = np.cumsum(q)
                base = np.where(cd["seg"] > 0,
                                csum[np.maximum(cd["seg"] - 1, 0)], 0)
                served = np.minimum(np.maximum(cells - (csum - q - base), 0),
                                    q)
                cd["q"] = q - served
                spent = np.zeros(len(tok), np.int64)
                np.add.at(spent, cd["node"], served * CELL_WIRE_BYTES)
                cd["tok"] = tok - spent
                cd["ns"] = cd["ns"] + spent
                cd["dl"] = cd["dl"] + np.where(cd["last"], served, 0)
                newly = cd["last"] & (cd["tg"] > 0) & (cd["dt"] < 0) \
                    & (cd["dl"] >= cd["tg"])
                cd["dt"] = np.where(newly, t, cd["dt"])
                cd["done"] |= bool(newly.any())
                cd["fwd_sum"] += int(served.sum())
                row = np.zeros(f, np.int64)
                for k in np.flatnonzero(~cd["last"]):
                    j = cd["rows"][k]
                    if not exchanged(j):
                        continue
                    v = int(served[k])
                    dst = succ[j]
                    if card[dst] == card[j]:
                        row[dst - cd["lo"]] = v
                        if shard[dst] != shard[j]:
                            cd["cross"] += v
                    else:
                        outbox.append((t, dst, v))
                cd["ring"][t % L] = row
        for t_sent, dst, v in outbox:     # the landing
            cd = cards[card[dst]]
            cd["ring"][t_sent % L, dst - cd["lo"]] = v
            cd["cross"] += v
        t = w1
        if at_b:
            halt = any(cd["done"] for cd in cards)
            for cd in cards:
                cd["done"] = False
            if halt:
                break
    out = [np.concatenate([cd[k] for cd in cards], axis=-1)
           for k in ("q", "ring", "tok", "dl", "tg", "dt", "ns")]
    out[1] = out[1].astype(RING_DTYPE)
    return (t, *out, sum(cd["fwd_sum"] for cd in cards),
            sum(cd["cross"] for cd in cards))


# (cards, max window, mode, leg mask): W = 1 and the layout's own W, 2 and
# 4 cards, the heuristic's fused mode, ppermute with a masked leg, 'none'
CASES = [(2, None, "fused", False), (4, None, "fused", False),
         (2, 1, "ppermute", True), (4, 1, "fused", False),
         (2, None, "none", False)]


@pytest.fixture(scope="module")
def references(toy):
    """The one-card plain mesh's and JAX's outputs of the three chained
    dispatches, per (mode, leg mask)."""
    lay = toy["lay"]
    out = {}
    for mode, masked in {(m, k) for _c, _w, m, k in CASES}:
        lm = _leg_mask(lay, masked)
        tstep = tex.make_mesh_span_flush(
            device_mesh(D, device="cpu"), "flows", toy["L"], lay,
            toy["last"], lay["node_src"], toy["h"], mode=mode, leg_mask=lm)
        jstep = jex.make_mesh_span_flush(
            jdevice_mesh(D, axis_names=("flows",)), "flows", toy["L"], lay,
            toy["last"], lay["node_src"], toy["h"], mode=mode, leg_mask=lm)
        port, ref = [], []
        a = (0,) + tuple(torch.as_tensor(x) for x in toy["state0"])
        b = (np.int64(0),) + tuple(jnp.asarray(x) for x in toy["state0"])
        for (tv, idle), inj in zip(DISPATCHES, toy["injects"]):
            a = tstep(int(a[0]), *a[1:8], torch.as_tensor(inj[0]),
                      torch.as_tensor(inj[1]), tv, idle, *_statics(lay))
            b = jstep(*b[:8], *inj, tv, np.int64(idle), *_statics(lay))
            port.append([np.asarray(x) for x in a])
            ref.append([np.asarray(x) for x in b])
        out[(mode, masked)] = (port, ref)
    return out


@pytest.mark.parametrize("n_cards,window,mode,masked", CASES)
def test_restated_schedule_equals_the_mesh_and_jax(toy, references, n_cards,
                                                   window, mode, masked):
    lay = toy["lay"]
    port, ref = references[(mode, masked)]
    cl = tcards.CardLayout(device_mesh(D, device="cpu",
                                       cards=[CPU] * n_cards), lay)
    w = cl.window if window is None else min(window, cl.window)
    assert w == (1 if window == 1 else 2)      # the toy layout's W is 2
    state, t0 = list(toy["state0"]), 0
    halted = []
    for k, ((tv, idle), inj) in enumerate(zip(DISPATCHES, toy["injects"])):
        got = restate(lay, toy["L"], n_cards, w, t0, state, inj[0], inj[1],
                      tv, idle, mode, _leg_mask(lay, masked))
        for i in range(8):
            np.testing.assert_array_equal(got[i], port[k][i],
                                          err_msg=f"dispatch {k} output {i}")
            np.testing.assert_array_equal(got[i], ref[k][i],
                                          err_msg=f"dispatch {k} output {i}")
        assert got[8] == ref[k][8]
        assert got[9] == ref[k][9][-1]
        halted.append(got[0] < int(tv[-1]))
        state, t0 = list(got[1:8]), got[0]
    if mode == "fused":
        # the second dispatch halts on the boundary that cuts a window
        # short, with cells crossing cards
        assert halted[1] and int(port[1][0]) == 141
        assert ref[1][9][-1] > 0


@pytest.mark.parametrize("n_cards,window,mode,masked", CASES)
def test_plain_over_cards_equals_the_mesh_and_jax(toy, references, n_cards,
                                                  window, mode, masked):
    lay = toy["lay"]
    port, ref = references[(mode, masked)]
    step = tex.make_mesh_span_flush(
        device_mesh(D, device="cpu", cards=["cpu"] * n_cards), "flows",
        toy["L"], lay, toy["last"], lay["node_src"], toy["h"], mode=mode,
        leg_mask=_leg_mask(lay, masked), max_window=window)
    assert step.cards.n_cards == n_cards
    out = (0,) + tuple(torch.as_tensor(x) for x in toy["state0"])
    for k, ((tv, idle), inj) in enumerate(zip(DISPATCHES, toy["injects"])):
        out = step(int(out[0]), *out[1:8], torch.as_tensor(inj[0]),
                   torch.as_tensor(inj[1]), tv, idle, *_statics(lay))
        assert all(isinstance(x, tcards.CardSplit) for x in out[1:8])
        for i in range(10):
            np.testing.assert_array_equal(np.asarray(out[i]), port[k][i],
                                          err_msg=f"dispatch {k} output {i}")
            np.testing.assert_array_equal(np.asarray(out[i]), ref[k][i],
                                          err_msg=f"dispatch {k} output {i}")
    # each card holds its own rows only
    assert [p.shape[-1] for p in out[1].parts] == \
        [hi - lo for lo, hi in step.cards.rows]


def test_windows_cut_at_every_boundary():
    w = tcards.card_windows
    assert w(40, [141, 241, 541], 2)[:2] == [(40, 42, False),
                                             (42, 44, False)]
    assert w(40, [141, 241], 2)[50] == (140, 141, True)
    assert w(40, [141, 241], 2)[51] == (141, 143, False)
    assert w(0, [5, 5, 9], None) == [(0, 5, True), (5, 9, False)]
    assert w(7, [5, 9], 3) == [(7, 9, False)]   # a boundary behind t0
    assert w(9, [9], 1) == []
    plan = tcards.card_launch_plan(40, [42, 44], 1)
    assert [p[0] for p in plan] == [
        tcards.FIRST, tcards.LAND, tcards.LAND | tcards.DECIDE,
        tcards.LAND, tcards.LAST | tcards.LAND]
    assert plan[-1][1:] == (44, 44, (43, 1))


def test_device_mesh_groups_shards_by_card():
    mesh = device_mesh(8, device="cpu", cards=["cpu"] * 3)
    assert mesh.n_cards == 3 and mesh.device == CPU
    assert [mesh.card_of(s) for s in range(8)] == [0, 0, 0, 1, 1, 1, 2, 2]
    assert [list(mesh.shards_of(c)) for c in range(3)] == \
        [[0, 1, 2], [3, 4, 5], [6, 7]]
    assert device_mesh(2, device="cpu", cards=["cpu"] * 5).n_cards == 2
    assert device_mesh(4, device="cpu").n_cards == 1


# -- the sharded hop over cards ---------------------------------------------

A = 37
DROP_KEY = 0xC0FFEE123456789A
BOOTSTRAP_END = 5_000_000_000
BARRIER = 7_000_000_000


@pytest.fixture(scope="module")
def topo():
    rng = np.random.default_rng(17)
    lat = rng.integers(1_000_000, 50_000_000, (A, A)).astype(np.int64)
    rel = rng.uniform(0.0, 1.0, (A, A)).astype(np.float32)
    rel[rng.random((A, A)) < 0.25] = np.float32(1.0)
    return _Topo(lat, rel)


@pytest.mark.parametrize("shard_matrix", [False, True])
@pytest.mark.parametrize("n_dev,n_cards", [(4, 2), (8, 4), (5, 2)])
def test_hop_over_cards_equals_jax(topo, n_dev, n_cards, shard_matrix):
    t = trs.ShardedPacketHopKernel(topo, DROP_KEY, BOOTSTRAP_END, n_dev,
                                   shard_matrix=shard_matrix, device="cpu",
                                   cards=[CPU] * n_cards)
    assert len(t.card_rows) == n_cards and t.latency is None
    if shard_matrix:
        assert len(t.lat_rows) == n_dev
        assert all(r.shape[0] < A for r in t.lat_rows)
        for c, rows in enumerate(t.card_rows):
            assert rows.first == t.mesh.shards_of(c).start
            assert rows.d == len(t.mesh.shards_of(c))
    j = JShardedPacketHopKernel(topo, DROP_KEY, BOOTSTRAP_END, n_dev,
                                shard_matrix=shard_matrix)
    rng = np.random.default_rng(n_dev)
    for n in (300, 5):
        raw = (rng.integers(0, A, n), rng.integers(0, A, n),
               rng.integers(0, 2 ** 63, n).astype(np.uint64),
               rng.integers(BOOTSTRAP_END // 2, 2 * BOOTSTRAP_END, n))
        got = t.step(*raw, BARRIER)
        want = j.step(*raw, BARRIER)
        np.testing.assert_array_equal(got[0], np.asarray(want[0]))
        np.testing.assert_array_equal(got[1], np.asarray(want[1]))


# -- end to end --------------------------------------------------------------

def test_tor_over_two_cards_equals_jax():
    from test_torch_mesh_plane import (assert_equal_runs,
                                       assert_mesh_contract, run)
    from test_torch_mesh_tor import TOR_XML
    port = run("torch", TOR_XML, 60, tpu_devices=4,
               mesh_cards=("cpu", "cpu"))
    plane = port["plane"]
    assert plane._cards is not None and plane._cards.n_cards == 2
    assert isinstance(plane._state[1], tcards.CardSplit)
    assert_mesh_contract(port)
    assert_equal_runs(port, run("jax", TOR_XML, 60, tpu_devices=4))
    assert port["completed"] == 5


# -- the launch helper -------------------------------------------------------

class _Event:
    def record(self, stream=None):
        pass


class _Stream:
    def wait_stream(self, other):
        pass

    def wait_event(self, event):
        pass


def test_every_card_launches_with_its_card_current(toy, monkeypatch):
    """mesh_span_cards's schedule with a stand-in for the card entry (and
    for the flush, which needs a card): each launch runs inside on_card
    with its own card current, the cards' launches window by window, as
    many as the plan has, and the inbox copies between them."""
    lay = toy["lay"]
    n = 4
    step = tex.make_mesh_span_flush(
        device_mesh(D, device="cpu", cards=["cpu"] * n), "flows", toy["L"],
        lay, toy["last"], lay["node_src"], toy["h"], max_window=1)
    cl, tables = step.cards, step.tables
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None:
                        _Stream())
    cl.streams = [_Stream() for _ in range(n)]
    tables.on_cards(cl)
    for dv in tables._dev:
        dv["events"] = (_Event(), _Event())
    seen = []

    def stand_in(c, st, *args):
        flags, w0 = args[8], args[9]
        seen.append((c, _build.current_card(), flags, w0))
        tables.card(c)["outbox"].fill_(c + 1)
    monkeypatch.setattr(tcards, "mesh_span_card", stand_in)
    monkeypatch.setattr(tcards, "mesh_pack_flush",
                        lambda *a, **k: torch.zeros(3, dtype=torch.int64))
    tv = np.array([12, 14])
    state = [cl.split(a, k) for a, k in zip(
        toy["state0"], ("flow", "flow", "node", "flow", "flow", "flow",
                        "node"))]
    zp = cl.split(np.zeros(len(lay["src"]), np.int64))
    tcards.mesh_span_cards(10, state, zp, zp, tv, 0,
                           cl.split(lay["refill"], "node"),
                           cl.split(lay["capacity"], "node"), cl, tables)
    plan = tcards.card_launch_plan(10, tv, tables.window)
    assert len(seen) == len(plan) * n
    for i, (flags, w0, _w1, _p) in enumerate(plan):
        for c in range(n):
            got_c, (slot, card), got_flags, got_w0 = seen[i * n + c]
            assert (got_c, slot, card) == (c, c, CPU)
            assert (got_flags, got_w0) == (flags, w0)
    assert _build.current_card() is None
    # the last windows' copies: card a's segment for b in b's inbox at a
    seg = tables.seg
    half = (len(plan) - 2) & 1
    for b in range(n):
        inbox = tables.card(b)["inbox"][half]
        for a in range(n):
            if a != b:
                assert bool((inbox[a * seg:(a + 1) * seg] == a + 1).all())


def test_check_tensor_refuses_another_card(monkeypatch):
    class OnCard1:
        device = torch.device("cuda", 1)
        dtype = torch.int64
        shape = (4,)

        def is_contiguous(self):
            return True
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(ValueError, match=r"cuda:1.*cuda:0"):
        _build.check_tensor("x", OnCard1(), torch.int64, (4,),
                            torch.device("cuda", 1))
    with _build.on_card(CPU, slot=3):
        assert _build.current_card() == (3, CPU)
    assert _build.current_card() is None


def test_fuzz_mesh_mode_over_cards_equals_one_device():
    """The fuzz runner's mesh mode (the corpus tor spec's, D = 3) over 2
    CPU "cards" gives the digest and events of the same mode on one
    device, and of the spec's base mode."""
    import json
    import os
    from shadow_tpu_torch.fuzz import runner
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "shadow_tpu_torch", "fuzz", "corpus",
        "tor-seed21.json")
    with open(path, encoding="utf-8") as f:
        spec = json.load(f)["spec"]
    modes = {m["name"]: m for m in spec["modes"]}
    over = runner.run_one_mode(spec, modes["mesh"], device="cpu",
                               cards=[CPU, CPU])
    one = runner.run_one_mode(spec, modes["mesh"], device="cpu")
    base = runner.run_one_mode(spec, modes["base"], device="cpu")
    assert over["rc"] == one["rc"] == 0, over["log_tail"]
    assert (over["digest"], over["events"]) == (one["digest"],
                                                one["events"])
    assert over["digest"] == base["digest"]
    assert over["scrape"] == one["scrape"]


def test_card_round_refuses_memory_a_card_cannot_map(monkeypatch):
    """The hop over cards reads and writes each round in page-locked host
    memory through every card's mapping: CardRound refuses memory that is
    not page-locked, and memory that one card does not map, naming the
    buffer and the card."""
    b = 64
    cols = torch.empty(b * trs._ColumnPool.COL_BYTES, dtype=torch.uint8)
    deliver = torch.empty(b, dtype=torch.int64)
    keep = torch.empty(b, dtype=torch.bool)
    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    with pytest.raises(ValueError, match="columns must be contiguous "
                                         "page-locked"):
        trs.CardRound(cols, deliver, keep, cards)
    monkeypatch.setattr(torch.Tensor, "is_pinned", lambda self: True)
    current = []

    class Device:
        def __init__(self, card):
            self.card = card

        def __enter__(self):
            current.append(self.card)

        def __exit__(self, *exc):
            current.pop()

    def query(ptr, kind, dptr):
        mapped = current[-1].index == 0     # card 1 maps nothing
        kind._obj.value = 1 if mapped else 2
        dptr._obj.value = ptr if mapped else None
        return 0
    monkeypatch.setattr(torch.cuda, "device", Device)
    monkeypatch.setattr(_build, "entry", lambda *args: query)
    with pytest.raises(ValueError, match="columns is not page-locked host "
                                         "memory mapped into cuda:1"):
        trs.CardRound(cols, deliver, keep, cards)
    ok = trs.CardRound(cols, deliver, keep, cards[:1])
    assert ok.ptrs == [(cols.data_ptr(), deliver.data_ptr(),
                        keep.data_ptr())]
    assert ok.lane_ptrs(0, 2)[4] == cols.data_ptr() + 16
