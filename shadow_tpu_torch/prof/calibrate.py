"""``simprof calibrate``: time the port's hand kernels into a
digest-stamped per-box cost model.

The port's counterpart of the JAX package's ``prof/calibrate.py``, which
times XLA programs; this one times the CUDA kernels the device plane
launches (on ``--device cpu``, their plain versions, so that the whole
path runs without a card).  Each point is the median of ``REPS`` launches
after a warm-up launch, bracketed by CUDA events on the card (the host
clock on the CPU); the kernels update their state in place, so the state
is restored before each launch, outside the bracket.  The exchange
probe's five cases for one D are taken in turns, ``EXCHANGE_REPS``
rounds (:func:`time_interleaved`), since its differences are small beside
a drift of the card's clock.  The spread of every point (min and max)
goes to the status row, not into the model.

* **step kernel vs flows** (:func:`measure_step_kernel`) — the plane's
  dispatch, ``torcells_step_window_flush`` (``torcells_span`` +
  ``pack_flush``), over ``DeviceTorCells`` tables of ``FLOW_POINTS``
  circuits (1,000 to 120,000 flow rows: the tuner engages only where
  ``CostModel.covers`` the plane's flow count, and tor10k dispatches
  100,000), one launch of a whole window per point, per tick;
* **the exchange** (:func:`measure_collectives`) — the JAX package's
  ``shard_map`` microbenchmark of ``ppermute`` / ``all_to_all`` / ``psum``
  has no counterpart on one card, where the D shards' exchange is part of
  ``mesh_span.cu``.  So for D in ``DEVICES`` two tables of
  ``COLLECTIVE_CIRCUITS`` circuits are timed per tick.  The
  chain-partitioned calibration table goes through ``mesh_span`` in its
  ``fused`` and its ``ppermute`` mode, and through ``torcells_span``
  (``single``).  The cross-free table (:func:`_cross_free_instance`: the
  same nodes, latencies and relay load, each circuit kept to one of D
  groups, so D shards and no cross edges) goes through ``mesh_span``
  (``cross_free``) and ``torcells_span`` (``single_cf``).  A mesh tick
  less the single-table tick on the same flows is the mesh's cost beside
  the span work, so the two tables' differences in span work cancel:
  ``psum["Dx2"]`` = cross_free - single_cf (the mesh's per-tick reduction
  and layout cost with nothing to exchange); ``all_to_all
  ["Dx(D*pair_width)"]`` = (fused - single) - psum; and ``ppermute
  ["Dx(w)"]`` the ppermute excess, (ppermute - single) - psum, shared
  among the legs in proportion to their widths (a width that two legs
  share gets one entry, equal for both).  So
  ``CostModel.exchange_tick_us`` gives back (mode - single) for the
  measured schedule.  A difference below zero (noise) is 0 in the table;
  the raw ticks and differences stay in the status row.  Beside them,
  the exchange between cards (:func:`_cards_exchange_case`): the mesh
  over cards (parallel/mesh/cards.py) moves a lookahead window's
  cross-card cells from each card's outbox into the other cards' inboxes;
  one window's copies per mode are timed over the host's distinct cards
  where it has two or more, else over two aliases of the one card (on
  the CPU, two CPU "cards").  The JAX model has no field for it, so it
  goes to the status row only;
* **transfer** (:func:`measure_transfer`) — the plane's own copies: the
  inject upload (a pinned [2, F] buffer to the card) and the flush
  read-back (the card to a pinned buffer, then the host array) at flush
  lengths for 4,096 and 65,536 flows, and the slope ``flush_us_per_mb``;
* **batched step** (:func:`measure_batched_step_kernel`, ``--batched``) —
  ``torcells_step_span_flush_batched`` at W = 1, 2, 4, 8, in the status
  row only.

The parent (:func:`run_calibration`) runs the probes in ONE bounded child
(``python -m shadow_tpu_torch.prof calibrate --child ...``), killed on
overrun, and wraps its measurements with the fingerprint of the platform
it ran on, the git sha and the digest into an atomically written model.
The child checks a wall deadline between probes and marks the model
``truncated`` when it stopped early.  ``--device cuda`` (the default) with
no card fails: it never falls back to the CPU.
"""

from __future__ import annotations

import json
import os
import statistics
import time as _walltime
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

DEVICES = (2, 3, 4, 8)
QUICK_DEVICES = (2, 8)
# step-kernel sweep in CIRCUITS (flow rows = 5x), the JAX package's
# points: the top ones exist so the calibrated range covers tor10k's
# 100,000 flow rows under the 2x slack of CostModel.covers
FLOW_POINTS = (200, 1000, 4000, 12000, 24000)
QUICK_FLOW_POINTS = (200, 2000)
# the exchange probe's table: 60,000 flow rows; 2,000 in quick mode
COLLECTIVE_CIRCUITS = 12000
QUICK_COLLECTIVE_CIRCUITS = 400
REPS = 5                 # timed launches a point (after one warm-up)
EXCHANGE_REPS = 11       # the exchange probe's rounds of its five cases
TRANSFER_REPS = 30
CELLS = 50               # cells queued on each circuit's first stage


def _steps_for(n_circ: int, steps: int) -> int:
    """Scale the timed step count down for large tables (cost per step
    grows ~linearly with flows; the per-step quotient stays accurate with
    fewer, longer steps) — never below 60 steps so launch overhead stays
    amortized out of the quotient."""
    if n_circ <= 4000:
        return steps
    return max(60, steps * 4000 // n_circ)


def _deadline_left(deadline: Optional[float]) -> float:
    if deadline is None:
        return float("inf")
    return deadline - _walltime.monotonic()


def time_launches(launch: Callable[[], object], dev,
                  reset: Callable[[], None] = lambda: None,
                  reps: int = REPS) -> Dict:
    """``launch`` timed ``reps`` times after one warm-up, ``reset``
    before each (outside the timed interval): CUDA events on the card,
    the host clock on the CPU.  Returns {"ms": median, "min_ms", "max_ms"}."""
    return time_interleaved({"": (launch, reset)}, dev, reps)[""]


def time_interleaved(cases: Dict[str, Tuple[Callable[[], object],
                                            Callable[[], None]]], dev,
                     reps: int = REPS) -> Dict[str, Dict]:
    """Each case's (launch, reset) timed as :func:`time_launches` does,
    the cases taken in turns (one warm-up round, then ``reps`` rounds of
    one launch each), so that a drift of the card's clock over the
    measurement falls on every case alike.  Returns {name: {"ms",
    "min_ms", "max_ms"}}."""
    import torch
    times: Dict[str, List[float]] = {name: [] for name in cases}
    cuda = dev.type == "cuda"
    if cuda:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
    for r in range(reps + 1):
        for name, (launch, reset) in cases.items():
            reset()
            if cuda:
                torch.cuda.synchronize(dev)
                e0.record()
                launch()
                e1.record()
                e1.synchronize()
                ms = e0.elapsed_time(e1)
            else:
                t0 = _walltime.perf_counter()
                launch()
                ms = (_walltime.perf_counter() - t0) * 1e3
            if r:
                times[name].append(ms)
    return {name: {"ms": statistics.median(t), "min_ms": min(t),
                   "max_ms": max(t)} for name, t in times.items()}


CALIB_SEED = 11
CALIB_RELAY_KIBPS = 4096
CALIB_MAX_LATENCY_MS = 30


def _instance(n_circ: int, dev, inst=None) -> Dict:
    """The JAX package's calibration table (``DeviceTorCells`` of
    ``n_circ`` circuits, seed 11), or ``inst`` when given, with its
    tensors on ``dev``."""
    import torch
    from ..ops.torcells_device import DeviceTorCells
    if inst is None:
        inst = DeviceTorCells(n_relays=max(8, n_circ // 10),
                              n_circuits=n_circ, seed=CALIB_SEED,
                              relay_bw_kibps=CALIB_RELAY_KIBPS,
                              max_latency_ms=CALIB_MAX_LATENCY_MS,
                              device=str(dev.type))
    fl = inst.flows
    last_flow = np.flatnonzero(fl["flow_succ"] < 0)

    def up(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int64),
                               device=dev)
    return {"inst": inst, "f": inst.n_flows, "h": len(inst.refill),
            "last_flow": last_flow,
            "queued0": (fl["flow_stage"] == 0).astype(np.int64) * CELLS,
            "target0": (fl["flow_succ"] < 0).astype(np.int64) * CELLS,
            "args": tuple(up(a) for a in (
                fl["flow_node"], fl["flow_lat"], fl["flow_succ"],
                fl["seg_start"], inst.refill, inst.capacity, last_flow))}


def _cross_free_instance(n_circ: int, d: int):
    """The calibration table's twin with no cross edges at D = ``d``: the
    same clients, relays, servers, latency matrix and bucket parameters
    (``DeviceTorCells``' draws, seed 11), circuits ``i * d // n_circ`` =
    g taking their guard, middle, exit and server from group g's share of
    the relays and servers, so each circuit's five flows sit on one shard.
    Returns (an instance with ``flows``, ``refill``, ``capacity``,
    ``ring_len``, ``n_flows``; the node -> shard map)."""
    from types import SimpleNamespace
    from ..ops.bandwidth import bucket_params
    from ..ops.torcells_device import build_flows
    n_relays = max(8, n_circ // 10)
    n_clients, n_servers = n_circ, max(1, n_circ // 50)
    h = n_clients + n_relays + n_servers
    rng = np.random.default_rng(CALIB_SEED)
    lat = rng.integers(2, CALIB_MAX_LATENCY_MS, size=(h, h)).astype(np.int64)
    np.fill_diagonal(lat, 1)
    bw = np.full(h, 1 << 20, dtype=np.int64)
    bw[n_clients:n_clients + n_relays] = CALIB_RELAY_KIBPS
    refill, cap = bucket_params(bw)
    relays = np.array_split(np.arange(n_relays), d)
    servers = np.array_split(np.arange(n_servers), d)
    if min(len(r) for r in relays) < 3 or min(len(s) for s in servers) < 1:
        raise ValueError(f"cross-free table: {n_circ} circuits cannot be "
                         f"kept to {d} groups")
    group = np.arange(n_circ) * d // n_circ
    route = np.empty((n_circ, 5), dtype=np.int64)
    route[:, 4] = np.arange(n_circ)
    shard_of = np.empty(h, dtype=np.int64)
    shard_of[:n_clients] = group
    for g in range(d):
        idx = np.flatnonzero(group == g)
        rel, srv = relays[g], servers[g]
        route[idx, 0] = n_clients + n_relays + srv[
            rng.integers(0, len(srv), size=len(idx))]
        picks = rng.random((len(idx), len(rel))).argsort(axis=1)[:, :3]
        route[idx, 1:4] = n_clients + rel[picks]
        shard_of[n_clients + rel] = g
        shard_of[n_clients + n_relays + srv] = g
    inst = SimpleNamespace(
        flows=build_flows(route, lat), refill=refill.astype(np.int64),
        capacity=cap.astype(np.int64), ring_len=CALIB_MAX_LATENCY_MS + 2,
        n_flows=n_circ * 5)
    return inst, shard_of


def _zero_state(f: int, h: int, ring_len: int, capacity, dev) -> tuple:
    """The calibration's starting state (after t): queued, ring, tokens
    (full buckets), delivered, target, done_tick (-1), node_sent."""
    import torch
    from ..ops.torcells_device import RING_TORCH_DTYPE
    z = torch.zeros(f, dtype=torch.int64, device=dev)
    return (z, torch.zeros((ring_len, f), dtype=RING_TORCH_DTYPE,
                           device=dev),
            torch.as_tensor(capacity, device=dev).clone(), z.clone(),
            z.clone(), torch.full((f,), -1, dtype=torch.int64, device=dev),
            torch.zeros(h, dtype=torch.int64, device=dev))


def _restorable(saved: tuple):
    """Live copies of ``saved`` and the reset that copies it back."""
    live = tuple(a.clone() for a in saved)

    def reset():
        for a, b in zip(live, saved):
            a.copy_(b)
    return live, reset


def measure_step_kernel(flow_points, steps: int, deadline: Optional[float],
                        dev) -> Tuple[Dict, List[Dict], bool]:
    """Per-tick cost of the plane's dispatch (span + pack) at
    ``flow_points`` circuits.  Returns ({"points": [{flows,
    us_per_step}]}, the status rows with each point's spread, truncated)."""
    import torch
    from ..ops.torcells_device import SpanTables, torcells_step_window_flush

    points: List[Dict] = []
    status: List[Dict] = []
    truncated = False
    for n_circ in flow_points:
        if _deadline_left(deadline) <= 0:
            truncated = True
            break
        pt_steps = _steps_for(int(n_circ), steps)
        c = _instance(int(n_circ), dev)
        inst, f, h, args = c["inst"], c["f"], c["h"], c["args"]
        live, reset = _restorable(_zero_state(f, h, inst.ring_len,
                                              args[5], dev))
        inject = torch.as_tensor(c["queued0"], device=dev)
        inject_t = torch.as_tensor(c["target0"], device=dev)
        targets = np.array([pt_steps], dtype=np.int64)
        tables = SpanTables(*args[:4], h, inst.ring_len) \
            if dev.type == "cuda" else None

        def launch():
            return torcells_step_window_flush(
                0, *live, inject, inject_t, targets, 0, *args,
                ring_len=inst.ring_len, tables=tables)
        t = time_launches(launch, dev, reset)
        points.append({"flows": int(f),
                       "us_per_step": round(t["ms"] * 1e3 / pt_steps, 3)})
        status.append({"flows": int(f), "steps": pt_steps,
                       "us_per_step": points[-1]["us_per_step"],
                       "min_us_per_step": round(
                           t["min_ms"] * 1e3 / pt_steps, 3),
                       "max_us_per_step": round(
                           t["max_ms"] * 1e3 / pt_steps, 3)})
    return {"points": points}, status, truncated


def _exchange_diffs(ticks: Dict[str, float]) -> Dict[str, float]:
    """The raw differences (us a tick, unclamped) of one D's ticks:
    psum = cross_free - single_cf; all_to_all and ppermute = (mode -
    single) - psum, with psum clamped at 0 as the table holds it."""
    psum = ticks["cross_free"] - ticks["single_cf"]
    base = ticks["single"] + max(psum, 0.0)
    return {"psum": psum, "all_to_all": ticks["fused"] - base,
            "ppermute": ticks["ppermute"] - base}


def _exchange_tables(d: int, ticks: Dict[str, float], pair_width: int,
                     widths: List[int]) -> Dict[str, Dict[str, float]]:
    """The model's per-tick tables for one D from its measured ticks (us)
    (:func:`_exchange_diffs`): psum, all_to_all, and the ppermute excess
    shared among the legs by width.  Noise below zero is 0."""
    diff = _exchange_diffs(ticks)
    psum, a2a, pp = (max(diff[k], 0.0)
                     for k in ("psum", "all_to_all", "ppermute"))
    total_w = max(sum(widths), 1)
    out = {"psum": {f"{d}x2": round(psum, 4)},
           "all_to_all": {f"{d}x{d * max(pair_width, 1)}": round(a2a, 4)},
           "ppermute": {}}
    for w in widths:
        out["ppermute"][f"{d}x{max(int(w), 1)}"] = round(pp * w / total_w,
                                                         4)
    return out


def _single_case(c: Dict, steps: int, dev) -> Tuple[Callable, Callable]:
    """(launch, reset) of ``torcells_span`` on instance ``c``'s unpadded
    flows."""
    import torch
    from ..ops import torcells_device as td
    inst, f, h, args = c["inst"], c["f"], c["h"], c["args"]
    live, reset = _restorable(_zero_state(f, h, inst.ring_len, args[5],
                                          dev))
    inject = torch.as_tensor(c["queued0"], device=dev)
    inject_t = torch.as_tensor(c["target0"], device=dev)
    targets = np.array([steps], dtype=np.int64)
    if dev.type == "cuda":
        tables = td.SpanTables(*args[:4], h, inst.ring_len)

        def single():
            td.torcells_span(0, *live, inject, inject_t, targets, 0, *args,
                             ring_len=inst.ring_len, tables=tables)
    else:
        def single():
            td.torcells_step_span_torch(0, *live, inject, inject_t, targets,
                                        0, *args[:6], inst.ring_len)
    return single, reset


def _mesh_case(c: Dict, lay: dict, mode: str, steps: int,
               dev) -> Tuple[Callable, Callable]:
    """(launch, reset) of ``mesh_span`` in ``mode`` on instance ``c``
    laid out as ``lay`` (``build_mesh_layout``)."""
    import torch
    from ..ops import torcells_device as td
    from ..parallel.mesh import exchange as ex
    from ..parallel.mesh.partition import pad_state
    inst, h = c["inst"], c["h"]
    fp = len(lay["src"])
    statics = tuple(torch.as_tensor(np.ascontiguousarray(lay[k]),
                                    device=dev) for k in (
        "flow_node_local", "succ_global", "seg_start_local", "refill",
        "capacity", "arr_lat", "shard_base"))
    z = torch.zeros(fp, dtype=torch.int64, device=dev)
    live, reset = _restorable((
        z, torch.zeros((inst.ring_len, fp), dtype=td.RING_TORCH_DTYPE,
                       device=dev),
        statics[4].clone(), z.clone(), z.clone(),
        torch.full((fp,), -1, dtype=torch.int64, device=dev),
        torch.zeros(len(lay["refill"]), dtype=torch.int64, device=dev)))
    m_inject, m_inject_t = (torch.as_tensor(pad_state(lay, a, 0), device=dev)
                            for a in (c["queued0"], c["target0"]))
    targets = np.array([steps], dtype=np.int64)
    if dev.type == "cuda":
        mt = ex.MeshTables(lay, inst.ring_len, lay["inv"][c["last_flow"]],
                           lay["node_src"], h, mode, None, dev)

        def launch():
            ex.mesh_span(0, *live, m_inject, m_inject_t, targets, 0,
                         statics[3], statics[4], mt)
    else:
        def launch():
            ex.mesh_span_torch(0, *live, m_inject, m_inject_t, targets, 0,
                               *statics, ring_len=inst.ring_len,
                               schedule=lay["exchange"], mode=mode)
    return launch, reset


def _cards_exchange_case(c: Dict, lay: dict, mode: str, dev
                         ) -> Tuple[Callable, Dict]:
    """(launch, shape) of one lookahead window's exchange over cards in
    ``mode`` on instance ``c`` laid out as ``lay``: each card's outbox
    segment for every other card copied into that card's inbox
    (``Tensor.copy_``, non-blocking, on the source card's current stream),
    then every card synchronised.  The cards: the host's distinct ones
    where it has two or more, else two aliases of ``dev``."""
    import torch
    from ..ops._build import on_card
    from ..parallel.mesh import device_mesh
    from ..parallel.mesh.cards import CardLayout, CardTables
    d = int(lay["n_shards"])
    n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1
    cards = [torch.device("cuda", i) for i in range(min(n_dev, d))] \
        if n_dev >= 2 else [dev, dev]
    cl = CardLayout(device_mesh(d, device=dev, cards=cards), lay)
    tb = CardTables(lay, cl, c["inst"].ring_len,
                    lay["inv"][c["last_flow"]], lay["node_src"], c["h"],
                    mode)
    n, seg = len(cards), tb.seg
    out = [torch.ones(n * seg, dtype=torch.int64, device=x) for x in cards]
    inb = [torch.zeros(n * seg, dtype=torch.int64, device=x) for x in cards]
    phys = list(dict.fromkeys(cards))

    def launch():
        for a, card in enumerate(cards):
            with on_card(card, slot=a):
                for b in range(n):
                    if b != a:
                        inb[b][a * seg:(a + 1) * seg].copy_(
                            out[a][b * seg:(b + 1) * seg], non_blocking=True)
        if dev.type == "cuda":
            for x in phys:
                torch.cuda.synchronize(x)
    shape = {"cards": [str(x) for x in cards], "window": tb.window,
             "pw": tb.pw, "bytes": n * (n - 1) * seg * 8,
             "cross_card_cells_a_tick": tb.cross_card_cells_a_tick}
    return launch, shape


def measure_collectives(devices, n_circ: int, steps: int,
                        deadline: Optional[float], dev
                        ) -> Tuple[Dict, Dict, bool]:
    """Per-tick exchange cost tables {kind: {"DxW": us}} from
    ``mesh_span``'s ticks per mode on the chain-partitioned table and on
    its cross-free twin, each beside ``torcells_span``'s on the same flows
    (module docstring).  Returns (tables, the raw ticks and differences per
    D with their spread, truncated)."""
    from ..parallel.mesh.partition import build_mesh_layout

    out: Dict[str, Dict[str, float]] = {"ppermute": {}, "all_to_all": {},
                                        "psum": {}}
    raw: Dict[str, Dict] = {}
    if _deadline_left(deadline) <= 0:
        return out, raw, True
    c = _instance(int(n_circ), dev)
    inst = c["inst"]

    def per_tick(t):
        return (t["ms"] * 1e3 / steps,
                [round(t[k] * 1e3 / steps, 4) for k in ("min_ms", "max_ms")])

    def layout(inst, d, shard_of=None):
        fl = inst.flows
        return build_mesh_layout(fl["flow_node"], fl["flow_lat"],
                                 fl["flow_succ"], fl["seg_start"],
                                 inst.refill, inst.capacity, int(d),
                                 shard_of_node=shard_of)

    single = _single_case(c, steps, dev)
    truncated = False
    for d in devices:
        if _deadline_left(deadline) <= 0:
            truncated = True
            break
        lay = layout(inst, d)
        sched = lay["exchange"]
        cf_inst, shard_of = _cross_free_instance(int(n_circ), int(d))
        cf = _instance(int(n_circ), dev, inst=cf_inst)
        cf_lay = layout(cf_inst, d, shard_of)
        if cf_lay["exchange"].cross_edges != 0:
            raise AssertionError(f"the cross-free table has "
                                 f"{cf_lay['exchange'].cross_edges} cross "
                                 f"edges at D = {d}")
        cases = {"single": single,
                 "single_cf": _single_case(cf, steps, dev),
                 "cross_free": _mesh_case(cf, cf_lay, "none", steps, dev)}
        for mode in ("fused", "ppermute"):
            cases[mode] = _mesh_case(c, lay, mode, steps, dev)
        timed = {k: per_tick(t) for k, t in time_interleaved(
            cases, dev, EXCHANGE_REPS).items()}
        ticks = {k: v[0] for k, v in timed.items()}
        row: Dict = {"flows_padded": len(lay["src"]),
                     "cross_free_flows_padded": len(cf_lay["src"]),
                     "legs": sched.legs, "cross_edges": sched.cross_edges,
                     "pair_width": sched.pair_width,
                     "widths": [int(w) for w in sched.widths]}
        for k, (us, spread) in timed.items():
            row[f"{k}_us"] = round(us, 4)
            row[f"{k}_spread_us"] = spread
        for kind, table in _exchange_tables(int(d), ticks, sched.pair_width,
                                            list(sched.widths)).items():
            out[kind].update(table)
        row["diff_us"] = {k: round(v, 4)
                          for k, v in _exchange_diffs(ticks).items()}
        # the exchange between cards: one window's copies, by the host
        # clock around copies and synchronisation (median of the rounds)
        cards: Dict = {}
        for mode in ("fused", "ppermute"):
            launch, shape = _cards_exchange_case(c, lay, mode, dev)
            launch()
            walls = []
            for _ in range(EXCHANGE_REPS):
                t0 = _walltime.perf_counter()
                launch()
                walls.append((_walltime.perf_counter() - t0) * 1e6)
            cards[mode] = {**shape,
                           "window_us": round(statistics.median(walls), 3),
                           "min_us": round(min(walls), 3),
                           "max_us": round(max(walls), 3)}
        row["cards_exchange"] = cards
        raw[str(d)] = row
    return out, raw, truncated


def measure_batched_step_kernel(widths=(1, 2, 4, 8), n_circ: int = 1000,
                                steps: int = 200,
                                deadline: Optional[float] = None,
                                dev=None) -> Tuple[Dict, bool]:
    """The fleet plane's width sweep: per-lane per-tick cost of
    ``torcells_step_span_flush_batched`` at widths 1..W.  Reported in the
    calibrate status row ONLY; the stamped model stays the single-lane
    model every consumer is keyed by."""
    import torch
    from ..ops.torcells_device import (BatchedSpanTables,
                                       torcells_step_span_flush_batched)

    c = _instance(int(n_circ), dev)
    inst, f, h = c["inst"], c["f"], c["h"]
    lane = _zero_state(f, h, inst.ring_len, inst.capacity, dev)
    points: List[Dict] = []
    truncated = False
    base_us = None
    for w in widths:
        if _deadline_left(deadline) <= 0:
            truncated = True
            break

        def stack(a):
            return torch.stack([torch.as_tensor(a, device=dev)] * w)
        live, reset = _restorable(tuple(stack(a) for a in lane))
        rest = (stack(c["queued0"]), stack(c["target0"]),
                torch.full((w, 1), steps, dtype=torch.int64, device=dev),
                torch.zeros(w, dtype=torch.int64, device=dev),
                *(stack(a) for a in c["args"]))
        t0 = torch.zeros(w, dtype=torch.int64, device=dev)
        tables = BatchedSpanTables.build(*rest[4:8], h, inst.ring_len) \
            if dev.type == "cuda" else None

        def launch():
            return torcells_step_span_flush_batched(
                t0, *live, *rest, ring_len=inst.ring_len, tables=tables)
        t = time_launches(launch, dev, reset)
        lane_us = t["ms"] * 1e3 / steps / w
        if base_us is None:
            base_us = lane_us
        points.append({"width": int(w), "flows": int(f),
                       "us_per_lane_step": round(lane_us, 3),
                       "min_us_per_lane_step": round(
                           t["min_ms"] * 1e3 / steps / w, 3),
                       "max_us_per_lane_step": round(
                           t["max_ms"] * 1e3 / steps / w, 3),
                       "speedup_vs_serial": round(base_us / lane_us, 2)
                       if lane_us > 0 else 0.0})
    return {"points": points}, truncated


def measure_transfer(dev, reps: int = TRANSFER_REPS, flows: int = 4096,
                     big_flows: int = 65536) -> Tuple[Dict, Dict]:
    """The plane's per-launch copies (host clock, median of ``reps``):
    the inject upload of a [2, flows] pinned buffer to the card, and the
    flush read-back (the card to a pinned buffer, an event, the host
    array) at ``flows`` and ``big_flows`` words, whose slope prices the
    capped flush.  On the CPU the plane copies nothing: the same calls on
    host tensors (``torch.from_numpy``, ``.numpy()``).  Returns (the
    model's transfer table, its status row with the spreads)."""
    import torch
    cuda = dev.type == "cuda"
    host = np.zeros((2, flows), dtype=np.int64)

    def median_us(fn) -> Tuple[float, float, float]:
        fn()
        ts = []
        for _ in range(reps):
            t0 = _walltime.perf_counter()
            fn()
            ts.append((_walltime.perf_counter() - t0) * 1e6)
        return statistics.median(ts), min(ts), max(ts)

    if cuda:
        pin = torch.empty((2, flows), dtype=torch.int64, pin_memory=True)

        def upload():
            pin.numpy()[:] = host
            up = pin.to(dev, non_blocking=True)
            torch.cuda.current_stream(dev).synchronize()
            return up
    else:
        def upload():
            return torch.from_numpy(host[0]), torch.from_numpy(host[1])

    def readback(n: int):
        src = torch.arange(n, dtype=torch.int64, device=dev)
        if not cuda:
            return lambda: src.numpy().copy()
        buf = torch.empty(n, dtype=torch.int64, pin_memory=True)
        ev = torch.cuda.Event()

        def fn():
            buf.copy_(src, non_blocking=True)
            ev.record()
            ev.synchronize()
            return buf.numpy().copy()
        return fn

    up = median_us(upload)
    down = median_us(readback(flows))
    down_big = median_us(readback(big_flows))
    mb = (big_flows - flows) * 8 / 2 ** 20
    slope = max((down_big[0] - down[0]) / mb, 0.0) if mb > 0 else 0.0
    table = {"dispatch_us": round(up[0], 2), "flush_us": round(down[0], 2),
             "flush_us_per_mb": round(slope, 2)}
    status = {"flows": flows, "big_flows": big_flows,
              "dispatch_us": [round(x, 2) for x in up],
              "flush_us": [round(x, 2) for x in down],
              "flush_big_us": [round(x, 2) for x in down_big]}
    return table, status


def calibrate_child(out_path: str, quick: bool, wall_cap_sec: float,
                    devices: Optional[List[int]] = None,
                    batched: bool = False, device: str = "cuda") -> int:
    """The in-subprocess half: run every probe on ``device`` under the
    wall deadline and write raw measurements (+ the status rows,
    truncated flag and wall) as JSON.  Raises on ``cuda`` with no card."""
    from ..device import resolve_device
    dev = resolve_device(device)
    t0 = _walltime.monotonic()
    deadline = t0 + wall_cap_sec if wall_cap_sec > 0 else None
    devs = tuple(devices) if devices else (
        QUICK_DEVICES if quick else DEVICES)
    flow_points = QUICK_FLOW_POINTS if quick else FLOW_POINTS
    steps = 200 if quick else 400
    transfer, transfer_status = measure_transfer(dev)
    step, step_status, trunc_s = measure_step_kernel(flow_points, steps,
                                                     deadline, dev)
    coll, coll_status, trunc_c = measure_collectives(
        devs, QUICK_COLLECTIVE_CIRCUITS if quick else COLLECTIVE_CIRCUITS,
        64 if quick else 256, deadline, dev)
    payload = {
        "collectives": coll,
        "step_kernel": step,
        "transfer": transfer,
        "truncated": bool(trunc_c or trunc_s),
        "status": {"device": str(dev), "step_kernel": step_status,
                   "exchange": coll_status, "transfer": transfer_status},
    }
    if batched:
        fleet, trunc_b = measure_batched_step_kernel(
            n_circ=200 if quick else 1000, steps=100 if quick else 200,
            deadline=deadline, dev=dev)
        fleet["truncated"] = trunc_b
        payload["fleet_batched"] = fleet
    payload["wall_sec"] = round(_walltime.monotonic() - t0, 2)
    tmp = out_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, out_path)
    return 0


def run_calibration(out_path: str, quick: bool = False,
                    wall_cap_sec: float = 600.0,
                    devices: Optional[List[int]] = None,
                    batched: bool = False, device: str = "cuda") -> Dict:
    """Parent orchestration: spawn the bounded child on ``device``, wrap
    its measurements into the stamped model (fingerprinted for that
    platform), write ``out_path`` atomically.  Returns a status row
    ({"ok": bool, ...}); a wedged child is killed and reported, never a
    hang."""
    import subprocess
    import sys
    import tempfile

    from . import model as _model
    from . import repo_root

    t0 = _walltime.monotonic()
    with tempfile.TemporaryDirectory(prefix="simprof-") as td:
        mpath = os.path.join(td, "measurements.json")
        args = [sys.executable, "-m", "shadow_tpu_torch.prof", "calibrate",
                "--child", mpath, "--wall-cap-sec", str(wall_cap_sec),
                "--device", device]
        if quick:
            args.append("--quick")
        if batched:
            args.append("--batched")
        if devices:
            args += ["--devices", ",".join(str(d) for d in devices)]
        env = dict(os.environ)
        env["PYTHONPATH"] = repo_root() + os.pathsep \
            + env.get("PYTHONPATH", "")
        try:
            proc = subprocess.run(
                args, env=env, cwd=repo_root(), capture_output=True,
                text=True, timeout=wall_cap_sec + 120)
        except subprocess.TimeoutExpired:
            return {"ok": False,
                    "reason": f"calibration child exceeded the "
                              f"{wall_cap_sec + 120:.0f}s bound and was "
                              "killed"}
        if proc.returncode != 0 or not os.path.exists(mpath):
            return {"ok": False, "rc": proc.returncode,
                    "reason": "calibration child failed",
                    "tail": (proc.stdout + proc.stderr)[-800:]}
        with open(mpath) as f:
            meas = json.load(f)
    # the fleet width sweep and the spreads ride in the STATUS ROW only —
    # popped before build_model so the stamped model stays the single-lane
    # model its consumers are keyed by
    fleet_batched = meas.pop("fleet_batched", None)
    status = meas.pop("status", {})
    data = _model.build_model(
        meas, wall_sec=_walltime.monotonic() - t0,
        truncated=bool(meas.get("truncated")), device=device)
    save_dir = os.path.dirname(os.path.abspath(out_path))
    if save_dir and not os.path.isdir(save_dir):
        os.makedirs(save_dir, exist_ok=True)
    _model.save_model(out_path, data)
    n_coll = sum(len(t) for t in data["collectives"].values())
    return {"ok": True, "path": out_path,
            **({"fleet_batched": fleet_batched} if fleet_batched else {}),
            "wall_sec": round(_walltime.monotonic() - t0, 1),
            "child_wall_sec": meas.get("wall_sec"),
            "collective_points": n_coll,
            "step_points": len(data["step_kernel"]["points"]),
            "truncated": data["truncated"],
            "collectives": data["collectives"],
            "step_kernel": data["step_kernel"]["points"],
            "transfer": data["transfer"],
            "measured": status,
            "fingerprint": data["fingerprint"],
            "git_sha": data["git_sha"]}
