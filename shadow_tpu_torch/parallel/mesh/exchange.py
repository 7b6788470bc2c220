"""Cross-shard forward exchange: precomputed BvN permutation legs, and the
mesh superwindow step that executes them.

The port's copy of the JAX package's ``parallel/mesh/exchange.py``.  Its
statics (:class:`ExchangeSchedule`, :func:`shard_edge_matrix`,
:func:`build_exchange`, :func:`leg_of_edges`, :func:`choose_exchange_mode`,
:func:`mesh_flush_extra`) are copied unchanged.  Its device program
(``make_mesh_span_raw`` -> ``shard_body`` and ``make_mesh_span_flush`` ->
``step_flush``, a ``shard_map`` over D devices with one ``all_to_all`` or one
``ppermute`` per leg and one ``psum`` a tick) is rewritten in two forms:

* :func:`mesh_span_torch` / :func:`mesh_span_flush_torch` — the plain torch
  version: each shard's tick body on its own slice (the shard axis is the
  leading axis of a ``[D, pad]`` view, so no shard reads another's rows),
  the exchange written out as an explicit slot buffer (the sender gathers
  its served cells into its slots, the buffer is transposed or rotated as
  the collective would move it, the receiver scatter-adds its slots), and
  the ``psum`` of ``[served, newly]`` as a sum over the shard axis;
* :func:`mesh_span` + :func:`mesh_pack_flush` — the wrappers that launch
  the hand-written kernels csrc/mesh_span.cu (all D shards in one
  cooperative launch, a thread per flow over tiles of whole nodes; the
  exchange a real buffer in the card's memory, double-buffered by tick
  parity, one grid sync a tick) and the mesh entry of csrc/pack_flush.cu.

:func:`make_mesh_span_flush` returns the engine-facing step: on CPU tensors
the plain version, on CUDA tensors the two kernels and nothing else.

Exactness argument (the JAX package's): the per-tick greedy bandwidth
allocation is independent ACROSS nodes, so with every node's whole flow
segment on one shard, per-shard segment cumsums are bit-identical to the
global ones.  The only cross-shard dataflow is cell forwarding, and every
flow has exactly one predecessor (circuits are chains), so the per-tick
arrival vector in successor space has exactly one writer per slot —
addition order cannot matter, and any exchange that delivers the same (src
value -> dst slot) pairs is bitwise-equivalent.  So every mode (``fused``,
``ppermute``, ``none``), every superset leg mask, and the single-table span
step on the unpadded layout give the same bits.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import numpy as np
import torch

from ...ops._build import check_tensor as _check
from ...ops._build import entry as _bound
from ...ops.torcells_device import (CELL_WIRE_BYTES, MAX_TARGETS,
                                    RING_TORCH_DTYPE, TILE_FLOWS, flush_len,
                                    flush_scratch, pack_flush_torch,
                                    span_tile_tables)


class ExchangeSchedule:
    """The precomputed cross-shard forward schedule.

    ``offsets[k]`` is leg k's rotation (shard s sends to (s+r) % D);
    ``send_src[k]`` is int64 [D * width_k]: for each sending shard, the
    shard-LOCAL rows whose served cells ride leg k (slot-padded with -1);
    ``recv_dst[k]`` is int64 [D * width_k]: for each RECEIVING shard, the
    shard-local successor rows the same slots scatter into (-1 = padding,
    dropped).  Slot order is ascending sender local row, so sender and
    receiver tables line up by construction.

    Execution fuses the legs: with more than one leg the per-tick
    collective is ONE ``all_to_all`` whose [D, W] slot layout
    (``pair_width``/``a2a_src``/``a2a_dst``) is the superposition of the
    rotation legs — same cells, same slots, one launch (collective-launch
    count is what the per-tick wall buys on any backend); a single-leg
    schedule keeps the bytes-minimal lone ``ppermute``."""

    __slots__ = ("n_shards", "offsets", "widths", "send_src", "recv_dst",
                 "cross_edges", "matrix", "pair_width", "a2a_src",
                 "a2a_dst")

    def __init__(self, n_shards: int, offsets: List[int],
                 widths: List[int], send_src: List[np.ndarray],
                 recv_dst: List[np.ndarray], cross_edges: int,
                 matrix: np.ndarray, pair_width: int,
                 a2a_src: np.ndarray, a2a_dst: np.ndarray):
        self.n_shards = n_shards
        self.offsets = offsets
        self.widths = widths
        self.send_src = send_src
        self.recv_dst = recv_dst
        self.cross_edges = cross_edges
        self.matrix = matrix
        self.pair_width = pair_width
        self.a2a_src = a2a_src
        self.a2a_dst = a2a_dst

    @property
    def legs(self) -> int:
        return len(self.offsets)


def shard_edge_matrix(succ_global: np.ndarray, pad: int,
                      n_shards: int) -> np.ndarray:
    """The static shard-to-shard cell-edge matrix M[s, d]: count of flow
    rows on shard s whose successor lives on shard d != s."""
    succ_global = np.asarray(succ_global, dtype=np.int64)
    rows = np.flatnonzero(succ_global >= 0)
    s_src = rows // pad
    s_dst = succ_global[rows] // pad
    m = np.zeros((n_shards, n_shards), dtype=np.int64)
    cross = s_src != s_dst
    np.add.at(m, (s_src[cross], s_dst[cross]), 1)
    return m


def build_exchange(succ_global: np.ndarray, pad: int,
                   n_shards: int) -> ExchangeSchedule:
    """Decompose the cross-shard successor edges into rotation legs.

    Every entry M[s, d] maps to offset r = (d - s) % D; the used offsets
    (sorted ascending, deterministic) are the legs, each leg's width the
    max edge count any shard contributes at that offset."""
    succ_global = np.asarray(succ_global, dtype=np.int64)
    m = shard_edge_matrix(succ_global, pad, n_shards)
    rows = np.flatnonzero(succ_global >= 0)
    s_src = rows // pad
    s_dst = succ_global[rows] // pad
    cross = rows[s_src != s_dst]
    # per (offset, sending shard): (local src row, receiver local dst row)
    # pairs in ascending src-row order — the slot order BOTH tables use
    by_leg: dict = {}
    for i in cross.tolist():
        s = i // pad
        d = int(succ_global[i]) // pad
        r = (d - s) % n_shards
        by_leg.setdefault(r, {}).setdefault(s, []).append(
            (i - s * pad, int(succ_global[i]) - d * pad))
    offsets = sorted(by_leg)
    widths, send_src, recv_dst = [], [], []
    for r in offsets:
        per_shard = by_leg[r]
        w = max(len(v) for v in per_shard.values())
        snd = np.full(n_shards * w, -1, dtype=np.int64)
        rcv = np.full(n_shards * w, -1, dtype=np.int64)
        for s, pairs in sorted(per_shard.items()):
            d = (s + r) % n_shards
            for k, (src_row, dst_row) in enumerate(pairs):
                snd[s * w + k] = src_row
                rcv[d * w + k] = dst_row
        widths.append(w)
        send_src.append(snd)
        recv_dst.append(rcv)
    # fused all_to_all layout: slot chunk d of sender s carries the
    # (s -> d) edges; receiver m's chunk s scatters sender s's slots.
    # pair_width is the max edge count over ordered shard pairs, so the
    # [D, W] buffer superposes every rotation leg into one collective.
    pair_width = max(1, int(m.max()) if m.size else 1)
    a2a_src = np.full((n_shards, n_shards * pair_width), -1, dtype=np.int64)
    a2a_dst = np.full((n_shards, n_shards * pair_width), -1, dtype=np.int64)
    for r in offsets:
        for s, pairs in sorted(by_leg[r].items()):
            d = (s + r) % n_shards
            for k, (src_row, dst_row) in enumerate(pairs):
                a2a_src[s, d * pair_width + k] = src_row
                a2a_dst[d, s * pair_width + k] = dst_row
    return ExchangeSchedule(n_shards, offsets, widths, send_src, recv_dst,
                            int(len(cross)), m, pair_width,
                            a2a_src.reshape(-1), a2a_dst.reshape(-1))


def leg_of_edges(succ_global: np.ndarray, pad: int,
                 schedule: ExchangeSchedule) -> np.ndarray:
    """Per PADDED flow row: the index of the exchange leg its successor
    edge rides, or -1 (no edge, intra-shard, or padding).  The quiet-tick
    leg mask is built from this: OR each chain's rows' legs into a bitmask
    and a span whose active chains touch only a subset of legs can compile
    the rest out (make_mesh_span_raw's ``leg_mask``)."""
    succ_global = np.asarray(succ_global, dtype=np.int64)
    n_shards = schedule.n_shards
    leg_of = np.full(len(succ_global), -1, dtype=np.int64)
    lut = np.full(n_shards, -1, dtype=np.int64)
    for k, r in enumerate(schedule.offsets):
        lut[r] = k
    rows = np.flatnonzero(succ_global >= 0)
    s_src = rows // pad
    s_dst = succ_global[rows] // pad
    cross = s_src != s_dst
    leg_of[rows[cross]] = lut[(s_dst[cross] - s_src[cross]) % n_shards]
    return leg_of


def choose_exchange_mode(schedule: ExchangeSchedule, model=None,
                         override: str = "auto"
                         ) -> Tuple[str, float, str]:
    """Pick the exchange execution mode for a schedule: ``fused`` (one
    all_to_all over the superposed [D, pair_width] slots), ``ppermute``
    (one collective per rotation leg — lone for a single leg, multi-leg
    otherwise), or ``none`` (no cross-shard edges).

    Returns ``(mode, predicted_tick_us, source)``.  ``source`` says what
    decided: ``static`` (no cross edges), ``forced`` (the
    ``--exchange-mode`` CLI override), ``model`` (the measured per-box
    cost model — cheapest predicted per-tick collective cost
    wins), or ``heuristic`` (no calibration on this box: the original
    rule, fused when multi-leg, lone ppermute otherwise — exactly the
    pre-model behavior, so an uncalibrated box changes nothing).
    ``predicted_tick_us`` is the model's per-tick exchange cost for the
    CHOSEN mode (0.0 without a model) — recorded as
    ``mesh.predicted_us`` so the decision is auditable in every scrape.

    Every candidate delivers the identical (src value -> dst slot)
    pairs, so the choice can only ever change WHICH bit-identical kernel
    runs: digest parity across modes is by construction, and pinned by
    tests/test_simprof.py with the override forced each way."""
    d = schedule.n_shards

    def predicted(mode: str) -> float:
        if model is None:
            return 0.0
        return model.exchange_tick_us(d, mode, schedule.pair_width,
                                      schedule.widths)

    if schedule.legs == 0:
        # cross-free table: no exchange collective, but the mesh kernel
        # still issues the per-tick stats psum — predict THAT, so the
        # audit value (and the window predictor fed from it) is the
        # cost actually paid, not a flattering zero
        return "none", round(predicted("none"), 2), "static"

    if override in ("fused", "ppermute"):
        return override, round(predicted(override), 2), "forced"
    heuristic = "fused" if schedule.legs > 1 else "ppermute"
    if model is None:
        return heuristic, 0.0, "heuristic"
    cost_f, cost_p = predicted("fused"), predicted("ppermute")
    if cost_f == cost_p:
        mode = heuristic            # measured tie: keep the known shape
    else:
        mode = "fused" if cost_f < cost_p else "ppermute"
    return mode, round(min(cost_f, cost_p), 2), "model"



# ---------------------------------------------------------------------------
# The mesh superwindow step: plain torch version
# ---------------------------------------------------------------------------

def resolve_mode(schedule: ExchangeSchedule, mode: Optional[str] = None,
                 leg_mask: Optional[Tuple[bool, ...]] = None
                 ) -> Tuple[str, List[int]]:
    """The exchange mode a step actually runs and its active legs, by the
    JAX package's rules (``make_mesh_span_raw``): ``None`` picks fused for
    several legs, ppermute for one, none for zero; a cross-free schedule or
    an all-masked ``leg_mask`` runs ``none``.  ``leg_mask`` is a static
    per-leg bool tuple; a False leg is not exchanged (legal only when it
    carries zeros; any superset of the needed legs gives the same bits).
    Fused mode exchanges every leg whatever the mask says, as in JAX."""
    if leg_mask is None:
        leg_mask = tuple(True for _ in range(schedule.legs))
    assert len(leg_mask) == schedule.legs, (len(leg_mask), schedule.legs)
    active = [k for k in range(schedule.legs) if leg_mask[k]]
    if mode is None:
        mode = "fused" if schedule.legs > 1 else (
            "ppermute" if schedule.legs == 1 else "none")
    if schedule.legs == 0 or not active:
        mode = "none"
    assert mode in ("fused", "ppermute", "none"), mode
    if mode == "fused":
        active = list(range(schedule.legs))
    elif mode == "none":
        active = []
    return mode, active


def mesh_span_torch(t0, queued, ring, tokens, delivered, target, done_tick,
                    node_sent, inject, inject_target, targets, idle_ticks,
                    flow_node_local, succ_global, seg_start_local, refill,
                    capacity, arr_lat, shard_base, *, ring_len: int,
                    schedule: ExchangeSchedule, mode: Optional[str] = None,
                    leg_mask: Optional[Tuple[bool, ...]] = None):
    """Plain torch version of the JAX package's ``make_mesh_span_raw``
    step.  Every ``[D*pad]`` flow array, ``[D*h_pad]`` node array and the
    ``[L, D*pad]`` ring hold shard s's slice at s*pad (s*h_pad) — the
    global layout of ``P(axis)`` / ``P(None, axis)``.  Returns the 10-tuple
    (t_stop, queued, ring, tokens, delivered, target, done_tick, node_sent,
    forwards, cross) with t_stop, forwards and cross as 0-d int64 tensors.
    Pure: no input is changed."""
    dev = queued.device
    d = schedule.n_shards
    fp = queued.shape[0] // d
    hp = refill.shape[0] // d
    i64 = torch.int64
    size = CELL_WIRE_BYTES
    mode, active = resolve_mode(schedule, mode, leg_mask)

    def rows(a, w):            # the [D, w] per-shard view of a flat array
        return a.reshape(d, w)

    q = rows(queued + inject, fp)
    tg = rows(target + inject_target, fp)
    idle = int(idle_ticks)
    tok = rows(torch.minimum(capacity, tokens + refill * idle), hp)
    ring3 = torch.zeros_like(ring) if idle > 0 else ring.clone()
    ring3 = ring3.reshape(ring_len, d, fp)
    dl = rows(delivered, fp).clone()
    dt = rows(done_tick, fp).clone()
    ns = rows(node_sent, hp).clone()
    node = rows(flow_node_local, fp)
    succ = rows(succ_global, fp)
    seg = rows(seg_start_local, fp)
    rf = rows(refill, hp)
    cap = rows(capacity, hp)
    al = rows(arr_lat, fp)
    base = shard_base.reshape(d, 1)
    is_last = succ < 0
    local_succ = succ - base
    intra = (succ >= 0) & (local_succ >= 0) & (local_succ < fp)
    intra_dst = torch.where(intra, local_succ, torch.zeros_like(local_succ))
    has_base = seg > 0
    base_idx = (seg - 1).clamp(min=0)
    zero = torch.zeros((), dtype=i64, device=dev)
    shard_ix = torch.arange(d, device=dev).reshape(d, 1)
    col_ix = torch.arange(fp, device=dev).reshape(1, fp)
    # the exchange tables, per shard (row s = what shard s sends/receives)
    if mode == "fused":
        pw = schedule.pair_width
        a2a_src = torch.as_tensor(schedule.a2a_src, device=dev).reshape(
            d, d * pw)
        a2a_dst = torch.as_tensor(schedule.a2a_dst, device=dev).reshape(
            d, d * pw)
    legs = [(schedule.offsets[k],
             torch.as_tensor(schedule.send_src[k], device=dev).reshape(d, -1),
             torch.as_tensor(schedule.recv_dst[k], device=dev).reshape(d, -1))
            for k in active] if mode == "ppermute" else []

    def send(fwd, src_tbl):    # each sender gathers its slots' cells
        return torch.where(src_tbl >= 0,
                           fwd.gather(1, src_tbl.clamp(min=0)), zero)

    def receive(v, got, dst_tbl):  # each receiver scatter-adds its slots
        got = torch.where(dst_tbl >= 0, got, zero)
        v.scatter_add_(1, dst_tbl.clamp(min=0), got)
        return got.sum()

    bounds = [int(x) for x in torch.as_tensor(targets).reshape(-1).tolist()]
    end = bounds[-1]
    t = int(t0)
    idx = 0
    span_done = False
    forwards = torch.zeros((), dtype=i64, device=dev)
    cross = torch.zeros((), dtype=i64, device=dev)
    while t < end:
        # -- each shard's tick body, on its own slice
        q = q + ring3[torch.remainder(t - al, ring_len), shard_ix,
                      col_ix].to(i64)
        tok = torch.minimum(cap, tok + rf)
        assert bool((tok >= 0).all()), "mesh span: negative tokens"
        cap_cells = torch.div(tok.gather(1, node), size,
                              rounding_mode="floor")
        csum = torch.cumsum(q, 1)
        before = csum - q - torch.where(has_base, csum.gather(1, base_idx),
                                        zero)
        served = torch.minimum((cap_cells - before).clamp(min=0), q)
        q = q - served
        spent = torch.zeros_like(tok).scatter_add_(1, node, served * size)
        tok = tok - spent
        ns = ns + spent
        dl = dl + torch.where(is_last, served, zero)
        newly = is_last & (tg > 0) & (dt < 0) & (dl >= tg)
        dt = torch.where(newly, torch.full_like(dt, t), dt)
        fwd = torch.where(is_last, zero, served)
        v = torch.zeros_like(q).scatter_add_(
            1, intra_dst, torch.where(intra, fwd, zero))
        # -- the exchange, written out
        if mode == "fused":
            vals = send(fwd, a2a_src)                      # [D, D*pw]
            # all_to_all: receiver m's chunk s is sender s's chunk m
            got = vals.reshape(d, d, pw).transpose(0, 1).reshape(d, d * pw)
            cross = cross + receive(v, got, a2a_dst)
        for r, snd, rcv in legs:
            # ppermute s -> (s + r) % D: receiver m holds sender m - r's
            cross = cross + receive(v, torch.roll(send(fwd, snd), r, 0), rcv)
        ring3[t % ring_len] = v.to(ring.dtype)
        # -- the psum of [served, newly]
        forwards = forwards + served.sum()
        span_done = span_done or bool(newly.any())
        t += 1
        if t == bounds[min(idx, len(bounds) - 1)]:
            idx += 1
            if span_done:
                break
            span_done = False
    return (torch.tensor(t, dtype=i64, device=dev), q.reshape(-1),
            ring3.reshape(ring_len, d * fp), tok.reshape(-1), dl.reshape(-1),
            tg.reshape(-1), dt.reshape(-1), ns.reshape(-1), forwards, cross)


def global_sent_torch(node_sent: torch.Tensor, node_src: torch.Tensor,
                      n_nodes: int) -> torch.Tensor:
    """Padded per-shard node counters -> the global [H] vector (padding
    slots, ``node_src < 0``, dropped; each node lives on one shard)."""
    ok = node_src >= 0
    return torch.zeros(n_nodes, dtype=torch.int64,
                       device=node_sent.device).index_add_(
        0, node_src.clamp(min=0),
        torch.where(ok, node_sent, torch.zeros_like(node_sent)))


def mesh_span_flush_torch(t0, queued, ring, tokens, delivered, target,
                          done_tick, node_sent, inject, inject_target,
                          targets, idle_ticks, flow_node_local, succ_global,
                          seg_start_local, refill, capacity, arr_lat,
                          shard_base, *, ring_len: int,
                          schedule: ExchangeSchedule,
                          last_flow_pad: torch.Tensor,
                          node_src: torch.Tensor, n_nodes: int,
                          mode: Optional[str] = None,
                          leg_mask: Optional[Tuple[bool, ...]] = None,
                          cap_chains: Optional[int] = None,
                          cap_nodes: Optional[int] = None):
    """Plain torch version of the JAX package's ``make_mesh_span_flush``
    step: :func:`mesh_span_torch` and the packed flush of the global view
    (capped by ``cap_chains`` / ``cap_nodes`` as ``pack_flush_torch`` caps
    it) with ONE trailing slot, the window's cross-shard cells, after the
    capped layout.  Returns (t_stop, queued, ring, tokens, delivered,
    target, done_tick, node_sent, forwards, flush)."""
    done_in_last = done_tick[last_flow_pad]
    sent_in = global_sent_torch(node_sent, node_src, n_nodes)
    out = mesh_span_torch(
        t0, queued, ring, tokens, delivered, target, done_tick, node_sent,
        inject, inject_target, targets, idle_ticks, flow_node_local,
        succ_global, seg_start_local, refill, capacity, arr_lat, shard_base,
        ring_len=ring_len, schedule=schedule, mode=mode, leg_mask=leg_mask)
    done_last = out[6][last_flow_pad]
    newly = (done_last >= 0) & (done_in_last < 0)
    flush = pack_flush_torch(out[8], out[4][last_flow_pad].sum(), out[0],
                             newly, done_last,
                             global_sent_torch(out[7], node_src, n_nodes)
                             - sent_in, cap_chains, cap_nodes)
    return (*out[:9], torch.cat([flush, out[9].reshape(1)]))


# ---------------------------------------------------------------------------
# The mesh superwindow step: kernel wrappers
# ---------------------------------------------------------------------------

def exchange_routes(layout: dict, mode: str, active: List[int]):
    """Where each padded row's served cells go, and where each column's
    arrive from, for an exchange ``mode`` and its ``active`` legs
    (:func:`resolve_mode`).  Returns (``send_to`` int64 [D*pad]: -1 a last
    stage, ``0 <= x < D*pad`` the global ring column of an intra-shard
    successor, ``D*pad + k`` slot k of the exchange buffer, -2 a
    cross-shard successor on a leg not exchanged; ``xin`` int32 [D*pad]: the
    slot column j receives through, -2 where j's predecessor is on another
    shard and not exchanged, else -1; the buffer's slot count).  The slot
    numbering follows the JAX schedule: in fused mode sender s's chunk d
    (``a2a_src``) lands in receiver d's chunk s (``a2a_dst``); in ppermute
    mode leg k's sender s slot i lands in receiver (s + r_k) % D's slot i
    (``send_src`` / ``recv_dst``)."""
    sched = layout["exchange"]
    d, pad = int(layout["n_shards"]), int(layout["pad"])
    fp = d * pad
    succ = np.asarray(layout["succ_global"], dtype=np.int64)
    rows = np.arange(fp)
    intra = (succ >= 0) & (succ // pad == rows // pad)
    send_to = np.where(succ < 0, -1, np.where(intra, succ, -2))
    xin = np.full(fp, -1, dtype=np.int32)
    xin[succ[(succ >= 0) & ~intra]] = -2
    xlen = 0
    if mode == "fused":
        pw = sched.pair_width
        chunk = d * pw
        src = np.asarray(sched.a2a_src).reshape(d, chunk)
        dst = np.asarray(sched.a2a_dst).reshape(d, chunk)
        s, k = np.nonzero(src >= 0)
        send_to[s * pad + src[s, k]] = fp + s * chunk + k
        m, k = np.nonzero(dst >= 0)
        sender, i = np.divmod(k, pw)
        xin[m * pad + dst[m, k]] = sender * chunk + m * pw + i
        xlen = d * chunk
    elif mode == "ppermute":
        for leg in active:
            r, w = sched.offsets[leg], sched.widths[leg]
            snd = np.asarray(sched.send_src[leg]).reshape(d, w)
            rcv = np.asarray(sched.recv_dst[leg]).reshape(d, w)
            s, i = np.nonzero(snd >= 0)
            send_to[s * pad + snd[s, i]] = fp + xlen + s * w + i
            m, i = np.nonzero(rcv >= 0)
            xin[m * pad + rcv[m, i]] = xlen + (m - r) % d * w + i
            xlen += d * w
    return send_to, xin, xlen


def mesh_tile_tables(layout: dict, send_to: np.ndarray, ring_len: int,
                     tile_flows: int = TILE_FLOWS,
                     shards: Optional[range] = None):
    """The tile tables of csrc/span_tile.cuh for the padded global layout:
    each shard's rows cut on their own by :func:`span_tile_tables` (so a
    tile never crosses a shard) and the results made global.  Returns
    ``node_off`` int64 [D*h_pad + 1] (global node slot g paces global rows
    ``node_off[g]:node_off[g+1]``; a padding row runs with its shard's last
    node slot), ``meta`` int32 [D*pad, 4] (global node
    slot, ``send_to``, arrival latency, flags) and ``tiles`` int32 [T+1, 4]
    with T = D * ceil(pad / tile_flows).  With ``shards`` (a range of the
    mesh's shards, a card's) the tables cover those shards alone, their
    rows and node slots numbered from the range's first shard."""
    d, pad, hp = (int(layout[k]) for k in ("n_shards", "pad", "h_pad"))
    shards = range(d) if shards is None else shards
    node = np.asarray(layout["flow_node_local"], dtype=np.int64)
    seg = np.asarray(layout["seg_start_local"], dtype=np.int64)
    al = np.asarray(layout["arr_lat"], dtype=np.int64)
    offs, metas, tiles = [], [], []
    for s in shards:
        rows = slice(s * pad, (s + 1) * pad)
        off, meta, tl = span_tile_tables(node[rows], al[rows], send_to[rows],
                                         seg[rows], hp, ring_len, tile_flows)
        ls = s - shards.start
        meta[:, 0] += ls * hp
        tl[:-1, 0] += ls * hp
        tl[:-1, 1] += ls * pad
        offs.append(off[:-1] + ls * pad)
        metas.append(meta)
        tiles.append(tl[:-1])
    n = len(shards)
    tiles.append(np.array([[n * hp, n * pad, 0, 0]], dtype=np.int32))
    return (np.concatenate(offs + [np.array([n * pad])]).astype(np.int64),
            np.concatenate(metas), np.concatenate(tiles))


def check_mesh_layout(layout: dict, ring_len: int) -> None:
    """Refuse a padded layout the mesh kernels cannot run (ValueError):
    each shard's flows sorted by node with every real row's segment its
    node's whole run, every arrival latency in [1, ring_len) where a row
    feeds (0 elsewhere), and padding rows outside every chain."""
    d = int(layout["n_shards"])
    pad = int(layout["pad"])
    hp = int(layout["h_pad"])
    node = np.asarray(layout["flow_node_local"], dtype=np.int64)
    seg = np.asarray(layout["seg_start_local"], dtype=np.int64)
    succ = np.asarray(layout["succ_global"], dtype=np.int64)
    al = np.asarray(layout["arr_lat"], dtype=np.int64)
    keep = np.asarray(layout["keep"], dtype=bool)
    for s in range(d):
        nd = node[s * pad:(s + 1) * pad]
        if np.any(np.diff(nd) < 0) or nd.min() < 0 or nd.max() >= hp:
            raise ValueError(f"mesh_span: shard {s}'s flow_node_local "
                             "must be sorted and in [0, h_pad)")
        off = np.searchsorted(nd, np.arange(hp + 1), side="left")
        real = keep[s * pad:(s + 1) * pad]
        if not np.array_equal(seg[s * pad:(s + 1) * pad][real],
                              off[nd[real]]):
            raise ValueError(f"mesh_span: shard {s}: every real row's "
                             "segment must be its node's whole run")
    has_pred = np.zeros(d * pad, dtype=bool)
    has_pred[succ[succ >= 0]] = True
    if np.any(has_pred & ((al < 1) | (al >= ring_len))) \
            or np.any(~has_pred & (al != 0)):
        raise ValueError("mesh_span: every arrival latency must be in "
                         "[1, ring_len), and 0 where no row feeds")
    if np.any(~keep & ((succ >= 0) | has_pred)):
        raise ValueError("mesh_span: padding rows must be outside "
                         "every chain")


class MeshTables:
    """What the mesh kernels derive from a padded layout and an exchange
    mode, computed and checked once per (layout, mode, leg mask), on the
    kernels' device.

    * ``node_off`` [D*h_pad+1], ``meta`` [D*pad, 4] int32 and ``tiles``
      [T+1, 4] int32: csrc/span_tile.cuh's tables over the global layout
      (:func:`mesh_tile_tables`), each row's destination in ``meta`` as
      :func:`exchange_routes` gives it;
    * ``xin`` [D*pad] int32: the slot each column receives through
      (:func:`exchange_routes`);
    * ``xbuf_len``: the exchange buffer's slots (fused: D*D*pair_width;
      ppermute: the active legs' D*width_k each), ``n_recv`` the slots
      received; the kernel holds two buffers, one a tick parity;
    * ``last_flow_pad`` [C] and ``node_slot`` [H] (global node -> its
      padded slot, -1 for a node on no shard) for the flush.

    A row has at most one successor, so each slot has one writer and each
    receiving column one source: no atomics, and any mode gives the same
    bits."""

    __slots__ = ("n_shards", "pad", "h_pad", "ring_len", "mode",
                 "node_off", "meta", "tiles", "xin", "xbuf_len", "n_recv",
                 "last_flow_pad", "node_slot", "n_nodes", "n_chains")

    def __init__(self, layout: dict, ring_len: int, last_flow_pad,
                 node_src, n_nodes: int, mode: Optional[str] = None,
                 leg_mask: Optional[Tuple[bool, ...]] = None,
                 device="cpu"):
        sched = layout["exchange"]
        d = int(layout["n_shards"])
        pad = int(layout["pad"])
        hp = int(layout["h_pad"])
        fp = d * pad
        mode, active = resolve_mode(sched, mode, leg_mask)
        check_mesh_layout(layout, ring_len)
        send_to, xin, xlen = exchange_routes(layout, mode, active)
        if ring_len * fp >= 2 ** 31 or fp + xlen >= 2 ** 31:
            raise ValueError(f"mesh_span: F = {fp}, L = {ring_len} and "
                             f"{xlen} slots overflow the kernel's 32-bit "
                             "offsets")
        node_off, meta, tiles = mesh_tile_tables(layout, send_to, ring_len)
        nsrc = np.asarray(node_src, dtype=np.int64)
        node_slot = np.full(n_nodes, -1, dtype=np.int64)
        ok = np.flatnonzero(nsrc >= 0)
        node_slot[nsrc[ok]] = ok
        dev = device if isinstance(device, torch.device) \
            else torch.device(device)

        def up(a):
            return torch.as_tensor(np.ascontiguousarray(a), device=dev)

        self.n_shards, self.pad, self.h_pad = d, pad, hp
        self.ring_len = int(ring_len)
        self.mode = mode
        self.node_off = up(node_off)
        self.meta = up(meta)
        self.tiles = up(tiles)
        self.xin = up(xin)
        self.xbuf_len = max(int(xlen), 1)
        self.n_recv = int((xin >= 0).sum())
        self.last_flow_pad = up(np.asarray(last_flow_pad, dtype=np.int64))
        self.node_slot = up(node_slot)
        self.n_nodes = int(n_nodes)
        self.n_chains = int(len(np.asarray(last_flow_pad)))


_VP = ctypes.c_void_p
_I64 = ctypes.c_int64
_MESH_ARGTYPES = ([_VP] * 20 + [_I64] * 8 + [ctypes.c_int, _VP, _VP])
_MESH_PACK_ARGTYPES = [_VP] * 11 + [_I64] * 4 + [_VP, _I64, _VP]


def mesh_span(t0, queued, ring, tokens, delivered, target, done_tick,
              node_sent, inject, inject_target, targets, idle_ticks, refill,
              capacity, tables: MeshTables):
    """Launch csrc/mesh_span.cu on CUDA tensors: the superwindow of all D
    shards in one cooperative launch on the current stream, no
    synchronisation; the carried state (global padded layout) is updated
    in place.  Returns (the 9-tuple of the step with t_stop and forwards
    as 0-d device tensors, (cross 0-d, done_in [C], sent_in [D*h_pad])):
    the flush kernel's inputs.  Counts ``mesh_span.launches``."""
    dev = queued.device
    if dev.type != "cuda":
        raise ValueError(f"mesh_span: needs CUDA tensors, got {dev}")
    d, pad, hp = tables.n_shards, tables.pad, tables.h_pad
    fp, hh, c = d * pad, d * hp, tables.n_chains
    i64 = torch.int64
    for name, t, shape in (("queued", queued, (fp,)),
                           ("tokens", tokens, (hh,)),
                           ("delivered", delivered, (fp,)),
                           ("target", target, (fp,)),
                           ("done_tick", done_tick, (fp,)),
                           ("node_sent", node_sent, (hh,)),
                           ("inject", inject, (fp,)),
                           ("inject_target", inject_target, (fp,)),
                           ("refill", refill, (hh,)),
                           ("capacity", capacity, (hh,))):
        _check(f"mesh_span: {name}", t, i64, shape, dev)
    _check("mesh_span: ring", ring, RING_TORCH_DTYPE,
           (tables.ring_len, fp), dev)
    if tables.meta.device != dev:
        raise ValueError(f"mesh_span: tables on {tables.meta.device}, "
                         f"state on {dev}")
    tv = np.asarray(targets.cpu() if torch.is_tensor(targets) else targets,
                    dtype=np.int64).reshape(-1)
    if not 1 <= len(tv) <= MAX_TARGETS:
        raise ValueError(f"mesh_span: 1 to {MAX_TARGETS} targets, got "
                         f"{len(tv)}")
    # [0] t_stop, [1] forwards, [2] cross, [3:6] the per-tick completion
    # flags; the kernel initialises all six
    scalars = torch.empty(6, dtype=i64, device=dev)
    done_in = torch.empty(c, dtype=i64, device=dev)
    sent_in = torch.empty(hh, dtype=i64, device=dev)
    xbuf = torch.empty(2 * tables.xbuf_len, dtype=i64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    tv = np.ascontiguousarray(tv)
    rc = _bound("mesh_span", "mesh_span_launch", _MESH_ARGTYPES)(
        queued.data_ptr(), ring.data_ptr(), tokens.data_ptr(),
        delivered.data_ptr(), target.data_ptr(), done_tick.data_ptr(),
        node_sent.data_ptr(), inject.data_ptr(), inject_target.data_ptr(),
        tables.meta.data_ptr(), tables.tiles.data_ptr(),
        tables.node_off.data_ptr(), tables.xin.data_ptr(),
        refill.data_ptr(), capacity.data_ptr(),
        tables.last_flow_pad.data_ptr(), scalars.data_ptr(),
        done_in.data_ptr(), sent_in.data_ptr(), xbuf.data_ptr(), fp, hh, c,
        len(tables.tiles) - 1, tables.ring_len, int(t0), int(idle_ticks),
        tables.xbuf_len, len(tv), tv.ctypes.data, stream)
    if rc != 0:
        raise RuntimeError(f"mesh_span kernel launch failed: CUDA error {rc} "
                           f"(D={d}, pad={pad}, h_pad={hp}, "
                           f"L={tables.ring_len})")
    mesh_span.launches += 1
    state = (scalars[0], queued, ring, tokens, delivered, target, done_tick,
             node_sent, scalars[1])
    return state, (scalars[2], done_in, sent_in)


mesh_span.launches = 0


def mesh_pack_flush(t_stop, forwards, cross, done_tick, delivered,
                    node_sent, done_in, sent_in, tables: MeshTables,
                    cap_chains: Optional[int] = None,
                    cap_nodes: Optional[int] = None) -> torch.Tensor:
    """Launch the mesh entry of csrc/pack_flush.cu on CUDA tensors (one
    cooperative launch, current stream, no synchronisation): the packed
    flush of the global view — chains through ``last_flow_pad``, nodes
    through ``node_slot`` — capped as the serial entry caps it (None: the
    full length), with the trailing cross-shard slot after it.
    ``t_stop``, ``forwards`` and ``cross`` are 0-d int64 tensors on the
    card (the span kernel's outputs).  Counts ``mesh_pack_flush.launches``,
    and ``mesh_pack_flush.capped_launches`` too when a cap is below its
    count."""
    dev = done_tick.device
    if dev.type != "cuda":
        raise ValueError(f"mesh_pack_flush: needs CUDA tensors, got {dev}")
    d, pad, hp = tables.n_shards, tables.pad, tables.h_pad
    c, h = tables.n_chains, tables.n_nodes
    i64 = torch.int64
    for name, t, shape in (("t_stop", t_stop, ()), ("forwards", forwards, ()),
                           ("cross", cross, ()),
                           ("done_tick", done_tick, (d * pad,)),
                           ("delivered", delivered, (d * pad,)),
                           ("node_sent", node_sent, (d * hp,)),
                           ("done_in", done_in, (c,)),
                           ("sent_in", sent_in, (d * hp,))):
        _check(f"mesh_pack_flush: {name}", t, i64, shape, dev)
    cc = c if cap_chains is None else min(int(cap_chains), c)
    hh = h if cap_nodes is None else min(int(cap_nodes), h)
    buf = torch.empty(flush_len(c, h, cap_chains, cap_nodes) + 1, dtype=i64,
                      device=dev)
    scratch, tiles = flush_scratch(1, c, h, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _bound("pack_flush", "pack_flush_mesh_launch", _MESH_PACK_ARGTYPES)(
        t_stop.data_ptr(), forwards.data_ptr(), cross.data_ptr(),
        done_tick.data_ptr(), delivered.data_ptr(), node_sent.data_ptr(),
        done_in.data_ptr(), sent_in.data_ptr(), buf.data_ptr(),
        tables.last_flow_pad.data_ptr(), tables.node_slot.data_ptr(), c, h,
        cc, hh, scratch.data_ptr(), tiles, stream)
    if rc != 0:
        raise RuntimeError(f"pack_flush mesh kernel launch failed: CUDA "
                           f"error {rc} (C={c}, H={h})")
    mesh_pack_flush.launches += 1
    if cc < c or hh < h:
        mesh_pack_flush.capped_launches += 1
    return buf


mesh_pack_flush.launches = 0
mesh_pack_flush.capped_launches = 0


def _as_tensor(a, device) -> torch.Tensor:
    if torch.is_tensor(a):
        return a
    return torch.as_tensor(np.ascontiguousarray(np.asarray(a)),
                           device=device)


def make_mesh_span_flush(mesh, axis: str, ring_len: int, layout: dict,
                         last_flow_pad: np.ndarray, node_src: np.ndarray,
                         n_nodes: int, mode: Optional[str] = None,
                         leg_mask: Optional[Tuple[bool, ...]] = None,
                         cap_chains: Optional[int] = None,
                         cap_nodes: Optional[int] = None,
                         card_layout=None, max_window: Optional[int] = None):
    """Mesh superwindow step + packed flush in ONE dispatch: the engine's
    sharded step (DeviceTrafficPlane._sharded_step contract — the JAX
    package's argument list and 10-tuple; the flush grows ONE trailing
    slot, the window's cross-shard cells).  ``mode`` picks the exchange
    (choose_exchange_mode; None = the heuristic), ``leg_mask`` leaves quiet
    legs out, and the caps pick the capped flush layout, as the JAX
    package's ``cap_chains`` / ``cap_nodes`` do (:func:`mesh_flush_extra`
    reads the trailing slot after it).  The plane passes its tuner's caps,
    which it turns off before it shards (parallel/device_plane.py), so no
    run packs a capped mesh flush: the caps are there for parity with the
    JAX function.  On CPU tensors the step runs
    :func:`mesh_span_flush_torch`; on CUDA tensors one launch of
    csrc/mesh_span.cu and one of the mesh entry of csrc/pack_flush.cu on
    the current stream, the carried state updated in place, nothing else.  ``mesh`` names the device (its shards) and
    ``axis`` the sharded axis, as in the JAX package.  A mesh that spans
    several cards runs the step of parallel/mesh/cards.py (its state as
    CardSplits; ``card_layout`` shares one cards.CardLayout between a
    plane's variants, ``max_window`` caps its lookahead window)."""
    sched = layout["exchange"]
    if mesh.n_shards != sched.n_shards:
        raise ValueError(f"a {mesh.n_shards}-shard mesh for a "
                         f"{sched.n_shards}-shard layout")
    if mesh.n_cards > 1:
        from .cards import make_cards_step
        return make_cards_step(mesh, ring_len, layout, last_flow_pad,
                               node_src, n_nodes, mode, leg_mask,
                               card_layout, max_window, cap_chains,
                               cap_nodes)
    lf = np.asarray(last_flow_pad, dtype=np.int64)
    nsrc = np.asarray(node_src, dtype=np.int64)
    tables: List[MeshTables] = []

    def step_flush(t0, queued, ring, tokens, delivered, target, done_tick,
                   node_sent, inject, inject_target, targets, idle_ticks,
                   flow_node_local, succ_global, seg_start_local,
                   refill, capacity, arr_lat, shard_base):
        dev = queued.device
        if dev.type == "cpu":
            a = [_as_tensor(x, dev) for x in (
                inject, inject_target, flow_node_local, succ_global,
                seg_start_local, refill, capacity, arr_lat, shard_base)]
            return mesh_span_flush_torch(
                t0, queued, ring, tokens, delivered, target, done_tick,
                node_sent, a[0], a[1], targets, idle_ticks, *a[2:],
                ring_len=ring_len, schedule=sched,
                last_flow_pad=torch.as_tensor(lf),
                node_src=torch.as_tensor(nsrc), n_nodes=n_nodes, mode=mode,
                leg_mask=leg_mask, cap_chains=cap_chains,
                cap_nodes=cap_nodes)
        if not tables or tables[0].meta.device != dev:
            tables[:] = [MeshTables(layout, ring_len, lf, nsrc, n_nodes,
                                    mode, leg_mask, dev)]
        state, (cross, done_in, sent_in) = mesh_span(
            t0, queued, ring, tokens, delivered, target, done_tick,
            node_sent, _as_tensor(inject, dev),
            _as_tensor(inject_target, dev), targets, idle_ticks,
            _as_tensor(refill, dev), _as_tensor(capacity, dev), tables[0])
        flush = mesh_pack_flush(state[0], state[8], cross, state[6],
                                state[4], state[7], done_in, sent_in,
                                tables[0], cap_chains, cap_nodes)
        return (*state, flush)

    return step_flush


def mesh_flush_extra(flush: np.ndarray, n_chains: int, n_nodes: int,
                     cap_chains: Optional[int] = None,
                     cap_nodes: Optional[int] = None) -> int:
    """The mesh flush buffer's trailing cross-shard cell count, or 0 for a
    standard-length buffer (the numpy twin after a demotion).  Pass the
    caps the buffer was packed with — the trailing slot rides at the end
    of the CAPPED layout."""
    base = flush_len(n_chains, n_nodes, cap_chains, cap_nodes)
    return int(flush[base]) if len(flush) > base else 0
