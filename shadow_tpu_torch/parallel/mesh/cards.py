"""The mesh over several cards: each card runs its own shards, and the
cells that cross cards are exchanged between lookahead windows.

The JAX package runs the D shards of ``make_mesh_span_flush``
(shadow_tpu/parallel/mesh/exchange.py:473) on D devices from one
controller: a ``shard_map`` whose per-tick ``all_to_all``/``ppermute`` and
``psum`` the runtime carries between devices.  The port, one process too,
groups the shards by card (parallel/mesh ``device_mesh``: shard s on card
``s * n_cards // D``) and runs, per card and per window, one cooperative
launch of the card entry of csrc/mesh_span.cu over that card's shards
alone.  The cells whose sender and receiver share a card go through that
card's exchange buffer inside the launch, as on one card.  The cells that
cross cards go into an outbox, one row a tick of the window; between
windows each card's outbox segments are copied into the other cards'
inboxes (``Tensor.copy_(non_blocking=True)``: ``cudaMemcpyPeerAsync``
between distinct cards), ordered by CUDA events, and the next launch lands
them first.

The window.  The span reads ``ring[(t - arr_lat[j]) mod L, j]``
(csrc/span_tile.cuh); a cell sent at tick s over the edge into column j is
written into j's row ``s mod L`` and read first at tick ``s +
arr_lat[j]``.  So a card may run ``W`` ticks alone, W the least
``arr_lat`` over the columns whose predecessor is on another card (at
least 1): the cells of a window land before any tick that reads them,
into rows that no tick of the window reads (``L > arr_lat``).

The halt.  The JAX package reduces its halt at the targets boundaries
only, so a window also ends at every boundary, and the halt there is the
OR over cards of "a completion since the last boundary": each card's flag
rides in the header of every outbox segment.  A launch after a halt
returns at once, so a dispatch's windows are all enqueued up front, with
no host sync in the dispatch.

Counts.  ``forwards`` and ``cross`` are summed over the cards; ``cross``
counts the cells that crossed shards (on a card, at receipt through its
exchange buffer; across cards, at landing), as the one-card mesh counts
them.  The flush: each card's state is copied to the lead card (cards[0])
and the mesh entry of csrc/pack_flush.cu packs it there, so the buffer is
the one-card mesh's byte for byte.

Two forms, held to each other and to :func:`exchange.mesh_span_torch` bit
for bit: :func:`mesh_span_cards_torch`, the plain version (any devices:
the CPU tests run it on ``[cpu] * k``), and :func:`mesh_span_cards`, the
card entry's launches.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...ops._build import check_tensor as _check
from ...ops._build import entry as _bound
from ...ops._build import on_card
from ...ops.torcells_device import (CELL_WIRE_BYTES, MAX_TARGETS,
                                    RING_TORCH_DTYPE, pack_flush_torch)
from .exchange import (check_mesh_layout, exchange_routes, global_sent_torch,
                       mesh_pack_flush, mesh_tile_tables, resolve_mode)

# a card's scalars: t_stop, forwards, cross, a completion since the last
# boundary, stopped, the cells landed from other cards (csrc/mesh_span.cu
# S_*)
N_SCALARS = 8
S_TSTOP, S_FWD, S_CROSS, S_DONE, S_STOP, S_XCARD = range(6)
# an outbox segment's header words: the ticks the window ran, the sending
# card's completion flag
HDR = 2
# the card entry's launch flags (csrc/mesh_span.cu)
FIRST, LAND, DECIDE, LAST = 1, 2, 4, 8


def card_windows(t0: int, targets, window: Optional[int]
                 ) -> List[Tuple[int, int, bool]]:
    """The lookahead windows of one dispatch from tick ``t0`` to
    ``targets[-1]``: ``(w0, w1, at_boundary)``, each at most ``window``
    ticks (None: unbounded), cut at every boundary the span's loop checks
    (exchange.mesh_span_torch: the boundary index advances only when a
    tick reaches it, so a boundary at or before the tick in hand is never
    reached, nor any after it)."""
    bounds = [int(x) for x in np.asarray(targets).reshape(-1)]
    end = bounds[-1]
    t, idx, out = int(t0), 0, []
    while t < end:
        b = bounds[min(idx, len(bounds) - 1)]
        w1 = end if window is None else min(t + int(window), end)
        hit = False
        if b > t and b <= w1:
            w1, hit = b, True
        out.append((t, w1, hit))
        idx += hit
        t = w1
    return out


class CardLayout:
    """Where a padded mesh layout's rows live over a mesh's cards: card c
    holds shards ``mesh.shards_of(c)``, so the flow rows ``rows[c]`` and
    the node slots ``nodes[c]`` of every global array (contiguous).  One
    stream a card (the card's launches and copies), the window ``W`` (the
    least arrival latency over the columns whose predecessor is on another
    card, None when none is), and :meth:`split` from the global layout to
    per-card arrays."""

    def __init__(self, mesh, layout: dict):
        d, pad, hp = (int(layout[k]) for k in ("n_shards", "pad", "h_pad"))
        if mesh.n_shards != d:
            raise ValueError(f"a {mesh.n_shards}-shard mesh for a {d}-shard "
                             "layout")
        self.mesh = mesh
        self.cards = tuple(mesh.cards)
        self.n_cards = len(self.cards)
        self.shards = [mesh.shards_of(c) for c in range(self.n_cards)]
        self.rows = [(r.start * pad, r.stop * pad) for r in self.shards]
        self.nodes = [(r.start * hp, r.stop * hp) for r in self.shards]
        self.f, self.h, self.pad, self.h_pad = d * pad, d * hp, pad, hp
        self.lead = self.cards[0]
        self.streams = [torch.cuda.Stream(c) if c.type == "cuda" else None
                        for c in self.cards]
        # each physical card's share of its SMs: aliased cards' grids fit
        # on it together, so their cooperative launches can never wait on
        # each other
        self.share = [sum(x == c for x in self.cards) for c in self.cards]
        succ = np.asarray(layout["succ_global"], dtype=np.int64)
        al = np.asarray(layout["arr_lat"], dtype=np.int64)
        card_of_row = self.card_of_rows(np.arange(self.f))
        src = np.flatnonzero(succ >= 0)
        crossing = card_of_row[src] != card_of_row[succ[src]]
        self.window = int(al[succ[src[crossing]]].min()) \
            if crossing.any() else None
        self.cross_card_edges = int(crossing.sum())
        # what the dispatches moved (the chip smoke's per-card figures):
        # windows enqueued, bytes of the inbox copies, and the cells landed
        # from other cards (a 0-d tensor on the lead card, added to on its
        # stream, never read in a dispatch)
        self.windows = self.copy_bytes = 0
        self.xcard_cells = None

    def card_of_rows(self, rows: np.ndarray) -> np.ndarray:
        """The card of each global flow row."""
        return (np.asarray(rows) // self.pad) * self.n_cards \
            // self.mesh.n_shards

    def split(self, a, kind: str = "flow") -> "CardSplit":
        """A global-layout array (numpy, or a tensor on any device; the
        last axis ``F = D*pad`` for ``kind`` "flow", ``H = D*h_pad`` for
        "node") as per-card tensors on the cards.  A :class:`CardSplit` of
        this layout is returned as it is."""
        if isinstance(a, CardSplit):
            if a.layout is not self:
                raise ValueError("a CardSplit of another card layout")
            return a
        spans = self.rows if kind == "flow" else self.nodes
        n = self.f if kind == "flow" else self.h
        if a.shape[-1] != n:
            raise ValueError(f"split: a {kind} array of {a.shape[-1]} for "
                             f"{n}")
        parts = []
        for card, (lo, hi) in zip(self.cards, spans):
            if torch.is_tensor(a):
                parts.append(a[..., lo:hi].to(card).contiguous())
            else:
                parts.append(torch.as_tensor(
                    np.ascontiguousarray(np.asarray(a)[..., lo:hi]),
                    device=card))
        return CardSplit(parts, self)

    def synchronize(self) -> None:
        """Wait for every card's stream."""
        for s in self.streams:
            if s is not None:
                s.synchronize()


class CardSplit:
    """One array of the padded global layout held per card (the last axis
    cut at the cards' row or node spans), as the over-cards mesh step
    carries its state.  ``np.asarray`` waits for the cards' streams and
    returns the global array."""

    __slots__ = ("parts", "layout")

    def __init__(self, parts: Sequence[torch.Tensor], layout: CardLayout):
        self.parts = list(parts)
        self.layout = layout

    @property
    def shape(self) -> tuple:
        p = self.parts[0]
        return tuple(p.shape[:-1]) + (sum(x.shape[-1] for x in self.parts),)

    @property
    def dtype(self):
        return self.parts[0].dtype

    @property
    def device(self) -> torch.device:
        return self.parts[0].device

    def __array__(self, dtype=None, copy=None):
        self.layout.synchronize()
        out = np.concatenate([p.cpu().numpy() for p in self.parts], axis=-1)
        return out if dtype is None else out.astype(dtype)


class CardTables:
    """What the card entry derives from a padded layout, an exchange mode
    and a card layout, once per (layout, mode, leg mask): per card c,

    * ``meta``, ``tiles``, ``node_off`` and ``xin`` as
      :class:`exchange.MeshTables` holds them, over the card's shards
      alone, numbered from its first row and node slot; a row's
      destination in ``meta`` is -1 (a last stage), -2 (a leg not
      exchanged), a ring column of the card, ``F_c + k`` slot k of the
      card's exchange buffer (a successor on another shard of the card),
      or ``F_c + X_c + b * seg + HDR + i`` (a successor on card b: cell i
      of the outbox segment for b, plus ``pw`` a tick of the window);
    * ``cin`` int32 [n_cards, pw]: the column each inbox cell lands in
      (row a: from card a), -1 padding;
    * ``route`` (numpy, for the plain version): per row, ``("ring", col)``,
      ``("slot", col)``, ``("out", b, i)`` or none;

    and ``window`` (the layout's W, capped by ``max_window``; None where no
    cell crosses cards), ``pw`` (the most cells a card sends another in a
    tick), ``seg = HDR + window * pw``."""

    def __init__(self, layout: dict, cl: CardLayout, ring_len: int,
                 last_flow_pad, node_src, n_nodes: int,
                 mode: Optional[str] = None,
                 leg_mask: Optional[Tuple[bool, ...]] = None,
                 max_window: Optional[int] = None):
        sched = layout["exchange"]
        d, pad, hp = (int(layout[k]) for k in ("n_shards", "pad", "h_pad"))
        fp = d * pad
        mode, active = resolve_mode(sched, mode, leg_mask)
        check_mesh_layout(layout, ring_len)
        send_to, xin, xlen = exchange_routes(layout, mode, active)
        n = cl.n_cards
        crow = cl.card_of_rows(np.arange(fp))
        # each slot's sender row and receiving column
        snd = np.flatnonzero(send_to >= fp)
        send_row = np.full(max(xlen, 1), -1, dtype=np.int64)
        send_row[send_to[snd] - fp] = snd
        rcv = np.flatnonzero(xin >= 0)
        recv_col = np.full(max(xlen, 1), -1, dtype=np.int64)
        recv_col[xin[rcv]] = rcv
        slots = np.flatnonzero((send_row >= 0) & (recv_col >= 0))
        same = crow[send_row[slots]] == crow[recv_col[slots]]
        # the cells that cross cards, per ordered card pair, in ascending
        # sender row
        pairs = {}
        for k in slots[~same]:
            a, b = int(crow[send_row[k]]), int(crow[recv_col[k]])
            pairs.setdefault((a, b), []).append(
                (int(send_row[k]), int(recv_col[k])))
        for v in pairs.values():
            v.sort()
        pw = max((len(v) for v in pairs.values()), default=0)
        window = max_window
        if pw:
            window = cl.window if max_window is None \
                else min(cl.window, int(max_window))
        seg = HDR + (window * pw if pw else 0)
        self.mode, self.window, self.pw, self.seg = mode, window, pw, seg
        self.n_cards, self.ring_len = n, int(ring_len)
        self.cross_card_cells_a_tick = sum(len(v) for v in pairs.values())
        self.meta, self.tiles, self.node_off, self.xin, self.cin = \
            [], [], [], [], []
        self.xbuf_len, self.route = [], []
        lf = np.asarray(last_flow_pad, dtype=np.int64)
        for c in range(n):
            lo, hi = cl.rows[c]
            fc = hi - lo
            # this card's own slots, renumbered
            mine = slots[same & (crow[send_row[slots]] == c)]
            local = {int(k): i for i, k in enumerate(mine)}
            xc = max(len(mine), 1)
            dest = np.full(fp, -1, dtype=np.int64)      # global index space
            xin_c = np.full(fc, -1, dtype=np.int32)
            route = [None] * fc
            rows = np.arange(lo, hi)
            st = send_to[lo:hi]
            dest[lo:hi] = np.where(st == -2, -2, -1)
            ring_rows = rows[(st >= 0) & (st < fp)]
            dest[ring_rows] = send_to[ring_rows] - lo
            for j in ring_rows:
                route[j - lo] = ("ring", int(send_to[j]) - lo)
            for k, i in local.items():
                j, r = int(send_row[k]), int(recv_col[k])
                dest[j] = fc + i
                xin_c[r - lo] = i
                route[j - lo] = ("slot", r - lo)
            # a column fed over a leg this mode does not exchange
            xin_c[(xin[lo:hi] == -2)] = -2
            cin = np.full((n, max(pw, 1)), -1, dtype=np.int32)
            for (a, b), v in pairs.items():
                for i, (j, r) in enumerate(v):
                    if a == c:
                        dest[j] = fc + xc + b * seg + HDR + i
                        route[j - lo] = ("out", b, i)
                    if b == c:
                        cin[a, i] = r - lo
            if ring_len * fc >= 2 ** 31 or fc + xc + n * seg >= 2 ** 31:
                raise ValueError(f"mesh_span card {c}: F = {fc}, L = "
                                 f"{ring_len}, {xc} slots and an outbox of "
                                 f"{n * seg} overflow the kernel's 32-bit "
                                 "offsets")
            off, meta, tiles = mesh_tile_tables(layout, dest, ring_len,
                                                shards=cl.shards[c])
            self.node_off.append(off)
            self.meta.append(meta)
            self.tiles.append(tiles)
            self.xin.append(xin_c)
            self.cin.append(cin)
            self.xbuf_len.append(xc)
            self.route.append(route)
        # the flush on the lead card
        nsrc = np.asarray(node_src, dtype=np.int64)
        node_slot = np.full(n_nodes, -1, dtype=np.int64)
        ok = np.flatnonzero(nsrc >= 0)
        node_slot[nsrc[ok]] = ok
        self.last_flow_pad, self.node_slot = lf, node_slot
        self.n_chains, self.n_nodes = len(lf), int(n_nodes)
        self.n_shards, self.pad, self.h_pad = d, pad, hp
        self._dev = None

    def on_cards(self, cl: CardLayout) -> "CardTables":
        """Upload the tables to the cards (once) and allocate the window
        buffers: per card its exchange buffer, outbox, double inbox and
        scalars, two events; on the lead the flush's gather buffers."""
        if self._dev is not None:
            return self
        dev = []
        for c, card in enumerate(cl.cards):
            def up(a):
                return torch.as_tensor(np.ascontiguousarray(a), device=card)
            i64 = torch.int64
            lo, hi = cl.rows[c]
            nlo, nhi = cl.nodes[c]
            dev.append({
                "snap": torch.empty(hi - lo, dtype=i64, device=card),
                "sent_in": torch.empty(nhi - nlo, dtype=i64, device=card),
                "meta": up(self.meta[c]), "tiles": up(self.tiles[c]),
                "node_off": up(self.node_off[c]), "xin": up(self.xin[c]),
                "cin": up(self.cin[c]),
                "xbuf": torch.empty(2 * self.xbuf_len[c], dtype=i64,
                                    device=card),
                "outbox": torch.zeros(self.n_cards * self.seg, dtype=i64,
                                      device=card),
                "inbox": torch.zeros((2, self.n_cards * self.seg),
                                     dtype=i64, device=card),
                "scalars": torch.zeros(N_SCALARS, dtype=i64, device=card),
                "events": (torch.cuda.Event(), torch.cuda.Event())
                if card.type == "cuda" else None})
        lead = cl.lead
        i64 = torch.int64
        self.gather = {
            "done_tick": torch.empty(cl.f, dtype=i64, device=lead),
            "delivered": torch.empty(cl.f, dtype=i64, device=lead),
            "done_snap": torch.empty(cl.f, dtype=i64, device=lead),
            "node_sent": torch.empty(cl.h, dtype=i64, device=lead),
            "sent_in": torch.empty(cl.h, dtype=i64, device=lead),
            "scalars": torch.empty((self.n_cards, N_SCALARS), dtype=i64,
                                   device=lead),
            "last_flow_pad": torch.as_tensor(self.last_flow_pad,
                                             device=lead),
            "node_slot": torch.as_tensor(self.node_slot, device=lead)}
        self._dev = dev
        return self

    def card(self, c: int) -> dict:
        return self._dev[c]


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------

def _card_statics(layout: dict, cl: CardLayout, c: int):
    """Card c's flow and node statics (numbered from its first row and node
    slot): node, the row of the segment head, arrival latency, is-last."""
    lo, hi = cl.rows[c]
    s0 = cl.shards[c].start
    shard = np.arange(lo, hi) // cl.pad - s0
    node = np.asarray(layout["flow_node_local"], dtype=np.int64)[lo:hi] \
        + shard * cl.h_pad
    seg = np.asarray(layout["seg_start_local"], dtype=np.int64)[lo:hi] \
        + shard * cl.pad
    al = np.asarray(layout["arr_lat"], dtype=np.int64)[lo:hi]
    last = np.asarray(layout["succ_global"], dtype=np.int64)[lo:hi] < 0
    return node, seg, al, last


def mesh_span_cards_torch(t0, state, inject, inject_target, targets,
                          idle_ticks, refill, capacity, layout: dict,
                          cl: CardLayout, tables: CardTables):
    """Plain version of the mesh span over cards: the card entry's windows,
    exchange and halt written out in torch, each card's arithmetic on its
    own device (the CPU tests give ``[cpu] * k``).  ``state`` is the
    7-tuple (queued, ring, tokens, delivered, target, done_tick,
    node_sent) as :class:`CardSplit` (or global arrays, split here), the
    injections, ``refill`` and ``capacity`` likewise.  Returns (t_stop,
    the state as CardSplits, forwards, cross, done_snap, sent_in), the
    last two per card (the dispatch's entry snapshots).  Pure."""
    i64 = torch.int64
    size = CELL_WIRE_BYTES
    n, L = cl.n_cards, tables.ring_len
    pw, seg = tables.pw, tables.seg
    kinds = ("flow", "flow", "node", "flow", "flow", "flow", "node")
    st = [cl.split(a, k) for a, k in zip(state, kinds)]
    inj = cl.split(inject)
    inj_t = cl.split(inject_target)
    rf_all = cl.split(refill, "node")
    cap_all = cl.split(capacity, "node")
    idle = int(idle_ticks)
    cards = []
    for c, dev in enumerate(cl.cards):
        node, segs, al, last = (torch.as_tensor(a, device=dev)
                                for a in _card_statics(layout, cl, c))
        fc = node.shape[0]
        rf, cap = rf_all.parts[c], cap_all.parts[c]
        q = st[0].parts[c] + inj.parts[c]
        tg = st[4].parts[c] + inj_t.parts[c]
        tok = torch.minimum(cap, st[2].parts[c] + rf * idle)
        ring = torch.zeros_like(st[1].parts[c]) if idle > 0 \
            else st[1].parts[c].clone()
        route = tables.route[c]
        ring_j = [j for j, r in enumerate(route) if r and r[0] != "out"]
        out_j = [j for j, r in enumerate(route) if r and r[0] == "out"]
        cards.append({
            "dev": dev, "q": q, "tg": tg, "tok": tok, "ring": ring,
            "dl": st[3].parts[c].clone(), "dt": st[5].parts[c].clone(),
            "ns": st[6].parts[c].clone(),
            "snap": st[5].parts[c].clone(), "sent_in": st[6].parts[c].clone(),
            "node": node, "last": last, "al": al,
            "has_base": segs > 0, "base": (segs - 1).clamp(min=0),
            "rf": rf, "cap": cap, "cols": torch.arange(fc, device=dev),
            "src": torch.as_tensor(ring_j, dtype=i64, device=dev),
            "dst": torch.as_tensor([route[j][1] for j in ring_j], dtype=i64,
                                   device=dev),
            "xsrc": torch.as_tensor(
                [j for j in ring_j if route[j][0] == "slot"], dtype=i64,
                device=dev),
            "osrc": torch.as_tensor(out_j, dtype=i64, device=dev),
            "opos": torch.as_tensor([route[j][1] * seg + HDR + route[j][2]
                                     for j in out_j], dtype=i64, device=dev),
            "cin": torch.as_tensor(tables.cin[c], device=dev),
            "fwd_sum": torch.zeros((), dtype=i64, device=dev),
            "cross": torch.zeros((), dtype=i64, device=dev),
            "done": False})
    t = int(t0)
    xcard = torch.zeros((), dtype=i64, device=cl.lead)
    for w0, w1, at_b in card_windows(t0, targets, tables.window):
        outs = []
        for cd in cards:
            dev, zero = cd["dev"], torch.zeros((), dtype=i64, device=cd["dev"])
            out = torch.zeros(n * seg, dtype=i64, device=dev)
            for t in range(w0, w1):
                q = cd["q"] + cd["ring"][torch.remainder(t - cd["al"], L),
                                         cd["cols"]].to(i64)
                tok = torch.minimum(cd["cap"], cd["tok"] + cd["rf"])
                assert bool((tok >= 0).all()), "mesh span: negative tokens"
                cap_cells = torch.div(tok[cd["node"]], size,
                                      rounding_mode="floor")
                csum = torch.cumsum(q, 0)
                before = csum - q - torch.where(cd["has_base"],
                                                csum[cd["base"]], zero)
                served = torch.minimum((cap_cells - before).clamp(min=0), q)
                cd["q"] = q - served
                spent = torch.zeros_like(tok).scatter_add_(
                    0, cd["node"], served * size)
                cd["tok"] = tok - spent
                cd["ns"] = cd["ns"] + spent
                cd["dl"] = cd["dl"] + torch.where(cd["last"], served, zero)
                newly = cd["last"] & (cd["tg"] > 0) & (cd["dt"] < 0) \
                    & (cd["dl"] >= cd["tg"])
                cd["dt"] = torch.where(newly, torch.full_like(cd["dt"], t),
                                       cd["dt"])
                fwd = torch.where(cd["last"], zero, served)
                v = torch.zeros_like(q).scatter_add_(0, cd["dst"],
                                                     fwd[cd["src"]])
                cd["ring"][t % L] = v.to(cd["ring"].dtype)
                cd["cross"] = cd["cross"] + fwd[cd["xsrc"]].sum()
                out[cd["opos"] + (t - w0) * pw] = fwd[cd["osrc"]]
                cd["fwd_sum"] = cd["fwd_sum"] + served.sum()
                cd["done"] = cd["done"] or bool(newly.any())
            hdr = out.reshape(n, seg)
            hdr[:, 0] = w1 - w0
            hdr[:, 1] = int(cd["done"])
            outs.append(out)
        # the exchange: card a's segment for b into b's inbox at a
        halt = False
        for b, cd in enumerate(cards):
            for a in range(n):
                if a == b:
                    continue
                got = outs[a][b * seg:(b + 1) * seg].to(cd["dev"])
                assert int(got[0]) == w1 - w0
                halt = halt or bool(got[1])
                cells = got[HDR:].reshape(-1, pw)[:w1 - w0] if pw else None
                live = cd["cin"][a] >= 0
                for k in range(w1 - w0 if pw else 0):
                    row = cd["ring"][(w0 + k) % L]
                    row[cd["cin"][a][live].to(i64)] = \
                        cells[k][live].to(row.dtype)
                    cd["cross"] = cd["cross"] + cells[k][live].sum()
                    xcard = xcard + cells[k][live].sum().to(cl.lead)
        halt = halt or any(cd["done"] for cd in cards)
        t = w1
        if at_b:
            for cd in cards:
                cd["done"] = False
            if halt:
                break
    lead = cl.lead
    cl.xcard_cells = xcard if cl.xcard_cells is None \
        else cl.xcard_cells + xcard
    i64z = torch.zeros((), dtype=i64, device=lead)
    forwards = sum((cd["fwd_sum"].to(lead) for cd in cards), i64z)
    cross = sum((cd["cross"].to(lead) for cd in cards), i64z)

    def out_of(key):
        return CardSplit([cd[key] for cd in cards], cl)
    state = (out_of("q"), out_of("ring"), out_of("tok"), out_of("dl"),
             out_of("tg"), out_of("dt"), out_of("ns"))
    return (torch.tensor(t, dtype=i64, device=lead), state, forwards, cross,
            [cd["snap"] for cd in cards], [cd["sent_in"] for cd in cards])


def _gathered(parts, cl: CardLayout) -> torch.Tensor:
    return torch.cat([p.to(cl.lead) for p in parts], dim=-1)


def mesh_span_cards_flush_torch(t0, state, inject, inject_target, targets,
                                idle_ticks, refill, capacity, layout: dict,
                                cl: CardLayout, tables: CardTables,
                                cap_chains: Optional[int] = None,
                                cap_nodes: Optional[int] = None):
    """:func:`mesh_span_cards_torch` and the packed flush of the global view
    on the lead card, with the trailing cross-shard slot: the over-cards
    counterpart of :func:`exchange.mesh_span_flush_torch`, the same
    10-tuple (the state as CardSplits)."""
    t_stop, st, forwards, cross, snap, sent_in = mesh_span_cards_torch(
        t0, state, inject, inject_target, targets, idle_ticks, refill,
        capacity, layout, cl, tables)
    lf = torch.as_tensor(tables.last_flow_pad, device=cl.lead)
    nsrc = torch.as_tensor(np.asarray(layout["node_src"]), device=cl.lead)
    done_in = _gathered(snap, cl)[lf]
    done_last = _gathered(st[5].parts, cl)[lf]
    newly = (done_last >= 0) & (done_in < 0)
    sent0 = global_sent_torch(_gathered(sent_in, cl), nsrc, tables.n_nodes)
    flush = pack_flush_torch(
        forwards, _gathered(st[3].parts, cl)[lf].sum(), t_stop, newly,
        done_last, global_sent_torch(_gathered(st[6].parts, cl), nsrc,
                                     tables.n_nodes) - sent0, cap_chains,
        cap_nodes)
    return (t_stop, *st, forwards, torch.cat([flush, cross.reshape(1)]))


# ---------------------------------------------------------------------------
# The card entry's launches
# ---------------------------------------------------------------------------

_VP = ctypes.c_void_p
_I64 = ctypes.c_int64
_CARD_ARGTYPES = ([_VP] * 22 + [_I64] * 13 + [ctypes.c_int] * 4 + [_VP])


def mesh_span_card(c: int, st: Sequence[torch.Tensor], inject, inject_target,
                   refill, capacity, tables: CardTables, cl: CardLayout,
                   t0: int, idle_ticks: int, flags: int, w0: int, w1: int,
                   prev: Tuple[int, int], inbox: torch.Tensor) -> None:
    """One launch of csrc/mesh_span.cu's card entry on card ``c`` (which
    must be current: :func:`ops._build.on_card`), on its current stream,
    no synchronisation: the window ``[w0, w1)`` of card c's shards (none
    with LAST), after landing ``inbox`` (the previous window's cells,
    ``prev`` = (its first tick, its ticks)) with LAND and deciding the
    halt with DECIDE.  ``st`` is card c's 7 state tensors, updated in
    place.  Counts ``mesh_span_card.launches``."""
    card = cl.cards[c]
    if card.type != "cuda":
        raise ValueError(f"mesh_span_card: needs a CUDA card, got {card}")
    dv = tables.card(c)
    lo, hi = cl.rows[c]
    nlo, nhi = cl.nodes[c]
    fc, hc = hi - lo, nhi - nlo
    i64 = torch.int64
    for name, t, shape in (("queued", st[0], (fc,)), ("tokens", st[2], (hc,)),
                           ("delivered", st[3], (fc,)),
                           ("target", st[4], (fc,)),
                           ("done_tick", st[5], (fc,)),
                           ("node_sent", st[6], (hc,)),
                           ("inject", inject, (fc,)),
                           ("inject_target", inject_target, (fc,)),
                           ("refill", refill, (hc,)),
                           ("capacity", capacity, (hc,)),
                           ("inbox", inbox, (tables.n_cards * tables.seg,))):
        _check(f"mesh_span_card: {name}", t, i64, shape, card)
    _check("mesh_span_card: ring", st[1], RING_TORCH_DTYPE,
           (tables.ring_len, fc), card)
    snap, sent_in = dv["snap"], dv["sent_in"]
    stream = torch.cuda.current_stream(card).cuda_stream
    rc = _bound("mesh_span", "mesh_span_card_launch", _CARD_ARGTYPES)(
        st[0].data_ptr(), st[1].data_ptr(), st[2].data_ptr(),
        st[3].data_ptr(), st[4].data_ptr(), st[5].data_ptr(),
        st[6].data_ptr(), inject.data_ptr(), inject_target.data_ptr(),
        dv["meta"].data_ptr(), dv["tiles"].data_ptr(),
        dv["node_off"].data_ptr(), dv["xin"].data_ptr(), refill.data_ptr(),
        capacity.data_ptr(), dv["scalars"].data_ptr(), snap.data_ptr(),
        sent_in.data_ptr(), dv["xbuf"].data_ptr(), dv["outbox"].data_ptr(),
        inbox.data_ptr(), dv["cin"].data_ptr(), fc, hc,
        len(tables.tiles[c]) - 1, tables.ring_len, int(t0), int(idle_ticks),
        tables.xbuf_len[c], tables.pw, tables.seg, int(w0), int(w1),
        int(prev[0]), int(prev[1]), tables.n_cards, c, int(flags),
        cl.share[c], stream)
    if rc != 0:
        raise RuntimeError(f"mesh_span card entry launch failed on card {c} "
                           f"({card}): CUDA error {rc} (F={fc}, H={hc}, "
                           f"L={tables.ring_len}, window [{w0}, {w1}))")
    mesh_span_card.launches += 1


mesh_span_card.launches = 0


def card_launch_plan(t0: int, targets, window: Optional[int]):
    """The card entry's launches for one dispatch: ``(flags, w0, w1,
    prev)`` per window, then the LAST launch (the final landing and the
    end of the dispatch) at the tick the windows reach."""
    wins = card_windows(t0, targets, window)
    plan = []
    for i, (w0, w1, _hit) in enumerate(wins):
        flags = FIRST if i == 0 else LAND
        prev = (0, 0)
        if i:
            p0, p1, phit = wins[i - 1]
            prev = (p0, p1 - p0)
            flags |= DECIDE if phit else 0
        plan.append((flags, w0, w1, prev))
    end = wins[-1][1] if wins else int(t0)
    last = LAST | (LAND if wins else FIRST)
    prev = (wins[-1][0], wins[-1][1] - wins[-1][0]) if wins else (0, 0)
    plan.append((last, end, end, prev))
    return plan


def mesh_span_cards(t0, state, inject, inject_target, targets, idle_ticks,
                    refill, capacity, cl: CardLayout, tables: CardTables,
                    cap_chains: Optional[int] = None,
                    cap_nodes: Optional[int] = None):
    """The mesh span over cards on CUDA cards: per window, one card-entry
    launch a card on the card's stream, then each card's outbox segments
    copied into the other cards' inboxes (peer copies, non-blocking), the
    next launches waiting on CUDA events; every window enqueued up front,
    no host sync.  Then each card's state goes to the lead card and the
    mesh entry of csrc/pack_flush.cu packs the flush there.  ``state``
    (the 7-tuple), the injections, ``refill`` and ``capacity`` are
    :class:`CardSplit` or global arrays (split here; an injection from
    page-locked memory goes up per card without a sync).  Returns the
    10-tuple (t_stop 0-d on the lead, the state as CardSplits, forwards
    0-d, the flush buffer), ordered after the caller's current streams and
    before the lead's current stream."""
    tables.on_cards(cl)
    n = cl.n_cards
    kinds = ("flow", "flow", "node", "flow", "flow", "flow", "node")
    st = [cl.split(a, k) for a, k in zip(state, kinds)]
    rf, cap = cl.split(refill, "node"), cl.split(capacity, "node")
    tv = np.asarray(targets.cpu() if torch.is_tensor(targets) else targets,
                    dtype=np.int64).reshape(-1)
    if not 1 <= len(tv) <= MAX_TARGETS:
        raise ValueError(f"mesh_span_cards: 1 to {MAX_TARGETS} targets, got "
                         f"{len(tv)}")
    lead_stream = cl.streams[0]
    start = torch.cuda.Event()
    start.record(lead_stream)
    injs = []
    for c, card in enumerate(cl.cards):
        s = cl.streams[c]
        s.wait_stream(torch.cuda.current_stream(card))
        s.wait_event(start)
        lo, hi = cl.rows[c]
        with on_card(card, s, slot=c):
            injs.append(tuple(
                a.parts[c] if isinstance(a, CardSplit) else
                a[lo:hi].to(card, non_blocking=True) if torch.is_tensor(a)
                else torch.as_tensor(np.ascontiguousarray(a[lo:hi]),
                                     device=card)
                for a in (inject, inject_target)))
    plan = card_launch_plan(int(t0), tv, tables.window)
    cl.windows += len(plan) - 1
    cl.copy_bytes += (len(plan) - 1) * n * (n - 1) * tables.seg * 8
    for i, (flags, w0, w1, prev) in enumerate(plan):
        for c, card in enumerate(cl.cards):
            s = cl.streams[c]
            dv = tables.card(c)
            with on_card(card, s, slot=c):
                if i:
                    for b in range(n):
                        if b != c:
                            s.wait_event(tables.card(b)["events"][(i - 1) & 1])
                mesh_span_card(c, [a.parts[c] for a in st], *injs[c],
                               rf.parts[c], cap.parts[c], tables, cl, t0,
                               idle_ticks, flags, w0, w1, prev,
                               dv["inbox"][(i - 1) & 1])
                if not flags & LAST:
                    seg = tables.seg
                    for b in range(n):
                        if b != c:
                            tables.card(b)["inbox"][i & 1][
                                c * seg:(c + 1) * seg].copy_(
                                dv["outbox"][b * seg:(b + 1) * seg],
                                non_blocking=True)
                    dv["events"][i & 1].record(s)
    # the flush: every card's state to the lead card
    g = tables.gather
    for c, card in enumerate(cl.cards):
        s = cl.streams[c]
        dv = tables.card(c)
        lo, hi = cl.rows[c]
        nlo, nhi = cl.nodes[c]
        with on_card(card, s, slot=c):
            for key, part, (a, b) in (("done_tick", st[5].parts[c], (lo, hi)),
                                      ("delivered", st[3].parts[c], (lo, hi)),
                                      ("done_snap", dv["snap"], (lo, hi)),
                                      ("node_sent", st[6].parts[c],
                                       (nlo, nhi)),
                                      ("sent_in", dv["sent_in"], (nlo, nhi))):
                g[key][a:b].copy_(part, non_blocking=True)
            g["scalars"][c].copy_(dv["scalars"], non_blocking=True)
            dv["events"][0].record(s)
    with on_card(cl.lead, lead_stream, slot=0):
        for c in range(1, n):
            lead_stream.wait_event(tables.card(c)["events"][0])
        sc = g["scalars"]
        t_stop = sc[0, S_TSTOP]
        forwards = sc[:, S_FWD].sum()
        cross = sc[:, S_CROSS].sum()
        done_in = g["done_snap"].index_select(0, g["last_flow_pad"])
        xcard = sc[:, S_XCARD].sum()
        cl.xcard_cells = xcard if cl.xcard_cells is None \
            else cl.xcard_cells.add_(xcard)
        flush = mesh_pack_flush(t_stop, forwards, cross, g["done_tick"],
                                g["delivered"], g["node_sent"], done_in,
                                g["sent_in"], _LeadTables(tables, g),
                                cap_chains, cap_nodes)
    cur = torch.cuda.current_stream(cl.lead)
    cur.wait_stream(lead_stream)
    if flush.is_cuda:
        # made on the lead card's stream, read next on the caller's
        for x in (forwards, flush):
            x.record_stream(cur)
    return (t_stop, *st, forwards, flush)


class _LeadTables:
    """What the mesh entry of csrc/pack_flush.cu reads of the layout, on
    the lead card (exchange.MeshTables' flush fields)."""

    __slots__ = ("n_shards", "pad", "h_pad", "n_chains", "n_nodes",
                 "last_flow_pad", "node_slot")

    def __init__(self, tables: CardTables, g: dict):
        self.n_shards, self.pad, self.h_pad = (tables.n_shards, tables.pad,
                                               tables.h_pad)
        self.n_chains, self.n_nodes = tables.n_chains, tables.n_nodes
        self.last_flow_pad = g["last_flow_pad"]
        self.node_slot = g["node_slot"]


def make_cards_step(mesh, ring_len: int, layout: dict,
                    last_flow_pad: np.ndarray, node_src: np.ndarray,
                    n_nodes: int, mode: Optional[str] = None,
                    leg_mask: Optional[Tuple[bool, ...]] = None,
                    cl: Optional[CardLayout] = None,
                    max_window: Optional[int] = None,
                    cap_chains: Optional[int] = None,
                    cap_nodes: Optional[int] = None):
    """The engine's sharded step (exchange.make_mesh_span_flush's contract:
    the JAX package's argument list and 10-tuple, the flush with its
    trailing slot) for a mesh that spans several cards: the plain version
    on CPU cards, the card entry's launches on CUDA cards.  The state comes
    back as :class:`CardSplit`; the static flow arguments are the layout's
    (read from ``layout``, the passed ones ignored).  ``cl`` shares one
    card layout (its streams) between a plane's step variants."""
    cl = cl if cl is not None else CardLayout(mesh, layout)
    tables = CardTables(layout, cl, ring_len, last_flow_pad, node_src,
                        n_nodes, mode, leg_mask, max_window)
    refill = cl.split(np.asarray(layout["refill"]), "node")
    capacity = cl.split(np.asarray(layout["capacity"]), "node")

    def step_flush(t0, queued, ring, tokens, delivered, target, done_tick,
                   node_sent, inject, inject_target, targets, idle_ticks,
                   *_statics):
        state = (queued, ring, tokens, delivered, target, done_tick,
                 node_sent)
        if cl.lead.type == "cpu":
            return mesh_span_cards_flush_torch(
                t0, state, inject, inject_target, targets, idle_ticks,
                refill, capacity, layout, cl, tables, cap_chains, cap_nodes)
        return mesh_span_cards(t0, state, inject, inject_target, targets,
                               idle_ticks, refill, capacity, cl, tables,
                               cap_chains, cap_nodes)

    step_flush.cards = cl
    step_flush.tables = tables
    step_flush.layout = layout
    return step_flush
