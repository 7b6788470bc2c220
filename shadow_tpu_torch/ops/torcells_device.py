"""The device traffic plane's step: bulk Tor cells advanced in device
tensors, one dispatch per superwindow.

Port of the JAX package's ``ops/torcells_device.py`` superwindow span step
(``_step_span_impl`` via ``_step_span_flush_impl``) and its packed flush
(``_pack_flush_jnp``).  The model: C cell chains of a few stages each form
F flows, sorted by paced node (``build_flows``); per tick every node refills
its token bucket, serves its flows greedily in flow order (a segmented
cumsum), and a served cell arrives at the successor flow after the edge
latency through an int32 ``[L, F]`` send-history ring.  A dispatch advances
through the ascending step boundaries in ``targets`` and halts at the first
boundary after a chain completed.

Three layers, each testable on its own:

* the plain torch versions :func:`torcells_step_span_torch` and
  :func:`pack_flush_torch` (and their composite
  :func:`torcells_step_window_flush_reference`) — the CPU tests hold them
  bit-exact against the JAX functions and the numpy twins;
* the wrappers :func:`torcells_span` and :func:`pack_flush`, each of which
  launches its hand-written kernel (``csrc/torcells_span.cu``,
  ``csrc/pack_flush.cu``) on a CUDA tensor and counts the launch in its
  ``.launches``;
* the dispatch :func:`torcells_step_window_flush`: on CPU tensors the plain
  versions, on CUDA tensors the two kernels, nothing else;
* the fleet plane's batched step :func:`torcells_step_span_flush_batched`
  (the JAX package's vmapped ``torcells_step_span_flush_batched``): W
  independent lanes in one launch each of ``csrc/torcells_span_batched.cu``
  and the batched entry of ``csrc/pack_flush.cu`` (wrappers
  :func:`torcells_span_batched`, :func:`pack_flush_batched`), with its
  plain version :func:`torcells_step_span_flush_batched_torch` (a loop of
  :func:`torcells_step_window_flush_reference` over lanes) and the numpy
  twin :func:`torcells_step_span_batched_numpy`.

On the card the carried state is updated in place (the JAX package donated
it instead); callers treat the state they pass as consumed.

The numpy helpers (``build_flows``, the flush layout helpers) and the numpy
twins are copied unchanged: ``--device-plane=numpy`` runs the twins as an
execution mode, and the plane's recovery drill replays on them.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from ..core import defs
from ..device import resolve_device
from ._build import check_tensor as _check
from ._build import entry as _bound
from .bandwidth import bucket_params

CELL_WIRE_BYTES = 512 + defs.CONFIG_HEADER_SIZE_TCPIPETH

# Arrival-ring element dtype: per-step per-flow cell counts are bounded by
# bucket capacity / cell size (a 10 Gbit/s host at a 100 ms granule is
# ~230k cells, nowhere near 2**31), so int32 halves the [ring_len, F] state.
# The plane refuses a configuration whose burst could overflow it.
RING_DTYPE = np.int32
RING_TORCH_DTYPE = torch.int32

# the span kernel takes the superwindow boundaries by value (csrc
# torcells_span.cu MAX_TARGETS); the tuner's ceiling on K is the same
MAX_TARGETS = 64


def build_flows(route: np.ndarray,          # int32 [C, 5] node per stage
                latency_ticks: np.ndarray,  # int64 [H, H]
                ) -> dict:
    """Precompute the static flow layout: flows sorted by (paced node,
    circuit id), segment offsets per node, and each flow's onward hop
    latency.  Pure numpy; runs once at model build."""
    c, stages = route.shape
    flow_circ = np.repeat(np.arange(c, dtype=np.int64), stages)
    flow_stage = np.tile(np.arange(stages, dtype=np.int64), c)
    flow_node = route[flow_circ, flow_stage].astype(np.int64)
    # greedy allocation order: by paced node, then circuit id (a node never
    # paces two stages of the same circuit: servers/relays/clients occupy
    # disjoint node ranges and relay picks are distinct).  Onward latencies
    # are >= 1 tick, so a cell can never traverse two stages in one tick —
    # matching the engine, where a forwarded cell is a new arrival event.
    order = np.lexsort((flow_stage, flow_circ, flow_node))
    flow_circ, flow_stage, flow_node = (flow_circ[order], flow_stage[order],
                                        flow_node[order])
    # onward latency: stage s -> s+1 edge; last stage delivers (0)
    nxt = np.where(flow_stage < stages - 1,
                   route[flow_circ, np.minimum(flow_stage + 1, stages - 1)],
                   route[flow_circ, flow_stage])
    lat = latency_ticks[flow_node, nxt].astype(np.int64)
    lat = np.where(flow_stage < stages - 1, np.maximum(lat, 1), 0)
    # successor flow index (same circuit, next stage) in sorted space
    flat_id = flow_circ * stages + flow_stage
    pos_of = np.empty(c * stages, dtype=np.int64)
    pos_of[flat_id] = np.arange(c * stages)
    succ = np.where(flow_stage < stages - 1,
                    pos_of[np.minimum(flat_id + 1, c * stages - 1)], -1)
    # segment start offset of each flow's node group (for the cumsum trick)
    seg_start_of_flow = np.zeros(c * stages, dtype=np.int64)
    starts = np.flatnonzero(np.r_[True, flow_node[1:] != flow_node[:-1]])
    seg_id = np.cumsum(np.r_[0, (flow_node[1:] != flow_node[:-1])
                             .astype(np.int64)])
    seg_start_of_flow = starts[seg_id]
    return {
        "flow_circ": flow_circ, "flow_stage": flow_stage,
        "flow_node": flow_node, "flow_lat": lat, "flow_succ": succ,
        "seg_start": seg_start_of_flow,
    }


# ---------------------------------------------------------------------------
# Packed flush buffer: the dispatch's ENTIRE host-facing summary in one
# int64 vector, so collect is ONE device->host transfer instead of four
# (delivered + done_tick + node_sent + forwards).  Delta-compacted with a
# device-side cursor: only chains that completed THIS window and only nodes
# whose sent-byte counter moved occupy slots; the header carries the counts.
#
# Layout ([5 + 2C + 2H] int64, C = chains, H = nodes):
#   [0] forwards this window
#   [1] cumulative delivered cells summed over chain-exit flows
#   [2] n_done   — chains newly completed this window
#   [3] n_nodes  — nodes with a nonzero sent-byte delta this window
#   [4] t_stop   — the absolute step the kernel actually advanced to (the
#                  final target, or an earlier sub-window boundary when the
#                  superwindow loop halted at a completion — see
#                  _step_span_impl); carried in the flush so the host never
#                  pays a second device read to learn where a multi-round
#                  dispatch stopped
#   [5        : 5+n_done]        newly-done chain indices (ascending)
#   [5+C      : 5+C+n_done]      their completion steps
#   [5+2C     : 5+2C+n_nodes]    touched node indices (ascending)
#   [5+2C+H   : 5+2C+H+n_nodes]  their sent-byte deltas
# ---------------------------------------------------------------------------

FLUSH_HEADER = 5


def flush_len(n_chains: int, n_nodes: int,
              cap_chains: Optional[int] = None,
              cap_nodes: Optional[int] = None) -> int:
    """Packed flush buffer length.  With caps (the delta-compacted
    flush) the chain/node sections carry at most ``cap_chains``/
    ``cap_nodes`` entries — the header counts stay TRUE, so an
    overflowing window is detectable (flush_overflowed) and re-read
    through the full-length kernel."""
    c = n_chains if cap_chains is None else min(cap_chains, n_chains)
    h = n_nodes if cap_nodes is None else min(cap_nodes, n_nodes)
    return FLUSH_HEADER + 2 * c + 2 * h


def pack_flush_np(forwards, delivered_sum, t_stop, newly, done_last,
                  sent_delta):
    """Bit-identical host twin of _pack_flush_jnp."""
    c = len(newly)
    h = len(sent_delta)
    buf = np.zeros(flush_len(c, h), np.int64)
    buf[0] = forwards
    buf[1] = delivered_sum
    ci = np.flatnonzero(newly)
    ni = np.flatnonzero(sent_delta)
    buf[2] = len(ci)
    buf[3] = len(ni)
    buf[4] = t_stop
    base = FLUSH_HEADER
    buf[base:base + len(ci)] = ci
    buf[base + c:base + c + len(ci)] = np.asarray(done_last)[ci]
    buf[base + 2 * c:base + 2 * c + len(ni)] = ni
    buf[base + 2 * c + h:base + 2 * c + h + len(ni)] = \
        np.asarray(sent_delta)[ni]
    return buf


def flush_overflowed(buf: np.ndarray, cap_chains: int,
                     cap_nodes: int) -> bool:
    """True when a CAPPED flush buffer lost entries: the header carries the
    true per-window counts, so overflow is one comparison — the caller then
    re-runs the same inputs through the full-length kernel (legal on the
    non-donating CPU path, where the inputs are still alive)."""
    return int(buf[2]) > int(cap_chains) or int(buf[3]) > int(cap_nodes)


def parse_flush(buf: np.ndarray, n_chains: int, n_nodes: int,
                cap_chains: Optional[int] = None,
                cap_nodes: Optional[int] = None):
    """(forwards, delivered_sum, t_stop, done_chains, done_steps, node_idx,
    node_delta) from a packed flush buffer — the ONE host-side reader.
    Pass the caps the buffer was packed with (if any); callers must check
    flush_overflowed FIRST — parsing an overflowed capped buffer would
    silently drop completions/deltas."""
    cc = n_chains if cap_chains is None else min(int(cap_chains), n_chains)
    hh = n_nodes if cap_nodes is None else min(int(cap_nodes), n_nodes)
    base = FLUSH_HEADER
    n_done = min(int(buf[2]), cc)
    n_touch = min(int(buf[3]), hh)
    return (int(buf[0]), int(buf[1]), int(buf[4]),
            buf[base:base + n_done],
            buf[base + cc:base + cc + n_done],
            buf[base + 2 * cc:base + 2 * cc + n_touch],
            buf[base + 2 * cc + hh:
                base + 2 * cc + hh + n_touch])


def torcells_step_span_numpy(t0, queued, ring, tokens, delivered, target,
                             done_tick, node_sent, inject, inject_target,
                             targets, idle_ticks, flow_node, flow_lat,
                             flow_succ, seg_start, refill, capacity,
                             ring_len: int):
    """Bit-identical host twin of _step_span_impl (same boundary/halt
    rule) — the parity oracle and the --device-plane=numpy execution
    mode's superwindow step."""
    f = len(queued)
    h = len(refill)
    size = CELL_WIRE_BYTES
    is_last = flow_succ < 0
    queued = queued + inject
    target = target + inject_target
    tokens = np.minimum(capacity, tokens + refill * int(idle_ticks))
    if int(idle_ticks) > 0:
        ring = np.zeros_like(ring)   # idle jump: stale send history cleared
    arr_lat = np.zeros(f, dtype=np.int64)
    np.add.at(arr_lat, np.maximum(flow_succ, 0),
              np.where(is_last, 0, flow_lat))
    cols = np.arange(f)
    bounds = [int(x) for x in np.asarray(targets)]
    end = bounds[-1]
    forwards = 0
    t = int(t0)
    idx = 0
    span_done = False
    while t < end:
        arr = ring[(t - arr_lat) % ring_len, cols]
        queued = queued + arr
        tokens = np.minimum(capacity, tokens + refill)
        cap_cells = tokens[flow_node] // size
        csum = np.cumsum(queued)
        seg_base = np.where(seg_start > 0, csum[np.maximum(seg_start - 1, 0)],
                            0) * (seg_start > 0)
        before = csum - queued - seg_base
        served = np.clip(cap_cells - before, 0, queued)
        queued = queued - served
        spent = np.bincount(flow_node, weights=served * size,
                            minlength=h).astype(np.int64)
        tokens = tokens - spent
        node_sent = node_sent + spent
        delivered = delivered + np.where(is_last, served, 0)
        newly_done = (is_last & (target > 0) & (done_tick < 0)
                      & (delivered >= target))
        done_tick = np.where(newly_done, t, done_tick)
        v = np.zeros(f, dtype=np.int64)
        np.add.at(v, np.maximum(flow_succ, 0), np.where(is_last, 0, served))
        ring[t % ring_len] = v
        forwards += int(served.sum())
        span_done = span_done or bool(newly_done.any())
        t += 1
        if t == bounds[min(idx, len(bounds) - 1)]:
            idx += 1
            if span_done:
                break
            span_done = False
    return (np.int64(t), queued, ring, tokens, delivered, target, done_tick,
            node_sent, np.int64(forwards))


def torcells_step_window_numpy_flush(t0, queued, ring, tokens, delivered,
                                     target, done_tick, node_sent, inject,
                                     inject_target, targets, idle_ticks,
                                     flow_node, flow_lat, flow_succ,
                                     seg_start, refill, capacity, last_flow,
                                     ring_len: int):
    """Host twin of torcells_step_window_flush (same 10-tuple contract,
    same ``targets`` superwindow boundaries)."""
    done_in_last = np.asarray(done_tick)[last_flow].copy()
    node_sent_in = np.asarray(node_sent).copy()
    out = torcells_step_span_numpy(t0, queued, ring, tokens, delivered,
                                   target, done_tick, node_sent, inject,
                                   inject_target, targets, idle_ticks,
                                   flow_node, flow_lat, flow_succ,
                                   seg_start, refill, capacity, ring_len)
    done_last = out[6][last_flow]
    newly = (done_last >= 0) & (done_in_last < 0)
    flush = pack_flush_np(int(out[8]), int(out[4][last_flow].sum()),
                          int(out[0]), newly, done_last,
                          out[7] - node_sent_in)
    return (*out, flush)


def torcells_step_span_batched_numpy(t0, queued, ring, tokens, delivered,
                                     target, done_tick, node_sent, inject,
                                     inject_target, targets, idle_ticks,
                                     flow_node, flow_lat, flow_succ,
                                     seg_start, refill, capacity, last_flow,
                                     ring_len: int):
    """Host twin of torcells_step_span_flush_batched: lanes looped through
    the unbatched numpy flush twin and re-stacked (same 10-tuple/leading-
    axis contract) — the parity oracle for the vmapped program."""
    outs = [torcells_step_window_numpy_flush(
        np.int64(t0[w]), queued[w], ring[w], tokens[w], delivered[w],
        target[w], done_tick[w], node_sent[w], inject[w], inject_target[w],
        targets[w], int(idle_ticks[w]), flow_node[w], flow_lat[w],
        flow_succ[w], seg_start[w], refill[w], capacity[w], last_flow[w],
        ring_len) for w in range(len(t0))]
    return tuple(np.stack([np.asarray(o[i]) for o in outs])
                 for i in range(10))


# ---------------------------------------------------------------------------
# Plain torch versions (the JAX functions' semantics, any device)
# ---------------------------------------------------------------------------

def arrival_latency(flow_lat: torch.Tensor,
                    flow_succ: torch.Tensor) -> torch.Tensor:
    """Successor-space arrival latency: ``arr_lat[j]`` is the onward
    latency of j's predecessor, 0 where j has none (``flow_succ`` is
    injective over chains, so the scatter-add is a set).  Static per flow
    table: the plane computes it once."""
    is_last = flow_succ < 0
    return torch.zeros_like(flow_lat).index_add_(
        0, flow_succ.clamp(min=0),
        torch.where(is_last, torch.zeros_like(flow_lat), flow_lat))


def torcells_step_span_torch(t0, queued, ring, tokens, delivered, target,
                             done_tick, node_sent, inject, inject_target,
                             targets, idle_ticks, flow_node, flow_lat,
                             flow_succ, seg_start, refill, capacity,
                             ring_len: int,
                             arr_lat: Optional[torch.Tensor] = None):
    """Plain torch version of the JAX package's ``_step_span_impl``: advance
    from ``t0`` through the ascending boundaries ``targets`` (padded by
    repeating the last), halting at the end of the first sub-window in
    which a chain newly completed.  Returns the 9-tuple (t_stop, queued,
    ring, tokens, delivered, target, done_tick, node_sent, forwards) with
    t_stop and forwards as 0-d int64 tensors.  Pure: no input is changed.
    The halt check reads one flag per tick on the host, which is the
    plain version's privilege; the kernel keeps its loop on the card."""
    dev = queued.device
    f = queued.shape[0]
    h = refill.shape[0]
    size = CELL_WIRE_BYTES
    is_last = flow_succ < 0
    zero_f = torch.zeros(f, dtype=torch.int64, device=dev)
    queued = queued + inject
    target = target + inject_target
    idle = int(idle_ticks)
    tokens = torch.minimum(capacity, tokens + refill * idle)
    ring = torch.zeros_like(ring) if idle > 0 else ring.clone()
    if arr_lat is None:
        arr_lat = arrival_latency(flow_lat, flow_succ)
    cols = torch.arange(f, device=dev)
    succ0 = flow_succ.clamp(min=0)
    has_base = seg_start > 0
    base_idx = (seg_start - 1).clamp(min=0)
    bounds = [int(x) for x in torch.as_tensor(targets).reshape(-1).tolist()]
    end = bounds[-1]
    t = int(t0)
    idx = 0
    span_done = False
    forwards = torch.zeros((), dtype=torch.int64, device=dev)
    while t < end:
        queued = queued + ring[torch.remainder(t - arr_lat, ring_len),
                               cols].to(torch.int64)
        tokens = torch.minimum(capacity, tokens + refill)
        # floor division; the kernel's C++ '/' truncates, which agrees
        # only while tokens stay non-negative — they always do
        assert bool((tokens >= 0).all()), "torcells: negative tokens"
        cap_cells = torch.div(tokens[flow_node], size, rounding_mode="floor")
        csum = torch.cumsum(queued, 0)
        before = csum - queued - torch.where(has_base, csum[base_idx],
                                             zero_f)
        served = torch.minimum((cap_cells - before).clamp(min=0), queued)
        queued = queued - served
        spent = torch.zeros(h, dtype=torch.int64, device=dev).index_add_(
            0, flow_node, served * size)
        tokens = tokens - spent
        node_sent = node_sent + spent
        delivered = delivered + torch.where(is_last, served, zero_f)
        newly_done = (is_last & (target > 0) & (done_tick < 0)
                      & (delivered >= target))
        done_tick = torch.where(newly_done, torch.full_like(done_tick, t),
                                done_tick)
        v = torch.zeros(f, dtype=torch.int64, device=dev).index_add_(
            0, succ0, torch.where(is_last, zero_f, served))
        ring[t % ring_len] = v.to(ring.dtype)
        forwards = forwards + served.sum()
        span_done = span_done or bool(newly_done.any())
        t += 1
        if t == bounds[min(idx, len(bounds) - 1)]:
            idx += 1
            if span_done:
                break
            span_done = False
    return (torch.tensor(t, dtype=torch.int64, device=dev), queued, ring,
            tokens, delivered, target, done_tick, node_sent, forwards)


def pack_flush_torch(forwards, delivered_sum, t_stop, newly: torch.Tensor,
                     done_last: torch.Tensor, sent_delta: torch.Tensor,
                     cap_chains: Optional[int] = None,
                     cap_nodes: Optional[int] = None) -> torch.Tensor:
    """Plain torch version of the JAX package's ``_pack_flush_jnp``: newly
    bool [C], done_last int64 [C], sent_delta int64 [H] -> the packed
    buffer (capped length with caps; the header keeps the TRUE counts).
    The JAX scatters drop out-of-range slots; here the unselected lanes
    are masked out, never scattered (torch's indexing would raise)."""
    dev = sent_delta.device
    c = newly.shape[0]
    h = sent_delta.shape[0]
    cc = c if cap_chains is None else min(int(cap_chains), c)
    hh = h if cap_nodes is None else min(int(cap_nodes), h)
    buf = torch.zeros(flush_len(c, h, cap_chains, cap_nodes),
                      dtype=torch.int64, device=dev)
    newly = newly.to(torch.bool)
    touched = sent_delta != 0
    pos_c = torch.cumsum(newly.to(torch.int64), 0) - 1
    pos_h = torch.cumsum(touched.to(torch.int64), 0) - 1
    sel_c = newly & (pos_c < cc)
    sel_h = touched & (pos_h < hh)
    buf[0] = torch.as_tensor(forwards, dtype=torch.int64, device=dev)
    buf[1] = torch.as_tensor(delivered_sum, dtype=torch.int64, device=dev)
    buf[2] = newly.sum()
    buf[3] = touched.sum()
    buf[4] = torch.as_tensor(t_stop, dtype=torch.int64, device=dev)
    base = FLUSH_HEADER
    pc = pos_c[sel_c]
    ph = pos_h[sel_h]
    buf[base + pc] = torch.arange(c, dtype=torch.int64, device=dev)[sel_c]
    buf[base + cc + pc] = done_last[sel_c]
    buf[base + 2 * cc + ph] = torch.arange(h, dtype=torch.int64,
                                           device=dev)[sel_h]
    buf[base + 2 * cc + hh + ph] = sent_delta[sel_h]
    return buf


def torcells_step_window_flush_reference(
        t0, queued, ring, tokens, delivered, target, done_tick, node_sent,
        inject, inject_target, targets, idle_ticks, flow_node, flow_lat,
        flow_succ, seg_start, refill, capacity, last_flow, ring_len: int,
        cap_chains: Optional[int] = None, cap_nodes: Optional[int] = None,
        arr_lat: Optional[torch.Tensor] = None):
    """Plain torch version of ``_step_span_flush_impl``: the 9-tuple of
    :func:`torcells_step_span_torch` with the packed flush appended as
    [9].  Runs on any device; the dispatch wrapper uses it on the CPU and
    ``chip_smoke.py`` holds the kernels to it on the card."""
    done_in_last = done_tick[last_flow]
    node_sent_in = node_sent
    out = torcells_step_span_torch(t0, queued, ring, tokens, delivered,
                                   target, done_tick, node_sent, inject,
                                   inject_target, targets, idle_ticks,
                                   flow_node, flow_lat, flow_succ,
                                   seg_start, refill, capacity, ring_len,
                                   arr_lat=arr_lat)
    done_last = out[6][last_flow]
    newly = (done_last >= 0) & (done_in_last < 0)
    flush = pack_flush_torch(out[8], out[4][last_flow].sum(), out[0], newly,
                             done_last, out[7] - node_sent_in, cap_chains,
                             cap_nodes)
    return (*out, flush)


def torcells_step_span_flush_batched_torch(
        t0, queued, ring, tokens, delivered, target, done_tick, node_sent,
        inject, inject_target, targets, idle_ticks, flow_node, flow_lat,
        flow_succ, seg_start, refill, capacity, last_flow, ring_len: int):
    """Plain torch version of the JAX package's vmapped
    ``torcells_step_span_flush_batched``: every operand carries a leading
    lane axis [W] (``t0`` and ``idle_ticks`` [W], ``targets`` [W, P]),
    each lane runs :func:`torcells_step_window_flush_reference` on its own
    row, and the ten outputs come back stacked ([W] t_stop and forwards,
    [W, ...] state, [W, flush_len] flushes).  A lane whose span has ended
    is frozen at its halt state, as under vmap; a lane whose targets equal
    its t0 never starts.  Pure: no input is changed."""
    outs = []
    for w in range(queued.shape[0]):
        outs.append(torcells_step_window_flush_reference(
            int(t0[w]), queued[w], ring[w], tokens[w], delivered[w],
            target[w], done_tick[w], node_sent[w], inject[w],
            inject_target[w], targets[w], int(idle_ticks[w]), flow_node[w],
            flow_lat[w], flow_succ[w], seg_start[w], refill[w], capacity[w],
            last_flow[w], ring_len))
    return tuple(torch.stack([o[i] for o in outs]) for i in range(10))


# ---------------------------------------------------------------------------
# Kernel wrappers (CUDA tensors launch the kernels; CPU tensors run the
# plain versions)
# ---------------------------------------------------------------------------

class SpanTables:
    """What the span kernel derives from a static flow table, computed and
    checked once per table: ``arr_lat`` [F] and each node's flow range
    ``node_off`` [H+1].  The kernel walks node n's flows
    ``node_off[n]:node_off[n+1]`` serially, which is the JAX segmented
    cumsum exactly when every ``seg_start`` segment is one node's whole
    contiguous run of flows; it reads a flow's arrival from a ring row
    other than the one the tick writes, which needs every arrival
    latency in [1, ring_len).  A table breaking either is refused here."""

    __slots__ = ("arr_lat", "node_off")

    def __init__(self, flow_node, flow_lat, flow_succ, seg_start,
                 n_nodes: int, ring_len: int):
        fn = flow_node.cpu().numpy()
        succ = flow_succ.cpu().numpy()
        ss = seg_start.cpu().numpy()
        f = len(fn)
        if f and (np.any(np.diff(fn) < 0) or fn[0] < 0
                  or fn[-1] >= n_nodes):
            raise ValueError("torcells_span: flow_node must be sorted and "
                             "in [0, H)")
        off = np.searchsorted(fn, np.arange(n_nodes + 1), side="left")
        if f and not np.array_equal(ss, off[fn]):
            raise ValueError("torcells_span: every seg_start segment must "
                             "be one node's whole run of flows")
        arr_lat = arrival_latency(flow_lat.cpu(), flow_succ.cpu())
        has_pred = np.zeros(f, dtype=bool)
        has_pred[succ[succ >= 0]] = True
        al = arr_lat.numpy()
        if np.any(has_pred & ((al < 1) | (al >= ring_len))):
            raise ValueError("torcells_span: every arrival latency must be "
                             "in [1, ring_len)")
        dev = flow_node.device
        self.arr_lat = arr_lat.to(dev)
        self.node_off = torch.as_tensor(off.astype(np.int64), device=dev)


_VP = ctypes.c_void_p
_I64 = ctypes.c_int64
_SPAN_ARGTYPES = ([_VP] * 19 + [_I64] * 6 + [ctypes.c_int, _VP, _VP])
_PACK_ARGTYPES = [_VP] * 7 + [_I64] * 4 + [_VP]


def torcells_span(t0, queued, ring, tokens, delivered, target, done_tick,
                  node_sent, inject, inject_target, targets, idle_ticks,
                  flow_node, flow_lat, flow_succ, seg_start, refill,
                  capacity, last_flow, ring_len: int,
                  tables: Optional[SpanTables] = None):
    """Launch csrc/torcells_span.cu on CUDA tensors: the whole superwindow
    in one cooperative launch on the current stream, no synchronisation.
    The state tensors are updated in place.  Returns the 9-tuple of
    :func:`torcells_step_span_torch` (t_stop and forwards as 0-d device
    tensors) and the flush inputs (delivered_sum 0-d, newly bool [C],
    done_last [C], sent_delta [H]).  Counts ``torcells_span.launches``."""
    dev = queued.device
    if dev.type != "cuda":
        raise ValueError(f"torcells_span: needs CUDA tensors, got {dev}")
    f = queued.shape[0]
    h = refill.shape[0]
    c = last_flow.shape[0]
    i64 = torch.int64
    for name, t, shape in (("queued", queued, (f,)),
                           ("tokens", tokens, (h,)),
                           ("delivered", delivered, (f,)),
                           ("target", target, (f,)),
                           ("done_tick", done_tick, (f,)),
                           ("node_sent", node_sent, (h,)),
                           ("inject", inject, (f,)),
                           ("inject_target", inject_target, (f,)),
                           ("flow_node", flow_node, (f,)),
                           ("flow_lat", flow_lat, (f,)),
                           ("flow_succ", flow_succ, (f,)),
                           ("seg_start", seg_start, (f,)),
                           ("refill", refill, (h,)),
                           ("capacity", capacity, (h,)),
                           ("last_flow", last_flow, (c,))):
        _check(f"torcells_span: {name}", t, i64, shape, dev)
    _check("torcells_span: ring", ring, RING_TORCH_DTYPE, (ring_len, f), dev)
    tv = np.asarray(targets.cpu() if torch.is_tensor(targets) else targets,
                    dtype=np.int64).reshape(-1)
    if not 1 <= len(tv) <= MAX_TARGETS:
        raise ValueError(f"torcells_span: 1 to {MAX_TARGETS} targets, got "
                         f"{len(tv)}")
    if tables is None:
        tables = SpanTables(flow_node, flow_lat, flow_succ, seg_start, h,
                            ring_len)
    # [0] t_stop, [1] forwards, [2] delivered_sum, [3:6] the per-tick
    # completion flags; the kernel initialises all six
    scalars = torch.empty(6, dtype=i64, device=dev)
    newly = torch.empty(c, dtype=torch.bool, device=dev)
    done_last = torch.empty(c, dtype=i64, device=dev)
    sent_delta = torch.empty(h, dtype=i64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    tv = np.ascontiguousarray(tv)
    rc = _bound("torcells_span", "torcells_span_launch", _SPAN_ARGTYPES)(
        queued.data_ptr(), ring.data_ptr(), tokens.data_ptr(),
        delivered.data_ptr(), target.data_ptr(), done_tick.data_ptr(),
        node_sent.data_ptr(), inject.data_ptr(), inject_target.data_ptr(),
        tables.node_off.data_ptr(), tables.arr_lat.data_ptr(),
        flow_succ.data_ptr(), refill.data_ptr(), capacity.data_ptr(),
        last_flow.data_ptr(), scalars.data_ptr(), newly.data_ptr(),
        done_last.data_ptr(), sent_delta.data_ptr(),
        f, h, c, int(ring_len), int(t0), int(idle_ticks),
        len(tv), tv.ctypes.data, stream)
    if rc != 0:
        raise RuntimeError(f"torcells_span kernel launch failed: CUDA error "
                           f"{rc} (F={f}, H={h}, C={c}, L={ring_len})")
    torcells_span.launches += 1
    state = (scalars[0], queued, ring, tokens, delivered, target, done_tick,
             node_sent, scalars[1])
    return state, (scalars[2], newly, done_last, sent_delta)


torcells_span.launches = 0


def pack_flush(forwards, delivered_sum, t_stop, newly: torch.Tensor,
               done_last: torch.Tensor, sent_delta: torch.Tensor,
               cap_chains: Optional[int] = None,
               cap_nodes: Optional[int] = None) -> torch.Tensor:
    """The packed flush on ``sent_delta``'s device.  CPU tensors run
    :func:`pack_flush_torch` (``forwards``, ``delivered_sum`` and
    ``t_stop`` may be ints there); CUDA tensors launch csrc/pack_flush.cu
    on the current stream (no synchronisation), reading those three from
    0-d int64 tensors on the card, and count ``pack_flush.launches``."""
    dev = sent_delta.device
    if dev.type == "cpu":
        return pack_flush_torch(forwards, delivered_sum, t_stop, newly,
                                done_last, sent_delta, cap_chains, cap_nodes)
    if dev.type != "cuda":
        raise ValueError(f"pack_flush: unsupported device {dev}")
    c = newly.shape[0]
    h = sent_delta.shape[0]
    _check("pack_flush: newly", newly, torch.bool, (c,), dev)
    _check("pack_flush: done_last", done_last, torch.int64, (c,), dev)
    _check("pack_flush: sent_delta", sent_delta, torch.int64, (h,), dev)
    heads = (forwards, delivered_sum, t_stop)
    for name, v in zip(("forwards", "delivered_sum", "t_stop"), heads):
        if not torch.is_tensor(v):
            raise ValueError(f"pack_flush: {name} must be a 0-d int64 "
                             "tensor on the card")
        _check(f"pack_flush: {name}", v, torch.int64, (), dev)
    cc = c if cap_chains is None else min(int(cap_chains), c)
    hh = h if cap_nodes is None else min(int(cap_nodes), h)
    buf = torch.empty(flush_len(c, h, cap_chains, cap_nodes),
                      dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _bound("pack_flush", "pack_flush_launch", _PACK_ARGTYPES)(
        heads[0].data_ptr(), heads[1].data_ptr(), heads[2].data_ptr(),
        newly.data_ptr(), done_last.data_ptr(), sent_delta.data_ptr(),
        buf.data_ptr(), c, h, cc, hh, stream)
    if rc != 0:
        raise RuntimeError(f"pack_flush kernel launch failed: CUDA error "
                           f"{rc} (C={c}, H={h})")
    pack_flush.launches += 1
    return buf


pack_flush.launches = 0


def torcells_step_window_flush(t0, queued, ring, tokens, delivered, target,
                               done_tick, node_sent, inject, inject_target,
                               targets, idle_ticks, flow_node, flow_lat,
                               flow_succ, seg_start, refill, capacity,
                               last_flow, ring_len: int,
                               cap_chains: Optional[int] = None,
                               cap_nodes: Optional[int] = None,
                               tables: Optional[SpanTables] = None):
    """Superwindow step + packed flush (the JAX package's
    ``_step_span_flush_impl`` argument list and 10-tuple).  On CPU tensors
    the plain versions; on CUDA tensors one launch of each kernel on the
    current stream, with the carried state updated in place.  ``tables``
    (a :class:`SpanTables` of this flow table) saves re-deriving it."""
    if queued.device.type == "cpu":
        return torcells_step_window_flush_reference(
            t0, queued, ring, tokens, delivered, target, done_tick,
            node_sent, inject, inject_target, targets, idle_ticks,
            flow_node, flow_lat, flow_succ, seg_start, refill, capacity,
            last_flow, ring_len, cap_chains, cap_nodes,
            arr_lat=None if tables is None else tables.arr_lat)
    state, (delivered_sum, newly, done_last, sent_delta) = torcells_span(
        t0, queued, ring, tokens, delivered, target, done_tick, node_sent,
        inject, inject_target, targets, idle_ticks, flow_node, flow_lat,
        flow_succ, seg_start, refill, capacity, last_flow, ring_len,
        tables=tables)
    flush = pack_flush(state[8], delivered_sum, state[0], newly, done_last,
                       sent_delta, cap_chains, cap_nodes)
    return (*state, flush)


def from_jax_state(state, flow_args, device) -> Tuple[tuple, tuple]:
    """The JAX plane's carried state (its ``_state`` 8-tuple: t, queued,
    ring, tokens, delivered, target, done_tick, node_sent) and static
    tables (its ``_flow_args()`` 7-tuple: flow_node, flow_lat_steps,
    flow_succ, seg_start, refill_step, capacity_step, last_flow), given as
    numpy arrays, as the port's tensors on ``device``: t stays a Python
    int, the ring is int32, everything else int64.  The JAX mesh's padded
    state carries over the same way: the port keeps its global layout
    (``[D*pad]`` flow arrays, ``[D*h_pad]`` node arrays, the ``[L, D*pad]``
    ring split by columns), and ``flow_args`` is then the mesh step's
    7-tuple of layout statics (flow_node_local, succ_global,
    seg_start_local, refill, capacity, arr_lat, shard_base)."""
    t, *arrays = state
    out = [int(t)]
    for i, a in enumerate(arrays):
        dtype = RING_DTYPE if i == 1 else np.int64
        out.append(torch.as_tensor(
            np.ascontiguousarray(np.asarray(a), dtype=dtype), device=device))
    tables = tuple(torch.as_tensor(np.ascontiguousarray(
        np.asarray(a), dtype=np.int64), device=device) for a in flow_args)
    return tuple(out), tables


# ---------------------------------------------------------------------------
# The fleet plane's batched step: W independent lanes per launch
# ---------------------------------------------------------------------------

# the batched span kernel keeps each lane's loop control in shared memory
# (csrc/torcells_span_batched.cu MAX_LANES)
MAX_LANES = 256


def lane_span_tables(flow_node, flow_lat, flow_succ, seg_start,
                     n_nodes: int, ring_len: int) -> Tuple[np.ndarray,
                                                           np.ndarray]:
    """What the batched span kernel derives from one lane's flow table
    (numpy, [F] each): ``node_off`` [H+1] (node n paces flows
    ``node_off[n]:node_off[n+1]``) and ``arr_lat`` [F].  The kernel walks a
    node's flows serially and restarts the greedy allocation at every flow
    that opens a ``seg_start`` segment, which is the JAX segmented cumsum
    exactly when flow_node is sorted and every segment is a contiguous run
    of one node's flows; it needs every arrival latency in [1, ring_len).
    A table breaking either is refused here.  (Unlike the serial kernel's
    :class:`SpanTables`, a node's run may hold several segments: the fleet's
    padding flows are each their own segment.)"""
    fn = np.asarray(flow_node, dtype=np.int64)
    ss = np.asarray(seg_start, dtype=np.int64)
    succ = np.asarray(flow_succ, dtype=np.int64)
    lat = np.asarray(flow_lat, dtype=np.int64)
    f = len(fn)
    if f and (np.any(np.diff(fn) < 0) or fn[0] < 0 or fn[-1] >= n_nodes):
        raise ValueError("torcells_span_batched: flow_node must be sorted "
                         "and in [0, H)")
    if f:
        cont = (ss == np.r_[-1, ss[:-1]]) & (fn == np.r_[-1, fn[:-1]])
        if not np.all((ss == np.arange(f)) | cont):
            raise ValueError("torcells_span_batched: every seg_start "
                             "segment must be a contiguous run of one "
                             "node's flows")
    is_last = succ < 0
    arr_lat = np.zeros(f, dtype=np.int64)
    np.add.at(arr_lat, np.maximum(succ, 0), np.where(is_last, 0, lat))
    has_pred = np.zeros(f, dtype=bool)
    has_pred[succ[succ >= 0]] = True
    if np.any(has_pred & ((arr_lat < 1) | (arr_lat >= ring_len))):
        raise ValueError("torcells_span_batched: every arrival latency "
                         "must be in [1, ring_len)")
    node_off = np.searchsorted(fn, np.arange(n_nodes + 1),
                               side="left").astype(np.int64)
    return node_off, arr_lat


class BatchedSpanTables:
    """The batched span kernel's derived tables, [W]-leading tensors on one
    device: ``node_off`` [W, H+1] and ``arr_lat`` [W, F].  Built from the
    [W]-leading flow tables (:meth:`build`), or stacked from per-lane
    :func:`lane_span_tables` results, which the fleet plane computes once
    per lane."""

    __slots__ = ("node_off", "arr_lat")

    def __init__(self, node_off: torch.Tensor, arr_lat: torch.Tensor):
        self.node_off = node_off
        self.arr_lat = arr_lat

    @classmethod
    def build(cls, flow_node, flow_lat, flow_succ, seg_start, n_nodes: int,
              ring_len: int) -> "BatchedSpanTables":
        host = [t.cpu().numpy() for t in (flow_node, flow_lat, flow_succ,
                                           seg_start)]
        lanes = [lane_span_tables(*(a[w] for a in host), n_nodes, ring_len)
                 for w in range(flow_node.shape[0])]
        dev = flow_node.device
        return cls(torch.as_tensor(np.stack([n for n, _ in lanes]),
                                   device=dev),
                   torch.as_tensor(np.stack([a for _, a in lanes]),
                                   device=dev))


_SPAN_B_ARGTYPES = [_VP] * 21 + [_I64] * 6 + [_VP]
_PACK_B_ARGTYPES = [_VP] * 9 + [_I64] * 4 + [_VP]


def lane_args(t0, idle_ticks, targets, device) -> torch.Tensor:
    """The per-lane launch words as one [W, 2 + P] int64 tensor on
    ``device``: t0, idle ticks, then the lane's P superwindow boundaries."""
    t0 = np.asarray(t0.cpu() if torch.is_tensor(t0) else t0,
                    dtype=np.int64).reshape(-1, 1)
    idle = np.asarray(idle_ticks.cpu() if torch.is_tensor(idle_ticks)
                      else idle_ticks, dtype=np.int64).reshape(-1, 1)
    tv = np.asarray(targets.cpu() if torch.is_tensor(targets) else targets,
                    dtype=np.int64)
    if tv.ndim != 2 or tv.shape[0] != t0.shape[0] or tv.shape[1] < 1:
        raise ValueError(f"torcells_span_batched: targets must be [W, P], "
                         f"got {tv.shape} for W = {t0.shape[0]}")
    return torch.as_tensor(np.ascontiguousarray(
        np.concatenate([t0, idle, tv], axis=1)), device=device)


def torcells_span_batched(queued, ring, tokens, delivered, target,
                          done_tick, node_sent, inject, inject_target,
                          flow_succ, seg_start, refill, capacity, last_flow,
                          args: torch.Tensor, ring_len: int,
                          tables: BatchedSpanTables):
    """Launch csrc/torcells_span_batched.cu on [W]-leading CUDA tensors: every
    lane's superwindow in one cooperative launch on the current stream, no
    synchronisation; ``args`` is :func:`lane_args`.  The state tensors are
    updated in place.  Returns ``t_stop`` [W] and the pack's inputs:
    ``done_in`` [W, C] (done_tick[last_flow] at entry) and ``sent_in``
    [W, H] (node_sent at entry).  Counts ``torcells_span_batched.launches``."""
    dev = queued.device
    if dev.type != "cuda":
        raise ValueError(f"torcells_span_batched: needs CUDA tensors, got "
                         f"{dev}")
    w, f = queued.shape
    h = refill.shape[1]
    c = last_flow.shape[1]
    p = args.shape[1] - 2
    if not 1 <= w <= MAX_LANES or p < 1:
        raise ValueError(f"torcells_span_batched: 1 to {MAX_LANES} lanes "
                         f"and at least one target, got W={w}, P={p}")
    i64 = torch.int64
    for name, t, shape in (("queued", queued, (w, f)),
                           ("tokens", tokens, (w, h)),
                           ("delivered", delivered, (w, f)),
                           ("target", target, (w, f)),
                           ("done_tick", done_tick, (w, f)),
                           ("node_sent", node_sent, (w, h)),
                           ("inject", inject, (w, f)),
                           ("inject_target", inject_target, (w, f)),
                           ("flow_succ", flow_succ, (w, f)),
                           ("seg_start", seg_start, (w, f)),
                           ("refill", refill, (w, h)),
                           ("capacity", capacity, (w, h)),
                           ("last_flow", last_flow, (w, c)),
                           ("args", args, (w, p + 2)),
                           ("node_off", tables.node_off, (w, h + 1)),
                           ("arr_lat", tables.arr_lat, (w, f))):
        _check(f"torcells_span_batched: {name}", t, i64, shape, dev)
    _check("torcells_span_batched: ring", ring, RING_TORCH_DTYPE,
           (w, ring_len, f), dev)
    t_stop = torch.empty(w, dtype=i64, device=dev)
    flags = torch.empty(3 * w, dtype=i64, device=dev)
    done_in = torch.empty((w, c), dtype=i64, device=dev)
    sent_in = torch.empty((w, h), dtype=i64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _bound("torcells_span_batched", "torcells_span_batched_launch",
                _SPAN_B_ARGTYPES)(
        queued.data_ptr(), ring.data_ptr(), tokens.data_ptr(),
        delivered.data_ptr(), target.data_ptr(), done_tick.data_ptr(),
        node_sent.data_ptr(), inject.data_ptr(), inject_target.data_ptr(),
        tables.node_off.data_ptr(), tables.arr_lat.data_ptr(),
        seg_start.data_ptr(), flow_succ.data_ptr(), refill.data_ptr(),
        capacity.data_ptr(), last_flow.data_ptr(), args.data_ptr(),
        t_stop.data_ptr(), flags.data_ptr(), done_in.data_ptr(),
        sent_in.data_ptr(), w, f, h, c, int(ring_len), p, stream)
    if rc != 0:
        raise RuntimeError(f"torcells_span_batched kernel launch failed: "
                           f"CUDA error {rc} (W={w}, F={f}, H={h}, C={c}, "
                           f"L={ring_len})")
    torcells_span_batched.launches += 1
    return t_stop, done_in, sent_in


torcells_span_batched.launches = 0


def pack_flush_batched_torch(t_stop, done_in, done_tick, last_flow,
                             delivered, sent_in, node_sent):
    """Plain torch version of the batched pack: per lane, the newly-done
    chains (done_tick[last_flow] set now, not at entry), the nodes whose
    node_sent moved, the delivered sum over chain exits and the forwards
    (every served cell added CELL_WIRE_BYTES to its node's node_sent, so
    forwards = the sent bytes' total / CELL_WIRE_BYTES), packed as
    :func:`pack_flush_torch` packs one lane.  Returns (flush [W, len],
    forwards [W])."""
    bufs, fwds = [], []
    for w in range(done_in.shape[0]):
        done_last = done_tick[w][last_flow[w]]
        newly = (done_last >= 0) & (done_in[w] < 0)
        delta = node_sent[w] - sent_in[w]
        fwd = torch.div(delta.sum(), CELL_WIRE_BYTES, rounding_mode="floor")
        bufs.append(pack_flush_torch(fwd, delivered[w][last_flow[w]].sum(),
                                     t_stop[w], newly, done_last, delta))
        fwds.append(fwd)
    return torch.stack(bufs), torch.stack(fwds)


def pack_flush_batched(t_stop, done_in, done_tick, last_flow, delivered,
                       sent_in, node_sent):
    """The batched pack on CUDA tensors: one launch of the batched entry of
    csrc/pack_flush.cu (one block per lane) on the current stream, no
    synchronisation.  Returns (flush [W, 5 + 2C + 2H], forwards [W]), as
    :func:`pack_flush_batched_torch` does; CPU tensors run that.  Counts
    ``pack_flush_batched.launches``."""
    dev = node_sent.device
    if dev.type == "cpu":
        return pack_flush_batched_torch(t_stop, done_in, done_tick,
                                        last_flow, delivered, sent_in,
                                        node_sent)
    if dev.type != "cuda":
        raise ValueError(f"pack_flush_batched: unsupported device {dev}")
    w, f = done_tick.shape
    c = last_flow.shape[1]
    h = node_sent.shape[1]
    i64 = torch.int64
    for name, t, shape in (("t_stop", t_stop, (w,)),
                           ("done_in", done_in, (w, c)),
                           ("done_tick", done_tick, (w, f)),
                           ("last_flow", last_flow, (w, c)),
                           ("delivered", delivered, (w, f)),
                           ("sent_in", sent_in, (w, h)),
                           ("node_sent", node_sent, (w, h))):
        _check(f"pack_flush_batched: {name}", t, i64, shape, dev)
    buf = torch.empty((w, flush_len(c, h)), dtype=i64, device=dev)
    forwards = torch.empty(w, dtype=i64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _bound("pack_flush", "pack_flush_batched_launch", _PACK_B_ARGTYPES)(
        t_stop.data_ptr(), done_in.data_ptr(), done_tick.data_ptr(),
        last_flow.data_ptr(), delivered.data_ptr(), sent_in.data_ptr(),
        node_sent.data_ptr(), buf.data_ptr(), forwards.data_ptr(), w, f, c,
        h, stream)
    if rc != 0:
        raise RuntimeError(f"pack_flush_batched kernel launch failed: CUDA "
                           f"error {rc} (W={w}, C={c}, H={h})")
    pack_flush_batched.launches += 1
    return buf, forwards


pack_flush_batched.launches = 0


def torcells_step_span_flush_batched(t0, queued, ring, tokens, delivered,
                                     target, done_tick, node_sent, inject,
                                     inject_target, targets, idle_ticks,
                                     flow_node, flow_lat, flow_succ,
                                     seg_start, refill, capacity, last_flow,
                                     ring_len: int,
                                     tables: Optional[BatchedSpanTables]
                                     = None):
    """The fleet plane's step: the JAX package's vmapped
    ``torcells_step_span_flush_batched`` argument list and 10-tuple, every
    operand with a leading lane axis [W] (``t0``, ``idle_ticks`` [W];
    ``targets`` [W, P]).  On CPU tensors the plain version
    :func:`torcells_step_span_flush_batched_torch`; on CUDA tensors one
    launch of the batched span kernel and one of the batched pack, on the
    current stream, with the carried state updated in place.  ``tables``
    (:class:`BatchedSpanTables` of these flow tables) saves re-deriving
    them."""
    if queued.device.type == "cpu":
        return torcells_step_span_flush_batched_torch(
            t0, queued, ring, tokens, delivered, target, done_tick,
            node_sent, inject, inject_target, targets, idle_ticks,
            flow_node, flow_lat, flow_succ, seg_start, refill, capacity,
            last_flow, ring_len)
    if tables is None:
        tables = BatchedSpanTables.build(flow_node, flow_lat, flow_succ,
                                         seg_start, refill.shape[1],
                                         ring_len)
    args = lane_args(t0, idle_ticks, targets, queued.device)
    t_stop, done_in, sent_in = torcells_span_batched(
        queued, ring, tokens, delivered, target, done_tick, node_sent,
        inject, inject_target, flow_succ, seg_start, refill, capacity,
        last_flow, args, ring_len, tables)
    flush, forwards = pack_flush_batched(t_stop, done_in, done_tick,
                                         last_flow, delivered, sent_in,
                                         node_sent)
    return (t_stop, queued, ring, tokens, delivered, target, done_tick,
            node_sent, forwards, flush)


# ---------------------------------------------------------------------------
# The device-resident model workload: run to completion, and the windowed
# form (the JAX package's torcells_run, torcells_step_window, their numpy
# twins and DeviceTorCells)
# ---------------------------------------------------------------------------

def torcells_step_window_numpy(t0, queued, ring, tokens, delivered, target,
                               done_tick, node_sent, inject, inject_target,
                               n_ticks, idle_ticks, flow_node, flow_lat,
                               flow_succ, seg_start, refill, capacity,
                               ring_len: int):
    """Bit-identical host twin of torcells_step_window (same rule, same
    ring, same completion/byte accounting) — the parity gate's oracle and
    the --device-plane=numpy execution mode."""
    f = len(queued)
    h = len(refill)
    size = CELL_WIRE_BYTES
    is_last = flow_succ < 0
    queued = queued + inject
    target = target + inject_target
    tokens = np.minimum(capacity, tokens + refill * int(idle_ticks))
    if int(idle_ticks) > 0:
        ring = np.zeros_like(ring)   # idle jump: stale send history cleared
    arr_lat = np.zeros(f, dtype=np.int64)
    np.add.at(arr_lat, np.maximum(flow_succ, 0),
              np.where(is_last, 0, flow_lat))
    cols = np.arange(f)
    forwards = 0
    t = int(t0)
    for _ in range(int(n_ticks)):
        arr = ring[(t - arr_lat) % ring_len, cols]
        queued = queued + arr
        tokens = np.minimum(capacity, tokens + refill)
        cap_cells = tokens[flow_node] // size
        csum = np.cumsum(queued)
        seg_base = np.where(seg_start > 0, csum[np.maximum(seg_start - 1, 0)],
                            0) * (seg_start > 0)
        before = csum - queued - seg_base
        served = np.clip(cap_cells - before, 0, queued)
        queued = queued - served
        spent = np.bincount(flow_node, weights=served * size,
                            minlength=h).astype(np.int64)
        tokens = tokens - spent
        node_sent = node_sent + spent
        delivered = delivered + np.where(is_last, served, 0)
        newly_done = (is_last & (target > 0) & (done_tick < 0)
                      & (delivered >= target))
        done_tick = np.where(newly_done, t, done_tick)
        v = np.zeros(f, dtype=np.int64)
        np.add.at(v, np.maximum(flow_succ, 0), np.where(is_last, 0, served))
        ring[t % ring_len] = v
        forwards += int(served.sum())
        t += 1
    return (np.int64(t), queued, ring, tokens, delivered, target, done_tick,
            node_sent, np.int64(forwards))


def torcells_run_numpy(queued0, flow_node, flow_lat, flow_succ, seg_start,
                       refill, capacity, ring_len: int, max_ticks: int):
    """Bit-identical host twin (same allocation rule, same ring)."""
    f = len(queued0)
    h = len(refill)
    size = CELL_WIRE_BYTES
    is_last = flow_succ < 0
    queued = queued0.astype(np.int64).copy()
    ring = np.zeros((ring_len, f), dtype=np.int64)
    tokens = capacity.astype(np.int64).copy()
    delivered = np.zeros(f, dtype=np.int64)
    arr_lat = np.zeros(f, dtype=np.int64)
    np.add.at(arr_lat, np.maximum(flow_succ, 0),
              np.where(is_last, 0, flow_lat))
    cols = np.arange(f)
    forwards = 0
    t = 0
    total = int(queued0.sum())
    while delivered.sum() < total and t < max_ticks:
        arr = ring[(t - arr_lat) % ring_len, cols]
        queued += arr
        tokens = np.minimum(capacity, tokens + refill)
        cap_cells = tokens[flow_node] // size
        csum = np.cumsum(queued)
        seg_base = np.where(seg_start > 0, csum[np.maximum(seg_start - 1, 0)],
                            0) * (seg_start > 0)
        before = csum - queued - seg_base
        served = np.clip(cap_cells - before, 0, queued)
        queued -= served
        spent = np.bincount(flow_node, weights=served * size,
                            minlength=h).astype(np.int64)
        tokens -= spent
        delivered += np.where(is_last, served, 0)
        v = np.zeros(f, dtype=np.int64)
        np.add.at(v, np.maximum(flow_succ, 0), np.where(is_last, 0, served))
        ring[t % ring_len] = v
        forwards += int(served.sum())
        t += 1
    return delivered, t, forwards


def torcells_run_torch(queued0, flow_node, flow_lat, flow_succ, seg_start,
                       refill, capacity, ring_len: int, max_ticks,
                       arr_lat: Optional[torch.Tensor] = None):
    """Plain torch version of the JAX package's ``torcells_run``: from an
    all-zero int64 [L, F] ring and full buckets, tick until every queued
    cell is delivered or ``max_ticks``.  Returns (delivered int64 [F], the
    ticks run and the forwards, both 0-d int64 tensors).  Pure.  It reads
    the delivered sum on the host each tick, which is the plain version's
    privilege; the kernel decides its halt on the card."""
    dev = queued0.device
    f = queued0.shape[0]
    h = refill.shape[0]
    size = CELL_WIRE_BYTES
    i64 = torch.int64
    is_last = flow_succ < 0
    zero_f = torch.zeros(f, dtype=i64, device=dev)
    queued = queued0.clone()
    ring = torch.zeros((ring_len, f), dtype=i64, device=dev)
    tokens = capacity.clone()
    delivered = zero_f.clone()
    if arr_lat is None:
        arr_lat = arrival_latency(flow_lat, flow_succ)
    cols = torch.arange(f, device=dev)
    succ0 = flow_succ.clamp(min=0)
    has_base = seg_start > 0
    base_idx = (seg_start - 1).clamp(min=0)
    total = int(queued0.sum())
    max_ticks = int(max_ticks)
    forwards = torch.zeros((), dtype=i64, device=dev)
    t = 0
    while int(delivered.sum()) < total and t < max_ticks:
        queued = queued + ring[torch.remainder(t - arr_lat, ring_len), cols]
        tokens = torch.minimum(capacity, tokens + refill)
        assert bool((tokens >= 0).all()), "torcells: negative tokens"
        cap_cells = torch.div(tokens[flow_node], size, rounding_mode="floor")
        csum = torch.cumsum(queued, 0)
        before = csum - queued - torch.where(has_base, csum[base_idx],
                                             zero_f)
        served = torch.minimum((cap_cells - before).clamp(min=0), queued)
        queued = queued - served
        tokens = tokens - torch.zeros(h, dtype=i64, device=dev).index_add_(
            0, flow_node, served * size)
        delivered = delivered + torch.where(is_last, served, zero_f)
        ring[t % ring_len] = torch.zeros(f, dtype=i64, device=dev) \
            .index_add_(0, succ0, torch.where(is_last, zero_f, served))
        forwards = forwards + served.sum()
        t += 1
    return delivered, torch.tensor(t, dtype=i64, device=dev), forwards


_RUN_ARGTYPES = [_VP] * 11 + [_I64] * 4 + [_VP]


def torcells_run(queued0, flow_node, flow_lat, flow_succ, seg_start, refill,
                 capacity, ring_len: int, max_ticks,
                 tables: Optional[SpanTables] = None):
    """Run the cell model until every cell is delivered or ``max_ticks``
    (the JAX package's ``torcells_run`` argument list, every operand int64).
    On CPU tensors the plain version; on CUDA tensors one cooperative launch
    of csrc/torcells_run.cu on the current stream, no synchronisation,
    counted in ``torcells_run.launches``; ``tables`` (a :class:`SpanTables`
    of this flow table) saves re-deriving and re-checking it.  Returns
    (delivered int64 [F], ticks, forwards), the last two 0-d int64 tensors
    on the operands' device."""
    dev = queued0.device
    if dev.type == "cpu":
        return torcells_run_torch(
            queued0, flow_node, flow_lat, flow_succ, seg_start, refill,
            capacity, ring_len, max_ticks,
            arr_lat=None if tables is None else tables.arr_lat)
    if dev.type != "cuda":
        raise ValueError(f"torcells_run: unsupported device {dev}")
    f = queued0.shape[0]
    h = refill.shape[0]
    i64 = torch.int64
    for name, t, shape in (("queued0", queued0, (f,)),
                           ("flow_node", flow_node, (f,)),
                           ("flow_lat", flow_lat, (f,)),
                           ("flow_succ", flow_succ, (f,)),
                           ("seg_start", seg_start, (f,)),
                           ("refill", refill, (h,)),
                           ("capacity", capacity, (h,))):
        _check(f"torcells_run: {name}", t, i64, shape, dev)
    if f < 1 or h < 1:
        raise ValueError(f"torcells_run: needs F >= 1 and H >= 1, got F={f}, "
                         f"H={h}")
    if tables is None:
        tables = SpanTables(flow_node, flow_lat, flow_succ, seg_start, h,
                            ring_len)
    queued = torch.empty(f, dtype=i64, device=dev)
    ring = torch.empty((ring_len, f), dtype=i64, device=dev)
    tokens = torch.empty(h, dtype=i64, device=dev)
    delivered = torch.empty(f, dtype=i64, device=dev)
    # [0] ticks, [1] forwards, [2] the cells queued, [3:6] the per-tick
    # delivered sums; the kernel adds into them
    scalars = torch.zeros(6, dtype=i64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _bound("torcells_run", "torcells_run_launch", _RUN_ARGTYPES)(
        queued0.data_ptr(), tables.node_off.data_ptr(),
        tables.arr_lat.data_ptr(), flow_succ.data_ptr(), refill.data_ptr(),
        capacity.data_ptr(), queued.data_ptr(), ring.data_ptr(),
        tokens.data_ptr(), delivered.data_ptr(), scalars.data_ptr(), f, h,
        int(ring_len), int(max_ticks), stream)
    if rc != 0:
        raise RuntimeError(f"torcells_run kernel launch failed: CUDA error "
                           f"{rc} (F={f}, H={h}, L={ring_len})")
    torcells_run.launches += 1
    return delivered, scalars[0], scalars[1]


torcells_run.launches = 0


def _window_ring_check(ring: torch.Tensor, capacity: torch.Tensor) -> None:
    """The windowed step keeps its send ring in RING_TORCH_DTYPE (the span
    kernel's int32): refuse any other dtype, and a bucket whose one-tick
    burst (capacity / CELL_WIRE_BYTES cells) would not fit in it."""
    if ring.dtype != RING_TORCH_DTYPE:
        raise TypeError(f"torcells_step_window: the ring must be "
                        f"{RING_TORCH_DTYPE} (the span kernel's), got "
                        f"{ring.dtype}")
    if capacity.numel() and int(capacity.max()) // CELL_WIRE_BYTES \
            > torch.iinfo(RING_TORCH_DTYPE).max:
        raise ValueError("torcells_step_window: a bucket's one-tick burst "
                         "does not fit in the int32 ring")


def torcells_step_window_torch(t0, queued, ring, tokens, delivered, target,
                               done_tick, node_sent, inject, inject_target,
                               n_ticks, idle_ticks, flow_node, flow_lat,
                               flow_succ, seg_start, refill, capacity,
                               ring_len: int,
                               arr_lat: Optional[torch.Tensor] = None):
    """Plain torch version of the JAX package's ``torcells_step_window``:
    fold the injections and ``idle_ticks``, then advance EXACTLY
    ``n_ticks`` ticks, which is :func:`torcells_step_span_torch` with the
    one boundary ``t0 + n_ticks``.  Returns its 9-tuple.  Pure."""
    _window_ring_check(ring, capacity)
    return torcells_step_span_torch(
        t0, queued, ring, tokens, delivered, target, done_tick, node_sent,
        inject, inject_target, [int(t0) + int(n_ticks)], idle_ticks,
        flow_node, flow_lat, flow_succ, seg_start, refill, capacity,
        ring_len, arr_lat=arr_lat)


def torcells_step_window(t0, queued, ring, tokens, delivered, target,
                         done_tick, node_sent, inject, inject_target,
                         n_ticks, idle_ticks, flow_node, flow_lat, flow_succ,
                         seg_start, refill, capacity, ring_len: int,
                         tables: Optional[SpanTables] = None):
    """The windowed step (the JAX package's ``torcells_step_window``
    argument list and 9-tuple: t, queued, ring, tokens, delivered, target,
    done_tick, node_sent, forwards).  The ring must be int32.  On CPU
    tensors the plain version; on CUDA tensors one launch of the span
    kernel (csrc/torcells_span.cu, counted in ``torcells_span.launches``)
    with the single boundary ``t0 + n_ticks``, which runs exactly n_ticks
    ticks whatever completes, and the carried state updated in place (the
    JAX package donated it).  t and forwards come back as 0-d int64
    tensors."""
    if queued.device.type == "cpu":
        return torcells_step_window_torch(
            t0, queued, ring, tokens, delivered, target, done_tick,
            node_sent, inject, inject_target, n_ticks, idle_ticks, flow_node,
            flow_lat, flow_succ, seg_start, refill, capacity, ring_len,
            arr_lat=None if tables is None else tables.arr_lat)
    _window_ring_check(ring, capacity)
    no_chains = torch.empty(0, dtype=torch.int64, device=queued.device)
    state, _flush_inputs = torcells_span(
        t0, queued, ring, tokens, delivered, target, done_tick, node_sent,
        inject, inject_target, [int(t0) + int(n_ticks)], idle_ticks,
        flow_node, flow_lat, flow_succ, seg_start, refill, capacity,
        no_chains, ring_len, tables=tables)
    return state


class DeviceTorCells:
    """Build a circuits-over-relays instance and run it on ``device``
    (default the card; ``"cpu"`` runs the plain version).  The arrays are
    the JAX class's, made by the same numpy calls in the same order."""

    def __init__(self, n_relays: int, n_circuits: int, seed: int = 7,
                 relay_bw_kibps: int = 2048, edge_bw_kibps: int = 1 << 20,
                 max_latency_ms: int = 120, device: str = "cuda"):
        rng = np.random.default_rng(seed)
        # nodes: [clients | relays | servers] — clients/servers effectively
        # unthrottled, relays are the contended resource
        n_clients = n_circuits
        n_servers = max(1, n_circuits // 50)
        h = n_clients + n_relays + n_servers
        lat = rng.integers(2, max_latency_ms, size=(h, h)).astype(np.int64)
        np.fill_diagonal(lat, 1)
        bw = np.full(h, edge_bw_kibps, dtype=np.int64)
        bw[n_clients:n_clients + n_relays] = relay_bw_kibps
        refill, cap = bucket_params(bw)
        self.refill = refill.astype(np.int64)
        self.capacity = cap.astype(np.int64)
        # routes: distinct guard/middle/exit per circuit
        route = np.empty((n_circuits, 5), dtype=np.int64)
        route[:, 4] = np.arange(n_circuits)                       # client
        route[:, 0] = n_clients + n_relays + rng.integers(
            0, n_servers, size=n_circuits)                        # server
        picks = rng.random((n_circuits, n_relays)).argsort(axis=1)[:, :3]
        route[:, 1:4] = n_clients + picks                         # e, m, g
        self.flows = build_flows(route, lat)
        self.ring_len = int(max_latency_ms) + 2
        self.n_flows = n_circuits * 5
        self.route = route
        self.device = resolve_device(device)
        fl = self.flows
        self.tensors = tuple(torch.as_tensor(a, device=self.device) for a in (
            fl["flow_node"], fl["flow_lat"], fl["flow_succ"], fl["seg_start"],
            self.refill, self.capacity))
        self.tables = SpanTables(*self.tensors[:4], h, self.ring_len)

    def _args(self, cells_per_circuit: int):
        fl = self.flows
        queued0 = np.where(fl["flow_stage"] == 0, cells_per_circuit, 0) \
            .astype(np.int64)
        return queued0, fl

    def run_device(self, cells_per_circuit: int, max_ticks: int):
        """One call of :func:`torcells_run` (on the card: queued0 uploaded,
        one launch, the results read back).  Returns numpy delivered [F],
        the ticks and the forwards as ints."""
        queued0, _fl = self._args(cells_per_circuit)
        delivered, ticks, forwards = torcells_run(
            torch.as_tensor(queued0, device=self.device), *self.tensors,
            self.ring_len, max_ticks, tables=self.tables)
        return delivered.cpu().numpy(), int(ticks), int(forwards)

    def run_numpy(self, cells_per_circuit: int, max_ticks: int):
        queued0, fl = self._args(cells_per_circuit)
        d, t, fw = torcells_run_numpy(queued0, fl["flow_node"],
                                      fl["flow_lat"], fl["flow_succ"],
                                      fl["seg_start"], self.refill,
                                      self.capacity, self.ring_len,
                                      max_ticks)
        return d, t, fw
