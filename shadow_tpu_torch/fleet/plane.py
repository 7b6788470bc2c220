"""FleetPlane: the shared batched traffic plane.

Every device-mode run owns its own plane and pays a launch per dispatch;
this module batches N independent scenarios into ONE stacked launch so one
launch advances all of them.  The split that unlocks it: per-scenario
plane *state* stays with each lane (real-shaped, carried between
dispatches by the lane's own DeviceTrafficPlane), while the *launch shape*
is shared per shape class — scenarios whose padded shapes coincide ride
the same batched launch.

Shape classes pad flows/nodes/chains and the targets vector up to
power-of-two buckets with INERT rows (padding flows are their own
zero-cell segment with no successor and target 0 — identically zero
forever, so pad -> step -> unpad is bit-exact), while ``ring_len`` stays
EXACT per class (the arrival ring's mod-slot layout is position-dependent;
length-padding it would re-address history carried between dispatches).
When chain padding is needed the flow axis is padded by at least one row
so the padded ``last_flow`` entries can point at a guaranteed-zero flow
(keeping the flush header's ``delivered_sum`` exact).

Batch width per class is STICKY (starts at the first launch's
power-of-two, only grows); under-full launches are topped up with inert
filler lanes whose targets equal their base step — the batched loop
freezes them before the first iteration.  Sticky width + fillers is what
makes lane re-arm shape-stable: a living class's launch shape (shapes,
width, ring_len) never changes, and ``FleetPlane.compiles`` counts the
distinct (class, width) launch shapes the plane ever launched (the name is
the JAX package's, whose jit compiled one program per shape; the port's
kernels are built once and take any shape) — the re-arm drill asserts it
stays flat.

Lanes at different rounds coexist in one launch: each lane submits its
OWN superwindow targets vector and gets back its OWN ``t_stop``, which the
lane's engine maps back through its own ``_SuperPlan`` exactly as in the
serial path.  All kernel math is int64 integer arithmetic, so each batched
lane is bit-identical to the unbatched step — the property the fleet
digest gate (``simfleet smoke``) rides on.

The port's copy.  The plane lives on one device (``FleetPlane(device=...)``,
cuda unless the caller asks for the CPU); a lane whose DeviceTrafficPlane
sits on another device is refused.  A lane's carried state stays a set of
torch tensors on that device: a launch pads and stacks the parked lanes'
rows into [W, ...] tensors there, runs
``ops.torcells_device.torcells_step_span_flush_batched`` (on the card one
launch each of the batched span and pack kernels, on the CPU their plain
version), and hands each lane row views of the results; the [W] flush
buffers come to the host in one copy per launch.  Padding flows are spread
over the class's padding nodes (the JAX package hangs them all on node
H-1): the kernel gives each node's run to one block as part of a tile, so
tens of thousands of them on one node would be one very long tile, and
they are inert on any node.  ``use_numpy=True`` (``--numpy``) is an
explicit debugging switch that runs the batched numpy twin instead, never
a fallback.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch


def _pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << int(n - 1).bit_length()


def _pad_vec(a: np.ndarray, n: int, fill: int = 0) -> np.ndarray:
    a = np.asarray(a)
    out = np.full(n, fill, dtype=a.dtype)
    out[: len(a)] = a
    return out


def _repack_flush(buf: np.ndarray, pad_c: int, pad_h: int, c: int,
                  h: int) -> np.ndarray:
    """Re-section a padded-class flush buffer [5+2*pad_c+2*pad_h] to the
    lane's real [5+2c+2h] layout.  Padding chains never complete and
    padding nodes never carry deltas, so every recorded index is < c/h
    and the true header counts are <= c/h — a straight section copy."""
    from ..ops.torcells_device import FLUSH_HEADER, flush_len
    buf = np.asarray(buf)
    if pad_c == c and pad_h == h:
        return buf.copy()
    out = np.zeros(flush_len(c, h), np.int64)
    out[:FLUSH_HEADER] = buf[:FLUSH_HEADER]
    n_done = int(buf[2])
    n_touch = int(buf[3])
    base = FLUSH_HEADER
    out[base:base + n_done] = buf[base:base + n_done]
    out[base + c:base + c + n_done] = buf[base + pad_c:base + pad_c + n_done]
    out[base + 2 * c:base + 2 * c + n_touch] = \
        buf[base + 2 * pad_c:base + 2 * pad_c + n_touch]
    out[base + 2 * c + h:base + 2 * c + h + n_touch] = \
        buf[base + 2 * pad_c + pad_h:base + 2 * pad_c + pad_h + n_touch]
    return out


def _pad_nodes(f: int, f2: int, h: int, h2: int) -> np.ndarray:
    """Nodes of the padding flows f..f2-1: spread evenly, ascending, over
    the padding nodes h..h2-1 (on node h2-1 alone when there are none)."""
    n = f2 - f
    if h2 == h:
        return np.full(n, h2 - 1, dtype=np.int64)
    return h + (np.arange(n, dtype=np.int64) * (h2 - h)) // max(n, 1)


def _lane_tables(flow_node, flow_lat, flow_succ, seg_start, refill,
                 capacity, last_flow, f2: int, h2: int, c2: int,
                 ring_len: int):
    """One lane's static tables padded into the class (numpy int64:
    flow_node, flow_lat, flow_succ, seg_start, refill, capacity,
    last_flow) and the batched span kernel's derived (node_off, meta,
    tiles)."""
    from ..ops.torcells_device import lane_span_tables
    i64 = np.int64
    f = len(flow_node)
    h = len(refill)
    tables = (
        np.concatenate([np.asarray(flow_node, i64),
                        _pad_nodes(f, f2, h, h2)]),
        _pad_vec(np.asarray(flow_lat, i64), f2, 0),
        _pad_vec(np.asarray(flow_succ, i64), f2, -1),
        # padding flows are each their own (empty) segment
        np.concatenate([np.asarray(seg_start, i64),
                        np.arange(f, f2, dtype=i64)]),
        _pad_vec(np.asarray(refill, i64), h2, 0),
        _pad_vec(np.asarray(capacity, i64), h2, 0),
        # padded chains exit through a guaranteed-zero padding flow
        _pad_vec(np.asarray(last_flow, i64), c2, f2 - 1),
    )
    derived = lane_span_tables(tables[0], tables[1], tables[2], tables[3],
                               h2, ring_len)
    return tables, derived


class _ShapeClass:
    """One padded shape bucket: (flows, nodes, chains, targets) padded to
    powers of two, ring_len exact.  Owns the sticky batch width and the
    inert filler lane every under-full launch is topped up with."""

    __slots__ = ("key", "f2", "h2", "c2", "p2", "ring_len", "width",
                 "_filler")

    def __init__(self, f2: int, h2: int, c2: int, p2: int, ring_len: int):
        self.key = (f2, h2, c2, p2, ring_len)
        self.f2 = f2
        self.h2 = h2
        self.c2 = c2
        self.p2 = p2
        self.ring_len = ring_len
        self.width = 0          # sticky: set at first launch, only grows
        self._filler = None

    def filler_tables(self, device) -> tuple:
        """The inert lane's tables (a member with no traffic) on
        ``device``: the seven flow tables, then the derived node_off,
        meta and tiles (see :func:`_lane_tables`); its state is zero, its
        done_tick -1, and its targets all equal its base step 0 (the
        batched loop is false for it before the first iteration) — the
        fill values a launch stages every row with."""
        if self._filler is None:
            from ..ops.torcells_device import lane_span_tables
            f2, h2, c2 = self.f2, self.h2, self.c2
            i64 = np.int64
            tables = (np.full(f2, h2 - 1, i64),          # flow_node
                      np.zeros(f2, i64),                 # flow_lat
                      np.full(f2, -1, i64),              # flow_succ
                      np.arange(f2, dtype=i64),          # seg_start
                      np.zeros(h2, i64),                 # refill
                      np.zeros(h2, i64),                 # capacity
                      np.full(c2, f2 - 1, i64))          # last_flow
            derived = lane_span_tables(*tables[:4], h2, self.ring_len)
            self._filler = tuple(torch.as_tensor(a, device=device)
                                 for a in tables + derived)
        return self._filler


class _Submit:
    """One lane's staged dispatch: its real-shaped state rows, injections
    (numpy, or None for none), padded targets and idle ticks, filled in
    with its result row (or an error) by the launching thread."""

    __slots__ = ("lane", "state", "inject", "inject_target", "tvec", "idle",
                 "result", "error")

    def __init__(self, lane: "FleetLane", state: tuple, inject,
                 inject_target, tvec: np.ndarray, idle: int):
        self.lane = lane
        self.state = state
        self.inject = inject
        self.inject_target = inject_target
        self.tvec = tvec
        self.idle = idle
        self.result: Optional[tuple] = None
        self.error: Optional[BaseException] = None


class FleetLane:
    """Per-scenario handle: attaches to the scenario's DeviceTrafficPlane
    (via ``options._fleet_lane``), joins its shape class, and blocks on
    each dispatch until the shared batched launch returns its row.
    ``dispatch`` is synchronous — the already-digest-pinned
    ``--device-plane-sync`` shape — so the owning engine sees exactly the
    serial plane contract."""

    __slots__ = ("plane", "name", "serial", "cls", "shape", "_tables",
                 "dispatches")

    def __init__(self, plane: "FleetPlane", name: str, serial: int):
        self.plane = plane
        self.name = name
        self.serial = serial
        self.cls: Optional[_ShapeClass] = None
        self.shape: Optional[Tuple[int, int, int, int, int]] = None
        self._tables = None
        self.dispatches = 0

    # -- driver-facing lifecycle ------------------------------------------
    def begin(self) -> None:
        self.plane._lane_begin()

    def end(self) -> None:
        self.plane._lane_end()

    # -- device-plane-facing ----------------------------------------------
    def attach_plane(self, dev_plane) -> None:
        """Join (or re-join: a --resume second pass re-attaches with the
        same shapes) the shape class for this plane's flow table and keep
        the padded static tables on the fleet's device.  A plane on
        another device than the fleet's is refused."""
        if dev_plane.device != self.plane.device:
            raise ValueError(
                f"fleet lane {self.name}: its device plane is on "
                f"{dev_plane.device}, the fleet plane on {self.plane.device}"
                " (pass the same --device to both)")
        f, h, c = dev_plane.n_flows, dev_plane.n_nodes, dev_plane.n_chains
        p, ring_len = dev_plane.superwindow_rounds, dev_plane.ring_len
        self.shape = (f, h, c, p, ring_len)
        self.cls = self.plane._class_for(f, h, c, p, ring_len)
        tables, derived = _lane_tables(
            dev_plane.flow_node, dev_plane.flow_lat_steps,
            dev_plane.flow_succ, dev_plane.seg_start, dev_plane.refill_step,
            dev_plane.capacity_step, dev_plane.last_flow, self.cls.f2,
            self.cls.h2, self.cls.c2, ring_len)
        # the seven flow tables, then the derived node_off, meta and tiles
        self._tables = tuple(torch.as_tensor(a, device=self.plane.device)
                             for a in tables + derived)

    def dispatch(self, state: tuple, inject, inject_target, tvec,
                 idle: int) -> tuple:
        """Ride the shared launch with this plane's real-shaped dispatch
        (``state``: t and the seven state tensors on the fleet's device;
        injections as numpy, or device tensors meaning none).  Returns the
        real-shaped 10-tuple the serial kernel call would have produced:
        t_stop and forwards as np.int64, the state as tensors (row views
        of the launch's outputs), the flush as a finished numpy buffer."""
        assert self.cls is not None, "lane dispatched before attach_plane"
        f, h, c, _p, _ring_len = self.shape
        cls = self.cls
        if not isinstance(inject, np.ndarray):
            inject = inject_target = None     # the plane's zero injection
        tvec = np.asarray(tvec, np.int64)
        # extra target slots repeat the final boundary (never reached: the
        # lane's span ends at its own targets[-1])
        sub = _Submit(self, state, inject, inject_target,
                      _pad_vec(tvec, cls.p2, int(tvec[-1])), int(idle))
        self.plane._submit(sub)
        if sub.error is not None:
            raise sub.error
        r = sub.result
        flush = _repack_flush(r[9], cls.c2, cls.h2, c, h)
        self.dispatches += 1
        return (np.int64(r[9][4]), r[1][:f], r[2][:, :f], r[3][:h],
                r[4][:f], r[5][:f], r[6][:f], r[7][:h], np.int64(r[9][0]),
                flush)

    def metrics(self) -> Dict:
        """fleet.* scrape source (registered per engine by the device
        plane's lane hook; namespace documented in obs/metrics.py)."""
        return self.plane.metrics()


class FleetPlane:
    """The shared batching executor: shape classes, the all-live-lanes
    barrier, and the batched launches.

    Barrier contract: every live lane (begin()..end()) eventually either
    submits a dispatch or ends.  A submission parks its lane; when every
    live lane has one parked submission, the LAST parker launches the
    whole batch (grouped per shape class, one batched launch each) with
    the lock released around the device work, distributes per-lane rows,
    and wakes everyone.  A lane ending mid-wait re-checks the barrier,
    so host-heavy lanes delay launches but can never deadlock them."""

    def __init__(self, use_numpy: bool = False, device: str = "cuda"):
        from ..device import resolve_device
        self.device = resolve_device(device)
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._cv = threading.Condition(threading.Lock())
        self._live = 0
        self._pending: List[_Submit] = []
        self._launching = False
        self._classes: Dict[tuple, _ShapeClass] = {}
        self._compiled: set = set()
        self._use_numpy = bool(use_numpy)
        self._lanes_created = 0
        self.lanes_peak = 0
        self.launches = 0
        self.lane_dispatches = 0
        self.compiles = 0
        self._occupancy_sum = 0.0

    # -- lane construction -------------------------------------------------
    def lane(self, name: Optional[str] = None) -> FleetLane:
        with self._cv:
            self._lanes_created += 1
            serial = self._lanes_created
            label = name or f"lane-{serial}"
        return FleetLane(self, label, serial)

    def _class_for(self, f: int, h: int, c: int, p: int,
                   ring_len: int) -> _ShapeClass:
        c2 = _pow2(c)
        h2 = _pow2(h)
        # chain padding needs at least one guaranteed-zero flow row for
        # the padded last_flow entries (delivered_sum stays exact)
        f2 = _pow2(f + 1) if c2 > c else _pow2(f)
        p2 = _pow2(p)
        key = (f2, h2, c2, p2, ring_len)
        with self._cv:
            cls = self._classes.get(key)
            if cls is None:
                cls = self._classes[key] = _ShapeClass(f2, h2, c2, p2,
                                                       ring_len)
            return cls

    # -- barrier -----------------------------------------------------------
    def _lane_begin(self) -> None:
        with self._cv:
            self._live += 1
            self.lanes_peak = max(self.lanes_peak, self._live)

    def _lane_end(self) -> None:
        with self._cv:
            self._live -= 1
            self._maybe_launch_locked()

    def _submit(self, sub: _Submit) -> None:
        with self._cv:
            self._pending.append(sub)
            self.lane_dispatches += 1
            self._maybe_launch_locked()
            while sub.result is None and sub.error is None:
                self._cv.wait()

    def _maybe_launch_locked(self) -> None:
        """Launch when every live lane is parked (lock held on entry and
        exit; RELEASED around the device call — the batch is snapshotted
        first, so late submissions start the next generation)."""
        if self._launching or not self._pending \
                or len(self._pending) < self._live:
            return
        batch, self._pending = self._pending, []
        self._launching = True
        self._cv.release()
        try:
            self._run_batch(batch)
        finally:
            self._cv.acquire()
            self._launching = False
            self._cv.notify_all()
            # submissions that arrived during the launch may already
            # satisfy the next barrier (e.g. the last other lane ended)
            self._maybe_launch_locked()

    # -- launching ---------------------------------------------------------
    def _run_batch(self, batch: List[_Submit]) -> None:
        """One barrier generation: group per shape class, launch each
        group as one batched launch, scatter rows back (called with the
        barrier lock released).  A launch error goes to every lane of its
        group, whose runs then end with it."""
        groups: Dict[tuple, List[_Submit]] = {}
        for sub in batch:
            groups.setdefault(sub.lane.cls.key, []).append(sub)
        for key in sorted(groups):
            subs = groups[key]
            try:
                self._launch_class(self._classes[key], subs)
            except BaseException as e:  # noqa: BLE001 - scatter to lanes
                for sub in subs:
                    if sub.result is None:
                        sub.error = e

    def _tables_for(self, cls: _ShapeClass, subs: List[_Submit],
                    width: int) -> tuple:
        """The [W, ...] static tables of this batch's rows (lanes, then
        fillers) and their derived span tables."""
        from ..ops.torcells_device import BatchedSpanTables
        rows = [s.lane._tables for s in subs]
        rows += [cls.filler_tables(self.device)] * (width - len(subs))
        stacked = [torch.stack([r[i] for r in rows]) for i in range(10)]
        return stacked[:7], BatchedSpanTables(*stacked[7:])

    def _stage(self, cls: _ShapeClass, subs: List[_Submit],
               width: int) -> tuple:
        """Pad and stack the parked lanes' carried state and injections
        into [W, ...] tensors on the plane's device; rows past the lanes
        are the filler's (zero state, done_tick -1, no injection)."""
        dev = self.device
        i64 = torch.int64
        from ..ops.torcells_device import RING_TORCH_DTYPE
        f2, h2, lr = cls.f2, cls.h2, cls.ring_len
        queued = torch.zeros((width, f2), dtype=i64, device=dev)
        ring = torch.zeros((width, lr, f2), dtype=RING_TORCH_DTYPE,
                           device=dev)
        tokens = torch.zeros((width, h2), dtype=i64, device=dev)
        delivered = torch.zeros((width, f2), dtype=i64, device=dev)
        target = torch.zeros((width, f2), dtype=i64, device=dev)
        done_tick = torch.full((width, f2), -1, dtype=i64, device=dev)
        node_sent = torch.zeros((width, h2), dtype=i64, device=dev)
        inject = torch.zeros((width, f2), dtype=i64, device=dev)
        inject_target = torch.zeros((width, f2), dtype=i64, device=dev)
        t0 = np.zeros(width, dtype=np.int64)
        idle = np.zeros(width, dtype=np.int64)
        tvec = np.zeros((width, cls.p2), dtype=np.int64)
        for w, sub in enumerate(subs):
            f, h = sub.lane.shape[0], sub.lane.shape[1]
            st = sub.state
            queued[w, :f] = st[1]
            ring[w, :, :f] = st[2]
            tokens[w, :h] = st[3]
            delivered[w, :f] = st[4]
            target[w, :f] = st[5]
            done_tick[w, :f] = st[6]
            node_sent[w, :h] = st[7]
            if sub.inject is not None:
                inject[w, :f] = torch.from_numpy(sub.inject)
                inject_target[w, :f] = torch.from_numpy(sub.inject_target)
            t0[w] = int(st[0])
            idle[w] = sub.idle
            tvec[w] = sub.tvec
        return ((queued, ring, tokens, delivered, target, done_tick,
                 node_sent, inject, inject_target), t0, idle, tvec)

    def _launch_class(self, cls: _ShapeClass, subs: List[_Submit]) -> None:
        import contextlib
        width = max(cls.width, _pow2(len(subs)))
        ctx = contextlib.ExitStack()
        if self._stream is not None:
            # the lanes' state came from this thread's stream (uploads) or
            # from earlier launches (finished before they returned)
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
            ctx.enter_context(torch.cuda.device(self.device))
            ctx.enter_context(torch.cuda.stream(self._stream))
        with ctx:
            tables, span_tables = self._tables_for(cls, subs, width)
            state, t0, idle, tvec = self._stage(cls, subs, width)
            if self._use_numpy:
                from ..ops.torcells_device import (
                    torcells_step_span_batched_numpy)
                # simjit: disable=SIM302 -- the numpy twin: the batched step runs on the host, so the lanes' state comes to it first
                out = torcells_step_span_batched_numpy(
                    t0, *(a.cpu().numpy() for a in state), tvec, idle,
                    *(a.cpu().numpy() for a in tables),
                    ring_len=cls.ring_len)
                out = tuple(torch.as_tensor(np.asarray(a), device=self.device)
                            for a in out)
            else:
                from ..ops.torcells_device import (
                    torcells_step_span_flush_batched)
                out = torcells_step_span_flush_batched(
                    t0, *state, tvec, idle, *tables,
                    ring_len=cls.ring_len, tables=span_tables)
            # the one copy back: every lane's flush (t_stop and forwards
            # are in its header); waits for the launch to finish
            # simjit: disable=SIM302 -- the fleet's designed collect: a fleet launch returns with its lanes' flush, one copy back a launch
            flush = out[9].cpu().numpy()
        with self._cv:
            cls.width = width
            if (cls.key, width) not in self._compiled:
                self._compiled.add((cls.key, width))
                self.compiles += 1
            self.launches += 1
            self._occupancy_sum += len(subs) / width
        for w, sub in enumerate(subs):
            sub.result = (None, *(a[w] for a in out[1:8]), None, flush[w])

    # -- stats -------------------------------------------------------------
    def metrics(self) -> Dict:
        """The fleet.* scrape namespace (see obs/metrics.py): how many
        lanes rode the plane, how full launches ran, and how many lane
        dispatches each device launch amortized."""
        with self._cv:
            launches = self.launches
            amortized = self.lane_dispatches / launches if launches else 0.0
            occupancy = self._occupancy_sum / launches if launches else 0.0
            return {
                "fleet.lanes": self.lanes_peak,
                "fleet.lane_occupancy": round(occupancy, 4),
                "fleet.launches": launches,
                "fleet.lane_dispatches": self.lane_dispatches,
                "fleet.launches_amortized": round(amortized, 4),
                "fleet.shape_classes": len(self._classes),
                "fleet.compiles": self.compiles,
            }

    def stats(self) -> Dict:
        return self.metrics()
