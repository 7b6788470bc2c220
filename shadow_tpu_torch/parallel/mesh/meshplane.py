"""meshplane: attach the mesh layout to a DeviceTrafficPlane.

The port's copy of the JAX package's ``parallel/mesh/meshplane.py``: the
same partition, schedule, exchange decision, leg bits and ``mesh.*``
metrics; the mesh is D shards on the plane's one device
(:func:`device_mesh`), and the installed step runs the plain mesh version
on the CPU and the mesh kernels on the card (exchange.make_mesh_span_flush).

``attach_mesh`` is the traffic plane's ONE sharding entry point
(DeviceTrafficPlane._setup_sharding delegates here for --tpu-devices N):
it builds the device mesh, runs the chain partitioner, precomputes the
BvN exchange schedule, installs the sharded superwindow kernel, and
registers the ``mesh.*`` metrics source.  Everything engine-facing
(advance/consume/warmup, pipelined dispatch, superwindows, checkpoints,
the dispatch guard's numpy-twin demotion) is untouched — the mesh kernel
keeps the exact argument/return contract of the single-device path, so
the plane composes with all of it by construction and digest parity
sharded-vs-single-device-vs-serial is pinned by tests/test_meshplane.py.

Metrics (scraped into the same registry the bench reads):

* ``mesh.host_bounces``   — cross-shard forwards that transited the host.
  The exchange is entirely device-side, so this stays 0 on the
  steady-state path; the counter exists so the contract is ASSERTED, not
  assumed (the acceptance gate reads it).
* ``mesh.cross_shard_cells`` — cells exchanged over the permutation legs
  (accumulated from the flush buffer's trailing slot, zero extra reads).
* ``mesh.exchange_legs`` / ``mesh.cross_edges`` — schedule shape: BvN
  rotation legs in the static schedule and the flow->successor edges that
  cross shards.
* ``mesh.occupancy_min`` / ``mesh.occupancy_mean`` — per-device real-flow
  fraction of the padded slice (partition balance).
"""

from __future__ import annotations

import numpy as np

from ...core.logger import get_logger
from . import device_mesh
from .exchange import (choose_exchange_mode, leg_of_edges,
                       make_mesh_span_flush, resolve_mode)
from .partition import build_mesh_layout, chain_partition


class MeshPlaneInfo:
    """Per-run mesh introspection: schedule shape + runtime counters."""

    __slots__ = ("n_devices", "legs", "cross_edges", "cut_fraction",
                 "occupancy", "cross_shard_cells", "host_bounces",
                 "flush_base", "exchange_mode", "predicted_us",
                 "exchange_source", "model_status", "legs_active")

    def __init__(self, n_devices: int, legs: int, cross_edges: int,
                 cut_fraction: float, occupancy: np.ndarray,
                 flush_base: int, exchange_mode: str = "none",
                 predicted_us: float = 0.0,
                 exchange_source: str = "heuristic",
                 model_status: str = "absent"):
        self.n_devices = n_devices
        self.legs = legs
        self.cross_edges = cross_edges
        self.cut_fraction = cut_fraction
        self.occupancy = occupancy
        self.flush_base = flush_base
        # the exchange scheduling decision and its audit trail:
        # which identical-result kernel runs, its model-predicted per-tick
        # collective cost, and WHAT decided (model/heuristic/forced)
        self.exchange_mode = exchange_mode
        self.predicted_us = predicted_us
        self.exchange_source = exchange_source
        self.model_status = model_status
        self.cross_shard_cells = 0
        # exchange legs the CURRENT kernel variant actually issues
        # (quiet-tick fusion): starts at the full static
        # schedule, drops to the active-chain superset once the plane
        # picks a masked variant
        self.legs_active = legs
        # dispatch windows whose cross-shard forwards were delivered
        # HOST-side.  No steady-state path does — the acceptance gate
        # asserts it stays 0 — and the counter is falsifiable: after a
        # dispatch failure demotes a sharded plane to the numpy twin,
        # every busy window's cross forwards run on the host and count
        # here (device_plane.consume; the fault drill pins it nonzero)
        self.host_bounces = 0

    def metrics(self, plane) -> dict:
        return {
            "mesh.devices": self.n_devices,
            "mesh.exchange_legs": self.legs,
            "mesh.cross_edges": self.cross_edges,
            "mesh.cut_fraction": round(self.cut_fraction, 4),
            "mesh.cross_shard_cells": self.cross_shard_cells,
            "mesh.host_bounces": self.host_bounces,
            "mesh.occupancy_min": round(float(self.occupancy.min()), 4),
            "mesh.occupancy_mean": round(float(self.occupancy.mean()), 4),
            "mesh.demoted": int(plane.demoted),
            # the exchange decision: chosen kernel, the cost
            # model's predicted per-tick collective cost (0.0 when no
            # calibration loaded), and the decision source — so every
            # scrape says WHICH kernel ran and WHY
            "mesh.exchange_mode": self.exchange_mode,
            "mesh.predicted_us": self.predicted_us,
            "mesh.exchange_source": self.exchange_source,
            "mesh.cost_model": self.model_status,
            "mesh.legs_active": self.legs_active,
        }


def attach_mesh(plane, n_dev: int) -> None:
    """Shard ``plane``'s flow table over an ``n_dev``-device mesh: chain
    partition -> padded layout -> BvN exchange schedule -> sharded
    superwindow kernel, installed under the plane's standard sharded-step
    contract."""
    from ...ops.torcells_device import flush_len

    mesh = device_mesh(n_dev, axis_names=("flows",), device=plane.device)
    shard_of_node, cross_hops = chain_partition(
        plane.flow_node, plane.flow_succ, n_dev)
    lay = build_mesh_layout(
        plane.flow_node, plane.flow_lat_steps, plane.flow_succ,
        plane.seg_start, plane.refill_step, plane.capacity_step, n_dev,
        shard_of_node)
    sched = lay["exchange"]
    plane._mesh = mesh
    plane._shard = lay
    # the exchange scheduling decision: the measured per-box
    # cost model picks fused-all_to_all vs (multi-leg) ppermute from
    # data; --exchange-mode forces it; an uncalibrated box falls back to
    # the heuristic.  Identical-result kernels, so digest parity
    # across choices is by construction (pinned by tests/test_simprof.py)
    override = getattr(plane.engine.options, "exchange_mode", "auto")
    ex_mode, predicted_us, source = choose_exchange_mode(
        sched, plane._costmodel, override)
    # quiet-tick fusion support: per-chain exchange-leg
    # bitmask, so a span whose ACTIVE chains touch only a subset of the
    # legs can run a variant kernel with the quiet legs compiled out.
    # Safe because an un-injected chain's rows forward zero cells — any
    # SUPERSET of the active chains' legs is bit-identical (see
    # make_mesh_span_raw).  >63 legs cannot happen (legs <= D-1 and the
    # mesh caps out far below), but guard with the always-full sentinel.
    leg_of = leg_of_edges(lay["succ_global"], lay["pad"], sched)
    chain_bits = np.zeros(plane.n_chains, dtype=np.int64)
    if sched.legs > 63:
        chain_bits[:] = -1
    else:
        rows = np.flatnonzero((leg_of >= 0) & (lay["src"] >= 0))
        if len(rows):
            np.bitwise_or.at(
                chain_bits, plane.flow_circ[lay["src"][rows]],
                np.int64(1) << leg_of[rows])
    plane._chain_leg_bits = chain_bits
    plane._full_leg_bits = -1 if sched.legs > 63 \
        else (1 << sched.legs) - 1
    # no flush caps on the mesh (the plane turns them off before it
    # shards): the mesh flush is always full-length plus its trailing slot

    # one step per exchange the masks resolve to: fused mode exchanges
    # every leg whatever the mask, so its masked variants are the full
    # step, with its tables built once
    steps = {}

    def make_step(leg_mask=None):
        mode, active = resolve_mode(sched, ex_mode, leg_mask)
        key = (mode, tuple(active))
        if key not in steps:
            steps[key] = make_mesh_span_flush(
                mesh, "flows", plane.ring_len, lay,
                lay["inv"][plane.last_flow], lay["node_src"], plane.n_nodes,
                mode=ex_mode, leg_mask=leg_mask)
        return steps[key]

    plane._mesh_make_step = make_step
    plane._sharded_step = make_step()
    edges_total = max(int(np.count_nonzero(plane.flow_succ >= 0)), 1)
    occupancy = lay["shard_sizes"].astype(np.float64) / max(lay["pad"], 1)
    plane._meshinfo = MeshPlaneInfo(
        n_dev, sched.legs, sched.cross_edges,
        cross_hops / edges_total, occupancy,
        flush_len(plane.n_chains, plane.n_nodes),
        exchange_mode=ex_mode, predicted_us=predicted_us,
        exchange_source=source, model_status=plane._costmodel_status)
    plane.engine.metrics.source(
        "mesh", lambda: plane._meshinfo.metrics(plane))
    get_logger().message(
        "device-plane",
        f"mesh plane: flow table sharded over {n_dev} devices "
        f"(pad {lay['pad']} flows/shard, {lay['h_pad']} nodes/shard, "
        f"{sched.cross_edges}/{edges_total} cross-shard hops over "
        f"{sched.legs} exchange legs; exchange={ex_mode} "
        f"[{source}], predicted {predicted_us} us/tick)")
