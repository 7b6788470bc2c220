"""Deterministic circuit/flow partitioning for the mesh traffic plane.

The sharded kernel's exactness argument (see exchange.py) requires every
node's WHOLE flow segment to live on one shard: the per-tick greedy
bandwidth allocation is a cumsum within each node's segment, so splitting
a segment would change allocation order.  The unit of placement is
therefore the node segment, and the objective is to co-locate the nodes a
circuit's consecutive hops are paced by — every hop whose successor lives
on another shard costs one slot in the cross-shard exchange.

:func:`chain_partition` walks the chains (each flow has at most one
successor, so circuits are simple paths over node segments) in ascending
head order and assigns each first-seen node to the currently-filling
shard until its flow budget is reached — chain-adjacent nodes land
together, and shards stay balanced to within one node segment.  Pure
numpy + dict walking, runs once at plane build, deterministic for a given
flow table (pinned by tests/test_meshplane.py).

:func:`build_mesh_layout` turns an arbitrary segment-aligned node->shard
assignment into the padded sharded layout (the ``build_sharded_layout``
contract the single-device plane's sharding has used since PR 7: real
rows front-packed per shard, padding rows self-segmented on the shard's
last local node slot with queued pinned 0, uniform pad/h_pad across
shards).  This module is the ONE definition of that contract —
:func:`pad_state` is the only legal original->padded translation.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def chain_partition(flow_node: np.ndarray, flow_succ: np.ndarray,
                    n_shards: int) -> Tuple[np.ndarray, int]:
    """Assign nodes to shards, chains-first: walk every chain from its
    head flow (ascending), assigning each not-yet-placed node to the
    current shard until the per-shard flow budget fills.  Returns
    (shard_of_node [max_node+1], cross_edges) where cross_edges counts
    flow->successor hops whose nodes landed on different shards."""
    flow_node = np.asarray(flow_node, dtype=np.int64)
    flow_succ = np.asarray(flow_succ, dtype=np.int64)
    f = len(flow_node)
    n_nodes = int(flow_node.max()) + 1 if f else 1
    seg_size = np.bincount(flow_node, minlength=n_nodes).astype(np.int64)
    shard_of = np.full(n_nodes, -1, dtype=np.int64)
    budget = -(-f // n_shards)
    # chain heads: flows nobody forwards into
    has_pred = np.zeros(f, dtype=bool)
    valid = flow_succ >= 0
    has_pred[flow_succ[valid]] = True
    shard = 0
    fill = 0
    for head in np.flatnonzero(~has_pred).tolist():
        i = head
        while i >= 0:
            node = int(flow_node[i])
            if shard_of[node] < 0:
                size = int(seg_size[node])
                if fill and fill + size > budget and shard < n_shards - 1:
                    shard += 1
                    fill = 0
                shard_of[node] = shard
                fill += size
            i = int(flow_succ[i])
    # nodes with no flows (cannot occur for tables built from chains, but
    # keep the map total): park them on the last shard
    shard_of[shard_of < 0] = n_shards - 1
    src_shard = shard_of[flow_node[valid]]
    dst_shard = shard_of[flow_node[flow_succ[valid]]]
    cross = int(np.count_nonzero(src_shard != dst_shard))
    return shard_of, cross


def contiguous_partition(flow_node: np.ndarray,
                         n_shards: int) -> np.ndarray:
    """The pre-mesh placement rule (PR 7's partition_flows): contiguous
    node-sorted ranges balanced by flow count.  Kept as the partitioner's
    baseline/oracle — chain_partition must never do worse on cross-shard
    hops than this for the same table (tests pin it)."""
    flow_node = np.asarray(flow_node, dtype=np.int64)
    f = len(flow_node)
    n_nodes = int(flow_node.max()) + 1 if f else 1
    starts = np.flatnonzero(np.r_[True, flow_node[1:] != flow_node[:-1]])
    bounds = [0]
    for s in range(1, n_shards):
        target = round(f * s / n_shards)
        i = int(np.searchsorted(starts, target))
        b = int(starts[i]) if i < len(starts) else f
        bounds.append(max(b, bounds[-1]))
    bounds.append(f)
    shard_of = np.full(n_nodes, n_shards - 1, dtype=np.int64)
    for s in range(n_shards):
        lo, hi = bounds[s], bounds[s + 1]
        if hi > lo:
            shard_of[np.unique(flow_node[lo:hi])] = s
    return shard_of


def build_mesh_layout(flow_node, flow_lat, flow_succ, seg_start,
                      refill, capacity, n_shards: int,
                      shard_of_node: Optional[np.ndarray] = None) -> dict:
    """Pad + index-map the (node-sorted) flow tables for the sharded
    kernel, honoring an arbitrary segment-aligned node->shard assignment
    (default: :func:`chain_partition`).  Real rows occupy the front of
    each shard's slice in ascending (node, original-row) order — a node's
    segment is copied whole, so within-segment allocation order is
    untouched; padding rows are self-segmented with queued always 0, so
    they serve nothing and perturb nothing.  Returns the padded tables
    plus src/keep/inv mappings for translating state between the original
    and padded layouts, and the exchange schedule over the cross-shard
    successor edges (exchange.build_exchange)."""
    flow_node = np.asarray(flow_node, dtype=np.int64)
    flow_lat = np.asarray(flow_lat, dtype=np.int64)
    flow_succ = np.asarray(flow_succ, dtype=np.int64)
    f = len(flow_node)
    if shard_of_node is None:
        shard_of_node, _ = chain_partition(flow_node, flow_succ, n_shards)
    shard_of_node = np.asarray(shard_of_node, dtype=np.int64)
    # per-shard row lists: each shard's nodes ascending, each node's whole
    # segment in original order (the array is node-sorted, so a node's
    # rows are one contiguous slice)
    starts = np.flatnonzero(np.r_[True, flow_node[1:] != flow_node[:-1]])
    ends = np.r_[starts[1:], f]
    seg_nodes = flow_node[starts]
    rows_per_shard = [[] for _ in range(n_shards)]
    for k in range(len(starts)):
        s = int(shard_of_node[seg_nodes[k]])
        rows_per_shard[s].append((int(seg_nodes[k]),
                                  int(starts[k]), int(ends[k])))
    sizes = [sum(e - b for _n, b, e in segs) for segs in rows_per_shard]
    pad = max(sizes) if sizes and max(sizes) else 1
    fp_total = n_shards * pad
    keep = np.zeros(fp_total, dtype=bool)
    src = np.zeros(fp_total, dtype=np.int64)
    for s in range(n_shards):
        pos = s * pad
        for _node, b, e in sorted(rows_per_shard[s]):
            src[pos:pos + (e - b)] = np.arange(b, e)
            pos += e - b
        keep[s * pad:pos] = True
    inv = np.full(f, -1, dtype=np.int64)
    inv[src[keep]] = np.flatnonzero(keep)

    node_p = flow_node[src]
    lat_p = flow_lat[src]
    lat_p[~keep] = 0        # diagnostic copy only; the kernel reads arr_lat
    succ_orig = flow_succ[src]
    succ_p = np.where((succ_orig >= 0) & keep, inv[np.maximum(succ_orig, 0)],
                      -1)
    # per-shard local node renumbering + local segment starts; uniform
    # local node count across shards (padded)
    h_locals = []
    node_local = np.zeros(fp_total, dtype=np.int64)
    seg_local = np.zeros(fp_total, dtype=np.int64)
    for s in range(n_shards):
        lo, hi = s * pad, (s + 1) * pad
        k = keep[lo:hi]
        nodes = node_p[lo:hi][k]
        uniq, local_ids = np.unique(nodes, return_inverse=True)
        h_locals.append(len(uniq))
        node_local[lo:lo + len(nodes)] = local_ids
        if len(nodes):
            sstarts = np.flatnonzero(np.r_[True, nodes[1:] != nodes[:-1]])
            seg_id = np.cumsum(np.r_[0, (nodes[1:] != nodes[:-1])
                                     .astype(np.int64)])
            seg_local[lo:lo + len(nodes)] = sstarts[seg_id]
        # padding rows: own one-row segments on the last local node slot
        for j in range(lo + int(k.sum()), hi):
            seg_local[j] = j - lo
    h_pad = max(h_locals) if h_locals else 1
    refill_p = np.zeros(n_shards * h_pad, dtype=np.int64)
    capacity_p = np.zeros(n_shards * h_pad, dtype=np.int64)
    node_src = np.full(n_shards * h_pad, -1, dtype=np.int64)
    for s in range(n_shards):
        lo = s * pad
        k = keep[lo:lo + pad]
        nodes = node_p[lo:lo + pad][k]
        uniq = np.unique(nodes)
        refill_p[s * h_pad:s * h_pad + len(uniq)] = np.asarray(refill)[uniq]
        capacity_p[s * h_pad:s * h_pad + len(uniq)] = \
            np.asarray(capacity)[uniq]
        node_src[s * h_pad:s * h_pad + len(uniq)] = uniq
        # padding rows point at the shard's last local node; they never
        # serve (queued stays 0) so sharing a real bucket is harmless
        node_local[lo + int(k.sum()):lo + pad] = h_pad - 1
    # successor-space arrival latency: arr_lat[j] = lat of j's predecessor
    # (each shard reads its own slice — the kernel's ring is shard-local)
    arr_lat = np.zeros(fp_total, dtype=np.int64)
    senders = np.flatnonzero(succ_p >= 0)
    arr_lat[succ_p[senders]] = lat_p[senders]
    lay = {
        "pad": pad, "keep": keep, "src": src, "inv": inv,
        "flow_node_local": node_local, "flow_lat": lat_p,
        "succ_global": succ_p, "seg_start_local": seg_local,
        "refill": refill_p, "capacity": capacity_p, "h_pad": h_pad,
        "node_src": node_src,    # padded local-node slot -> global node
        "arr_lat": arr_lat,
        "shard_base": (np.arange(n_shards, dtype=np.int64) * pad),
        "n_shards": n_shards,
        "shard_of_node": shard_of_node,
        "shard_sizes": np.asarray(sizes, dtype=np.int64),
    }
    from .exchange import build_exchange
    lay["exchange"] = build_exchange(succ_p, pad, n_shards)
    return lay


def pad_state(layout: dict, a, fill: int = 0) -> np.ndarray:
    """Translate a per-flow array from the original layout into the padded
    sharded layout (ONE definition of the padding contract — callers must
    not hand-roll ``out[keep] = a[src[keep]]``)."""
    src, keep = layout["src"], layout["keep"]
    out = np.full(len(src), fill, dtype=np.int64)
    out[keep] = np.asarray(a)[src[keep]]
    return out
