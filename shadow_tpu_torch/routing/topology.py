"""Topology as tensors: GraphML network graph → device-resident matrices.

The reference (src/main/routing/topology.c) imports an igraph GraphML file
and answers per-packet latency/reliability queries with *lazy* one-to-all
Dijkstra plus a path cache (topology.c:1655 `_topology_computeSourcePaths`,
:1284 cache probe).  On the device the right shape is the opposite: compute the
whole attached-pair matrix **eagerly at load** (like the reference, only for
vertices that actually have hosts attached — topology.c:1681) and keep it
device-resident as

    latency_ns     int64  [A, A]   (A = attached vertices)
    reliability    float32[A, A]

so the per-round packet kernel is a pure gather.  The CPU scheduler policies
query the same numpy matrices, guaranteeing CPU/device parity.

Semantics matched to the reference (behavior, not code):
  * edge attribute ``latency`` is milliseconds; path latency = sum of edge
    latencies along the latency-shortest path (topology.c:1476-1502).
  * path reliability = (1-src vertex loss) * prod(1-edge loss) * (1-dst
    vertex loss) (topology.c:1427-1463).
  * zero-latency shortest paths are clamped to 1 ms (topology.c:1848-1852).
  * self-paths (src and dst on the same vertex) use the cheapest incident
    edge twice: latency = 2*min, reliability = r_min**2 (topology.c:1640-1650).
  * complete graphs (or ``preferdirectpaths`` + adjacent) use the direct edge
    instead of Dijkstra (topology.c:1877-1928, :2019).
  * packet delay in sim-time = ceil(latency_ms -> ns) (worker.c:276).
  * host attachment picks a vertex by ip/city/country/geocode/type hints with
    longest-IP-prefix tiebreak (topology.c:2094-2371).
"""

from __future__ import annotations

import math
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core import stime
from ..core.logger import get_logger
from .address import ip_to_int


class GraphVertex:
    __slots__ = ("index", "gid", "attrs")

    def __init__(self, index: int, gid: str, attrs: Dict[str, str]):
        self.index = index
        self.gid = gid
        self.attrs = attrs

    def get_float(self, name: str) -> Optional[float]:
        v = self.attrs.get(name)
        return float(v) if v not in (None, "") else None

    def get_int(self, name: str) -> Optional[int]:
        v = self.get_float(name)
        return int(v) if v is not None else None


class GraphEdge:
    __slots__ = ("src", "dst", "latency_ms", "jitter_ms", "packetloss")

    def __init__(self, src: int, dst: int, latency_ms: float, jitter_ms: float,
                 packetloss: float):
        self.src = src
        self.dst = dst
        self.latency_ms = latency_ms
        self.jitter_ms = jitter_ms
        self.packetloss = packetloss


def parse_graphml(text: str) -> Tuple[List[GraphVertex], List[GraphEdge], bool, Dict[str, str]]:
    """Minimal GraphML reader covering the reference's schema: typed <key>
    declarations, <node>/<edge> with <data> children, directedness."""
    ns = {"g": "http://graphml.graphdrawing.org/xmlns"}
    root = ET.fromstring(text)

    def findall(el, tag):
        out = el.findall(f"g:{tag}", ns)
        return out if out else el.findall(tag)

    keys = {}  # key id -> attr name
    for k in findall(root, "key"):
        keys[k.get("id")] = k.get("attr.name", k.get("id"))

    graphs = findall(root, "graph")
    if not graphs:
        raise ValueError("GraphML contains no <graph>")
    graph = graphs[0]
    directed = graph.get("edgedefault", "undirected") == "directed"

    def data_of(el) -> Dict[str, str]:
        d = {}
        for c in findall(el, "data"):
            name = keys.get(c.get("key"), c.get("key"))
            d[name] = (c.text or "").strip()
        return d

    graph_attrs = data_of(graph)
    vertices: List[GraphVertex] = []
    vid_to_index: Dict[str, int] = {}
    for n in findall(graph, "node"):
        gid = n.get("id")
        attrs = data_of(n)
        attrs.setdefault("id", gid)
        v = GraphVertex(len(vertices), gid, attrs)
        vid_to_index[gid] = v.index
        vertices.append(v)

    edges: List[GraphEdge] = []
    for e in findall(graph, "edge"):
        d = data_of(e)
        edges.append(GraphEdge(
            vid_to_index[e.get("source")], vid_to_index[e.get("target")],
            latency_ms=float(d.get("latency", 0.0) or 0.0),
            jitter_ms=float(d.get("jitter", 0.0) or 0.0),
            packetloss=float(d.get("packetloss", 0.0) or 0.0)))
    return vertices, edges, directed, graph_attrs


class Topology:
    """The network graph with eagerly computed attached-pair path tensors."""

    def __init__(self, vertices: List[GraphVertex], edges: List[GraphEdge],
                 directed: bool, graph_attrs: Dict[str, str]):
        self.vertices = vertices
        self.edges = edges
        self.directed = directed
        self.graph_attrs = graph_attrs
        self.prefer_direct_paths = graph_attrs.get(
            "preferdirectpaths", "").lower() in ("1", "true", "yes")

        n = len(vertices)
        # Dense would explode for big sparse graphs; keep edges in CSR.
        import scipy.sparse as sp
        rows, cols, lat, rel = [], [], [], []
        for e in edges:
            rows.append(e.src); cols.append(e.dst)
            lat.append(max(e.latency_ms, 0.0)); rel.append(1.0 - e.packetloss)
            if not directed and e.src != e.dst:
                rows.append(e.dst); cols.append(e.src)
                lat.append(max(e.latency_ms, 0.0)); rel.append(1.0 - e.packetloss)
        # Parallel edges: keep the minimum-latency one (deterministic;
        # matches the reference's single igraph_get_eid edge resolution).
        best: Dict[Tuple[int, int], Tuple[float, float]] = {}
        for r, c, l, rr in zip(rows, cols, lat, rel):
            k = (r, c)
            if k not in best or l < best[k][0]:
                best[k] = (l, rr)
        self._edge_lat: Dict[Tuple[int, int], float] = {k: v[0] for k, v in best.items()}
        self._edge_rel: Dict[Tuple[int, int], float] = {k: v[1] for k, v in best.items()}
        # Integer-ns edge weights (ceil per edge, like the reference's final
        # ms->ns ceil) keep all path sums exact: ns values < 2**53 are exact
        # in the float64 scipy works in.  +1 per edge keeps zero-latency
        # edges visible to CSR (scipy drops explicit zeros); the +hop_count
        # bias is subtracted exactly in finalize()'s integer DP.
        self._edge_ns: Dict[Tuple[int, int], int] = {
            k: int(math.ceil(v[0] * stime.SIM_TIME_MS)) for k, v in best.items()}
        if best:
            keys = list(best)       # the dict itself: insertion-ordered
            rr = [k[0] for k in keys]
            cc = [k[1] for k in keys]
            ww = [self._edge_ns[k] + 1 for k in keys]
            self._csr = sp.csr_matrix((np.array(ww, dtype=np.float64), (rr, cc)),
                                      shape=(n, n))
        else:
            self._csr = sp.csr_matrix((n, n))

        self.is_complete = self._check_complete()
        self._vloss = np.array([v.get_float("packetloss") or 0.0 for v in vertices],
                               dtype=np.float64)

        # Attachment state
        self.attached_index: Dict[int, int] = {}   # vertex index -> row in matrices
        self.attached_vertices: List[int] = []     # row -> vertex index
        self._ip_to_row: Dict[int, int] = {}       # host IP -> matrix row
        self.latency_ns: Optional[np.ndarray] = None
        self.reliability: Optional[np.ndarray] = None
        self.min_latency_ns: int = stime.SIM_TIME_MAX
        self.path_packet_counts: Optional[np.ndarray] = None
        self._finalized = False
        self._device_cache = None
        self._attach_cands_cache: Dict[tuple, list] = {}

    # -- construction ------------------------------------------------------
    @classmethod
    def from_graphml(cls, text: str) -> "Topology":
        return cls(*parse_graphml(text))

    @classmethod
    def from_file(cls, path: str) -> "Topology":
        if path.endswith(".xz"):
            import lzma
            with lzma.open(path, "rt") as f:
                return cls.from_graphml(f.read())
        with open(path, "r") as f:
            return cls.from_graphml(f.read())

    def _check_complete(self) -> bool:
        """Complete = every ordered vertex pair (incl. self loops on multi-
        vertex graphs? reference checks all pairs have an edge) is adjacent.
        Single-vertex graphs with a self-loop count as complete."""
        n = len(self.vertices)
        if n == 0:
            return False
        if n == 1:
            return (0, 0) in self._edge_lat
        # _edge_lat is deduplicated and holds both directions for undirected
        # graphs, so completeness is a simple count check.
        non_self = sum(1 for (i, j) in self._edge_lat if i != j)
        return non_self == n * (n - 1)

    # -- host attachment ---------------------------------------------------
    def attach_host(self, ip: int, ip_hint: Optional[str] = None,
                    city_hint: Optional[str] = None, country_hint: Optional[str] = None,
                    geocode_hint: Optional[str] = None, type_hint: Optional[str] = None,
                    choice_rand: Optional[int] = None) -> int:
        """Pick an attachment vertex for a host (reference topology_attach
        :2371 / _topology_findAttachmentVertex :2248).  Returns vertex index.

        Filtering: exact-IP match wins outright; otherwise candidates are
        filtered by each provided hint in turn (ignoring hints that would
        empty the set); the longest-common-IP-prefix with ip_hint breaks
        ties; any remainder is broken deterministically with ``choice_rand``.
        """
        if self._finalized:
            raise RuntimeError("cannot attach hosts after finalize()")

        if ip_hint:
            exact = [v for v in self.vertices if v.attrs.get("ip") == ip_hint]
            if exact:
                return self._record_attachment(exact[0].index, ip)

        # hint filtering is identical for every host with the same hints
        # (the common case: none) — memoize the candidate list so 10k-host
        # boots don't rescan the vertex set per host
        hint_key = (type_hint, city_hint, country_hint, geocode_hint)
        cached = self._attach_cands_cache.get(hint_key)
        if cached is None:
            cands = list(self.vertices)

            def filt(key: str, want: Optional[str]):
                nonlocal cands
                if not want:
                    return
                kept = [v for v in cands
                        if v.attrs.get(key, "").lower() == want.lower()]
                if kept:
                    cands = kept

            filt("type", type_hint)
            filt("citycode", city_hint)
            filt("countrycode", country_hint)
            filt("geocode", geocode_hint)
            self._attach_cands_cache[hint_key] = cands
        else:
            cands = cached

        if ip_hint and len(cands) > 1:
            want = ip_to_int(ip_hint)
            def prefix_len(v: GraphVertex) -> int:
                vip = v.attrs.get("ip")
                if not vip:
                    return -1
                try:
                    x = ip_to_int(vip) ^ want
                except Exception:
                    return -1
                return 32 if x == 0 else 32 - x.bit_length()
            best_len = max(prefix_len(v) for v in cands)
            cands = [v for v in cands if prefix_len(v) == best_len]

        idx = cands[(choice_rand or 0) % len(cands)].index
        return self._record_attachment(idx, ip)

    def _record_attachment(self, vertex_index: int, ip: int) -> int:
        if vertex_index not in self.attached_index:
            self.attached_index[vertex_index] = len(self.attached_vertices)
            self.attached_vertices.append(vertex_index)
        self._ip_to_row[ip] = self.attached_index[vertex_index]
        return vertex_index

    def vertex_bandwidth_kibps(self, vertex_index: int) -> Tuple[int, int]:
        """(down, up) KiB/s defaults for hosts attached here."""
        v = self.vertices[vertex_index]
        down = v.get_int("bandwidthdown") or 0
        up = v.get_int("bandwidthup") or 0
        return down, up

    # -- path matrix computation ------------------------------------------
    def finalize(self) -> None:
        """Compute the [A, A] latency/reliability matrices for all attached
        vertex pairs.  Eager equivalent of the reference's lazy per-source
        Dijkstra + cache."""
        if self._finalized:
            return
        A = len(self.attached_vertices)
        n = len(self.vertices)
        lat_ns = np.zeros((A, A), dtype=np.int64)
        rel = np.ones((A, A), dtype=np.float64)

        if A > 0 and self.is_complete:
            for i, si in enumerate(self.attached_vertices):
                for j, dj in enumerate(self.attached_vertices):
                    if si == dj:
                        l, r = self._self_path(si)
                    else:
                        l = self._edge_ns[(si, dj)]
                        r = (self._edge_rel[(si, dj)]
                             * (1.0 - self._vloss[si]) * (1.0 - self._vloss[dj]))
                    lat_ns[i, j] = l
                    rel[i, j] = r
        elif A > 0:
            from scipy.sparse.csgraph import dijkstra
            srcs = np.array(self.attached_vertices, dtype=np.int64)
            # _csr already contains both arc directions for undirected
            # graphs, so always treat it as directed here.  Weights are
            # integer ns + 1 per edge (see __init__); ns-scale values are
            # exact in float64 and the hop bias is removed exactly below.
            dist, pred = dijkstra(self._csr, directed=True,
                                  indices=srcs, return_predecessors=True)
            for i, si in enumerate(self.attached_vertices):
                order = np.argsort(dist[i], kind="stable")
                # DP along each predecessor chain in distance order:
                # reliability product and exact hop count.
                relpath = np.full(n, np.nan)
                hops = np.zeros(n, dtype=np.int64)
                relpath[si] = 1.0
                for v in order:
                    if not np.isfinite(dist[i][v]) or v == si:
                        continue
                    p = pred[i][v]
                    if p < 0 or np.isnan(relpath[p]):
                        continue
                    relpath[v] = relpath[p] * self._edge_rel.get((p, v),
                                    self._edge_rel.get((v, p), 1.0))
                    hops[v] = hops[p] + 1
                for j, dj in enumerate(self.attached_vertices):
                    if si == dj:
                        l, r = self._self_path(si)
                        lat_ns[i, j] = l
                        rel[i, j] = r
                        continue
                    if self.prefer_direct_paths and (si, dj) in self._edge_ns:
                        # preferdirectpaths graphs use the direct edge for
                        # adjacent pairs even when a multi-hop path is
                        # shorter (reference topology.c:2019, :1877-1928).
                        lat_ns[i, j] = self._edge_ns[(si, dj)]
                        rel[i, j] = (self._edge_rel[(si, dj)]
                                     * (1.0 - self._vloss[si]) * (1.0 - self._vloss[dj]))
                        continue
                    d = dist[i][dj]
                    if not np.isfinite(d):
                        raise ValueError(
                            f"no path between attached vertices "
                            f"{self.vertices[si].gid} and {self.vertices[dj].gid}")
                    lat_ns[i, j] = int(d) - int(hops[dj])  # exact integer ns
                    rel[i, j] = (relpath[dj] * (1.0 - self._vloss[si])
                                 * (1.0 - self._vloss[dj]))

        # 0 -> 1ms clamp (reference topology.c:1848-1852 clamps zero-latency
        # shortest paths to 1 ms).
        self.latency_ns = np.where(lat_ns <= 0, stime.SIM_TIME_MS, lat_ns).astype(np.int64)
        self.reliability = np.clip(rel, 0.0, 1.0).astype(np.float32)
        self.path_packet_counts = np.zeros((A, A), dtype=np.int64)
        if A > 0:
            self.min_latency_ns = int(self.latency_ns.min())
        self._finalized = True
        get_logger().message(
            "topology",
            f"finalized path matrices: {A} attached vertices of {n}, "
            f"min latency {self.min_latency_ns / 1e6:.3f} ms, "
            f"{'complete' if self.is_complete else 'sparse'} graph")

    def _self_path(self, vertex_index: int) -> Tuple[int, float]:
        """Cheapest incident edge used twice (topology.c:1545-1653).
        Returns (latency_ns, reliability)."""
        best_lat, best_rel = None, 1.0
        for (u, w), l in self._edge_ns.items():
            if u == vertex_index or w == vertex_index:
                if best_lat is None or l < best_lat:
                    best_lat = l
                    best_rel = self._edge_rel[(u, w)]
        if best_lat is None:
            return stime.SIM_TIME_MS, 1.0  # isolated vertex: 1ms self path
        return 2 * best_lat, best_rel * best_rel

    # -- queries (CPU side) ------------------------------------------------
    def row_for_ip(self, ip: int) -> Optional[int]:
        return self._ip_to_row.get(ip)

    def latency_ns_ip(self, src_ip: int, dst_ip: int) -> int:
        i = self._ip_to_row[src_ip]
        j = self._ip_to_row[dst_ip]
        self.path_packet_counts[i, j] += 1
        return int(self.latency_ns[i, j])

    def reliability_ip(self, src_ip: int, dst_ip: int) -> float:
        return float(self.reliability[self._ip_to_row[src_ip], self._ip_to_row[dst_ip]])

    # -- device view -------------------------------------------------------
    def device_tensors(self, device):
        """(latency_ns int64[A,A], reliability f32[A,A]) as torch tensors on
        ``device``, uploaded once per device and cached."""
        import torch
        device = torch.device(device)
        if self._device_cache is None:
            self._device_cache = {}
        cached = self._device_cache.get(device)
        if cached is None:
            lat = torch.as_tensor(self.latency_ns, dtype=torch.int64,
                                  device=device)
            rel = torch.as_tensor(self.reliability, dtype=torch.float32,
                                  device=device)
            assert lat.dtype == torch.int64, "device latency must be int64 ns"
            assert rel.dtype == torch.float32, "device reliability must be f32"
            cached = self._device_cache[device] = (lat, rel)
        return cached

    def ip_row_array(self, ips: List[int]) -> np.ndarray:
        """Map a list of host IPs to matrix rows (for building the host →
        attached-vertex index used by the device kernel)."""
        return np.array([self._ip_to_row[ip] for ip in ips], dtype=np.int32)


def single_vertex_topology(bandwidth_down_kibps: int = 102400,
                           bandwidth_up_kibps: int = 102400,
                           latency_ms: float = 10.0,
                           packetloss: float = 0.0) -> Topology:
    """The built-in one-vertex + self-loop graph used by ``--test`` (reference
    core/support/examples.c)."""
    v = GraphVertex(0, "poi-1", {
        "id": "poi-1", "ip": "0.0.0.0", "citycode": "0", "countrycode": "US",
        "asn": "0", "type": "net",
        "bandwidthdown": str(bandwidth_down_kibps),
        "bandwidthup": str(bandwidth_up_kibps), "packetloss": str(packetloss)})
    e = GraphEdge(0, 0, latency_ms=latency_ms, jitter_ms=0.0, packetloss=packetloss)
    return Topology([v], [e], directed=False, graph_attrs={})
