"""Seeded synthetic GraphML topologies.

:func:`lossy_complete_graphml` builds a complete, undirected, lossy graph
with the attribute schema of the reference's Internet topology
(``resource/topology.graphml.xml.xz``: 183 vertices, every pair adjacent,
per-vertex bandwidth and loss, per-edge latency and loss), so the tor
workloads can run at that size without the reference file.  Everything
comes from a numpy Generator seeded by ``seed``: the same arguments give a
byte-identical document.
"""

from __future__ import annotations

from typing import List

import numpy as np

_HEADER = """<graphml xmlns="http://graphml.graphdrawing.org/xmlns">
  <key id="d0" for="node" attr.name="bandwidthdown" attr.type="int"/>
  <key id="d1" for="node" attr.name="bandwidthup" attr.type="int"/>
  <key id="d2" for="node" attr.name="packetloss" attr.type="double"/>
  <key id="d3" for="node" attr.name="ip" attr.type="string"/>
  <key id="d4" for="edge" attr.name="latency" attr.type="double"/>
  <key id="d5" for="edge" attr.name="packetloss" attr.type="double"/>
  <graph edgedefault="undirected">
"""


def lossy_complete_graphml(n_vertices: int = 183, seed: int = 7) -> str:
    """A complete lossy graph on ``n_vertices`` vertices.

    * vertex bandwidth: 10-1000 MiB/s in KiB/s; vertex loss 0 on 80% of
      vertices, else up to 0.2%;
    * edge latency: 2-150 ms (0.1 ms steps); edge loss 0 on half the edges,
      else up to 0.5% — so path reliabilities are exactly 1.0 on some pairs
      and strictly between 0 and 1 on the rest.
    """
    rng = np.random.default_rng(seed)
    n = int(n_vertices)
    bw = rng.integers(10 * 1024, 1000 * 1024, size=n).tolist()
    vloss = np.where(rng.random(n) < 0.8, 0.0,
                     np.round(rng.random(n) * 0.002, 6)).tolist()
    out: List[str] = [_HEADER]
    for i in range(n):
        out.append(
            f'    <node id="v{i}"><data key="d0">{bw[i]}</data>'
            f'<data key="d1">{bw[i]}</data>'
            f'<data key="d2">{vloss[i]!r}</data>'
            f'<data key="d3">10.{i // 250}.{i % 250}.1</data></node>\n')
    iu, ju = np.triu_indices(n, k=1)
    lat = np.round(rng.uniform(2.0, 150.0, size=iu.size), 1)
    eloss = np.where(rng.random(iu.size) < 0.5, 0.0,
                     np.round(rng.random(iu.size) * 0.005, 6))
    for i, j, la, lo in zip(iu.tolist(), ju.tolist(), lat.tolist(),
                            eloss.tolist()):
        out.append(f'    <edge source="v{i}" target="v{j}">'
                   f'<data key="d4">{la!r}</data>'
                   f'<data key="d5">{lo!r}</data></edge>\n')
    out.append("  </graph>\n</graphml>\n")
    return "".join(out)

