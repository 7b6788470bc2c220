"""simprof: the device cost observatory (ISSUE 15 / ROADMAP item 5).

After the host-plane cuts of PRs 7-12 the flagship wall is dominated by
XLA device kernel compute — the one plane the repo observed only as a
single ``flush_sec`` blob, and the one whose scheduling decision (fused
``all_to_all`` vs lone ``ppermute`` in the mesh exchange) was made by
heuristic, not data.  This package closes both gaps with the
microbenchmark-calibration methodology of *Dissecting the Graphcore IPU
Architecture via Microbenchmarking* (arXiv 1912.03413) and the
measured-schedule framing of *FAST* (arXiv 2505.09764):

* :mod:`calibrate` — ``simprof calibrate`` microbenchmarks the actual
  backend in a bounded subprocess (per-collective launch cost across
  mesh widths, step-kernel cost vs flow count, dispatch/flush transfer
  cost) and persists a digest-stamped per-box ``COSTMODEL.json``;
* :mod:`model` — the :class:`~shadow_tpu_torch.prof.model.CostModel` the mesh
  exchange scheduler and the device plane consult at run time; a model
  whose backend fingerprint does not match this box REFUSES to load
  (loudly) and the consumers fall back to the pre-existing heuristics;
* :mod:`ledger` — the persistent perf-trend ledger
  (``BENCH_HISTORY.jsonl``): bench.py appends every flagship/sharded
  row keyed by box + git sha, and ``trace_report --trend`` renders the
  trajectory with regression flags, so the next perf regression is
  caught by the repo instead of a human rereading CHANGES.md;
* :mod:`cli` — the ``simprof`` console entry (calibrate / check / show).

Live attribution rides the existing observability plane: the device
plane publishes per-launch predicted-vs-measured histograms under
``prof.*`` and a sim-time-correlated ``device-sim`` track into the
Chrome trace; a drifting model (measured/predicted outside the band)
raises the loud ``prof.model_stale`` counter instead of silently
mis-scheduling.
"""

from __future__ import annotations

import os

COSTMODEL_BASENAME = "COSTMODEL.json"
HISTORY_BASENAME = "BENCH_HISTORY.jsonl"


def repo_root() -> str:
    """The repo checkout containing this package (where the per-box
    COSTMODEL.json and BENCH_HISTORY.jsonl live, next to bench.py) —
    the ONE definition every prof path default derives from."""
    return os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
