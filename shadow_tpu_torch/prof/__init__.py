"""simprof: the device cost observatory of the port.

The port's copy of the JAX package's ``prof`` package, measuring the
port's own hand-written CUDA kernels on the card (or their plain versions
on the CPU) instead of XLA programs:

* :mod:`calibrate` — ``python -m shadow_tpu_torch.prof calibrate`` times
  the span + pack step the device plane dispatches against the flow count,
  ``mesh_span`` per exchange mode at D in {2, 3, 4, 8}, and the plane's
  inject upload and flush read-back, in one bounded child process, and
  persists a digest-stamped per-box model;
* :mod:`model` — the :class:`~shadow_tpu_torch.prof.model.CostModel` the
  mesh exchange scheduler, the dispatch tuner (:mod:`autotune`) and the
  device plane's launch attribution consult at run time; a model whose
  fingerprint (platform, GPU, torch and CUDA versions, host) does not match
  the run REFUSES to load, and the consumers keep their pre-model rules;
* :mod:`ledger` — the perf-trend ledger, read by
  ``tools/trace_report.py --trend``;
* :mod:`cli` — the ``simprof`` entry (calibrate / check / show).

The port keeps files of its own names: the JAX package's ``COSTMODEL.json``
and ``BENCH_HISTORY.jsonl`` beside it are that package's checked-in
records, which the port must never overwrite (and whose model, calibrated
for XLA, refuses to load here).  The port checks in no model: the
fingerprint names the host, so a model loads only where it was made.
"""

from __future__ import annotations

import os

COSTMODEL_BASENAME = "COSTMODEL_TORCH.json"
HISTORY_BASENAME = "BENCH_HISTORY_TORCH.jsonl"


def repo_root() -> str:
    """The repo checkout containing this package (where the per-box
    COSTMODEL_TORCH.json and BENCH_HISTORY_TORCH.jsonl live) — the ONE
    definition every prof path default derives from."""
    return os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
