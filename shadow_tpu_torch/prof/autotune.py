"""COSTMODEL-driven dispatch auto-tuner (ISSUE 16 / ROADMAP item 2).

PR 14 taught the mesh layer to pick its exchange kernel from measured
per-box costs (``choose_exchange_mode``); this module generalizes that
pattern to the WHOLE dispatch loop.  Given the calibrated
:class:`~shadow_tpu_torch.prof.model.CostModel`, :func:`plan_dispatch` picks:

* **effective superwindow depth K** — how many consecutive quiet rounds
  one kernel launch may merge.  Per-launch cost has a FIXED half (the
  dispatch upload + flush readback ``transfer_us``, plus the collective
  launch floor) that a deeper K amortizes; the tuner deepens K until
  that fixed half is a small fraction of the window's per-step compute,
  instead of trusting the hand default of 8 on every box;
* **delta-compacted flush** — whether the packed flush buffer should be
  capped to the few lanes a window actually touches (overflow falls
  back to the full buffer, ops/torcells_device.py).  ON only when the
  measured flush size slope (``flush_us_per_mb``) says the readback
  bytes saved beat the compaction's extra kernel cost — on a box where
  launches, not bytes, dominate the transfer, compaction is pure
  overhead and stays off.

What the tuner deliberately does NOT touch: **dispatch cadence**
(``--device-plane-batch-steps``) and **granule size**
(``--device-plane-granule-ms``).  Both are digest-BEARING — wake times
clamp to the consuming barrier and per-hop latency rounds up to the
granule, so changing either changes simulation RESULTS, not just wall
time.  The tuner's contract is the same as ``choose_exchange_mode``'s:
it may only ever choose between bit-identical executions (digest parity
tuned-vs-hand-defaults is by construction and pinned by
tests/test_autotune.py).  Cadence and granule are therefore reported at
their contract values with source ``contract``, and the launch
amortization they could have bought is converted into the
digest-NEUTRAL K instead.

Engagement rules (:func:`plan_dispatch` returns a :class:`TunePlan`
whose ``source`` records what decided):

* ``off``      — ``--device-autotune off``: the hand/CLI defaults run
  untouched (the escape hatch, and the parity oracle's other side);
* ``defaults`` — no calibration on this box, the model was refused, or
  the flow table sits outside the calibrated range (the
  no-extrapolation guard, ``CostModel.covers``): hand defaults, exactly
  the pre-16 behavior;
* ``model``    — the measured model shaped the plan; the predicted
  per-launch cost is recorded so obs/profiler.py's
  predicted-vs-measured band audits the decision live
  (``prof.model_stale`` fires when the tuned prediction misses).

A knob the user explicitly set (e.g. ``--superwindow-rounds 1`` in a
parity test) is ALWAYS honored — the tuner only moves knobs still at
their hand defaults.
"""

from __future__ import annotations

from typing import Optional

# hand defaults the tuner may move (must mirror core/options.py)
DEFAULT_K = 8
DEFAULT_CADENCE = 8

# ceiling on the tuned superwindow depth: the targets vector is padded
# to K (static kernel shape), and the negotiation loop is O(K) per
# round — past this the launch amortization has long flattened out
MAX_K = 64

# the fixed per-launch cost should be at most this fraction of the
# launch's per-step compute before deepening K stops paying
AMORTIZE_FRACTION = 8

# the compaction's extra kernel cost per launch (the capped pack is a
# couple of extra masked scatters): compaction must save at least this
# much predicted readback time to turn on
COMPACT_MIN_SAVINGS_US = 25.0


class TunePlan:
    """One box's tuned dispatch plan (immutable after plan_dispatch)."""

    __slots__ = ("source", "superwindow_rounds", "min_dispatch_steps",
                 "granule_source", "flush_compact", "flush_cap_chains",
                 "flush_cap_nodes", "predicted_step_us",
                 "predicted_fixed_us", "flush_bytes_cap_saved", "k_would")

    def __init__(self, source: str, superwindow_rounds: int,
                 min_dispatch_steps: int, flush_compact: bool = False,
                 flush_cap_chains: int = 0, flush_cap_nodes: int = 0,
                 predicted_step_us: float = 0.0,
                 predicted_fixed_us: float = 0.0,
                 flush_bytes_cap_saved: int = 0,
                 k_would: Optional[int] = None):
        self.source = source
        self.superwindow_rounds = superwindow_rounds
        self.min_dispatch_steps = min_dispatch_steps
        # what the model WOULD have chosen for K had nothing pinned it —
        # equals superwindow_rounds when the tuner actually decided (or
        # had no model to decide with); diverges when a user-set K or
        # ``--device-autotune off`` overrode a live model's preference
        self.k_would = superwindow_rounds if k_would is None else k_would
        # cadence + granule are digest-bearing: always contract values
        self.granule_source = "contract"
        self.flush_compact = flush_compact
        self.flush_cap_chains = flush_cap_chains
        self.flush_cap_nodes = flush_cap_nodes
        self.predicted_step_us = predicted_step_us
        self.predicted_fixed_us = predicted_fixed_us
        self.flush_bytes_cap_saved = flush_bytes_cap_saved

    def metrics(self) -> dict:
        """The decision's audit trail, published under ``prof.*`` (the
        same registry namespace launch attribution uses, so bench rows
        pick these up through the existing prefix copy)."""
        return {
            "prof.autotune_source": self.source,
            "prof.autotune_k": self.superwindow_rounds,
            "prof.autotune_k_would": self.k_would,
            "prof.autotune_cadence": self.min_dispatch_steps,
            "prof.autotune_granule": self.granule_source,
            "prof.autotune_flush_compact": int(self.flush_compact),
            "prof.autotune_predicted_us": round(
                self.predicted_step_us * self.min_dispatch_steps
                + self.predicted_fixed_us, 1),
        }


def _tuned_k(model, per_step_us: float, cadence: int) -> int:
    """Deepen K until the fixed per-launch transfer is <=
    1/AMORTIZE_FRACTION of the launch's per-step compute.  Never
    shallower than the hand default — a box where the fixed cost is
    already negligible keeps today's behavior bit for bit."""
    fixed = model.transfer_us()
    if per_step_us <= 0:
        return DEFAULT_K
    k = -(-(AMORTIZE_FRACTION * fixed) // (per_step_us * max(cadence, 1)))
    return max(DEFAULT_K, min(MAX_K, int(k)))


def flush_caps(n_chains: int, n_nodes: int) -> tuple:
    """The capped flush sections: generous enough that a typical window
    (a handful of completions, the active lanes' node deltas) fits, and
    an overflowing one is detected from the header's TRUE counts and
    re-read full-length (ops/torcells_device.parse_flush)."""
    cap_c = max(16, min(n_chains, -(-n_chains // 8)))
    cap_h = max(64, min(n_nodes, -(-n_nodes // 4)))
    return int(cap_c), int(cap_h)


def plan_dispatch(model, model_status: str, options,
                  n_flows: int, n_chains: int, n_nodes: int,
                  exchange_tick_us: float = 0.0) -> TunePlan:
    """Build the dispatch plan for one plane.

    ``model`` may be None (uncalibrated/refused box); ``n_flows`` is the
    kernel's flow-row count (the step-cost key), ``n_chains``/``n_nodes``
    size the flush buffer the compaction decision prices."""
    k_opt = max(1, int(getattr(options, "superwindow_rounds", DEFAULT_K)))
    cadence = max(1, int(getattr(options, "device_plane_batch_steps",
                                 DEFAULT_CADENCE)))
    autotune = str(getattr(options, "device_autotune", "on") or "on")
    usable = (model is not None and model_status == "loaded"
              and model.covers(n_flows))
    if autotune == "off":
        # still RECORD what the model would have chosen (ISSUE 18): a
        # pinned run's metrics carry the counterfactual K, so perf
        # triage can see how far the hand value sits from the tuned one
        k_would = None
        if usable:
            per_step = model.step_us(n_flows) + max(exchange_tick_us, 0.0)
            k_would = _tuned_k(model, per_step, cadence)
        return TunePlan("off", k_opt, cadence, k_would=k_would)
    if not usable:
        # no measured basis on this box (or the table is outside the
        # calibrated range): hand defaults, exactly the pre-16 loop
        return TunePlan("defaults", k_opt, cadence)
    per_step = model.step_us(n_flows) + max(exchange_tick_us, 0.0)
    # a knob the user moved off its hand default is theirs, not ours —
    # but the preference is computed regardless, so the audit trail
    # records the would-have-chosen K even when the knob is pinned
    k_model = _tuned_k(model, per_step, cadence)
    k = k_model if k_opt == DEFAULT_K else k_opt
    # delta-compacted flush: ON only when the measured size slope says
    # the readback bytes saved beat the compaction's extra kernel work
    from ..ops.torcells_device import flush_len
    cap_c, cap_h = flush_caps(n_chains, n_nodes)
    full = flush_len(n_chains, n_nodes)
    capped = flush_len(n_chains, n_nodes, cap_c, cap_h)
    bytes_saved = (full - capped) * 8
    compact = model.flush_savings_us(bytes_saved) > COMPACT_MIN_SAVINGS_US
    return TunePlan("model", k, cadence,
                    flush_compact=compact,
                    flush_cap_chains=cap_c if compact else 0,
                    flush_cap_nodes=cap_h if compact else 0,
                    predicted_step_us=per_step,
                    predicted_fixed_us=model.transfer_us(),
                    flush_bytes_cap_saved=bytes_saved if compact else 0,
                    k_would=k_model)
