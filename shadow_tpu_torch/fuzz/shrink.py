"""Shrink a violating spec to a minimal reproducer.

Greedy delta-debugging over the spec's structure: each candidate
transformation (drop a mode, drop an app group, drop the topology, halve
a numeric parameter, halve the stoptime) is applied ONE at a time and the
spec re-run; the candidate is kept only if the SAME oracle still fires.
Candidates are generated in a fixed order and the loop runs to a
fixpoint, so the minimal repro for a given (spec, violation, runner) is
deterministic.  Total re-runs are bounded by ``budget`` — a shrink is an
optimization, never a place to wedge.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, List, Optional, Tuple

from .oracles import check

# per-family floors the halving steps respect (below these, builders
# reject or the shape degenerates away from what it reproduces)
_PARAM_FLOORS = {
    "n_clients": 2, "n_hosts": 6, "n_peers": 4, "n_origins": 1,
    "pieces": 1, "msgs_in_flight": 1, "stagger_waves": 1,
    "down_bytes": 1024, "up_bytes": 0, "piece_bytes": 1024,
    "bw_kibps": 1024,
}
_HALVE_KEYS = tuple(sorted(_PARAM_FLOORS))


def _candidates(spec: Dict) -> List[Tuple[str, Dict]]:
    """All single-step reductions of ``spec``, in fixed order."""
    out: List[Tuple[str, Dict]] = []
    # 1. drop one mode (keep >= 2 so cross-mode oracles stay meaningful)
    if len(spec["modes"]) > 2:
        for i, m in enumerate(spec["modes"]):
            cand = copy.deepcopy(spec)
            del cand["modes"][i]
            out.append((f"drop mode {m['name']}", cand))
    # 2. drop one app group
    for i, app in enumerate(spec.get("apps", [])):
        cand = copy.deepcopy(spec)
        del cand["apps"][i]
        out.append((f"drop app {app['id']}", cand))
    # 3. drop the generated topology
    if spec.get("topology"):
        cand = copy.deepcopy(spec)
        cand["topology"] = None
        out.append(("drop topology", cand))
    # 4. halve numeric params (floored); small values also step by one
    #    so the minimum can land exactly on a failure boundary halving
    #    jumps over (40 -> 20 -> 10 -> 5 can never reach 4)
    for key in _HALVE_KEYS:
        val = spec["params"].get(key)
        floor = _PARAM_FLOORS[key]
        if isinstance(val, int) and val > floor:
            cand = copy.deepcopy(spec)
            cand["params"][key] = max(floor, val // 2)
            out.append((f"halve {key} to {cand['params'][key]}", cand))
            if val <= 8 and val - 1 != cand["params"][key]:
                dec = copy.deepcopy(spec)
                dec["params"][key] = val - 1
                out.append((f"reduce {key} to {val - 1}", dec))
    # 5. halve the stoptime (floor 6: starts at ~2s + staggers must fit)
    if spec["stoptime"] > 6:
        cand = copy.deepcopy(spec)
        cand["stoptime"] = max(6, spec["stoptime"] // 2)
        out.append((f"halve stoptime to {cand['stoptime']}", cand))
    return out


def _still_fails(spec: Dict, oracle: str, runner) -> Optional[Dict]:
    """Re-run the candidate; return the matching violation (same oracle)
    or None."""
    for v in check(spec, runner.run(spec)):
        if v["oracle"] == oracle:
            return v
    return None


def shrink(spec: Dict, violation: Dict, runner, budget: int = 40,
           log: Optional[Callable[[str], None]] = None,
           deadline: Optional[float] = None) -> Tuple[Dict, Dict, int]:
    """Minimize ``spec`` while ``violation['oracle']`` keeps firing.

    Returns ``(minimal_spec, final_violation, runs_used)``.  The runner
    must be the same kind the violation was found with (results, and so
    the violation, can depend on the execution surface).  ``deadline``
    (a ``time.monotonic()`` timestamp) stops the loop between candidate
    runs — a wall-capped caller (fuzz-smoke, the bench leg) gets its
    best-so-far repro instead of losing the violation to an outer
    kill."""
    import time as _walltime
    oracle = violation["oracle"]
    current = copy.deepcopy(spec)
    final = violation
    runs = 0
    progress = True
    while progress and runs < budget:
        progress = False
        for desc, cand in _candidates(current):
            if runs >= budget:
                break
            if deadline is not None and _walltime.monotonic() >= deadline:
                if log:
                    log("shrink: wall cap reached; keeping the "
                        "best-so-far repro")
                return current, final, runs
            runs += 1
            got = _still_fails(cand, oracle, runner)
            if got is not None:
                if log:
                    log(f"shrink: kept '{desc}' ({oracle} still fires)")
                current, final = cand, got
                progress = True
                break       # restart candidate scan from the smaller spec
    return current, final, runs
