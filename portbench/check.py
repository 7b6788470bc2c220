"""Whether the timed path produced the right answers.

Every episode of the window is held to its scenario's plain reference
(``scenario.check``) once the window has closed.  The one number
compared is how many of the episodes' answers differ from the
reference's, summed over the episodes; the simulation is exact, so its
limit is 0.
"""

from __future__ import annotations

from typing import Dict, List

# each compared number and its limit
LIMITS = {"answers_off": 0}


def check_all(records: List[Dict], scenario, config: Dict, traffic: Dict,
              device) -> Dict:
    """Every episode against the scenario's reference on ``device``: the
    compared numbers, the answers off by kind (the scenario's ``PARTS``),
    the episodes with any answer off, and each episode's reference
    outcome (``rec["ref"]``)."""
    parts = {k: 0 for k in scenario.PARTS}
    failed = 0
    for rec in records:
        off, rec["ref"] = scenario.check(rec, config, traffic, device)
        failed += any(off.values())
        for k, v in off.items():
            parts[k] += v
    numbers = {"answers_off": sum(parts.values())}
    correct = len(records) > 0 and all(
        v <= LIMITS[k] for k, v in numbers.items())
    return {"numbers": numbers, "parts": parts, "failed": failed,
            "correct": correct}
