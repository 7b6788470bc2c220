"""Whether the timed path produced the right answers.

Every episode of the window is held to the plain reference
(``reference.py``) once the window has closed.  Its answers: the time
each chain delivered its last cell (the end of its tick in ms, so a
coarser tick cannot hide), each host's bytes sent and received as the
plane's flush folded them into the host table, the cells forwarded, the
circuits completed, and the episode's exit code.  The one number compared
is how many of those answers differ from the reference's, summed over the
episodes; the simulation is exact, so its limit is 0.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from . import reference

# each compared number and its limit
LIMITS = {"answers_off": 0}
# the kinds of answer it counts, printed beside it
PARTS = ("chains", "hosts", "forwards", "completed", "exit_code")


def done_ms(done: np.ndarray, granule: int) -> np.ndarray:
    """A chain's completion as the end of its tick in ms, -1 for none."""
    return np.where(done >= 0, (done + 1) * granule, -1)


def compare(rec: Dict, out: reference.Outcome,
            net: reference.Network) -> Dict[str, int]:
    """One episode's answers that differ from the reference's, by kind."""
    rows = {}
    for name, quantity, first, count in rec["groups"]:
        for q in range(count):
            rows[name if quantity == 1 else f"{name}{q + 1}"] = first + q
    idx = np.array([rows.get(nm, -1) for nm in net.host_names])
    missing = idx < 0
    idx = np.maximum(idx, 0)
    tx = np.where(missing, -1, rec["tx"][idx])
    rx = np.where(missing, -1, rec["rx"][idx])
    got = done_ms(rec["chain_done"], rec["granule"])
    want = done_ms(out.done_tick, out.granule_ms)
    off = len(want) if got.shape != want.shape else int((got != want).sum())
    return {"chains": off,
            "hosts": int(((tx != out.host_tx) | (rx != out.host_rx)).sum()),
            "forwards": int(rec["forwards"] != out.forwards),
            "completed": int(rec["completed"] != out.completed),
            "exit_code": int(rec["rc"] != 0)}


def check_all(records: List[Dict], config: Dict, traffic: Dict,
              device) -> Dict:
    """Every episode against the reference on ``device``: the compared
    numbers, the answers off by kind, the episodes with any answer off,
    and each episode's reference outcome (``rec["ref"]``)."""
    parts = {k: 0 for k in PARTS}
    failed = 0
    for rec in records:
        net = reference.tor_network(config, traffic, rec["path_seed"])
        out = reference.simulate(net, device)
        rec["ref"] = out
        off = compare(rec, out, net)
        failed += any(off.values())
        for k, v in off.items():
            parts[k] += v
    numbers = {"answers_off": sum(parts.values())}
    correct = len(records) > 0 and all(
        v <= LIMITS[k] for k, v in numbers.items())
    return {"numbers": numbers, "parts": parts, "failed": failed,
            "correct": correct}
