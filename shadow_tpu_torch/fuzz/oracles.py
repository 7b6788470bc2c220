"""The pluggable oracle set: every invariant a fuzzed scenario must hold.

Each oracle is a function ``(spec, results) -> [violation...]`` over the
per-mode result dicts runner.py produces; a violation is a dict
``{"oracle", "detail", "modes"}``.  The set mirrors the invariants every
PR already swears by in tests — digest determinism and cross-mode parity,
event-count conservation, supervision cleanliness, mesh exactness, rc/log
hygiene — applied to scenarios nobody hand-wrote.

``check(spec, results)`` runs the spec's oracle subset (default: all) and
returns the merged violation list, most fundamental first.
"""

from __future__ import annotations

from typing import Callable, Dict, List

Violation = Dict
_ORACLES: Dict[str, Callable] = {}


def oracle(name: str):
    def deco(fn):
        _ORACLES[name] = fn
        return fn
    return deco


def _v(name: str, detail: str, modes: List[str]) -> Violation:
    return {"oracle": name, "detail": detail, "modes": modes}


def _live(results: List[Dict]) -> List[Dict]:
    """Modes that actually ran to completion (skipped/errored modes are
    the rc oracle's business, not parity's)."""
    return [r for r in results
            if not r.get("skipped") and r.get("rc") == 0]


def _by_group(live: List[Dict]) -> Dict[str, List[Dict]]:
    """Partition results by digest group.  A mode that legitimately takes
    a different trajectory (the bbrx CC legs, ISSUE 19) carries its own
    ``digest_group``; parity/conservation hold WITHIN each group, never
    across them.  Absent key = the historical "base" group, so old corpus
    records replay unchanged."""
    groups: Dict[str, List[Dict]] = {}
    for r in live:
        groups.setdefault(r.get("digest_group") or "base", []).append(r)
    return groups


@oracle("rc_log")
def oracle_rc_log(spec: Dict, results: List[Dict]) -> List[Violation]:
    """Every non-skipped mode exits rc 0 inside its wall bound, with no
    tracebacks or critical lines in the log."""
    out = []
    for r in results:
        if r.get("skipped"):
            continue
        if r.get("timeout"):
            out.append(_v("rc_log", r.get("log_tail", "timeout"),
                          [r["mode"]]))
            continue
        if r.get("rc") != 0:
            out.append(_v("rc_log", f"rc={r.get('rc')}: "
                          f"{r.get('log_tail', '')[-300:]}", [r["mode"]]))
            continue
        tail = r.get("log_tail") or ""
        for marker in ("Traceback (most recent call last)", "[critical]"):
            if marker in tail:
                out.append(_v("rc_log", f"{marker!r} in log: "
                              f"{tail[-300:]}", [r["mode"]]))
                break
    return out


@oracle("stability")
def oracle_stability(spec: Dict, results: List[Dict]) -> List[Violation]:
    """Repeat runs of the same mode are bit-identical: same digest, same
    event count (seeded determinism is the whole contract)."""
    by_name = {r["mode"]: r for r in _live(results)}
    out = []
    for r in _live(results):
        base = by_name.get(r.get("repeat_of") or "")
        if base is None:
            continue
        if r["digest"] != base["digest"]:
            out.append(_v("stability",
                          f"repeat digest {r['digest']!r} != "
                          f"{base['digest']!r}", [base["mode"], r["mode"]]))
        if r["events"] != base["events"]:
            out.append(_v("stability",
                          f"repeat events {r['events']} != "
                          f"{base['events']}", [base["mode"], r["mode"]]))
    return out


@oracle("parity")
def oracle_parity(spec: Dict, results: List[Dict]) -> List[Violation]:
    """Cross-mode digest parity: every mode of the matrix — device/numpy
    twins, K=1/K=8, table on/off, threaded, procs, mesh — ends in the
    same state digest, within its digest group (a group per legitimate
    trajectory: base, bbrx)."""
    out = []
    for _, live in sorted(_by_group(
            [r for r in _live(results) if r.get("digest")]).items()):
        if len(live) < 2:
            continue
        ref = live[0]
        for r in live[1:]:
            if r["digest"] != ref["digest"]:
                out.append(_v("parity",
                              f"{r['mode']} digest {r['digest']!r} != "
                              f"{ref['mode']} {ref['digest']!r}",
                              [ref["mode"], r["mode"]]))
    return out


@oracle("events")
def oracle_events(spec: Dict, results: List[Dict]) -> List[Violation]:
    """Event-count conservation across the serial single-process modes
    (device/numpy, K=1/K=8, table on/off execute the identical event
    stream; threaded/procs modes are digest-checked only).  Conservation
    holds within each digest group — a different CC trajectory schedules
    a different event stream."""
    out = []
    for _, live in sorted(_by_group(
            [r for r in _live(results)
             if r.get("events_comparable")
             and r.get("events") is not None]).items()):
        if len(live) < 2:
            continue
        ref = live[0]
        for r in live[1:]:
            if r["events"] != ref["events"]:
                out.append(_v("events",
                              f"{r['mode']} executed {r['events']} events "
                              f"!= {ref['mode']}'s {ref['events']}",
                              [ref["mode"], r["mode"]]))
    return out


@oracle("supervision")
def oracle_supervision(spec: Dict, results: List[Dict]) -> List[Violation]:
    """engine.supervision stays clean: zero watchdog fires, demotions, or
    recoveries in a healthy run (an ``engine:*`` fault spec — or a mode
    carrying its own ``engine_fault`` recovery drill, ISSUE 17 — flips
    the expectation: the drilled detour is judged by the parity oracle
    landing the base digest, not by a zero-recoveries ledger)."""
    fault = (spec.get("fault_inject") or {})
    expect_recoveries = fault.get("kind") == "engine"
    out = []
    for r in _live(results):
        sup = r.get("supervision")
        if sup is None:
            continue
        n = sup.get("recoveries", 0)
        if expect_recoveries or r.get("engine_fault"):
            continue            # drills are judged by their own tests
        if n:
            out.append(_v("supervision",
                          f"{r['mode']}: {n} recoveries in a healthy run: "
                          f"{sup}", [r["mode"]]))
    return out


@oracle("mesh")
def oracle_mesh(spec: Dict, results: List[Dict]) -> List[Violation]:
    """Sharded-mesh invariants: cross-shard forwards never transit the
    host, the plane never silently demotes, occupancy stays sane.  Modes
    drilling their own engine fault (ISSUE 17) are exempt — a drilled
    device loss legitimately reshapes the mesh mid-run, and the parity
    oracle already pins its end digest against the fault-free base."""
    out = []
    for r in _live(results):
        if r.get("engine_fault"):
            continue
        sc = r.get("scrape") or {}
        if "mesh.host_bounces" not in sc:
            continue
        if sc["mesh.host_bounces"] != 0:
            out.append(_v("mesh", f"{r['mode']}: host_bounces="
                          f"{sc['mesh.host_bounces']}", [r["mode"]]))
        if sc.get("mesh.demoted"):
            out.append(_v("mesh", f"{r['mode']}: sharded plane demoted",
                          [r["mode"]]))
        occ_min = sc.get("mesh.occupancy_min", 0)
        occ_mean = sc.get("mesh.occupancy_mean", 0)
        if not (0 < occ_min <= occ_mean <= 1.0001):
            out.append(_v("mesh",
                          f"{r['mode']}: occupancy insane (min={occ_min}, "
                          f"mean={occ_mean})", [r["mode"]]))
    return out


@oracle("completion")
def oracle_completion(spec: Dict, results: List[Dict]) -> List[Violation]:
    """Flow-completion conservation: every mode sees the same circuit
    count and completes the same number of them (completion inside the
    stoptime is scenario-dependent; its CONSISTENCY is not).  Judged
    within each digest group, like parity."""
    out = []
    for _, live in sorted(_by_group(
            [r for r in _live(results)
             if "plane.circuits" in (r.get("scrape") or {})]).items()):
        if len(live) < 2:
            continue
        ref = live[0]
        for r in live[1:]:
            for key in ("plane.circuits", "plane.completed"):
                if r["scrape"].get(key) != ref["scrape"].get(key):
                    out.append(_v("completion",
                                  f"{r['mode']} {key}="
                                  f"{r['scrape'].get(key)} != "
                                  f"{ref['mode']}'s "
                                  f"{ref['scrape'].get(key)}",
                                  [ref["mode"], r["mode"]]))
    return out


ORACLE_ORDER = ("rc_log", "stability", "parity", "events", "supervision",
                "mesh", "completion")


def check(spec: Dict, results: List[Dict]) -> List[Violation]:
    names = spec.get("oracles") or ORACLE_ORDER
    out: List[Violation] = []
    for name in ORACLE_ORDER:
        if name in names:
            out.extend(_ORACLES[name](spec, results))
    return out
