"""Trace report: summarize a flight-recorder trace file so CI and humans
read the same numbers.

Input is the Chrome trace-event JSON ``--trace PATH`` writes (obs/trace.py);
output is ONE JSON document on stdout:

* ``top_spans_by_self_time`` — per span name: count, total, self (total
  minus same-track children), mean — the profile's headline table;
* ``per_round_phase`` — wall totals of the engine's round phases
  (collect / dispatch.launch / round / flush / log.flush) plus per-round
  means, i.e. the BENCH phase columns recomputed from the trace itself;
* ``overlap_efficiency`` — device.inflight (device compute hidden behind
  host work) vs device.collect (exposed wait), the pipeline's honesty
  number;
* ``tracks`` — per (shard, thread) event counts, so a sharded run's merge
  is checkable at a glance (one entry per shard track).

``--metrics`` switches the input to a ``--metrics PATH`` JSONL stream
(obs/metrics.py): the report is the run's FINAL summary scrape (the
steady-state plane/engine/policy numbers CI gates key on —
``plane.rounds_per_launch``, ``plane.overlap_efficiency``, the
``engine.host_exec_*`` split) plus the scrape-record count, so
``make bench-smoke`` asserts the perf machinery from the same artifact a
production ``--metrics`` run writes.

``--compare A B`` diffs two metrics runs column-wise (ISSUE 10: the perf-PR
review artifact): every numeric key of the two final summaries side by
side with delta and ratio, keys present on one side only called out, so a
before/after pair of ``--metrics`` files turns into the regression table a
reviewer reads directly.

``--trend`` renders the persistent perf-trend ledger
(``BENCH_HISTORY.jsonl``, ISSUE 15 / shadow_tpu/prof/ledger.py): rows
grouped by family, every numeric column as a sparkline over the recorded
rounds plus latest-vs-best-known delta, and regression flags for the
columns whose good direction is known — the next perf regression is
caught by rereading THIS report, not CHANGES.md.

Usage: python -m shadow_tpu_torch.tools.trace_report <trace.json> [--pretty]
       python -m shadow_tpu_torch.tools.trace_report --metrics <metrics.jsonl>
       python -m shadow_tpu_torch.tools.trace_report --compare <A.jsonl> <B.jsonl>
       python -m shadow_tpu_torch.tools.trace_report --trend <BENCH_HISTORY.jsonl>
"""

from __future__ import annotations

import json
import sys
from collections import defaultdict
from typing import Dict, Iterable, List, Optional

ROUND_PHASES = ("collect", "dispatch.launch", "round", "flush", "log.flush",
                "checkpoint.write", "exchange")


def load_events(path: str) -> List[dict]:
    with open(path) as f:
        blob = json.load(f)
    if isinstance(blob, dict):
        events = blob.get("traceEvents", [])
    else:                      # bare-array form is legal Chrome JSON too
        events = blob
    if not isinstance(events, list):
        raise ValueError(f"{path}: traceEvents is not a list")
    return [e for e in events if e.get("ph") != "M"]


def self_times(events: Iterable[dict]) -> Dict[str, Dict[str, float]]:
    """Aggregate complete ('X') spans by name with self-time: duration
    minus the duration of spans nested inside them on the same track
    (computed with a containment stack per track, the standard flame-graph
    fold).  A span that merely OVERLAPS its predecessor — starts inside it
    but ends after, like the async ``device.inflight`` window stretching
    from one round's launch into the next round's collect — is not a
    child: it neither discounts the enclosing span's self-time nor becomes
    a parent for later spans."""
    by_track: Dict[tuple, List[dict]] = defaultdict(list)
    for e in events:
        if e.get("ph") == "X":
            by_track[(e.get("pid", 0), e.get("tid", ""))].append(e)
    agg: Dict[str, Dict[str, float]] = defaultdict(
        lambda: {"count": 0, "total_us": 0.0, "self_us": 0.0})
    for track_events in by_track.values():
        track_events.sort(key=lambda e: (e["ts"], -e.get("dur", 0.0)))
        stack: List[tuple] = []     # (end_ts, name) of open CONTAINED spans
        for e in track_events:
            ts, dur = e["ts"], e.get("dur", 0.0)
            end = ts + dur
            while stack and ts >= stack[-1][0]:
                stack.pop()
            contained = not stack or end <= stack[-1][0] + 1e-6
            if stack and contained:  # true child: charge parent self-time
                agg[stack[-1][1]]["self_us"] -= dur
            a = agg[e["name"]]
            a["count"] += 1
            a["total_us"] += dur
            a["self_us"] += dur
            if contained:
                stack.append((end, e["name"]))
    return dict(agg)


def summarize(events: List[dict]) -> Dict:
    events = [e for e in events if e.get("ph") != "M"]
    spans = self_times(events)
    # name tiebreak + pre-sorted input: the headline table stays
    # byte-stable across runs even when two spans measure equal self-time
    top = sorted(
        ({"name": name, "count": int(v["count"]),
          "total_ms": round(v["total_us"] / 1e3, 3),
          "self_ms": round(max(v["self_us"], 0.0) / 1e3, 3),
          "mean_us": round(v["total_us"] / max(v["count"], 1), 1)}
         for name, v in sorted(spans.items())),
        key=lambda r: (-r["self_ms"], r["name"]))
    rounds = spans.get("round", {}).get("count", 0)
    phases: Dict[str, Dict[str, float]] = {}
    for name in ROUND_PHASES:
        v = spans.get(name)
        if not v:
            continue
        phases[name] = {"total_ms": round(v["total_us"] / 1e3, 3),
                        "mean_us": round(v["total_us"] / max(v["count"], 1),
                                         1)}
    inflight = spans.get("device.inflight", {}).get("total_us", 0.0)
    blocked = spans.get("device.collect", {}).get("total_us", 0.0)
    tracks: Dict[str, int] = defaultdict(int)
    sim_min = sim_max = None
    for e in events:
        tracks[f"{e.get('pid', 0)}:{e.get('tid', '')}"] += 1
        sim = e.get("args", {}).get("sim_ns")
        if isinstance(sim, (int, float)) and sim >= 0:
            sim_min = sim if sim_min is None else min(sim_min, sim)
            sim_max = sim if sim_max is None else max(sim_max, sim)
    return {
        "events": len(events),
        "rounds": int(rounds),
        "tracks": dict(sorted(tracks.items())),
        "shards": sorted({e.get("pid", 0) for e in events}),
        "sim_span_s": (round((sim_max - sim_min) / 1e9, 3)
                       if sim_min is not None else None),
        "top_spans_by_self_time": top[:15],
        "per_round_phase": phases,
        "device": {
            "inflight_ms": round(inflight / 1e3, 3),
            "collect_blocked_ms": round(blocked / 1e3, 3),
            "overlap_efficiency": round(inflight / (inflight + blocked), 4)
            if (inflight + blocked) else None,
        },
    }


def summarize_metrics(records: List[dict]) -> Dict:
    """Report over a metrics JSONL stream: the final summary record's
    scrape (flat metric -> value) + stream shape.  Raises ValueError when
    the stream has no summary record (a crashed run never writes one — CI
    must see that as a failure, not an empty report)."""
    summaries = [r for r in records if r.get("summary")]
    if not summaries:
        raise ValueError("no summary record (run did not finish?)")
    final = summaries[-1]
    metrics = final.get("metrics", {})
    # histogram digest table (ISSUE 15): the percentile columns pulled
    # up next to each other so a human reads tails without digging
    # through the flat scrape's nested dicts
    hists = {
        name: {k: v[k] for k in ("count", "mean", "p50", "p95", "p99",
                                 "min", "max") if k in v}
        for name, v in sorted(metrics.items())
        if isinstance(v, dict) and "count" in v and v["count"]}
    return {
        "scrape_records": len(records) - len(summaries),
        "rounds": final.get("round"),
        "sim_time_ns": final.get("sim_time_ns"),
        "histograms": hists,
        "final": metrics,
    }


def compare_metrics(a_records: List[dict], b_records: List[dict]) -> Dict:
    """Column-wise diff of two metrics runs' final summaries.  Numeric
    keys carry (a, b, delta, ratio); non-numeric keys compare by equality;
    keys on one side only land in ``only_a``/``only_b`` — nothing is
    silently dropped.  Ratio is b/a (>1 = B larger), None when a == 0."""
    fa = summarize_metrics(a_records)["final"]
    fb = summarize_metrics(b_records)["final"]
    num = (int, float)
    columns: Dict[str, Dict] = {}
    changed: Dict[str, Dict] = {}
    for key in sorted(set(fa) & set(fb)):
        va, vb = fa[key], fb[key]
        if isinstance(va, num) and isinstance(vb, num) \
                and not isinstance(va, bool) and not isinstance(vb, bool):
            row = {"a": va, "b": vb, "delta": round(vb - va, 6),
                   "ratio": round(vb / va, 4) if va else None}
            columns[key] = row
            if row["delta"]:
                changed[key] = row
        elif va != vb:
            changed[key] = columns[key] = {"a": va, "b": vb}
    return {
        "keys_compared": len(set(fa) & set(fb)),
        "only_a": sorted(set(fa) - set(fb)),
        "only_b": sorted(set(fb) - set(fa)),
        "changed": changed,
        "columns": columns,
    }


# -- perf-trend ledger rendering (ISSUE 15) ---------------------------------

_SPARK = "▁▂▃▄▅▆▇█"

# which direction is GOOD, per column-name pattern.  Higher-better is
# matched FIRST (sim_sec_per_wall_sec ends in _sec but is a rate);
# unknown columns still render, they just carry no regression verdict.
_HIGHER_BETTER = ("sim_sec_per_wall", "per_sec", "fraction", "efficiency",
                  "rounds_per_launch", "events", "completed", "forwards",
                  "occupancy")
_LOWER_BETTER = ("_sec", "_us", "_ns", "_ms", "_mb", "bytes",
                 "host_bounces", "model_stale", "violations", "recoveries",
                 "demoted", "findings", "problems", "_rc")


def _direction(col: str) -> Optional[str]:
    c = col.lower()
    # specific names first: cut_fraction is the partitioner's cross-shard
    # hop share — LOWER is better, despite the generic "fraction" rule
    if "cut_fraction" in c:
        return "lower"
    if any(p in c for p in _HIGHER_BETTER):
        return "higher"
    if any(p in c for p in _LOWER_BETTER):
        return "lower"
    return None


def _sparkline(values: List[float]) -> str:
    lo, hi = min(values), max(values)
    if hi == lo:
        return _SPARK[3] * len(values)
    return "".join(
        _SPARK[min(int((v - lo) / (hi - lo) * (len(_SPARK) - 1)),
                   len(_SPARK) - 1)] for v in values)


def summarize_trend(records: List[dict], last_n: int = 16,
                    regress_pct: float = 10.0) -> Dict:
    """Render the ledger: rows grouped by family (record ``row`` key),
    each numeric column as (latest, best-known, delta, sparkline) over
    the recorded history, regression-flagged when the good direction is
    known and the latest value is >``regress_pct``% worse than the best.
    Raises ValueError on an empty ledger — CI must see that as a
    failure, not an empty trajectory."""
    if not records:
        raise ValueError("ledger is empty (no rows ever appended?)")
    by_row: Dict[str, List[dict]] = defaultdict(list)
    for rec in records:
        by_row[rec.get("row", "?")].append(rec)
    rows: Dict[str, Dict] = {}
    regressions: List[str] = []
    for name, recs in sorted(by_row.items()):
        recs = sorted(recs, key=lambda r: r.get("ts", ""))
        cols: Dict[str, List[float]] = defaultdict(list)
        for rec in recs:
            for col, v in (rec.get("cols") or {}).items():
                if isinstance(v, (int, float)) \
                        and not isinstance(v, bool):
                    cols[col].append(float(v))
        col_out: Dict[str, Dict] = {}
        row_regs: List[str] = []
        for col, vals in sorted(cols.items()):
            vals = vals[-last_n:]
            direction = _direction(col)
            latest = vals[-1]
            best = max(vals) if direction == "higher" else min(vals)
            entry = {
                "latest": latest,
                "best": best,
                "delta_vs_best": round(latest - best, 6),
                "spark": _sparkline(vals),
                "n": len(vals),
                "direction": direction,
            }
            if direction is not None and len(vals) >= 2:
                scale = abs(best) if best else 1.0
                worse = (best - latest if direction == "higher"
                         else latest - best)
                entry["regressed"] = bool(
                    worse / scale * 100.0 > regress_pct)
                if entry["regressed"]:
                    row_regs.append(col)
            else:
                entry["regressed"] = None
            col_out[col] = entry
        rows[name] = {
            "n": len(recs),
            "first_ts": recs[0].get("ts"),
            "last_ts": recs[-1].get("ts"),
            "latest_sha": recs[-1].get("sha"),
            "boxes": sorted({r.get("box") for r in recs}),
            "columns": col_out,
            "regressions": row_regs,
        }
        regressions.extend(f"{name}:{c}" for c in row_regs)
    return {"rows": rows, "row_families": sorted(by_row),
            "records": len(records), "regressions": regressions}


def main(argv: List[str]) -> int:
    usage = ("usage: python -m shadow_tpu_torch.tools.trace_report "
             "<trace.json> [--pretty] | --metrics <metrics.jsonl> | "
             "--compare <A.jsonl> <B.jsonl> | "
             "--trend <BENCH_HISTORY.jsonl>")
    if not argv:
        print(usage, file=sys.stderr)
        return 2
    pretty = "--pretty" in argv
    metrics_mode = "--metrics" in argv
    compare_mode = "--compare" in argv
    trend_mode = "--trend" in argv
    paths = [a for a in argv if not a.startswith("--")]
    if not paths:
        print(usage, file=sys.stderr)
        return 2
    if trend_mode:
        from ..prof.ledger import load_history
        try:
            report = summarize_trend(load_history(paths[0]))
        except (OSError, ValueError, json.JSONDecodeError) as e:
            print(f"error: cannot render trend {paths[0]!r}: {e}",
                  file=sys.stderr)
            return 1
        json.dump(report, sys.stdout, indent=2 if pretty else None,
                  sort_keys=True, ensure_ascii=False)
        print()
        return 0
    if compare_mode:
        if len(paths) != 2:
            print(usage, file=sys.stderr)
            return 2
        from ..obs.metrics import read_metrics_file
        try:
            report = compare_metrics(read_metrics_file(paths[0]),
                                     read_metrics_file(paths[1]))
        except (OSError, ValueError, json.JSONDecodeError) as e:
            print(f"error: cannot compare metrics: {e}", file=sys.stderr)
            return 1
        json.dump(report, sys.stdout, indent=2 if pretty else None,
                  sort_keys=True)
        print()
        return 0
    path = paths[0]
    if metrics_mode:
        from ..obs.metrics import read_metrics_file
        try:
            report = summarize_metrics(read_metrics_file(path))
        except (OSError, ValueError, json.JSONDecodeError) as e:
            print(f"error: cannot read metrics {path!r}: {e}",
                  file=sys.stderr)
            return 1
        json.dump(report, sys.stdout, indent=2 if pretty else None,
                  sort_keys=True)
        print()
        return 0
    try:
        events = load_events(path)
    except (OSError, ValueError, json.JSONDecodeError) as e:
        print(f"error: cannot read trace {path!r}: {e}", file=sys.stderr)
        return 1
    report = summarize(events)
    json.dump(report, sys.stdout, indent=2 if pretty else None,
              sort_keys=True)
    print()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
