"""Log parsing/plotting: the reference's tools/parse-shadow.py +
plot-shadow.py + strip_log_for_compare.py, for shadow_tpu log output.

Line format (core/logger.py LogRecord.format):
    <wall_s> [<thread>] <HH:MM:SS.ns|n/a> [<level>] [<domain>] <text>

Heartbeats (host/tracker.py):
    ... [tracker] [shadow-heartbeat] [<host>] rx=N tx=N rx_pkts=N tx_pkts=N
        retrans=N drops=N proc_ms=F

Three entry points (also usable as a library):
    parse  <log>           -> summary JSON on stdout (per-host totals,
                              throughput time series, sim/wall ratio)
    strip  <log>           -> canonical lines for determinism diffing
                              (wall time + thread removed — the reference's
                              strip_log_for_compare.py)
    plot   <log> <out.png> -> throughput/heartbeat plots (needs matplotlib)
"""

from __future__ import annotations

import json
import re
import sys
from collections import defaultdict
from typing import Dict, Iterable, List, Optional

LINE_RE = re.compile(
    r"^(?P<wall>\d+\.\d+) \[(?P<thread>[^\]]*)\] (?P<sim>\S+) "
    r"\[(?P<level>[^\]]*)\] \[(?P<domain>[^\]]*)\] (?P<text>.*)$")
HEARTBEAT_RE = re.compile(
    r"\[shadow-heartbeat\] \[(?P<host>[^\]]+)\] rx=(?P<rx>\d+) tx=(?P<tx>\d+) "
    r"rx_pkts=(?P<rx_pkts>\d+) tx_pkts=(?P<tx_pkts>\d+) "
    r"retrans=(?P<retrans>\d+) drops=(?P<drops>\d+) proc_ms=(?P<proc_ms>[\d.]+)")
FINISH_RE = re.compile(
    r"simulation finished: (?P<rounds>\d+) rounds, (?P<events>\d+) events, "
    r"(?P<wall>[\d.]+)s wall")


def parse_sim_time(text: str) -> Optional[float]:
    """'HH:MM:SS.ns' -> seconds; 'n/a' -> None."""
    if text == "n/a":
        return None
    try:
        h, m, rest = text.split(":")
        s, _, ns = rest.partition(".")
        return int(h) * 3600 + int(m) * 60 + int(s) + (int(ns) / 1e9 if ns else 0.0)
    except ValueError:
        return None


def iter_records(lines: Iterable[str]):
    for line in lines:
        m = LINE_RE.match(line.rstrip("\n"))
        if m:
            yield m.groupdict()


def parse_log(lines: Iterable[str]) -> Dict:
    """Aggregate a run's log into the reference parse-shadow.py-style
    summary: per-host heartbeat series + totals + run info."""
    hosts: Dict[str, List[Dict]] = defaultdict(list)
    info: Dict = {}
    last_sim = 0.0
    for rec in iter_records(lines):
        sim_t = parse_sim_time(rec["sim"])
        if sim_t is not None:
            last_sim = max(last_sim, sim_t)
        hb = HEARTBEAT_RE.search(rec["text"])
        if hb:
            d = {k: (float(v) if k == "proc_ms" else int(v)) if k != "host" else v
                 for k, v in hb.groupdict().items()}
            d["time_s"] = sim_t
            hosts[hb.group("host")].append(d)
            continue
        fin = FINISH_RE.search(rec["text"])
        if fin:
            info = {"rounds": int(fin.group("rounds")),
                    "events": int(fin.group("events")),
                    "wall_s": float(fin.group("wall"))}
    totals = {}
    for host, series in hosts.items():
        last = series[-1]
        totals[host] = {"rx_bytes": last["rx"], "tx_bytes": last["tx"],
                        "rx_pkts": last["rx_pkts"], "tx_pkts": last["tx_pkts"],
                        "retrans": last["retrans"], "drops": last["drops"]}
    out = {
        "hosts": totals,
        "num_hosts": len(totals),
        "total_rx_bytes": sum(t["rx_bytes"] for t in totals.values()),
        "total_tx_bytes": sum(t["tx_bytes"] for t in totals.values()),
        "total_retrans": sum(t["retrans"] for t in totals.values()),
        "total_drops": sum(t["drops"] for t in totals.values()),
        "sim_seconds": last_sim,
        "run": info,
        "series": {h: s for h, s in hosts.items()},
    }
    if info.get("wall_s"):
        out["sim_sec_per_wall_sec"] = last_sim / info["wall_s"]
    return out


def strip_log(lines: Iterable[str]) -> Iterable[str]:
    """Canonical form for determinism diffing: drop wall time and thread
    (nondeterministic), keep (sim time, level, domain, text) — the exact
    transformation of the reference's strip_log_for_compare.py."""
    for rec in iter_records(lines):
        text = rec["text"]
        # engine heartbeats are wall-clock-gated (fire after N wall seconds):
        # both their presence and their content are nondeterministic, exactly
        # like the reference's getrusage heartbeats its strip tool drops
        if text.startswith("[engine-heartbeat]"):
            continue
        # wall-clock durations inside message text are nondeterministic too
        text = re.sub(r"[\d.]+s wall", "<wall>s wall", text)
        text = re.sub(r"\(host_exec [\d.]+s, flush [\d.]+s\)",
                      "(host_exec <s>, flush <s>)", text)
        yield f"{rec['sim']} [{rec['level']}] [{rec['domain']}] {text}"


def plot_log(lines: Iterable[str], out_path: str) -> bool:
    """Throughput-over-time plot per host; returns False if matplotlib is
    unavailable (plot-shadow.py equivalent)."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib not available; skipping plot", file=sys.stderr)
        return False
    summary = parse_log(lines)
    fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(10, 8), sharex=True)
    for host, series in summary["series"].items():
        ts = [p["time_s"] for p in series if p["time_s"] is not None]
        rx = [p["rx"] for p in series if p["time_s"] is not None]
        tx = [p["tx"] for p in series if p["time_s"] is not None]
        if not ts:
            continue
        # cumulative -> rate between heartbeats
        rx_rate = [0.0] + [(b - a) / max(t2 - t1, 1e-9) / 1024
                           for a, b, t1, t2 in zip(rx, rx[1:], ts, ts[1:])]
        tx_rate = [0.0] + [(b - a) / max(t2 - t1, 1e-9) / 1024
                           for a, b, t1, t2 in zip(tx, tx[1:], ts, ts[1:])]
        ax1.plot(ts, rx_rate, alpha=0.6, label=host if len(summary["series"]) <= 12 else None)
        ax2.plot(ts, tx_rate, alpha=0.6)
    ax1.set_ylabel("rx KiB/s")
    ax2.set_ylabel("tx KiB/s")
    ax2.set_xlabel("virtual time (s)")
    if len(summary["series"]) <= 12:
        ax1.legend(fontsize=8)
    fig.suptitle("shadow_tpu per-host throughput")
    fig.savefig(out_path, dpi=120)
    return True


def main(argv: List[str]) -> int:
    if len(argv) < 2:
        print("usage: python -m shadow_tpu_torch.tools.parse_log "
              "{parse|strip|plot} <log> [out.png]", file=sys.stderr)
        return 2
    cmd, path = argv[0], argv[1]
    with open(path) as f:
        lines = f.readlines()
    if cmd == "parse":
        summary = parse_log(lines)
        summary.pop("series")  # keep stdout JSON compact
        json.dump(summary, sys.stdout, indent=2, sort_keys=True)
        print()
        return 0
    if cmd == "strip":
        for line in strip_log(lines):
            print(line)
        return 0
    if cmd == "plot":
        out = argv[2] if len(argv) > 2 else "shadow_plot.png"
        return 0 if plot_log(lines, out) else 1
    print(f"unknown command {cmd!r}", file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
