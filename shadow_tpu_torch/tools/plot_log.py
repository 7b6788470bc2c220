"""Plot tool: simulation log -> throughput + engine-heartbeat figures.

The reference ships src/tools/plot-shadow.py (parse the log, plot per-host
throughput and resource usage over time); this is its analog over
tools/parse_log.py's record stream:

* panel 1/2: per-host rx/tx rate between tracker heartbeats (KiB/s over
  virtual time) — parse_log.plot_log's figure;
* panel 3: engine heartbeats — wall-clock progress and max RSS against
  virtual time (the reference plots its getrusage heartbeats the same way).

Usage: python -m shadow_tpu_torch.tools.plot_log <log> [out.png]
Exit 1 if matplotlib is unavailable (the simulator itself never needs it).
"""

from __future__ import annotations

import re
import sys
from typing import Iterable, List

from .parse_log import iter_records, plot_log

_HB = re.compile(
    r"\[engine-heartbeat\] rounds=(\d+) simtime=([\d.]+)s wall=([\d.]+)s"
    r".*? maxrss_mb=(\d+)")


def engine_heartbeats(lines: Iterable[str]) -> List[dict]:
    out = []
    for rec in iter_records(lines):
        m = _HB.search(rec["text"])
        if m:
            out.append({"rounds": int(m.group(1)),
                        "sim_s": float(m.group(2)),
                        "wall_s": float(m.group(3)),
                        "maxrss_mb": int(m.group(4))})
    return out


def plot_heartbeats(lines: Iterable[str], out_path: str) -> bool:
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib not available; skipping plot", file=sys.stderr)
        return False
    hbs = engine_heartbeats(lines)
    if not hbs:
        return False
    fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(10, 6), sharex=True)
    sim = [h["sim_s"] for h in hbs]
    ax1.plot(sim, [h["wall_s"] for h in hbs], marker="o")
    ax1.set_ylabel("wall time (s)")
    ax2.plot(sim, [h["maxrss_mb"] for h in hbs], marker="o", color="tab:red")
    ax2.set_ylabel("max RSS (MB)")
    ax2.set_xlabel("virtual time (s)")
    fig.suptitle("shadow_tpu engine heartbeats")
    fig.savefig(out_path, dpi=120)
    return True


def main(argv: List[str]) -> int:
    if len(argv) < 1:
        print("usage: python -m shadow_tpu_torch.tools.plot_log <log> [out.png]",
              file=sys.stderr)
        return 2
    path = argv[0]
    out = argv[1] if len(argv) > 1 else "shadow_plot.png"
    with open(path) as f:
        lines = f.readlines()
    ok = plot_log(lines, out)
    hb_out = out.rsplit(".", 1)[0] + "_heartbeats.png"
    plot_heartbeats(lines, hb_out)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
