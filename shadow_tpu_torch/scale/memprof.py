"""Memory accounting for the scale tier: bytes-per-host and peak RSS,
published through the PR-3 metrics registry so bench and CI gate memory
the way they gate digests (``make bench-smoke`` reads these back from the
metrics JSONL via tools/trace_report.py --metrics).

Two views, both honest about what they measure:

* **RSS view** — resident-set deltas around Controller.setup() plus the
  process peak (``getrusage`` ru_maxrss).  Includes interpreter overhead,
  numpy pools, everything: the number an operator's OOM killer sees.
* **Table view** — the HostTable's exact column bytes per row: the
  marginal cost the struct-of-arrays design promises (~hundreds of bytes
  per quiet host vs ~10 KB per eager Host).
"""

from __future__ import annotations

import resource
from typing import Dict, Optional


def current_rss_bytes() -> int:
    """Resident set size from /proc (Linux); 0 when unreadable."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 0


def peak_rss_mb() -> float:
    """Process-lifetime peak RSS in MiB (ru_maxrss is KiB on Linux)."""
    return round(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024,
                 1)


class BootProfile:
    """Setup-phase memory/wall accounting: snapshot() before host
    registration, commit() after, then install() onto the engine's
    metrics registry as the 'scale' source."""

    def __init__(self):
        self.rss_before = 0
        self.rss_after = 0
        self.boot_sec = 0.0
        self.n_hosts = 0
        self._t0 = 0.0

    def snapshot(self) -> None:
        import time as _walltime
        self.rss_before = current_rss_bytes()
        self._t0 = _walltime.monotonic()

    def commit(self, n_hosts: int) -> None:
        import time as _walltime
        self.boot_sec = round(_walltime.monotonic() - self._t0, 3)
        self.rss_after = current_rss_bytes()
        self.n_hosts = max(1, n_hosts)

    def bytes_per_host(self) -> int:
        return max(0, self.rss_after - self.rss_before) // self.n_hosts

    def install(self, engine) -> None:
        engine.metrics.source("scale", lambda: scrape(engine, self))


def scrape(engine, profile: Optional[BootProfile]) -> Dict:
    """The 'scale' metrics source: boot cost + table occupancy.  Flat
    namespace, same registry bench.py reads flush/overlap numbers from."""
    out: Dict = {}
    if profile is not None:
        out["scale.boot_sec"] = profile.boot_sec
        out["scale.bytes_per_host"] = profile.bytes_per_host()
        out["scale.boot_rss_mb"] = round(profile.rss_after / (1024 * 1024),
                                         1)
    out["scale.peak_rss_mb"] = peak_rss_mb()
    table = getattr(engine, "host_table", None)
    if table is not None:
        out.update(table.stats())
        out["scale.table_bytes_per_host"] = \
            table.nbytes() // max(1, table.rows)
    return out
