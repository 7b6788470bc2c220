"""BENCH_HISTORY.jsonl — the persistent perf-trend ledger.

Every bench row used to die with the run that produced it (the BENCH_r*
files are hand-curated snapshots; the trajectory between them was
literally empty).  The ledger fixes that at the cheapest possible layer:
bench.py appends ONE JSON line per flagship/sharded row, keyed by box
hostname + git sha + UTC timestamp, and ``trace_report --trend`` renders
the trajectory (per-column sparklines, regression flags vs the
best-known value) so a regression is caught by the repo, not by a human
rereading CHANGES.md.

Records are append-only and line-delimited: a crashed bench still leaves
every earlier row readable, and the file diffs cleanly in review.  Only
scalar columns are kept (nested dicts are flattened one level) so the
trend report can treat every column numerically.
"""

from __future__ import annotations

import json
import os
import subprocess
import time as _walltime
from typing import Dict, List, Optional

LEDGER_VERSION = 1


def repo_git_sha(cwd: Optional[str] = None) -> Optional[str]:
    """Short git sha of the repo containing this package (None when git
    or the repo is unavailable — callers record 'unknown', not a crash)."""
    from . import repo_root
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            cwd=cwd or repo_root(),
            capture_output=True, text=True, timeout=10)
    except (OSError, subprocess.TimeoutExpired):
        return None
    sha = out.stdout.strip()
    return sha if out.returncode == 0 and sha else None


def default_history_path() -> str:
    from . import HISTORY_BASENAME, repo_root
    return os.path.join(repo_root(), HISTORY_BASENAME)


def _flatten_cols(row: Dict) -> Dict:
    """Scalar columns only, nested dicts flattened ONE level with a dotted
    prefix (the bench rows' ``plane`` sub-dict); deeper nesting and lists
    are dropped — the trend report is column-wise."""
    out: Dict = {}
    for k, v in row.items():
        if isinstance(v, (int, float, bool)) or v is None \
                or isinstance(v, str):
            out[k] = v
        elif isinstance(v, dict):
            for k2, v2 in v.items():
                if isinstance(v2, (int, float, bool)):
                    out[f"{k}.{k2}"] = v2
    return out


def append_row(path: str, name: str, cols: Dict,
               box: Optional[str] = None,
               sha: Optional[str] = None) -> Dict:
    """Append one ledger record; returns it.  ``name`` identifies the row
    family (``tor10k_device_plane_native_long``, ``multichip``, ...) so
    the trend groups like with like across rounds."""
    import platform

    rec = {
        "v": LEDGER_VERSION,
        "ts": _walltime.strftime("%Y-%m-%dT%H:%M:%SZ",
                                 _walltime.gmtime()),
        "box": box or platform.node(),
        "sha": sha or repo_git_sha() or "unknown",
        "row": name,
        "cols": _flatten_cols(cols),
    }
    with open(path, "a") as f:
        f.write(json.dumps(rec, sort_keys=True) + "\n")
    return rec


def append_bench_rows(rows: Dict[str, Dict],
                      path: Optional[str] = None) -> int:
    """Bench-side helper: append every present row dict under its name.
    Never raises — a broken ledger must not fail a bench that already
    measured everything (the error lands on stderr instead)."""
    import sys

    path = path or default_history_path()
    sha = repo_git_sha() or "unknown"
    n = 0
    for name, row in rows.items():
        if not isinstance(row, dict):
            continue
        try:
            append_row(path, name, row, sha=sha)
            n += 1
        except OSError as e:
            print(f"bench history append failed for {name}: {e}",
                  file=sys.stderr)
    return n


def load_history(path: str) -> List[Dict]:
    """Parse the ledger back (skips blank lines; a malformed line raises
    — the ledger is append-only JSON lines, corruption must be loud)."""
    out: List[Dict] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
