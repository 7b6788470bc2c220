"""A copy of the benchmark (``BENCHMARK.json`` and ``portbench/``) in a
temporary directory, its networks cut to a size the CPU runs in seconds,
and a way to run a cell there in-process or as its own process."""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
from typing import Dict, List, Optional

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def tiny_copy(dest: str) -> str:
    """The benchmark under ``dest`` (an existing directory), cut by
    :func:`cut`; returns ``dest``."""
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), dest)
    shutil.copytree(os.path.join(REPO, "portbench"),
                    os.path.join(dest, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return cut(dest)


def cut(root: str) -> str:
    """Each cell's configuration and mix under ``root`` cut to a size the
    CPU runs in seconds: the keys of the ``TINY_CONFIG`` and
    ``TINY_TRAFFIC`` of the configuration's scenario overwritten; returns
    ``root``."""
    from portbench import cell
    b = bench(root)
    with contextlib.chdir(root):
        for w in b["workloads"]:
            config = cell.config_file(b, w["config"])
            sc = cell.scenario(config)
            entry = next(c for c in b["configs"] if c["name"] == w["config"])
            for path, tiny in ((entry["file"], sc.TINY_CONFIG),
                               (os.path.join("portbench", "traffic",
                                             f"{w['traffic']}.json"),
                                sc.TINY_TRAFFIC)):
                with open(path) as f:
                    data = json.load(f)
                data.update(tiny)
                with open(path, "w") as f:
                    json.dump(data, f, indent=1)
    return root


def bench(root: str) -> Dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def run_cli(root: str, workload: str, seed: int = 3_000_000_019,
            seconds: float = 0.5, extra: Optional[List[str]] = None,
            device: str = "cpu"):
    """The cell run from its command line, as its own process from ``root``
    (on ``device``): (exit code, the result line or None where standard
    output ends in none, stderr)."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "portbench", "--workload", workload,
         "--seed", str(seed), "--seconds", str(seconds), "--trace", "0",
         "--device", device, *(extra or [])],
        cwd=root, env=env, capture_output=True, text=True, timeout=600)
    lines = proc.stdout.strip().splitlines()
    result = json.loads(lines[-1]) if lines and lines[-1].startswith("{") \
        else None
    return proc.returncode, result, proc.stderr


def run_inprocess(root: str, workload: str, seed: int = 3_000_000_019,
                  seconds: float = 0.5, extra: Optional[List[str]] = None):
    """The cell run in this process from ``root`` (so a test may patch the
    program underneath): (exit code, the result line or None)."""
    import time
    from portbench.run import main
    out = io.StringIO()
    with contextlib.chdir(root), contextlib.redirect_stdout(out):
        rc = main(["--workload", workload, "--seed", str(seed),
                   "--seconds", str(seconds), "--device", "cpu",
                   *(extra or [])], time.monotonic())
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if rc == 0 and lines else None)
