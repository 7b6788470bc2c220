"""Finding a cell's pieces by name, from the root of a checkout: its entry
in ``BENCHMARK.json``, its configuration file, its traffic mix
(``portbench/traffic/<name>.json``) and the reader of each metric
(``portbench/metrics/<name>.py``, a ``read(ctx)`` that returns a number,
or None where it finds nothing to read)."""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Callable, Dict, List

DIR = "portbench"


def load_benchmark(path: str = "BENCHMARK.json") -> Dict:
    with open(path) as f:
        return json.load(f)


def workload(bench: Dict, name: str) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"portbench: no workload {name!r} in BENCHMARK.json "
                     f"(have {', '.join(w['name'] for w in bench['workloads'])})")


def config_file(bench: Dict, name: str) -> Dict:
    entry = next(c for c in bench["configs"] if c["name"] == name)
    with open(entry["file"]) as f:
        return json.load(f)


def traffic_file(name: str) -> Dict:
    with open(os.path.join(DIR, "traffic", f"{name}.json")) as f:
        return json.load(f)


def metrics_for(bench: Dict, cell: Dict, kind: str) -> List[Dict]:
    """The cell's metrics of ``kind`` (end_to_end or per_layer): those that
    list it, or list no cells at all."""
    return [m for m in bench[kind]
            if cell["name"] in m.get("workloads", [cell["name"]])]


def reader(name: str) -> Callable[[Dict], object]:
    path = os.path.join(DIR, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
