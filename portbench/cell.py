"""Finding a cell's pieces by name, from the root of a checkout: its entry
in ``BENCHMARK.json``, its configuration file, the scenario that file
names (``portbench/scenarios/<name>.py``; see that package for what a
scenario provides), its traffic mix (``portbench/traffic/<name>.json``)
and the reader of each metric (``portbench/metrics/<name>.py``, a
``read(ctx)`` that returns a number, or None where it finds nothing to
read)."""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Callable, Dict, List

DIR = "portbench"
# the scenario of a configuration file that names none: the files written
# before scenarios were found by name are all of it
DEFAULT_SCENARIO = "tor"


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


def _module(kind: str, name: str):
    path = os.path.join(DIR, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench.{kind}.{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def scenario(config: Dict):
    """The scenario module the configuration names."""
    name = config.get("scenario", DEFAULT_SCENARIO)
    d = os.path.join(DIR, "scenarios")
    if not os.path.isfile(os.path.join(d, f"{name}.py")):
        have = sorted(f[:-3] for f in os.listdir(d)
                      if f.endswith(".py") and f != "__init__.py")
        raise SystemExit(f"portbench: no scenario {name!r} "
                         f"(portbench/scenarios/<name>.py; have "
                         f"{', '.join(have)})")
    return _module("scenarios", name)


def reader(name: str) -> Callable[[Dict], object]:
    return _module("metrics", name).read
