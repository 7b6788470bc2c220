"""The port's analyzer settings: the repository's, re-pointed at the port,
with the port's own supplement merged over them.

The repository's ``pyproject.toml`` names the JAX package's paths in its
analyzer sections (``[tool.simlint]``, ``[tool.simlint.allow]``,
``[tool.simjit]``, ``[tool.simjit.allow]``, ``[tool.simjit.budget]``,
``[tool.simtwin.map]``).  The port's tools read those sections, turn every
``shadow_tpu/`` in them into ``shadow_tpu_torch/`` (keys and values), and
merge ``port.toml`` (beside this file) over the result:

* ``[tool.simtwin.rename]``: ``name = ["entry as re-pointed", "entry in
  the port"]``, a twin symbol the port spells otherwise.  Renaming an entry
  that a repository's map does not hold is an error, so a stale rename
  shows;
* ``[tool.simjit.budget]``: the port's build budget.  Its module keys
  replace the repository's (those count jit programs, which the port does
  not have); the repository's dotted runtime keys stay unless the
  supplement names them;
* every other array (``[tool.simtwin.map]`` surfaces, ``[tool.simjit]``
  globs, allowlists) is appended to the array of the same name, and any
  other value replaces it.

A map change on the JAX side so reaches the port without a copy.  The
merged view is written back as a TOML document in the subset the tools'
own readers parse (``simlint._toml_section``, ``simjit.parse_budget``), so
every tool reads its sections from it exactly as from a pyproject.toml.
"""

from __future__ import annotations

import json
import os
import re
import tomllib
from dataclasses import dataclass
from typing import Dict, List

from .simlint import Config

SUPPLEMENT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "port.toml")
REF_PREFIX, PORT_PREFIX = "shadow_tpu/", "shadow_tpu_torch/"
TOOLS = ("simlint", "simjit", "simtwin")
RENAME = "tool.simtwin.rename"
BUDGET = "tool.simjit.budget"
_BARE_KEY = re.compile(r"^[A-Za-z0-9_-]+$")


def _tables(doc: Dict) -> Dict[str, Dict]:
    """``{"tool.simlint.allow": {...}, ...}``: every analyzer table of a
    parsed document, nested tables flattened to dotted names."""
    out: Dict[str, Dict] = {}

    def walk(name: str, table: Dict) -> None:
        leaves = {k: v for k, v in table.items() if not isinstance(v, dict)}
        out[name] = leaves
        for k, v in table.items():
            if isinstance(v, dict):
                walk(f"{name}.{k}", v)

    for tool in TOOLS:
        table = doc.get("tool", {}).get(tool)
        if isinstance(table, dict):
            walk(f"tool.{tool}", table)
    return out


def _repoint(value):
    if isinstance(value, str):
        return value.replace(REF_PREFIX, PORT_PREFIX)
    if isinstance(value, list):
        return [_repoint(v) for v in value]
    return value


def merge(text: str, supplement: str) -> Dict[str, Dict]:
    """The port's tables from the repository's settings document and the
    supplement's (both TOML text)."""
    tables = {name: {_repoint(k): _repoint(v) for k, v in table.items()}
              for name, table in _tables(tomllib.loads(text)).items()}
    sup = _tables(tomllib.loads(supplement))
    has_map = "tool.simtwin.map" in tables
    surface_map = tables.setdefault("tool.simtwin.map", {})
    for name, pair in sorted(sup.pop(RENAME, {}).items()):
        old, new = pair
        hits = [s for s, entries in surface_map.items() if old in entries]
        if not hits and has_map:
            raise ValueError(f"port.toml [{RENAME}] {name}: the repository's "
                             f"map holds no entry {old!r}")
        for s in hits:
            surface_map[s] = [new if e == old else e
                              for e in surface_map[s]]
    runtime = {k: v for k, v in tables.get(BUDGET, {}).items()
               if not k.endswith(".py")}
    tables[BUDGET] = {**runtime, **sup.pop(BUDGET, {})}
    for name, table in sup.items():
        into = tables.setdefault(name, {})
        for key, value in table.items():
            if isinstance(value, list) and isinstance(into.get(key), list):
                into[key] = into[key] + [v for v in value
                                         if v not in into[key]]
            else:
                into[key] = value
    return tables


def dump(tables: Dict[str, Dict]) -> str:
    """``tables`` as TOML, one ``key = value`` line each (arrays of
    strings and integers only: what the analyzers' settings hold)."""
    lines: List[str] = []
    for name, table in tables.items():
        lines.append(f"[{name}]")
        for key, value in table.items():
            k = key if _BARE_KEY.match(key) else json.dumps(key)
            v = ("[" + ", ".join(json.dumps(x) for x in value) + "]"
                 if isinstance(value, list) else json.dumps(value))
            lines.append(f"{k} = {v}")
        lines.append("")
    return "\n".join(lines)


def port_settings(text: str) -> str:
    """The settings document the port's tools read, from the text of the
    repository's pyproject.toml."""
    with open(SUPPLEMENT, encoding="utf-8") as f:
        supplement = f.read()
    return dump(merge(text, supplement))


@dataclass
class PortConfig(Config):
    """The shared :class:`~.simlint.Config` and the settings document it
    came from, in which each tool finds its own sections."""
    text: str = ""
