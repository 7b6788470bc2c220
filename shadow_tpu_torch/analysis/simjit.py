"""simjit: the port's build-and-sync surface analysis.

The JAX package's simjit proves its compile surface (jit identities,
retracing, donation, compile keys).  The port launches hand-written CUDA
kernels bound through ``ops/_build.py`` instead; this simjit keeps the
rule ids, the pragma vocabulary and the CLI, and checks what the port has
(jit_rules.py holds the model and the catalog):

=======  ========  ====================================================
SIM301   n/a       XLA retracing: not in the port (listed, runs nothing)
SIM302   error     implicit host<->device sync inside the dispatch
                   window (``[tool.simjit] sync`` modules)
SIM303   error     float promotion of a sim-time lane in kernel-tagged
                   files, Python and CUDA (``[tool.simjit] kernel``)
SIM304   n/a       XLA buffer donation: not in the port
SIM305   error     build-budget drift (kernel entries bound per module,
                   ``_build.KERNELS``) against ``[tool.simjit.budget]``
=======  ========  ====================================================

Usage::

    python -m shadow_tpu_torch.analysis.simjit [paths...] [--json]
        [--list-rules] [--config pyproject.toml] [--diff BASE]
        [--sync-sites]

Exit status: 0 = no unsuppressed findings, 1 = findings, 2 = usage error.

The settings are the port's (settings.py: the repository's pyproject.toml
re-pointed at ``shadow_tpu_torch/`` with ``analysis/port.toml`` merged
over it): ``[tool.simjit] kernel`` (SIM303's files, the CUDA sources
among them), ``[tool.simjit] sync`` (SIM302's modules), the allowlists of
``[tool.simjit.allow]`` unioned with ``[tool.simlint.allow]``, and the
build budget of ``[tool.simjit.budget]``, whose dotted runtime keys
``simfleet smoke`` cross-checks (fleet/cli.py reads them).  Pragmas are the family's:
``# simjit: disable=SIM302 -- <why>`` in Python, ``// simjit:
disable=SIM303 -- <why>`` in CUDA, stale or reasonless ones a SIM000
finding.  ``--sync-sites`` prints, as JSON, every synchronizing call the
static pass knows as designed (jit_rules.sync_inventory): the list the
card's runtime sync audit holds the observed syncs to.
"""

from __future__ import annotations

import argparse
import fnmatch
import json
import os
import re
import sys
from dataclasses import asdict
from typing import Dict, List, Optional, Set, Tuple

from . import cuspec, jit_rules
from .simlint import (Config, Finding, LintResult, ModuleContext,
                      _toml_section, apply_pragmas, changed_py_files,
                      iter_py_files, load_config)

# SIM303's and SIM302's defaults where the settings name none
DEFAULT_KERNEL = [
    "shadow_tpu_torch/ops/*.py",
    "shadow_tpu_torch/parallel/mesh/*.py",
    "shadow_tpu_torch/fleet/plane.py",
    "shadow_tpu_torch/ops/csrc/*.cu",
    "shadow_tpu_torch/ops/csrc/*.cuh",
]
DEFAULT_SYNC = [
    "shadow_tpu_torch/parallel/device_plane.py",
    "shadow_tpu_torch/parallel/tpu_policy.py",
    "shadow_tpu_torch/ops/round_step.py",
    "shadow_tpu_torch/fleet/plane.py",
    "shadow_tpu_torch/parallel/mesh/meshplane.py",
]

# quoted-key scalar lines inside [tool.simjit.budget]:  "path" = 3
_BUDGET_LINE_RE = re.compile(r'^"((?:[^"\\]|\\.)+)"\s*=\s*(\d+)\s*(?:#.*)?$')


def parse_budget(text: str) -> Dict[str, int]:
    """The ``[tool.simjit.budget]`` table from a settings document (quoted
    path keys mapping to integers)."""
    out: Dict[str, int] = {}
    in_section = False
    for raw in text.splitlines():
        line = raw.strip()
        if line.startswith("["):
            in_section = line == "[tool.simjit.budget]"
            continue
        if not in_section or not line or line.startswith("#"):
            continue
        m = _BUDGET_LINE_RE.match(line)
        if m:
            out[m.group(1)] = int(m.group(2))
    return out


def load_jit_config(path: Optional[str], start: Optional[str] = None,
                    port: bool = True
                    ) -> Tuple[Config, Dict[str, int], List[str], List[str]]:
    """(shared Config with [tool.simjit.allow] unioned in, budget table,
    kernel globs, sync globs), from the port's settings (``port``) or the
    file as written."""
    config = load_config(path, start=start, port=port)
    text = getattr(config, "text", "")
    top = _toml_section(text, "tool.simjit")
    for rule_id, pats in _toml_section(text, "tool.simjit.allow").items():
        config.allow.setdefault(rule_id.upper(), []).extend(pats)
    return (config, parse_budget(text),
            top.get("kernel", list(DEFAULT_KERNEL)),
            top.get("sync", list(DEFAULT_SYNC)))


def default_rules() -> List[jit_rules.JitRule]:
    return list(jit_rules.CATALOG)


def active_ids(rules: Optional[List] = None) -> Set[str]:
    return {r.id for r in (rules or default_rules())} | {"SIM000"}


def _apply_c_pragmas(path: str, source: str, findings: List[Finding],
                     ids: Set[str]) -> List[Finding]:
    """``//`` pragmas of a CUDA source, with the Python path's semantics:
    a reason is required, a pragma that suppresses nothing is stale."""
    from .simlint import known_rule_ids
    pragmas, malformed = cuspec.collect_c_pragmas(source, known_rule_ids())
    bad = [Finding("SIM000", "error", path, ln, col, msg)
           for ln, col, msg in malformed]
    pragmas = [p for p in pragmas if p.rule in ids]
    index = {(p.target, p.rule): p for p in pragmas}
    for f in findings:
        p = index.get((f.line, f.rule))
        if p is not None:
            f.suppressed, f.reason = True, p.reason
            p.used = True
    for p in pragmas:
        if not p.used:
            bad.append(Finding(
                "SIM000", "error", path, p.line, p.col,
                f"suppression pragma for {p.rule} matched no finding — "
                "remove the stale pragma (or fix its rule id)"))
    return sorted(findings + bad, key=Finding.sort_key)


def jit_contexts(contexts: List[ModuleContext],
                 config: Optional[Config] = None,
                 rules: Optional[List] = None,
                 budget: Optional[Dict[str, int]] = None,
                 kernel: Optional[List[str]] = None,
                 sync: Optional[List[str]] = None,
                 cuda: Optional[Dict[str, str]] = None,
                 package: Optional[list] = None) -> List[Finding]:
    """Run the passes over parsed modules (and CUDA sources) and apply the
    pragma / allowlist machinery.  ``package``, when a list, receives the
    TorchPackage built (for :func:`jit_rules.sync_inventory`)."""
    config = config or Config()
    rules = rules if rules is not None else default_rules()
    cuda = cuda or {}
    pkg = jit_rules.TorchPackage(
        contexts, config, budget=budget,
        kernel=kernel if kernel is not None else DEFAULT_KERNEL,
        sync=sync if sync is not None else DEFAULT_SYNC, cuda=cuda)
    if package is not None:
        package.append(pkg)
    per_file: Dict[str, List[Finding]] = {c.relpath: [] for c in contexts}
    per_file.update({rel: [] for rel in cuda})
    loose: List[Finding] = []
    for rule in rules:
        for f in rule.run(pkg):
            if config.is_allowed(f.rule, f.path):
                continue
            if f.path in per_file:
                per_file[f.path].append(f)
            else:
                loose.append(f)          # the budget file's anchor
    out: List[Finding] = list(loose)
    ids = {r.id for r in rules} | {"SIM000"}
    for ctx in contexts:
        out.extend(apply_pragmas(ctx, per_file.get(ctx.relpath, []), ids))
    for rel, text in sorted(cuda.items()):
        out.extend(_apply_c_pragmas(rel, text, per_file[rel], ids))
    return sorted(out, key=Finding.sort_key)


def jit_sources(sources: Dict[str, str],
                config: Optional[Config] = None,
                rules: Optional[List] = None,
                budget: Optional[Dict[str, int]] = None,
                kernel: Optional[List[str]] = None,
                sync: Optional[List[str]] = None) -> List[Finding]:
    """Analyze in-memory sources ({relpath: text}; ``.cu``/``.cuh`` ones
    as CUDA) — the test-fixture entry point."""
    contexts: List[ModuleContext] = []
    bad: List[Finding] = []
    cuda = {rel: src for rel, src in sources.items()
            if rel.endswith(cuspec.CUDA_EXTS)}
    for rel, src in sorted(sources.items()):
        if rel in cuda:
            continue
        try:
            contexts.append(ModuleContext(rel, src))
        except SyntaxError as e:
            bad.append(Finding("SIM000", "error", rel, e.lineno or 1,
                               (e.offset or 1) - 1,
                               f"file does not parse: {e.msg}"))
    return sorted(jit_contexts(contexts, config, rules, budget, kernel,
                               sync, cuda) + bad, key=Finding.sort_key)


def _cuda_files(paths: List[str], config: Config, kernel: List[str]
                ) -> List[Tuple[str, str]]:
    """[(abspath, relpath)] of the kernel-tagged CUDA sources under
    ``paths``."""
    out = []
    for p in paths:
        p = os.path.abspath(p)
        if os.path.isfile(p):
            files = [p]
        else:
            files = [os.path.join(d, fn) for d, _dirs, fns in os.walk(p)
                     for fn in fns]
        for fp in files:
            if not fp.endswith(cuspec.CUDA_EXTS):
                continue
            rel = os.path.relpath(fp, config.root).replace(os.sep, "/")
            if any(fnmatch.fnmatch(rel, k) for k in kernel) and \
                    not config.is_excluded(rel):
                out.append((fp, rel))
    return sorted(set(out))


def jit_paths(paths: List[str], config: Optional[Config] = None,
              rules: Optional[List] = None,
              only: Optional[Set[str]] = None,
              budget: Optional[Dict[str, int]] = None,
              kernel: Optional[List[str]] = None,
              sync: Optional[List[str]] = None,
              package: Optional[list] = None) -> LintResult:
    """Analyze every .py under ``paths`` as one package, with the
    kernel-tagged CUDA sources among them.  ``only`` restricts REPORTING
    to the given relpaths.  Settings left None are loaded from the
    nearest pyproject (the port's view of it)."""
    if config is None or budget is None or kernel is None or sync is None:
        lc, lb, lk, ls = load_jit_config(None,
                                         start=paths[0] if paths else ".")
        config = config if config is not None else lc
        budget = budget if budget is not None else lb
        kernel = kernel if kernel is not None else lk
        sync = sync if sync is not None else ls
    files = iter_py_files(paths, config)
    contexts: List[ModuleContext] = []
    findings: List[Finding] = []
    for abspath, rel in files:
        try:
            with open(abspath, encoding="utf-8") as f:
                source = f.read()
        except (OSError, UnicodeDecodeError) as e:
            findings.append(Finding("SIM000", "error", rel, 1, 0,
                                    f"file is unreadable: {e}"))
            continue
        try:
            contexts.append(ModuleContext(rel, source))
        except SyntaxError as e:
            findings.append(Finding("SIM000", "error", rel, e.lineno or 1,
                                    (e.offset or 1) - 1,
                                    f"file does not parse: {e.msg}"))
    cuda: Dict[str, str] = {}
    for abspath, rel in _cuda_files(paths, config, kernel):
        try:
            with open(abspath, encoding="utf-8") as f:
                text = f.read()
            cuspec.extract(rel, text)      # a file that does not parse
        except (OSError, UnicodeDecodeError) as e:
            findings.append(Finding("SIM000", "error", rel, 1, 0,
                                    f"file is unreadable: {e}"))
            continue
        except cuspec.CudaParseError as e:
            findings.append(Finding("SIM000", "error", rel, e.line, 0,
                                    f"file does not parse: {e.msg}"))
            continue
        cuda[rel] = text
    findings.extend(jit_contexts(contexts, config, rules, budget, kernel,
                                 sync, cuda, package))
    if only is not None:
        findings = [f for f in findings if f.path in only]
    findings.sort(key=Finding.sort_key)
    return LintResult(findings, len(files) + len(cuda), tool="simjit")


def sync_sites(paths: List[str], config_path: Optional[str] = None
               ) -> List[dict]:
    """The designed sync sites of the sync-audited modules under ``paths``
    (jit_rules.sync_inventory over a full analysis), as dicts."""
    config, budget, kernel, sync = load_jit_config(
        config_path, start=paths[0] if paths else ".")
    pkg: list = []
    result = jit_paths(paths, config, budget=budget, kernel=kernel,
                       sync=sync, package=pkg)
    return [asdict(s) for s in jit_rules.sync_inventory(pkg[0],
                                                        result.findings)]


# ---------------------------------------------------------------------------
# CLI


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="simjit",
        description="build-and-sync surface static analysis "
                    "(shadow-tpu's PyTorch/CUDA port)")
    ap.add_argument("paths", nargs="*", default=None,
                    help="files or directories (default: shadow_tpu_torch/)")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable JSON on stdout")
    ap.add_argument("--config", default=None,
                    help="pyproject.toml carrying [tool.simjit] "
                         "(default: nearest to the first path)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    ap.add_argument("--diff", metavar="BASE", default=None,
                    help="report only findings in files changed since git "
                         "ref BASE (analysis stays package-wide)")
    ap.add_argument("--sync-sites", action="store_true",
                    help="print the designed sync sites as JSON and exit")
    args = ap.parse_args(argv)
    rules = default_rules()
    if args.list_rules:
        for r in rules:
            sev = r.severity if r.applicable else "n/a"
            print(f"{r.id}  {sev:<7}  {r.short}")
        return 0
    paths = args.paths or ["shadow_tpu_torch"]
    missing = [p for p in paths if not os.path.exists(p)]
    if missing:
        print(f"simjit: no such path: {', '.join(missing)}",
              file=sys.stderr)
        return 2
    if args.sync_sites:
        json.dump(sync_sites(paths, args.config), sys.stdout, indent=2)
        print()
        return 0
    config, budget, kernel, sync = load_jit_config(args.config,
                                                   start=paths[0])
    only = None
    if args.diff is not None:
        try:
            only = changed_py_files(args.diff, config.root,
                                    exts=(".py",) + cuspec.CUDA_EXTS)
        except RuntimeError as e:
            print(f"simjit: --diff {args.diff}: {e}", file=sys.stderr)
            return 2
    result = jit_paths(paths, config, rules, only=only, budget=budget,
                       kernel=kernel, sync=sync)
    if args.json:
        json.dump(result.to_json(), sys.stdout, indent=2, sort_keys=True)
        print()
    else:
        for f in result.unsuppressed:
            print(f.render())
        print(f"simjit: {len(result.unsuppressed)} finding(s), "
              f"{len(result.suppressed)} suppressed, "
              f"{result.files} file(s)")
    return 1 if result.unsuppressed else 0


if __name__ == "__main__":
    sys.exit(main())
