"""simrace: whole-package concurrency & shard-protocol static analysis.

Where simlint proves per-file determinism contracts, simrace analyzes the
PACKAGE: it parses every module, builds the concurrency model
(race_rules.PackageContext — lock identities, lock regions, thread
targets, same-module call graphs) and runs the SIM1xx catalog over it:

=======  ========  ====================================================
SIM101   error     lock-order inversion anywhere in the package
SIM102   error     thread-shared state mutated/read without one lock
SIM103   warning   blocking call while holding a lock
SIM110   error     shard-protocol drift (tag/arity/ordering — see
                   protocol.py for the state-machine construction)
=======  ========  ====================================================

Usage::

    python -m shadow_tpu_torch.analysis.simrace [paths...] [--json]
        [--list-rules] [--config pyproject.toml] [--diff BASE]

Exit status: 0 = no unsuppressed findings, 1 = findings, 2 = usage error.

Everything else is shared with simlint: the severity model, the
``# simlint: disable=SIMxxx -- <why>`` pragma syntax (one pragma
vocabulary for both tools; each judges staleness only for the rules it
runs), the ``[tool.simlint.allow]`` per-rule path allowlists, and the
JSON schema (``"tool": "simrace"``).  ``--diff BASE`` still analyzes the
WHOLE package (the rules are cross-module — a lock edge added in an
untouched file can complete an inversion) but reports only findings in
files changed since the git ref, which is what an incremental CI lane
wants.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Optional, Set

from . import race_rules
from .simlint import (Config, Finding, LintResult, ModuleContext,
                      apply_pragmas, changed_py_files, iter_py_files,
                      load_config)


def default_rules() -> List[race_rules.PackageRule]:
    return list(race_rules.CATALOG)


def active_ids(rules: Optional[List] = None) -> Set[str]:
    return {r.id for r in (rules or default_rules())} | {"SIM000"}


def race_contexts(contexts: List[ModuleContext],
                  config: Optional[Config] = None,
                  rules: Optional[List] = None) -> List[Finding]:
    """Run the package passes over parsed modules and apply pragma /
    allowlist machinery — the core shared by the CLI and the fixtures."""
    config = config or Config()
    rules = rules if rules is not None else default_rules()
    pkg = race_rules.PackageContext(contexts, config)
    per_module: Dict[str, List[Finding]] = {c.relpath: [] for c in contexts}
    for rule in rules:
        for f in rule.run(pkg):
            if not config.is_allowed(f.rule, f.path):
                per_module.setdefault(f.path, []).append(f)
    out: List[Finding] = []
    ids = {r.id for r in rules} | {"SIM000"}
    for ctx in contexts:
        out.extend(apply_pragmas(ctx, per_module.get(ctx.relpath, []), ids))
    return sorted(out, key=Finding.sort_key)


def race_sources(sources: Dict[str, str],
                 config: Optional[Config] = None,
                 rules: Optional[List] = None) -> List[Finding]:
    """Analyze in-memory modules ({relpath: source}) — the test-fixture
    entry point (the package analog of simlint.lint_source)."""
    contexts: List[ModuleContext] = []
    bad: List[Finding] = []
    for rel, src in sorted(sources.items()):
        try:
            contexts.append(ModuleContext(rel, src))
        except SyntaxError as e:
            bad.append(Finding("SIM000", "error", rel, e.lineno or 1,
                               (e.offset or 1) - 1,
                               f"file does not parse: {e.msg}"))
    return sorted(race_contexts(contexts, config, rules) + bad,
                  key=Finding.sort_key)


def race_paths(paths: List[str], config: Optional[Config] = None,
               rules: Optional[List] = None,
               only: Optional[Set[str]] = None) -> LintResult:
    """Analyze every .py under ``paths`` as one package.  ``only``
    restricts REPORTING (not analysis — the model is cross-module) to
    the given relpaths, the ``--diff BASE`` mode."""
    config = config or load_config(None, start=paths[0] if paths else ".")
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
    findings.extend(race_contexts(contexts, config, rules))
    if only is not None:
        findings = [f for f in findings if f.path in only]
    findings.sort(key=Finding.sort_key)
    return LintResult(findings, len(files), tool="simrace")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="simrace",
        description="concurrency & shard-protocol static analysis "
                    "(shadow-tpu)")
    ap.add_argument("paths", nargs="*", default=None,
                    help="files or directories (default: shadow_tpu_torch/)")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable JSON on stdout")
    ap.add_argument("--config", default=None,
                    help="pyproject.toml carrying [tool.simlint] "
                         "(default: nearest to the first path)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    ap.add_argument("--diff", metavar="BASE", default=None,
                    help="report only findings in .py files changed "
                         "since git ref BASE (analysis stays package-"
                         "wide)")
    args = ap.parse_args(argv)
    rules = default_rules()
    if args.list_rules:
        for r in rules:
            print(f"{r.id}  {r.severity:<7}  {r.short}")
        return 0
    paths = args.paths or ["shadow_tpu_torch"]
    missing = [p for p in paths if not os.path.exists(p)]
    if missing:
        print(f"simrace: no such path: {', '.join(missing)}",
              file=sys.stderr)
        return 2
    config = load_config(args.config, start=paths[0])
    only = None
    if args.diff is not None:
        try:
            only = changed_py_files(args.diff, config.root)
        except RuntimeError as e:
            print(f"simrace: --diff {args.diff}: {e}", file=sys.stderr)
            return 2
    result = race_paths(paths, config, rules, only=only)
    if args.json:
        json.dump(result.to_json(), sys.stdout, indent=2, sort_keys=True)
        print()
    else:
        for f in result.unsuppressed:
            print(f.render())
        print(f"simrace: {len(result.unsuppressed)} finding(s), "
              f"{len(result.suppressed)} suppressed, "
              f"{result.files} file(s)")
    return 1 if result.unsuppressed else 0


if __name__ == "__main__":
    sys.exit(main())
