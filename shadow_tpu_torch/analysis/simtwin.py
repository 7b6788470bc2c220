"""simtwin: cross-plane protocol-equivalence static analysis.

The simulator's protocol logic exists three times: the Python modules
(authoritative), the hand-transcribed native C data plane, and the kernel
family — in the port the torch modules of ``ops/`` and the CUDA C++ of
``ops/csrc/`` (read by cuspec).  Runtime digest tests keep them honest —
hours into a run.  simtwin fails the drift at LINT time instead: three
extractors (Python AST, cspec's regex+brace C reader, the kernel dtype
pass) feed one table-driven IR, and the SIM2xx rules diff the planes:

=======  ========  ====================================================
SIM201   error     protocol constant / threshold drift between twins
SIM202   error     TCP state-transition table drift
SIM203   error     twin missing a mapped counterpart surface
                   ([tool.simtwin.map] in pyproject.toml)
SIM204   error     dtype/overflow hazard in a device kernel
SIM205   error     simgen-generated region hand-edited or stale
                   (vs spec/protocol_spec.json; see analysis/simgen.py)
=======  ========  ====================================================

Usage::

    python -m shadow_tpu_torch.analysis.simtwin [paths...] [--json]
        [--list-rules] [--config pyproject.toml] [--diff BASE]
        [--emit-spec [PATH]]

Exit status: 0 = no unsuppressed findings, 1 = findings, 2 = usage error.

Everything else is shared with simlint/simrace: severity model, JSON
schema (``"tool": "simtwin"``), ``[tool.simlint.allow]`` allowlists, and
the pragma vocabulary — ``# simtwin: disable=SIM2xx -- <why>`` in Python
files, ``// simtwin: disable=SIM2xx -- <why>`` in C files (the
``simlint:`` spelling works too; each tool judges staleness only for the
rules it runs, so a SIM2xx pragma is never "stale" to simlint or simrace
and vice versa).  ``--diff BASE`` keeps the ANALYSIS whole-model (a
constant changed in an untouched twin still has to agree with the edited
one) and filters only the report, exactly like simrace.

The port's settings are the repository's, re-pointed at
``shadow_tpu_torch/`` with ``analysis/port.toml`` merged over them
(settings.py): the renamed twin symbols and the ``.cu``/``.cuh`` entries
of the kernel plane live there.

``--emit-spec`` serializes the extracted IR (by default to
``shadow_tpu_torch/analysis/protocol.json``; the JAX package's
``spec/protocol.json`` is its own) — byte-stable across regeneration and PYTHONHASHSEED values
(everything sorted, no ids, no timestamps).  Since the simgen cut-over
the AUTHORITATIVE table is ``spec/protocol_spec.json`` (the planes are
generated from it; `make gen`); the extracted IR is the read-back
artifact that proves the generated planes still mean what the spec says.
``--emit-spec`` refuses to clobber uncommitted hand edits to the target
(they belong in the authoritative spec) unless ``--force``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Optional, Set

from . import twin_rules
from .simlint import (Config, Finding, LintResult, _toml_section,
                      apply_pragmas, changed_py_files, load_config)
from .twin_rules import CATALOG, MapEntry, TwinModel, build_spec, parse_map

TWIN_EXTS = (".py", ".cc", ".cpp", ".h", ".cu", ".cuh")
# --emit-spec's default target, under the config root: inside the port
SPEC_OUT = os.path.join("shadow_tpu_torch", "analysis", "protocol.json")


def default_rules() -> List[twin_rules.TwinRule]:
    return list(CATALOG)


def active_ids(rules: Optional[List] = None) -> Set[str]:
    return {r.id for r in (rules or default_rules())} | {"SIM000"}


def load_map(config_path: Optional[str], config: Config
             ) -> Dict[str, List[MapEntry]]:
    """[tool.simtwin.map] from the settings the Config came from (the
    port's view of the repository's map, settings.py), or from
    ``config_path`` read the same way."""
    if config_path is not None:
        config = load_config(config_path)
    return parse_map(_toml_section(getattr(config, "text", ""),
                                   "tool.simtwin.map"))


def _apply_c_pragmas(path: str, source: str, findings: List[Finding],
                     ids: Set[str]) -> List[Finding]:
    """C-file counterpart of simlint.apply_pragmas: // pragma comments,
    reason required, rule-scoped ownership, stale pragma = SIM000."""
    pragmas, malformed = cspec_pragmas(source)
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


def cspec_pragmas(source: str):
    from . import cuspec
    from .simlint import known_rule_ids
    return cuspec.collect_c_pragmas(source, known_rule_ids())


def twin_sources(sources: Dict[str, str],
                 config: Optional[Config] = None,
                 surface_map: Optional[Dict[str, List[MapEntry]]] = None,
                 rules: Optional[List] = None) -> List[Finding]:
    """Analyze in-memory planes ({relpath: source}) — the fixture entry
    point (the cross-plane analog of simlint.lint_source)."""
    config = config or Config()
    rules = rules if rules is not None else default_rules()
    surface_map = surface_map or {}
    twin = TwinModel(sources, surface_map)
    per_file: Dict[str, List[Finding]] = {}
    for rule in rules:
        for f in rule.run(twin):
            if not config.is_allowed(f.rule, f.path):
                per_file.setdefault(f.path, []).append(f)
    ids = {r.id for r in rules} | {"SIM000"}
    out: List[Finding] = list(twin.parse_errors)
    handled: Set[str] = set()
    for rel, ctx in twin.py_ctx.items():
        out.extend(apply_pragmas(ctx, per_file.get(rel, []), ids))
        handled.add(rel)
    for rel in twin.c_extracts:
        out.extend(_apply_c_pragmas(rel, sources[rel],
                                    per_file.get(rel, []), ids))
        handled.add(rel)
    for rel, fs in per_file.items():        # e.g. pyproject-anchored SIM203
        if rel not in handled:
            out.extend(fs)
    return sorted(out, key=Finding.sort_key)


def _load_mapped_sources(config: Config,
                         surface_map: Dict[str, List[MapEntry]]
                         ) -> Dict[str, str]:
    sources: Dict[str, str] = {}
    for entries in surface_map.values():
        for e in entries:
            if e.path in sources:
                continue
            abspath = os.path.join(config.root, e.path)
            try:
                with open(abspath, encoding="utf-8") as f:
                    sources[e.path] = f.read()
            except (OSError, UnicodeDecodeError):
                pass                  # SurfaceMapRule reports the absence
    return sources


def twin_paths(paths: List[str], config: Optional[Config] = None,
               surface_map: Optional[Dict[str, List[MapEntry]]] = None,
               rules: Optional[List] = None,
               only: Optional[Set[str]] = None) -> LintResult:
    """Analyze the mapped twin files under the config root.  ``paths``
    and ``only`` restrict REPORTING (the model is cross-plane: every
    mapped file participates in extraction regardless)."""
    config = config or load_config(None, start=paths[0] if paths else ".")
    if surface_map is None:
        surface_map = load_map(None, config)
    sources = _load_mapped_sources(config, surface_map)
    # the authoritative spec rides along (not a mapped plane): SIM205
    # judges generated-region staleness against its digest.  Read BINARY
    # and decode: a text-mode read would normalize \r\n and make this
    # digest disagree with simgen's raw-bytes spec= markers.
    from .genmark import SPEC_RELPATH
    try:
        with open(os.path.join(config.root, SPEC_RELPATH), "rb") as f:
            sources.setdefault(SPEC_RELPATH, f.read().decode("utf-8"))
    except (OSError, UnicodeDecodeError):
        pass
    findings = twin_sources(sources, config, surface_map, rules)

    scoped: Set[str] = set()
    for p in paths:
        rel = os.path.relpath(os.path.abspath(p), config.root)
        rel = rel.replace(os.sep, "/")
        prefix = "" if rel == "." else rel.rstrip("/") + "/"
        for rel_file in sources:
            if prefix == "" or rel_file.startswith(prefix) \
                    or rel_file == rel:
                scoped.add(rel_file)
    # pyproject-anchored findings (missing mapped file) always report
    scoped.add("pyproject.toml")
    findings = [f for f in findings if f.path in scoped]
    if only is not None:
        # pyproject-anchored findings (a map entry whose file is gone)
        # survive the --diff filter too: .toml never enters the changed
        # set, and a broken map must fail the incremental gate as well
        findings = [f for f in findings
                    if f.path in only or f.path == "pyproject.toml"]
    findings.sort(key=Finding.sort_key)
    n_files = len([s for s in sources if s in scoped])
    return LintResult(findings, n_files, tool="simtwin")


def spec_blob(config: Config,
              surface_map: Dict[str, List[MapEntry]]) -> bytes:
    """The exact bytes --emit-spec would write, without writing them."""
    sources = _load_mapped_sources(config, surface_map)
    twin = TwinModel(sources, surface_map)
    spec = build_spec(twin)
    return (json.dumps(spec, indent=2, sort_keys=True) + "\n").encode()


def emit_spec(out_path: str, config: Config,
              surface_map: Dict[str, List[MapEntry]],
              blob: Optional[bytes] = None) -> bytes:
    """Serialize the IR; returns the exact bytes written.  ``blob``
    lets a caller that already ran spec_blob (the overwrite guard)
    skip a second full extraction."""
    if blob is None:
        blob = spec_blob(config, surface_map)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "wb") as f:
        f.write(blob)
    return blob


def _uncommitted_edits(path: str, root: str) -> bool:
    """True when git sees uncommitted working-tree changes to ``path``.
    Not-a-repo / no-git / untracked-file all report False — the guard
    only protects edits that would be silently destroyed."""
    import subprocess
    try:
        run = subprocess.run(
            ["git", "-C", root, "status", "--porcelain", "--", path],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return False
    if run.returncode != 0:
        return False
    status = run.stdout.strip()[:2] if run.stdout.strip() else ""
    return bool(status) and status != "??"


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="simtwin",
        description="cross-plane protocol-equivalence static analysis "
                    "(shadow-tpu)")
    ap.add_argument("paths", nargs="*", default=None,
                    help="files or directories to report on "
                         "(default: shadow_tpu_torch/ native/)")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable JSON on stdout")
    ap.add_argument("--config", default=None,
                    help="pyproject.toml carrying [tool.simlint] + "
                         "[tool.simtwin.map]")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    ap.add_argument("--diff", metavar="BASE", default=None,
                    help="report only findings in files changed since git "
                         "ref BASE (analysis stays cross-plane)")
    ap.add_argument("--emit-spec", nargs="?", const="", default=None,
                    metavar="PATH",
                    help="write the extracted protocol IR to PATH "
                         f"(default: {SPEC_OUT} under the config root) "
                         "and exit")
    ap.add_argument("--force", action="store_true",
                    help="with --emit-spec: overwrite the target even if "
                         "it carries uncommitted hand edits (the spec is "
                         "authoritative; refused otherwise)")
    args = ap.parse_args(argv)
    rules = default_rules()
    if args.list_rules:
        for r in rules:
            print(f"{r.id}  {r.severity:<7}  {r.short}")
        return 0
    paths = args.paths or ["shadow_tpu_torch", "native"]
    missing = [p for p in paths if not os.path.exists(p)]
    if missing and args.emit_spec is None:
        print(f"simtwin: no such path: {', '.join(missing)}",
              file=sys.stderr)
        return 2
    config = load_config(args.config, start=paths[0] if not missing else ".")
    surface_map = load_map(args.config, config)
    if args.emit_spec is not None:
        out_path = args.emit_spec or os.path.join(config.root, SPEC_OUT)
        blob = None
        if not args.force and os.path.exists(out_path):
            blob = spec_blob(config, surface_map)
            try:
                with open(out_path, "rb") as f:
                    existing = f.read()
            except OSError:
                existing = None
            if existing is not None and existing != blob \
                    and _uncommitted_edits(out_path, config.root):
                print(f"simtwin: refusing to overwrite {out_path}: it has "
                      f"uncommitted edits that differ from the "
                      f"regenerated IR.  The extracted spec is derived — "
                      f"hand edits belong in spec/protocol_spec.json "
                      f"(then `make gen`).  Commit or discard the edits, "
                      f"or rerun with --force.", file=sys.stderr)
                return 1
        blob = emit_spec(out_path, config, surface_map, blob=blob)
        print(f"simtwin: wrote {out_path} ({len(blob)} bytes)")
        return 0
    only = None
    if args.diff is not None:
        try:
            only = changed_py_files(args.diff, config.root, exts=TWIN_EXTS)
        except RuntimeError as e:
            print(f"simtwin: --diff {args.diff}: {e}", file=sys.stderr)
            return 2
    result = twin_paths(paths, config, surface_map, rules, only=only)
    if args.json:
        json.dump(result.to_json(), sys.stdout, indent=2, sort_keys=True)
        print()
    else:
        for f in result.unsuppressed:
            print(f.render())
        print(f"simtwin: {len(result.unsuppressed)} finding(s), "
              f"{len(result.suppressed)} suppressed, "
              f"{result.files} file(s)")
    return 1 if result.unsuppressed else 0


if __name__ == "__main__":
    sys.exit(main())
