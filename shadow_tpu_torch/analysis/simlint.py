"""simlint: the determinism & device-safety rule engine.

An AST-based linter with pluggable rules, a severity model, per-line
suppression pragmas that REQUIRE a reason, a per-rule path allowlist read
from ``pyproject.toml``, and machine-readable JSON output.

Usage::

    python -m shadow_tpu_torch.analysis.simlint [paths...] [--json] [--list-rules]
                                          [--config pyproject.toml]

Exit status: 0 = no unsuppressed findings, 1 = findings, 2 = usage error.

Rules (see rules.py for the catalog):

=======  ========  ====================================================
rule     severity  invariant guarded
=======  ========  ====================================================
SIM001   error     no wall-clock reads in sim code (core/stime.py owns
                   the clock); ``import time as _walltime`` / ``_wt``
                   declares deliberate wall-time (perf telemetry)
SIM002   error     no nondeterministic randomness — derive from
                   ``host.random`` streams or np.random.default_rng(seed)
SIM003   warning   no iteration over unordered sets / dict.keys() where
                   order can reach digests, events, or output
SIM004   error     a buffer donated to a jitted call (donate_argnums)
                   must not be read after the call site
SIM005   warning   no unbounded blocking (sleep, subprocess without
                   timeout) on sim execution paths
SIM006   error     no side effects (print/logging/closure mutation)
                   inside jit-traced functions
SIM000   error     simlint's own hygiene: unparsable/unreadable file,
                   malformed, reasonless, or stale (matched-no-finding)
                   suppression pragma
=======  ========  ====================================================

Suppression: a finding is justified IN the code, never silently::

    t.sleep(30.0)  # simlint: disable=SIM005 -- fault harness: bounded stall

The ``-- <why>`` reason is mandatory; a pragma without one is itself a
finding (SIM000), as is a stale pragma that no longer matches anything.
A pragma on any physical line of a multi-line statement covers the whole
statement; a standalone pragma comment line covers the line below it.
Pragma syntax quoted inside strings/docstrings is inert (comments are
found by tokenizing, not line-scanning).  Allowlisting whole modules
(wall-time-legitimate code like obs/) lives in ``[tool.simlint.allow]``
in pyproject.toml, keyed by rule id with fnmatch path patterns.

Adding a rule: subclass :class:`Rule` in rules.py, set ``id`` /
``severity`` / ``short``, implement ``run(ctx)`` returning findings, and
append it to ``rules.CATALOG``.  ``ctx`` (:class:`ModuleContext`) gives
every rule the shared scope/alias tracker — ``ctx.resolve(node)`` sees
through ``import time as _t`` renames — plus parent links and per-function
symbol tables, so rules stay small.
"""

from __future__ import annotations

import argparse
import ast
import fnmatch
import io
import json
import os
import re
import subprocess
import sys
import tokenize
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Set, Tuple

SCHEMA_VERSION = 1

# ---------------------------------------------------------------------------
# findings


@dataclass
class Finding:
    rule: str
    severity: str            # "error" | "warning"
    path: str                # posix relpath from the lint root
    line: int
    col: int
    message: str
    suppressed: bool = False
    reason: Optional[str] = None   # the pragma's justification, when suppressed

    def sort_key(self) -> Tuple:
        return (self.path, self.line, self.col, self.rule)

    def to_json(self) -> Dict:
        out = {"rule": self.rule, "severity": self.severity,
               "path": self.path, "line": self.line, "col": self.col,
               "message": self.message}
        if self.suppressed:
            out["suppressed"] = True
            out["reason"] = self.reason
        return out

    def render(self) -> str:
        tag = " (suppressed)" if self.suppressed else ""
        return (f"{self.path}:{self.line}:{self.col}: {self.rule} "
                f"{self.severity}: {self.message}{tag}")


class Rule:
    """Base class: one invariant, one ``run`` over a module context."""

    id: str = "SIM000"
    severity: str = "error"
    short: str = ""

    def run(self, ctx: "ModuleContext") -> List[Finding]:  # pragma: no cover
        raise NotImplementedError

    def finding(self, ctx: "ModuleContext", node: ast.AST,
                message: str) -> Finding:
        return Finding(self.id, self.severity, ctx.relpath,
                       getattr(node, "lineno", 1),
                       getattr(node, "col_offset", 0), message)


# ---------------------------------------------------------------------------
# module context: the shared scope/alias tracker every rule sees through


class ModuleContext:
    """One parsed module + the symbol information rules share.

    ``aliases`` maps every locally-bound import name to its canonical
    dotted module path — ``import time as _t`` yields ``{"_t": "time"}``,
    ``from numpy import random as npr`` yields ``{"npr": "numpy.random"}``
    — so a rule matching ``time.monotonic`` fires on ``_t.monotonic()``
    too.  ``resolve`` turns an Attribute/Name chain into
    ``(canonical_dotted_path, surface_root_name)`` or None when the chain
    does not start at an imported module."""

    def __init__(self, relpath: str, source: str):
        self.relpath = relpath
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=relpath)
        self.aliases = self._collect_aliases(self.tree)
        self._parents: Dict[ast.AST, ast.AST] = {}
        self._anchor_map: Optional[Dict[int, int]] = None
        for parent in ast.walk(self.tree):
            for child in ast.iter_child_nodes(parent):
                self._parents[child] = parent

    def stmt_anchor(self, line: int) -> int:
        """First line of the innermost statement covering ``line`` — a
        pragma anywhere on a multi-line statement covers the whole
        statement, wherever a rule anchored its finding."""
        if self._anchor_map is None:
            m: Dict[int, int] = {}
            for node in ast.walk(self.tree):
                end = getattr(node, "end_lineno", None)
                if isinstance(node, ast.stmt) and end:
                    for ln in range(node.lineno, end + 1):
                        # innermost statement = the latest-starting one
                        if node.lineno > m.get(ln, 0):
                            m[ln] = node.lineno
            self._anchor_map = m
        return self._anchor_map.get(line, line)

    @staticmethod
    def _collect_aliases(tree: ast.AST) -> Dict[str, str]:
        aliases: Dict[str, str] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.asname:
                        aliases[a.asname] = a.name
                    else:
                        top = a.name.split(".")[0]
                        aliases[top] = top
            elif isinstance(node, ast.ImportFrom):
                mod = ("." * node.level) + (node.module or "")
                for a in node.names:
                    if a.name == "*":
                        continue
                    aliases[a.asname or a.name] = f"{mod}.{a.name}"
        return aliases

    def parent(self, node: ast.AST) -> Optional[ast.AST]:
        return self._parents.get(node)

    def enclosing_function(self, node: ast.AST) -> Optional[ast.AST]:
        cur = self._parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return cur
            cur = self._parents.get(cur)
        return None

    def resolve(self, node: ast.AST) -> Optional[Tuple[str, str]]:
        """(canonical dotted path, surface root name) for a Name/Attribute
        chain rooted at an imported module binding, else None."""
        parts: List[str] = []
        cur = node
        while isinstance(cur, ast.Attribute):
            parts.append(cur.attr)
            cur = cur.value
        if not isinstance(cur, ast.Name):
            return None
        root = cur.id
        base = self.aliases.get(root)
        if base is None:
            return None
        parts.append(base)
        return ".".join(reversed(parts)), root

    def walk(self, *types) -> Iterable[ast.AST]:
        for node in ast.walk(self.tree):
            if not types or isinstance(node, types):
                yield node


# ---------------------------------------------------------------------------
# suppression pragmas

# one pragma vocabulary for the whole analysis family: the introducer may
# be spelled simlint:/simrace:/simtwin:/simjit: (all equivalent), and the
# rule ids scope ownership — each tool judges staleness only for rules it
# runs
PRAGMA_RE = re.compile(
    r"#\s*sim(?:lint|race|twin|jit):\s*disable=([A-Za-z0-9_,\s]*?)"
    r"\s*(?:--\s*(.*))?$")
_KNOWN_RULES_CACHE: Optional[set] = None


def known_rule_ids() -> set:
    """Every rule id any tool in this package owns: simlint's SIM00x
    catalog, simrace's SIM1xx concurrency catalog, simtwin's SIM2xx
    cross-plane catalog, and simjit's SIM3xx compile-surface catalog.
    Pragmas may name any of them; each TOOL only judges staleness for
    the rules it RUNS (a ``disable=SIM103`` pragma is invisible to
    simlint, not stale)."""
    global _KNOWN_RULES_CACHE
    if _KNOWN_RULES_CACHE is None:
        ids = {r.id for r in default_rules()} | {"SIM000"}
        from . import jit_rules, race_rules, twin_rules
        ids |= {r.id for r in race_rules.CATALOG}
        ids |= {r.id for r in twin_rules.CATALOG}
        ids |= {r.id for r in jit_rules.CATALOG}
        _KNOWN_RULES_CACHE = ids
    return _KNOWN_RULES_CACHE


def _comment_tokens(source: str) -> List[Tuple[int, int, str]]:
    """(line, col, text) for every real COMMENT token — tokenizing rather
    than scanning lines so pragma syntax quoted inside a string literal or
    docstring (this module's own docs, rule messages) is never mistaken
    for a live pragma."""
    out = []
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type == tokenize.COMMENT:
                out.append((tok.start[0], tok.start[1], tok.string))
    except (tokenize.TokenError, IndentationError):
        pass                   # unparsable files already yield SIM000
    return out


@dataclass
class Pragma:
    """One (rule, reason) pair from a suppression comment."""
    rule: str
    reason: str
    target: int              # the line the pragma covers
    line: int                # the pragma comment's own position
    col: int
    used: bool = False


def collect_pragmas(relpath: str, source: str, lines: List[str]
                    ) -> Tuple[List[Pragma], List[Finding]]:
    """Pragma entries + SIM000 findings for malformed ones.  A pragma
    covers its own line (lint_source widens that to the whole enclosing
    statement); a line that is ONLY a pragma comment covers the next line
    instead."""
    pragmas: List[Pragma] = []
    bad: List[Finding] = []
    for i, col0, text in _comment_tokens(source):
        m = PRAGMA_RE.search(text)
        if not m:
            continue
        ids = [s.strip().upper() for s in m.group(1).split(",") if s.strip()]
        reason = (m.group(2) or "").strip()
        col = col0 + m.start()
        if not ids:
            bad.append(Finding("SIM000", "error", relpath, i, col,
                               "suppression pragma names no rule ids "
                               "(expected disable=<RULE>[,<RULE>] "
                               "-- <why>)"))
            continue
        unknown = [r for r in ids if r not in known_rule_ids()]
        if unknown:
            bad.append(Finding("SIM000", "error", relpath, i, col,
                               f"suppression pragma names unknown rule(s) "
                               f"{', '.join(unknown)}"))
        if not reason:
            bad.append(Finding("SIM000", "error", relpath, i, col,
                               "suppression pragma is missing its reason — "
                               "justify it: # simlint: disable="
                               f"{','.join(ids)} -- <why>"))
            continue
        # a comment with no code before it on its line covers the NEXT line
        standalone = not lines[i - 1][:col0].strip() if i <= len(lines) \
            else True
        target = i + 1 if standalone else i
        for rid in ids:
            if rid in known_rule_ids():
                pragmas.append(Pragma(rid, reason, target, i, col))
    return pragmas, bad


# ---------------------------------------------------------------------------
# configuration ([tool.simlint] in pyproject.toml; python 3.10 has no
# tomllib, so a deliberately tiny parser covers the subset we emit)


@dataclass
class Config:
    root: str = "."                      # directory patterns are relative to
    allow: Dict[str, List[str]] = None   # rule id -> fnmatch path patterns
    exclude: List[str] = None            # path patterns skipped entirely

    def __post_init__(self):
        self.allow = self.allow or {}
        self.exclude = self.exclude or []

    def is_excluded(self, relpath: str) -> bool:
        return any(fnmatch.fnmatch(relpath, p) for p in self.exclude)

    def is_allowed(self, rule_id: str, relpath: str) -> bool:
        pats = self.allow.get(rule_id, ())
        return any(fnmatch.fnmatch(relpath, p) for p in pats)


_ARRAY_ITEM_RE = re.compile(r'"((?:[^"\\]|\\.)*)"')


def _toml_section(text: str, header: str) -> Dict[str, List[str]]:
    """Extract ``key = ["a", "b"]`` pairs from one [header] section of a
    TOML document (multiline arrays supported; just enough for simlint's
    own config — NOT a general TOML parser)."""
    out: Dict[str, List[str]] = {}
    lines = text.splitlines()
    in_section = False
    buf = ""
    key = None
    for raw in lines:
        line = raw.strip()
        if line.startswith("["):
            if key is not None:     # unterminated array at section end
                out[key] = _ARRAY_ITEM_RE.findall(buf)
                key = None
            in_section = line == f"[{header}]"
            continue
        if not in_section or not line or line.startswith("#"):
            continue
        if key is not None:
            buf += line
            if buf.count("[") <= buf.count("]"):
                out[key] = _ARRAY_ITEM_RE.findall(buf)
                key = None
            continue
        m = re.match(r"([A-Za-z0-9_-]+)\s*=\s*(.*)$", line)
        if not m:
            continue
        k, v = m.group(1), m.group(2)
        if v.count("[") > v.count("]"):
            key, buf = k, v
        else:
            out[k] = _ARRAY_ITEM_RE.findall(v)
    if key is not None:
        out[key] = _ARRAY_ITEM_RE.findall(buf)
    return out


def load_config(path: Optional[str], start: Optional[str] = None,
                port: bool = True) -> Config:
    """Load [tool.simlint] from ``path``, or search pyproject.toml upward
    from ``start``.  Missing file/section yields the empty config.  With
    ``port`` (the default) the settings are the repository's re-pointed at
    ``shadow_tpu_torch/`` with ``port.toml`` merged over them
    (settings.py); without it the file is read as written.  The returned
    config carries the settings document (``text``) the other tools read
    their own sections from."""
    from .settings import PortConfig, port_settings
    if path is None:
        cur = os.path.abspath(start or ".")
        if os.path.isfile(cur):
            cur = os.path.dirname(cur)
        while True:
            cand = os.path.join(cur, "pyproject.toml")
            if os.path.isfile(cand):
                path = cand
                break
            nxt = os.path.dirname(cur)
            if nxt == cur:
                return PortConfig()
            cur = nxt
    try:
        with open(path, encoding="utf-8") as f:
            text = f.read()
    except OSError:
        return PortConfig()
    if port:
        text = port_settings(text)
    top = _toml_section(text, "tool.simlint")
    allow = _toml_section(text, "tool.simlint.allow")
    return PortConfig(root=os.path.dirname(os.path.abspath(path)) or ".",
                      allow={k.upper(): v for k, v in allow.items()},
                      exclude=top.get("exclude", []), text=text)


# ---------------------------------------------------------------------------
# engine


def default_rules() -> List[Rule]:
    from . import rules
    return list(rules.CATALOG)


def apply_pragmas(ctx: ModuleContext, findings: List[Finding],
                  active_ids: Set[str]) -> List[Finding]:
    """Match suppression pragmas against ``findings`` and return the
    combined (suppressed + SIM000) list for one module.

    ``active_ids`` scopes ownership: only pragmas naming a rule in it can
    suppress here, and only THOSE pragmas can be stale — a pragma for a
    rule another tool runs (simrace's SIM1xx from simlint's point of view,
    and vice versa) is simply not this tool's business.  Malformed pragmas
    (reasonless, unknown rule id) are every tool's business."""
    pragmas, bad = collect_pragmas(ctx.relpath, ctx.source, ctx.lines)
    pragmas = [p for p in pragmas if p.rule in active_ids]
    # a pragma covers the whole statement its target line belongs to, so
    # wrapped calls can carry the pragma on any of their physical lines
    index: Dict[Tuple[int, str], Pragma] = {}
    for p in pragmas:
        index[(ctx.stmt_anchor(p.target), p.rule)] = p
        index[(p.target, p.rule)] = p
    for f in findings:
        p = index.get((f.line, f.rule)) or \
            index.get((ctx.stmt_anchor(f.line), f.rule))
        if p is not None:
            f.suppressed, f.reason = True, p.reason
            p.used = True
    # a pragma that suppressed nothing is stale (the code was fixed, or
    # the rule id is wrong for the finding on that line) — keeping it
    # would misdocument the code, so it is its own finding
    for p in pragmas:
        if not p.used:
            bad.append(Finding(
                "SIM000", "error", ctx.relpath, p.line, p.col,
                f"suppression pragma for {p.rule} matched no finding — "
                "remove the stale pragma (or fix its rule id)"))
    findings = findings + bad            # SIM000 is never suppressible
    return sorted(findings, key=Finding.sort_key)


def lint_source(source: str, relpath: str = "<snippet>",
                config: Optional[Config] = None,
                rules: Optional[List[Rule]] = None) -> List[Finding]:
    """Lint one module's source text (the test-fixture entry point)."""
    config = config or Config()
    rules = rules if rules is not None else default_rules()
    try:
        ctx = ModuleContext(relpath, source)
    except SyntaxError as e:
        return [Finding("SIM000", "error", relpath, e.lineno or 1,
                        (e.offset or 1) - 1,
                        f"file does not parse: {e.msg}")]
    findings: List[Finding] = []
    for rule in rules:
        if config.is_allowed(rule.id, relpath):
            continue
        findings.extend(rule.run(ctx))
    return apply_pragmas(ctx, findings, {r.id for r in rules} | {"SIM000"})


def iter_py_files(paths: List[str], config: Config) -> List[Tuple[str, str]]:
    """[(abspath, relpath-from-config-root)] for every .py under paths,
    sorted, exclusions applied."""
    out = []
    for p in paths:
        p = os.path.abspath(p)
        if os.path.isfile(p):
            files = [p]
        else:
            files = []
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames.sort()
                dirnames[:] = [d for d in dirnames if d != "__pycache__"]
                files.extend(os.path.join(dirpath, fn)
                             for fn in sorted(filenames)
                             if fn.endswith(".py"))
        for fp in files:
            rel = os.path.relpath(fp, config.root).replace(os.sep, "/")
            if not config.is_excluded(rel):
                out.append((fp, rel))
    return sorted(set(out))


def changed_py_files(base: str, root: str,
                     exts: Tuple[str, ...] = (".py",)) -> Set[str]:
    """Relpaths (from ``root``, posix) of files with an ``exts`` suffix
    changed since git ref ``base``, plus untracked ones — the ``--diff
    BASE`` incremental-lint set (simtwin passes C suffixes too).  Raises
    RuntimeError when git can't answer (bad ref, not a repo), so the CLI
    can exit 2 instead of silently linting nothing.

    Path bases differ between the two git commands: ``git diff
    --name-only`` prints toplevel-relative paths while ``git ls-files``
    (run with cwd=root) prints cwd-relative ones — so the diff output is
    re-based onto ``root`` via ``--show-prefix`` (when root is nested in
    the repo, a toplevel path outside root can never match the lint set
    and is dropped)."""

    def _git(args: List[str]) -> str:
        try:
            run = subprocess.run(["git"] + args, cwd=root,
                                 capture_output=True, text=True,
                                 timeout=60)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise RuntimeError(f"git failed: {e!r}")
        if run.returncode != 0:
            raise RuntimeError(
                f"`git {' '.join(args)}` failed: {run.stderr.strip()}")
        return run.stdout

    prefix = _git(["rev-parse", "--show-prefix"]).strip()
    out: Set[str] = set()
    for p in _git(["diff", "--name-only", "-z", base, "--"]).split("\0"):
        if not p.endswith(exts):
            continue
        if prefix:
            if not p.startswith(prefix):
                continue             # changed outside the lint root
            p = p[len(prefix):]
        out.add(p)
    out.update(p for p in _git(["ls-files", "--others",
                                "--exclude-standard", "-z"]).split("\0")
               if p.endswith(exts))
    return out


@dataclass
class LintResult:
    findings: List[Finding]
    files: int
    tool: str = "simlint"

    @property
    def unsuppressed(self) -> List[Finding]:
        return [f for f in self.findings if not f.suppressed]

    @property
    def suppressed(self) -> List[Finding]:
        return [f for f in self.findings if f.suppressed]

    def to_json(self) -> Dict:
        by_rule: Dict[str, int] = {}
        for f in self.unsuppressed:
            by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
        return {
            "version": SCHEMA_VERSION,
            "tool": self.tool,
            "files": self.files,
            "findings": [f.to_json() for f in self.unsuppressed],
            "suppressed": [f.to_json() for f in self.suppressed],
            "summary": {
                "findings": len(self.unsuppressed),
                "suppressed": len(self.suppressed),
                "by_rule": dict(sorted(by_rule.items())),
            },
        }


def lint_paths(paths: List[str], config: Optional[Config] = None,
               rules: Optional[List[Rule]] = None,
               only: Optional[Set[str]] = None) -> LintResult:
    """``only`` (when not None) restricts linting to those relpaths — the
    ``--diff BASE`` incremental mode; an empty set lints nothing."""
    config = config or load_config(None, start=paths[0] if paths else ".")
    rules = rules if rules is not None else default_rules()
    findings: List[Finding] = []
    files = iter_py_files(paths, config)
    if only is not None:
        files = [(a, r) for a, r in files if r in only]
    for abspath, rel in files:
        try:
            with open(abspath, encoding="utf-8") as f:
                source = f.read()
        except (OSError, UnicodeDecodeError) as e:
            # one unreadable/non-UTF8 file must surface as a finding, not
            # crash the whole gate with a traceback
            findings.append(Finding("SIM000", "error", rel, 1, 0,
                                    f"file is unreadable: {e}"))
            continue
        findings.extend(lint_source(source, rel, config, rules))
    findings.sort(key=Finding.sort_key)
    return LintResult(findings, len(files))


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="simlint",
        description="determinism & device-safety static analysis "
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
                    help="lint only .py files changed since git ref BASE "
                         "(plus untracked files)")
    args = ap.parse_args(argv)
    rules = default_rules()
    if args.list_rules:
        for r in rules:
            print(f"{r.id}  {r.severity:<7}  {r.short}")
        return 0
    paths = args.paths or ["shadow_tpu_torch"]
    missing = [p for p in paths if not os.path.exists(p)]
    if missing:
        print(f"simlint: no such path: {', '.join(missing)}",
              file=sys.stderr)
        return 2
    config = load_config(args.config, start=paths[0])
    only = None
    if args.diff is not None:
        try:
            only = changed_py_files(args.diff, config.root)
        except RuntimeError as e:
            print(f"simlint: --diff {args.diff}: {e}", file=sys.stderr)
            return 2
    result = lint_paths(paths, config, rules, only=only)
    if args.json:
        json.dump(result.to_json(), sys.stdout, indent=2, sort_keys=True)
        print()
    else:
        for f in result.unsuppressed:
            print(f.render())
        print(f"simlint: {len(result.unsuppressed)} finding(s), "
              f"{len(result.suppressed)} suppressed, "
              f"{result.files} file(s)")
    return 1 if result.unsuppressed else 0


if __name__ == "__main__":
    sys.exit(main())
