"""jit_rules: the port's build-and-sync surface model + the SIM3xx catalog.

The JAX package's simjit models XLA programs: jit identities, retracing,
buffer donation and compile keys.  The port has no XLA.  Its device
programs are hand-written CUDA kernels (``ops/csrc``) bound through
``ops/_build.py`` (``entry(kernel, symbol, argtypes)``) and launched by
wrappers on the caller's stream; its wall is a host that waits on the card
where it meant to overlap.  The same five rule ids keep their meaning
where the port has the hazard:

=======  ========  ====================================================
rule     severity  invariant guarded
=======  ========  ====================================================
SIM301   n/a       recompile hazard: XLA retracing, which the port does
                   not have (a kernel is built once per source hash)
SIM302   error     no implicit host<->device sync on a live device value
                   inside the dispatch window: ``.item()``,
                   ``.tolist()``, ``.cpu()``, ``.numpy()``,
                   ``int()/float()/bool()`` of a tensor,
                   ``np.asarray(t)``, one-argument ``torch.nonzero`` /
                   ``torch.where``, boolean-mask indexing, branching on
                   a tensor, and ``torch.cuda.synchronize()``
SIM303   error     float promotion of a sim-time lane in a kernel-tagged
                   file: true division, float literals, ``.float()``,
                   ``.double()``, ``.to(torch.float*)`` (and the JAX
                   spellings) in Python; ``(float)``/``(double)`` casts,
                   ``__ll2float_rn``-style conversions and float
                   literals in CUDA (cuspec)
SIM304   n/a       donation misuse: XLA buffer donation, which the port
                   does not have (kernels update their operands in
                   place, by design)
SIM305   error     build-budget drift: each module's count of kernel
                   entry points bound through ops/_build.py, and the
                   length of ``_build.KERNELS``, must EQUAL the
                   checked-in budget (``[tool.simjit.budget]`` of the
                   port's settings); a binding whose names are not
                   literals, or that names a kernel KERNELS does not
                   build, is always a finding; the sharded-variant
                   cache's literal cap must match its runtime budget
=======  ========  ====================================================

SIM302's model is per function, as JAX's: a name assigned from a device
value is one until the function ends.  Device values are the results of
kernel wrappers and of the functions that return them (found
package-wide, to a fixpoint, from the functions that bind a kernel entry),
of ``torch.*`` calls given a ``device=``, of ``.to(...)``/``.cuda()``, and
of their derivations (indexing, methods, arithmetic, ``torch.*`` ops over
them).  A designed collect reads an in-flight handle's attribute
(``self._event.synchronize()``, ``self._buf.numpy()``), which the rule
never tracks, or carries a reasoned ``# simjit: disable=SIM302 -- <why>``
pragma.  :func:`sync_inventory` lists both, and the explicit syncs, for
the card's runtime audit (chip_smoke.py's ``analyzers`` phase), which
fails on a sync in the window at any other site.
"""

from __future__ import annotations

import ast
import fnmatch
import functools
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

from . import cuspec
from .simlint import Config, Finding, ModuleContext
from .twin_rules import _is_timey

# python scalar coercions that force a host<->device sync on a tensor
_SYNC_COERCIONS = {"float", "int", "bool"}
# methods that copy a tensor to the host (each waits for the card)
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "nonzero"}
# numpy entry points that pull a device buffer to the host
_NP_PULLS = {"numpy.asarray", "numpy.array", "numpy.ascontiguousarray",
             "numpy.copy"}
# tensor methods and attributes whose result is host metadata
_HOST_ATTRS = {"shape", "dtype", "device", "ndim", "is_cuda", "layout",
               "data_ptr", "dim", "size", "numel", "element_size",
               "is_contiguous", "nbytes", "stride", "is_pinned",
               "cuda_stream"}
# torch calls whose result is host-side whatever their operands
_TORCH_HOST = {"torch.is_tensor", "torch.from_numpy", "torch.device",
               "torch.get_default_dtype", "torch.cuda.current_stream",
               "torch.cuda.Event", "torch.cuda.Stream", "torch.cuda.device",
               "torch.cuda.stream", "torch.cuda.is_available"}
_FLOAT_DTYPES = {"float32", "float64", "float16", "bfloat16"}
_FLOAT_METHODS = {"float", "double", "half", "bfloat16"}


def _expr_root(node: ast.AST) -> Optional[str]:
    cur = node
    while isinstance(cur, (ast.Attribute, ast.Subscript, ast.Call)):
        cur = cur.func if isinstance(cur, ast.Call) else cur.value
    return cur.id if isinstance(cur, ast.Name) else None


def _names_in(node: ast.AST) -> Set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _own_walk(fn: ast.AST) -> List[ast.AST]:
    """``fn``'s nodes without its nested def and class subtrees (each
    function is checked once, in its own pass), in source order."""
    out: List[ast.AST] = []
    stack = [fn]
    while stack:
        n = stack.pop()
        out.append(n)
        for child in ast.iter_child_nodes(n):
            if not isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                      ast.ClassDef)):
                stack.append(child)
    out.sort(key=lambda n: (getattr(n, "lineno", 0),
                            getattr(n, "col_offset", 0)))
    return out


def _bound_names(t: ast.AST) -> Set[str]:
    if isinstance(t, ast.Name):
        return {t.id}
    if isinstance(t, (ast.Tuple, ast.List)):
        out: Set[str] = set()
        for e in t.elts:
            out |= _bound_names(e)
        return out
    if isinstance(t, ast.Starred):
        return _bound_names(t.value)
    return set()


def _literal_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


# ---------------------------------------------------------------------------
# the package model


@dataclass
class Binding:
    """One kernel entry point bound through ops/_build.py."""
    kernel: Optional[str]     # None: not a literal
    symbol: Optional[str]
    node: ast.AST


def _functions(ctx: ModuleContext
               ) -> List[Tuple[str, Optional[str], ast.AST]]:
    """(qualified key, class name or None, def node) for every function of
    a module; methods keyed ``Class.name``."""
    out = []
    for node in ctx.walk(ast.FunctionDef, ast.AsyncFunctionDef):
        parent = ctx.parent(node)
        cls = parent.name if isinstance(parent, ast.ClassDef) else None
        out.append(((f"{cls}.{node.name}" if cls else node.name), cls, node))
    return out


def _called(nodes: List[ast.AST]) -> Set[str]:
    """The bare names a function's ``nodes`` call (``f(...)``,
    ``x.f(...)``)."""
    out: Set[str] = set()
    for n in nodes:
        if isinstance(n, ast.Call):
            if isinstance(n.func, ast.Name):
                out.add(n.func.id)
            elif isinstance(n.func, ast.Attribute):
                out.add(n.func.attr)
    return out


class TorchPackage:
    """All parsed modules of the port + its build and sync surfaces + the
    settings (kernel-tagged globs, sync-audited globs, the budget)."""

    def __init__(self, contexts: List[ModuleContext],
                 config: Optional[Config] = None,
                 budget: Optional[Dict[str, int]] = None,
                 kernel: Optional[List[str]] = None,
                 sync: Optional[List[str]] = None,
                 cuda: Optional[Dict[str, str]] = None):
        self.contexts = {c.relpath: c for c in contexts}
        # each function's own nodes, walked once for the whole analysis
        self.own = functools.lru_cache(maxsize=None)(_own_walk)
        self.config = config or Config()
        self.budget = dict(budget or {})
        self.kernel = list(kernel or [])
        self.sync = list(sync or [])
        self.cuda = dict(cuda or {})
        self.bindings: Dict[str, List[Binding]] = {
            rel: self._bindings(ctx)
            for rel, ctx in sorted(self.contexts.items())}
        self.kernels: Dict[str, Tuple[List[str], ast.AST]] = {}
        for rel, ctx in sorted(self.contexts.items()):
            found = self._kernels_tuple(ctx)
            if found is not None:
                self.kernels[rel] = found
        self.functions = {rel: _functions(ctx)
                          for rel, ctx in sorted(self.contexts.items())}
        self.device_fns = self._device_functions()

    # -- bindings ----------------------------------------------------------
    @staticmethod
    def _is_build(ctx: ModuleContext, node: ast.AST, name: str) -> bool:
        r = ctx.resolve(node)
        return r is not None and r[0].split(".")[-2:] == ["_build", name]

    def _bindings(self, ctx: ModuleContext) -> List[Binding]:
        out: List[Binding] = []
        for node in ctx.walk(ast.Call, ast.Attribute):
            if isinstance(node, ast.Call) and \
                    self._is_build(ctx, node.func, "entry"):
                args = node.args + [kw.value for kw in node.keywords
                                    if kw.arg in ("name", "symbol")]
                kern = _literal_str(args[0]) if args else None
                sym = _literal_str(args[1]) if len(args) > 1 else None
                out.append(Binding(kern, sym, node))
            elif isinstance(node, ast.Attribute) and \
                    isinstance(node.value, ast.Call) and \
                    self._is_build(ctx, node.value.func, "load"):
                args = node.value.args
                kern = _literal_str(args[0]) if args else None
                out.append(Binding(kern, node.attr, node))
        return out

    @staticmethod
    def _kernels_tuple(ctx: ModuleContext
                       ) -> Optional[Tuple[List[str], ast.AST]]:
        if not ctx.relpath.endswith("ops/_build.py"):
            return None
        for stmt in ctx.tree.body:
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                    and isinstance(stmt.targets[0], ast.Name) \
                    and stmt.targets[0].id == "KERNELS" \
                    and isinstance(stmt.value, (ast.Tuple, ast.List)):
                names = [_literal_str(e) or "?" for e in stmt.value.elts]
                return names, stmt
        return None

    # -- device values -------------------------------------------------------
    def _device_functions(self) -> Set[str]:
        """Function keys (``name`` for a module function, ``relpath::Class.
        method`` for a method) whose return value is a device value: the
        functions that bind a kernel entry, then to a fixpoint those that
        return one (a round re-reads only the functions that call one found
        in the round before)."""
        fns: Set[str] = set()
        todo = []
        for rel, ctx in sorted(self.contexts.items()):
            bound = {id(b.node) for b in self.bindings[rel]}
            for key, cls, node in self.functions[rel]:
                k = self._fn_key(rel, key, cls)
                nodes = self.own(node)
                if bound and any(id(n) in bound for n in ast.walk(node)):
                    fns.add(k)
                elif any(isinstance(n, ast.Return) and n.value is not None
                         for n in nodes):
                    todo.append((rel, ctx, k, cls, node, _called(nodes)))
        fresh: Optional[Set[str]] = None
        for _round in range(8):
            added: Set[str] = set()
            for rel, ctx, k, cls, node, called in todo:
                if k in fns or (fresh is not None and not called & fresh):
                    continue
                tracked = self.device_names(ctx, node, fns, cls)
                for n in self.own(node):
                    if isinstance(n, ast.Return) and n.value is not None \
                            and self._produces(ctx, n.value, tracked, fns,
                                               cls):
                        added.add(k)
                        break
            if not added:
                break
            fns |= added
            fresh = {k.rsplit(".", 1)[-1].rsplit("::", 1)[-1]
                     for k in added}
        return fns

    @staticmethod
    def _fn_key(rel: str, key: str, cls: Optional[str]) -> str:
        return f"{rel}::{key}" if cls else key

    def _calls_device_fn(self, ctx: ModuleContext, call: ast.Call,
                         fns: Set[str], cls: Optional[str]) -> bool:
        f = call.func
        if isinstance(f, ast.Name):
            return f.id in fns
        if isinstance(f, ast.Attribute):
            if isinstance(f.value, ast.Name) and f.value.id == "self" \
                    and cls is not None:
                return f"{ctx.relpath}::{cls}.{f.attr}" in fns
            r = ctx.resolve(f)
            return r is not None and f.attr in fns
        return False

    def _produces(self, ctx: ModuleContext, value: ast.AST,
                  tracked: Dict[str, int], fns: Set[str],
                  cls: Optional[str]) -> bool:
        """Whether ``value`` is a device value given the tracked names."""
        if isinstance(value, ast.Call):
            f = value.func
            if self._calls_device_fn(ctx, value, fns, cls):
                return True
            r = ctx.resolve(f)
            if r is not None and r[0].startswith("torch."):
                if r[0] in _TORCH_HOST:
                    return False
                for kw in value.keywords:
                    if kw.arg == "device" and \
                            _literal_str(kw.value) != "cpu":
                        return True
                return any(self._produces(ctx, a, tracked, fns, cls)
                           for a in value.args)
            if isinstance(f, ast.Attribute):
                if f.attr == "cuda":
                    return True
                if f.attr == "to" and self._moves_to_device(ctx, value):
                    return True
                if f.attr in _SYNC_METHODS or f.attr in _HOST_ATTRS:
                    return False
                return self._produces(ctx, f.value, tracked, fns, cls)
            return False
        if isinstance(value, ast.Attribute):
            if value.attr in _HOST_ATTRS:
                return False
            return self._produces(ctx, value.value, tracked, fns, cls)
        if isinstance(value, ast.Subscript):
            return self._produces(ctx, value.value, tracked, fns, cls)
        if isinstance(value, ast.Name):
            return value.id in tracked
        if isinstance(value, (ast.Tuple, ast.List)):
            return any(self._produces(ctx, e, tracked, fns, cls)
                       for e in value.elts)
        if isinstance(value, ast.BinOp):
            return self._produces(ctx, value.left, tracked, fns, cls) or \
                self._produces(ctx, value.right, tracked, fns, cls)
        if isinstance(value, ast.UnaryOp):
            return self._produces(ctx, value.operand, tracked, fns, cls)
        if isinstance(value, ast.Compare):
            return any(self._produces(ctx, e, tracked, fns, cls)
                       for e in [value.left] + value.comparators)
        if isinstance(value, ast.IfExp):
            return self._produces(ctx, value.body, tracked, fns, cls) or \
                self._produces(ctx, value.orelse, tracked, fns, cls)
        return False

    @staticmethod
    def _moves_to_device(ctx: ModuleContext, call: ast.Call) -> bool:
        """``x.to(dev)`` / ``x.to(device=dev)``: a copy to a device (not
        ``"cpu"``); ``x.to(torch.int64)`` only converts the dtype."""
        for kw in call.keywords:
            if kw.arg == "device":
                return _literal_str(kw.value) != "cpu"
        if not call.args:
            return False
        arg = call.args[0]
        if _literal_str(arg) is not None:
            return _literal_str(arg) != "cpu"
        r = ctx.resolve(arg)
        return not (r is not None and r[0].startswith("torch.")
                    and r[0] != "torch.device")

    def device_names(self, ctx: ModuleContext, fn: ast.AST,
                     fns: Optional[Set[str]] = None,
                     cls: Optional[str] = None) -> Dict[str, int]:
        """Names holding device values in ``fn``, each mapped to the first
        line where it becomes one (code above that line is host-side)."""
        fns = self.device_fns if fns is None else fns
        tracked: Dict[str, int] = {}
        for _ in range(2):
            for n in self.own(fn):
                targets: List[ast.AST] = []
                value: Optional[ast.AST] = None
                if isinstance(n, ast.Assign):
                    targets, value = n.targets, n.value
                elif isinstance(n, (ast.AnnAssign, ast.AugAssign)) \
                        and n.value is not None:
                    targets, value = [n.target], n.value
                elif isinstance(n, ast.For):
                    targets, value = [n.target], n.iter
                if value is None or not self._produces(ctx, value, tracked,
                                                        fns, cls):
                    continue
                for t in targets:
                    for name in _bound_names(t):
                        line = getattr(n, "lineno", None) or \
                            getattr(n.target, "lineno", 0)
                        tracked[name] = min(tracked.get(name, line), line)
        return tracked

    def is_kernel(self, relpath: str) -> bool:
        return any(fnmatch.fnmatch(relpath, p) for p in self.kernel)

    def is_sync(self, relpath: str) -> bool:
        return any(fnmatch.fnmatch(relpath, p) for p in self.sync)


class JitRule:
    """One invariant checked over the whole package."""

    id: str = "SIM300"
    severity: str = "error"
    short: str = ""
    applicable: bool = True

    def run(self, pkg: TorchPackage) -> List[Finding]:  # pragma: no cover
        raise NotImplementedError

    def finding(self, relpath: str, node: ast.AST, message: str) -> Finding:
        return Finding(self.id, self.severity, relpath,
                       getattr(node, "lineno", 1),
                       getattr(node, "col_offset", 0), message)


class NotApplicableRule(JitRule):
    """A JAX-package rule whose hazard the port does not have: listed, so
    its id stays known, and running no check."""

    applicable = False

    def __init__(self, rule_id: str, short: str):
        self.id = rule_id
        self.short = short

    def run(self, pkg: TorchPackage) -> List[Finding]:
        return []


# ---------------------------------------------------------------------------
# SIM302 — implicit sync inside the dispatch window


@dataclass
class SyncSite:
    """One synchronizing call of a sync-audited module."""
    path: str
    line: int           # the statement's first line
    end_line: int       # and its last
    kind: str           # "implicit" | "explicit"
    call: str           # what it calls, for the report
    handle: bool        # it reads an in-flight handle's attribute


class HiddenSyncRule(JitRule):
    """The port's pipelined dispatch runs the card BEHIND the round's host
    work; the overlap survives only while nothing waits on the in-flight
    result.  An implicit sync (``.item()``, ``.tolist()``, ``.cpu()``,
    ``.numpy()``, ``int()`` of a tensor, ``np.asarray`` of one, a
    one-argument ``nonzero``/``where``, a boolean mask, a branch on a
    tensor) or an explicit ``torch.cuda.synchronize()`` on a live device
    value serializes it.  Scoped to the modules that dispatch and collect
    (``[tool.simjit] sync``)."""

    id = "SIM302"
    severity = "error"
    short = ("implicit host<->device sync on a live device value inside "
             "the dispatch window")

    def run(self, pkg: TorchPackage) -> List[Finding]:
        out: List[Finding] = []
        for rel, ctx in sorted(pkg.contexts.items()):
            if not pkg.is_sync(rel):
                continue
            for _key, cls, fn in pkg.functions[rel]:
                for node, msg in self.syncs(pkg, ctx, fn, cls):
                    out.append(self.finding(rel, node, msg))
        return out

    @staticmethod
    def _mask_names(nodes: List[ast.AST], tracked: Dict[str, int]
                    ) -> Set[str]:
        """Tracked names bound to a comparison or a logical combination of
        device values: a boolean mask."""
        out: Set[str] = set()
        for n in nodes:
            if isinstance(n, ast.Assign) and isinstance(
                    n.value, (ast.Compare, ast.BoolOp)) or (
                    isinstance(n, ast.Assign) and isinstance(n.value,
                                                             ast.BinOp)
                    and isinstance(n.value.op, (ast.BitAnd, ast.BitOr))) \
                    or (isinstance(n, ast.Assign)
                        and isinstance(n.value, ast.UnaryOp)
                        and isinstance(n.value.op, ast.Invert)):
                for t in n.targets:
                    out |= _bound_names(t) & set(tracked)
        return out

    def syncs(self, pkg: TorchPackage, ctx: ModuleContext, fn: ast.AST,
              cls: Optional[str]) -> List[Tuple[ast.AST, str]]:
        tracked = pkg.device_names(ctx, fn, cls=cls)
        out: List[Tuple[ast.AST, str]] = []
        nodes = pkg.own(fn)
        for n in nodes:
            if isinstance(n, ast.Call):
                r = ctx.resolve(n.func)
                if r is not None and r[0] == "torch.cuda.synchronize":
                    out.append((n, "`torch.cuda.synchronize()` waits for "
                                   "everything on the card, the in-flight "
                                   "dispatch included — wait on the "
                                   "dispatch's own event, at its collect"))
        comps = [n for n in nodes if isinstance(
            n, (ast.ListComp, ast.SetComp, ast.GeneratorExp, ast.DictComp))]
        if not tracked and not comps:
            return out
        masks = self._mask_names(nodes, tracked)

        def live(node: ast.AST, name: Optional[str]) -> bool:
            # a comprehension's variable is its own: live when what it
            # iterates is a device value
            cur = ctx.parent(node)
            while cur is not None and cur is not fn:
                if isinstance(cur, (ast.ListComp, ast.SetComp,
                                    ast.GeneratorExp, ast.DictComp)):
                    for gen in cur.generators:
                        if name in _bound_names(gen.target):
                            line = getattr(node, "lineno", 0)
                            now = {k: v for k, v in tracked.items()
                                   if v <= line}
                            return pkg._produces(ctx, gen.iter, now,
                                                 pkg.device_fns, cls)
                cur = ctx.parent(cur)
            return name in tracked and \
                getattr(node, "lineno", 0) >= tracked[name]

        for n in nodes:
            if isinstance(n, ast.Call):
                f = n.func
                r = ctx.resolve(f)
                if isinstance(f, ast.Attribute) and \
                        f.attr in _SYNC_METHODS | {"to"} and \
                        live(n, _expr_root(f.value)):
                    if f.attr == "to" and not (
                            n.args and _literal_str(n.args[0]) == "cpu"):
                        continue
                    out.append((n, (
                        f"`.{f.attr}()` on device value "
                        f"`{_expr_root(f.value)}` blocks until the in-flight "
                        "kernel finishes — an implicit sync inside the "
                        "dispatch window; collect first, then read "
                        "host-side")))
                elif isinstance(f, ast.Name) and f.id in _SYNC_COERCIONS \
                        and n.args and live(n, _expr_root(n.args[0])):
                    out.append((n, (
                        f"`{f.id}()` of device value "
                        f"`{_expr_root(n.args[0])}` is an implicit host "
                        "sync — it serializes the pipelined dispatch; keep "
                        "the value on the card or collect explicitly")))
                elif r is not None and r[0] in _NP_PULLS and n.args and \
                        live(n, _expr_root(n.args[0])):
                    out.append((n, (
                        f"`{r[1]}.{r[0].rsplit('.', 1)[1]}` of live device "
                        f"value `{_expr_root(n.args[0])}` pulls the buffer "
                        "to the host mid-window — if this is the designed "
                        "collect point, say so with a pragma")))
                elif r is not None and r[0] in ("torch.nonzero",
                                                "torch.where") \
                        and len(n.args) == 1 and not n.keywords and \
                        any(live(n, m) for m in _names_in(n.args[0])):
                    name = sorted(m for m in _names_in(n.args[0])
                                  if live(n, m))[0]
                    out.append((n, (
                        f"one-argument `{r[0]}` of device value "
                        f"`{name}` sizes its result on the "
                        "host — an implicit sync; keep a fixed-size form")))
            elif isinstance(n, ast.Subscript) and \
                    live(n, _expr_root(n.value)):
                idx = n.slice
                names = _names_in(idx)
                if (names & masks and any(live(n, m) for m in names & masks)
                        and isinstance(idx, ast.Name)) or (
                        isinstance(idx, (ast.Compare, ast.UnaryOp))
                        and any(live(n, m) for m in names)):
                    out.append((n, (
                        f"boolean-mask indexing of device value "
                        f"`{_expr_root(n.value)}` sizes its result on the "
                        "host — an implicit sync; use torch.where with a "
                        "fill or a fixed-size gather")))
            elif isinstance(n, (ast.If, ast.While)) and \
                    self._branches_on_device(n.test, tracked):
                out.append((n.test, (
                    f"branching on device value "
                    f"`{sorted(_names_in(n.test) & set(tracked))[0]}` "
                    "forces a blocking sync — compute the predicate "
                    "host-side or on the card")))
        return out

    @staticmethod
    def _branches_on_device(test: ast.AST, tracked: Dict[str, int]) -> bool:
        line = getattr(test, "lineno", 0)
        if not any(line >= tracked[nm]
                   for nm in sorted(_names_in(test) & set(tracked))):
            return False
        if isinstance(test, ast.Compare) and all(
                isinstance(op, (ast.Is, ast.IsNot)) for op in test.ops):
            return False
        shallow: Set[int] = set()
        for n in ast.walk(test):
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Name) \
                    and n.func.id in ("len", "isinstance", "getattr",
                                      "hasattr"):
                shallow.update(id(s) for s in ast.walk(n))
            elif isinstance(n, ast.Call) and \
                    isinstance(n.func, ast.Attribute) and \
                    n.func.attr in _HOST_ATTRS:
                shallow.update(id(s) for s in ast.walk(n))
            elif isinstance(n, ast.Attribute) and n.attr in _HOST_ATTRS:
                shallow.update(id(s) for s in ast.walk(n))
        for n in ast.walk(test):
            if isinstance(n, ast.Name) and n.id in tracked \
                    and getattr(n, "lineno", 0) >= tracked[n.id] \
                    and id(n) not in shallow:
                return True
        return False


def sync_inventory(pkg: TorchPackage, findings: List[Finding]
                   ) -> List[SyncSite]:
    """Every synchronizing call of the sync-audited modules that the
    static pass knows as designed: the SIM302 findings that carry a pragma
    (``findings`` after pragma matching), the reads of an in-flight
    handle's attribute (``self._event.synchronize()``,
    ``self._buf.numpy()``), and the explicit ``.synchronize()`` calls.
    Each site spans its statement, as a runtime frame may name any line of
    it."""
    suppressed = {(f.path, f.line) for f in findings
                  if f.rule == "SIM302" and f.suppressed}
    out: List[SyncSite] = []
    for rel, ctx in sorted(pkg.contexts.items()):
        if not pkg.is_sync(rel):
            continue
        for n in ctx.walk(ast.Call):
            f = n.func
            r = ctx.resolve(f)
            name = None
            handle = False
            kind = "implicit"
            if isinstance(f, ast.Attribute) and f.attr == "synchronize":
                name, kind = ".synchronize()", "explicit"
                handle = _expr_root(f.value) == "self" or (
                    r is not None and r[0] == "torch.cuda.synchronize")
            elif isinstance(f, ast.Attribute) and f.attr in _SYNC_METHODS:
                name = f".{f.attr}()"
                handle = _expr_root(f.value) == "self" and \
                    isinstance(f.value, (ast.Attribute, ast.Subscript))
            elif isinstance(f, ast.Name) and f.id in _SYNC_COERCIONS:
                name = f"{f.id}()"
            elif r is not None and r[0] in _NP_PULLS:
                name = r[0].replace("numpy.", "np.") + "()"
            if name is None:
                continue
            anchor = ctx.stmt_anchor(n.lineno)
            designed = handle or (rel, n.lineno) in suppressed or \
                (rel, anchor) in suppressed
            if not designed:
                continue
            stmt_end = n.end_lineno or n.lineno
            for node in ctx.walk(ast.stmt):
                if node.lineno == anchor:
                    stmt_end = max(stmt_end, node.end_lineno or stmt_end)
                    break
            site = SyncSite(rel, anchor, stmt_end, kind, name, handle)
            if site not in out:
                out.append(site)
    return out


# ---------------------------------------------------------------------------
# SIM303 — float promotion in kernel-tagged files


class PromotionDriftRule(JitRule):
    """The kernel plane's contract is non-negative int64 arithmetic — what
    makes ``py // == C / == CUDA / == torch int64`` exact.  A float
    literal, a true division, or a float cast touching a sim-time lane
    promotes the expression to float: ns timestamps lose integer
    exactness above 2**53 and the planes drift.  Python kernel files in
    torch spelling (and the JAX package's, which the rule still reads), and
    the CUDA sources through cuspec."""

    id = "SIM303"
    severity = "error"
    short = ("float promotion on a sim-time lane in a kernel-tagged "
             "file (int64 contract)")

    def run(self, pkg: TorchPackage) -> List[Finding]:
        out: List[Finding] = []
        for rel, ctx in sorted(pkg.contexts.items()):
            if pkg.is_kernel(rel):
                out.extend(self._check_module(rel, ctx))
        for rel, text in sorted(pkg.cuda.items()):
            if pkg.is_kernel(rel):
                for line, col, msg in cuspec.float_findings(rel, text):
                    out.append(Finding(self.id, self.severity, rel, line,
                                       col, msg))
        return out

    @staticmethod
    def _timey_in(node: ast.AST) -> Optional[str]:
        for n in ast.walk(node):
            nm = None
            if isinstance(n, ast.Name):
                nm = n.id
            elif isinstance(n, ast.Attribute):
                nm = n.attr
            if nm and _is_timey(nm):
                return nm
        return None

    def _check_module(self, rel: str, ctx: ModuleContext) -> List[Finding]:
        out: List[Finding] = []
        for node in ctx.walk(ast.BinOp):
            if isinstance(node.op, ast.Div):
                nm = self._timey_in(node.left) or self._timey_in(node.right)
                if nm:
                    out.append(self.finding(
                        rel, node,
                        f"true division on sim-time lane `{nm}` promotes "
                        "the int64 ns value to float — use `//` (the "
                        "non-negative int64 contract keeps all three "
                        "planes bit-exact)"))
                continue
            if isinstance(node.op, (ast.Mult, ast.Add, ast.Sub)):
                for side, other in ((node.left, node.right),
                                    (node.right, node.left)):
                    if isinstance(side, ast.Constant) and \
                            isinstance(side.value, float):
                        nm = self._timey_in(other)
                        if nm:
                            out.append(self.finding(
                                rel, node,
                                f"float literal {side.value!r} in "
                                f"arithmetic with sim-time lane `{nm}` "
                                "weak-type-promotes the int64 ns value "
                                "to float — spell the coefficient as an "
                                "integer ratio (num // den)"))
                        break
        for node in ctx.walk(ast.Call):
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr == "astype" \
                    and node.args and self._float_dtype(node.args[0]):
                nm = self._timey_in(f.value)
                if nm:
                    out.append(self.finding(
                        rel, node,
                        f"sim-time lane `{nm}` cast to "
                        f"{self._float_dtype(node.args[0])} — ns "
                        "timestamps lose integer exactness above 2**53; "
                        "keep the lane int64"))
            elif isinstance(f, ast.Attribute) and \
                    f.attr in _FLOAT_DTYPES and node.args:
                nm = self._timey_in(node.args[0])
                if nm:
                    out.append(self.finding(
                        rel, node,
                        f"sim-time lane `{nm}` cast to {f.attr} — ns "
                        "timestamps lose integer exactness above 2**53; "
                        "keep the lane int64"))
            elif isinstance(f, ast.Attribute) and \
                    f.attr in _FLOAT_METHODS and not node.args:
                nm = self._timey_in(f.value)
                if nm:
                    out.append(self.finding(
                        rel, node,
                        f"sim-time lane `{nm}` cast by `.{f.attr}()` — ns "
                        "timestamps lose integer exactness above 2**53; "
                        "keep the lane int64"))
            elif isinstance(f, ast.Attribute) and f.attr in ("to", "type"):
                dt = next((self._float_dtype(a) for a in
                           list(node.args) + [kw.value for kw in
                                              node.keywords
                                              if kw.arg == "dtype"]
                           if self._float_dtype(a)), None)
                nm = self._timey_in(f.value) if dt else None
                if nm:
                    out.append(self.finding(
                        rel, node,
                        f"sim-time lane `{nm}` cast to {dt} by "
                        f"`.{f.attr}()` — ns timestamps lose integer "
                        "exactness above 2**53; keep the lane int64"))
        return out

    @staticmethod
    def _float_dtype(node: ast.AST) -> Optional[str]:
        if isinstance(node, ast.Attribute) and node.attr in _FLOAT_DTYPES:
            return node.attr
        if isinstance(node, ast.Name) and node.id in _FLOAT_DTYPES:
            return node.id
        if isinstance(node, ast.Constant) and \
                isinstance(node.value, str) and node.value in _FLOAT_DTYPES:
            return node.value
        return None


# ---------------------------------------------------------------------------
# SIM305 — the build budget

BUDGET_ANCHOR = "shadow_tpu_torch/analysis/port.toml"


class BuildBudgetRule(JitRule):
    """The checked-in budget declares, per module, how many kernel entry
    points the module binds through ops/_build.py, and how many CUDA
    sources ``_build.KERNELS`` builds; the rule enumerates both and fails
    on any drift — a new kernel or binding without a conscious bump, and a
    stale entry after a surface shrinks.  A binding that names its kernel
    or symbol by a non-literal cannot be enumerated, and one that names a
    kernel KERNELS does not build would fail at first use: both are
    findings.  The sharded-variant cache's literal cap must equal its
    runtime budget (``device_plane.sharded_variants``), as in JAX's
    simjit."""

    id = "SIM305"
    severity = "error"
    short = ("kernel-binding count drifted from the checked-in build "
             "budget")

    def run(self, pkg: TorchPackage) -> List[Finding]:
        out: List[Finding] = []
        module_budget = {k: v for k, v in pkg.budget.items()
                         if k.endswith(".py")}
        counted: Dict[str, int] = {}
        built: Set[str] = set()
        for names, _node in pkg.kernels.values():
            built |= set(names)
        for rel, binds in sorted(pkg.bindings.items()):
            pairs: Set[Tuple[str, str]] = set()
            for b in binds:
                if b.kernel is None or b.symbol is None:
                    out.append(self.finding(
                        rel, b.node,
                        "kernel entry bound with a non-literal kernel or "
                        "symbol name — the build surface is not "
                        "enumerable; name both literally"))
                    continue
                if built and b.kernel not in built:
                    out.append(self.finding(
                        rel, b.node,
                        f"entry binds kernel `{b.kernel}`, which "
                        "_build.KERNELS does not build"))
                pairs.add((b.kernel, b.symbol))
            if pairs:
                counted[rel] = len(pairs)
        for rel, (names, node) in sorted(pkg.kernels.items()):
            counted[rel] = len(names)
        anchor1 = ast.Module(body=[], type_ignores=[])
        anchor1.lineno, anchor1.col_offset = 1, 0
        for rel, count in sorted(counted.items()):
            declared = module_budget.get(rel)
            what = ("CUDA source(s) in KERNELS" if rel in pkg.kernels
                    else "kernel entry point(s) bound")
            if declared is None:
                out.append(self.finding(
                    rel, anchor1,
                    f"module has {count} {what} but no [tool.simjit.budget] "
                    f"entry — declare it in {BUDGET_ANCHOR} so growth is "
                    "a conscious decision"))
            elif declared != count:
                direction = "grew past" if count > declared else \
                    "shrank below"
                out.append(self.finding(
                    rel, anchor1,
                    f"build surface {direction} its budget: {count} "
                    f"{what} vs [tool.simjit.budget] = {declared} — update "
                    "the table to match the surface"))
        for rel in sorted(set(module_budget) - set(counted)):
            if rel not in pkg.contexts and \
                    os.path.isfile(os.path.join(pkg.config.root, rel)):
                continue
            out.append(self.finding(
                BUDGET_ANCHOR, anchor1,
                f"[tool.simjit.budget] entry `{rel}` = "
                f"{module_budget[rel]} is stale — the module binds no "
                "kernel entry point (removed surface? drop the entry)"))
        for key, declared in sorted(pkg.budget.items()):
            if not key.endswith(".sharded_variants"):
                continue
            for rel, ctx in sorted(pkg.contexts.items()):
                if not rel.endswith("device_plane.py"):
                    continue
                for n in ctx.walk(ast.Compare):
                    if isinstance(n.left, ast.Call) and \
                            isinstance(n.left.func, ast.Name) and \
                            n.left.func.id == "len" and n.left.args and \
                            "variants" in ast.unparse(n.left.args[0]) and \
                            len(n.ops) == 1 and \
                            isinstance(n.ops[0], ast.GtE) and \
                            isinstance(n.comparators[0], ast.Constant) and \
                            n.comparators[0].value != declared:
                        out.append(self.finding(
                            rel, n,
                            f"variant-cache literal cap "
                            f"{n.comparators[0].value} != "
                            f"[tool.simjit.budget] `{key}` = {declared} — "
                            "the checked-in budget and the code bound "
                            "must agree"))
        return out


CATALOG: List[JitRule] = [
    NotApplicableRule(
        "SIM301", "not applicable in the port: XLA retracing (a CUDA kernel "
        "is built once per source hash, never retraced)"),
    HiddenSyncRule(),
    PromotionDriftRule(),
    NotApplicableRule(
        "SIM304", "not applicable in the port: XLA buffer donation (the "
        "kernels update their operands in place, by design)"),
    BuildBudgetRule(),
]
