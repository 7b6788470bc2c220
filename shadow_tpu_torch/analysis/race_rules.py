"""The simrace rule catalog (SIM101-SIM110): package-wide concurrency
analysis over the whole-module model in :class:`PackageContext`.

Where simlint (rules.py) proves per-file determinism contracts, these
rules prove the *threading* contracts the simulator grew in PRs 2-4: the
threaded scheduler's lock hierarchy, the watchdog helper threads on every
fault seam, the lock-guarded trace ring and logger, and the tag-based
shard protocol.  Ordering bugs here surface as silent nondeterminism that
digest-parity tests catch only probabilistically — these rules catch them
at analysis time.

=======  ========  ====================================================
rule     severity  invariant guarded
=======  ========  ====================================================
SIM101   error     no lock-order inversion: two locks never acquired in
                   opposite nesting orders anywhere in the package
SIM102   error     state shared with a ``threading.Thread`` target is
                   mutated/read on both sides under one lock (or the
                   ordering is justified with a pragma)
SIM103   warning   no blocking call (Connection recv/send, sendall,
                   sleep, unbounded join/wait/subprocess) while holding
                   a lock
SIM110   error     the tag-based parent<->child shard protocol round-
                   trips: every sent tag has a handler, arities match,
                   no reachable mutual-wait (see protocol.py)
=======  ========  ====================================================

The model is deliberately scoped to stay sound-ish without whole-program
dataflow: lock identities resolve through ``self`` attributes assigned a
``threading.Lock()``-family factory (collections of locks —
``self._host_locks[hid]`` — collapse to one identity per collection, so
hierarchical per-host locking is not a false inversion), local aliases
(``lk = self._exec_locks[hid]``), and lock-ish attribute names as a
fallback; thread reachability is same-module (a target plus the local
functions/methods it calls), which covers every helper-thread idiom this
codebase uses without dragging the whole engine into the thread set.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from .simlint import Config, Finding, ModuleContext

LOCK_FACTORIES = {
    "threading.Lock", "threading.RLock", "threading.Condition",
    "threading.Semaphore", "threading.BoundedSemaphore",
    "multiprocessing.Lock", "multiprocessing.RLock",
    "multiprocessing.Condition",
}

# attribute-name fallback: `with self.foo:` counts as a lock when the
# name says so, even if the assignment lives in another module
_LOCKISH = ("lock", "cond", "mutex", "sem")

# method names that mutate their receiver in place (shared with SIM006's
# closure-mutation logic, duplicated here to keep the catalogs decoupled)
MUTATORS = {"append", "extend", "insert", "remove", "clear", "add",
            "update", "setdefault", "pop", "popitem", "discard"}


def _is_lockish_name(name: str) -> bool:
    low = name.lower()
    return any(part in low for part in _LOCKISH)


# ---------------------------------------------------------------------------
# lock identities


class LockId(tuple):
    """Hashable lock identity: (kind, owner, name).

    kind 'attr'     — ``self.X`` where X was assigned a lock factory (or
                      is lock-ish by name); owner = class qualname
    kind 'attrcoll' — ``self.X[k]`` collection of locks; ONE identity per
                      collection (members are unordered peers, so a
                      nested acquire within one collection is not a
                      statically decidable inversion and is skipped)
    kind 'local'    — function-local ``x = threading.Lock()``; owner =
                      function qualname (closures included)
    kind 'global'   — module-level lock; owner = relpath
    """

    def __new__(cls, kind: str, owner: str, name: str):
        return super().__new__(cls, (kind, owner, name))

    @property
    def kind(self) -> str:
        return self[0]

    def label(self) -> str:
        return f"{self[1]}.{self[2]}" if self[1] else self[2]


# ---------------------------------------------------------------------------
# per-function concurrency summary


class FuncInfo:
    __slots__ = ("ctx", "node", "qual", "cls_qual", "self_name",
                 "local_locks", "locals_")

    def __init__(self, ctx: ModuleContext, node: ast.AST, qual: str,
                 cls_qual: Optional[str]):
        self.ctx = ctx
        self.node = node
        self.qual = qual
        self.cls_qual = cls_qual
        args = node.args
        self.self_name = (args.args[0].arg
                          if cls_qual and args.args else None)
        self.local_locks: Dict[str, LockId] = {}
        self.locals_ = _own_locals(node)


def _own_locals(fn: ast.AST) -> Set[str]:
    """Names bound in ``fn``'s own scope (params, bare-Name stores,
    nested def names) — NOT descending into nested function bodies."""
    a = fn.args
    names = {x.arg for x in a.args + a.kwonlyargs + a.posonlyargs}
    if a.vararg:
        names.add(a.vararg.arg)
    if a.kwarg:
        names.add(a.kwarg.arg)
    for node in _walk_scope(fn):
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
            names.add(node.id)
        elif node is not fn and isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
    return names


def _walk_scope(node: ast.AST) -> Iterable[ast.AST]:
    """ast.walk that stays inside one function scope: nested function /
    class / lambda nodes are yielded (their NAMES are scope facts) but
    never descended into (their bodies are separate scopes)."""
    stack = [node]
    while stack:
        cur = stack.pop()
        yield cur
        if cur is not node and isinstance(
                cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                      ast.ClassDef, ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(cur))


class ModuleConcurrency:
    """One module's concurrency facts: functions, lock bindings, and the
    per-function event streams (acquisitions, calls, mutations, loads)
    recorded with the lock set held at each point."""

    def __init__(self, ctx: ModuleContext):
        self.ctx = ctx
        self.funcs: Dict[str, FuncInfo] = {}
        self.class_lock_attrs: Dict[Tuple[str, str], str] = {}  # -> kind
        self.module_locks: Dict[str, LockId] = {}
        # per function qualname:
        self.acquisitions: Dict[str, List[Tuple[Tuple, LockId, ast.AST]]] = {}
        self.calls: Dict[str, List[Tuple[Tuple, ast.Call]]] = {}
        self.mutations: Dict[str, List[Tuple[Tuple, str, str, ast.AST]]] = {}
        self.loads: Dict[str, List[Tuple[Tuple, str, str, ast.AST]]] = {}
        self.callees: Dict[str, Set[str]] = {}
        self.thread_spawns: List[Tuple[str, ast.Call, Optional[str]]] = []
        self._index()
        for qual in self.funcs:
            self._summarize(qual)

    # -- indexing ----------------------------------------------------------
    def _index(self) -> None:
        ctx = self.ctx
        for node in ctx.walk(ast.FunctionDef, ast.AsyncFunctionDef):
            qual, cls_qual = self._qualify(node)
            self.funcs[qual] = FuncInfo(ctx, node, qual, cls_qual)
        # lock-factory bindings: self.X = Lock() / self.X[k] = Lock() /
        # module-level N = Lock() / function-local n = Lock()
        for node in ctx.walk(ast.Assign):
            if len(node.targets) != 1 or not isinstance(node.value, ast.Call):
                continue
            r = ctx.resolve(node.value.func)
            if r is None or r[0] not in LOCK_FACTORIES:
                continue
            t = node.targets[0]
            owner = self._enclosing_func(node)
            if isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name):
                cls = self._enclosing_class_qual(node)
                if cls is not None:
                    self.class_lock_attrs.setdefault((cls, t.attr), "attr")
            elif isinstance(t, ast.Subscript) and \
                    isinstance(t.value, ast.Attribute) and \
                    isinstance(t.value.value, ast.Name):
                cls = self._enclosing_class_qual(node)
                if cls is not None:
                    self.class_lock_attrs[(cls, t.value.attr)] = "attrcoll"
            elif isinstance(t, ast.Name):
                if owner is None:
                    self.module_locks[t.id] = LockId(
                        "global", ctx.relpath, t.id)
                else:
                    owner.local_locks[t.id] = LockId(
                        "local", owner.qual, t.id)

    def _qualify(self, node: ast.AST) -> Tuple[str, Optional[str]]:
        names = [node.name]
        cur = self.ctx.parent(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.ClassDef)):
                names.append(cur.name)
            cur = self.ctx.parent(cur)
        parts = list(reversed(names))
        cls_qual = ".".join(parts[:-1]) if isinstance(
            self.ctx.parent(node), ast.ClassDef) else None
        return ".".join(parts), cls_qual

    def _enclosing_func(self, node: ast.AST) -> Optional[FuncInfo]:
        fn = self.ctx.enclosing_function(node)
        if fn is None:
            return None
        return self.funcs.get(self._qualify(fn)[0])

    def _enclosing_class_qual(self, node: ast.AST) -> Optional[str]:
        cur = self.ctx.parent(node)
        parts: List[str] = []
        cls = None
        while cur is not None:
            if isinstance(cur, ast.ClassDef) and cls is None:
                cls = cur
                parts.append(cur.name)
            elif cls is not None and isinstance(
                    cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
                parts.append(cur.name)
            cur = self.ctx.parent(cur)
        return ".".join(reversed(parts)) if cls is not None else None

    # -- lock resolution ---------------------------------------------------
    def resolve_lock(self, fi: FuncInfo, expr: ast.AST) -> Optional[LockId]:
        if isinstance(expr, ast.Name):
            if expr.id in fi.local_locks:
                return fi.local_locks[expr.id]
            # closure lock: a local lock of any enclosing function
            cur = self.ctx.enclosing_function(fi.node)
            while cur is not None:
                outer = self.funcs.get(self._qualify(cur)[0])
                if outer and expr.id in outer.local_locks:
                    return outer.local_locks[expr.id]
                cur = self.ctx.enclosing_function(cur)
            return self.module_locks.get(expr.id)
        if isinstance(expr, ast.Attribute) and \
                isinstance(expr.value, ast.Name):
            base, attr = expr.value.id, expr.attr
            if fi.self_name and base == fi.self_name and fi.cls_qual:
                kind = self.class_lock_attrs.get((fi.cls_qual, attr))
                if kind == "attr":
                    return LockId("attr", fi.cls_qual, attr)
                if kind is None and _is_lockish_name(attr):
                    return LockId("attr", fi.cls_qual, attr)
            elif _is_lockish_name(attr):
                return LockId("attr", f"{self.ctx.relpath}:{base}", attr)
            return None
        if isinstance(expr, ast.Subscript):
            coll = self._lock_collection(fi, expr.value)
            return coll
        if isinstance(expr, ast.Call) and \
                isinstance(expr.func, ast.Attribute) and \
                expr.func.attr == "get":
            return self._lock_collection(fi, expr.func.value)
        return None

    def _lock_collection(self, fi: FuncInfo,
                         base: ast.AST) -> Optional[LockId]:
        if isinstance(base, ast.Attribute) and \
                isinstance(base.value, ast.Name) and fi.self_name and \
                base.value.id == fi.self_name and fi.cls_qual:
            kind = self.class_lock_attrs.get((fi.cls_qual, base.attr))
            if kind == "attrcoll":
                return LockId("attrcoll", fi.cls_qual, base.attr)
        return None

    # -- the region/event walker ------------------------------------------
    def _summarize(self, qual: str) -> None:
        fi = self.funcs[qual]
        acqs: List[Tuple[Tuple, LockId, ast.AST]] = []
        calls: List[Tuple[Tuple, ast.Call]] = []
        muts: List[Tuple[Tuple, str, str, ast.AST]] = []
        loads: List[Tuple[Tuple, str, str, ast.AST]] = []
        callees: Set[str] = set()
        acquired: List[LockId] = []      # open .acquire() regions

        def selfattr(e: ast.AST) -> Optional[str]:
            if isinstance(e, ast.Attribute) and \
                    isinstance(e.value, ast.Name) and fi.self_name and \
                    e.value.id == fi.self_name and fi.cls_qual:
                return f"{fi.cls_qual}.{e.attr}"
            return None

        def record_mut(target: ast.AST, held: Tuple, node: ast.AST) -> None:
            base = target
            if isinstance(base, ast.Subscript):
                base = base.value
            sa = selfattr(base)
            if sa is not None:
                muts.append((held, "selfattr", sa, node))
            elif isinstance(base, ast.Name):
                muts.append((held, "name", base.id, node))

        def visit(node: ast.AST, held: Tuple) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef, ast.Lambda)):
                return                     # separate scope
            if isinstance(node, (ast.With, ast.AsyncWith)):
                new = held
                for item in node.items:
                    lk = self.resolve_lock(fi, item.context_expr)
                    if lk is not None:
                        acqs.append((new + tuple(acquired), lk, node))
                        new = new + (lk,)
                    else:
                        visit(item.context_expr, new)
                for s in node.body:
                    visit(s, new)
                return
            if isinstance(node, ast.Call):
                eff = held + tuple(acquired)
                f = node.func
                if isinstance(f, ast.Attribute):
                    lk = self.resolve_lock(fi, f.value)
                    if lk is not None and f.attr == "acquire":
                        acqs.append((eff, lk, node))
                        acquired.append(lk)
                    elif lk is not None and f.attr == "release":
                        if lk in acquired:
                            acquired.remove(lk)
                    if f.attr in MUTATORS:
                        record_mut(f.value, eff, node)
                calls.append((eff, node))
                if isinstance(f, ast.Name):
                    callees.add(f.id)
                elif isinstance(f, ast.Attribute) and \
                        isinstance(f.value, ast.Name) and fi.self_name and \
                        f.value.id == fi.self_name:
                    callees.add(f.attr)
                for child in ast.iter_child_nodes(node):
                    visit(child, held)
                return
            if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                eff = held + tuple(acquired)
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for t in targets:
                    if isinstance(t, (ast.Subscript, ast.Attribute)) or \
                            isinstance(node, ast.AugAssign):
                        record_mut(t, eff, node)
                if isinstance(node, ast.Assign) and \
                        isinstance(node.value, (ast.Subscript, ast.Call)) \
                        and len(node.targets) == 1 and \
                        isinstance(node.targets[0], ast.Name):
                    # local alias of a lock (exec_lock = self._locks[hid])
                    lk = self.resolve_lock(fi, node.value)
                    if lk is not None:
                        fi.local_locks[node.targets[0].id] = lk
                value = node.value
                if value is not None:
                    visit(value, held)
                return
            if isinstance(node, ast.Name):
                eff = held + tuple(acquired)
                loads.append((eff, "name", node.id, node))
                return
            if isinstance(node, ast.Attribute):
                sa = selfattr(node)
                if sa is not None:
                    loads.append((held + tuple(acquired), "selfattr", sa,
                                  node))
                for child in ast.iter_child_nodes(node):
                    visit(child, held)
                return
            for child in ast.iter_child_nodes(node):
                visit(child, held)

        for stmt in fi.node.body:
            visit(stmt, ())
        self.acquisitions[qual] = acqs
        self.calls[qual] = calls
        self.mutations[qual] = muts
        self.loads[qual] = loads
        self.callees[qual] = callees
        # threading.Thread(target=...) spawns
        for _, call in calls:
            r = self.ctx.resolve(call.func)
            if r is None or r[0] != "threading.Thread":
                continue
            target = next((kw.value for kw in call.keywords
                           if kw.arg == "target"), None)
            tq = self._target_qual(fi, target)
            self.thread_spawns.append((qual, call, tq))

    def _target_qual(self, fi: FuncInfo,
                     target: Optional[ast.AST]) -> Optional[str]:
        if isinstance(target, ast.Name):
            # nearest def: nested in the spawning function, else module
            for cand in (f"{fi.qual}.{target.id}", target.id):
                if cand in self.funcs:
                    return cand
            # method referenced without self (rare) or sibling nested def
            for qual in self.funcs:
                if qual.endswith(f".{target.id}"):
                    return qual
        elif isinstance(target, ast.Attribute) and \
                isinstance(target.value, ast.Name) and fi.self_name and \
                target.value.id == fi.self_name and fi.cls_qual:
            cand = f"{fi.cls_qual}.{target.attr}"
            if cand in self.funcs:
                return cand
        return None

    def thread_reachable(self, root: str) -> Set[str]:
        """Same-module functions reachable from thread target ``root``
        through bare-name and self-method calls."""
        seen = {root}
        frontier = [root]
        while frontier:
            cur = frontier.pop()
            fi = self.funcs.get(cur)
            for name in self.callees.get(cur, ()):
                cands = [f"{cur}.{name}", name]
                if fi is not None and fi.cls_qual:
                    cands.append(f"{fi.cls_qual}.{name}")
                for cand in cands:
                    if cand in self.funcs and cand not in seen:
                        seen.add(cand)
                        frontier.append(cand)
        return seen


# ---------------------------------------------------------------------------
# package context


class PackageContext:
    """All parsed modules + the lazily-built concurrency model."""

    def __init__(self, contexts: List[ModuleContext],
                 config: Optional[Config] = None):
        self.contexts = {c.relpath: c for c in contexts}
        self.config = config or Config()
        self.concurrency: Dict[str, ModuleConcurrency] = {}
        for rel, ctx in sorted(self.contexts.items()):
            self.concurrency[rel] = ModuleConcurrency(ctx)

    def locks_acquired_closure(self, rel: str, qual: str,
                               _seen: Optional[Set] = None) -> Set[LockId]:
        """Every lock ``qual`` (or a same-module callee) may acquire."""
        _seen = _seen if _seen is not None else set()
        key = (rel, qual)
        if key in _seen:
            return set()
        _seen.add(key)
        mc = self.concurrency.get(rel)
        if mc is None or qual not in mc.funcs:
            return set()
        out = {lk for _, lk, _ in mc.acquisitions.get(qual, ())}
        fi = mc.funcs[qual]
        for name in mc.callees.get(qual, ()):
            for cand in (f"{qual}.{name}", name,
                         f"{fi.cls_qual}.{name}" if fi.cls_qual else None):
                if cand and cand in mc.funcs:
                    out |= self.locks_acquired_closure(rel, cand, _seen)
                    break
        return out


class PackageRule:
    """One concurrency invariant checked over the whole package."""

    id: str = "SIM100"
    severity: str = "error"
    short: str = ""

    def run(self, pkg: PackageContext) -> List[Finding]:  # pragma: no cover
        raise NotImplementedError

    def finding(self, relpath: str, node: ast.AST, message: str) -> Finding:
        return Finding(self.id, self.severity, relpath,
                       getattr(node, "lineno", 1),
                       getattr(node, "col_offset", 0), message)


# ---------------------------------------------------------------------------
# SIM101 — lock-order inversion


class LockOrderRule(PackageRule):
    """Two locks acquired in opposite nesting orders anywhere in the
    package can deadlock the moment two threads interleave — the classic
    inversion the reference avoids with its ordered dual-locking
    (scheduler_policy_host_steal.c:366-416).  Edges propagate one call
    level deep (acquiring inside a helper called under a lock counts);
    acquisitions within ONE lock collection (``self._host_locks[a]`` then
    ``[b]``) are skipped — member order is not statically decidable."""

    id = "SIM101"
    severity = "error"
    short = ("lock-order inversion: locks acquired in opposite nesting "
             "orders (deadlock hazard)")

    def run(self, pkg: PackageContext) -> List[Finding]:
        edges: Dict[Tuple[LockId, LockId], Tuple[str, ast.AST]] = {}
        for rel, mc in pkg.concurrency.items():
            for qual in mc.funcs:
                for held, lk, node in mc.acquisitions.get(qual, ()):
                    for h in held:
                        if h != lk:
                            edges.setdefault((h, lk), (rel, node))
                for held, call in mc.calls.get(qual, ()):
                    if not held:
                        continue
                    f = call.func
                    fi = mc.funcs[qual]
                    # propagate through local functions and SELF methods
                    # only — `q.pop()` on an arbitrary receiver must not
                    # resolve to a same-named method of this class
                    name = None
                    if isinstance(f, ast.Name):
                        name = f.id
                    elif isinstance(f, ast.Attribute) and \
                            isinstance(f.value, ast.Name) and \
                            fi.self_name and f.value.id == fi.self_name:
                        name = f.attr
                    if name is None:
                        continue
                    for cand in (f"{qual}.{name}", name,
                                 f"{fi.cls_qual}.{name}"
                                 if fi.cls_qual else None):
                        if cand and cand in mc.funcs:
                            for lk in pkg.locks_acquired_closure(rel, cand):
                                for h in held:
                                    if h != lk:
                                        edges.setdefault((h, lk),
                                                         (rel, call))
                            break
        # reachability over the edge graph: an edge is part of a cycle iff
        # its head can reach its tail
        adj: Dict[LockId, Set[LockId]] = {}
        for (a, b) in edges:
            adj.setdefault(a, set()).add(b)

        def reaches(src: LockId, dst: LockId) -> bool:
            seen = {src}
            frontier = [src]
            while frontier:
                cur = frontier.pop()
                for nxt in adj.get(cur, ()):
                    if nxt == dst:
                        return True
                    if nxt not in seen:
                        seen.add(nxt)
                        frontier.append(nxt)
            return False

        out: List[Finding] = []
        for (a, b), (rel, node) in sorted(
                edges.items(), key=lambda kv: (kv[1][0],
                                               kv[1][1].lineno)):
            if reaches(b, a):
                out.append(self.finding(
                    rel, node,
                    f"lock-order inversion: `{b.label()}` acquired while "
                    f"holding `{a.label()}`, but the opposite order also "
                    "exists — pick one global order (deadlock hazard)"))
        return out


# ---------------------------------------------------------------------------
# SIM102 — unsynchronized thread-shared state


class ThreadSharedStateRule(PackageRule):
    """State a ``threading.Thread`` target mutates is only safe to touch
    from the spawning side under the SAME lock (or after a join that the
    analysis cannot see — justify THAT with a pragma naming the barrier).
    Covers closure variables (the watchdog-helper idiom: a nested
    ``_work`` writing its result box) and ``self`` attributes mutated by
    thread-target methods; accesses before the Thread construction are
    ordered by the start() happens-before edge and ignored."""

    id = "SIM102"
    severity = "error"
    short = ("thread-shared state mutated/read without a shared lock "
             "(silent race)")

    def run(self, pkg: PackageContext) -> List[Finding]:
        out: List[Finding] = []
        for rel, mc in sorted(pkg.concurrency.items()):
            for spawner_qual, call, target_qual in mc.thread_spawns:
                if target_qual is None:
                    continue
                out.extend(self._check_target(mc, rel, spawner_qual, call,
                                              target_qual))
        return out

    def _check_target(self, mc: ModuleConcurrency, rel: str,
                      spawner_qual: str, spawn_call: ast.Call,
                      target_qual: str) -> List[Finding]:
        out: List[Finding] = []
        thread_funcs = mc.thread_reachable(target_qual)
        spawner = mc.funcs.get(spawner_qual)
        target = mc.funcs.get(target_qual)
        if spawner is None or target is None:
            return out
        spawn_line = spawn_call.lineno
        # shared CLOSURE names: used in the thread set, local to the
        # spawner (the enclosing scope the closure captures)
        spawner_locals = spawner.locals_
        reported: Set[Tuple[str, str]] = set()
        for tq in sorted(thread_funcs):
            tfi = mc.funcs[tq]
            for held, kind, name, node in mc.mutations.get(tq, ()):
                if kind == "name":
                    if name in tfi.locals_ or name not in spawner_locals:
                        continue
                    main = self._main_accesses(mc, spawner_qual, "name",
                                               name, spawn_line)
                elif kind == "selfattr":
                    main = self._class_accesses(mc, name, thread_funcs)
                else:
                    continue
                if not main:
                    continue
                key = (tq, name)
                if key in reported:
                    continue
                unlocked_main = [n for h, n in main if not h]
                if held and not unlocked_main:
                    continue               # both sides locked
                reported.add(key)
                anchor, side = (node, "thread") if not held \
                    else (unlocked_main[0], "main")
                label = name.split(".")[-1]
                other = ("the spawning scope" if kind == "name"
                         else "another method")
                out.append(self.finding(
                    rel, anchor,
                    f"`{label}` is shared with thread target "
                    f"`{target.node.name}` (started near line "
                    f"{spawn_line}) and the {side}-side access holds no "
                    f"lock while {other} touches it too — guard both "
                    "sides with one threading.Lock, or justify the "
                    "ordering (join/barrier) with a pragma"))
        return out

    @staticmethod
    def _main_accesses(mc: ModuleConcurrency, spawner_qual: str,
                       kind: str, name: str,
                       spawn_line: int) -> List[Tuple[Tuple, ast.AST]]:
        got: List[Tuple[Tuple, ast.AST]] = []
        for held, k, n, node in (list(mc.loads.get(spawner_qual, ())) +
                                 list(mc.mutations.get(spawner_qual, ()))):
            if k == kind and n == name and node.lineno > spawn_line:
                got.append((held, node))
        return got

    @staticmethod
    def _class_accesses(mc: ModuleConcurrency, attr: str,
                        thread_funcs: Set[str]
                        ) -> List[Tuple[Tuple, ast.AST]]:
        got: List[Tuple[Tuple, ast.AST]] = []
        for qual, fi in mc.funcs.items():
            if qual in thread_funcs or fi.node.name == "__init__":
                continue
            for held, k, n, node in (list(mc.loads.get(qual, ())) +
                                     list(mc.mutations.get(qual, ()))):
                if k == "selfattr" and n == attr:
                    got.append((held, node))
        return got


# ---------------------------------------------------------------------------
# SIM103 — blocking calls under a lock


class BlockingUnderLockRule(PackageRule):
    """A blocking call made while holding a lock turns one slow peer into
    a stalled simulator: every other thread wanting the lock parks behind
    a wait the supervision watchdogs (PR 2) cannot preempt.  Condition
    waits on the HELD lock are exempt (wait releases it)."""

    id = "SIM103"
    severity = "warning"
    short = ("blocking call (recv/send/sleep/unbounded join/wait) while "
             "holding a lock")

    BLOCKING_ATTRS = {"recv", "recv_bytes", "send", "sendall", "send_bytes"}
    SUBPROCESS_FNS = {"subprocess.run", "subprocess.call",
                      "subprocess.check_call", "subprocess.check_output"}

    def run(self, pkg: PackageContext) -> List[Finding]:
        out: List[Finding] = []
        for rel, mc in sorted(pkg.concurrency.items()):
            for qual in mc.funcs:
                fi = mc.funcs[qual]
                for held, call in mc.calls.get(qual, ()):
                    if not held:
                        continue
                    msg = self._blocking_reason(mc, fi, call, held)
                    if msg is not None:
                        out.append(self.finding(
                            rel, call,
                            f"{msg} while holding "
                            f"`{held[-1].label()}` — blocking under a "
                            "lock stalls every thread contending for it; "
                            "move the wait outside the critical section"))
        return out

    def _blocking_reason(self, mc: ModuleConcurrency, fi: FuncInfo,
                         call: ast.Call, held: Tuple) -> Optional[str]:
        r = mc.ctx.resolve(call.func)
        canon = r[0] if r is not None else None
        if canon == "time.sleep":
            return "`time.sleep`"
        if canon in self.SUBPROCESS_FNS and \
                not any(kw.arg == "timeout" for kw in call.keywords):
            return f"unbounded `{canon}`"
        if canon == "select.select" and len(call.args) < 4:
            return "unbounded `select.select`"
        f = call.func
        if not isinstance(f, ast.Attribute):
            return None
        if f.attr in self.BLOCKING_ATTRS:
            return f"pipe/socket `.{f.attr}()`"
        bounded = bool(call.args) or \
            any(kw.arg == "timeout" for kw in call.keywords)
        if f.attr in ("join", "wait") and not bounded:
            if f.attr == "wait":
                lk = mc.resolve_lock(fi, f.value)
                if lk is not None and lk in held:
                    return None     # Condition.wait on the held lock
            return f"unbounded `.{f.attr}()`"
        return None


CATALOG: List[PackageRule] = [
    LockOrderRule(),
    ThreadSharedStateRule(),
    BlockingUnderLockRule(),
]


def _install_protocol_rule() -> None:
    # deferred: protocol.py imports PackageRule from this module, so the
    # SIM110 instance joins the catalog after both modules exist
    from .protocol import ShardProtocolRule
    if not any(r.id == "SIM110" for r in CATALOG):
        CATALOG.append(ShardProtocolRule())


_install_protocol_rule()
