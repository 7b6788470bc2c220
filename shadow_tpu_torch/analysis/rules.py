"""The simlint rule catalog (SIM001-SIM006).

Each rule guards one real invariant of this codebase — the docstrings name
the contract and the module(s) that own it.  Rules see through import
renames via ModuleContext.resolve (the shared alias tracker), so
``import time as _t; _t.monotonic()`` is caught, while the established
``_walltime`` / ``_wt`` aliases mark DELIBERATE wall-time (perf
telemetry — obs/, engine heartbeats, watchdogs).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from .simlint import Finding, ModuleContext, Rule

# the alias names that declare "this is wall-clock time, on purpose":
# telemetry code imports `time as _walltime` (module scope) or `time as
# _wt` (function scope) and the digest never sees the values
WALLTIME_ALIASES = ("_walltime", "_wt")


def _uses_convention_alias(root: str) -> bool:
    return root in WALLTIME_ALIASES


# ---------------------------------------------------------------------------
# SIM001 — wall-clock access


class WallClockRule(Rule):
    """Sim code must take time from the virtual clock (core/stime.py, the
    reference's SimulationTime) — a wall-clock read on a sim path makes
    event timing depend on host speed and breaks run-to-run digest parity.
    Wall-time for telemetry is declared via the ``_walltime``/``_wt``
    import alias or a [tool.simlint.allow] SIM001 module pattern."""

    id = "SIM001"
    severity = "error"
    short = ("wall-clock access in sim code (use core.stime / "
             "SimulationTime, or the _walltime/_wt alias for telemetry)")

    WALL_TIME_ATTRS = {
        "time", "time_ns", "monotonic", "monotonic_ns", "perf_counter",
        "perf_counter_ns", "process_time", "process_time_ns",
        "thread_time", "thread_time_ns", "clock_gettime",
        "clock_gettime_ns", "localtime", "gmtime",
    }
    WALL_DATETIME = {
        "datetime.datetime.now", "datetime.datetime.utcnow",
        "datetime.datetime.today", "datetime.date.today",
    }

    def run(self, ctx: ModuleContext) -> List[Finding]:
        out: List[Finding] = []
        for node in ctx.walk(ast.Attribute, ast.Name):
            if isinstance(node, ast.Attribute) and isinstance(
                    ctx.parent(node), ast.Attribute):
                continue                 # only the full chain, once
            r = ctx.resolve(node)
            if r is None:
                continue
            canon, root = r
            hit = None
            if canon.startswith("time.") and \
                    canon.split(".", 1)[1] in self.WALL_TIME_ATTRS:
                hit = canon
            elif canon in self.WALL_DATETIME:
                # resolve() canonicalizes every real import form
                # (`import datetime`, `from datetime import datetime/date`)
                # to these full dotted paths
                hit = canon
            if hit is None or _uses_convention_alias(root):
                continue
            out.append(self.finding(
                ctx, node,
                f"wall-clock access `{hit}` — sim code must use the "
                "virtual clock (core.stime); if this is deliberate "
                "telemetry, alias the import as "
                "`import time as _walltime` (or `_wt`)"))
        return out


# ---------------------------------------------------------------------------
# SIM002 — nondeterministic randomness


class NondetRandomRule(Rule):
    """Every random draw must derive from the master seed via the per-host
    stream tree (core/rng.py: master -> slave -> per-host, the reference's
    utility/random.c + master.c:417) or an explicitly seeded
    ``np.random.default_rng(seed)``.  Module-global RNG state, os.urandom
    and uuid4 give a different run every time."""

    id = "SIM002"
    severity = "error"
    short = ("nondeterministic randomness (use host.random streams or "
             "np.random.default_rng(seed))")

    # np.random attrs that are NOT the legacy global state
    NP_OK = {"default_rng", "Generator", "SeedSequence", "PCG64",
             "Philox", "MT19937", "SFC64", "BitGenerator", "RandomState"}
    # stdlib random attrs that construct seeded instances (fine)
    PY_OK = {"Random", "getstate", "setstate"}
    FLAT = {"os.urandom": "os.urandom",
            "uuid.uuid4": "uuid.uuid4 (random UUID)",
            "uuid.uuid1": "uuid.uuid1 (clock/MAC UUID)"}

    def run(self, ctx: ModuleContext) -> List[Finding]:
        out: List[Finding] = []
        for node in ctx.walk(ast.Attribute, ast.Name):
            if isinstance(node, ast.Attribute) and isinstance(
                    ctx.parent(node), ast.Attribute):
                continue
            r = ctx.resolve(node)
            if r is None:
                continue
            canon, _root = r
            msg = None
            if canon in self.FLAT:
                msg = (f"`{self.FLAT[canon]}` is nondeterministic — derive "
                       "ids/bytes from a host.random stream")
            elif canon.startswith("secrets."):
                msg = (f"`{canon}` draws from the OS entropy pool — "
                       "sim code must use seeded streams")
            elif canon.startswith("numpy.random."):
                attr = canon.split(".", 2)[2].split(".")[0]
                if attr not in self.NP_OK:
                    msg = (f"`np.random.{attr}` uses numpy's legacy global "
                           "RNG state — use np.random.default_rng(seed)")
            elif canon.startswith("random.") and not canon.startswith(
                    "random.Random."):
                attr = canon.split(".", 1)[1].split(".")[0]
                if attr not in self.PY_OK:
                    msg = (f"`random.{attr}` uses the module-global RNG — "
                           "use a host.random stream "
                           "(core/rng.py) or random.Random(seed)")
            if msg is not None:
                out.append(self.finding(ctx, node, msg))
        return out


# ---------------------------------------------------------------------------
# SIM003 — unordered iteration


def _set_env_for_scope(scope: ast.AST) -> Set[str]:
    """Names assigned (once, directly) a set-typed expression in ``scope``
    — a one-level local type inference, enough for the codebase idiom
    ``pending = set(...) ... for x in pending``."""
    env: Set[str] = set()
    unsafe: Set[str] = set()
    for node in ast.walk(scope):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name):
            name = node.targets[0].id
            if _is_set_expr(node.value, env):
                env.add(name)
            else:
                unsafe.add(name)
    return env - unsafe


def _is_set_expr(node: ast.AST, env: Set[str]) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) and \
            node.func.id in ("set", "frozenset"):
        return True
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
        if node.func.attr in ("union", "intersection", "difference",
                              "symmetric_difference") and \
                _is_set_expr(node.func.value, env):
            return True
    if isinstance(node, ast.BinOp) and isinstance(
            node.op, (ast.BitOr, ast.BitAnd, ast.Sub, ast.BitXor)):
        return _is_set_expr(node.left, env) or _is_set_expr(node.right, env)
    if isinstance(node, ast.Name):
        return node.id in env
    return False


def _is_keys_call(node: ast.AST) -> bool:
    return (isinstance(node, ast.Call) and not node.args and
            isinstance(node.func, ast.Attribute) and
            node.func.attr == "keys")


class UnorderedIterRule(Rule):
    """Set iteration order depends on PYTHONHASHSEED (fresh per process):
    anything it feeds — digests, event scheduling, shard/host assignment,
    user-visible reports — differs run to run.  Wrap in ``sorted(...)``
    or keep an insertion-ordered dict (``dict.fromkeys`` dedupes
    deterministically).  ``.keys()`` loops are flagged in the same
    contexts: iterate the dict itself (insertion-ordered) or sort."""

    id = "SIM003"
    severity = "warning"
    short = ("iteration over an unordered set / dict.keys() — wrap in "
             "sorted(...) where order matters")

    ORDER_SENSITIVE_CALLS = {"list", "tuple", "iter", "enumerate"}

    def run(self, ctx: ModuleContext) -> List[Finding]:
        out: List[Finding] = []
        # functions first (precise local env), the module tree last for
        # module-level code; `seen` dedupes the overlap
        scopes = [n for n in ctx.walk(ast.FunctionDef,
                                      ast.AsyncFunctionDef)] + [ctx.tree]
        seen: Set[Tuple[int, int]] = set()
        for scope in scopes:
            env = _set_env_for_scope(scope)
            for node in ast.walk(scope):
                iters: List[ast.AST] = []
                if isinstance(node, ast.For):
                    iters.append(node.iter)
                elif isinstance(node, (ast.ListComp, ast.SetComp,
                                       ast.DictComp, ast.GeneratorExp)):
                    iters.extend(g.iter for g in node.generators)
                elif isinstance(node, ast.Call):
                    fn = node.func
                    if isinstance(fn, ast.Name) and \
                            fn.id in self.ORDER_SENSITIVE_CALLS:
                        iters.extend(node.args)
                    elif isinstance(fn, ast.Attribute) and fn.attr == "join":
                        iters.extend(node.args)
                for it in iters:
                    key = (getattr(it, "lineno", 0),
                           getattr(it, "col_offset", 0))
                    if key in seen:
                        continue
                    if _is_set_expr(it, env):
                        seen.add(key)
                        out.append(self.finding(
                            ctx, it,
                            "iteration over an unordered set — order "
                            "varies with PYTHONHASHSEED; wrap in "
                            "sorted(...) (or dedupe with dict.fromkeys "
                            "to keep insertion order)"))
                    elif _is_keys_call(it):
                        seen.add(key)
                        out.append(self.finding(
                            ctx, it,
                            "iteration over .keys() — iterate the dict "
                            "itself (insertion-ordered) or sorted(...) "
                            "when the order feeds output or digests"))
        return out


# ---------------------------------------------------------------------------
# SIM004 — donated-buffer reuse


def _donate_positions(call: ast.Call) -> Optional[Set[int]]:
    """The donate_argnums literal from a jax.jit(...) call node, if any."""
    for kw in call.keywords:
        if kw.arg == "donate_argnums":
            v = kw.value
            if isinstance(v, ast.Tuple):
                pos = set()
                for elt in v.elts:
                    if isinstance(elt, ast.Constant) and \
                            isinstance(elt.value, int):
                        pos.add(elt.value)
                return pos
            if isinstance(v, ast.Constant) and isinstance(v.value, int):
                return {v.value}
            return set()        # dynamic expression: unknown positions
    return None


def _jit_call_info(node: ast.AST, ctx: ModuleContext
                   ) -> Optional[Set[int]]:
    """If ``node`` is a jax.jit(...)-or-partial(jax.jit, ...) expression,
    return its donated positions (empty set when donate_argnums absent)."""
    if not isinstance(node, ast.Call):
        return None
    r = ctx.resolve(node.func)
    if r is not None and r[0] in ("jax.jit", "jax.api.jit"):
        return _donate_positions(node) or set()
    if r is not None and r[0] in ("functools.partial", "partial") or (
            isinstance(node.func, ast.Name) and node.func.id == "partial"):
        if node.args:
            inner = ctx.resolve(node.args[0])
            if inner is not None and inner[0] in ("jax.jit", "jax.api.jit"):
                return _donate_positions(node) or set()
    return None


class DonatedReuseRule(Rule):
    """``donate_argnums`` hands the argument's device buffer to XLA: after
    the call the buffer may alias the OUTPUT (the device plane's dispatch
    path donates all 8 state tensors — ops/torcells_device.py).  Reading
    the Python variable afterwards observes undefined device memory on
    accelerators; jax only warns on some backends.  The variable must be
    rebound before any later read."""

    id = "SIM004"
    severity = "error"
    short = ("variable read after being donated to a jitted call "
             "(donate_argnums)")

    def _donated_names(self, ctx: ModuleContext) -> Dict[str, Set[int]]:
        donated: Dict[str, Set[int]] = {}
        for node in ctx.walk(ast.FunctionDef, ast.AsyncFunctionDef):
            for dec in node.decorator_list:
                pos = _jit_call_info(dec, ctx)
                if pos:
                    donated[node.name] = pos
        for node in ctx.walk(ast.Assign):
            if len(node.targets) == 1 and isinstance(node.targets[0],
                                                     ast.Name):
                val = node.value
                pos = _jit_call_info(val, ctx)
                # name = partial(jax.jit, donate_argnums=...)(fn) form
                if pos is None and isinstance(val, ast.Call):
                    pos = _jit_call_info(val.func, ctx)
                if pos:
                    donated[node.targets[0].id] = pos
        return donated

    @staticmethod
    def _call_donated_vars(call: ast.Call, pos: Set[int]) -> List[str]:
        names = []
        for i, arg in enumerate(call.args):
            if isinstance(arg, ast.Starred):
                # *state at or before a donated position: the unpacked
                # tuple covers donated slots — the tuple variable itself
                # must not be read afterwards
                if isinstance(arg.value, ast.Name) and any(p >= i
                                                           for p in pos):
                    names.append(arg.value.id)
            elif i in pos and isinstance(arg, ast.Name):
                names.append(arg.id)
        return names

    def run(self, ctx: ModuleContext) -> List[Finding]:
        donated = self._donated_names(ctx)
        if not donated:
            return []
        out: List[Finding] = []
        # module-level code (driver scripts) AND every function body, each
        # as its own scope — _check_body never descends into nested defs,
        # so names are tracked per scope and nothing is visited twice
        out.extend(self._check_body(ctx, ctx.tree.body, donated))
        for fn in ctx.walk(ast.FunctionDef, ast.AsyncFunctionDef):
            out.extend(self._check_body(ctx, fn.body, donated))
        return out

    @staticmethod
    def _walk_scope(node: ast.AST):
        """ast.walk that does not descend into nested function/class
        bodies — those are separate scopes checked on their own, and a
        donation of an inner `s` must not kill the outer `s`."""
        stack = [node]
        while stack:
            cur = stack.pop()
            yield cur
            for child in ast.iter_child_nodes(cur):
                if not isinstance(child, (ast.FunctionDef,
                                          ast.AsyncFunctionDef,
                                          ast.ClassDef, ast.Lambda)):
                    stack.append(child)

    def _check_body(self, ctx, body: List[ast.stmt],
                    donated: Dict[str, Set[int]], loop: bool = False
                    ) -> List[Finding]:
        out: List[Finding] = []
        for idx, stmt in enumerate(body):
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue                  # separate scope, checked by run()
            for call in self._walk_scope(stmt):
                if not (isinstance(call, ast.Call) and
                        isinstance(call.func, ast.Name) and
                        call.func.id in donated):
                    continue
                victims = self._call_donated_vars(call,
                                                  donated[call.func.id])
                if not victims:
                    continue
                dead = set(victims)
                # a same-statement rebind (out = f(state) with state in
                # targets) revives the name immediately — find the call's
                # NEAREST enclosing statement (the call may sit inside a
                # loop/if nested under `stmt`), not `stmt` itself
                near = ctx.parent(call)
                while near is not None and not isinstance(near, ast.stmt):
                    near = ctx.parent(near)
                if isinstance(near, ast.Assign):
                    for t in near.targets:
                        for n in ast.walk(t):
                            if isinstance(n, ast.Name):
                                dead.discard(n.id)
                self._scan_reads(ctx, body[idx + 1:], dead, call, out)
                if loop and dead:
                    # loop back edge: the next iteration re-executes the
                    # body from the top, so `for _ in r: out = step(s)`
                    # re-reads donated `s` — scan up to and INCLUDING the
                    # call statement (its value re-reads the donated arg;
                    # `s = step(s)` is safe because iteration N's targets
                    # already revived `s` above)
                    self._scan_reads(ctx, body[:idx + 1], dead, call, out)
            # recurse into nested suites so a donation inside an if-branch
            # is tracked within that branch; For/While bodies re-execute,
            # so their scans wrap around the back edge
            stmt_loops = isinstance(stmt, (ast.For, ast.AsyncFor,
                                           ast.While))
            for sub in (getattr(stmt, "body", None),
                        getattr(stmt, "orelse", None),
                        getattr(stmt, "finalbody", None)):
                if sub:
                    out.extend(self._check_body(
                        ctx, sub, donated,
                        loop=loop or (stmt_loops and sub is stmt.body)))
        return out

    def _scan_reads(self, ctx, stmts: List[ast.stmt], dead: Set[str],
                    call: ast.Call, out: List[Finding]) -> None:
        """Flag Loads of donated names over ``stmts`` in execution order,
        reviving a name at its first rebind (Store)."""
        for later in stmts:
            if not dead:
                return
            if isinstance(later, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                continue
            # an Assign evaluates its value BEFORE binding targets: walk
            # in that order so `state = g(state)` flags the read, not the
            # rebind
            if isinstance(later, ast.Assign):
                nodes = list(self._walk_scope(later.value)) + \
                    [n for t in later.targets
                     for n in self._walk_scope(t)]
            else:
                nodes = list(self._walk_scope(later))
            for n in nodes:
                if not isinstance(n, ast.Name) or n.id not in dead:
                    continue
                if isinstance(n.ctx, ast.Load):
                    out.append(self.finding(
                        ctx, n,
                        f"`{n.id}` was donated to jitted call "
                        f"`{call.func.id}` (donate_argnums) on "
                        f"line {call.lineno} and is read here — "
                        "the device buffer may be invalidated; "
                        "rebind it from the call's output or "
                        "copy before donating"))
                    dead.discard(n.id)
                else:
                    dead.discard(n.id)      # rebound: safe again


# ---------------------------------------------------------------------------
# SIM005 — blocking wall-time operations


class BlockingOpRule(Rule):
    """The engine's round loop, green threads (process/process.py) and
    plugin RPC serve loops are cooperative: one real ``time.sleep`` or an
    unbounded subprocess wait stalls EVERY simulated host, and the
    supervision watchdogs (ISSUE 2) exist precisely because such stalls
    froze runs.  Blocking calls must be bounded (timeout=) or live in
    allowlisted/justified telemetry code."""

    id = "SIM005"
    severity = "warning"
    short = ("blocking wall-time operation on a sim path (sleep / "
             "subprocess without timeout)")

    SUBPROCESS_FNS = {"subprocess.run", "subprocess.call",
                      "subprocess.check_call", "subprocess.check_output"}

    def run(self, ctx: ModuleContext) -> List[Finding]:
        out: List[Finding] = []
        for node in ctx.walk(ast.Call):
            r = ctx.resolve(node.func)
            if r is None:
                continue
            canon, _root = r
            if canon == "time.sleep":
                out.append(self.finding(
                    ctx, node,
                    "`time.sleep` blocks the whole sim process — "
                    "schedule a sim-time event (api.sleep / Task) "
                    "instead, or justify with a pragma"))
            elif canon in self.SUBPROCESS_FNS:
                if not any(kw.arg == "timeout" for kw in node.keywords):
                    out.append(self.finding(
                        ctx, node,
                        f"`{canon}` without timeout= can block the run "
                        "forever — every external wait must be bounded "
                        "(the plugin/pool watchdogs depend on it)"))
            elif canon == "socket.create_connection":
                if not (len(node.args) >= 2 or
                        any(kw.arg == "timeout" for kw in node.keywords)):
                    out.append(self.finding(
                        ctx, node,
                        "`socket.create_connection` without a timeout "
                        "can block the run forever — pass timeout="))
        return out


# ---------------------------------------------------------------------------
# SIM006 — side effects inside jit-traced functions


class JitSideEffectRule(Rule):
    """A jit-traced function's Python body runs ONCE at trace time; a
    print/log fires once (or never, on cache hit) and a closure mutation
    bakes stale state into the compiled program — both classic silent
    divergences between the device kernels (ops/) and their numpy twins.
    Tracing-time effects belong outside the jitted function."""

    id = "SIM006"
    severity = "error"
    short = ("side effect (print/logging/closure mutation) inside a "
             "jit-traced function")

    MUTATORS = {"append", "extend", "insert", "remove", "clear", "add",
                "update", "setdefault", "pop", "popitem"}

    def _jit_functions(self, ctx: ModuleContext) -> List[ast.FunctionDef]:
        jitted: List[ast.FunctionDef] = []
        wrapped_names: Set[str] = set()
        for node in ctx.walk(ast.Assign, ast.Call):
            call = node.value if isinstance(node, ast.Assign) else node
            if not isinstance(call, ast.Call):
                continue
            if _jit_call_info(call, ctx) is not None:
                # jax.jit(fn, ...) / partial(jax.jit, ...) — positional
                # function args are traced
                for arg in call.args:
                    if isinstance(arg, ast.Name):
                        wrapped_names.add(arg.id)
            elif _jit_call_info(call.func, ctx) is not None:
                # partial(jax.jit, ...)(fn): the ops/ idiom — the OUTER
                # call's args are the traced functions
                for arg in call.args:
                    if isinstance(arg, ast.Name):
                        wrapped_names.add(arg.id)
        for fn in ctx.walk(ast.FunctionDef, ast.AsyncFunctionDef):
            if fn.name in wrapped_names or any(
                    _jit_call_info(d, ctx) is not None or
                    (ctx.resolve(d) or ("",))[0] in ("jax.jit",)
                    for d in fn.decorator_list):
                jitted.append(fn)
        return jitted

    @staticmethod
    def _local_names(fn: ast.FunctionDef) -> Set[str]:
        local = {a.arg for a in fn.args.args + fn.args.kwonlyargs +
                 fn.args.posonlyargs}
        if fn.args.vararg:
            local.add(fn.args.vararg.arg)
        if fn.args.kwarg:
            local.add(fn.args.kwarg.arg)
        for node in ast.walk(fn):
            if isinstance(node, ast.Name) and isinstance(node.ctx,
                                                         ast.Store):
                local.add(node.id)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node is not fn:
                local.add(node.name)
        return local

    def run(self, ctx: ModuleContext) -> List[Finding]:
        out: List[Finding] = []
        for fn in self._jit_functions(ctx):
            local = self._local_names(fn)
            for node in ast.walk(fn):
                if node is fn:
                    continue
                if isinstance(node, ast.Call):
                    f = node.func
                    if isinstance(f, ast.Name) and f.id == "print":
                        out.append(self.finding(
                            ctx, node,
                            f"print() inside jit-traced `{fn.name}` runs "
                            "at trace time only — use jax.debug.print or "
                            "move it outside"))
                        continue
                    r = ctx.resolve(f)
                    if r is not None and (
                            r[0].startswith("logging.") or
                            r[0].endswith("logger.get_logger")):
                        out.append(self.finding(
                            ctx, node,
                            f"logging inside jit-traced `{fn.name}` fires "
                            "at trace time only — log at the call site"))
                        continue
                    if isinstance(f, ast.Attribute) and \
                            f.attr in self.MUTATORS and \
                            isinstance(f.value, ast.Name) and \
                            f.value.id not in local and \
                            f.value.id not in ctx.aliases:
                        out.append(self.finding(
                            ctx, node,
                            f"mutation of closed-over `{f.value.id}` "
                            f"inside jit-traced `{fn.name}` bakes "
                            "trace-time state into the compiled program"))
                elif isinstance(node, (ast.Assign, ast.AugAssign)):
                    targets = node.targets if isinstance(
                        node, ast.Assign) else [node.target]
                    for t in targets:
                        if isinstance(t, ast.Subscript) and \
                                isinstance(t.value, ast.Name) and \
                                t.value.id not in local:
                            out.append(self.finding(
                                ctx, t,
                                f"subscript assignment to closed-over "
                                f"`{t.value.id}` inside jit-traced "
                                f"`{fn.name}` is a trace-time side "
                                "effect (use .at[...].set())"))
        return out


CATALOG: List[Rule] = [
    WallClockRule(),
    NondetRandomRule(),
    UnorderedIterRule(),
    DonatedReuseRule(),
    BlockingOpRule(),
    JitSideEffectRule(),
]
