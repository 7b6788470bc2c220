"""SIM110 — the shard-protocol state-machine checker.

parallel/procs.py speaks a tag-based tuple protocol over multiprocessing
pipes: ``("run", ws, we)`` down, ``("out", boxes)`` up, and so on.  A tag
added on one side without a handler on the other, an arity change, or a
reordered round trip does not crash — it HANGS, and only the shard
watchdog turns that hang into a diagnostic.  This pass proves the
protocol at analysis time instead:

1. **extraction** — find the ``Process(target=f)`` spawn; compile the
   child side (``f`` plus the local functions it calls) and the parent
   side (the spawning function plus its local helpers) into small
   op-automata: SEND(tag, arity), RECV{tag -> branch, default}, END,
   ABORT.  ``conn.send(("tag", ...))`` is a SEND — and so is a literal
   tuple routed through a local send wrapper (``self._send(sid,
   ("tag", ...))`` where the wrapper's body sends a bound parameter:
   the self-healing controller wraps every parent-side send for death
   supervision); ``X = conn.recv()`` followed by ``if X[0] == "tag":``
   chains compiles into the RECV's branch table (the remaining
   statements are its default branch).  Calls to local
   functions/methods that (transitively) contain protocol ops are
   inlined; ``return`` is a function exit (jumping to the inline
   continuation, never a loop backedge).  When the ``Process`` spawn
   lives in a protocol-silent helper, the parent root hoists to the
   outermost local caller — the drive loop, not the fork.  Crash-retry
   guards (``if not sent[sid]: send; sent[sid] = True`` / ``if sid not
   in outs: outs[sid] = recv``) compile happy-path-unconditional: the
   flag starts false and flips only in the body, and the re-entry
   where it holds arrives via an except handler.  Fan-out over the
   connection list (``for c in conns: c.send(...)``, ``[recv(c) for c
   in conns]``) collapses to ONE logical peer — shards are symmetric.
   ``raise`` / ``os._exit`` are ABORT (crash states the shard
   supervision owns); sends inside ``except`` handlers register in the
   sent-tag set but stay out of the happy-path automaton.

2. **model check** — explore the product of the two automata with
   bounded message queues (sends never block on a pipe this small).
   Findings: a tag sent with no accepting branch on the peer recv; a
   subscript past the sent arity; a reachable mutual wait (both sides
   at RECV, both queues empty); a peer left at RECV after the other
   side ended CLEANLY.  A child that crashes (ABORT) while the parent
   waits is allowed — ``_recv_supervised`` exists exactly to catch it.

3. **coverage** — a tag a recv matches explicitly but no peer ever
   sends is drift in the other direction and is reported too.

The extraction is scoped to the statement shapes procs.py actually uses
(while/if/for/with/try, comprehension fan-outs, local-call inlining);
anything it cannot model is simply not modeled — the rule
under-approximates rather than guessing.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from .simlint import Finding, ModuleContext

MAX_PRODUCT_STATES = 50_000
QUEUE_BOUND = 8


# ---------------------------------------------------------------------------
# automaton nodes


class Node:
    __slots__ = ("kind", "tag", "arity", "branches", "branch_use",
                 "default", "succ", "use_idx", "node")

    def __init__(self, kind: str, ast_node: Optional[ast.AST] = None):
        self.kind = kind          # send | recv | branch | end | abort
        self.tag: Optional[str] = None
        self.arity: int = 0
        self.branches: Dict[str, "Node"] = {}
        self.branch_use: Dict[str, int] = {}  # per matched tag subscript
        self.default: Optional["Node"] = None
        self.succ: List["Node"] = []          # send/branch successors
        self.use_idx: int = 0                 # max subscript, default path
        self.node = ast_node                  # anchor for findings


class Automaton:
    def __init__(self, entry: Node, sent: Set[Tuple[str, int]],
                 matched: Dict[str, ast.AST]):
        self.entry = entry
        self.sent = sent          # every (tag, arity) incl. except-handlers
        self.matched = matched    # explicitly matched tag -> anchor node


class _Resume(ast.stmt):
    """Synthetic statement: a tag-branch body that falls through resumes
    the post-dispatch tail it was cut out of."""
    _fields = ()

    def __init__(self, rest, cont, loops, ret):
        super().__init__()
        self.rest = rest
        self.cont = cont
        self.loops = loops
        self.ret = ret


# ---------------------------------------------------------------------------
# extraction


class _SideExtractor:
    """Compile one side's protocol behavior into an automaton."""

    def __init__(self, ctx: ModuleContext, funcs: Dict[str, ast.AST],
                 root_qual: str):
        self.ctx = ctx
        self.funcs = funcs            # qualname -> FunctionDef (module-wide)
        self.root_qual = root_qual
        self.sent: Set[Tuple[str, int]] = set()
        self.matched: Dict[str, ast.AST] = {}
        self._inline_stack: List[str] = []
        self._has_ops_memo: Dict[str, bool] = {}

    # -- op recognition ----------------------------------------------------
    @staticmethod
    def _send_payload(call: ast.Call) -> Optional[Tuple[str, int]]:
        """(tag, arity) when ``call`` is ``X.send(("tag", ...))``."""
        if not (isinstance(call.func, ast.Attribute) and
                call.func.attr == "send" and len(call.args) == 1):
            return None
        arg = call.args[0]
        return _SideExtractor._literal_tag(arg)

    @staticmethod
    def _literal_tag(arg: ast.AST) -> Optional[Tuple[str, int]]:
        if isinstance(arg, ast.Tuple) and arg.elts and \
                isinstance(arg.elts[0], ast.Constant) and \
                isinstance(arg.elts[0].value, str):
            return arg.elts[0].value, len(arg.elts)
        return None

    def _wrapper_send_payload(self, call: ast.Call
                              ) -> Optional[Tuple[str, int]]:
        """(tag, arity) when ``call`` routes a literal tuple through a
        local send wrapper: ``self._send(sid, ("tag", ...))`` where the
        wrapper's body does ``X.send(msg)`` on a bound parameter (the
        self-healing controller wraps every parent-side send so pipe
        death is caught uniformly).  The literal payload is bound by
        parameter position, so the automaton sees the real tag."""
        qual = self._inlineable(call)
        if qual is None:
            return None
        fn = self.funcs[qual]
        params = [a.arg for a in fn.args.args]
        sent_param = None
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr == "send" and len(node.args) == 1 and \
                    isinstance(node.args[0], ast.Name) and \
                    node.args[0].id in params:
                sent_param = node.args[0].id
                break
        if sent_param is None:
            return None
        idx = params.index(sent_param)
        if isinstance(call.func, ast.Attribute):
            idx -= 1                       # self.X(...) binds `self`
        if 0 <= idx < len(call.args):
            return self._literal_tag(call.args[idx])
        return None

    @staticmethod
    def _is_recv_call(expr: ast.AST) -> Optional[ast.Call]:
        """The recv Call when ``expr`` is ``X.recv()`` / ``recv(c)`` —
        unwrapping one subscript (``recv(c)[1]``)."""
        if isinstance(expr, ast.Subscript):
            expr = expr.value
        if not isinstance(expr, ast.Call):
            return None
        f = expr.func
        if isinstance(f, ast.Attribute) and f.attr == "recv" and \
                not expr.args:
            return expr
        if isinstance(f, ast.Name) and f.id == "recv":
            return expr
        return None

    @staticmethod
    def _scope_walk(node: ast.AST):
        """Walk in document order without entering nested def bodies."""
        stack = [node]
        while stack:
            cur = stack.pop()
            yield cur
            if cur is not node and isinstance(
                    cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda, ast.ClassDef)):
                continue
            stack.extend(reversed(list(ast.iter_child_nodes(cur))))

    def _actions(self, stmt: ast.stmt) -> List[Tuple[str, ast.Call]]:
        """In-order protocol actions under one plain statement: direct
        send/recv ops plus inlineable local calls that transitively
        contain ops."""
        out: List[Tuple[str, ast.Call]] = []
        for node in self._scope_walk(stmt):
            if not isinstance(node, ast.Call):
                continue
            if self._send_payload(node) is not None or \
                    self._wrapper_send_payload(node) is not None:
                out.append(("send", node))
            elif self._is_recv_call(node) is not None:
                out.append(("recv", node))
            else:
                qual = self._inlineable(node)
                if qual is not None and self._has_protocol_ops(qual):
                    out.append(("inline", node))
        return out

    def _inlineable(self, call: ast.Call) -> Optional[str]:
        """Qualname of the local function this call resolves to: a bare
        Name matching a known def, or ``self.method``."""
        f = call.func
        name = None
        if isinstance(f, ast.Name):
            name = f.id
        elif isinstance(f, ast.Attribute) and \
                isinstance(f.value, ast.Name) and f.value.id == "self":
            name = f.attr
        if name is None:
            return None
        for qual in self.funcs:
            if (qual == name or qual.endswith(f".{name}")) and \
                    qual not in self._inline_stack:
                return qual
        return None

    def _has_protocol_ops(self, qual: str) -> bool:
        """Does ``qual`` (transitively through local calls) send/recv?"""
        memo = self._has_ops_memo.get(qual)
        if memo is not None:
            return memo
        self._has_ops_memo[qual] = False        # cycle guard
        fn = self.funcs[qual]
        result = False
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            if self._send_payload(node) is not None or \
                    self._is_recv_call(node) is not None:
                result = True
                break
            sub = self._inlineable(node)
            if sub is not None and sub != qual and \
                    self._has_protocol_ops(sub):
                result = True
                break
        self._has_ops_memo[qual] = result
        return result

    # -- compilation -------------------------------------------------------
    def build(self) -> Automaton:
        entry = self._compile_func(self.root_qual, Node("end"))
        return Automaton(entry, self.sent, self.matched)

    def _compile_func(self, qual: str, cont: Node) -> Node:
        self._inline_stack.append(qual)
        try:
            return self._compile_stmts(list(self.funcs[qual].body), cont,
                                       [], cont)
        finally:
            self._inline_stack.pop()

    def _compile_stmts(self, stmts: List[ast.stmt], cont: Node,
                       loops: List[Tuple[Node, Node]],
                       ret: Optional[Node] = None) -> Node:
        """Compile a statement list; ``loops`` is the (continue_target,
        break_target) stack and ``ret`` the enclosing function's exit
        continuation (``return`` jumps there — NOT the loop backedge;
        an unmodeled return inside ``_recv_supervised``'s watchdog loop
        would otherwise fall through into a phantom second recv)."""
        if not stmts:
            return cont
        stmt, rest = stmts[0], stmts[1:]

        if isinstance(stmt, _Resume):
            return self._compile_stmts(stmt.rest, stmt.cont, stmt.loops,
                                       stmt.ret)
        if isinstance(stmt, ast.Return):
            tail = ret if ret is not None else cont
            actions = self._actions(stmt)
            if actions:
                return self._chain_actions(stmt, actions, tail)
            return tail
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            # a nested def is a DEFINITION, not execution — its body only
            # enters the automaton where the function is called
            return self._compile_stmts(rest, cont, loops, ret)

        # -- msg = conn.recv() followed by tag-dispatch ifs ----------------
        recv_assign = self._recv_assignment(stmt)
        if recv_assign is not None:
            var, recv_expr = recv_assign
            node = Node("recv", stmt)
            use = self._recv_use_idx(recv_expr)
            # `x = conn.recv()[1]` binds the PAYLOAD, not the message
            # tuple — its subscripts/comparisons must not be mistaken
            # for tag dispatch or message-arity use
            is_whole_msg = not isinstance(recv_expr, ast.Subscript)
            tagvars = {var} if var and is_whole_msg else set()
            i = 0
            while i < len(rest):            # kind = msg[0] aliases
                alias = self._tag_alias(rest[i], tagvars)
                if alias is None:
                    break
                tagvars.add(alias)
                i += 1
            else_body = None
            while i < len(rest):            # if kind == "x": dispatch
                parsed = self._tag_branch(rest[i], tagvars)
                if parsed is None:
                    break
                branches, else_body = parsed
                for tag, body in branches:
                    self.matched.setdefault(tag, rest[i])
                    node.branch_use[tag] = self._max_use(list(body),
                                                         tagvars)
                    node.branches[tag] = self._compile_stmts(
                        list(body) + [_Resume(rest[i + 1:], cont, loops, ret)],
                        cont, loops, ret)
                i += 1
                if else_body is not None:
                    break       # the else IS the unknown-tag path
            if else_body is not None:
                node.default = self._compile_stmts(
                    list(else_body) + [_Resume(rest[i:], cont, loops, ret)],
                    cont, loops, ret)
                node.use_idx = max(use, self._max_use(list(else_body),
                                                      tagvars))
            else:
                node.default = self._compile_stmts(rest[i:], cont,
                                                   loops, ret)
                node.use_idx = max(use, self._max_use(rest[i:], tagvars))
            return node

        # -- control flow --------------------------------------------------
        if isinstance(stmt, ast.While):
            after = self._compile_stmts(rest, cont, loops, ret)
            header = Node("branch", stmt)
            body = self._compile_stmts(list(stmt.body), header,
                                       loops + [(header, after)], ret)
            # `while True:` only exits through break — a phantom exit
            # edge would let the model skip mandatory protocol turns
            infinite = isinstance(stmt.test, ast.Constant) and \
                bool(stmt.test.value)
            header.succ = [body] if infinite else [body, after]
            return header
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            # fan-out loop over the symmetric peer set: body ONCE
            after = self._compile_stmts(rest, cont, loops, ret)
            return self._compile_stmts(list(stmt.body), after,
                                       loops + [(after, after)], ret)
        if isinstance(stmt, ast.If):
            if self._retry_guard(stmt):
                # a crash-retry guard (`if not sent[sid]: send(...);
                # sent[sid] = True` / `if sid not in outs: outs[sid] =
                # recv(...)`) is ALWAYS taken on the happy path: its flag
                # starts false and flips only inside the body, and the
                # re-entry where it can be true arrives via an except
                # handler — a path the automaton already scopes out as
                # crash-state coverage.  Compiling it as a nondeterministic
                # branch would let the model skip a mandatory send yet
                # still reach the paired recv: a phantom mutual wait.
                return self._compile_stmts(list(stmt.body) + rest, cont,
                                           loops, ret)
            after = self._compile_stmts(rest, cont, loops, ret)
            br = Node("branch", stmt)
            br.succ = [self._compile_stmts(list(stmt.body), after, loops,
                                           ret),
                       self._compile_stmts(list(stmt.orelse), after, loops,
                                           ret)]
            return br
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            return self._compile_stmts(list(stmt.body) + rest, cont,
                                       loops, ret)
        if isinstance(stmt, ast.Try):
            # except-handler sends register as crash-path coverage only
            for h in stmt.handlers:
                for sub in ast.walk(h):
                    if isinstance(sub, ast.Call):
                        p = self._send_payload(sub) or \
                            self._wrapper_send_payload(sub)
                        if p is not None:
                            self.sent.add(p)
            return self._compile_stmts(
                list(stmt.body) + list(stmt.finalbody) + rest, cont, loops,
                ret)
        if isinstance(stmt, ast.Break):
            return loops[-1][1] if loops else cont
        if isinstance(stmt, ast.Continue):
            return loops[-1][0] if loops else cont
        if isinstance(stmt, ast.Raise):
            return Node("abort", stmt)
        if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call):
            r = self.ctx.resolve(stmt.value.func)
            if r is not None and r[0] in ("os._exit", "sys.exit"):
                return Node("abort", stmt)

        # -- plain statement: chain its protocol actions in order ----------
        actions = self._actions(stmt)
        if actions:
            return self._chain_actions(stmt, actions,
                                       self._compile_stmts(rest, cont,
                                                           loops, ret))
        return self._compile_stmts(rest, cont, loops, ret)

    def _chain_actions(self, stmt: ast.stmt,
                       actions: List[Tuple[str, ast.Call]],
                       cont: Node) -> Node:
        head = cont
        for kind, call in reversed(actions):
            if kind == "send":
                payload = self._send_payload(call) or \
                    self._wrapper_send_payload(call)
                n = Node("send", call)
                n.tag, n.arity = payload
                self.sent.add(payload)
                n.succ = [head]
                head = n
            elif kind == "recv":
                n = Node("recv", call)
                n.use_idx = self._subscript_on(stmt, call)
                n.default = head
                head = n
            else:                          # inline
                qual = self._inlineable(call)
                if qual is not None:
                    head = self._compile_func(qual, head)
        return head

    @staticmethod
    def _recv_use_idx(expr: ast.AST) -> int:
        if isinstance(expr, ast.Subscript) and \
                isinstance(expr.slice, ast.Constant) and \
                isinstance(expr.slice.value, int):
            return expr.slice.value
        return 0

    @staticmethod
    def _subscript_on(stmt: ast.stmt, call: ast.Call) -> int:
        for node in ast.walk(stmt):
            if isinstance(node, ast.Subscript) and node.value is call and \
                    isinstance(node.slice, ast.Constant) and \
                    isinstance(node.slice.value, int):
                return node.slice.value
        return 0

    def _recv_assignment(self, stmt: ast.stmt
                         ) -> Optional[Tuple[Optional[str], ast.AST]]:
        """``X = conn.recv()`` / ``X = conn.recv()[k]`` — the
        tag-dispatchable form (comprehension fan-outs bind lists and are
        handled as plain recv actions instead)."""
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 and \
                not self._contains_comprehension(stmt.value) and \
                self._is_recv_call(stmt.value) is not None:
            t = stmt.targets[0]
            return (t.id if isinstance(t, ast.Name) else None, stmt.value)
        return None

    @staticmethod
    def _contains_comprehension(expr: ast.AST) -> bool:
        return any(isinstance(n, (ast.ListComp, ast.SetComp,
                                  ast.GeneratorExp))
                   for n in ast.walk(expr))

    @staticmethod
    def _tag_alias(stmt: ast.stmt, tagvars: Set[str]) -> Optional[str]:
        """``kind = msg[0]`` -> 'kind'."""
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 and \
                isinstance(stmt.targets[0], ast.Name) and \
                isinstance(stmt.value, ast.Subscript) and \
                isinstance(stmt.value.value, ast.Name) and \
                stmt.value.value.id in tagvars and \
                isinstance(stmt.value.slice, ast.Constant) and \
                stmt.value.slice.value == 0:
            return stmt.targets[0].id
        return None

    @staticmethod
    def _tag_branch(stmt: ast.stmt, tagvars: Set[str]
                    ) -> Optional[Tuple[List[Tuple[str, List[ast.stmt]]],
                                        Optional[List[ast.stmt]]]]:
        """``if kind == "x": ...`` / ``if msg[0] == "x": ...`` (elif
        chains included) -> ([(tag, body)], else_body).  A trailing
        non-If ``else`` is the unknown-tag path — its body must enter
        the automaton (a raising else means "no handler"; a sending
        else registers its tags), never be silently dropped."""
        out: List[Tuple[str, List[ast.stmt]]] = []
        cur = stmt
        while isinstance(cur, ast.If):
            t = cur.test
            tag = None
            if isinstance(t, ast.Compare) and len(t.ops) == 1 and \
                    isinstance(t.ops[0], ast.Eq) and \
                    isinstance(t.comparators[0], ast.Constant) and \
                    isinstance(t.comparators[0].value, str):
                left = t.left
                if isinstance(left, ast.Name) and left.id in tagvars:
                    tag = t.comparators[0].value
                elif isinstance(left, ast.Subscript) and \
                        isinstance(left.value, ast.Name) and \
                        left.value.id in tagvars and \
                        isinstance(left.slice, ast.Constant) and \
                        left.slice.value == 0:
                    tag = t.comparators[0].value
            if tag is None:
                # a non-tag If mid-chain: the remaining chain (this If
                # included) is the default path — compile it there so
                # its sends/raises are never silently dropped
                return (out, [cur]) if out else None
            out.append((tag, list(cur.body)))
            if len(cur.orelse) == 1 and isinstance(cur.orelse[0], ast.If):
                cur = cur.orelse[0]
            elif cur.orelse:
                return out, list(cur.orelse)
            else:
                break
        return (out, None) if out else None

    @staticmethod
    def _expr_key(node: ast.AST) -> str:
        """Structural identity for guard/target matching, Load/Store
        context ignored (``run_sent[sid]`` tested vs assigned)."""
        import re
        return re.sub(r",?\s*ctx=(Load|Store|Del)\(\)", "",
                      ast.dump(node))

    @staticmethod
    def _retry_guard(stmt: ast.If) -> bool:
        """``if not flag[i]: ...; flag[i] = True`` or ``if k not in d:
        d[k] = ...`` with no else — the self-healing re-drive idiom (the
        body sets the very condition it tested, so the first reach on the
        happy path always executes it)."""
        if stmt.orelse:
            return False
        t = stmt.test
        key = _SideExtractor._expr_key
        if isinstance(t, ast.UnaryOp) and isinstance(t.op, ast.Not):
            flag = key(t.operand)
            for sub in stmt.body:
                for n in ast.walk(sub):
                    if isinstance(n, ast.Assign) and \
                            isinstance(n.value, ast.Constant) and \
                            n.value.value is True and \
                            any(key(tg) == flag for tg in n.targets):
                        return True
            return False
        if isinstance(t, ast.Compare) and len(t.ops) == 1 and \
                isinstance(t.ops[0], ast.NotIn) and \
                isinstance(t.comparators[0], ast.Name):
            needle, container = key(t.left), t.comparators[0].id
            for sub in stmt.body:
                for n in ast.walk(sub):
                    if isinstance(n, ast.Assign):
                        for tg in n.targets:
                            if isinstance(tg, ast.Subscript) and \
                                    isinstance(tg.value, ast.Name) and \
                                    tg.value.id == container and \
                                    key(tg.slice) == needle:
                                return True
        return False

    @staticmethod
    def _max_use(stmts: List[ast.stmt], tagvars: Set[str]) -> int:
        use = 0
        for stmt in stmts:
            for node in ast.walk(stmt):
                if isinstance(node, ast.Subscript) and \
                        isinstance(node.value, ast.Name) and \
                        node.value.id in tagvars and \
                        isinstance(node.slice, ast.Constant) and \
                        isinstance(node.slice.value, int):
                    use = max(use, node.slice.value)
        return use


# ---------------------------------------------------------------------------
# product model check


def _expand(node: Node, seen: Set[int]) -> List[Node]:
    """Skip over nondeterministic branch nodes to the reachable ops."""
    if id(node) in seen:
        return []
    seen.add(id(node))
    if node.kind != "branch":
        return [node]
    out: List[Node] = []
    for s in node.succ:
        out.extend(_expand(s, seen))
    return out


class _Check:
    def __init__(self, parent: Automaton, child: Automaton):
        self.parent = parent
        self.child = child
        self.findings: List[Tuple[str, ast.AST]] = []
        self._reported: Set[str] = set()

    def _report(self, key: str, msg: str, node: ast.AST) -> None:
        if key not in self._reported:
            self._reported.add(key)
            self.findings.append((msg, node))

    def run(self) -> List[Tuple[str, ast.AST]]:
        seen: Set[Tuple] = set()
        frontier = [(self.parent.entry, self.child.entry, (), ())]
        states = 0
        while frontier and states < MAX_PRODUCT_STATES:
            p, c, q_pc, q_cp = frontier.pop()
            for pn in _expand(p, set()):
                for cn in _expand(c, set()):
                    key = (id(pn), id(cn), q_pc, q_cp)
                    if key in seen:
                        continue
                    seen.add(key)
                    states += 1
                    frontier.extend(self._step(pn, cn, q_pc, q_cp))
        if frontier and states >= MAX_PRODUCT_STATES:
            # an exhausted budget must NOT read as "verified clean" —
            # unexplored interleavings could hide the very drift this
            # pass exists to catch
            self._report(
                "state-budget",
                f"protocol model check exhausted its "
                f"{MAX_PRODUCT_STATES}-state budget with interleavings "
                "unexplored — the protocol is too branchy to verify; "
                "simplify it or raise MAX_PRODUCT_STATES",
                self.parent.entry.node)
        return self.findings

    def _step(self, p: Node, c: Node, q_pc: Tuple,
              q_cp: Tuple) -> List[Tuple]:
        out: List[Tuple] = []
        progress = False
        if p.kind == "send" and len(q_pc) < QUEUE_BOUND:
            out.append((p.succ[0], c, q_pc + ((p.tag, p.arity, p.node),),
                        q_cp))
            progress = True
        if c.kind == "send" and len(q_cp) < QUEUE_BOUND:
            out.append((p, c.succ[0], q_pc,
                        q_cp + ((c.tag, c.arity, c.node),)))
            progress = True
        if p.kind == "recv" and q_cp:
            nxt = self._consume(p, q_cp[0], "parent")
            if nxt is not None:
                out.append((nxt, c, q_pc, q_cp[1:]))
            progress = True
        if c.kind == "recv" and q_pc:
            nxt = self._consume(c, q_pc[0], "child")
            if nxt is not None:
                out.append((p, nxt, q_pc[1:], q_cp))
            progress = True
        if not progress:
            self._stuck(p, c, q_pc, q_cp)
        return out

    def _consume(self, recv: Node, msg: Tuple, side: str) -> Optional[Node]:
        tag, arity, send_node = msg
        branch = recv.branches.get(tag)
        use = recv.branch_use.get(tag, 0) if branch is not None \
            else recv.use_idx
        if branch is None:
            # a default branch that immediately raises IS the
            # unknown-tag path — sending into it is a missing handler,
            # not a legitimate crash state
            if recv.default is None or recv.default.kind == "abort":
                self._report(
                    f"unhandled:{side}:{tag}",
                    f'tag "{tag}" is sent but the {side} recv at line '
                    f"{getattr(recv.node, 'lineno', '?')} has no handler "
                    "for it (protocol drift: this hangs at runtime)",
                    send_node)
                return None
            branch = recv.default
        if use >= arity:
            self._report(
                f"arity:{side}:{tag}",
                f'tag "{tag}" is sent with arity {arity} but the {side} '
                f"side reads element [{use}] — arity mismatch",
                send_node)
        return branch

    def _stuck(self, p: Node, c: Node, q_pc: Tuple, q_cp: Tuple) -> None:
        if q_pc or q_cp:
            return                # a message is in flight; not a wait
        if p.kind == "recv" and c.kind == "recv":
            self._report(
                "deadlock", "reachable mutual wait: parent and child are "
                "both blocked in recv with no message in flight — the "
                "round-trip ordering is inconsistent", p.node)
        elif p.kind == "recv" and c.kind == "end":
            self._report(
                "parent-hang", "child can finish cleanly while the "
                "parent still waits in recv — a reply or final message "
                "is missing from the child side", p.node)
        elif c.kind == "recv" and p.kind == "end":
            self._report(
                "child-hang", "parent can finish cleanly while the "
                "child still waits in recv — the stop tag never "
                "reaches it", c.node)


# ---------------------------------------------------------------------------
# the rule


class ShardProtocolRule:
    """Prove the parent<->shard tag protocol round-trips (see the module
    docstring): every sent tag handled, arities match, no reachable
    mutual wait, no handler for a tag nobody sends.

    Duck-typed against race_rules.PackageRule (not imported — this
    module must load standalone to avoid an import cycle with the
    catalog installation)."""

    id = "SIM110"
    severity = "error"
    short = ("shard-protocol drift: sent tag without a handler, arity "
             "mismatch, or inconsistent round-trip ordering")

    def finding(self, relpath: str, node: ast.AST,
                message: str) -> Finding:
        return Finding(self.id, self.severity, relpath,
                       getattr(node, "lineno", 1),
                       getattr(node, "col_offset", 0), message)

    def run(self, pkg) -> List[Finding]:
        out: List[Finding] = []
        for rel, mc in sorted(pkg.concurrency.items()):
            pair = self._find_pair(mc)
            if pair is None:
                continue
            out.extend(self.check_module(mc.ctx, *pair))
        return out

    @staticmethod
    def _find_pair(mc) -> Optional[Tuple[str, str]]:
        """(parent_qual, child_qual) when this module spawns a
        ``Process(target=f)`` whose target is a local function."""
        ctx = mc.ctx
        for node in ctx.walk(ast.Call):
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) else (
                f.id if isinstance(f, ast.Name) else None)
            if name != "Process":
                continue
            target = next((kw.value for kw in node.keywords
                           if kw.arg == "target"), None)
            if not isinstance(target, ast.Name):
                continue
            child = next((q for q in sorted(mc.funcs)
                          if q == target.id or
                          q.endswith(f".{target.id}")), None)
            if child is None:
                continue
            fn = ctx.enclosing_function(node)
            if fn is None:
                continue
            parent = next((q for q, fi in mc.funcs.items()
                           if fi.node is fn), None)
            if parent is None:
                continue
            return ShardProtocolRule._hoist_root(mc, parent, child), child
        return None

    @staticmethod
    def _hoist_root(mc, parent: str, child: str) -> str:
        """Root the parent automaton at the OUTERMOST local caller of the
        spawning function.  The self-healing controller moved the
        ``Process(...)`` call into a respawn helper (``_spawn``) that is
        itself protocol-silent; the conversation lives in the drive loop
        that (transitively) calls it.  Hoisting walks the local call
        graph upward and picks the unique caller no other caller reaches;
        when the spawn already sits in the driver (no local callers),
        this is the identity."""
        edges: Dict[str, Set[str]] = {}
        for q, fi in mc.funcs.items():
            out: Set[str] = set()
            for node in ast.walk(fi.node):
                if not isinstance(node, ast.Call):
                    continue
                f = node.func
                name = None
                if isinstance(f, ast.Name):
                    name = f.id
                elif isinstance(f, ast.Attribute) and \
                        isinstance(f.value, ast.Name) and \
                        f.value.id == "self":
                    name = f.attr
                if name is None:
                    continue
                for q2 in mc.funcs:
                    if q2 == name or q2.endswith(f".{name}"):
                        out.add(q2)
            edges[q] = out
        callers = {parent}
        changed = True
        while changed:
            changed = False
            for q, out in edges.items():
                if q != child and q not in callers and out & callers:
                    callers.add(q)
                    changed = True
        roots = [q for q in sorted(callers)
                 if not any(q in edges[o] for o in sorted(callers)
                            if o != q)]
        return roots[0] if len(roots) == 1 else parent

    def check_module(self, ctx: ModuleContext, parent_qual: str,
                     child_qual: str) -> List[Finding]:
        """Extract + model-check one module's protocol pair (also the
        fixture entry point used by the tests)."""
        funcs: Dict[str, ast.AST] = {}
        for node in ctx.walk(ast.FunctionDef, ast.AsyncFunctionDef):
            names = [node.name]
            cur = ctx.parent(node)
            while cur is not None:
                if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                                    ast.ClassDef)):
                    names.append(cur.name)
                cur = ctx.parent(cur)
            funcs[".".join(reversed(names))] = node
        parent = _SideExtractor(ctx, funcs, parent_qual).build()
        child = _SideExtractor(ctx, funcs, child_qual).build()
        findings: List[Finding] = []
        for msg, node in _Check(parent, child).run():
            findings.append(self.finding(ctx.relpath, node, msg))
        # drift in the other direction: matched-but-never-sent tags
        child_tags = {t for t, _ in child.sent}
        parent_tags = {t for t, _ in parent.sent}
        for tag, node in sorted(parent.matched.items()):
            if tag not in child_tags:
                findings.append(self.finding(
                    ctx.relpath, node,
                    f'parent matches tag "{tag}" but the child never '
                    "sends it — stale handler (protocol drift)"))
        for tag, node in sorted(child.matched.items()):
            if tag not in parent_tags:
                findings.append(self.finding(
                    ctx.relpath, node,
                    f'child matches tag "{tag}" but the parent never '
                    "sends it — stale handler (protocol drift)"))
        return findings
