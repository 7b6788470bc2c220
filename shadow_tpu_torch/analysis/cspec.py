"""cspec: a lightweight protocol-spec extractor for the C data plane.

The native twin (``native/dataplane.cc``, ``native/retransmit_tally.cc``)
is a hand transcription of the Python protocol modules; simtwin diffs the
two (plus the JAX kernel family) against ONE extracted IR.  This module is
the C side of that extraction: regex + brace matching only — no libclang,
no compiler, nothing the container doesn't already have — tuned to the
subset of C++ the data plane actually uses.

What it pulls out of a translation unit:

* **constants** — ``constexpr T NAME = EXPR;`` / ``#define NAME EXPR`` /
  ``const int NAME[n] = {...};`` with the expressions *evaluated* (suffix-
  stripped and folded through the same arithmetic evaluator the Python
  extractor uses), so ``RTO_INIT = 1000 * SIM_MS`` compares as the integer
  nanosecond value, not as a token string;
* **enums** — named and anonymous, implicit-increment members evaluated;
  an enum whose members are ``ST_*`` is the TCP state universe;
* **functions / structs** — every defined symbol, for the SIM203 surface
  map;
* **state transitions** — each ``...->state = ST_X`` assignment paired
  with the states named by its *enclosing* ``if`` guards (conditions are
  attributed to their if-block or single guarded statement only — never to
  an ``else`` body), mirroring the Python AST walk in twin_rules so a
  faithful transcription produces the identical (from, to) table;
* **probes** — per-canonical regex probes for update coefficients that are
  spelled inline (RTT gains, ssthresh math, CUBIC C/beta, thresholds);
* **pragmas** — ``// simtwin: disable=SIM2xx -- why`` suppression comments
  with the same reason-required / stale-is-a-finding semantics as the
  Python pragma machinery.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

# ---------------------------------------------------------------------------
# expression folding (shared shape with twin_rules._fold: C constant
# expressions in this codebase are valid Python arithmetic once the integer
# suffixes and casts are stripped)

# the whole numeric literal is matched (hex digits greedily — a trailing
# F in 0xFF is a DIGIT, not a float suffix; hex ints take no f suffix in
# C) and only the real type-suffix tail is stripped
_NUM_SUFFIX_RE = re.compile(
    r"\b(0[xX][0-9a-fA-F]+|(?:\d+\.\d*|\.\d+|\d+))[uUlLfF]*")
_CAST_RE = re.compile(r"\(\s*(?:u?int(?:8|16|32|64)_t|double|float|int|long"
                      r"|unsigned|size_t|char)\s*\)")


def eval_c_expr(expr: str, env: Dict[str, object]) -> Optional[object]:
    """Evaluate a C constant expression with ``env`` providing previously
    defined constant values.  Returns None when it doesn't fold."""
    text = _CAST_RE.sub(
        "", _NUM_SUFFIX_RE.sub(lambda m: m.group(1), expr)).strip()
    try:
        tree = ast.parse(text, mode="eval")
    except SyntaxError:
        return None
    return _fold_pyast(tree.body, env)


def _fold_pyast(node: ast.AST, env: Dict[str, object]) -> Optional[object]:
    if isinstance(node, ast.Constant) and isinstance(node.value, (int, float)):
        return node.value
    if isinstance(node, ast.Name):
        return env.get(node.id)
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        v = _fold_pyast(node.operand, env)
        return -v if isinstance(v, (int, float)) else None
    if isinstance(node, ast.BinOp):
        a = _fold_pyast(node.left, env)
        b = _fold_pyast(node.right, env)
        if not isinstance(a, (int, float)) or not isinstance(b, (int, float)):
            return None
        try:
            if isinstance(node.op, ast.Add):
                return a + b
            if isinstance(node.op, ast.Sub):
                return a - b
            if isinstance(node.op, ast.Mult):
                return a * b
            if isinstance(node.op, ast.Div):
                # C integer division truncates; both operands int => int
                if isinstance(a, int) and isinstance(b, int):
                    return a // b
                return a / b
            if isinstance(node.op, ast.FloorDiv):
                return a // b
            if isinstance(node.op, ast.Mod):
                return a % b
            if isinstance(node.op, ast.LShift):
                return a << b
            if isinstance(node.op, ast.RShift):
                return a >> b
            if isinstance(node.op, ast.BitOr):
                return a | b
            if isinstance(node.op, ast.BitAnd):
                return a & b
            if isinstance(node.op, ast.BitXor):
                return a ^ b
        except (ZeroDivisionError, TypeError, ValueError):
            return None
    return None


# ---------------------------------------------------------------------------
# comment stripping (line numbers preserved) + pragma collection

_PRAGMA_RE = re.compile(
    r"//\s*sim(?:lint|race|twin):\s*disable=([A-Za-z0-9_,\s]*?)"
    r"\s*(?:--\s*(.*))?$")


@dataclass
class CPragma:
    rule: str
    reason: str
    target: int      # line the pragma covers
    line: int
    col: int
    used: bool = False


def strip_comments(text: str) -> Tuple[str, List[Tuple[int, int, str]]]:
    """Blank out // and /* */ comments (and string/char literals) while
    preserving every newline, so downstream regex line numbers are real.
    Returns (stripped_text, [(line, col, comment_text)] for // comments)."""
    out: List[str] = []
    comments: List[Tuple[int, int, str]] = []
    i, n = 0, len(text)
    line, col = 1, 0
    while i < n:
        c = text[i]
        two = text[i:i + 2]
        if two == "//":
            j = text.find("\n", i)
            j = n if j < 0 else j
            comments.append((line, col, text[i:j]))
            out.append(" " * (j - i))
            col += j - i
            i = j
            continue
        if two == "/*":
            j = text.find("*/", i + 2)
            j = n if j < 0 else j + 2
            seg = text[i:j]
            out.append(re.sub(r"[^\n]", " ", seg))
            line += seg.count("\n")
            nl = seg.rfind("\n")
            col = (len(seg) - nl - 1) if nl >= 0 else col + len(seg)
            i = j
            continue
        if c in "\"'":
            quote = c
            j = i + 1
            while j < n:
                if text[j] == "\\":
                    j += 2
                    continue
                if text[j] == quote:
                    j += 1
                    break
                if text[j] == "\n":
                    break
                j += 1
            out.append(quote + " " * (j - i - 2 if j - i >= 2 else 0)
                       + (quote if j > i + 1 else ""))
            col += j - i
            i = j
            continue
        out.append(c)
        if c == "\n":
            line += 1
            col = 0
        else:
            col += 1
        i += 1
    return "".join(out), comments


def collect_c_pragmas(text: str, known_ids: Set[str]
                      ) -> Tuple[List[CPragma], List[Tuple[int, int, str]]]:
    """(pragmas, malformed) from // comments.  ``malformed`` entries are
    (line, col, message) — the caller turns them into SIM000 findings.
    A comment-only line covers the NEXT line; a trailing comment covers
    its own line (same convention as the Python tokenizer path)."""
    _, comments = strip_comments(text)
    lines = text.splitlines()
    pragmas: List[CPragma] = []
    bad: List[Tuple[int, int, str]] = []
    for ln, col, ctext in comments:
        m = _PRAGMA_RE.search(ctext)
        if not m:
            continue
        ids = [s.strip().upper() for s in m.group(1).split(",") if s.strip()]
        reason = (m.group(2) or "").strip()
        pcol = col + m.start()
        if not ids:
            bad.append((ln, pcol, "suppression pragma names no rule ids"))
            continue
        unknown = [r for r in ids if r not in known_ids]
        if unknown:
            bad.append((ln, pcol, "suppression pragma names unknown rule(s) "
                        + ", ".join(unknown)))
        if not reason:
            bad.append((ln, pcol, "suppression pragma is missing its reason "
                        "— justify it: // simtwin: disable="
                        f"{','.join(ids)} -- <why>"))
            continue
        standalone = (ln <= len(lines)
                      and not lines[ln - 1][:col].strip())
        target = ln + 1 if standalone else ln
        for rid in ids:
            if rid in known_ids:
                pragmas.append(CPragma(rid, reason, target, ln, pcol))
    return pragmas, bad


# ---------------------------------------------------------------------------
# the extraction result

@dataclass
class CExtract:
    path: str
    constants: Dict[str, Tuple[object, int]] = field(default_factory=dict)
    enums: Dict[str, List[Tuple[str, int, int]]] = field(default_factory=dict)
    symbols: Dict[str, int] = field(default_factory=dict)
    transitions: List[Tuple[str, str, int]] = field(default_factory=list)
    probes: Dict[str, Tuple[object, int]] = field(default_factory=dict)
    states: List[str] = field(default_factory=list)

    def env(self) -> Dict[str, object]:
        e = {k: v for k, (v, _) in self.constants.items()}
        for members in self.enums.values():
            for name, val, _ in members:
                e[name] = val
        return e


_CONSTEXPR_RE = re.compile(
    r"^\s*(?:static\s+)?constexpr\s+[\w:<>\s]+?\b([A-Za-z_]\w*\s*=\s*"
    r"[^;{]+);", re.M)
_DEFINE_RE = re.compile(r"^\s*#\s*define\s+([A-Za-z_]\w*)\s+(.+?)\s*$", re.M)
# arrays: `const int X[8] = {...};` and the constexpr spelling the
# simgen-generated regions use; bodies may span lines ([^}]* crosses \n)
_ARRAY_RE = re.compile(
    r"^\s*(?:static\s+)?const(?:expr)?\s+[\w\s]+?\b([A-Za-z_]\w*)"
    r"\s*\[\s*\d*\s*\]\s*=\s*\{([^}]*)\}\s*;", re.M)
_ENUM_RE = re.compile(r"\benum\s+([A-Za-z_]\w*)?\s*\{([^}]*)\}", re.S)
_FUNC_RE = re.compile(
    r"^[ \t]*(?:[A-Za-z_][\w:<>,*&\s]*?[\s*&])?([A-Za-z_]\w*)\s*"
    r"\(([^;{}]*)\)\s*(?:const\s*)?\{", re.M)
_STRUCT_RE = re.compile(r"^\s*struct\s+([A-Za-z_]\w*)\s*[:{]", re.M)

_KEYWORDS = {"if", "else", "for", "while", "switch", "return", "sizeof",
             "do", "case", "new", "delete", "catch"}


def _split_toplevel_commas(text: str) -> List[str]:
    out, depth, start = [], 0, 0
    for i, c in enumerate(text):
        if c in "([":
            depth += 1
        elif c in ")]":
            depth -= 1
        elif c == "," and depth == 0:
            out.append(text[start:i])
            start = i + 1
    out.append(text[start:])
    return out


def _line_of(text: str, pos: int) -> int:
    return text.count("\n", 0, pos) + 1


def extract(path: str, text: str,
            probe_patterns: Optional[Dict[str, object]] = None) -> CExtract:
    """Run the whole extraction over one C/C++ source file."""
    stripped, _ = strip_comments(text)
    out = CExtract(path)
    env: Dict[str, object] = {}

    # declarations are folded in TEXTUAL order (a constexpr may reference
    # an earlier #define and vice versa), and line attribution uses the
    # NAME group's position — the leading ``^\s*`` can swallow preceding
    # blank/blanked-comment lines across newlines, which made constants
    # drift to the line of whatever sat above them (e.g. a generated
    # fenced region's marker) whenever that region changed length
    decls: List[Tuple[int, str, "re.Match"]] = []
    for m in _CONSTEXPR_RE.finditer(stripped):
        decls.append((m.start(1), "constexpr", m))
    for m in _DEFINE_RE.finditer(stripped):
        decls.append((m.start(1), "define", m))
    for m in _ARRAY_RE.finditer(stripped):
        decls.append((m.start(1), "array", m))
    for pos, kind, m in sorted(decls, key=lambda d: d[0]):
        line = _line_of(stripped, pos)
        if kind == "constexpr":
            # one declaration may bind several names:
            # `constexpr int A = 1, B = 2;`
            for decl in _split_toplevel_commas(m.group(1)):
                name, _, expr = decl.partition("=")
                name = name.strip()
                if not name or not expr:
                    continue
                val = eval_c_expr(expr, env)
                if val is not None:
                    env[name] = val
                    out.constants[name] = (val, line)
        elif kind == "define":
            name, expr = m.group(1), m.group(2)
            val = eval_c_expr(expr, env)
            if val is not None:
                env[name] = val
                out.constants[name] = (val, line)
        else:
            name, body = m.group(1), m.group(2)
            vals = []
            for item in body.split(","):
                item = item.strip()
                if not item:
                    continue           # trailing comma / blank item
                v = eval_c_expr(item, env)
                if v is None:
                    vals = None
                    break
                vals.append(v)
            if vals:
                env[name] = vals
                out.constants[name] = (vals, line)

    for m in _ENUM_RE.finditer(stripped):
        ename = m.group(1) or ""
        members: List[Tuple[str, int, int]] = []
        nxt = 0
        base_line = _line_of(stripped, m.start())
        for item in m.group(2).split(","):
            item = item.strip()
            if not item:
                continue
            if "=" in item:
                name, _, expr = item.partition("=")
                name = name.strip()
                v = eval_c_expr(expr.strip(), env)
                if v is None:
                    continue
                nxt = int(v)
            else:
                name = item
            members.append((name, nxt, base_line))
            env[name] = nxt
            nxt += 1
        if members:
            out.enums[ename or f"@{base_line}"] = members
            # the TCP state universe: an enum of ST_* members
            if all(n.startswith("ST_") for n, _, _ in members):
                out.states = [n[3:].lower() for n, _, _ in members]

    for m in _STRUCT_RE.finditer(stripped):
        out.symbols.setdefault(m.group(1), _line_of(stripped, m.start()))
    for m in _FUNC_RE.finditer(stripped):
        name = m.group(1)
        if name in _KEYWORDS:
            continue
        out.symbols.setdefault(name, _line_of(stripped, m.start()))

    out.transitions = _extract_transitions(stripped)

    for canon, pattern in (probe_patterns or {}).items():
        hit = _run_probe(stripped, pattern, env)
        if hit is not None:
            out.probes[canon] = hit
    return out


def _run_probe(stripped: str, pattern, env) -> Optional[Tuple[object, int]]:
    """A probe is (regex, combine) — regex capture groups are evaluated
    through ``env``; ``combine`` folds all matches into one value:
    'one' / 'pair' (all matches must agree; a disagreement returns the
    list of distinct spellings so the comparator sees UNEQUAL values and
    reports drift, instead of the canon silently vanishing from this
    plane), 'max', 'set' (sorted uniques)."""
    regex, combine = pattern
    vals: List[object] = []
    first_line = None
    for m in re.finditer(regex, stripped):
        if first_line is None:
            first_line = _line_of(stripped, m.start())
        groups = [eval_c_expr(g, env) for g in m.groups() if g is not None]
        if any(g is None for g in groups):
            return None
        vals.append(groups[0] if len(groups) == 1 else groups)
    if not vals:
        return None
    if combine in ("one", "pair"):
        if len(set(map(repr, vals))) == 1:
            return (vals[0], first_line)
        distinct: List[object] = []
        for v in vals:                 # text order — deterministic
            if v not in distinct:
                distinct.append(v)
        return (distinct, first_line)
    if combine == "max":
        return (max(vals), first_line)
    if combine == "set":
        return (sorted(set(vals)), first_line)
    return None


# ---------------------------------------------------------------------------
# logic-function read-back (ISSUE 19): parse the generator's
# ``static inline int64_t gen_<name>(...) { return <expr>; }`` bodies
# back into logic IR so SIM206 / simgen's readback can structurally
# compare them against the spec.  Comments inside the expression are
# blanked by strip_comments first, so a comment-split expression parses
# the same as a one-liner; identity casts like ``(int64_t)`` are
# stripped (every IR value is int64 by contract).

_LOGIC_FN_RE = re.compile(
    r"static\s+inline\s+int64_t\s+gen_([A-Za-z_]\w*)\s*\(([^)]*)\)\s*"
    r"\{\s*return\s+(.*?);\s*\}", re.S)
# the two call-shaped min/max helpers the emitter leans on — they match
# the function regex but are vocabulary, not logic functions
_LOGIC_HELPERS = {"i64_min", "i64_max"}

_C_TOK_RE = re.compile(
    r"\s*(?:(?P<num>0[xX][0-9a-fA-F]+[uUlL]*|\d+[uUlL]*)"
    r"|(?P<name>[A-Za-z_]\w*)"
    r"|(?P<op><<|>>|<=|>=|==|!=|[-+*/%<>?:(),]))")

_C_CMP_OPS = {"==": "eq", "!=": "ne", "<": "lt", "<=": "le",
              ">": "gt", ">=": "ge"}
_C_MUL_OPS = {"*": "mul", "/": "floordiv", "%": "mod"}
_C_ADD_OPS = {"+": "add", "-": "sub"}
_C_SHIFT_OPS = {"<<": "shl", ">>": "shr"}


class CExprError(ValueError):
    pass


def _c_tokens(text: str) -> List[str]:
    toks: List[str] = []
    pos = 0
    while pos < len(text):
        m = _C_TOK_RE.match(text, pos)
        if not m or m.end() == pos:
            rest = text[pos:].strip()
            if not rest:
                break
            raise CExprError(f"unexpected token at {rest[:20]!r}")
        pos = m.end()
        toks.append(m.group("num") or m.group("name") or m.group("op"))
    return toks


class _CExprParser:
    """Recursive descent over the emitted C expression subset, with real
    C precedence (mul > add > shift > relational > equality > ternary) so
    hand-edited spellings still parse to the tree they mean."""

    def __init__(self, toks: List[str]):
        self.toks = toks
        self.i = 0

    def peek(self) -> Optional[str]:
        return self.toks[self.i] if self.i < len(self.toks) else None

    def take(self, want: Optional[str] = None) -> str:
        tok = self.peek()
        if tok is None:
            raise CExprError("unexpected end of expression")
        if want is not None and tok != want:
            raise CExprError(f"expected {want!r}, got {tok!r}")
        self.i += 1
        return tok

    def parse(self):
        ir = self.ternary()
        if self.peek() is not None:
            raise CExprError(f"trailing tokens at {self.peek()!r}")
        return ir

    def ternary(self):
        cond = self.equality()
        if self.peek() != "?":
            return cond
        self.take("?")
        t = self.ternary()
        self.take(":")
        f = self.ternary()
        if not (isinstance(cond, list) and cond[0] in _C_CMP_OPS.values()):
            raise CExprError("ternary condition must be a comparison")
        return ["select", cond, t, f]

    def _binchain(self, ops: Dict[str, str], sub):
        ir = sub()
        while self.peek() in ops:
            op = ops[self.take()]
            ir = [op, ir, sub()]
        return ir

    def equality(self):
        return self._binchain({"==": "eq", "!=": "ne"}, self.relational)

    def relational(self):
        return self._binchain({"<": "lt", "<=": "le", ">": "gt",
                               ">=": "ge"}, self.shift)

    def shift(self):
        return self._binchain(_C_SHIFT_OPS, self.additive)

    def additive(self):
        return self._binchain(_C_ADD_OPS, self.multiplicative)

    def multiplicative(self):
        return self._binchain(_C_MUL_OPS, self.primary)

    def primary(self):
        tok = self.take()
        if tok == "(":
            ir = self.ternary()
            self.take(")")
            return ir
        if re.fullmatch(r"0[xX][0-9a-fA-F]+[uUlL]*|\d+[uUlL]*", tok):
            return int(tok.rstrip("uUlL"), 0)
        if not re.fullmatch(r"[A-Za-z_]\w*", tok):
            raise CExprError(f"unexpected token {tok!r}")
        if self.peek() != "(":
            return tok                     # argument reference
        self.take("(")
        args = [self.ternary()]
        while self.peek() == ",":
            self.take(",")
            args.append(self.ternary())
        self.take(")")
        if tok in ("gen_i64_min", "gen_i64_max") and len(args) == 2:
            return [tok[len("gen_i64_"):], args[0], args[1]]
        raise CExprError(f"unsupported call {tok!r}")


def parse_c_expr(text: str):
    """One C expression -> logic IR.  Raises :class:`CExprError` when the
    spelling falls outside the portable vocabulary."""
    return _CExprParser(_c_tokens(_CAST_RE.sub("", text))).parse()


def parse_c_logic_functions(text: str
                            ) -> Dict[str, Tuple[List[str], object, int]]:
    """Extract every emitted logic function from a C translation unit:
    ``{logic_name: (arg_names, ir_or_None, lineno)}`` — the same shape as
    :func:`logic_ir.parse_py_functions`, with ``ir=None`` for a body the
    expression parser can't read (a finding, not a crash)."""
    stripped, _ = strip_comments(text)
    out: Dict[str, Tuple[List[str], object, int]] = {}
    for m in _LOGIC_FN_RE.finditer(stripped):
        name = m.group(1)
        if name in _LOGIC_HELPERS:
            continue
        args: List[str] = []
        for param in m.group(2).split(","):
            words = re.findall(r"[A-Za-z_]\w*", param)
            if words:
                args.append(words[-1])
        try:
            ir = parse_c_expr(m.group(3))
        except CExprError:
            ir = None
        out[name] = (args, ir, _line_of(stripped, m.start()))
    return out


# ---------------------------------------------------------------------------
# transition extraction: ...->state = ST_X under enclosing if-guards

_TOK_RE = re.compile(
    r"\b(?P<kw>if|else|for|while|switch)\b"
    r"|(?P<assign>(?:->|\.)\s*state\s*=(?!=)\s*(?P<target>ST_[A-Za-z0-9_]+))"
    r"|(?P<open>\{)|(?P<close>\})|(?P<semi>;)|(?P<lp>\()|(?P<rp>\))")
_GUARD_STATE_RE = re.compile(r"state\s*==\s*ST_([A-Za-z0-9_]+)")


def _extract_transitions(stripped: str) -> List[Tuple[str, str, int]]:
    """(from_state|'?', to_state, line) for every state assignment.  The
    from-set is the union of states named positively (``== ST_X``) by the
    enclosing if-conditions; an unguarded assignment records '?'."""
    transitions: List[Tuple[str, str, int]] = []
    # frames: (kind 'block'|'stmt', guard frozenset)
    stack: List[Tuple[str, frozenset]] = []
    pending: Optional[frozenset] = None
    paren_depth = 0
    pos = 0
    n = len(stripped)
    while pos < n:
        m = _TOK_RE.search(stripped, pos)
        if not m:
            break
        pos = m.end()
        if m.group("lp"):
            paren_depth += 1
            continue
        if m.group("rp"):
            paren_depth = max(0, paren_depth - 1)
            continue
        if paren_depth > 0 and not m.group("assign"):
            continue
        kw = m.group("kw")
        if kw == "if":
            # parse the balanced condition
            i = stripped.find("(", m.end())
            if i < 0:
                continue
            depth, j = 1, i + 1
            while j < n and depth:
                if stripped[j] == "(":
                    depth += 1
                elif stripped[j] == ")":
                    depth -= 1
                j += 1
            cond = stripped[i + 1:j - 1]
            guards = frozenset(g.lower()
                               for g in _GUARD_STATE_RE.findall(cond))
            # block or single guarded statement?
            k = j
            while k < n and stripped[k].isspace():
                k += 1
            if k < n and stripped[k] == "{":
                pending = guards          # consumed by the '{'
            else:
                stack.append(("stmt", guards))
            pos = j
            continue
        if kw == "else":
            k = m.end()
            while k < n and stripped[k].isspace():
                k += 1
            if stripped.startswith("if", k):
                continue                  # else-if: the if takes over
            if k < n and stripped[k] == "{":
                pending = frozenset()     # braced else: empty guard
            else:
                stack.append(("stmt", frozenset()))
            continue
        if kw in ("for", "while", "switch"):
            continue                      # their '(' / '{' handled generically
        if m.group("open"):
            stack.append(("block", pending if pending is not None
                          else frozenset()))
            pending = None
            continue
        if m.group("close"):
            while stack and stack[-1][0] == "stmt":
                stack.pop()
            if stack:
                stack.pop()
            continue
        if m.group("semi"):
            while stack and stack[-1][0] == "stmt":
                stack.pop()
            continue
        if m.group("assign"):
            target = m.group("target")[3:].lower()
            guards: Set[str] = set()
            for _, g in stack:
                guards |= g
            line = _line_of(stripped, m.start())
            if guards:
                for g in sorted(guards):
                    transitions.append((g, target, line))
            else:
                transitions.append(("?", target, line))
    return transitions
