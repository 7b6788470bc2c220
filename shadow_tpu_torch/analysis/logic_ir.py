"""The protocol-logic expression IR (ISSUE 19): one typed arithmetic AST
in ``spec/protocol_spec.json``, three generated materializations.

PR 11 (simgen) made protocol *constants and tables* spec-authoritative;
this module does the same for the protocol *update expressions* (SRTT/
RTTVAR gains, RTO clamp/backoff, ssthresh, recovery inflation, and the
spec-defined ``bbrx`` congestion family).  The IR is deliberately tiny —
int64 arithmetic over named arguments and spec-constant references —
because every node must emit AND parse back on all three planes:

- Python plane  — ``def _g_<name>(args): return <expr>``
- C plane       — ``static inline int64_t gen_<name>(...) { return <expr>; }``
- kernel plane  — ``def <name>_np(args): return <expr>`` (numpy ops)

Node grammar (JSON lists, so the spec stays byte-stable under
``sort_keys``)::

    <expr> ::= <int>                      integer literal
             | "<arg>"                    argument reference
             | ["ref", "NAME"]            spec-constant reference
             | ["ref", "NAME", <idx>]     element of a pair constant
             | ["add"|"sub"|"mul"|"floordiv"|"mod"|"min"|"max"
                |"shl"|"shr", <expr>, <expr>]
             | ["select", <cond>, <expr>, <expr>]
    <cond> ::= ["eq"|"ne"|"lt"|"le"|"gt"|"ge", <expr>, <expr>]

Arithmetic contract (what makes cross-plane digest parity possible):
every operand is a non-negative int64 and every intermediate stays below
2**63, so Python's arbitrary-precision ``//``/``%``, C's truncating
``/``/``%`` and numpy's int64 ops agree exactly.  The spec's job is to
respect that envelope (the bbrx expressions clamp before multiplying).

Emission resolves ``ref`` nodes to literals — the generated expression
carries the VALUE, the spec carries the meaning — and read-back compares
the parsed (literal) tree against the spec tree resolved the same way,
so a drifted coefficient on any one plane is a structural mismatch, not
a regex miss.  ``simtwin``'s SIM206 rule and ``simgen``'s readback diff
both go through :func:`structural_diff`.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Tuple, Union

IR = Union[int, str, list]

_BINOPS = ("add", "sub", "mul", "floordiv", "mod", "min", "max",
           "shl", "shr")
_CMPS = ("eq", "ne", "lt", "le", "gt", "ge")

# one naming convention, owned here, consumed by simgen (emit) and
# twin_rules/cspec (read-back)
PY_PREFIX = "_g_"
C_PREFIX = "gen_"
NP_SUFFIX = "_np"

PLANES = ("py", "c", "kernel")


def plane_symbol(name: str, plane: str) -> str:
    """The emitted function name for logic function ``name`` on a plane."""
    if plane == "py":
        return PY_PREFIX + name
    if plane == "c":
        return C_PREFIX + name
    if plane == "kernel":
        return name + NP_SUFFIX
    raise ValueError(f"unknown plane {plane!r}")


# ---------------------------------------------------------------------------
# validation / resolution

class IRError(ValueError):
    pass


def _const_value(spec_constants: Dict, name: str,
                 elem: Optional[int]) -> int:
    if name not in spec_constants:
        raise IRError(f"logic IR references unknown constant {name!r}")
    v = spec_constants[name]
    if elem is not None:
        if not isinstance(v, (list, tuple)) or elem >= len(v):
            raise IRError(f"constant {name!r} has no element [{elem}]")
        v = v[elem]
    if not isinstance(v, int) or isinstance(v, bool):
        raise IRError(f"logic IR constant {name!r} must be an int, "
                      f"got {v!r}")
    return v


def validate(ir: IR, args: Sequence[str], spec_constants: Dict,
             _cond_ok: bool = False) -> None:
    """Raise :class:`IRError` on any malformed node."""
    if isinstance(ir, bool):
        raise IRError(f"boolean literal {ir!r} is not an IR node")
    if isinstance(ir, int):
        return
    if isinstance(ir, str):
        if ir not in args:
            raise IRError(f"unknown argument reference {ir!r} "
                          f"(args: {list(args)})")
        return
    if not isinstance(ir, list) or not ir:
        raise IRError(f"malformed IR node {ir!r}")
    op = ir[0]
    if op == "ref":
        if len(ir) == 2:
            _const_value(spec_constants, ir[1], None)
        elif len(ir) == 3:
            _const_value(spec_constants, ir[1], ir[2])
        else:
            raise IRError(f"malformed ref node {ir!r}")
        return
    if op in _BINOPS:
        if len(ir) != 3:
            raise IRError(f"{op} node wants 2 operands: {ir!r}")
        validate(ir[1], args, spec_constants)
        validate(ir[2], args, spec_constants)
        return
    if op == "select":
        if len(ir) != 4:
            raise IRError(f"select node wants (cond, t, f): {ir!r}")
        cond = ir[1]
        if (not isinstance(cond, list) or len(cond) != 3
                or cond[0] not in _CMPS):
            raise IRError(f"select condition must be a comparison: {cond!r}")
        validate(cond[1], args, spec_constants)
        validate(cond[2], args, spec_constants)
        validate(ir[2], args, spec_constants)
        validate(ir[3], args, spec_constants)
        return
    raise IRError(f"unknown IR op {op!r}")


def resolve(ir: IR, spec_constants: Dict) -> IR:
    """Replace every ``ref`` node with its spec value (the canonical
    compare form — read-back trees are literal by construction)."""
    if isinstance(ir, (int, str)):
        return ir
    if ir[0] == "ref":
        return _const_value(spec_constants, ir[1],
                            ir[2] if len(ir) == 3 else None)
    return [ir[0]] + [resolve(x, spec_constants) for x in ir[1:]]


def referenced_constants(ir: IR) -> List[str]:
    if isinstance(ir, (int, str)):
        return []
    if ir[0] == "ref":
        return [ir[1]]
    out: List[str] = []
    for x in ir[1:]:
        out.extend(referenced_constants(x))
    return out


def structural_diff(want: IR, got: IR, path: str = "") -> Optional[str]:
    """First structural difference between two RESOLVED trees, or None.
    The message names the diverging path so a SIM206 finding reads like
    a diff, not a shrug."""
    at = path or "<root>"
    if isinstance(want, (int, str)) or isinstance(got, (int, str)):
        if want != got:
            return f"at {at}: spec has {want!r}, plane has {got!r}"
        return None
    if want[0] != got[0]:
        return f"at {at}: spec op {want[0]!r}, plane op {got[0]!r}"
    if len(want) != len(got):
        return (f"at {at}: {want[0]} arity {len(want) - 1} != "
                f"{len(got) - 1}")
    for i, (w, g) in enumerate(zip(want[1:], got[1:])):
        d = structural_diff(w, g, f"{path}/{want[0]}[{i}]")
        if d:
            return d
    return None


def evaluate(ir: IR, env: Dict[str, int]) -> int:
    """Reference interpreter (tests pin the emitted planes against it)."""
    if isinstance(ir, int):
        return ir
    if isinstance(ir, str):
        return env[ir]
    op = ir[0]
    if op == "ref":
        raise IRError("evaluate() wants a resolved tree")
    if op in _CMPS:
        a, b = evaluate(ir[1], env), evaluate(ir[2], env)
        return {"eq": a == b, "ne": a != b, "lt": a < b, "le": a <= b,
                "gt": a > b, "ge": a >= b}[op]
    if op == "select":
        return (evaluate(ir[2], env) if evaluate(ir[1], env)
                else evaluate(ir[3], env))
    a, b = evaluate(ir[1], env), evaluate(ir[2], env)
    if op == "add":
        return a + b
    if op == "sub":
        return a - b
    if op == "mul":
        return a * b
    if op == "floordiv":
        return a // b
    if op == "mod":
        return a % b
    if op == "min":
        return min(a, b)
    if op == "max":
        return max(a, b)
    if op == "shl":
        return a << b
    if op == "shr":
        return a >> b
    raise IRError(f"unknown op {op!r}")


# ---------------------------------------------------------------------------
# emitters (always over a RESOLVED tree)

_PY_BINOP = {"add": "+", "sub": "-", "mul": "*", "floordiv": "//",
             "mod": "%", "shl": "<<", "shr": ">>"}
_C_BINOP = {"add": "+", "sub": "-", "mul": "*", "floordiv": "/",
            "mod": "%", "shl": "<<", "shr": ">>"}
_CMP_TOK = {"eq": "==", "ne": "!=", "lt": "<", "le": "<=",
            "gt": ">", "ge": ">="}


def emit_py(ir: IR) -> str:
    if isinstance(ir, int):
        return str(ir)
    if isinstance(ir, str):
        return ir
    op = ir[0]
    if op in _PY_BINOP:
        return f"({emit_py(ir[1])} {_PY_BINOP[op]} {emit_py(ir[2])})"
    if op in ("min", "max"):
        return f"{op}({emit_py(ir[1])}, {emit_py(ir[2])})"
    if op in _CMPS:
        return f"({emit_py(ir[1])} {_CMP_TOK[op]} {emit_py(ir[2])})"
    if op == "select":
        return (f"({emit_py(ir[2])} if {emit_py(ir[1])} "
                f"else {emit_py(ir[3])})")
    raise IRError(f"emit_py: unknown op {op!r}")


def emit_c(ir: IR) -> str:
    if isinstance(ir, int):
        # int64 literals: suffix anything outside the int32 envelope
        return f"{ir}LL" if ir > 2147483647 else str(ir)
    if isinstance(ir, str):
        return ir
    op = ir[0]
    if op in _C_BINOP:
        return f"({emit_c(ir[1])} {_C_BINOP[op]} {emit_c(ir[2])})"
    if op in ("min", "max"):
        return f"gen_i64_{op}({emit_c(ir[1])}, {emit_c(ir[2])})"
    if op in _CMPS:
        return f"({emit_c(ir[1])} {_CMP_TOK[op]} {emit_c(ir[2])})"
    if op == "select":
        return (f"({emit_c(ir[1])} ? {emit_c(ir[2])} "
                f": {emit_c(ir[3])})")
    raise IRError(f"emit_c: unknown op {op!r}")


def emit_np(ir: IR) -> str:
    if isinstance(ir, int):
        return str(ir)
    if isinstance(ir, str):
        return ir
    op = ir[0]
    if op in _PY_BINOP:
        return f"({emit_np(ir[1])} {_PY_BINOP[op]} {emit_np(ir[2])})"
    if op == "min":
        return f"np.minimum({emit_np(ir[1])}, {emit_np(ir[2])})"
    if op == "max":
        return f"np.maximum({emit_np(ir[1])}, {emit_np(ir[2])})"
    if op in _CMPS:
        return f"({emit_np(ir[1])} {_CMP_TOK[op]} {emit_np(ir[2])})"
    if op == "select":
        return (f"np.where({emit_np(ir[1])}, {emit_np(ir[2])}, "
                f"{emit_np(ir[3])})")
    raise IRError(f"emit_np: unknown op {op!r}")


# ---------------------------------------------------------------------------
# Python / numpy read-back (ast -> IR); the C side lives in cspec.py

_AST_BINOP = {ast.Add: "add", ast.Sub: "sub", ast.Mult: "mul",
              ast.FloorDiv: "floordiv", ast.Mod: "mod",
              ast.LShift: "shl", ast.RShift: "shr"}
_AST_CMP = {ast.Eq: "eq", ast.NotEq: "ne", ast.Lt: "lt", ast.LtE: "le",
            ast.Gt: "gt", ast.GtE: "ge"}
# numpy spellings of the portable ops
_NP_CALLS = {"minimum": "min", "maximum": "max"}


class ParseError(ValueError):
    pass


def _from_pyast(node: ast.AST) -> IR:
    if isinstance(node, ast.Constant):
        if isinstance(node.value, bool) or not isinstance(node.value, int):
            raise ParseError(f"non-integer literal {node.value!r}")
        return node.value
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.BinOp):
        op = _AST_BINOP.get(type(node.op))
        if op is None:
            raise ParseError(f"unsupported operator {node.op!r}")
        return [op, _from_pyast(node.left), _from_pyast(node.right)]
    if isinstance(node, ast.Compare):
        if len(node.ops) != 1:
            raise ParseError("chained comparison")
        op = _AST_CMP.get(type(node.ops[0]))
        if op is None:
            raise ParseError(f"unsupported comparison {node.ops[0]!r}")
        return [op, _from_pyast(node.left), _from_pyast(node.comparators[0])]
    if isinstance(node, ast.IfExp):
        cond = _from_pyast(node.test)
        if not (isinstance(cond, list) and cond[0] in _CMPS):
            raise ParseError("select condition must be a comparison")
        return ["select", cond, _from_pyast(node.body),
                _from_pyast(node.orelse)]
    if isinstance(node, ast.Call):
        fn = node.func
        if isinstance(fn, ast.Name) and fn.id in ("min", "max"):
            name = fn.id
        elif (isinstance(fn, ast.Attribute)
              and isinstance(fn.value, ast.Name) and fn.value.id == "np"):
            if fn.attr == "where":
                if len(node.args) != 3:
                    raise ParseError("np.where wants 3 args")
                cond = _from_pyast(node.args[0])
                if not (isinstance(cond, list) and cond[0] in _CMPS):
                    raise ParseError("np.where condition must be a "
                                     "comparison")
                return ["select", cond, _from_pyast(node.args[1]),
                        _from_pyast(node.args[2])]
            name = _NP_CALLS.get(fn.attr)
            if name is None:
                raise ParseError(f"unsupported numpy call np.{fn.attr}")
        else:
            raise ParseError(f"unsupported call {ast.dump(fn)}")
        if len(node.args) != 2:
            raise ParseError(f"{name} wants 2 args")
        return [name, _from_pyast(node.args[0]), _from_pyast(node.args[1])]
    raise ParseError(f"unsupported syntax {type(node).__name__}")


def parse_py_functions(source: str, plane: str
                       ) -> Dict[str, Tuple[List[str], IR, int]]:
    """Extract every emitted logic function from Python-plane source:
    ``{logic_name: (arg_names, ir, def_lineno)}``.  A function matching
    the naming convention whose body is not a single ``return <expr>`` of
    the portable vocabulary maps to ``(args, None, lineno)`` — the caller
    turns that into a finding rather than a crash."""
    out: Dict[str, Tuple[List[str], IR, int]] = {}
    try:
        tree = ast.parse(source)
    except SyntaxError:
        return out
    for node in ast.walk(tree):
        if not isinstance(node, ast.FunctionDef):
            continue
        if plane == "py":
            if not node.name.startswith(PY_PREFIX):
                continue
            logic = node.name[len(PY_PREFIX):]
        else:
            if not node.name.endswith(NP_SUFFIX):
                continue
            logic = node.name[:-len(NP_SUFFIX)]
        args = [a.arg for a in node.args.args]
        body = [s for s in node.body
                if not isinstance(s, ast.Expr)  # docstring
                or not isinstance(s.value, ast.Constant)]
        ir: Optional[IR] = None
        if (len(body) == 1 and isinstance(body[0], ast.Return)
                and body[0].value is not None):
            try:
                ir = _from_pyast(body[0].value)
            except ParseError:
                ir = None
        out[logic] = (args, ir, node.lineno)
    return out
