"""cuspec: cspec for the port's CUDA C++ kernel plane (``.cu``/``.cuh``).

The port's kernels (``shadow_tpu_torch/ops/csrc``) carry protocol
constants (the refill tick, the cell's header bytes, Threefry's parity and
rotations) that the Python and C planes carry too, and 32-bit chains that
must not carry a sim-time value.  cspec reads the subset of C++ the native
data plane uses; this module reads the CUDA spelling on top of it:

* :func:`normalize` blanks what cspec does not know, keeping every offset
  and newline: the ``__global__``/``__device__``/``__host__``/
  ``__forceinline__``/``__noinline__``/``__restrict__`` qualifiers,
  ``__launch_bounds__(...)`` and ``__align__(...)``, ``template <...>``
  heads, the ``constexpr`` of ``if constexpr``, ``extern "C"``,
  ``<<<...>>>`` launch configurations and ``#pragma`` lines.  cspec's
  constant, enum, symbol and transition passes then run unchanged, and
  ``namespace x {`` blocks and ``__shared__`` arrays pass through them.
  A file whose brackets do not balance once normalized does not parse:
  :class:`CudaParseError`, which the tools report as SIM000;
* :func:`narrowing_findings` is SIM204 for C++: a sim-time-ish value cast
  to a type of 32 bits or fewer (``(int32_t)``, ``(unsigned)``,
  ``static_cast<int>``, ``int32_t(...)``, ``__ll2int_rn`` ...), assigned
  into a declaration of such a type, or stored into a ``__shared__``
  array of one;
* :func:`float_findings` is SIM303 for C++: a ``(float)``/``(double)``
  cast, ``static_cast`` or ``__ll2float_rn``-style conversion of a
  sim-time lane, or a floating literal in a statement that touches one;
* :func:`collect_c_pragmas` is cspec's, with the ``simjit:`` introducer
  accepted too (SIM303 pragmas live in ``.cu`` files).
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Set, Tuple

from . import cspec

CUDA_EXTS = (".cu", ".cuh")

_BLANK_WORDS = re.compile(
    r"\b(?:__global__|__device__|__host__|__forceinline__|__noinline__"
    r"|__restrict__|__shared__|__constant__|__managed__)\b")
_PAREN_WORDS = re.compile(r"\b(?:__launch_bounds__|__align__)\s*\(")
_TEMPLATE = re.compile(r"\btemplate\s*<")
_IF_CONSTEXPR = re.compile(r"\bif\s+(constexpr)\b")
_EXTERN_C = re.compile(r'\bextern\s+"[^"\n]*"')
_PRAGMA_LINE = re.compile(r"^[ \t]*#[ \t]*pragma\b[^\n]*", re.M)
_LAUNCH = re.compile(r"<<<.*?>>>", re.S)

_PRAGMA_RE = re.compile(
    r"//\s*sim(?:lint|race|twin|jit):\s*disable=([A-Za-z0-9_,\s]*?)"
    r"\s*(?:--\s*(.*))?$")


class CudaParseError(ValueError):
    def __init__(self, line: int, msg: str):
        super().__init__(msg)
        self.line = line
        self.msg = msg


def _blank(text: str, start: int, end: int) -> str:
    return text[:start] + re.sub(r"[^\n]", " ", text[start:end]) + text[end:]


def _close(text: str, i: int, open_c: str, close_c: str) -> int:
    """The offset just past the bracket closing the one at ``i``."""
    depth = 0
    for j in range(i, len(text)):
        if text[j] == open_c:
            depth += 1
        elif text[j] == close_c:
            depth -= 1
            if depth == 0:
                return j + 1
    raise CudaParseError(cspec._line_of(text, i),
                         f"unclosed {open_c!r} — the file does not parse")


def normalize(stripped: str) -> str:
    """Comment-stripped CUDA C++ as the C subset cspec reads (every offset
    and newline kept).  Raises :class:`CudaParseError` when brackets do not
    balance."""
    text = _PRAGMA_LINE.sub(lambda m: " " * len(m.group(0)), stripped)
    text = _EXTERN_C.sub(lambda m: " " * len(m.group(0)), text)
    text = _BLANK_WORDS.sub(lambda m: " " * len(m.group(0)), text)
    text = _IF_CONSTEXPR.sub(
        lambda m: m.group(0)[:m.start(1) - m.start(0)]
        + " " * len(m.group(1)), text)
    for m in _LAUNCH.finditer(text):
        text = _blank(text, m.start(), m.end())
    while True:
        m = _PAREN_WORDS.search(text)
        if m is None:
            break
        text = _blank(text, m.start(), _close(text, m.end() - 1, "(", ")"))
    while True:
        m = _TEMPLATE.search(text)
        if m is None:
            break
        text = _blank(text, m.start(), _close(text, m.end() - 1, "<", ">"))
    _check_balance(text)
    return text


def _check_balance(text: str) -> None:
    pairs = {")": "(", "]": "[", "}": "{"}
    stack: List[Tuple[str, int]] = []
    for i, c in enumerate(text):
        if c in "([{":
            stack.append((c, i))
        elif c in pairs:
            if not stack or stack[-1][0] != pairs[c]:
                raise CudaParseError(cspec._line_of(text, i),
                                     f"unbalanced {c!r} — the file does "
                                     "not parse")
            stack.pop()
    if stack:
        c, i = stack[-1]
        raise CudaParseError(cspec._line_of(text, i),
                             f"unclosed {c!r} — the file does not parse")


def extract(path: str, text: str,
            probe_patterns: Optional[Dict[str, object]] = None
            ) -> cspec.CExtract:
    """cspec's extraction over a CUDA source (raises CudaParseError)."""
    stripped, _ = cspec.strip_comments(text)
    return cspec.extract(path, normalize(stripped), probe_patterns)


def collect_c_pragmas(text: str, known_ids: Set[str]
                      ) -> Tuple[List[cspec.CPragma], List[Tuple[int, int, str]]]:
    """cspec.collect_c_pragmas with the ``simjit:`` introducer as well:
    ``(pragmas, malformed)``, a comment-only line covering the next line."""
    _, comments = cspec.strip_comments(text)
    lines = text.splitlines()
    pragmas: List[cspec.CPragma] = []
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
        standalone = ln <= len(lines) and not lines[ln - 1][:col].strip()
        target = ln + 1 if standalone else ln
        for rid in ids:
            if rid in known_ids:
                pragmas.append(cspec.CPragma(rid, reason, target, ln, pcol))
    return pragmas, bad


# ---------------------------------------------------------------------------
# operands and sim-time names

_IDENT = re.compile(r"[A-Za-z_]\w*")


def _operand_end(text: str, i: int) -> int:
    """The end of the unary operand starting at ``i`` (after blanks): a
    parenthesized group, or a name with its member, index and call
    suffixes, behind any prefix operators and casts."""
    n = len(text)
    while i < n and text[i] in " \t\n":
        i += 1
    while i < n and text[i] in "-+!~*&":
        i += 1
        while i < n and text[i] in " \t\n":
            i += 1
    if i < n and text[i] == "(":
        end = _close(text, i, "(", ")")
        # a cast: (T)x — the operand goes on
        inner = text[i + 1:end - 1].strip()
        if re.fullmatch(r"[A-Za-z_][\w:\s<>*]*", inner) and end < n \
                and re.match(r"\s*[A-Za-z_(]", text[end:]) \
                and not _IDENT.fullmatch(inner):
            return _operand_end(text, end)
        i = end
    else:
        m = re.compile(r"[A-Za-z_]\w*(?:::[A-Za-z_]\w*)*|\d[\w.]*").match(
            text, i)
        if m is None:
            return i
        i = m.end()
    while i < n:
        m = re.compile(r"\s*(?:\.|->)\s*[A-Za-z_]\w*").match(text, i)
        if m:
            i = m.end()
            continue
        m = re.compile(r"\s*([\[(])").match(text, i)
        if m:
            c = m.group(1)
            i = _close(text, m.start(1), c, "]" if c == "[" else ")")
            continue
        break
    return i


def _timey(expr: str) -> Optional[str]:
    from .twin_rules import _is_timey
    for name in sorted(set(_IDENT.findall(expr))):
        if _is_timey(name):
            return name
    return None


_NARROW = (r"(?:(?:unsigned|signed)\s+(?:int|short|char)|u?int(?:8|16|32)_t"
           r"|unsigned|int|short|char)")
_C_CAST = re.compile(r"\(\s*(" + _NARROW + r")\s*\)")
_STATIC_CAST = re.compile(r"\bstatic_cast\s*<\s*(" + _NARROW + r")\s*>\s*\(")
_FUNC_CAST = re.compile(r"(?<![\w.>])(u?int(?:8|16|32)_t)\s*\(")
_NARROW_INTRIN = re.compile(
    r"\b(__(?:ll|ull|double|float)2u?int_r[nzud]|__(?:ll|ull)2u?short_r"
    r"[nzud])\s*\(")
_DECL = re.compile(r"(?:^|[;{}(,])\s*(?:const\s+)?(" + _NARROW +
                   r")\s+([A-Za-z_]\w*)\s*=(?!=)\s*([^;,]+)", re.M)
_SHARED = re.compile(r"\b__shared__\s+(?:__align__\s*\(\s*\d+\s*\)\s*)?("
                     + _NARROW + r"|u?int(?:8|16)_t|uint8_t)\s+"
                     r"([A-Za-z_]\w*)\s*\[")


# keywords a cast may follow (after any other name, `(T)` is a call's
# parameter list)
_CAST_AFTER = {"return", "case", "else", "do", "throw", "co_return"}


def narrowing_findings(path: str, text: str) -> List[Tuple[int, int, str]]:
    """SIM204 over one CUDA source: ``(line, col, message)`` for every
    sim-time-ish value narrowed to 32 bits or fewer."""
    stripped, _ = cspec.strip_comments(text)
    out: List[Tuple[int, int, str]] = []

    def add(pos: int, msg: str) -> None:
        line = cspec._line_of(stripped, pos)
        col = pos - (stripped.rfind("\n", 0, pos) + 1)
        out.append((line, col, msg))

    for regex in (_C_CAST, _STATIC_CAST, _FUNC_CAST, _NARROW_INTRIN):
        for m in regex.finditer(stripped):
            if regex is _C_CAST:
                # a parameter list `f(int)` is not a cast: a cast is
                # followed by its operand
                if not re.match(r"\s*[A-Za-z_(\d!~-]", stripped[m.end():]):
                    continue
                word = re.search(r"(\w*)\s*$",
                                 stripped[max(0, m.start() - 80):m.start()])
                if word.group(1) and word.group(1) not in _CAST_AFTER:
                    continue                 # `f(int) ...`: a declaration
                expr = stripped[m.end():_operand_end(stripped, m.end())]
            else:
                open_at = m.end() - 1
                expr = stripped[open_at:_close(stripped, open_at, "(", ")")]
            name = _timey(expr)
            if name:
                add(m.start(), f"sim-time value `{name}` narrowed to "
                    f"{' '.join(m.group(1).split())} — int64 ns arithmetic "
                    "wraps silently in a 32-bit lane")
    for m in _DECL.finditer(stripped):
        name = _timey(m.group(3))
        if name:
            add(m.start(2), f"sim-time value `{name}` assigned into "
                f"{' '.join(m.group(1).split())} `{m.group(2)}` — int64 ns "
                "arithmetic wraps silently in a 32-bit lane")
    carriers = {m.group(2): m.group(1) for m in _SHARED.finditer(stripped)}
    if carriers:
        store = re.compile(r"\b(" + "|".join(map(re.escape, sorted(carriers)))
                           + r")\s*\[")
        for m in store.finditer(stripped):
            end = _close(stripped, m.end() - 1, "[", "]")
            rhs = re.match(r"\s*=(?!=)\s*([^;]+);", stripped[end:])
            if rhs is None:
                continue
            name = _timey(rhs.group(1))
            if name:
                add(m.start(), f"sim-time value `{name}` stored into "
                    f"32-bit __shared__ carrier `{m.group(1)}` "
                    f"({carriers[m.group(1)]}) — ns timestamps overflow "
                    "it")
    return sorted(set(out))


_FLOAT_CAST = re.compile(r"\(\s*(float|double)\s*\)")
_FLOAT_STATIC = re.compile(r"\bstatic_cast\s*<\s*(float|double)\s*>\s*\(")
_FLOAT_INTRIN = re.compile(
    r"\b(__(?:ll|ull|int|uint)2(?:float|double)_r[nzud])\s*\(")
_FLOAT_LIT = re.compile(
    r"(?<![\w.])(?:0[xX][0-9a-fA-F]*\.?[0-9a-fA-F]*[pP][-+]?\d+[fFlL]?"
    r"|\d+\.\d*(?:[eE][-+]?\d+)?[fFlL]?|\.\d+(?:[eE][-+]?\d+)?[fFlL]?"
    r"|\d+[eE][-+]?\d+[fFlL]?|\d+[fF](?![\w.]))")


def float_findings(path: str, text: str) -> List[Tuple[int, int, str]]:
    """SIM303 over one CUDA source: ``(line, col, message)`` for every
    float promotion of a sim-time lane."""
    stripped, _ = cspec.strip_comments(text)
    out: List[Tuple[int, int, str]] = []

    def add(pos: int, msg: str) -> None:
        line = cspec._line_of(stripped, pos)
        col = pos - (stripped.rfind("\n", 0, pos) + 1)
        out.append((line, col, msg))

    for regex in (_FLOAT_CAST, _FLOAT_STATIC, _FLOAT_INTRIN):
        for m in regex.finditer(stripped):
            if regex is _FLOAT_CAST:
                expr = stripped[m.end():_operand_end(stripped, m.end())]
                what = f"cast to {m.group(1)}"
            else:
                open_at = m.end() - 1
                expr = stripped[open_at:_close(stripped, open_at, "(", ")")]
                what = f"converted by `{m.group(1).strip()}`"
            name = _timey(expr)
            if name:
                add(m.start(), f"sim-time lane `{name}` {what} — ns "
                    "timestamps lose integer exactness above 2**53; keep "
                    "the lane int64")
    for m in _FLOAT_LIT.finditer(stripped):
        start = max(stripped.rfind(c, 0, m.start()) for c in ";{}") + 1
        ends = [e for e in (stripped.find(c, m.end()) for c in ";{}")
                if e >= 0]
        stmt = stripped[start:min(ends) if ends else len(stripped)]
        name = _timey(stmt)
        if name:
            add(m.start(), f"float literal {m.group(0)} in a statement with "
                f"sim-time lane `{name}` promotes the int64 ns value to "
                "float — spell the coefficient as an integer ratio")
    return sorted(set(out))
