"""twin_rules: cross-plane protocol-equivalence model + the SIM2xx catalog.

The protocol logic of this simulator exists three times — the Python
modules (authoritative), the hand-transcribed C data plane, and the
JAX/numpy kernel family — kept bit-identical by discipline and runtime
digest tests.  simtwin turns that discipline into lint: three extractors
feed ONE table-driven IR (constants, update coefficients, TCP transition
tables, surface symbols, kernel dtypes) and the rules diff the planes.

=======  ========  ====================================================
SIM201   error     protocol constant / threshold drift between twins
SIM202   error     TCP state-transition table drift (missing / extra
                   transition or state per plane)
SIM203   error     a twin is missing a mapped counterpart surface
                   ([tool.simtwin.map] in pyproject.toml)
SIM204   error     dtype/overflow hazard in a device kernel (sim-ns
                   value narrowed to a 32-bit lane)
SIM205   error     simgen-generated region hand-edited (body digest
                   drift) or stale vs spec/protocol_spec.json
SIM206   error     emitted protocol-logic expression drifted from the
                   spec's expression IR (read-back: the plane's parsed
                   tree differs structurally from the resolved spec
                   tree)
=======  ========  ====================================================

The extracted IR serializes to ``spec/protocol.json`` (``simtwin
--emit-spec``): byte-stable, sorted, hash-seed independent.  Since the
simgen cut-over (ROADMAP item 3) the direction is INVERTED:
``spec/protocol_spec.json`` is authoritative, the planes carry generated
fenced regions (``make gen``), and this extracted IR is the read-back
verification artifact.  Constant sources are anchored to SYMBOL names
(``path#symbol``), never raw line offsets, so generated regions growing
or shrinking cannot churn the spec.

The surface map (``[tool.simtwin.map]``) is the comparator's scope: each
key names a protocol surface, each value lists ``plane:path[:symbol]``
entries (plane in {py, c, kernel}).  ``py``/``kernel`` files go through
the AST extractor (kernel files additionally run the dtype pass);
``c`` files go through cspec.  The surface named ``tcp-state-machine``
selects the files whose transition tables are compared.

In the port the kernel plane is also CUDA C++: a mapped ``.cu``/``.cuh``
file goes through cuspec (cspec over the CUDA spelling), its constants
join the kernel plane's, its symbols answer SIM203, and SIM204 runs
cuspec's C++ narrowing pass over it (a sim-time value cast or stored to
32 bits or fewer).  A CUDA file cuspec cannot parse is a SIM000 finding.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from . import cspec, cuspec
from .simlint import Config, Finding, ModuleContext

# ---------------------------------------------------------------------------
# canonical constant names: per-plane surface spellings -> one comparator key

CANON: Dict[str, str] = {
    # wire framing (core/defs.py <-> dataplane.cc constants)
    "CONFIG_MTU": "MTU", "MTU": "MTU",
    "CONFIG_HEADER_SIZE_TCPIPETH": "HDR_TCP", "HDR_TCP": "HDR_TCP",
    "CONFIG_HEADER_SIZE_UDPIPETH": "HDR_UDP", "HDR_UDP": "HDR_UDP",
    "CONFIG_DATAGRAM_MAX_SIZE": "DGRAM_MAX", "DGRAM_MAX": "DGRAM_MAX",
    "CONFIG_TCP_MAX_SEGMENT_SIZE": "MSS", "MSS": "MSS",
    # TCP buffers / timers
    "CONFIG_TCP_RMEM_MAX": "RMEM_MAX", "RMEM_MAX": "RMEM_MAX",
    "CONFIG_TCP_WMEM_MAX": "WMEM_MAX", "WMEM_MAX": "WMEM_MAX",
    "RTO_INIT_NS": "RTO_INIT_NS", "RTO_INIT": "RTO_INIT_NS",
    "RTO_MIN_NS": "RTO_MIN_NS", "RTO_MIN": "RTO_MIN_NS",
    "RTO_MAX_NS": "RTO_MAX_NS", "RTO_MAX": "RTO_MAX_NS",
    "TIME_WAIT_NS": "TIME_WAIT_NS",
    "MAX_SYN_RETRIES": "MAX_SYN_RETRIES",
    "MAX_RETRIES": "MAX_RETRIES",
    "MAX_SACK_BLOCKS": "MAX_SACK_BLOCKS",
    # interface token buckets
    "INTERFACE_REFILL_INTERVAL_NS": "REFILL_INTERVAL_NS",
    "REFILL_INTERVAL": "REFILL_INTERVAL_NS",
    "REFILL_NS": "REFILL_INTERVAL_NS",
    "REFILL_INTERVAL_NS": "REFILL_INTERVAL_NS",
    "INTERFACE_CAPACITY_FACTOR": "CAPACITY_FACTOR",
    "CAPACITY_FACTOR": "CAPACITY_FACTOR",
    # router AQM
    "CoDelQueue.TARGET_NS": "CODEL_TARGET_NS",
    "CODEL_TARGET": "CODEL_TARGET_NS",
    "CoDelQueue.INTERVAL_NS": "CODEL_INTERVAL_NS",
    "CODEL_INTERVAL": "CODEL_INTERVAL_NS",
    "CoDelQueue.HARD_LIMIT": "CODEL_HARD_LIMIT",
    "CODEL_HARD_LIMIT": "CODEL_HARD_LIMIT",
    "STATIC_CAPACITY": "STATIC_CAPACITY",
    # clock
    "SIM_TIME_MS": "SIM_TIME_MS", "SIM_MS": "SIM_TIME_MS",
    "SIM_TIME_SEC": "SIM_TIME_SEC", "SIM_SEC": "SIM_TIME_SEC",
    # drop RNG (core/rng.py threefry <-> dataplane.cc mirror)
    "_PARITY": "THREEFRY_PARITY", "TF_PARITY": "THREEFRY_PARITY",
    "_ROTATIONS": "THREEFRY_ROTATIONS", "TF_ROT": "THREEFRY_ROTATIONS",
    # the Tor cell on the wire (ops/torcells_device.py <-> the CUDA kernel
    # plane's span, flush and run kernels): a payload and HDR_TCP
    "CELL_WIRE_BYTES": "CELL_WIRE_BYTES",
    "PACK_CELL_WIRE_BYTES": "CELL_WIRE_BYTES",
    # TCP header flags (routing/packet.py <-> dataplane.cc enum)
    "TCP_RST": "FLAG_RST", "F_RST": "FLAG_RST",
    "TCP_SYN": "FLAG_SYN", "F_SYN": "FLAG_SYN",
    "TCP_ACK": "FLAG_ACK", "F_ACK": "FLAG_ACK",
    "TCP_FIN": "FLAG_FIN", "F_FIN": "FLAG_FIN",
    # descriptor status bits (descriptor/base.py <-> dataplane.cc enum)
    "S_ACTIVE": "S_ACTIVE", "S_READABLE": "S_READABLE",
    "S_WRITABLE": "S_WRITABLE", "S_CLOSED": "S_CLOSED",
    # epoll readiness bits (descriptor/epoll.py <-> dataplane.cc enum):
    # the C-side readiness cache computes revents natively, so
    # the bit values are a two-plane surface
    "EPOLLIN": "EPOLLIN", "EPOLLOUT": "EPOLLOUT",
    "EPOLLERR": "EPOLLERR", "EPOLLHUP": "EPOLLHUP",
    # port allocation (host/host.py <-> dataplane.cc)
    "MIN_EPHEMERAL_PORT": "MIN_EPHEMERAL_PORT", "MAX_PORT": "MAX_PORT",
    # congestion control: the coefficient families are NAMED constants on
    # all three planes since the simgen cut-over (generated regions in
    # tcp_cong.py / dataplane.cc / ops/protocol_tables.py)
    "Cubic.C": "CUBIC_C", "Cubic.BETA": "CUBIC_BETA",
    "CUBIC_C": "CUBIC_C", "CUBIC_BETA": "CUBIC_BETA",
    "CubicX.C": "CUBICX_C", "CubicX.BETA": "CUBICX_BETA",
    "CUBICX_C": "CUBICX_C", "CUBICX_BETA": "CUBICX_BETA",
    # bbrx estimator parameters: named identically on all three planes
    # (generated logic regions)
    "BBRX_BETA_DEN": "BBRX_BETA_DEN", "BBRX_BETA_NUM": "BBRX_BETA_NUM",
    "BBRX_BW_CAP_BPS": "BBRX_BW_CAP_BPS", "BBRX_CYCLE_LEN": "BBRX_CYCLE_LEN",
    "BBRX_CYCLE_NS": "BBRX_CYCLE_NS",
    "BBRX_GAIN_CRUISE_NUM": "BBRX_GAIN_CRUISE_NUM",
    "BBRX_GAIN_DEN": "BBRX_GAIN_DEN",
    "BBRX_GAIN_DOWN_NUM": "BBRX_GAIN_DOWN_NUM",
    "BBRX_GAIN_UP_NUM": "BBRX_GAIN_UP_NUM",
    "BBRX_MIN_CWND_SEGMENTS": "BBRX_MIN_CWND_SEGMENTS",
    "BBRX_RTT_CAP_NS": "BBRX_RTT_CAP_NS",
    "BBRX_RTT_FLOOR_NS": "BBRX_RTT_FLOOR_NS",
}

# canonical constants compared across the planes that the spec does not
# list: each is derived from spec entries in every plane that spells it
# (simgen's read-back holds the spec entries, SIM201 the derived value)
DERIVED_CANON = {"CELL_WIRE_BYTES"}

# C-side regex probes for coefficients spelled inline (see cspec._run_probe)
C_PROBES: Dict[str, Tuple[str, str]] = {
    "MAX_RETRIES": (r"rtx_count\s*>=\s*(MAX_RETRIES)", "one"),
    "DUP_ACK_THRESHOLD": (r"\bcount\s*==\s*(\d+)", "one"),
    "QUICK_ACKS_LIMIT": (r"quick_acks\s*<\s*(\d+)", "one"),
    "DELACK_DELAYS_NS": (r"\bdelay\s*=\s*([^;]+);", "set"),
    # CUBIC_C / CUBIC_BETA left the probe set at the simgen cut-over: the
    # C plane now spells them as named constexpr constants (generated
    # region c-congestion-params), extracted like any other constant.
    # SRTT_GAIN / RTTVAR_GAIN / RTO_VAR_MULT / SSTHRESH_RULE /
    # RECOVERY_INFLATE_SEGMENTS left at the logic-surface cut-over: the
    # update expressions are generated from the spec's
    # logic IR and SIM206 compares the parsed trees structurally —
    # strictly stronger than a per-coefficient regex.
}

# sim-time-ish identifiers for the SIM204 dtype pass
_TIMEY_RE = re.compile(
    r"(?:^|_)(?:ns|time|times|deliver|arrive|admit|barrier|expiry|deadline)"
    r"(?:_|$)|_ns$|time")
_NARROW_DTYPES = {"int32", "uint32", "int16", "uint16", "int8", "uint8"}


def _is_timey(name: str) -> bool:
    return bool(_TIMEY_RE.search(name.lower()))


# ---------------------------------------------------------------------------
# python constant folding

def _fold(node: ast.AST, env: Dict[str, object],
          modules: Dict[str, Dict[str, object]]) -> Optional[object]:
    """Fold a module-level constant expression.  ``env`` is the module's
    own names; ``modules`` maps import basenames (defs, stime, ...) to the
    envs of other analyzed modules so ``defs.CONFIG_MTU`` resolves."""
    if isinstance(node, ast.Constant) and isinstance(
            node.value, (int, float, str)):
        return node.value
    if isinstance(node, ast.Name):
        return env.get(node.id)
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name):
        mod_env = modules.get(node.value.id)
        if mod_env is not None:
            return mod_env.get(node.attr)
        return None
    if isinstance(node, ast.Tuple):
        vals = [_fold(e, env, modules) for e in node.elts]
        if any(v is None for v in vals):
            return None
        return list(vals)
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        v = _fold(node.operand, env, modules)
        return -v if isinstance(v, (int, float)) else None
    if isinstance(node, ast.BinOp):
        a = _fold(node.left, env, modules)
        b = _fold(node.right, env, modules)
        if not isinstance(a, (int, float)) or not isinstance(b, (int, float)):
            return None
        try:
            if isinstance(node.op, ast.Add):
                return a + b
            if isinstance(node.op, ast.Sub):
                return a - b
            if isinstance(node.op, ast.Mult):
                return a * b
            if isinstance(node.op, ast.FloorDiv):
                return a // b
            if isinstance(node.op, ast.Div):
                return a / b
            if isinstance(node.op, ast.Pow):
                return a ** b
            if isinstance(node.op, ast.LShift):
                return a << b
            if isinstance(node.op, ast.RShift):
                return a >> b
            if isinstance(node.op, ast.BitOr):
                return a | b
        except (ZeroDivisionError, TypeError, ValueError, OverflowError):
            return None
    return None


@dataclass
class PyExtract:
    path: str
    constants: Dict[str, Tuple[object, int]] = field(default_factory=dict)
    symbols: Dict[str, int] = field(default_factory=dict)
    transitions: List[Tuple[str, str, int]] = field(default_factory=list)
    probes: Dict[str, Tuple[object, int]] = field(default_factory=dict)
    states: List[str] = field(default_factory=list)
    env: Dict[str, object] = field(default_factory=dict)


def fold_module_env(ctx: ModuleContext,
                    modules: Dict[str, Dict[str, object]]
                    ) -> Dict[str, object]:
    """Module-level (and Class.attr) constant values for one module."""
    env: Dict[str, object] = {}
    for stmt in ctx.tree.body:
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                and isinstance(stmt.targets[0], ast.Name):
            v = _fold(stmt.value, env, modules)
            if v is not None:
                env[stmt.targets[0].id] = v
        elif isinstance(stmt, ast.ClassDef):
            for sub in stmt.body:
                if isinstance(sub, ast.Assign) and len(sub.targets) == 1 \
                        and isinstance(sub.targets[0], ast.Name):
                    v = _fold(sub.value, env, modules)
                    if v is not None:
                        env[f"{stmt.name}.{sub.targets[0].id}"] = v
    return env


def _const_lines(ctx: ModuleContext) -> Dict[str, int]:
    lines: Dict[str, int] = {}
    for stmt in ctx.tree.body:
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                and isinstance(stmt.targets[0], ast.Name):
            lines[stmt.targets[0].id] = stmt.lineno
        elif isinstance(stmt, ast.ClassDef):
            for sub in stmt.body:
                if isinstance(sub, ast.Assign) and len(sub.targets) == 1 \
                        and isinstance(sub.targets[0], ast.Name):
                    lines[f"{stmt.name}.{sub.targets[0].id}"] = sub.lineno
    return lines


def _py_symbols(ctx: ModuleContext) -> Dict[str, int]:
    syms: Dict[str, int] = {}
    for node in ctx.tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            syms[node.name] = node.lineno
        elif isinstance(node, ast.ClassDef):
            syms[node.name] = node.lineno
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    syms[f"{node.name}.{sub.name}"] = sub.lineno
    return syms


# -- transition extraction (python side) ------------------------------------

def _guard_states(test: ast.AST, env: Dict[str, object]) -> Set[str]:
    """States named positively (== / in) by an if-condition."""
    out: Set[str] = set()
    for node in ast.walk(test):
        if not isinstance(node, ast.Compare) or len(node.ops) != 1:
            continue
        left = node.left
        is_state = (isinstance(left, ast.Attribute) and left.attr == "state") \
            or (isinstance(left, ast.Name) and left.id == "state")
        if not is_state:
            continue
        op = node.ops[0]
        comp = node.comparators[0]
        if isinstance(op, ast.Eq):
            v = _fold(comp, env, {})
            if isinstance(v, str):
                out.add(v)
        elif isinstance(op, ast.In) and isinstance(comp, (ast.Tuple, ast.List)):
            for e in comp.elts:
                v = _fold(e, env, {})
                if isinstance(v, str):
                    out.add(v)
    return out


def _py_transitions(ctx: ModuleContext, env: Dict[str, object]
                    ) -> List[Tuple[str, str, int]]:
    """(from|'?', to, line) for every ``<obj>.state = STATE`` assignment,
    guards attributed only through if-*bodies* (never else branches) —
    the AST mirror of cspec._extract_transitions."""
    out: List[Tuple[str, str, int]] = []
    for node in ctx.walk(ast.Assign):
        if len(node.targets) != 1:
            continue
        tgt = node.targets[0]
        if not (isinstance(tgt, ast.Attribute) and tgt.attr == "state"):
            continue
        values = [node.value]
        if isinstance(node.value, ast.IfExp):
            values = [node.value.body, node.value.orelse]
        targets: List[str] = []
        for v in values:
            folded = _fold(v, env, {})
            if isinstance(folded, str):
                targets.append(folded)
        if not targets:
            continue
        guards: Set[str] = set()
        child: ast.AST = node
        cur = ctx.parent(node)
        while cur is not None:
            if isinstance(cur, ast.If) and child in cur.body:
                guards |= _guard_states(cur.test, env)
            child = cur
            cur = ctx.parent(cur)
        for to in targets:
            if guards:
                for g in sorted(guards):
                    out.append((g, to, node.lineno))
            else:
                out.append(("?", to, node.lineno))
    return out


def _py_states(transitions: List[Tuple[str, str, int]]) -> List[str]:
    s = {t for _, t, _ in transitions} | \
        {f for f, _, _ in transitions if f != "?"}
    return sorted(s)


# -- python coefficient probes ----------------------------------------------

def _attr_name(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _py_probes(ctx: ModuleContext, env: Dict[str, object],
               modules: Dict[str, Dict[str, object]]
               ) -> Dict[str, Tuple[object, int]]:
    """The Python spellings of the C_PROBES coefficients."""
    out: Dict[str, Tuple[object, int]] = {}
    delack: List[object] = []
    delack_line = None
    for node in ast.walk(ctx.tree):
        ln = getattr(node, "lineno", 0)
        # rtx_count >= <int literal>  ->  MAX_RETRIES (tcp_retries2)
        if isinstance(node, ast.Compare) and len(node.ops) == 1 \
                and isinstance(node.ops[0], ast.GtE) \
                and _attr_name(node.left) == "rtx_count" \
                and isinstance(node.comparators[0], ast.Constant) \
                and isinstance(node.comparators[0].value, int):
            prev = out.get("MAX_RETRIES")
            if prev is None or node.comparators[0].value > prev[0]:
                out["MAX_RETRIES"] = (node.comparators[0].value, ln)
        # count == N  ->  DUP_ACK_THRESHOLD
        if isinstance(node, ast.Compare) and len(node.ops) == 1 \
                and isinstance(node.ops[0], ast.Eq) \
                and _attr_name(node.left) == "count" \
                and isinstance(node.comparators[0], ast.Constant):
            out.setdefault("DUP_ACK_THRESHOLD",
                           (node.comparators[0].value, ln))
        # _quick_acks < N  ->  QUICK_ACKS_LIMIT
        if isinstance(node, ast.Compare) and len(node.ops) == 1 \
                and isinstance(node.ops[0], ast.Lt) \
                and (_attr_name(node.left) or "").lstrip("_") == "quick_acks" \
                and isinstance(node.comparators[0], ast.Constant):
            out.setdefault("QUICK_ACKS_LIMIT",
                           (node.comparators[0].value, ln))
        # delay = <expr>  ->  DELACK_DELAYS_NS (set of folded values)
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id == "delay":
            v = _fold(node.value, env, modules)
            if isinstance(v, (int, float)):
                delack.append(v)
                delack_line = delack_line or ln
        # SRTT/RTTVAR/RTO/ssthresh/recovery coefficient probes retired at
        # the logic-surface cut-over: SIM206 structurally
        # compares the generated update expressions instead.
        # def __init__(..., capacity_packets: int = N)  ->  STATIC_CAPACITY
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            args = node.args.args
            for arg, default in zip(args[len(args) - len(node.args.defaults):],
                                    node.args.defaults):
                if arg.arg == "capacity_packets" \
                        and isinstance(default, ast.Constant):
                    out.setdefault("STATIC_CAPACITY",
                                   (default.value, node.lineno))
    if delack:
        out["DELACK_DELAYS_NS"] = (sorted(set(delack)), delack_line or 0)
    return out


def extract_py(ctx: ModuleContext, modules: Dict[str, Dict[str, object]],
               with_transitions: bool) -> PyExtract:
    env = fold_module_env(ctx, modules)
    out = PyExtract(ctx.relpath, env=env)
    lines = _const_lines(ctx)
    for name, val in env.items():
        if isinstance(val, (int, float, list)):
            out.constants[name] = (val, lines.get(name, 1))
    out.symbols = _py_symbols(ctx)
    out.probes = _py_probes(ctx, env, modules)
    if with_transitions:
        out.transitions = _py_transitions(ctx, env)
        out.states = _py_states(out.transitions)
    return out


# ---------------------------------------------------------------------------
# SIM204: kernel dtype/overflow pass

def _dtype_of(node: ast.AST) -> Optional[str]:
    """'int32' for jnp.int32 / np.uint32 / "int32" etc., else None."""
    if isinstance(node, ast.Attribute) and node.attr in _NARROW_DTYPES:
        return node.attr
    if isinstance(node, ast.Name) and node.id in _NARROW_DTYPES:
        return node.id
    if isinstance(node, ast.Constant) and isinstance(node.value, str) \
            and node.value in _NARROW_DTYPES:
        return node.value
    return None


def _expr_names(node: ast.AST) -> Set[str]:
    names: Set[str] = set()
    for n in ast.walk(node):
        if isinstance(n, ast.Name):
            names.add(n.id)
        elif isinstance(n, ast.Attribute):
            names.add(n.attr)
        elif isinstance(n, ast.arg):
            names.add(n.arg)
    return names


def kernel_dtype_findings(ctx: ModuleContext) -> List[Finding]:
    """SIM204: a sim-time value narrowed to a 32-bit lane inside a kernel
    module.  Two shapes are findings:

    * a direct cast — ``deliver_ns.astype(jnp.int32)`` or
      ``jnp.int32(send_times)`` — of an expression whose identifiers look
      sim-time-ish (``*_ns``, ``*time*``, deliver/arrive/admit/barrier/
      expiry);
    * a 32-bit carrier (``jnp.zeros(..., dtype=jnp.int32)`` or a tracked
      ``.astype(32-bit)`` binding — the arrival-ring shape, donate-aware
      in the sense that the carried buffer keeps its identity across
      ``.at[...].set/add``) receiving a sim-time expression.
    """
    findings: List[Finding] = []
    narrow_vars: Set[str] = set()
    rule_id, sev = "SIM204", "error"

    def timey(expr: ast.AST) -> Optional[str]:
        for nm in sorted(_expr_names(expr)):
            if _is_timey(nm):
                return nm
        return None

    for node in ast.walk(ctx.tree):
        # x = jnp.zeros(..., dtype=<32>)  /  x = <expr>.astype(<32>)
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            v = node.value
            if isinstance(v, ast.Call):
                for kw in v.keywords:
                    if kw.arg == "dtype" and _dtype_of(kw.value):
                        narrow_vars.add(node.targets[0].id)
                if isinstance(v.func, ast.Attribute) \
                        and v.func.attr == "astype" and v.args \
                        and _dtype_of(v.args[0]):
                    narrow_vars.add(node.targets[0].id)
        if not isinstance(node, ast.Call):
            continue
        # direct cast of a time-ish expression
        if isinstance(node.func, ast.Attribute) and node.func.attr == "astype" \
                and node.args and _dtype_of(node.args[0]):
            nm = timey(node.func.value)
            if nm:
                findings.append(Finding(
                    rule_id, sev, ctx.relpath, node.lineno, node.col_offset,
                    f"sim-time value `{nm}` narrowed to "
                    f"{_dtype_of(node.args[0])} — int64 ns arithmetic "
                    f"wraps silently in a 32-bit lane"))
            continue
        dt = _dtype_of(node.func)
        if dt and node.args:
            nm = timey(node.args[0])
            if nm:
                findings.append(Finding(
                    rule_id, sev, ctx.relpath, node.lineno, node.col_offset,
                    f"sim-time value `{nm}` narrowed to {dt} — int64 ns "
                    f"arithmetic wraps silently in a 32-bit lane"))
            continue
        # ring.at[i].set(time_expr) on a tracked 32-bit carrier
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr in ("set", "add") and node.args:
            base = node.func.value
            root = None
            while isinstance(base, (ast.Subscript, ast.Attribute)):
                base = base.value
            if isinstance(base, ast.Name):
                root = base.id
            if root in narrow_vars:
                nm = timey(node.args[0])
                if nm:
                    findings.append(Finding(
                        rule_id, sev, ctx.relpath, node.lineno,
                        node.col_offset,
                        f"sim-time value `{nm}` stored into 32-bit carrier "
                        f"`{root}` — ns timestamps overflow int32"))
    return findings


# ---------------------------------------------------------------------------
# the surface map + twin model

STATE_SURFACE = "tcp-state-machine"
_ENTRY_RE = re.compile(r"^(py|c|kernel):([^:]+)(?::(.+))?$")


@dataclass
class MapEntry:
    plane: str      # py | c | kernel
    path: str       # relpath from the config root
    symbol: Optional[str]


def parse_map(raw: Dict[str, List[str]]) -> Dict[str, List[MapEntry]]:
    out: Dict[str, List[MapEntry]] = {}
    for surface, entries in raw.items():
        parsed = []
        for e in entries:
            m = _ENTRY_RE.match(e.strip())
            if m:
                parsed.append(MapEntry(m.group(1), m.group(2), m.group(3)))
        out[surface] = parsed
    return out


def _nearest_symbol(symbols: Dict[str, int], line: int) -> Optional[str]:
    """The defined symbol whose start line is nearest above ``line`` —
    the stable anchor for a value spelled inside a function body.
    Deterministic: ties (same start line) break alphabetically."""
    best: Optional[str] = None
    best_line = -1
    for name in sorted(symbols):
        ln = symbols[name]
        if ln <= line and ln > best_line:
            best, best_line = name, ln
    return best


class TwinModel:
    """All three planes extracted from one source set, per the map."""

    def __init__(self, sources: Dict[str, str],
                 surface_map: Dict[str, List[MapEntry]],
                 spec_text: Optional[str] = None):
        self.sources = sources
        self.map = surface_map
        # authoritative-spec digest for the SIM205 staleness check; the
        # fixture path passes spec_text (or puts the spec file in
        # ``sources``), twin_paths loads it from the config root
        from .genmark import SPEC_RELPATH, sha12
        if spec_text is None:
            spec_text = sources.get(SPEC_RELPATH)
        self.spec_text = spec_text
        self.spec_digest = sha12(spec_text) if spec_text is not None else None
        self.parse_errors: List[Finding] = []
        self.py_ctx: Dict[str, ModuleContext] = {}
        self.py_extracts: Dict[str, PyExtract] = {}
        self.c_extracts: Dict[str, cspec.CExtract] = {}
        self.kernel_paths: List[str] = []
        # CUDA sources of the kernel plane (cuspec; their extracts sit in
        # c_extracts beside the C plane's, plane_of tells them apart)
        self.cuda_paths: List[str] = []
        state_paths = {e.path for e in surface_map.get(STATE_SURFACE, ())}

        py_paths: List[str] = []
        c_paths: List[str] = []
        for entries in surface_map.values():
            for e in entries:
                if e.path not in sources:
                    continue
                if e.path.endswith(cuspec.CUDA_EXTS):
                    if e.path not in self.cuda_paths:
                        self.cuda_paths.append(e.path)
                    if e.plane == "kernel" \
                            and e.path not in self.kernel_paths:
                        self.kernel_paths.append(e.path)
                elif e.plane == "c":
                    if e.path not in c_paths:
                        c_paths.append(e.path)
                else:
                    if e.path not in py_paths:
                        py_paths.append(e.path)
                    if e.plane == "kernel" \
                            and e.path not in self.kernel_paths:
                        self.kernel_paths.append(e.path)

        for rel in sorted(py_paths):
            try:
                self.py_ctx[rel] = ModuleContext(rel, sources[rel])
            except SyntaxError as exc:
                self.parse_errors.append(Finding(
                    "SIM000", "error", rel, exc.lineno or 1,
                    (exc.offset or 1) - 1,
                    f"file does not parse: {exc.msg}"))
        # two folding passes so cross-module references (tcp.py -> defs,
        # stime) settle regardless of iteration order
        module_envs: Dict[str, Dict[str, object]] = {}
        for _ in range(2):
            for rel, ctx in self.py_ctx.items():
                base = rel.rsplit("/", 1)[-1][:-3]
                module_envs[base] = fold_module_env(ctx, module_envs)
        for rel, ctx in sorted(self.py_ctx.items()):
            self.py_extracts[rel] = extract_py(
                ctx, module_envs, with_transitions=rel in state_paths)
        for rel in sorted(c_paths):
            self.c_extracts[rel] = cspec.extract(rel, sources[rel], C_PROBES)
        for rel in sorted(self.cuda_paths):
            try:
                self.c_extracts[rel] = cuspec.extract(rel, sources[rel])
            except cuspec.CudaParseError as exc:
                self.parse_errors.append(Finding(
                    "SIM000", "error", rel, exc.line, 0,
                    f"file does not parse: {exc.msg}"))

    # -- plane-tagged views ------------------------------------------------
    def plane_of(self, path: str) -> str:
        if path in self.kernel_paths:
            return "kernel"
        if path in self.c_extracts:
            return "c"
        return "python"

    def constants_by_canonical(
            self) -> Dict[str, List[Tuple[str, object, int, str]]]:
        """canonical -> [(path, value, line, anchor)], python plane first,
        then kernel, then C — sorted within a plane by path.  ``anchor``
        is the SYMBOL the value is attributed to (its own name for a
        named constant/enum member, the enclosing function for an inline
        coefficient probe): spec sources cite anchors, never raw line
        offsets, so a generated region growing or shrinking above a value
        cannot churn the emitted spec."""
        merged: Dict[str, List[Tuple[str, object, int, str]]] = {}

        def add(canon: str, path: str, value: object, line: int,
                anchor: str) -> None:
            merged.setdefault(canon, []).append((path, value, line, anchor))

        order = ([(rel, ext) for rel, ext in sorted(self.py_extracts.items())
                  if rel not in self.kernel_paths]
                 + [(rel, ext) for rel, ext in sorted(
                     self.py_extracts.items()) if rel in self.kernel_paths])
        for rel, ext in order:
            for name, (val, line) in sorted(ext.constants.items()):
                canon = CANON.get(name)
                if canon:
                    add(canon, rel, val, line, name)
            for canon, (val, line) in sorted(ext.probes.items()):
                add(canon, rel, val, line,
                    _nearest_symbol(ext.symbols, line) or "module")
        c_order = sorted(self.c_extracts.items(),
                         key=lambda kv: (kv[0] in self.kernel_paths, kv[0]))
        for rel, ext in c_order:
            for name, (val, line) in sorted(ext.constants.items()):
                canon = CANON.get(name)
                if canon:
                    add(canon, rel, val, line, name)
            for members in ext.enums.values():
                for name, val, line in members:
                    canon = CANON.get(name)
                    if canon:
                        add(canon, rel, val, line, name)
            for canon, (val, line) in sorted(ext.probes.items()):
                add(canon, rel, val, line,
                    _nearest_symbol(ext.symbols, line) or "unit")
        return merged

    def _region_bodies(self, rel: str) -> List[Tuple[int, str]]:
        """(line_offset, body_text) for each simgen region in a mapped
        file.  The logic surface lives only inside generated regions, so
        the SIM206 read-back parses nothing else — a hand-written
        ``*_np`` kernel helper is not a logic function."""
        from .genmark import scan_regions
        regions, _ = scan_regions(self.sources[rel])
        return [(r.begin_line, r.body) for r in regions]

    def logic_functions_by_plane(
            self) -> Dict[str, Dict[str, Tuple[List[str], object, int, str]]]:
        """plane -> {logic_name: (args, ir_or_None, line, path)} parsed
        from the generated regions of every mapped source — the SIM206
        read-back input.  Functions are recognized by the naming
        convention logic_ir owns (``_g_*``, ``gen_*`` free functions,
        ``*_np``); body line numbers are offset back to file lines."""
        from . import logic_ir
        out: Dict[str, Dict[str, Tuple[List[str], object, int, str]]] = {
            "py": {}, "c": {}, "kernel": {}}
        for rel in sorted(self.c_extracts):
            if rel in self.cuda_paths:
                continue             # the kernel plane's C++ has no logic
            for off, body in self._region_bodies(rel):
                parsed = cspec.parse_c_logic_functions(body)
                for name, (args, ir, line) in sorted(parsed.items()):
                    out["c"][name] = (args, ir, off + line, rel)
        for rel in sorted(self.py_extracts):
            plane = "kernel" if rel in self.kernel_paths else "py"
            for off, body in self._region_bodies(rel):
                parsed = logic_ir.parse_py_functions(body, plane)
                for name, (args, ir, line) in sorted(parsed.items()):
                    out[plane][name] = (args, ir, off + line, rel)
        return out

    def transition_tables(self) -> Dict[str, Dict]:
        """path -> {'pairs': {(from, to): line}, 'states': [..]} for every
        plane in the tcp-state-machine surface."""
        out: Dict[str, Dict] = {}
        for e in self.map.get(STATE_SURFACE, ()):
            ext = self.py_extracts.get(e.path) if e.plane != "c" \
                else self.c_extracts.get(e.path)
            if ext is None:
                continue
            pairs: Dict[Tuple[str, str], int] = {}
            for f, t, line in ext.transitions:
                pairs.setdefault((f, t), line)
            out[e.path] = {"pairs": pairs, "states": list(ext.states)}
        return out


# ---------------------------------------------------------------------------
# the rule catalog

class TwinRule:
    id = "SIM200"
    severity = "error"
    short = ""

    def run(self, twin: TwinModel) -> List[Finding]:  # pragma: no cover
        raise NotImplementedError


def _fmt(v: object) -> str:
    return repr(v)


class ConstantDriftRule(TwinRule):
    id = "SIM201"
    severity = "error"
    short = "protocol constant/threshold drift between twins"

    def run(self, twin: TwinModel) -> List[Finding]:
        findings: List[Finding] = []
        for canon, sites in sorted(twin.constants_by_canonical().items()):
            if len(sites) < 2:
                continue
            ref_path, ref_val, _ref_line, ref_anchor = sites[0]
            for path, val, line, _anchor in sites[1:]:
                if _values_equal(val, ref_val):
                    continue
                findings.append(Finding(
                    self.id, self.severity, path, line, 0,
                    f"protocol constant {canon} = {_fmt(val)} here but the "
                    f"{twin.plane_of(ref_path)} plane has {_fmt(ref_val)} "
                    f"({ref_path}#{ref_anchor}) — twins must agree or carry "
                    f"a reasoned pragma"))
        return findings


def _values_equal(a: object, b: object) -> bool:
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(
            _values_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, (int, float)) and isinstance(b, (int, float)):
        return float(a) == float(b)
    return a == b


class TransitionDriftRule(TwinRule):
    id = "SIM202"
    severity = "error"
    short = "TCP state-transition table drift between twins"

    def run(self, twin: TwinModel) -> List[Finding]:
        tables = twin.transition_tables()
        if len(tables) < 2:
            return []
        paths = sorted(tables, key=lambda p: (twin.plane_of(p) != "python", p))
        ref_path = paths[0]
        ref = tables[ref_path]
        findings: List[Finding] = []
        for path in paths[1:]:
            cur = tables[path]
            for st in sorted(set(ref["states"]) - set(cur["states"])):
                findings.append(Finding(
                    self.id, self.severity, path, 1, 0,
                    f"TCP state {st!r} exists in {ref_path} but not in "
                    f"this twin's state table"))
            for st in sorted(set(cur["states"]) - set(ref["states"])):
                findings.append(Finding(
                    self.id, self.severity, path, 1, 0,
                    f"TCP state {st!r} exists only in this twin — "
                    f"{ref_path} has no such state"))
            missing = sorted(set(ref["pairs"]) - set(cur["pairs"]))
            for f, t in missing:
                ref_line = ref["pairs"][(f, t)]
                findings.append(Finding(
                    self.id, self.severity, path, 1, 0,
                    f"transition {f} -> {t} ({ref_path}:{ref_line}) has no "
                    f"counterpart in this twin"))
            extra = sorted(set(cur["pairs"]) - set(ref["pairs"]))
            for f, t in extra:
                findings.append(Finding(
                    self.id, self.severity, path, cur["pairs"][(f, t)], 0,
                    f"transition {f} -> {t} exists only in this twin — "
                    f"{ref_path} never makes it"))
        return findings


class SurfaceMapRule(TwinRule):
    id = "SIM203"
    severity = "error"
    short = "twin missing a mapped counterpart surface"

    def run(self, twin: TwinModel) -> List[Finding]:
        findings: List[Finding] = []
        for surface, entries in sorted(twin.map.items()):
            for e in entries:
                if e.path not in twin.sources:
                    findings.append(Finding(
                        self.id, self.severity, "pyproject.toml", 1, 0,
                        f"surface {surface!r} maps {e.plane}:{e.path} but "
                        f"the file does not exist"))
                    continue
                if not e.symbol:
                    continue
                if e.plane == "c" or e.path in twin.cuda_paths:
                    ext = twin.c_extracts.get(e.path)
                    found = ext is not None and e.symbol in ext.symbols
                else:
                    ext2 = twin.py_extracts.get(e.path)
                    found = ext2 is not None and e.symbol in ext2.symbols
                if not found:
                    findings.append(Finding(
                        self.id, self.severity, e.path, 1, 0,
                        f"surface {surface!r} expects symbol `{e.symbol}` "
                        f"in this {e.plane} twin but it is not defined — "
                        f"unmapped or renamed counterpart"))
        return findings


class KernelDtypeRule(TwinRule):
    id = "SIM204"
    severity = "error"
    short = "dtype/overflow hazard in a device kernel"

    def run(self, twin: TwinModel) -> List[Finding]:
        findings: List[Finding] = []
        for rel in sorted(twin.kernel_paths):
            ctx = twin.py_ctx.get(rel)
            if ctx is not None:
                findings.extend(kernel_dtype_findings(ctx))
            elif rel in twin.c_extracts:
                for line, col, msg in cuspec.narrowing_findings(
                        rel, twin.sources[rel]):
                    findings.append(Finding(self.id, self.severity, rel,
                                            line, col, msg))
        return findings


class GeneratedRegionRule(TwinRule):
    id = "SIM205"
    severity = "error"
    short = "hand-edited or stale simgen-generated region"

    def run(self, twin: TwinModel) -> List[Finding]:
        from .genmark import scan_regions, sha12
        findings: List[Finding] = []
        for rel in sorted(twin.sources):
            if not rel.endswith((".py", ".cc", ".cpp", ".h")
                                + cuspec.CUDA_EXTS):
                continue
            regions, problems = scan_regions(twin.sources[rel])
            for line, msg in problems:
                findings.append(Finding(
                    self.id, self.severity, rel, line, 0, msg))
            for reg in regions:
                if sha12(reg.body) != reg.body_hash:
                    findings.append(Finding(
                        self.id, self.severity, rel, reg.begin_line, 0,
                        f"generated region {reg.name!r} was edited by "
                        f"hand (body digest drift) — the spec is "
                        f"authoritative: edit spec/protocol_spec.json "
                        f"and run `make gen`"))
                elif twin.spec_digest is not None \
                        and reg.spec_hash != twin.spec_digest:
                    findings.append(Finding(
                        self.id, self.severity, rel, reg.begin_line, 0,
                        f"generated region {reg.name!r} is stale: emitted "
                        f"from spec {reg.spec_hash}, current spec is "
                        f"{twin.spec_digest} — run `make gen`"))
        return findings


class LogicDriftRule(TwinRule):
    id = "SIM206"
    severity = "error"
    short = "emitted logic expression drifted from the spec IR"

    def run(self, twin: TwinModel) -> List[Finding]:
        import json

        from . import logic_ir
        if twin.spec_text is None:
            return []
        try:
            spec = json.loads(twin.spec_text)
        except ValueError:
            return []
        fns = spec.get("logic", {}).get("functions", {})
        constants = spec.get("constants", {})
        if not fns:
            return []
        findings: List[Finding] = []
        resolved: Dict[str, object] = {}
        for name, fn in sorted(fns.items()):
            try:
                resolved[name] = logic_ir.resolve(fn["expr"], constants)
            except logic_ir.IRError as exc:
                findings.append(Finding(
                    self.id, self.severity, "spec/protocol_spec.json", 1, 0,
                    f"logic fn {name}: spec expression does not resolve: "
                    f"{exc}"))
        for plane, got in sorted(twin.logic_functions_by_plane().items()):
            if not got:
                # a source set without a logic surface on this plane
                # (fixtures, partial maps) is not drift
                continue
            anchor = sorted(g[3] for g in got.values())[0]
            for name in sorted(set(fns) - set(got)):
                findings.append(Finding(
                    self.id, self.severity, anchor, 1, 0,
                    f"spec logic fn {name} has no "
                    f"`{logic_ir.plane_symbol(name, plane)}` on the "
                    f"{plane} plane — run `make gen`"))
            for name, (args, ir, line, rel) in sorted(got.items()):
                sym = logic_ir.plane_symbol(name, plane)
                fn = fns.get(name)
                if fn is None:
                    findings.append(Finding(
                        self.id, self.severity, rel, line, 0,
                        f"`{sym}` matches the generated-logic naming "
                        f"convention but the spec has no logic fn "
                        f"{name!r}"))
                    continue
                if list(args) != list(fn["args"]):
                    findings.append(Finding(
                        self.id, self.severity, rel, line, 0,
                        f"`{sym}` takes {list(args)} but the spec says "
                        f"{list(fn['args'])}"))
                    continue
                if ir is None:
                    findings.append(Finding(
                        self.id, self.severity, rel, line, 0,
                        f"`{sym}` body is not a single expression of the "
                        f"portable logic vocabulary — the spec is "
                        f"authoritative: edit spec/protocol_spec.json "
                        f"and run `make gen`"))
                    continue
                want = resolved.get(name)
                if want is None:
                    continue    # unresolvable spec expr already reported
                diff = logic_ir.structural_diff(want, ir)
                if diff:
                    findings.append(Finding(
                        self.id, self.severity, rel, line, 0,
                        f"`{sym}` drifted from the spec logic IR: {diff} "
                        f"— the spec is authoritative: edit "
                        f"spec/protocol_spec.json and run `make gen`"))
        return findings


CATALOG: List[TwinRule] = [
    ConstantDriftRule(),
    TransitionDriftRule(),
    SurfaceMapRule(),
    KernelDtypeRule(),
    GeneratedRegionRule(),
    LogicDriftRule(),
]


# ---------------------------------------------------------------------------
# spec serialization (simtwin --emit-spec)

SPEC_VERSION = 1


def build_spec(twin: TwinModel) -> Dict:
    """The cross-plane protocol IR as one JSON-stable dict: every mapping
    sorted, every value a plain int/float/str/list — byte-identical across
    runs and PYTHONHASHSEED values."""
    constants: Dict[str, Dict] = {}
    for canon, sites in sorted(twin.constants_by_canonical().items()):
        per_plane: Dict[str, Dict] = {}
        for path, val, _line, anchor in sites:
            plane = twin.plane_of(path)
            # symbol-anchored source attribution: a generated region
            # changing the file's length must not churn the spec
            per_plane.setdefault(plane, {
                "value": val, "source": f"{path}#{anchor}"})
        constants[canon] = per_plane
    transitions: Dict[str, Dict] = {}
    for path, table in sorted(twin.transition_tables().items()):
        transitions[path] = {
            "plane": twin.plane_of(path),
            "states": sorted(table["states"]),
            "pairs": sorted(f"{f} -> {t}" for f, t in table["pairs"]),
        }
    surfaces: Dict[str, Dict] = {}
    for surface, entries in sorted(twin.map.items()):
        per_file: Dict[str, List[str]] = {}
        for e in sorted(entries,
                        key=lambda x: (x.plane, x.path, x.symbol or "")):
            per_file.setdefault(e.plane + ":" + e.path, []).append(
                e.symbol or "*")
        surfaces[surface] = per_file
    # the logic surface as read back from the authoritative python plane:
    # parsed (literal) expression trees, one entry per emitted function
    from . import logic_ir
    logic: Dict[str, Dict] = {}
    for name, (args, ir, _line, rel) in sorted(
            twin.logic_functions_by_plane()["py"].items()):
        if ir is None:
            continue
        logic[name] = {
            "args": list(args), "expr": ir,
            "source": f"{rel}#{logic_ir.plane_symbol(name, 'py')}",
        }
    return {
        "version": SPEC_VERSION,
        "generator": "simtwin --emit-spec",
        "constants": constants,
        "transitions": transitions,
        "surfaces": surfaces,
        "logic": logic,
    }
