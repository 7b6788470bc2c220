"""simgen: spec-authoritative protocol codegen for the three planes.

simtwin extracted ONE table-driven IR from the three hand-synced
protocol planes and diffed them at lint time; ``spec/protocol.json`` was
the *extracted* seed artifact.  simgen inverts the direction (ROADMAP
item 3): ``spec/protocol_spec.json`` is now AUTHORITATIVE, and the
protocol surfaces it names — the canonical constants, the TCP
state-transition table, the token-bucket/CoDel hop-math coefficients,
and the congestion-control coefficient families — are *emitted* into
fenced, checksummed regions of the Python plane, the native C plane and
the JAX/numpy kernel modules.  A protocol change is now one spec edit +
``make gen``, not three hand-synced transcriptions.

The verification stack, outermost first:

* ``make gen-check`` (== ``simgen --check``, wired into ``make lint``):
  every declared region byte-matches what the generator would emit
  today (stale spec or hand edit both fail), and the *read-back* gate
  re-extracts the planes with simtwin's extractors and diffs the IR
  against the spec — the generated code must mean what the spec says,
  not merely look generated.
* SIM205 (twin_rules): lint-time detection of hand edits inside a
  fenced region (``body=`` digest drift) and of regions older than the
  spec (``spec=`` digest drift), with the shared pragma vocabulary.
* SIM201-204 keep diffing the planes against each other, and
  ``spec/protocol.json`` (the extracted IR) stays checked in and
  byte-stable — regeneration after ``make gen`` is part of the flow.

In the port the emission table (``REGIONS``) is the JAX package's Python
regions at the port's paths, and the CUDA kernel plane's own: Threefry's
parity and rotations in ``ops/csrc/threefry.cuh`` (constexprs that
``threefry2x32_x0`` reads), the refill tick in ``ops/csrc/admit_sorted.cu``
with its multiply-high reciprocal computed here and checked against
Granlund and Montgomery's condition (:func:`refill_magic`), and the cell's
header bytes in ``pack_flush.cu``, ``span_tile.cuh`` and
``torcells_run.cu``.  ``--write`` writes only those (the port's files);
``--check`` also holds native/'s regions to the spec, which only the JAX
package's generator (``make gen``) writes.  The messages name ``make
gen``; for a region of the port, ``--write`` here is its ``make gen``.
The spec stays the repository's ``spec/protocol_spec.json``.

Usage::

    python -m shadow_tpu_torch.analysis.simgen [--check | --write | --list]
        [--spec PATH] [--root PATH] [--no-readback]

Exit status: 0 = clean, 1 = stale/hand-edited/IR-drift, 2 = usage error.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Callable, Dict, List, Optional, Tuple

from . import logic_ir
from .genmark import (SPEC_RELPATH, begin_marker, end_marker, scan_regions,
                      sha12)

PY, C = "#", "//"


# ---------------------------------------------------------------------------
# spec loading

def load_spec(path: str) -> Tuple[Dict, str]:
    """(spec dict, sha12 of the exact file bytes)."""
    with open(path, "rb") as f:
        blob = f.read()
    return json.loads(blob.decode("utf-8")), sha12(blob)


def canonical_spec_bytes(spec: Dict) -> bytes:
    return (json.dumps(spec, indent=2, sort_keys=True) + "\n").encode()


# ---------------------------------------------------------------------------
# renderers: spec -> region body lines (indent included where non-zero)

def _pairs(spec: Dict) -> List[Tuple[str, str]]:
    out = []
    for p in spec["transitions"]["pairs"]:
        frm, _, to = p.partition(" -> ")
        out.append((frm, to))
    return out


def _variant_class_name(name: str, base: str) -> str:
    # "cubicx" extending "cubic" -> CubicX
    return base.capitalize() + name[len(base):].upper()


def _r_wire_defs(spec: Dict) -> List[str]:
    c = spec["constants"]
    assert c["MSS"] == c["MTU"] - (c["HDR_TCP"] - 14), \
        "spec MSS must equal MTU - (HDR_TCP - 14)"
    ms = 1000000
    return [
        "# Ethernet/IP framing (reference definitions.h:169-193).",
        f"CONFIG_HEADER_SIZE_UDPIPETH = {c['HDR_UDP']}    "
        "# UDP+IP+ETH header bytes",
        f"CONFIG_HEADER_SIZE_TCPIPETH = {c['HDR_TCP']}    "
        "# TCP+IP+ETH header bytes (with options)",
        f"CONFIG_MTU = {c['MTU']}",
        f"CONFIG_DATAGRAM_MAX_SIZE = {c['DGRAM_MAX']}",
        "CONFIG_TCP_MAX_SEGMENT_SIZE = CONFIG_MTU - "
        f"(CONFIG_HEADER_SIZE_TCPIPETH - 14)  # {c['MSS']}",
        "",
        "# Interface token bucket "
        "(reference network_interface.c:93-95, 207-214).",
        f"INTERFACE_REFILL_INTERVAL_NS = {c['REFILL_INTERVAL_NS']}"
        "        # 1 ms token refill",
        f"INTERFACE_CAPACITY_FACTOR = {c['CAPACITY_FACTOR']}"
        "                   # capacity = refill*factor + MTU",
        "",
        "# TCP buffer caps (reference definitions.h:109-114).",
        f"CONFIG_TCP_WMEM_MAX = {c['WMEM_MAX']}",
        f"CONFIG_TCP_RMEM_MAX = {c['RMEM_MAX']}",
        "",
        "# TCP retransmit-timer bounds, ms "
        "(reference definitions.h:115-131).",
        f"CONFIG_TCP_RTO_INIT_MS = {c['RTO_INIT_NS'] // ms}",
        f"CONFIG_TCP_RTO_MIN_MS = {c['RTO_MIN_NS'] // ms}",
        f"CONFIG_TCP_RTO_MAX_MS = {c['RTO_MAX_NS'] // ms}",
    ]


def _r_clock(spec: Dict) -> List[str]:
    c = spec["constants"]
    return [
        "# One simulated nanosecond is the base unit.",
        "SIM_TIME_NS = 1",
        f"SIM_TIME_US = {c['SIM_TIME_MS'] // 1000}",
        f"SIM_TIME_MS = {c['SIM_TIME_MS']}",
        f"SIM_TIME_SEC = {c['SIM_TIME_SEC']}",
    ]


def _r_tcp_flags(spec: Dict) -> List[str]:
    c = spec["constants"]
    return [
        "# TCP header flag bits (reference tcp.c enum ProtocolTCPFlags).",
        "TCP_NONE = 0",
        f"TCP_RST = {c['FLAG_RST']}",
        f"TCP_SYN = {c['FLAG_SYN']}",
        f"TCP_ACK = {c['FLAG_ACK']}",
        f"TCP_FIN = {c['FLAG_FIN']}",
    ]


def _r_status_bits(spec: Dict) -> List[str]:
    c = spec["constants"]
    return [
        "# Status bits (reference descriptor.h DS_*).",
        "S_NONE = 0",
        f"S_ACTIVE = {c['S_ACTIVE']}",
        f"S_READABLE = {c['S_READABLE']}",
        f"S_WRITABLE = {c['S_WRITABLE']}",
        f"S_CLOSED = {c['S_CLOSED']}",
    ]


def _r_epoll_bits(spec: Dict) -> List[str]:
    c = spec["constants"]
    return [
        f"EPOLLIN = 0x{c['EPOLLIN']:03x}",
        f"EPOLLOUT = 0x{c['EPOLLOUT']:03x}",
        f"EPOLLERR = 0x{c['EPOLLERR']:03x}",
        f"EPOLLHUP = 0x{c['EPOLLHUP']:03x}",
    ]


def _r_c_epoll_bits(spec: Dict) -> List[str]:
    c = spec["constants"]
    return [
        "// epoll readiness bits (descriptor/epoll.py) — the C-side",
        "// readiness cache (ISSUE 12) computes revents for epoll-watched",
        "// native sockets with these",
        f"enum {{ EPOLLIN = 0x{c['EPOLLIN']:03x}, "
        f"EPOLLOUT = 0x{c['EPOLLOUT']:03x}, "
        f"EPOLLERR = 0x{c['EPOLLERR']:03x}, "
        f"EPOLLHUP = 0x{c['EPOLLHUP']:03x} }};",
    ]


def _r_port_alloc(spec: Dict) -> List[str]:
    c = spec["constants"]
    return [
        f"MIN_EPHEMERAL_PORT = {c['MIN_EPHEMERAL_PORT']}",
        f"MAX_PORT = {c['MAX_PORT']}",
    ]


def _r_threefry(spec: Dict) -> List[str]:
    c = spec["constants"]
    rots = ", ".join(str(r) for r in c["THREEFRY_ROTATIONS"])
    return [
        "# Threefry-2x32 rotation constants (Salmon et al., Table 2).",
        f"_ROTATIONS = ({rots})",
        f"_PARITY = 0x{c['THREEFRY_PARITY']:X}  # SKEIN_KS_PARITY32",
    ]


def _r_tcp_states(spec: Dict) -> List[str]:
    lines = ["# states (reference tcp.c enum TCPState :42-47)"]
    for st in spec["transitions"]["states"]:
        lines.append(f"{st.upper()} = \"{st}\"")
    lines += [
        "",
        "# The spec's legal (from, to) transition pairs; \"?\" = an",
        "# assignment no state guard encloses.",
        "TCP_TRANSITIONS = (",
    ]
    for frm, to in _pairs(spec):
        lines.append(f"    (\"{frm}\", \"{to}\"),")
    lines.append(")")
    return lines


def _r_tcp_timers(spec: Dict) -> List[str]:
    c = spec["constants"]
    return [
        f"RTO_INIT_NS = {c['RTO_INIT_NS']}",
        f"RTO_MIN_NS = {c['RTO_MIN_NS']}",
        f"RTO_MAX_NS = {c['RTO_MAX_NS']}",
        f"TIME_WAIT_NS = {c['TIME_WAIT_NS']}"
        "        # 2*MSL teardown hold",
        f"MAX_SYN_RETRIES = {c['MAX_SYN_RETRIES']}"
        "                           # Linux tcp_syn_retries default",
        f"MAX_RETRIES = {c['MAX_RETRIES']}"
        "                              # Linux tcp_retries2",
        f"MAX_SACK_BLOCKS = {c['MAX_SACK_BLOCKS']}",
    ]


def _r_codel_params(spec: Dict) -> List[str]:
    c = spec["constants"]
    return [
        f"    TARGET_NS = {c['CODEL_TARGET_NS']}",
        f"    INTERVAL_NS = {c['CODEL_INTERVAL_NS']}",
        f"    HARD_LIMIT = {c['CODEL_HARD_LIMIT']}  # packets",
    ]


def _r_router_static(spec: Dict) -> List[str]:
    c = spec["constants"]
    return [
        f"STATIC_CAPACITY = {c['STATIC_CAPACITY']}"
        "  # packets (reference router_queue_static.c)",
    ]


def _r_congestion_params(spec: Dict) -> List[str]:
    c = spec["constants"]
    lines = ["# CUBIC coefficient families (RFC 9438 §4.1 / §4.6)."]
    for name, var in sorted(spec["congestion"]["variants"].items()):
        lines.append(f"{var['c_const']} = {c[var['c_const']]!r}"
                     f"      # {name}: scaling constant")
        lines.append(f"{var['beta_const']} = {c[var['beta_const']]!r}"
                     f"   # {name}: multiplicative decrease")
    return lines


def _r_congestion_variants(spec: Dict) -> List[str]:
    c = spec["constants"]
    lines: List[str] = []
    generated: List[Tuple[str, str]] = []
    for name, var in sorted(spec["congestion"]["variants"].items()):
        base = var.get("base")
        if base is None:
            continue              # the base algorithm is hand-written
        cls = _variant_class_name(name, base)
        generated.append((name, cls))
        lines += [
            f"class {cls}({base.capitalize()}):",
            f"    \"\"\"Spec-defined CUBIC variant {name!r}: "
            f"(C, beta) = ({c[var['c_const']]!r}, "
            f"{c[var['beta_const']]!r}).",
            "",
            f"    Same window-growth machinery as {base.capitalize()} "
            "(the base class reads",
            "    ``self.C``/``self.BETA``); only the coefficients "
            "differ.",
            "    \"\"\"",
            "",
            f"    name = \"{name}\"",
            f"    C = {var['c_const']}",
            f"    BETA = {var['beta_const']}",
            "",
            "",
        ]
    lines += _r_family_classes(spec)
    for name in sorted(spec["congestion"].get("families", {})):
        generated.append((name, _family_class_name(spec, name)))
    lines.append("# config token -> generated class "
                 "(make_congestion_control consults this)")
    lines.append("CC_GENERATED = {")
    for name, cls in sorted(generated):
        lines.append(f"    \"{name}\": {cls},")
    lines.append("}")
    return lines


def _logic_functions(spec: Dict, group: Optional[str] = None
                     ) -> List[Tuple[str, Dict]]:
    fns = spec.get("logic", {}).get("functions", {})
    return [(name, fns[name]) for name in sorted(fns)
            if group is None or fns[name].get("group") == group]


def _resolved_expr(spec: Dict, fn: Dict):
    logic_ir.validate(fn["expr"], fn["args"], spec["constants"])
    return logic_ir.resolve(fn["expr"], spec["constants"])


def _bbrx_const_names(spec: Dict) -> List[str]:
    return sorted(n for n in spec["constants"] if n.startswith("BBRX_"))


def _py_logic_lines(spec: Dict, group: str) -> List[str]:
    lines: List[str] = []
    for name, fn in _logic_functions(spec, group):
        expr = logic_ir.emit_py(_resolved_expr(spec, fn))
        lines += [
            f"def {logic_ir.plane_symbol(name, 'py')}"
            f"({', '.join(fn['args'])}):",
            f"    \"\"\"{fn['doc']}\"\"\"",
            f"    return {expr}",
            "",
            "",
        ]
    while lines and lines[-1] == "":
        lines.pop()
    return lines


def _r_tcp_logic(spec: Dict) -> List[str]:
    lines = [
        "# RTT/RTO update logic, generated from the spec's expression IR",
        "# (SIM206 parses these bodies back and compares them to the "
        "spec).",
        "",
    ]
    lines += _py_logic_lines(spec, "rtt")
    return lines


def _r_congestion_logic(spec: Dict) -> List[str]:
    c = spec["constants"]
    lines = ["# bbrx estimator parameters (spec surface: congestion)"]
    for name in _bbrx_const_names(spec):
        lines.append(f"{name} = {c[name]}")
    lines += [
        "",
        "",
        "# congestion update logic, generated from the spec's "
        "expression IR",
        "",
    ]
    lines += _py_logic_lines(spec, "cc")
    return lines


def _family_class_name(spec: Dict, name: str) -> str:
    return spec["congestion"]["families"][name]["class"]


def _r_family_classes(spec: Dict) -> List[str]:
    """The generated CC family classes.  The expressions come
    from the spec's logic IR (via the ``_g_*`` helpers emitted into the
    congestion-logic region); the hook scaffold below is the generator's
    one estimator shape, so an unknown family fails generation loudly
    instead of emitting garbage."""
    fams = spec["congestion"].get("families", {})
    unknown = sorted(set(fams) - {"bbrx"})
    if unknown:
        raise ValueError(
            f"no generator scaffold for congestion families {unknown}; "
            f"teach simgen._r_family_classes before adding them")
    if "bbrx" not in fams:
        return []
    cls = _family_class_name(spec, "bbrx")
    return [
        f"class {cls}(CongestionControl):",
        "    \"\"\"Spec-defined 'bbrx' (ISSUE 19): a BBR-flavored "
        "family — windowed",
        "    bandwidth (max filter + loss decay), min-RTT from ACK "
        "spacing, a",
        "    pacing-gain cycle, and an inflight cap from the BDP.  "
        "Every update",
        "    expression is generated from the spec's logic IR; this "
        "class holds",
        "    only the estimator state and the hook wiring.",
        "    \"\"\"",
        "",
        "    name = \"bbrx\"",
        "",
        "    def __init__(self, mss, ssthresh=0,",
        "                 init_segments=INIT_CWND_SEGMENTS):",
        "        super().__init__(mss, ssthresh, init_segments)",
        "        self.btl_bw_bps = 0",
        "        self.min_rtt_ns = BBRX_RTT_CAP_NS",
        "        self.last_ack_ns = 0",
        "        self.cycle_idx = 0",
        "        self.cycle_start_ns = 0",
        "",
        "    def on_new_ack(self, acked_bytes, snd_una, now_ns):",
        "        if self.in_fast_recovery:",
        "            if snd_una >= self.recovery_point:",
        "                self._exit_recovery()",
        "            else:",
        "                return  # partial ACK: stay in recovery",
        "        if self.last_ack_ns > 0:",
        "            interval_ns = now_ns - self.last_ack_ns",
        "            self.btl_bw_bps = _g_bbrx_btl_bw(",
        "                self.btl_bw_bps,",
        "                _g_bbrx_bw_sample(acked_bytes, interval_ns))",
        "            self.min_rtt_ns = _g_bbrx_min_rtt(self.min_rtt_ns,",
        "                                              interval_ns)",
        "        self.last_ack_ns = now_ns",
        "        if now_ns - self.cycle_start_ns >= BBRX_CYCLE_NS:",
        "            self.cycle_idx = _g_bbrx_next_cycle(self.cycle_idx)",
        "            self.cycle_start_ns = now_ns",
        "        if self.btl_bw_bps > 0:",
        "            self.cwnd = _g_bbrx_inflight_cap(",
        "                _g_bbrx_bdp_bytes(self.btl_bw_bps, "
        "self.min_rtt_ns),",
        "                _g_bbrx_gain_num(self.cycle_idx), self.mss)",
        "",
        "    def _enter_recovery(self, snd_nxt):",
        "        self.btl_bw_bps = _g_bbrx_bw_decay(self.btl_bw_bps)",
        "        self.ssthresh = _g_ssthresh_after_loss(self.cwnd, "
        "self.mss)",
        "        self.cwnd = _g_recovery_cwnd(self.ssthresh, self.mss)",
        "        self.in_fast_recovery = True",
        "        self.recovery_point = snd_nxt",
        "",
        "    def on_timeout(self):",
        "        self.btl_bw_bps = _g_bbrx_bw_decay(self.btl_bw_bps)",
        "        self.ssthresh = _g_ssthresh_after_loss(self.cwnd, "
        "self.mss)",
        "        self.cwnd = self.mss",
        "        self.in_fast_recovery = False",
        "        self._avoid_acc = 0",
        "",
        "",
    ]


def _r_token_bucket_kernel(spec: Dict) -> List[str]:
    c = spec["constants"]
    return [
        f"REFILL_NS = {c['REFILL_INTERVAL_NS']}"
        "   # == defs.INTERFACE_REFILL_INTERVAL_NS (1 ms)",
    ]


def _r_protocol_tables(spec: Dict) -> List[str]:
    c = spec["constants"]
    states = spec["transitions"]["states"]
    lines = [
        "# TCP state universe, reference-enum order; the tuple index IS",
        "# the C-plane TcpState id.",
        "TCP_STATES = (",
    ]
    for st in states:
        lines.append(f"    \"{st}\",")
    lines += [
        ")",
        "",
        "# Legal (from, to) transition pairs; \"?\" = unguarded.",
        "TCP_TRANSITIONS = (",
    ]
    for frm, to in _pairs(spec):
        lines.append(f"    (\"{frm}\", \"{to}\"),")
    lines += [")", "", "# Congestion-control coefficient families "
              "+ config-token kind ids."]
    variants = sorted(spec["congestion"]["variants"].items())
    for name, var in variants:
        lines.append(f"{var['c_const']} = {c[var['c_const']]!r}")
        lines.append(f"{var['beta_const']} = {c[var['beta_const']]!r}")
    kinds = sorted(spec["congestion"]["kinds"].items())
    lines.append("CC_KIND_IDS = {"
                 + ", ".join(f"\"{k}\": {v}" for k, v in kinds) + "}")
    by_kind = {var["kind"]: var for _, var in variants}
    lines.append("# (C, beta) per kind id; non-cubic kinds carry the "
                 "cubic defaults (unused)")
    lines.append("CC_COEFFS = {")
    for k, kid in kinds:
        var = by_kind.get(kid, dict(spec["congestion"]["variants"]["cubic"]))
        lines.append(f"    {kid}: ({var['c_const']}, "
                     f"{var['beta_const']}),  # {k}")
    lines.append("}")
    return lines


def _r_c_constants(spec: Dict) -> List[str]:
    c = spec["constants"]
    return [
        "// ---- constants (mirror core/defs.py / descriptor/tcp.py) "
        "------------------",
        f"constexpr int64_t SIM_MS = {c['SIM_TIME_MS']}LL;",
        f"constexpr int64_t SIM_SEC = {c['SIM_TIME_SEC']}LL;",
        f"constexpr int HDR_UDP = {c['HDR_UDP']};",
        f"constexpr int HDR_TCP = {c['HDR_TCP']};",
        f"constexpr int64_t MTU = {c['MTU']};",
        f"constexpr int64_t MSS = {c['MTU']} - ({c['HDR_TCP']} - 14);"
        f"          // {c['MSS']}",
        f"constexpr int64_t RTO_INIT = {c['RTO_INIT_NS']}LL;",
        f"constexpr int64_t RTO_MIN = {c['RTO_MIN_NS']}LL;",
        f"constexpr int64_t RTO_MAX = {c['RTO_MAX_NS']}LL;",
        f"constexpr int64_t TIME_WAIT_NS = {c['TIME_WAIT_NS']}LL;",
        f"constexpr int MAX_SYN_RETRIES = {c['MAX_SYN_RETRIES']};",
        f"constexpr int MAX_RETRIES = {c['MAX_RETRIES']};"
        "                    // Linux tcp_retries2",
        f"constexpr int MAX_SACK_BLOCKS = {c['MAX_SACK_BLOCKS']};",
        f"constexpr int64_t RMEM_MAX = {c['RMEM_MAX']};",
        f"constexpr int64_t WMEM_MAX = {c['WMEM_MAX']};",
        f"constexpr int64_t REFILL_INTERVAL = {c['REFILL_INTERVAL_NS']}LL;"
        "     // 1 ms",
        f"constexpr int64_t CAPACITY_FACTOR = {c['CAPACITY_FACTOR']};",
        f"constexpr int64_t DGRAM_MAX = {c['DGRAM_MAX']};",
        f"constexpr int64_t CODEL_TARGET = {c['CODEL_TARGET_NS']}LL;",
        f"constexpr int64_t CODEL_INTERVAL = {c['CODEL_INTERVAL_NS']}LL;",
        f"constexpr int CODEL_HARD_LIMIT = {c['CODEL_HARD_LIMIT']};",
        f"constexpr int STATIC_CAPACITY = {c['STATIC_CAPACITY']};",
        "",
        "// descriptor status bits (descriptor/base.py)",
        f"enum {{ S_ACTIVE = {c['S_ACTIVE']}, "
        f"S_READABLE = {c['S_READABLE']}, "
        f"S_WRITABLE = {c['S_WRITABLE']}, S_CLOSED = {c['S_CLOSED']} }};",
        "// TCP header flags (routing/packet.py)",
        f"enum {{ F_RST = {c['FLAG_RST']}, F_SYN = {c['FLAG_SYN']}, "
        f"F_ACK = {c['FLAG_ACK']}, F_FIN = {c['FLAG_FIN']} }};",
    ]


def _chunked(tokens: List[str], per_line: int = 5) -> List[str]:
    return ["  " + ", ".join(tokens[i:i + per_line]) + ","
            for i in range(0, len(tokens), per_line)]


def _r_c_tcp_states(spec: Dict) -> List[str]:
    states = spec["transitions"]["states"]
    lines = ["enum TcpState {"]
    lines += _chunked([f"ST_{s.upper()}" + (" = 0" if i == 0 else "")
                       for i, s in enumerate(states)])
    lines += ["};", "const char *const STATE_NAMES[] = {"]
    lines += _chunked([f"\"{s}\"" for s in states])
    lines += [
        "};",
        "// the spec's legal transition table; 255 = any state ('?')",
        "struct TcpTransition { unsigned char from, to; };",
        "constexpr TcpTransition TCP_TRANSITIONS[] = {",
    ]
    for frm, to in _pairs(spec):
        f_tok = "255" if frm == "?" else f"ST_{frm.upper()}"
        lines.append(f"  {{{f_tok}, ST_{to.upper()}}},")
    lines += [
        "};",
        "constexpr int TCP_TRANSITION_COUNT =",
        "    (int)(sizeof(TCP_TRANSITIONS) / sizeof(TCP_TRANSITIONS[0]));",
    ]
    return lines


def _r_c_congestion_params(spec: Dict) -> List[str]:
    c = spec["constants"]
    kinds = sorted(spec["congestion"]["kinds"].items(), key=lambda kv: kv[1])
    enum_body = ", ".join(f"CC_{k.upper()} = {v}" for k, v in kinds)
    lines = [f"enum CcKind {{ {enum_body} }};",
             "// CUBIC coefficient families (RFC 9438 §4.1 / §4.6)"]
    cubics = [(n, v) for n, v in sorted(spec["congestion"]["variants"]
                                        .items())]
    for name, var in cubics:
        lines.append(f"constexpr double {var['c_const']} = "
                     f"{c[var['c_const']]!r};")
        lines.append(f"constexpr double {var['beta_const']} = "
                     f"{c[var['beta_const']]!r};")
    is_cubic = " || ".join(f"kind == CC_{n.upper()}" for n, _ in cubics)
    lines += [f"inline bool cc_is_cubic(int kind) {{ return {is_cubic}; }}"]
    for field in ("c", "beta"):
        expr = f"CUBIC_{field.upper()}"
        for name, var in cubics:
            if var.get("base") is None:
                continue
            expr = (f"kind == CC_{name.upper()} ? "
                    f"{var[field + '_const']} : " + expr)
        lines.append(f"inline double cc_{field}(int kind) "
                     f"{{ return {expr}; }}")
    return lines


def _r_c_protocol_logic(spec: Dict) -> List[str]:
    """All spec logic functions as pure int64 free functions, plus the
    bbrx parameter constants.  ``gen_i64_min/max`` exist so the emitted
    expressions stay call-shaped (parseable by the SIM206 read-back)
    instead of template-instantiated ``std::max<int64_t>`` spellings."""
    c = spec["constants"]
    lines = [
        "// generated int64 protocol-update logic (spec 'logic' IR); "
        "SIM206",
        "// parses each body back to the IR and compares it to the spec.",
        "static inline int64_t gen_i64_min(int64_t a, int64_t b) "
        "{ return a < b ? a : b; }",
        "static inline int64_t gen_i64_max(int64_t a, int64_t b) "
        "{ return a > b ? a : b; }",
        "// bbrx estimator parameters (spec surface: congestion)",
    ]
    for name in _bbrx_const_names(spec):
        lines.append(f"constexpr int64_t {name} = {c[name]}LL;")
    for name, fn in _logic_functions(spec):
        expr = logic_ir.emit_c(_resolved_expr(spec, fn))
        args = ", ".join(f"int64_t {a}" for a in fn["args"])
        lines += [
            f"// {fn['doc']}",
            f"static inline int64_t "
            f"{logic_ir.plane_symbol(name, 'c')}({args}) {{",
            f"  return {expr};",
            "}",
        ]
    return lines


def _r_c_congestion_logic(spec: Dict) -> List[str]:
    """The generated-family estimator state + hook dispatch, emitted
    INSIDE ``struct Cong`` (the hand hooks call ``gen_on_*`` first and
    return when a generated family handled the event).  Mirrors the
    Python ``BbrX`` scaffold statement for statement."""
    fams = spec["congestion"].get("families", {})
    unknown = sorted(set(fams) - {"bbrx"})
    if unknown:
        raise ValueError(
            f"no generator scaffold for congestion families {unknown}; "
            f"teach simgen._r_c_congestion_logic before adding them")
    if "bbrx" not in fams:
        return ["  // no generated congestion families in the spec",
                "  void gen_init() {}",
                "  bool gen_on_new_ack(int64_t, int64_t, int64_t) "
                "{ return false; }",
                "  bool gen_on_duplicate_ack(int, int64_t, bool*) "
                "{ return false; }",
                "  bool gen_on_timeout() { return false; }"]
    return [
        "  // generated 'bbrx' estimator state + dispatch (spec "
        "congestion.families)",
        "  int64_t gx_btl_bw_bps = 0;",
        "  int64_t gx_min_rtt_ns = BBRX_RTT_CAP_NS;",
        "  int64_t gx_last_ack_ns = 0;",
        "  int64_t gx_cycle_idx = 0;",
        "  int64_t gx_cycle_start_ns = 0;",
        "",
        "  void gen_init() {",
        "    gx_btl_bw_bps = 0;",
        "    gx_min_rtt_ns = BBRX_RTT_CAP_NS;",
        "    gx_last_ack_ns = 0;",
        "    gx_cycle_idx = 0;",
        "    gx_cycle_start_ns = 0;",
        "  }",
        "",
        "  // each hook returns true when a generated family handled "
        "the event",
        "  bool gen_on_new_ack(int64_t acked_bytes, int64_t snd_una, "
        "int64_t now_ns) {",
        "    if (kind != CC_BBRX) return false;",
        "    if (in_fast_recovery) {",
        "      if (snd_una >= recovery_point) exit_recovery();",
        "      else return true;  // partial ACK: stay in recovery",
        "    }",
        "    if (gx_last_ack_ns > 0) {",
        "      int64_t interval_ns = now_ns - gx_last_ack_ns;",
        "      gx_btl_bw_bps = gen_bbrx_btl_bw(",
        "          gx_btl_bw_bps, gen_bbrx_bw_sample(acked_bytes, "
        "interval_ns));",
        "      gx_min_rtt_ns = gen_bbrx_min_rtt(gx_min_rtt_ns, "
        "interval_ns);",
        "    }",
        "    gx_last_ack_ns = now_ns;",
        "    if (now_ns - gx_cycle_start_ns >= BBRX_CYCLE_NS) {",
        "      gx_cycle_idx = gen_bbrx_next_cycle(gx_cycle_idx);",
        "      gx_cycle_start_ns = now_ns;",
        "    }",
        "    if (gx_btl_bw_bps > 0) {",
        "      cwnd = gen_bbrx_inflight_cap(",
        "          gen_bbrx_bdp_bytes(gx_btl_bw_bps, gx_min_rtt_ns),",
        "          gen_bbrx_gain_num(gx_cycle_idx), mss);",
        "    }",
        "    return true;",
        "  }",
        "",
        "  bool gen_on_duplicate_ack(int count, int64_t snd_nxt, "
        "bool* retransmit) {",
        "    if (kind != CC_BBRX) return false;",
        "    *retransmit = false;",
        "    if (count == 3 && !in_fast_recovery) {",
        "      gx_btl_bw_bps = gen_bbrx_bw_decay(gx_btl_bw_bps);",
        "      ssthresh = gen_ssthresh_after_loss(cwnd, mss);",
        "      cwnd = gen_recovery_cwnd(ssthresh, mss);",
        "      in_fast_recovery = true;",
        "      recovery_point = snd_nxt;",
        "      *retransmit = true;",
        "      return true;",
        "    }",
        "    if (in_fast_recovery) cwnd += mss;",
        "    return true;",
        "  }",
        "",
        "  bool gen_on_timeout() {",
        "    if (kind != CC_BBRX) return false;",
        "    gx_btl_bw_bps = gen_bbrx_bw_decay(gx_btl_bw_bps);",
        "    ssthresh = gen_ssthresh_after_loss(cwnd, mss);",
        "    cwnd = mss;",
        "    in_fast_recovery = false;",
        "    avoid_acc = 0;",
        "    return true;",
        "  }",
    ]


def _r_kernel_logic(spec: Dict) -> List[str]:
    """The kernel plane's numpy mirror of every logic function (int64
    in, int64 out; ``np.where``/``np.minimum``/``np.maximum`` spell
    select/min/max so the same read-back grammar covers this plane)."""
    c = spec["constants"]
    lines = ["# bbrx estimator parameters (mirrors descriptor/"
             "tcp_cong.py)"]
    for name in _bbrx_const_names(spec):
        lines.append(f"{name} = {c[name]}")
    lines += [
        "",
        "",
        "# protocol-update logic, generated from the spec's expression "
        "IR;",
        "# elementwise over int64 arrays (device-vs-numpy parity is "
        "pinned in tests)",
        "",
    ]
    for name, fn in _logic_functions(spec):
        expr = logic_ir.emit_np(_resolved_expr(spec, fn))
        lines += [
            f"def {logic_ir.plane_symbol(name, 'kernel')}"
            f"({', '.join(fn['args'])}):",
            f"    \"\"\"{fn['doc']}\"\"\"",
            f"    return {expr}",
            "",
            "",
        ]
    while lines and lines[-1] == "":
        lines.pop()
    return lines


def _r_cuda_threefry(spec: Dict) -> List[str]:
    c = spec["constants"]
    rots = ", ".join(str(r) for r in c["THREEFRY_ROTATIONS"])
    return [
        "  // Threefry-2x32 key-schedule parity and rotations (Salmon et "
        "al., Table 2)",
        f"  constexpr uint32_t TF_PARITY = 0x{c['THREEFRY_PARITY']:X}u;"
        "  // SKEIN_KS_PARITY32",
        f"  constexpr int TF_ROT[{len(c['THREEFRY_ROTATIONS'])}] = "
        f"{{{rots}}};",
    ]


def refill_magic(d: int) -> Tuple[int, int]:
    """(magic, shift) with floor(x / d) == (x * magic) >> (64 + shift) for
    every 0 <= x < 2^64, the least such shift: magic = ceil(2^(64 + shift)
    / d) < 2^64 and magic * d - 2^(64 + shift) <= 2^shift (Granlund and
    Montgomery, PLDI 1994, theorem 4.2).  Raises ValueError when no shift
    below 64 meets it."""
    for shift in range(64):
        magic = -(-(1 << (64 + shift)) // d)
        if magic < 1 << 64 and magic * d - (1 << (64 + shift)) <= 1 << shift:
            return magic, shift
    raise ValueError(f"no 64-bit reciprocal of {d} meets theorem 4.2")


def _r_cuda_refill(spec: Dict) -> List[str]:
    d = spec["constants"]["REFILL_INTERVAL_NS"]
    magic, shift = refill_magic(d)
    return [
        f"constexpr int64_t REFILL_NS = {d};   // the 1 ms refill tick",
        "// floor(x / REFILL_NS) = umulhi(x, REFILL_MAGIC) >> REFILL_SHIFT "
        "for every",
        "// x < 2^64: REFILL_MAGIC = ceil(2^(64 + REFILL_SHIFT) / "
        "REFILL_NS), and",
        "// REFILL_MAGIC * REFILL_NS - 2^(64 + REFILL_SHIFT) <= "
        "2^REFILL_SHIFT",
        "// (Granlund and Montgomery, theorem 4.2; simgen checks it)",
        f"constexpr uint64_t REFILL_MAGIC = 0x{magic:X}ull;",
        f"constexpr int REFILL_SHIFT = {shift};",
    ]


def _r_cuda_cell_header(spec: Dict) -> List[str]:
    c = spec["constants"]
    return [
        f"constexpr int64_t HDR_TCP = {c['HDR_TCP']};"
        "  // a cell's TCP+IP+ETH header bytes",
    ]


# ---------------------------------------------------------------------------
# the emission table: every declared region, in file order

RegionDef = Tuple[str, str, str, Callable[[Dict], List[str]]]
#             (relpath, region name, comment lead, renderer)

# the JAX package's emission table: the port's regions are its Python
# regions at the port's paths, and its own CUDA regions
REFERENCE_REGIONS: List[RegionDef] = [
    ("shadow_tpu/core/defs.py", "wire-defs", PY, _r_wire_defs),
    ("shadow_tpu/core/stime.py", "clock", PY, _r_clock),
    ("shadow_tpu/routing/packet.py", "tcp-flags", PY, _r_tcp_flags),
    ("shadow_tpu/descriptor/base.py", "status-bits", PY, _r_status_bits),
    ("shadow_tpu/descriptor/epoll.py", "epoll-bits", PY, _r_epoll_bits),
    ("shadow_tpu/host/host.py", "port-alloc", PY, _r_port_alloc),
    ("shadow_tpu/core/rng.py", "threefry", PY, _r_threefry),
    ("shadow_tpu/descriptor/tcp.py", "tcp-states", PY, _r_tcp_states),
    ("shadow_tpu/descriptor/tcp.py", "tcp-timers", PY, _r_tcp_timers),
    ("shadow_tpu/descriptor/tcp.py", "tcp-logic", PY, _r_tcp_logic),
    ("shadow_tpu/host/router.py", "router-static", PY, _r_router_static),
    ("shadow_tpu/host/router.py", "codel-params", PY, _r_codel_params),
    ("shadow_tpu/descriptor/tcp_cong.py", "congestion-params", PY,
     _r_congestion_params),
    ("shadow_tpu/descriptor/tcp_cong.py", "congestion-logic", PY,
     _r_congestion_logic),
    ("shadow_tpu/descriptor/tcp_cong.py", "congestion-variants", PY,
     _r_congestion_variants),
    ("shadow_tpu/ops/bandwidth.py", "token-bucket-kernel", PY,
     _r_token_bucket_kernel),
    ("shadow_tpu/ops/protocol_tables.py", "protocol-tables", PY,
     _r_protocol_tables),
    ("shadow_tpu/ops/protocol_tables.py", "kernel-logic", PY,
     _r_kernel_logic),
    ("native/dataplane.cc", "c-protocol-constants", C, _r_c_constants),
    ("native/dataplane.cc", "c-epoll-bits", C, _r_c_epoll_bits),
    ("native/dataplane.cc", "c-tcp-states", C, _r_c_tcp_states),
    ("native/dataplane.cc", "c-congestion-params", C,
     _r_c_congestion_params),
    ("native/dataplane.cc", "c-protocol-logic", C, _r_c_protocol_logic),
    ("native/dataplane.cc", "c-congestion-logic", C,
     _r_c_congestion_logic),
]

_CSRC = "shadow_tpu_torch/ops/csrc/"

# the regions the port writes (simgen --write): the JAX package's Python
# regions at the port's paths, and the CUDA kernel plane's
REGIONS: List[RegionDef] = [
    (path.replace("shadow_tpu/", "shadow_tpu_torch/"), name, lead, r)
    for path, name, lead, r in REFERENCE_REGIONS
    if path.startswith("shadow_tpu/")] + [
    (_CSRC + "threefry.cuh", "cuda-threefry", C, _r_cuda_threefry),
    (_CSRC + "admit_sorted.cu", "cuda-refill", C, _r_cuda_refill),
    (_CSRC + "pack_flush.cu", "cuda-cell-header", C, _r_cuda_cell_header),
    (_CSRC + "span_tile.cuh", "cuda-cell-header", C, _r_cuda_cell_header),
    (_CSRC + "torcells_run.cu", "cuda-cell-header", C,
     _r_cuda_cell_header),
]

# native/'s regions: the port's --check holds them to the spec too, but
# only the JAX package's generator (make gen) writes them
NATIVE_REGIONS: List[RegionDef] = [
    rd for rd in REFERENCE_REGIONS if rd[0].startswith("native/")]

SURFACE_OF_REGION: Dict[str, str] = {
    "wire-defs": "constants", "clock": "constants",
    "tcp-flags": "constants", "status-bits": "constants",
    "port-alloc": "constants", "threefry": "constants",
    "tcp-timers": "constants", "c-protocol-constants": "constants",
    "epoll-bits": "constants", "c-epoll-bits": "constants",
    "token-bucket-kernel": "hop-math", "router-static": "hop-math",
    "codel-params": "hop-math",
    "tcp-states": "transitions", "c-tcp-states": "transitions",
    "protocol-tables": "transitions",
    "congestion-params": "congestion", "congestion-variants": "congestion",
    "c-congestion-params": "congestion",
    "tcp-logic": "logic", "congestion-logic": "logic",
    "kernel-logic": "logic", "c-protocol-logic": "logic",
    "c-congestion-logic": "logic",
    "cuda-threefry": "constants", "cuda-cell-header": "constants",
    "cuda-refill": "hop-math",
}


def render_body(name: str, spec: Dict) -> str:
    for _, rname, _, renderer in REGIONS + REFERENCE_REGIONS:
        if rname == name:
            return "".join(ln + "\n" for ln in renderer(spec))
    raise KeyError(f"no renderer for region {name!r}")


# ---------------------------------------------------------------------------
# apply / check

def _regions_by_file(regions: Optional[List[RegionDef]] = None
                     ) -> Dict[str, List[RegionDef]]:
    out: Dict[str, List[RegionDef]] = {}
    for rd in (REGIONS + NATIVE_REGIONS if regions is None else regions):
        out.setdefault(rd[0], []).append(rd)
    return out


def rewrite_text(text: str, defs: List[RegionDef], spec: Dict,
                 spec_hash: str) -> Tuple[str, List[str], List[str]]:
    """Replace every declared region of one file's text.

    Returns (new_text, changed region names, problems)."""
    regions, scan_problems = scan_regions(text)
    problems = [f"line {ln}: {msg}" for ln, msg in scan_problems]
    by_name = {r.name: r for r in regions}
    lines = text.splitlines()
    changed: List[str] = []
    # replace bottom-up so earlier line numbers stay valid
    def _key(d):
        reg = by_name.get(d[1])
        return -reg.begin_line if reg is not None else 0

    for _, name, lead, renderer in sorted(defs, key=_key):
        reg = by_name.get(name)
        if reg is None:
            problems.append(f"region {name!r}: markers not found")
            continue
        body = "".join(ln + "\n" for ln in renderer(spec))
        bh = sha12(body)
        if reg.body == body and reg.body_hash == bh \
                and reg.spec_hash == spec_hash:
            continue
        changed.append(name)
        new_block = [begin_marker(name, lead, spec_hash, bh, reg.indent)]
        new_block += body.splitlines()
        new_block.append(end_marker(name, lead, reg.indent))
        lines[reg.begin_line - 1:reg.end_line] = new_block
    return "".join(ln + "\n" for ln in lines), changed, problems


def check_text(path: str, text: str, defs: List[RegionDef], spec: Dict,
               spec_hash: str) -> List[str]:
    """Diagnostics for one file (empty = clean)."""
    out: List[str] = []
    regions, scan_problems = scan_regions(text)
    for ln, msg in scan_problems:
        out.append(f"{path}:{ln}: {msg}")
    by_name = {r.name: r for r in regions}
    declared = {d[1] for d in defs}
    for name in sorted(set(by_name) - declared):
        out.append(f"{path}:{by_name[name].begin_line}: region {name!r} "
                   f"is not declared in simgen's emission table")
    for _, name, _, renderer in defs:
        reg = by_name.get(name)
        if reg is None:
            out.append(f"{path}: region {name!r} markers not found — "
                       f"add the fence and run `make gen`")
            continue
        body = "".join(ln + "\n" for ln in renderer(spec))
        if sha12(reg.body) != reg.body_hash:
            out.append(f"{path}:{reg.begin_line}: region {name!r} was "
                       f"edited by hand (body digest drift) — edit "
                       f"{SPEC_RELPATH} instead and run `make gen`")
        elif reg.body != body:
            out.append(f"{path}:{reg.begin_line}: region {name!r} is "
                       f"stale — the spec or the generator changed; "
                       f"run `make gen`")
        elif reg.spec_hash != spec_hash:
            out.append(f"{path}:{reg.begin_line}: region {name!r} was "
                       f"emitted from an older spec "
                       f"(spec={reg.spec_hash}, current={spec_hash}) — "
                       f"run `make gen`")
    return out


# ---------------------------------------------------------------------------
# read-back: the generated planes must extract to the spec's IR

def readback_diffs(root: str, spec: Dict, port: bool = True,
                   regions: Optional[List[RegionDef]] = None) -> List[str]:
    """Re-extract the planes with simtwin's extractors and diff the IR
    against the authoritative spec (values, transition tables, and the
    congestion coefficient families).  ``port``: the port's settings
    (simlint.load_config); ``regions``: the emission table whose logic
    regions are read back (the port's and native/'s by default)."""
    from .simlint import load_config
    from .simtwin import _load_mapped_sources, load_map
    from .twin_rules import DERIVED_CANON, TwinModel
    config = load_config(os.path.join(root, "pyproject.toml"), port=port)
    surface_map = load_map(None, config)
    sources = _load_mapped_sources(config, surface_map)
    twin = TwinModel(sources, surface_map)
    out: List[str] = []
    want = spec["constants"]
    got = twin.constants_by_canonical()
    # constants referenced by the logic IR are verified structurally by
    # the expression read-back below (their regex probes are retired, so
    # a plane no longer "spells" them as a named constant)
    logic_covered = set()
    for _name, fn in _logic_functions(spec):
        logic_covered.update(logic_ir.referenced_constants(fn["expr"]))
    for canon in sorted(want):
        sites = got.get(canon)
        if not sites:
            if canon in logic_covered:
                continue
            out.append(f"readback: constant {canon} is in the spec but "
                       f"no plane spells it")
            continue
        for path, val, _line, anchor in sites:
            if not _values_equal(val, want[canon]):
                out.append(f"readback: {canon} = {val!r} at "
                           f"{path}#{anchor} but the spec says "
                           f"{want[canon]!r}")
    for canon in sorted(set(got) - set(want) - DERIVED_CANON):
        out.append(f"readback: extracted constant {canon} has no spec "
                   f"entry — add it to {SPEC_RELPATH}")
    want_pairs = set(spec["transitions"]["pairs"])
    want_states = set(spec["transitions"]["states"])
    tables = twin.transition_tables()
    if not tables:
        out.append("readback: no transition tables extracted")
    for path, table in sorted(tables.items()):
        have = {f"{f} -> {t}" for f, t in table["pairs"]}
        for p in sorted(want_pairs - have):
            out.append(f"readback: transition `{p}` is in the spec but "
                       f"not in {path}")
        for p in sorted(have - want_pairs):
            out.append(f"readback: {path} makes transition `{p}` which "
                       f"the spec does not allow")
        if set(table["states"]) != want_states:
            out.append(f"readback: state universe of {path} differs "
                       f"from the spec")
    out.extend(logic_readback_diffs(root, spec, regions))
    return out


def _logic_plane_files(regions: Optional[List[RegionDef]] = None
                       ) -> Dict[str, List[str]]:
    """plane -> list of relpaths carrying emitted logic functions (from
    the emission table, so the read-back can never drift from what the
    generator emits)."""
    out: Dict[str, List[str]] = {"py": [], "c": [], "kernel": []}
    for path, rname, lead, _ in (REGIONS + NATIVE_REGIONS
                                 if regions is None else regions):
        if SURFACE_OF_REGION.get(rname) != "logic":
            continue
        plane = ("c" if lead == C
                 else "kernel" if "/ops/" in path else "py")
        if path not in out[plane]:
            out[plane].append(path)
    return out


def logic_readback_diffs(root: str, spec: Dict,
                         regions: Optional[List[RegionDef]] = None
                         ) -> List[str]:
    """The expression read-back: parse every emitted logic
    function on every plane back to IR and structurally compare against
    the spec.  This is the same comparison SIM206 makes at lint time —
    two independent processes, one meaning."""
    from .cspec import parse_c_logic_functions
    out: List[str] = []
    fns = dict(_logic_functions(spec))
    if not fns:
        return out
    planes: Dict[str, Dict] = {"py": {}, "c": {}, "kernel": {}}
    for plane, paths in _logic_plane_files(regions).items():
        for path in paths:
            try:
                with open(os.path.join(root, path),
                          encoding="utf-8") as f:
                    text = f.read()
            except OSError as e:
                out.append(f"readback: {path}: unreadable: {e}")
                continue
            if plane == "c":
                planes["c"].update(parse_c_logic_functions(text))
            else:
                planes[plane].update(
                    logic_ir.parse_py_functions(text, plane))
    for name in sorted(fns):
        fn = fns[name]
        resolved = _resolved_expr(spec, fn)
        for plane in ("py", "c", "kernel"):
            sym = logic_ir.plane_symbol(name, plane)
            got = planes[plane].get(name)
            if got is None:
                out.append(f"readback: logic fn {name} ({sym}) missing "
                           f"on the {plane} plane — run `make gen`")
                continue
            args, ir, _line = got
            if list(args) != list(fn["args"]):
                out.append(f"readback: {sym} args {list(args)} != spec "
                           f"args {list(fn['args'])}")
            elif ir is None:
                out.append(f"readback: {sym} body is not a single "
                           f"portable-IR expression")
            else:
                d = logic_ir.structural_diff(resolved, ir)
                if d:
                    out.append(f"readback: logic fn {name} drifted on "
                               f"the {plane} plane: {d}")
    return out


def _values_equal(a, b) -> bool:
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(
            _values_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, (int, float)) and isinstance(b, (int, float)):
        return float(a) == float(b)
    return a == b


# ---------------------------------------------------------------------------
# tree-level entry points (the API tests/bench use)

def check_tree(root: str, spec: Dict, spec_hash: str,
               readback: bool = True, port: bool = True,
               regions: Optional[List[RegionDef]] = None) -> List[str]:
    """Diagnostics for every region of ``regions`` (the port's and
    native/'s by default) and, when they are clean, the read-back under
    the port's settings (``port``) or the repository's as written."""
    out: List[str] = []
    for path, defs in sorted(_regions_by_file(regions).items()):
        abspath = os.path.join(root, path)
        try:
            with open(abspath, encoding="utf-8") as f:
                text = f.read()
        except OSError as e:
            out.append(f"{path}: unreadable: {e}")
            continue
        out.extend(check_text(path, text, defs, spec, spec_hash))
    if readback and not out:
        out.extend(readback_diffs(root, spec, port, regions))
    return out


def write_tree(root: str, spec: Dict, spec_hash: str
               ) -> Tuple[List[str], List[str]]:
    """Write the port's own regions (never native/'s, which the JAX
    package's generator owns).  Returns (list of 'path:region' written,
    problems)."""
    written: List[str] = []
    problems: List[str] = []
    for path, defs in sorted(_regions_by_file(REGIONS).items()):
        abspath = os.path.join(root, path)
        try:
            with open(abspath, encoding="utf-8") as f:
                text = f.read()
        except OSError as e:
            problems.append(f"{path}: unreadable: {e}")
            continue
        new_text, changed, probs = rewrite_text(text, defs, spec, spec_hash)
        problems.extend(f"{path}: {p}" for p in probs)
        if changed:
            with open(abspath, "w", encoding="utf-8") as f:
                f.write(new_text)
            written.extend(f"{path}:{name}" for name in changed)
    return written, problems


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="simgen",
        description="spec-authoritative protocol codegen (shadow-tpu): "
                    "emit the protocol surfaces of spec/protocol_spec.json "
                    "into fenced regions of the Python/C/kernel planes")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--write", action="store_true",
                      help="materialize every declared region (make gen)")
    mode.add_argument("--check", action="store_true",
                      help="verify regions are current + hand-edit-free "
                           "and the planes read back to the spec's IR "
                           "(make gen-check; the default)")
    mode.add_argument("--list", action="store_true",
                      help="print the emission table and exit")
    ap.add_argument("--spec", default=None,
                    help=f"authoritative spec path (default: "
                         f"{SPEC_RELPATH} under the config root)")
    ap.add_argument("--root", default=None,
                    help="repo root (default: walk up to pyproject.toml)")
    ap.add_argument("--no-readback", action="store_true",
                    help="skip the IR read-back diff (marker checks only)")
    args = ap.parse_args(argv)

    if args.root is None:
        from .simlint import load_config
        args.root = load_config(None, start=".").root
    spec_path = args.spec or os.path.join(args.root, SPEC_RELPATH)
    if not os.path.isfile(spec_path):
        print(f"simgen: no spec at {spec_path}", file=sys.stderr)
        return 2
    try:
        spec, spec_hash = load_spec(spec_path)
    except (ValueError, OSError) as e:
        print(f"simgen: unreadable spec {spec_path}: {e}", file=sys.stderr)
        return 2

    if args.list:
        for path, name, _, _renderer in REGIONS + NATIVE_REGIONS:
            surface = SURFACE_OF_REGION.get(name, "?")
            print(f"{surface:<12} {name:<22} {path}")
        return 0

    if args.write:
        written, problems = write_tree(args.root, spec, spec_hash)
        for p in problems:
            print(f"simgen: {p}", file=sys.stderr)
        for w in written:
            print(f"simgen: wrote {w}")
        print(f"simgen: {len(written)} region(s) updated, "
              f"{len(REGIONS) - len(written)} already current")
        return 1 if problems else 0

    diags = check_tree(args.root, spec, spec_hash,
                       readback=not args.no_readback)
    for d in diags:
        print(d)
    checked = REGIONS + NATIVE_REGIONS
    n_surfaces = len({SURFACE_OF_REGION[n] for _, n, _, _ in checked})
    print(f"simgen: {len(diags)} problem(s), {len(checked)} region(s), "
          f"{n_surfaces} surface(s)")
    return 1 if diags else 0


if __name__ == "__main__":
    sys.exit(main())
