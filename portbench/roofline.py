"""Peaks of the card and the span kernels' least times.

Copied from ``chip_smoke.py`` (``HBM_BYTES_PER_S``, ``ALU32_OPS_PER_S``,
``SPAN_OPS_PER_FLOW``, ``SPAN_OPS_PER_NODE``, ``span_bound``), rewritten
to take the counts of flows, nodes and chains the benchmark generated
and the ticks the reference stepped, never the program's own counters.
"""

from __future__ import annotations

# H100 SXM peaks (NVIDIA's data sheet, at the full 700 W): HBM bytes/s,
# and 32-bit scalar ALU operations/s (the span's work is 32-bit integer
# operations outside the tensor cores)
HBM_BYTES_PER_S = 3.35e12
ALU32_OPS_PER_S = 67e12
# 32-bit operations the span does per tick: per flow the arrival gather
# index (int64 sub, floor mod), two adds, the clip (2 compares), the
# queue update, the send (or the delivered add and 3 compares), the
# segment's running sums, ~12 int64 operations = 24 32-bit; per node the
# refill min, the divide by the cell size (~20), the token and node_sent
# updates, ~32 32-bit
SPAN_OPS_PER_FLOW = 24
SPAN_OPS_PER_NODE = 32


def span_work(f: int, h: int, c: int, ring_len: int, ticks: int):
    """(bytes, operations) of one dispatch of ``ticks`` ticks over a table
    of ``f`` flows, ``h`` nodes and ``c`` chains: every input read once and
    every output written once (the state, the injections, the tables, the
    flush inputs), and the ticks' 32-bit operations."""
    state = 8 * f * 4 + 4 * ring_len * f + 8 * h * 2
    reads = state + 8 * f * 2 + 8 * f * 4 + 8 * h * 2 + 8 * c
    writes = state + c + 8 * c + 8 * h
    ops = ticks * (f * SPAN_OPS_PER_FLOW + h * SPAN_OPS_PER_NODE)
    return reads + writes, ops


def bound_s(nbytes: float, ops: float) -> float:
    """The least time for ``nbytes`` over HBM and ``ops`` over the ALUs."""
    return max(nbytes / HBM_BYTES_PER_S, ops / ALU32_OPS_PER_S)
