"""Kernel-plane protocol tables, generated from the authoritative spec.

The device kernels operate on integer state ids and coefficient arrays,
not on the Python plane's string states or the C plane's enums.  This
module is the kernel plane's copy of the protocol surfaces that the
other two planes also carry — the TCP state universe (tuple index ==
C-plane ``TcpState`` id), the legal state-transition pairs, and the
congestion-control coefficient families — materialized by simgen from
``spec/protocol_spec.json`` exactly like the twin regions in
``core/defs.py`` and ``native/dataplane.cc``.  simtwin's SIM201/SIM203
passes hold this module to the same cross-plane agreement as the
runtime planes.
"""

from __future__ import annotations

import numpy as np

# >>> simgen:begin region=protocol-tables spec=293c930bb679 body=d9f495f010ac
# TCP state universe, reference-enum order; the tuple index IS
# the C-plane TcpState id.
TCP_STATES = (
    "closed",
    "listen",
    "syn_sent",
    "syn_received",
    "established",
    "fin_wait_1",
    "fin_wait_2",
    "closing",
    "time_wait",
    "close_wait",
    "last_ack",
)

# Legal (from, to) transition pairs; "?" = unguarded.
TCP_TRANSITIONS = (
    ("?", "closed"),
    ("?", "established"),
    ("?", "listen"),
    ("?", "syn_received"),
    ("?", "syn_sent"),
    ("?", "time_wait"),
    ("close_wait", "last_ack"),
    ("established", "close_wait"),
    ("established", "fin_wait_1"),
    ("fin_wait_1", "closing"),
    ("fin_wait_1", "fin_wait_2"),
    ("fin_wait_1", "time_wait"),
    ("syn_received", "established"),
    ("syn_received", "fin_wait_1"),
)

# Congestion-control coefficient families + config-token kind ids.
CUBIC_C = 0.4
CUBIC_BETA = 0.7
CUBICX_C = 0.6
CUBICX_BETA = 0.85
CC_KIND_IDS = {"aimd": 1, "bbrx": 4, "cubic": 2, "cubicx": 3, "reno": 0}
# (C, beta) per kind id; non-cubic kinds carry the cubic defaults (unused)
CC_COEFFS = {
    1: (CUBIC_C, CUBIC_BETA),  # aimd
    4: (CUBIC_C, CUBIC_BETA),  # bbrx
    2: (CUBIC_C, CUBIC_BETA),  # cubic
    3: (CUBICX_C, CUBICX_BETA),  # cubicx
    0: (CUBIC_C, CUBIC_BETA),  # reno
}
# <<< simgen:end region=protocol-tables

# >>> simgen:begin region=kernel-logic spec=293c930bb679 body=f02981e31cd7
# bbrx estimator parameters (mirrors descriptor/tcp_cong.py)
BBRX_BETA_DEN = 8
BBRX_BETA_NUM = 7
BBRX_BW_CAP_BPS = 1000000000000
BBRX_CYCLE_LEN = 8
BBRX_CYCLE_NS = 25000000
BBRX_GAIN_CRUISE_NUM = 4
BBRX_GAIN_DEN = 4
BBRX_GAIN_DOWN_NUM = 3
BBRX_GAIN_UP_NUM = 5
BBRX_MIN_CWND_SEGMENTS = 4
BBRX_RTT_CAP_NS = 1000000000
BBRX_RTT_FLOOR_NS = 100000


# protocol-update logic, generated from the spec's expression IR;
# elementwise over int64 arrays (device-vs-numpy parity is pinned in tests)

def bbrx_bdp_bytes_np(btl_bw_bps, min_rtt_ns):
    """bandwidth-delay product; the /1000 then /1e6 split keeps the intermediate below 2**63 at the bw/rtt caps"""
    return (((btl_bw_bps // 1000) * np.minimum(min_rtt_ns, 1000000000)) // 1000000)


def bbrx_btl_bw_np(btl_bw_bps, bw_sample_bps):
    """bottleneck-bandwidth max filter"""
    return np.maximum(btl_bw_bps, bw_sample_bps)


def bbrx_bw_decay_np(btl_bw_bps):
    """multiplicative bandwidth-estimate decay on loss"""
    return ((btl_bw_bps * 7) // 8)


def bbrx_bw_sample_np(acked_bytes, interval_ns):
    """delivery-rate sample in bytes/sec from one ACK's bytes over the inter-ACK interval, capped"""
    return np.minimum(((acked_bytes * 1000000000) // np.maximum(interval_ns, 1)), 1000000000000)


def bbrx_gain_num_np(cycle_idx):
    """gain numerator for the cycle phase: probe up, drain down, then cruise (BBR's 5/4, 3/4, 1.0 x6 over BBRX_GAIN_DEN)"""
    return np.where((cycle_idx == 0), 5, np.where((cycle_idx == 1), 3, 4))


def bbrx_inflight_cap_np(bdp_bytes, gain_num, mss):
    """cwnd = max(gain * bdp, floor segments)"""
    return np.maximum(((bdp_bytes * gain_num) // 4), (4 * mss))


def bbrx_min_rtt_np(min_rtt_ns, interval_ns):
    """min-RTT filter over floored inter-ACK intervals"""
    return np.minimum(min_rtt_ns, np.maximum(interval_ns, 100000))


def bbrx_next_cycle_np(cycle_idx):
    """pacing-gain cycle advance"""
    return ((cycle_idx + 1) % 8)


def recovery_cwnd_np(ssthresh, mss):
    """fast-recovery window inflation (ssthresh + 3*mss)"""
    return (ssthresh + (3 * mss))


def rto_backoff_np(rto_ns):
    """exponential backoff on retransmission timeout"""
    return np.minimum((rto_ns * 2), 120000000000)


def rto_from_estimate_np(srtt_ns, rttvar_ns):
    """RTO = clamp(srtt + 4*rttvar) into [RTO_MIN, RTO_MAX]"""
    return np.maximum(200000000, np.minimum((srtt_ns + (4 * rttvar_ns)), 120000000000))


def rttvar_update_np(srtt_ns, rttvar_ns, sample_ns):
    """RFC 6298 RTT variance over the PRE-update srtt; |err| spelled max-min so every plane stays in non-negative int64"""
    return np.where((srtt_ns == 0), (sample_ns // 2), (((3 * rttvar_ns) + (np.maximum(sample_ns, srtt_ns) - np.minimum(sample_ns, srtt_ns))) // 4))


def srtt_update_np(srtt_ns, sample_ns):
    """RFC 6298 smoothed RTT; first sample seeds the filter"""
    return np.where((srtt_ns == 0), sample_ns, (((7 * srtt_ns) + sample_ns) // 8))


def ssthresh_after_loss_np(cwnd, mss):
    """ssthresh = max(cwnd/2, 2*mss) on loss (RFC 5681)"""
    return np.maximum((cwnd // 2), (2 * mss))
# <<< simgen:end region=kernel-logic

ANY_STATE = "?"          # an assignment no state guard encloses


def state_id(name: str) -> int:
    """C-plane TcpState id for a state name (255 for the '?' wildcard,
    matching the C transition table's encoding)."""
    if name == ANY_STATE:
        return 255
    return TCP_STATES.index(name)


def transition_matrix() -> np.ndarray:
    """Boolean [n_states+1, n_states] allow-matrix: row ``i`` = from-state
    id (last row = the '?' wildcard), column = to-state id."""
    n = len(TCP_STATES)
    m = np.zeros((n + 1, n), dtype=np.bool_)
    for frm, to in TCP_TRANSITIONS:
        row = n if frm == ANY_STATE else TCP_STATES.index(frm)
        m[row, TCP_STATES.index(to)] = True
    return m


def cc_coefficients() -> np.ndarray:
    """[n_kinds, 2] float64 (C, beta) rows indexed by CC_KIND_IDS, built
    from the generated CC_COEFFS table — a new spec variant lands here
    via `make gen` with no hand edit."""
    n = max(CC_KIND_IDS.values()) + 1
    out = np.zeros((n, 2))
    for kind_id, (c, beta) in CC_COEFFS.items():
        out[kind_id] = (c, beta)
    return out
