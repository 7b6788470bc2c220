"""Pluggable TCP congestion control.

Capability parity with the reference's CC vtable (tcp_cong.h:17-31 hooks:
duplicateAck / fastRecovery / newAck / timeout / ssthresh) and its
``--tcp-congestion-control`` choices reno/aimd/cubic (options.c,
tcp.c:2514 tcpCongestion_getType).  The reference ships Reno
(tcp_cong_reno.c); we implement all three advertised algorithms.

Windows are in bytes; ``mss`` is the segment size used for increments.
"""

from __future__ import annotations

INIT_CWND_SEGMENTS = 10       # Linux default initial window (RFC 6928)

# >>> simgen:begin region=congestion-params spec=293c930bb679 body=6a36d8b1dbdf
# CUBIC coefficient families (RFC 9438 §4.1 / §4.6).
CUBIC_C = 0.4      # cubic: scaling constant
CUBIC_BETA = 0.7   # cubic: multiplicative decrease
CUBICX_C = 0.6      # cubicx: scaling constant
CUBICX_BETA = 0.85   # cubicx: multiplicative decrease
# <<< simgen:end region=congestion-params

# >>> simgen:begin region=congestion-logic spec=293c930bb679 body=5b1b752f25a6
# bbrx estimator parameters (spec surface: congestion)
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


# congestion update logic, generated from the spec's expression IR

def _g_bbrx_bdp_bytes(btl_bw_bps, min_rtt_ns):
    """bandwidth-delay product; the /1000 then /1e6 split keeps the intermediate below 2**63 at the bw/rtt caps"""
    return (((btl_bw_bps // 1000) * min(min_rtt_ns, 1000000000)) // 1000000)


def _g_bbrx_btl_bw(btl_bw_bps, bw_sample_bps):
    """bottleneck-bandwidth max filter"""
    return max(btl_bw_bps, bw_sample_bps)


def _g_bbrx_bw_decay(btl_bw_bps):
    """multiplicative bandwidth-estimate decay on loss"""
    return ((btl_bw_bps * 7) // 8)


def _g_bbrx_bw_sample(acked_bytes, interval_ns):
    """delivery-rate sample in bytes/sec from one ACK's bytes over the inter-ACK interval, capped"""
    return min(((acked_bytes * 1000000000) // max(interval_ns, 1)), 1000000000000)


def _g_bbrx_gain_num(cycle_idx):
    """gain numerator for the cycle phase: probe up, drain down, then cruise (BBR's 5/4, 3/4, 1.0 x6 over BBRX_GAIN_DEN)"""
    return (5 if (cycle_idx == 0) else (3 if (cycle_idx == 1) else 4))


def _g_bbrx_inflight_cap(bdp_bytes, gain_num, mss):
    """cwnd = max(gain * bdp, floor segments)"""
    return max(((bdp_bytes * gain_num) // 4), (4 * mss))


def _g_bbrx_min_rtt(min_rtt_ns, interval_ns):
    """min-RTT filter over floored inter-ACK intervals"""
    return min(min_rtt_ns, max(interval_ns, 100000))


def _g_bbrx_next_cycle(cycle_idx):
    """pacing-gain cycle advance"""
    return ((cycle_idx + 1) % 8)


def _g_recovery_cwnd(ssthresh, mss):
    """fast-recovery window inflation (ssthresh + 3*mss)"""
    return (ssthresh + (3 * mss))


def _g_ssthresh_after_loss(cwnd, mss):
    """ssthresh = max(cwnd/2, 2*mss) on loss (RFC 5681)"""
    return max((cwnd // 2), (2 * mss))
# <<< simgen:end region=congestion-logic


class CongestionControl:
    """Base vtable: slow start + congestion avoidance scaffolding."""

    name = "base"

    def __init__(self, mss: int, ssthresh: int = 0,
                 init_segments: int = INIT_CWND_SEGMENTS):
        self.mss = mss
        # --tcp-windows: initial window in packets (reference tcp.c:2459)
        self.cwnd = max(1, init_segments) * mss
        # 0 = "infinite" until first loss
        self.ssthresh = ssthresh if ssthresh > 0 else (1 << 30)
        self.in_fast_recovery = False
        self.recovery_point = 0       # snd_nxt at loss detection
        self._avoid_acc = 0           # byte accumulator for CA increments

    # -- hooks (tcp_cong.h:17-31) -----------------------------------------
    def on_new_ack(self, acked_bytes: int, snd_una: int, now_ns: int) -> None:
        if self.in_fast_recovery:
            if snd_una >= self.recovery_point:
                self._exit_recovery()
            else:
                return  # partial ACK: stay in recovery
        if self.cwnd < self.ssthresh:
            self.cwnd += min(acked_bytes, self.mss)   # slow start
        else:
            self._congestion_avoidance(acked_bytes, now_ns)

    def on_duplicate_ack(self, count: int, snd_nxt: int) -> bool:
        """Returns True when the caller should fast-retransmit (3rd dup)."""
        if count == 3 and not self.in_fast_recovery:
            self._enter_recovery(snd_nxt)
            return True
        if self.in_fast_recovery:
            self.cwnd += self.mss   # window inflation per extra dup
        return False

    def on_timeout(self) -> None:
        self.ssthresh = _g_ssthresh_after_loss(self.cwnd, self.mss)
        self.cwnd = self.mss
        self.in_fast_recovery = False
        self._avoid_acc = 0

    # -- internals ---------------------------------------------------------
    def _enter_recovery(self, snd_nxt: int) -> None:
        self.ssthresh = _g_ssthresh_after_loss(self.cwnd, self.mss)
        self.cwnd = _g_recovery_cwnd(self.ssthresh, self.mss)
        self.in_fast_recovery = True
        self.recovery_point = snd_nxt

    def _exit_recovery(self) -> None:
        self.cwnd = self.ssthresh
        self.in_fast_recovery = False
        self._avoid_acc = 0

    def _congestion_avoidance(self, acked_bytes: int, now_ns: int) -> None:
        # +1 MSS per cwnd of acked bytes (Reno linear growth)
        self._avoid_acc += acked_bytes
        if self._avoid_acc >= self.cwnd:
            self._avoid_acc -= self.cwnd
            self.cwnd += self.mss


class Reno(CongestionControl):
    """NewReno-style fast recovery (reference tcp_cong_reno.c)."""

    name = "reno"


class AIMD(CongestionControl):
    """Plain additive-increase/multiplicative-decrease: like Reno but with
    no window inflation during recovery (the reference's 'aimd' choice)."""

    name = "aimd"

    def on_duplicate_ack(self, count: int, snd_nxt: int) -> bool:
        if count == 3 and not self.in_fast_recovery:
            self._enter_recovery(snd_nxt)
            self.cwnd = self.ssthresh  # no +3 inflation
            return True
        return False


class Cubic(CongestionControl):
    """CUBIC (RFC 9438): window growth is a cubic function of time since
    the last congestion event, independent of RTT."""

    name = "cubic"
    C = CUBIC_C          # scaling constant (RFC 9438 §4.1)
    BETA = CUBIC_BETA    # multiplicative decrease factor

    def __init__(self, mss: int, ssthresh: int = 0,
                 init_segments: int = INIT_CWND_SEGMENTS):
        super().__init__(mss, ssthresh, init_segments)
        self.w_max = 0.0          # window before last reduction (bytes)
        self.epoch_start_ns = 0
        self.k = 0.0              # time to regrow to w_max (seconds)

    def _enter_recovery(self, snd_nxt: int) -> None:
        self.w_max = float(self.cwnd)
        self.ssthresh = max(int(self.cwnd * self.BETA), 2 * self.mss)
        self.cwnd = self.ssthresh
        self.in_fast_recovery = True
        self.recovery_point = snd_nxt
        self.epoch_start_ns = 0   # new epoch starts at next ACK

    def on_timeout(self) -> None:
        self.w_max = float(self.cwnd)
        super().on_timeout()
        self.epoch_start_ns = 0

    def _congestion_avoidance(self, acked_bytes: int, now_ns: int) -> None:
        if self.epoch_start_ns == 0:
            self.epoch_start_ns = now_ns
            wm = max(self.w_max, float(self.cwnd))
            self.k = ((wm - self.cwnd) / (self.C * self.mss)) ** (1.0 / 3.0) \
                if wm > self.cwnd else 0.0
        t = (now_ns - self.epoch_start_ns) / 1e9
        target = self.w_max + self.C * self.mss * (t - self.k) ** 3
        if target > self.cwnd:
            # approach the cubic target over the next RTT-ish step
            self.cwnd += max(self.mss // 8,
                             int((target - self.cwnd) / 8))
        else:
            super()._congestion_avoidance(acked_bytes, now_ns)


# >>> simgen:begin region=congestion-variants spec=293c930bb679 body=08dd1007c920
class CubicX(Cubic):
    """Spec-defined CUBIC variant 'cubicx': (C, beta) = (0.6, 0.85).

    Same window-growth machinery as Cubic (the base class reads
    ``self.C``/``self.BETA``); only the coefficients differ.
    """

    name = "cubicx"
    C = CUBICX_C
    BETA = CUBICX_BETA


class BbrX(CongestionControl):
    """Spec-defined 'bbrx' (ISSUE 19): a BBR-flavored family — windowed
    bandwidth (max filter + loss decay), min-RTT from ACK spacing, a
    pacing-gain cycle, and an inflight cap from the BDP.  Every update
    expression is generated from the spec's logic IR; this class holds
    only the estimator state and the hook wiring.
    """

    name = "bbrx"

    def __init__(self, mss, ssthresh=0,
                 init_segments=INIT_CWND_SEGMENTS):
        super().__init__(mss, ssthresh, init_segments)
        self.btl_bw_bps = 0
        self.min_rtt_ns = BBRX_RTT_CAP_NS
        self.last_ack_ns = 0
        self.cycle_idx = 0
        self.cycle_start_ns = 0

    def on_new_ack(self, acked_bytes, snd_una, now_ns):
        if self.in_fast_recovery:
            if snd_una >= self.recovery_point:
                self._exit_recovery()
            else:
                return  # partial ACK: stay in recovery
        if self.last_ack_ns > 0:
            interval_ns = now_ns - self.last_ack_ns
            self.btl_bw_bps = _g_bbrx_btl_bw(
                self.btl_bw_bps,
                _g_bbrx_bw_sample(acked_bytes, interval_ns))
            self.min_rtt_ns = _g_bbrx_min_rtt(self.min_rtt_ns,
                                              interval_ns)
        self.last_ack_ns = now_ns
        if now_ns - self.cycle_start_ns >= BBRX_CYCLE_NS:
            self.cycle_idx = _g_bbrx_next_cycle(self.cycle_idx)
            self.cycle_start_ns = now_ns
        if self.btl_bw_bps > 0:
            self.cwnd = _g_bbrx_inflight_cap(
                _g_bbrx_bdp_bytes(self.btl_bw_bps, self.min_rtt_ns),
                _g_bbrx_gain_num(self.cycle_idx), self.mss)

    def _enter_recovery(self, snd_nxt):
        self.btl_bw_bps = _g_bbrx_bw_decay(self.btl_bw_bps)
        self.ssthresh = _g_ssthresh_after_loss(self.cwnd, self.mss)
        self.cwnd = _g_recovery_cwnd(self.ssthresh, self.mss)
        self.in_fast_recovery = True
        self.recovery_point = snd_nxt

    def on_timeout(self):
        self.btl_bw_bps = _g_bbrx_bw_decay(self.btl_bw_bps)
        self.ssthresh = _g_ssthresh_after_loss(self.cwnd, self.mss)
        self.cwnd = self.mss
        self.in_fast_recovery = False
        self._avoid_acc = 0


# config token -> generated class (make_congestion_control consults this)
CC_GENERATED = {
    "bbrx": BbrX,
    "cubicx": CubicX,
}
# <<< simgen:end region=congestion-variants


def make_congestion_control(kind: str, mss: int, ssthresh: int = 0,
                            init_segments: int = INIT_CWND_SEGMENTS
                            ) -> CongestionControl:
    if kind == "reno":
        return Reno(mss, ssthresh, init_segments)
    if kind == "aimd":
        return AIMD(mss, ssthresh, init_segments)
    if kind == "cubic":
        return Cubic(mss, ssthresh, init_segments)
    cls = CC_GENERATED.get(kind)
    if cls is not None:
        return cls(mss, ssthresh, init_segments)
    raise ValueError(f"unknown congestion control {kind!r}")
