"""Userspace TCP: full state machine, windows, SACK, retransmits, autotuning.

Capability parity with the reference's tcp.c (2520 LoC; SURVEY.md §2.5):

* connection state machine (tcp.c enum :42-47; CLOSED/LISTEN/SYN_SENT/
  SYN_RECEIVED/ESTABLISHED/FIN_WAIT_*/CLOSING/TIME_WAIT/CLOSE_WAIT/LAST_ACK);
* child/server multiplexing — a LISTEN socket spawns one child socket per
  SYN and queues established children for accept() (tcp.c :91-113);
* sequence/ack windows with peer-advertised flow control and pluggable
  congestion control (tcp_cong.py: reno/aimd/cubic);
* ``_flush``-style send pipeline (tcp.c:1121-1278): retransmit marked-lost
  ranges first, then segmentize buffered user data within
  min(cwnd, peer window), hand packets to the interface qdisc;
* SACK generation from the reorder buffer and SACK processing through the
  retransmit tally (native C++ lib, retransmit_tally.py; reference's
  shadow-remora, dup-ACK threshold 3);
* RTT estimation (RFC 6298 SRTT/RTTVAR via header timestamps, tcp.c:991)
  driving the RTO timer with exponential backoff
  (CONFIG_TCP_RTO_* definitions.h:115-131);
* per-RTT receive/send buffer autotuning toward 2x the measured
  bandwidth-delay product (tcp.c:441-600), clamped to
  CONFIG_TCP_{R,W}MEM_MAX;
* FIN/RST teardown with TIME_WAIT.

Design deltas from the reference (deliberate, simulation-idiomatic):
sequence numbers are unbounded Python ints (no u32 wraparound handling
needed); the initial sequence number is 0 for reproducible traces.

Delayed ACKs follow the reference exactly (tcp.c:2047-2088): a pure ACK in
response to in-order data is coalesced behind a per-socket timer — 1 ms for
the first 1000 "quick ACKs" of a connection, 5 ms after — so all packets
received within the window produce ONE ACK.  DUPACKs and any packet that
already carries an ACK flag (data, FIN) are sent immediately and clear the
pending delayed-ACK counter (tcp.c:1106-1107).
"""

from __future__ import annotations

from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

from ..core import defs, stime
from ..core.task import Task
from ..routing.packet import (TCP_ACK, TCP_FIN, TCP_RST, TCP_SYN, Packet,
                              TCPHeader)
from .base import S_ACTIVE, S_CLOSED, S_READABLE, S_WRITABLE, Socket
from .retransmit_tally import make_tally
from .tcp_cong import make_congestion_control
from ..core.worker import current_worker

# >>> simgen:begin region=tcp-states spec=293c930bb679 body=c91ef6656a5d
# states (reference tcp.c enum TCPState :42-47)
CLOSED = "closed"
LISTEN = "listen"
SYN_SENT = "syn_sent"
SYN_RECEIVED = "syn_received"
ESTABLISHED = "established"
FIN_WAIT_1 = "fin_wait_1"
FIN_WAIT_2 = "fin_wait_2"
CLOSING = "closing"
TIME_WAIT = "time_wait"
CLOSE_WAIT = "close_wait"
LAST_ACK = "last_ack"

# The spec's legal (from, to) transition pairs; "?" = an
# assignment no state guard encloses.
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
# <<< simgen:end region=tcp-states

MSS = defs.CONFIG_TCP_MAX_SEGMENT_SIZE

# >>> simgen:begin region=tcp-timers spec=293c930bb679 body=21bb9e099dc9
RTO_INIT_NS = 1000000000
RTO_MIN_NS = 200000000
RTO_MAX_NS = 120000000000
TIME_WAIT_NS = 60000000000        # 2*MSL teardown hold
MAX_SYN_RETRIES = 6                           # Linux tcp_syn_retries default
MAX_RETRIES = 15                              # Linux tcp_retries2
MAX_SACK_BLOCKS = 4
# <<< simgen:end region=tcp-timers

# >>> simgen:begin region=tcp-logic spec=293c930bb679 body=cc99e04c0aa5
# RTT/RTO update logic, generated from the spec's expression IR
# (SIM206 parses these bodies back and compares them to the spec).

def _g_rto_backoff(rto_ns):
    """exponential backoff on retransmission timeout"""
    return min((rto_ns * 2), 120000000000)


def _g_rto_from_estimate(srtt_ns, rttvar_ns):
    """RTO = clamp(srtt + 4*rttvar) into [RTO_MIN, RTO_MAX]"""
    return max(200000000, min((srtt_ns + (4 * rttvar_ns)), 120000000000))


def _g_rttvar_update(srtt_ns, rttvar_ns, sample_ns):
    """RFC 6298 RTT variance over the PRE-update srtt; |err| spelled max-min so every plane stays in non-negative int64"""
    return ((sample_ns // 2) if (srtt_ns == 0) else (((3 * rttvar_ns) + (max(sample_ns, srtt_ns) - min(sample_ns, srtt_ns))) // 4))


def _g_srtt_update(srtt_ns, sample_ns):
    """RFC 6298 smoothed RTT; first sample seeds the filter"""
    return (sample_ns if (srtt_ns == 0) else (((7 * srtt_ns) + sample_ns) // 8))
# <<< simgen:end region=tcp-logic


class _Segment:
    """One in-flight segment awaiting cumulative ACK."""

    __slots__ = ("seq", "end", "payload", "flags", "send_time_ns", "rtx_count")

    def __init__(self, seq: int, end: int, payload: bytes, flags: int,
                 send_time_ns: int):
        self.seq = seq
        self.end = end                 # seq + len + (1 if SYN or FIN)
        self.payload = payload
        self.flags = flags
        self.send_time_ns = send_time_ns
        self.rtx_count = 0


class TCPSocket(Socket):
    def __init__(self, host, handle: int, recv_buf_size: int,
                 send_buf_size: int, parent: Optional["TCPSocket"] = None):
        super().__init__(host, handle, "tcp", recv_buf_size, send_buf_size)
        self.state = CLOSED
        self.parent = parent
        self.accepted = False  # delivered to the app via accept()
        self.error: Optional[str] = None
        # --- listener side ---
        self.backlog = 0
        self.accept_queue: Deque["TCPSocket"] = deque()
        self.children: Dict[Tuple[int, int], "TCPSocket"] = {}
        # --- sequence space (tcp.c struct :117-243) ---
        self.snd_una = 0          # oldest unacked
        self.snd_nxt = 0          # next seq to send
        self.snd_wnd = MSS        # peer-advertised window
        self.rcv_nxt = 0          # next expected seq
        self.iss = 0
        self.irs = 0
        # --- buffers ---
        self.send_pending: Deque[bytes] = deque()   # user bytes not yet segmentized
        self.send_pending_bytes = 0
        self.unacked: Dict[int, _Segment] = {}      # seq -> segment
        self.reorder: Dict[int, Packet] = {}        # out-of-order arrivals
        self.reorder_bytes = 0
        self.read_queue: Deque[bytes] = deque()     # in-order user bytes
        self.read_bytes = 0
        # --- congestion / loss state ---
        self.cong = None
        self.tally = make_tally()
        self._tally_dirty = False
        self.dup_ack_count = 0
        self.last_ack_rcvd = 0
        # --- RTT / RTO (RFC 6298; tcp.c:991) ---
        self.srtt_ns = 0
        self.rttvar_ns = 0
        self.rto_ns = RTO_INIT_NS
        self.rto_expiry = 0
        self._rto_generation = 0
        self._rto_scheduled = False
        # --- teardown ---
        self.fin_pending = False       # close() requested; FIN not yet sent
        self.fin_seq: Optional[int] = None
        self.eof_received = False      # peer FIN consumed by reader
        self.fin_acked = False
        self.app_closed = False
        self.write_shutdown = False    # shutdown(SHUT_WR) called
        self._persist_scheduled = False
        # --- delayed ACK (tcp.c:2047-2088) ---
        self._delack_scheduled = False
        self._delack_counter = 0
        self._quick_acks = 0
        # --- autotuning (tcp.c:441-600) ---
        self.autotune_recv = host.params.autotune_recv
        self.autotune_send = host.params.autotune_send
        self._rtt_bytes_in = 0
        self._rtt_window_start = 0
        # last advertised window; 0->+ transitions trigger a window update
        self._last_adv_window = recv_buf_size

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------
    def _now(self) -> int:
        # the executing worker mirrors the clock onto the host (event.py);
        # one attribute read instead of a thread-local lookup
        return self.host.now

    def _engine_options(self):
        eng = self.host.engine
        return getattr(eng, "options", None)

    def _make_cong(self):
        from .tcp_cong import INIT_CWND_SEGMENTS
        opts = self._engine_options()
        kind = getattr(opts, "tcp_congestion_control", "reno") if opts else "reno"
        # per-host override (<host tcpcc="...">) beats the engine-wide flag
        host_kind = getattr(getattr(self.host, "params", None),
                            "tcp_cc", None)
        if host_kind:
            kind = host_kind
        ssthresh = getattr(opts, "tcp_ssthresh", 0) if opts else 0
        init_segments = getattr(opts, "tcp_windows", INIT_CWND_SEGMENTS) \
            if opts else INIT_CWND_SEGMENTS
        # --tcp-windows also seeds the pre-handshake peer-window assumption
        # (the real value arrives with the first packet's window field)
        self.snd_wnd = max(1, init_segments) * MSS
        return make_congestion_control(kind, MSS, ssthresh, init_segments)

    def _iface(self):
        return self.host.interface_for_ip(self.bound_ip)

    def _adv_window(self) -> int:
        used = self.read_bytes + self.reorder_bytes
        return max(0, self.recv_buf_size - used)

    def _send_capacity(self) -> int:
        """Sender limit: min(cwnd, peer window) minus bytes in flight."""
        flight = self.snd_nxt - self.snd_una
        cwnd = self.cong.cwnd if self.cong is not None else MSS
        return max(0, min(cwnd, max(self.snd_wnd, 0)) - flight)

    # ------------------------------------------------------------------
    # packet construction / emission
    # ------------------------------------------------------------------
    def _emit(self, flags: int, seq: int, payload: bytes = b"",
              echo_ts: Optional[int] = None, track: bool = True,
              notify: bool = True) -> None:
        """Create one packet and hand it to the interface qdisc.

        ``notify=False`` defers the interface kick — the segmentizing loop
        in :meth:`_flush` emits many packets and notifies ONCE, so the
        interface drain doesn't re-run per segment."""
        now = self.host.now
        adv_window = self._adv_window()
        header = TCPHeader(self.bound_ip, self.bound_port,
                           self.peer_ip, self.peer_port,
                           flags, seq,
                           self.rcv_nxt if flags & TCP_ACK else 0,
                           adv_window,
                           self._sack_blocks() if (self.reorder
                                                   and flags & TCP_ACK) else None,
                           now,
                           echo_ts if echo_ts is not None else 0)
        pkt = Packet.new_tcp(self.host.next_packet_uid(),
                             self.host.next_packet_priority(), header, payload)
        if flags & TCP_ACK:
            # this packet carries a current ACK; any pending delayed ACK is
            # now redundant (tcp.c:1106-1107)
            self._delack_counter = 0
        consumes = len(payload) + (1 if flags & (TCP_SYN | TCP_FIN) else 0)
        if track and consumes:
            seg = _Segment(seq, seq + consumes, payload, flags, now)
            self.unacked[seq] = seg
            self._arm_rto()
        self._last_adv_window = header.window
        self.out_packets.append(pkt)
        self.out_bytes += pkt.total_size
        pkt.add_status("SND_SOCKET_BUFFERED")
        if notify:
            iface = self._iface()
            if iface is not None:
                iface.wants_send(self)

    def _sack_blocks(self) -> List[Tuple[int, int]]:
        """Contiguous runs in the reorder buffer, newest-first capped at 4
        (SACK generation; reference builds these from its unordered input)."""
        if not self.reorder:
            return []
        seqs = sorted(self.reorder)
        blocks: List[Tuple[int, int]] = []
        start = prev_end = None
        for s in seqs:
            p = self.reorder[s]
            e = s + p.payload_size
            if start is None:
                start, prev_end = s, e
            elif s <= prev_end:
                prev_end = max(prev_end, e)
            else:
                blocks.append((start, prev_end))
                start, prev_end = s, e
        blocks.append((start, prev_end))
        return blocks[-MAX_SACK_BLOCKS:]

    def _send_ack(self, echo_ts: Optional[int] = None) -> None:
        self._emit(TCP_ACK, self.snd_nxt, b"", echo_ts=echo_ts, track=False)

    def _schedule_delayed_ack(self) -> None:
        """Coalesce pure ACKs for in-order data behind a short timer
        (tcp.c:2066-2091): quick ACKs (1 ms) early in the connection to keep
        the peer's send rate growing, 5 ms after.  One timer per socket; the
        counter is cleared whenever any ACK-carrying packet goes out."""
        self._delack_counter += 1
        if self._delack_scheduled:
            return
        w = current_worker()
        if w is None:
            self._delack_counter = 0
            self._send_ack()
            return
        if self._quick_acks < 1000:
            self._quick_acks += 1
            delay = stime.SIM_TIME_MS
        else:
            delay = 5 * stime.SIM_TIME_MS
        self._delack_scheduled = True
        if w.schedule_task(Task(_delayed_ack_task, self, None,
                                name="tcp_delack"),
                           delay, dst_host=self.host) is None:
            # scheduling declined (engine stopping / past end time): leave
            # the timer unarmed so a later segment can try again
            self._delack_scheduled = False

    def _on_delayed_ack_fire(self) -> None:
        self._delack_scheduled = False
        if self._delack_counter > 0 and not self.closed \
                and self.state != CLOSED:
            self._send_ack()   # _emit clears the counter

    # ------------------------------------------------------------------
    # user API: connect / listen / accept
    # ------------------------------------------------------------------
    def connect_to(self, dst_ip: int, dst_port: int) -> bool:
        """Begin the three-way handshake; returns False (in progress).
        The caller blocks on WRITABLE (set at ESTABLISHED)."""
        if self.state != CLOSED:
            raise OSError("EISCONN")
        if not self.is_bound:
            self.host.autobind_socket(self, dst_ip)
        self.peer_ip, self.peer_port = dst_ip, dst_port
        iface = self._iface()
        if iface is not None:
            # narrow the wildcard binding to the 4-tuple for reply routing
            iface.disassociate("tcp", self.bound_port)
            iface.associate(self, "tcp", self.bound_port, dst_ip, dst_port)
        self.cong = self._make_cong()
        self.iss = 0
        self.snd_una = self.snd_nxt = self.iss
        self.state = SYN_SENT
        self._emit(TCP_SYN, self.snd_nxt)
        self.snd_nxt += 1
        return False

    def take_socket_error(self) -> Optional[str]:
        err, self.error = self.error, None
        return err

    def listen(self, backlog: int = 128) -> None:
        if self.state not in (CLOSED, LISTEN):
            raise OSError("EINVAL")
        if not self.is_bound:
            self.host.autobind_socket(self, 0)
        self.state = LISTEN
        self.backlog = backlog

    def accept_child(self) -> Optional["TCPSocket"]:
        if self.accept_queue:
            child = self.accept_queue.popleft()
            child.accepted = True
            self.adjust_status(S_READABLE, bool(self.accept_queue))
            return child
        return None

    # ------------------------------------------------------------------
    # user API: send / receive
    # ------------------------------------------------------------------
    def send_user_data(self, data: bytes, dst_ip: int = 0, dst_port: int = 0) -> int:
        if self.write_shutdown:
            # POSIX: writing after SHUT_WR is EPIPE, not ENOTCONN
            raise OSError("EPIPE")
        if self.state not in (ESTABLISHED, CLOSE_WAIT):
            raise OSError("ENOTCONN" if self.error is None else self.error)
        space = self.send_buf_size - self.send_pending_bytes \
            - (self.snd_nxt - self.snd_una)
        n = min(len(data), max(0, space))
        if n == 0:
            self._update_writable()
            return 0
        self.send_pending.append(bytes(data[:n]))
        self.send_pending_bytes += n
        self._flush()
        self._update_writable()
        return n

    def peek_user_data(self, nbytes: int):
        """MSG_PEEK: copy up to nbytes of in-order data without consuming
        (reference socket buffers support peeking the same way; real HTTP
        clients like wget peek the response head before reading it)."""
        if not self.read_queue:
            if self.eof_received or self.error is not None:
                return b"", self.peer_ip or 0, self.peer_port or 0
            return None
        out = bytearray()
        for chunk in self.read_queue:
            take = nbytes - len(out)
            if take <= 0:
                break
            out.extend(chunk[:take])
        return bytes(out), self.peer_ip or 0, self.peer_port or 0

    def receive_user_data(self, nbytes: int):
        if not self.read_queue:
            if self.eof_received or self.error is not None:
                return b"", self.peer_ip or 0, self.peer_port or 0
            return None
        out = bytearray()
        while self.read_queue and len(out) < nbytes:
            chunk = self.read_queue[0]
            take = nbytes - len(out)
            if len(chunk) <= take:
                out.extend(chunk)
                self.read_queue.popleft()
            else:
                out.extend(chunk[:take])
                self.read_queue[0] = chunk[take:]
        self.read_bytes -= len(out)
        self._update_readable()
        # reopened receive window after a zero-window advertisement?
        if self._last_adv_window == 0 and self._adv_window() > 0 \
                and self.state in (ESTABLISHED, FIN_WAIT_1, FIN_WAIT_2):
            self._send_ack()
        return bytes(out), self.peer_ip or 0, self.peer_port or 0

    # ------------------------------------------------------------------
    # the send pipeline (tcp.c _tcp_flush :1121-1278)
    # ------------------------------------------------------------------
    def _flush(self) -> None:
        if self.state == CLOSED:
            return
        # 1. retransmit ranges the tally marked lost.  The dirty flag is set
        # by the two loss-marking paths (dup-ACK tally update, fast
        # retransmit) so the vast majority of flushes skip the native-lib
        # range query entirely.
        if self._tally_dirty:
            self._tally_dirty = False
            lost = self.tally.lost_ranges()
            if lost:
                self.tally.clear_lost()
                for b, e in lost:
                    self._retransmit_range(b, e)
        # 2. new data within min(cwnd, peer window).  The send buffer is a
        # byte STREAM: small app writes coalesce into full-MSS segments,
        # exactly like the reference segmentizing its buffered user bytes
        # (tcp.c:1121-1278) — a 512 B-per-write app still fills 1460 B
        # packets here.
        pending = self.send_pending
        emitted = False
        while pending:
            n = min(MSS, self._send_capacity())
            if n == 0:
                break
            chunk = pending[0]
            clen = len(chunk)
            if clen == n:
                payload = chunk
                pending.popleft()
            elif clen > n:
                payload = chunk[:n]
                pending[0] = chunk[n:]
            else:
                # gather several queued writes into one segment
                parts = [chunk]
                pending.popleft()
                size = clen
                while pending and size < n:
                    chunk = pending[0]
                    take = n - size
                    if len(chunk) <= take:
                        parts.append(chunk)
                        pending.popleft()
                        size += len(chunk)
                    else:
                        parts.append(chunk[:take])
                        pending[0] = chunk[take:]
                        size += take
                payload = b"".join(parts)
                n = size
            self.send_pending_bytes -= n
            self._emit(TCP_ACK, self.snd_nxt, payload, notify=False)
            self.snd_nxt += n
            emitted = True
        # 3. FIN once all data is out
        if self.fin_pending and not self.send_pending \
                and self.fin_seq is None:
            self.fin_seq = self.snd_nxt
            self._emit(TCP_FIN | TCP_ACK, self.snd_nxt, notify=False)
            self.snd_nxt += 1
            self.fin_pending = False
            emitted = True
        if emitted:
            iface = self._iface()
            if iface is not None:
                iface.wants_send(self)
        # 4. zero-window persist: if the peer closed its window and nothing
        # is in flight (so no RTO is running), probe so a lost window-update
        # ACK cannot deadlock the connection
        if self.send_pending and self.snd_wnd <= 0 and not self.unacked:
            self._schedule_persist()

    def _retransmit_range(self, b: int, e: int) -> None:
        for seq in sorted(self.unacked):
            seg = self.unacked[seq]
            if seg.end <= b or seg.seq >= e:
                continue
            self._retransmit_segment(seg)

    def _retransmit_segment(self, seg: _Segment) -> None:
        seg.rtx_count += 1
        seg.send_time_ns = self._now()
        self.tally.mark_retransmitted(seg.seq, seg.end)
        # a client retransmitting its SYN has nothing to ack yet
        flags = seg.flags if self.state == SYN_SENT else seg.flags | TCP_ACK
        header = TCPHeader(self.bound_ip, self.bound_port,
                           self.peer_ip, self.peer_port,
                           flags=flags, sequence=seg.seq,
                           acknowledgment=self.rcv_nxt,
                           window=self._adv_window(),
                           sel_acks=self._sack_blocks(),
                           timestamp=seg.send_time_ns, timestamp_echo=0)
        # fresh uid: the drop draw for a retransmission is independent
        # (reference redraws rand on every worker_sendPacket)
        pkt = Packet.new_tcp(self.host.next_packet_uid(),
                             self.host.next_packet_priority(), header,
                             seg.payload)
        pkt.add_status("SND_TCP_ENQUEUE_RETRANSMIT")
        self.out_packets.append(pkt)
        self.out_bytes += pkt.total_size
        iface = self._iface()
        if iface is not None:
            iface.wants_send(self)

    # ------------------------------------------------------------------
    # RTO timer (tcp.c retransmit timer tasks :923-1026)
    # ------------------------------------------------------------------
    def _arm_rto(self) -> None:
        now = self._now()
        self.rto_expiry = now + self.rto_ns
        if self._rto_scheduled:
            return
        w = current_worker()
        if w is None:
            return
        self._rto_scheduled = True
        gen = self._rto_generation
        w.schedule_task(Task(_rto_fire_task, self, gen, name="tcp_rto"),
                        self.rto_ns, dst_host=self.host)

    def _cancel_rto(self) -> None:
        self._rto_generation += 1
        self._rto_scheduled = False

    def _on_rto_fire(self, generation: int) -> None:
        # a stale generation must not clear the flag: a live task for the
        # current generation may still be pending, and clearing here would
        # let _arm_rto schedule a duplicate
        if generation != self._rto_generation or self.closed:
            return
        self._rto_scheduled = False
        now = self._now()
        if not self.unacked:
            return
        if now < self.rto_expiry:
            # a newer ACK pushed the deadline; re-sleep the difference
            w = current_worker()
            if w is not None:
                self._rto_scheduled = True
                w.schedule_task(Task(_rto_fire_task, self,
                                     self._rto_generation, name="tcp_rto"),
                                self.rto_expiry - now, dst_host=self.host)
            return
        # timeout: back off, collapse window, retransmit the oldest segment
        first_seq = min(self.unacked)
        seg = self.unacked[first_seq]
        if self.state == SYN_SENT and seg.rtx_count >= MAX_SYN_RETRIES:
            self._fail_connection("ETIMEDOUT")
            return
        if seg.rtx_count >= MAX_RETRIES:
            self._fail_connection("ETIMEDOUT")
            return
        if self.cong is not None:
            self.cong.on_timeout()
        self.dup_ack_count = 0
        self.rto_ns = _g_rto_backoff(self.rto_ns)
        self._retransmit_segment(seg)
        self._arm_rto()

    def _schedule_persist(self) -> None:
        if self._persist_scheduled:
            return
        w = current_worker()
        if w is None:
            return
        self._persist_scheduled = True
        w.schedule_task(Task(_persist_fire_task, self, None,
                             name="tcp_persist"),
                        max(self.rto_ns, RTO_MIN_NS), dst_host=self.host)

    def _on_persist_fire(self) -> None:
        self._persist_scheduled = False
        if self.closed or self.state not in (ESTABLISHED, CLOSE_WAIT,
                                             FIN_WAIT_1):
            return
        if not self.send_pending or self.snd_wnd > 0 or self.unacked:
            self._flush()
            return
        # window probe: force out 1 byte of pending data as a real segment
        chunk = self.send_pending[0]
        if len(chunk) == 1:
            self.send_pending.popleft()
        else:
            self.send_pending[0] = chunk[1:]
        self.send_pending_bytes -= 1
        self._emit(TCP_ACK, self.snd_nxt, bytes(chunk[:1]))
        self.snd_nxt += 1
        self._schedule_persist()

    def _fail_connection(self, err: str) -> None:
        self.error = err
        self._cancel_rto()
        self.eof_received = True
        if self.parent is not None and not self.accepted:
            # embryonic/queued child: no app holds it, so nobody will ever
            # close() it — release the descriptor, the 4-tuple binding and
            # the parent link now, else new SYNs from the same client port
            # route to this dead child forever
            self._teardown()
        else:
            self.state = CLOSED
            self.release_bindings()
        self.adjust_status(S_READABLE | S_WRITABLE, True)  # wake blockers

    # ------------------------------------------------------------------
    # RTT estimation (RFC 6298; tcp.c:991)
    # ------------------------------------------------------------------
    def _rtt_sample(self, sample_ns: int) -> None:
        if sample_ns <= 0:
            return
        # rttvar first: it reads the PRE-update srtt (RFC 6298 order)
        self.rttvar_ns = _g_rttvar_update(self.srtt_ns, self.rttvar_ns,
                                          sample_ns)
        self.srtt_ns = _g_srtt_update(self.srtt_ns, sample_ns)
        self.rto_ns = _g_rto_from_estimate(self.srtt_ns, self.rttvar_ns)
        self._autotune(sample_ns)

    def _recv_autotune(self) -> None:
        """Receiver-side buffer autotuning, ticked from the RECEIVE path
        (the reference tunes its receive buffer while data arrives,
        tcp.c:441-521): once per RTT-ish window, grow toward 2x the bytes
        received in that window.  A pure receiver never processes ACKs, so
        the sender-path hook alone would never fire for it."""
        if not self.autotune_recv:
            return
        now = self.host.now
        if self._rtt_window_start == 0:
            self._rtt_window_start = now
            return
        rtt = self.srtt_ns or (200 * stime.SIM_TIME_MS)
        if now - self._rtt_window_start < rtt:
            return
        target = 2 * self._rtt_bytes_in
        if target > self.recv_buf_size:
            self.recv_buf_size = min(target, defs.CONFIG_TCP_RMEM_MAX)
        self._rtt_bytes_in = 0
        self._rtt_window_start = now

    def _autotune(self, rtt_ns: int) -> None:
        """Grow buffers toward 2x the measured bandwidth-delay product
        (reference per-RTT autotuning, tcp.c:441-600)."""
        now = self._now()
        if self._rtt_window_start == 0:
            self._rtt_window_start = now
            return
        elapsed = now - self._rtt_window_start
        if elapsed < rtt_ns:
            return
        if self.autotune_recv and self._rtt_bytes_in > 0:
            target = 2 * self._rtt_bytes_in
            if target > self.recv_buf_size:
                self.recv_buf_size = min(target, defs.CONFIG_TCP_RMEM_MAX)
        if self.autotune_send and self.cong is not None:
            target = 2 * self.cong.cwnd
            if target > self.send_buf_size:
                self.send_buf_size = min(target, defs.CONFIG_TCP_WMEM_MAX)
        self._rtt_bytes_in = 0
        self._rtt_window_start = now

    # ------------------------------------------------------------------
    # inbound packet processing (tcp.c tcp_processPacket :1777-2099)
    # ------------------------------------------------------------------
    def push_in_packet(self, packet: Packet) -> None:
        flags = packet.header.flags
        if self.state == LISTEN:
            self._listen_process(packet)
            return
        if flags & TCP_RST:
            self._process_rst(packet)
            return
        if self.state == SYN_SENT:
            self._syn_sent_process(packet)
            return
        if flags & TCP_SYN:
            # duplicate SYN (our SYN+ACK or its ACK was lost): re-ACK
            self._send_ack(echo_ts=packet.header.timestamp)
            return
        if flags & TCP_ACK:
            self._ack_processing(packet)
        if packet.payload_size > 0 or flags & TCP_FIN:
            self._data_processing(packet)
        packet.add_status("RCV_SOCKET_PROCESSED")

    # -- LISTEN: spawn children (tcp.c child/server mux :91-113) ----------
    def _listen_process(self, packet: Packet) -> None:
        flags = packet.header.flags
        key = (packet.src_ip, packet.src_port)
        child = self.children.get(key)
        if child is not None:
            child.push_in_packet(packet)
            return
        if not flags & TCP_SYN:
            return  # stray non-SYN to listener: ignore
        # backlog counts connections not yet handed to accept()
        pending = len(self.accept_queue) + sum(
            1 for c in self.children.values() if c.state == SYN_RECEIVED)
        if pending >= max(self.backlog, 1):
            return  # backlog full: drop; client will retransmit SYN
        host = self.host
        handle = host.allocate_handle()
        child = TCPSocket(host, handle, host.params.recv_buf_size,
                          host.params.send_buf_size, parent=self)
        host.register_descriptor(child)
        # reply with the address the SYN actually arrived on (matters for a
        # wildcard-bound listener reachable on loopback and eth)
        child.bind_to(packet.dst_ip, self.bound_port)
        child.peer_ip, child.peer_port = key
        child.cong = child._make_cong()
        self.children[key] = child
        iface = host.interface_for_ip(packet.dst_ip) or self._iface()
        if iface is not None:
            iface.associate(child, "tcp", child.bound_port,
                            packet.src_ip, packet.src_port)
        # receive SYN
        child.irs = packet.header.sequence
        child.rcv_nxt = packet.header.sequence + 1
        child.snd_wnd = packet.header.window or MSS
        child.state = SYN_RECEIVED
        child.iss = 0
        child.snd_una = child.snd_nxt = child.iss
        child._emit(TCP_SYN | TCP_ACK, child.snd_nxt,
                    echo_ts=packet.header.timestamp)
        child.snd_nxt += 1

    def _child_established(self, child: "TCPSocket") -> None:
        self.accept_queue.append(child)
        self.adjust_status(S_READABLE, True)

    def _detach_child(self, child: "TCPSocket") -> None:
        self.children.pop((child.peer_ip, child.peer_port), None)
        if child in self.accept_queue:
            self.accept_queue.remove(child)
            self._update_readable()

    # -- SYN_SENT ---------------------------------------------------------
    def _syn_sent_process(self, packet: Packet) -> None:
        flags = packet.header.flags
        if not (flags & TCP_SYN and flags & TCP_ACK):
            return
        if packet.header.acknowledgment != self.snd_nxt:
            return
        self.irs = packet.header.sequence
        self.rcv_nxt = packet.header.sequence + 1
        self.snd_una = packet.header.acknowledgment
        self.snd_wnd = packet.header.window or MSS
        self.unacked.pop(self.iss, None)
        self._cancel_rto()
        self._rtt_sample(self._now() - packet.header.timestamp_echo
                         if packet.header.timestamp_echo else 0)
        self.state = ESTABLISHED
        self._send_ack(echo_ts=packet.header.timestamp)
        self._update_writable()

    # -- RST --------------------------------------------------------------
    def _process_rst(self, packet: Packet) -> None:
        err = "ECONNREFUSED" if self.state == SYN_SENT else "ECONNRESET"
        if self.parent is not None:
            self.parent._detach_child(self)
        self._fail_connection(err)

    # -- ACK processing (tcp.c _tcp_ackProcessing :1662) ------------------
    def _ack_processing(self, packet: Packet) -> None:
        h = packet.header
        ack = h.acknowledgment
        self.snd_wnd = h.window
        now = self._now()
        # SACK blocks into the tally
        for b, e in h.sel_acks:
            if e > self.snd_una:
                self.tally.mark_sacked(max(b, self.snd_una), e)
        if ack > self.snd_una:
            acked_bytes = ack - self.snd_una
            self.snd_una = ack
            self.dup_ack_count = 0
            self.tally.advance_una(ack)
            # drop fully-acked segments; RTT from the newest acked segment
            newest_ts = 0
            for seq in [s for s in self.unacked if self.unacked[s].end <= ack]:
                seg = self.unacked.pop(seq)
                if seg.rtx_count == 0:
                    newest_ts = max(newest_ts, seg.send_time_ns)
            if h.timestamp_echo:
                self._rtt_sample(now - h.timestamp_echo)
            elif newest_ts:
                self._rtt_sample(now - newest_ts)
            if self.cong is not None:
                self.cong.on_new_ack(acked_bytes, self.snd_una, now)
            if self.unacked:
                self.rto_expiry = now + self.rto_ns
                self._arm_rto()
            else:
                self._cancel_rto()
            self._on_snd_una_advanced(ack)
        elif ack == self.snd_una and self.snd_nxt > self.snd_una \
                and packet.payload_size == 0 \
                and not (h.flags & (TCP_SYN | TCP_FIN)):
            # pure duplicate ACK
            self.dup_ack_count += 1
            self.tally.update_lost(self.snd_una, self.snd_nxt,
                                   self.dup_ack_count)
            self._tally_dirty = True
            if self.cong is not None \
                    and self.cong.on_duplicate_ack(self.dup_ack_count,
                                                   self.snd_nxt):
                # fast retransmit: without SACK info, the una segment is lost
                if not self.tally.lost_ranges() and self.snd_una in self.unacked:
                    self.tally.mark_lost(self.snd_una,
                                         self.unacked[self.snd_una].end)
        self._flush()
        self._update_writable()

    def _on_snd_una_advanced(self, ack: int) -> None:
        """Handshake/teardown transitions driven by our bytes being acked."""
        if self.state == SYN_RECEIVED and ack >= self.iss + 1:
            self.state = ESTABLISHED
            self._update_writable()
            if self.parent is not None:
                self.parent._child_established(self)
        if self.fin_seq is not None and ack >= self.fin_seq + 1:
            self.fin_acked = True
            if self.state == FIN_WAIT_1:
                self.state = FIN_WAIT_2
            elif self.state == CLOSING:
                self._enter_time_wait()
            elif self.state == LAST_ACK:
                self._teardown()

    # -- data + FIN (tcp.c _tcp_dataProcessing :1597) ---------------------
    def _data_processing(self, packet: Packet) -> None:
        h = packet.header
        seq = h.sequence
        size = packet.payload_size
        end = seq + size
        if size > 0:
            if end <= self.rcv_nxt:
                # full duplicate: re-ACK so the sender's tally advances
                self._send_ack(echo_ts=h.timestamp)
                return
            if seq > self.rcv_nxt:
                # out of order: hold in reorder buffer if window allows
                if self.reorder_bytes + size <= self.recv_buf_size \
                        and seq not in self.reorder:
                    self.reorder[seq] = packet
                    self.reorder_bytes += size
                    packet.add_status("RCV_SOCKET_BUFFERED")
                else:
                    self.drop_packet(packet)
                self._send_ack(echo_ts=h.timestamp)  # dup ACK w/ SACK blocks
                return
            # in order (possibly partially duplicate)
            payload = packet.payload[self.rcv_nxt - seq:]
            self._append_read(payload)
            self.rcv_nxt = end
            self._drain_reorder()
        fin = bool(h.flags & TCP_FIN)
        if fin:
            fin_seq = seq + size
            if fin_seq == self.rcv_nxt:
                self.rcv_nxt = fin_seq + 1
                self._on_fin_received()
        if fin:
            # FIN ACKs go out now so the close sequence completes promptly
            # (the reference always sends FIN-related control immediately)
            self._send_ack(echo_ts=h.timestamp)
        else:
            # in-order new data: the pure ACK can be delayed (tcp.c:2047-2051)
            self._schedule_delayed_ack()
        if size > 0:
            self._rtt_bytes_in += size
            self._recv_autotune()
            self._update_readable()

    def _append_read(self, data: bytes) -> None:
        if not data:
            return
        self.read_queue.append(data)
        self.read_bytes += len(data)

    def _drain_reorder(self) -> None:
        while self.rcv_nxt in self.reorder:
            p = self.reorder.pop(self.rcv_nxt)
            self.reorder_bytes -= p.payload_size
            self._append_read(p.payload)
            self.rcv_nxt += p.payload_size
            if p.header.flags & TCP_FIN:
                self.rcv_nxt += 1
                self._on_fin_received()

    def _on_fin_received(self) -> None:
        self.eof_received = True
        if self.state == ESTABLISHED:
            self.state = CLOSE_WAIT
        elif self.state == FIN_WAIT_1:
            self.state = CLOSING if not self.fin_acked else TIME_WAIT
            if self.state == TIME_WAIT:
                self._enter_time_wait()
        elif self.state == FIN_WAIT_2:
            self._enter_time_wait()
        self.adjust_status(S_READABLE, True)  # EOF is readable

    # ------------------------------------------------------------------
    # teardown
    # ------------------------------------------------------------------
    def shutdown(self, how: int) -> None:
        """shutdown(2): 0=SHUT_RD, 1=SHUT_WR, 2=SHUT_RDWR.

        SHUT_WR sends FIN after pending data but the app keeps receiving
        (the classic half-close: 'I'm done sending, finish your reply');
        SHUT_RD discards buffered input and makes further reads return EOF.
        The descriptor stays open either way — close() still owns teardown.
        """
        if how not in (0, 1, 2):
            raise OSError("EINVAL")
        if self.state in (CLOSED, LISTEN, SYN_SENT):
            raise OSError("ENOTCONN")
        if how in (1, 2) and not self.fin_pending and self.fin_seq is None:
            if self.state in (ESTABLISHED, SYN_RECEIVED):
                self.state = FIN_WAIT_1
                self.fin_pending = True
                self._flush()
            elif self.state == CLOSE_WAIT:
                self.state = LAST_ACK
                self.fin_pending = True
                self._flush()
            self.write_shutdown = True
            self.adjust_status(S_WRITABLE, False)
        if how in (0, 2):
            self.read_queue.clear()
            self.read_bytes = 0
            self.eof_received = True
            self._update_readable()

    def close(self) -> None:
        """Application close: send FIN after pending data (half-close of
        our direction), keep the machinery alive until teardown."""
        if self.app_closed:
            return
        self.app_closed = True
        if self.state == LISTEN or (self.state == CLOSED and self.error is None
                                    and self.cong is None):
            self._teardown()
            return
        if self.state in (CLOSED, TIME_WAIT):
            self._teardown()
            return
        if self.state in (ESTABLISHED, SYN_RECEIVED):
            self.state = FIN_WAIT_1
            self.fin_pending = True
            self._flush()
        elif self.state == CLOSE_WAIT:
            self.state = LAST_ACK
            self.fin_pending = True
            self._flush()
        elif self.state == SYN_SENT:
            self._fail_connection("ECONNABORTED")
            self._teardown()

    def _enter_time_wait(self) -> None:
        self.state = TIME_WAIT
        self._cancel_rto()
        w = current_worker()
        if w is not None:
            w.schedule_task(Task(_time_wait_task, self, None,
                                 name="tcp_time_wait"),
                            TIME_WAIT_NS, dst_host=self.host)
        else:
            self._teardown()

    def _teardown(self) -> None:
        """Final resource release (descriptor close + binding removal)."""
        self.state = CLOSED
        self._cancel_rto()
        # a closing listener resets every connection the app has not
        # accepted: they would otherwise complete handshakes into a dead
        # accept queue and leak (tcp.c resets pending children on server
        # close)
        for child in list(self.children.values()):
            child.parent = None
            if not child.accepted and not child.closed:
                if child.state not in (CLOSED, LISTEN):
                    child._emit(TCP_RST | TCP_ACK, child.snd_nxt)
                child._teardown()
        self.children.clear()
        self.accept_queue.clear()
        if self.parent is not None:
            self.parent._detach_child(self)
        self.tally.close()
        if not self.closed:
            # Socket.close drops every interface binding this socket holds
            super().close()

    # ------------------------------------------------------------------
    # status upkeep
    # ------------------------------------------------------------------
    def _update_readable(self) -> None:
        readable = bool(self.read_queue) or self.eof_received \
            or bool(self.accept_queue)
        if bool(self.status & S_READABLE) != readable:
            self.adjust_status(S_READABLE, readable)

    def _update_writable(self) -> None:
        if self.state not in (ESTABLISHED, CLOSE_WAIT):
            if self.error is not None:
                self.adjust_status(S_WRITABLE, True)
            return
        space = self.send_buf_size - self.send_pending_bytes \
            - (self.snd_nxt - self.snd_una)
        writable = space > 0
        if bool(self.status & S_WRITABLE) != writable:
            self.adjust_status(S_WRITABLE, writable)

    def pull_out_packet(self):
        p = super().pull_out_packet()
        self._update_writable()
        return p


def _rto_fire_task(sock: TCPSocket, generation: int) -> None:
    sock._on_rto_fire(generation)


def _persist_fire_task(sock: TCPSocket, _arg) -> None:
    sock._on_persist_fire()


def _delayed_ack_task(sock: TCPSocket, _arg) -> None:
    sock._on_delayed_ack_fire()


def _time_wait_task(sock: TCPSocket, _arg) -> None:
    if sock.state == TIME_WAIT:
        sock._teardown()
