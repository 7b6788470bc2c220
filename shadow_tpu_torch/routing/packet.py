"""Packet and Payload.

Capability of the reference's Packet/Payload (routing/packet.c, payload.c):

* protocol header union (local pipe / UDP / TCP) — here small per-protocol
  header objects;
* payload bytes shared on copy (payload.c refcount; Python bytes are
  immutable so sharing is free);
* per-packet priority used by the FIFO qdisc tiebreak (packet.c:52-57,
  assigned from the host's monotonically increasing counter);
* a delivery-status audit trail (packet_addDeliveryStatus, 20+ PDS_* flags)
  used for debugging and by tests to assert a packet's life cycle;
* a globally unique ``uid`` that keys the order-independent reliability draw
  (replaces the reference's execution-order-coupled rand_r draw).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..core import defs

# Delivery-status flags (subset of the reference's PDS_* covering every
# transition our pipeline makes; extend freely).
STATUSES = (
    "CREATED", "SND_CREATED", "SND_TCP_ENQUEUE_THROTTLED", "SND_TCP_ENQUEUE_RETRANSMIT",
    "SND_SOCKET_BUFFERED", "SND_INTERFACE_SENT", "INET_SENT", "INET_DROPPED",
    "ROUTER_ENQUEUED", "ROUTER_DROPPED", "ROUTER_DEQUEUED",
    "RCV_INTERFACE_BUFFERED", "RCV_INTERFACE_RECEIVED", "RCV_INTERFACE_DROPPED",
    "RCV_SOCKET_PROCESSED", "RCV_SOCKET_DROPPED", "RCV_SOCKET_BUFFERED",
    "RCV_SOCKET_DELIVERED", "DESTROYED",
)


class UDPHeader:
    __slots__ = ("src_ip", "src_port", "dst_ip", "dst_port")

    def __init__(self, src_ip, src_port, dst_ip, dst_port):
        self.src_ip = src_ip
        self.src_port = src_port
        self.dst_ip = dst_ip
        self.dst_port = dst_port


class TCPHeader:
    __slots__ = ("src_ip", "src_port", "dst_ip", "dst_port", "flags",
                 "sequence", "acknowledgment", "window", "sel_acks", "timestamp",
                 "timestamp_echo")

    def __init__(self, src_ip, src_port, dst_ip, dst_port, flags=0,
                 sequence=0, acknowledgment=0, window=0,
                 sel_acks: Optional[List[Tuple[int, int]]] = None,
                 timestamp: int = 0, timestamp_echo: int = 0):
        self.src_ip = src_ip
        self.src_port = src_port
        self.dst_ip = dst_ip
        self.dst_port = dst_port
        self.flags = flags
        self.sequence = sequence
        self.acknowledgment = acknowledgment
        self.window = window
        self.sel_acks = sel_acks or []
        self.timestamp = timestamp
        self.timestamp_echo = timestamp_echo


# >>> simgen:begin region=tcp-flags spec=293c930bb679 body=5c389b66fae3
# TCP header flag bits (reference tcp.c enum ProtocolTCPFlags).
TCP_NONE = 0
TCP_RST = 2
TCP_SYN = 4
TCP_ACK = 8
TCP_FIN = 16
# <<< simgen:end region=tcp-flags


# Full per-packet delivery-status audit trails (the reference's PDS_* flags,
# packet.c:59-60) cost real time at millions of packets; they are recorded
# only when the log level includes debug.  The retransmit marker the Tracker
# needs survives as a dedicated flag either way.
AUDIT_STATUSES = False


class Packet:
    """A simulated network packet."""

    __slots__ = ("uid", "header", "payload", "priority", "statuses",
                 "header_size", "arrival_time", "total_size", "retransmit",
                 "src_ip", "dst_ip", "src_port", "dst_port", "payload_size")

    _uid_counter = 0

    def __init__(self, uid: int, header, payload: bytes, priority: int,
                 header_size: int):
        self.uid = uid                  # global, keys the reliability draw
        self.header = header
        self.payload = payload or b""
        self.priority = priority        # FIFO qdisc tiebreak
        self.header_size = header_size
        self.statuses: List[str] = ["CREATED"] if AUDIT_STATUSES else []
        self.arrival_time = -1
        # bytes charged to token buckets; header and payload are immutable,
        # so sizes and addresses are flattened to plain attributes (these are
        # the hottest reads in the whole pipeline)
        self.payload_size = len(self.payload)
        self.total_size = header_size + self.payload_size
        self.retransmit = False
        self.src_ip = header.src_ip
        self.dst_ip = header.dst_ip
        self.src_port = header.src_port
        self.dst_port = header.dst_port

    # -- constructors ------------------------------------------------------
    @classmethod
    def new_udp(cls, uid: int, priority: int, src_ip, src_port, dst_ip,
                dst_port, payload: bytes) -> "Packet":
        assert len(payload) <= defs.CONFIG_DATAGRAM_MAX_SIZE
        return cls(uid, UDPHeader(src_ip, src_port, dst_ip, dst_port), payload,
                   priority, defs.CONFIG_HEADER_SIZE_UDPIPETH)

    @classmethod
    def new_tcp(cls, uid: int, priority: int, header: TCPHeader,
                payload: bytes) -> "Packet":
        return cls(uid, header, payload, priority, defs.CONFIG_HEADER_SIZE_TCPIPETH)

    def copy(self, new_uid: int) -> "Packet":
        """Header deep copy, payload shared (reference packet_copy :100).
        Retransmitted TCP packets get fresh uids so their drop draws are
        independent, like fresh rand draws in the reference."""
        import copy as _copy
        p = Packet(new_uid, _copy.copy(self.header), self.payload,
                   self.priority, self.header_size)
        p.statuses = list(self.statuses)
        p.retransmit = self.retransmit
        return p

    # -- cross-process wire format (parallel/procs.py) ---------------------
    def to_wire(self) -> tuple:
        """Flatten to plain ints/bytes for shipping to another shard engine
        (the procs scale-out exchanges packets at round barriers the way the
        reference's master/slave split would over MPI).  Exact round-trip:
        ``from_wire(p.to_wire())`` reconstructs every field the receiving
        host's protocol stack and the state digest can observe."""
        h = self.header
        if isinstance(h, TCPHeader):
            hdr = ("t", h.src_ip, h.src_port, h.dst_ip, h.dst_port, h.flags,
                   h.sequence, h.acknowledgment, h.window,
                   tuple(h.sel_acks), h.timestamp, h.timestamp_echo)
        else:
            hdr = ("u", h.src_ip, h.src_port, h.dst_ip, h.dst_port)
        return (self.uid, self.priority, hdr, self.payload, self.retransmit,
                tuple(self.statuses))

    @classmethod
    def from_wire(cls, wire: tuple) -> "Packet":
        uid, priority, hdr, payload, retransmit, statuses = wire
        if hdr[0] == "t":
            header = TCPHeader(hdr[1], hdr[2], hdr[3], hdr[4], hdr[5], hdr[6],
                               hdr[7], hdr[8], [tuple(b) for b in hdr[9]],
                               hdr[10], hdr[11])
            hsize = defs.CONFIG_HEADER_SIZE_TCPIPETH
        else:
            header = UDPHeader(hdr[1], hdr[2], hdr[3], hdr[4])
            hsize = defs.CONFIG_HEADER_SIZE_UDPIPETH
        p = cls(uid, header, payload, priority, hsize)
        p.retransmit = retransmit
        p.statuses = list(statuses)
        return p

    # -- accessors ---------------------------------------------------------
    def is_tcp(self) -> bool:
        return isinstance(self.header, TCPHeader)

    def add_status(self, status: str) -> None:
        if status == "SND_TCP_ENQUEUE_RETRANSMIT":
            self.retransmit = True
        if AUDIT_STATUSES:
            self.statuses.append(status)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        kind = "tcp" if self.is_tcp() else "udp"
        return (f"Packet#{self.uid}({kind} {self.src_ip}:{self.src_port}->"
                f"{self.dst_ip}:{self.dst_port} len={self.payload_size})")
