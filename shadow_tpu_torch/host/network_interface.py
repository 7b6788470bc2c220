"""NetworkInterface: token-bucket bandwidth shaping + qdisc + socket binding.

Capability parity with the reference's hot-path component
(host/network_interface.c):

* **Token buckets** for up/down bandwidth: refill every 1 ms with
  rate/1000 bytes, capacity = refill + MTU (:93-95, :207-214).  The refill
  task is self-suspending: it only stays scheduled while there is pending
  work (:121-183), so idle interfaces cost nothing.
* **Binding table** (protocol, port, peer_ip, peer_port) → socket
  (:255-335) with wildcard peer fallback, used to deliver arriving packets.
* **Receive loop** drains the upstream router while tokens last (:421-455).
* **Send loop** drains bound sockets by qdisc — round-robin or
  FIFO-by-packet-priority (:466-517) — and hands packets to
  ``worker.send_packet`` (the reference goes through router_forward,
  router.c:96-102).  Loopback destinations short-circuit with a local task
  (:519-579).
* pcap capture hook per packet in/out (:337-373).

This class is the source of truth for bandwidth state under every scheduler
policy.  A vectorized device twin of the token-bucket admission math lives
in ops/bandwidth.py (parity-tested against this implementation); wiring it
into the tpu policy's round step — so bandwidth drops are decided on device
— is the remaining north-star integration (BASELINE.json).
"""

from __future__ import annotations

from collections import deque
from typing import Dict, Optional, Tuple

from ..core import defs, stime
from ..core.logger import get_logger
from ..core.task import Task
from ..routing.address import LOCALHOST_IP
from ..core.worker import current_worker


class TokenBucket:
    __slots__ = ("bytes_refill", "bytes_capacity", "bytes_remaining")

    def __init__(self, rate_kibps: int):
        # bytes per 1ms interval (network_interface.c:199-205)
        time_factor = stime.SIM_TIME_SEC // defs.INTERFACE_REFILL_INTERVAL_NS
        self.bytes_refill = (rate_kibps * 1024) // time_factor
        self.bytes_capacity = (self.bytes_refill * defs.INTERFACE_CAPACITY_FACTOR
                               + defs.CONFIG_MTU)
        self.bytes_remaining = self.bytes_capacity

    def refill(self) -> None:
        self.bytes_remaining = min(self.bytes_remaining + self.bytes_refill,
                                   self.bytes_capacity)

    def try_consume(self, nbytes: int) -> bool:
        if self.bytes_remaining >= nbytes:
            self.bytes_remaining -= nbytes
            return True
        return False


class NetworkInterface:
    def __init__(self, host, address, bw_down_kibps: int, bw_up_kibps: int,
                 qdisc: str = "fifo", pcap_writer=None):
        self.host = host
        self.address = address            # routing.address.Address
        self.is_loopback = address.ip == LOCALHOST_IP
        self.qdisc = qdisc
        self.send_bucket = TokenBucket(bw_up_kibps)
        self.receive_bucket = TokenBucket(bw_down_kibps)
        self.router = None                # set for eth ifaces by Host
        self.pcap = pcap_writer
        # (protocol, port, peer_ip, peer_port) -> socket; wildcard peer = (0,0)
        self._bindings: Dict[Tuple[str, int, int, int], object] = {}
        # sockets with queued outbound packets, FIFO arrival order for RR
        # (deque preserves order; the set makes the membership test O(1))
        self._ready_senders: deque = deque()
        self._ready_set: set = set()
        self._refill_scheduled = False
        # local delivery buffer for loopback/self-directed packets
        self._arrivals: deque = deque()
        self._receive_pending = False

    # -- binding table (network_interface.c:255-335) -----------------------
    @staticmethod
    def _key(protocol: str, port: int, peer_ip: int = 0, peer_port: int = 0):
        return (protocol, port, peer_ip, peer_port)

    def associate(self, socket, protocol: str, port: int, peer_ip: int = 0,
                  peer_port: int = 0) -> None:
        key = self._key(protocol, port, peer_ip, peer_port)
        self._bindings[key] = socket
        # back-reference so Socket.close can drop every binding it holds
        # (a wildcard bind associates on multiple interfaces)
        assoc = getattr(socket, "_associations", None)
        if assoc is not None and (self, key) not in assoc:
            assoc.append((self, key))

    def disassociate(self, protocol: str, port: int, peer_ip: int = 0,
                     peer_port: int = 0) -> None:
        key = self._key(protocol, port, peer_ip, peer_port)
        sock = self._bindings.get(key)
        if sock is not None:
            self.disassociate_key(key, sock)

    def disassociate_key(self, key, sock) -> None:
        """Single removal point for binding entries: drops ``key`` only if
        it still refers to ``sock`` (a stale pair must not evict another
        socket's live binding)."""
        if self._bindings.get(key) is sock:
            del self._bindings[key]
        assoc = getattr(sock, "_associations", None)
        if assoc and (self, key) in assoc:
            assoc.remove((self, key))

    def is_associated(self, protocol: str, port: int, peer_ip: int = 0,
                      peer_port: int = 0) -> bool:
        return self._key(protocol, port, peer_ip, peer_port) in self._bindings

    def lookup_socket(self, packet):
        """Specific (4-tuple) binding first, then wildcard-peer listener."""
        protocol = "tcp" if packet.is_tcp() else "udp"
        s = self._bindings.get(self._key(protocol, packet.dst_port,
                                         packet.src_ip, packet.src_port))
        if s is None:
            s = self._bindings.get(self._key(protocol, packet.dst_port))
        return s

    # -- refill task (network_interface.c:121-183) -------------------------
    def _has_pending_work(self) -> bool:
        if self._ready_senders:
            return True
        if self.router is not None and self.router.peek() is not None:
            return True
        if self._arrivals:
            return True
        return False

    def _ensure_refill_scheduled(self) -> None:
        if self._refill_scheduled or self.is_loopback:
            return
        w = current_worker()
        if w is None:
            return
        self._refill_scheduled = True
        w.schedule_task(Task(_refill_task, self, None, name="iface_refill"),
                        defs.INTERFACE_REFILL_INTERVAL_NS, dst_host=self.host)

    def _on_refill(self) -> None:
        self._refill_scheduled = False
        self.send_bucket.refill()
        self.receive_bucket.refill()
        self.receive_packets()
        self.send_packets()
        if self._has_pending_work():
            self._ensure_refill_scheduled()

    # -- receive path ------------------------------------------------------
    def on_router_ready(self) -> None:
        """First packet buffered upstream: start draining."""
        self.receive_packets()
        if self._has_pending_work():
            self._ensure_refill_scheduled()

    def push_arrival(self, packet) -> None:
        """Loopback / self-directed arrival bypassing the router."""
        self._arrivals.append(packet)
        self.receive_packets()
        if self._has_pending_work():
            self._ensure_refill_scheduled()

    def receive_packets(self) -> None:
        """Drain arrivals while bandwidth tokens allow
        (network_interface.c:421-455).  Loopback is unthrottled."""
        w = current_worker()
        now = w.now if w is not None else 0
        bootstrapping = w.is_bootstrapping() if w is not None else False
        while True:
            src = None
            if self._arrivals:
                packet = self._arrivals[0]
                src = "local"
            elif self.router is not None:
                # peek the packet that will actually be delivered (the AQM
                # may drop queued packets on the way) so the token spend
                # matches the delivered bytes exactly
                packet = self.router.peek_deliverable(now)
                src = "router"
            else:
                packet = None
            if packet is None:
                return
            unthrottled = self.is_loopback or bootstrapping
            if not unthrottled and not self.receive_bucket.try_consume(packet.total_size):
                return  # out of tokens; refill task will resume us
            if src == "local":
                self._arrivals.popleft()
            else:
                packet = self.router.dequeue(now)
            packet.add_status("RCV_INTERFACE_RECEIVED")
            if self.pcap is not None:
                self.pcap.write_packet(now, packet)
            self._deliver(packet)

    def _deliver(self, packet) -> None:
        sock = self.lookup_socket(packet)
        if sock is None:
            packet.add_status("RCV_INTERFACE_DROPPED")
            self.host.tracker.add_drop(packet)
            return
        sock.push_in_packet(packet)
        self.host.tracker.add_input_bytes(packet, self.address.ip)

    # -- send path ---------------------------------------------------------
    def wants_send(self, socket) -> None:
        """A socket has queued outbound data (network_interface.c:581)."""
        if socket not in self._ready_set:
            self._ready_set.add(socket)
            self._ready_senders.append(socket)
        self.send_packets()
        if self._has_pending_work():
            self._ensure_refill_scheduled()

    def _select_socket(self):
        """qdisc: rr = rotate ready list; fifo = lowest packet priority
        first (network_interface.c:466-517)."""
        while self._ready_senders:
            if self.qdisc == "rr":
                s = self._ready_senders[0]
                if s.peek_out_packet() is None:
                    self._ready_senders.popleft()
                    self._ready_set.discard(s)
                    continue
                return s
            best, best_prio = None, None
            for s in self._ready_senders:
                p = s.peek_out_packet()
                if p is None:
                    continue
                if best_prio is None or p.priority < best_prio:
                    best, best_prio = s, p.priority
            if best is None:
                self._ready_senders.clear()
                self._ready_set.clear()
                return None
            return best
        return None

    def send_packets(self) -> None:
        w = current_worker()
        if w is None:
            return
        bootstrapping = w.is_bootstrapping()
        while True:
            sock = self._select_socket()
            if sock is None:
                return
            packet = sock.peek_out_packet()
            unthrottled = self.is_loopback or bootstrapping
            if not unthrottled and not self.send_bucket.try_consume(packet.total_size):
                return
            sock.pull_out_packet()
            if self.qdisc == "rr" and self._ready_senders \
                    and self._ready_senders[0] is sock:
                self._ready_senders.rotate(-1)
            packet.add_status("SND_INTERFACE_SENT")
            self.host.tracker.add_output_bytes(packet, self.address.ip)
            if self.pcap is not None:
                self.pcap.write_packet(w.now, packet)
            dst_ip = packet.dst_ip
            if self.is_loopback or dst_ip == self.address.ip:
                # local short-circuit (network_interface.c:519-547): schedule
                # a self-delivery task after a minimal 1-tick delay to keep
                # event ordering honest.
                target = self.host.interface_for_ip(dst_ip) or self
                w.schedule_task(
                    Task(_local_delivery_task, target, packet, name="local_deliver"),
                    1, dst_host=self.host)
            else:
                w.send_packet(packet)


def _refill_task(iface: NetworkInterface, _arg) -> None:
    iface._on_refill()


def _local_delivery_task(iface: NetworkInterface, packet) -> None:
    iface.push_arrival(packet)
