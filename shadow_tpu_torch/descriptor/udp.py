"""UDP socket.

Thin wrapper over the packet pipeline like the reference's udp.c: sends chop
user data into datagrams (<= CONFIG_DATAGRAM_MAX_SIZE) handed straight to
the interface; arrivals queue whole packets for recvfrom.  Cites
udp_sendUserData (udp.c:75) / udp_processPacket (udp.c:53).
"""

from __future__ import annotations

from ..core import defs
from ..routing.packet import Packet
from .base import S_READABLE, S_WRITABLE, Socket


class UDPSocket(Socket):
    def __init__(self, host, handle: int, recv_buf_size: int, send_buf_size: int):
        super().__init__(host, handle, "udp", recv_buf_size, send_buf_size)
        self.adjust_status(S_WRITABLE, True)
        self.default_interface = None   # set when bound

    # -- connect (datagram semantics) --------------------------------------
    def connect_to(self, dst_ip: int, dst_port: int) -> bool:
        """UDP connect(2): record the default destination and filter
        arrivals to that peer.  Completes immediately (returns True) —
        there is no handshake.  Real resolver-style clients connect their
        UDP sockets before send/recv."""
        if not self.is_bound:
            self.host.autobind_socket(self, dst_ip)
        self.peer_ip, self.peer_port = dst_ip, dst_port
        return True

    def take_socket_error(self):
        return None

    # -- send --------------------------------------------------------------
    def send_user_data(self, data: bytes, dst_ip: int = 0, dst_port: int = 0) -> int:
        host = self.host
        if dst_ip == 0:
            if self.peer_ip is None:
                raise ConnectionError("EDESTADDRREQ: unconnected UDP send without address")
            dst_ip, dst_port = self.peer_ip, self.peer_port
        if not self.is_bound:
            host.autobind_socket(self, dst_ip)
        if len(data) > defs.CONFIG_DATAGRAM_MAX_SIZE:
            raise OSError("EMSGSIZE: datagram too large")
        need = len(data) + defs.CONFIG_HEADER_SIZE_UDPIPETH
        if need > self.send_buf_size:
            # can never fit even in an empty buffer: returning 0 would make a
            # blocking sender spin at one virtual instant forever
            raise OSError("EMSGSIZE: datagram exceeds send buffer")
        if not self.has_out_space(need):
            return 0  # EWOULDBLOCK; caller retries when WRITABLE
        packet = Packet.new_udp(host.next_packet_uid(), host.next_packet_priority(),
                                self.bound_ip, self.bound_port, dst_ip, dst_port,
                                data)
        self.add_out_packet(packet)
        iface = host.interface_for_ip(self.bound_ip)
        if iface is not None:
            iface.wants_send(self)
        self._update_writable()
        return len(data)

    # -- receive -----------------------------------------------------------
    def peek_user_data(self, nbytes: int):
        """MSG_PEEK: the next datagram's payload without consuming it."""
        if not self.in_packets:
            return None
        p = self.in_packets[0]
        return p.payload[:nbytes], p.src_ip, p.src_port

    def receive_user_data(self, nbytes: int):
        if not self.in_packets:
            return None
        p = self.in_packets.popleft()
        self.in_bytes -= p.total_size
        data = p.payload[:nbytes]  # datagram semantics: excess is discarded
        p.add_status("RCV_SOCKET_DELIVERED")
        self._update_readable()
        self._update_writable()
        return data, p.src_ip, p.src_port

    def push_in_packet(self, packet) -> None:
        # a connected UDP socket only accepts datagrams from its peer
        if self.peer_ip is not None and (
                packet.src_ip != self.peer_ip
                or packet.src_port != self.peer_port):
            self.drop_packet(packet)
            return
        if not self.has_in_space(packet.total_size):
            self.drop_packet(packet)
            return
        packet.add_status("RCV_SOCKET_BUFFERED")
        self.in_packets.append(packet)
        self.in_bytes += packet.total_size
        self._update_readable()

    # -- status upkeep -----------------------------------------------------
    def _update_readable(self) -> None:
        self.adjust_status(S_READABLE, bool(self.in_packets))

    def _update_writable(self) -> None:
        # WRITABLE must imply a max-size datagram send will succeed, or a
        # blocking sender spins on (send -> 0, block-on-writable -> already
        # set) without ever advancing virtual time.  Clamped to the buffer
        # size so tiny configured send buffers can still become writable
        # (they just can't take a max-size datagram without draining first).
        max_need = min(defs.CONFIG_DATAGRAM_MAX_SIZE
                       + defs.CONFIG_HEADER_SIZE_UDPIPETH, self.send_buf_size)
        self.adjust_status(S_WRITABLE,
                           self.has_out_space(max_need) and not self.closed)

    def pull_out_packet(self):
        p = super().pull_out_packet()
        self._update_writable()
        return p
