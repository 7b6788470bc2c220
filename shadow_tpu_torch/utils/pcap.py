"""PCAP capture of simulated traffic (reference utility/pcap_writer.c +
network_interface.c:337-373 hook): standard pcap format with synthetic
Ethernet/IP/UDP/TCP headers so Wireshark opens the files."""

from __future__ import annotations

import os
import struct
from typing import Optional

PCAP_MAGIC = 0xA1B2C3D4
LINKTYPE_ETHERNET = 1


class PcapWriter:
    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "wb")
        # global header: magic, v2.4, tz 0, sigfigs 0, snaplen 65535, ethernet
        self._f.write(struct.pack("<IHHiIII", PCAP_MAGIC, 2, 4, 0, 0, 65535,
                                  LINKTYPE_ETHERNET))

    @classmethod
    def for_host(cls, directory: str, hostname: str) -> "PcapWriter":
        os.makedirs(directory, exist_ok=True)
        return cls(os.path.join(directory, f"{hostname}.pcap"))

    def write_packet(self, sim_time_ns: int, packet) -> None:
        eth = b"\x02" * 6 + b"\x02" * 6 + b"\x08\x00"  # dst, src mac, IPv4
        if packet.is_tcp():
            proto = 6
            l4 = struct.pack(">HHIIBBHHH", packet.src_port & 0xFFFF,
                             packet.dst_port & 0xFFFF,
                             packet.header.sequence & 0xFFFFFFFF,
                             packet.header.acknowledgment & 0xFFFFFFFF,
                             5 << 4, packet.header.flags & 0xFF,
                             packet.header.window & 0xFFFF, 0, 0)
        else:
            proto = 17
            l4 = struct.pack(">HHHH", packet.src_port & 0xFFFF,
                             packet.dst_port & 0xFFFF,
                             (8 + packet.payload_size) & 0xFFFF, 0)
        total_len = 20 + len(l4) + packet.payload_size
        ip = struct.pack(">BBHHHBBHII", 0x45, 0, total_len, packet.uid & 0xFFFF,
                         0, 64, proto, 0, packet.src_ip & 0xFFFFFFFF,
                         packet.dst_ip & 0xFFFFFFFF)
        frame = eth + ip + l4 + packet.payload
        sec, ns = divmod(sim_time_ns, 1_000_000_000)
        self._f.write(struct.pack("<IIII", sec, ns // 1000, len(frame), len(frame)))
        self._f.write(frame)

    def close(self) -> None:
        try:
            self._f.close()
        except Exception:
            pass
