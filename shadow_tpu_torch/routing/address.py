"""Address: a (host id, IP, name) identity with cached string forms.

Capability of the reference's refcounted Address (routing/address.c): each
network interface gets one; DNS hands them out and resolves between forms.
IPs are plain host-order uint32 ints internally.
"""

from __future__ import annotations

import ipaddress
from typing import Optional


def ip_to_int(dotted: str) -> int:
    # manual parse: ~10x faster than ipaddress.IPv4Address and this runs
    # several times per host during 10k-host boot; falls back for anything
    # that isn't plain dotted-quad
    parts = dotted.split(".")
    if len(parts) == 4:
        try:
            a, b, c, d = (int(p) for p in parts)
            if 0 <= a <= 255 and 0 <= b <= 255 and 0 <= c <= 255 \
                    and 0 <= d <= 255 \
                    and all(p == str(int(p)) for p in parts):
                return (a << 24) | (b << 16) | (c << 8) | d
        except ValueError:
            pass
    return int(ipaddress.IPv4Address(dotted))


def int_to_ip(v: int) -> str:
    return (f"{(v >> 24) & 0xFF}.{(v >> 16) & 0xFF}."
            f"{(v >> 8) & 0xFF}.{v & 0xFF}")


LOCALHOST_IP = ip_to_int("127.0.0.1")
BROADCAST_IP = ip_to_int("255.255.255.255")


class Address:
    __slots__ = ("host_id", "ip", "name", "mac", "is_local", "_ip_str")

    def __init__(self, host_id: int, ip: int, name: str, mac: int = 0,
                 is_local: bool = False):
        self.host_id = host_id
        self.ip = ip
        self.name = name
        self.mac = mac
        self.is_local = is_local
        self._ip_str: Optional[str] = None

    @property
    def ip_string(self) -> str:
        if self._ip_str is None:
            self._ip_str = int_to_ip(self.ip)
        return self._ip_str

    def __repr__(self) -> str:
        return f"Address({self.name}={self.ip_string})"
