"""DNS: the global name <-> IP registry.

Capability of the reference's DNS (routing/dns.c): assigns unique IPs from a
counter while skipping restricted CIDR ranges (dns.c:30-66), registers
(name, ip) pairs, resolves both directions; backs getaddrinfo emulation.
Assignment order is deterministic (registration order), which matters for the
determinism gate.
"""

from __future__ import annotations

from typing import Dict, Optional

from .address import Address, ip_to_int, int_to_ip


def _in_range(ip: int, base: str, prefix: int) -> bool:
    b = ip_to_int(base)
    mask = ((1 << prefix) - 1) << (32 - prefix)
    return (ip & mask) == (b & mask)


# The ranges the reference refuses to hand out (dns.c:30-66): loopback,
# zero-net, link-local, multicast/reserved, broadcast.  ONE definition:
# both the per-IP test and the block reservation derive from it.
_RESTRICTED_CIDRS = (("127.0.0.0", 8), ("0.0.0.0", 8), ("169.254.0.0", 16),
                     ("224.0.0.0", 4), ("240.0.0.0", 4),
                     ("255.255.255.255", 32))

_RESTRICTED = None


def _restricted_intervals():
    """_RESTRICTED_CIDRS as sorted [lo, hi) int intervals, computed once."""
    global _RESTRICTED
    if _RESTRICTED is None:
        ivals = []
        for base, prefix in _RESTRICTED_CIDRS:
            lo = ip_to_int(base) & ((((1 << prefix) - 1)
                                     << (32 - prefix)) & 0xFFFFFFFF)
            ivals.append((lo, lo + (1 << (32 - prefix))))
        _RESTRICTED = sorted(ivals)
    return _RESTRICTED


def _is_restricted(ip: int) -> bool:
    return any(_in_range(ip, base, prefix)
               for base, prefix in _RESTRICTED_CIDRS)


class DNS:
    def __init__(self):
        self._ip_counter = ip_to_int("11.0.0.1")
        self._by_name: Dict[str, Address] = {}
        self._by_ip: Dict[int, Address] = {}
        # lazy resolver (scale/hosttable.py): consulted on a miss so
        # table-resident hosts resolve without ever materializing an
        # Address per quiet host up front.  Returns an Address (which the
        # hook itself registers) or None.
        self.lazy_resolver = None
        # block reservations ([lo, hi) intervals): their IPs are assigned
        # but deliberately NOT in _by_ip — collision checks must consult
        # this list too, or an ip_hint could duplicate a reserved row's IP
        self._blocks: list = []

    def _in_reserved_block(self, ip: int) -> bool:
        return any(lo <= ip < hi for lo, hi in self._blocks)

    def unique_ip(self) -> int:
        ip = self._ip_counter
        while _is_restricted(ip) or ip in self._by_ip \
                or self._in_reserved_block(ip):
            ip += 1
        self._ip_counter = ip + 1
        return ip

    def try_reserve_block(self, count: int) -> Optional[int]:
        """Claim ``count`` consecutive IPs starting at the counter and
        return the base — or None when the candidate range is not clean
        (it crosses a restricted CIDR or an already-registered IP).  The
        caller then falls back to per-IP :meth:`register`, because
        :meth:`unique_ip` skips ONLY the colliding addresses and a block
        that jumped the whole range would assign different IPs than an
        eager per-host registration — breaking table-on vs table-off
        digest parity.  A clean block is arithmetic (base + i), which is
        what lets a 100k-row host table resolve name<->ip without a dict
        entry per host.  Interval checks, not per-IP scans."""
        base = self._ip_counter
        for lo, hi in _restricted_intervals():  # hi exclusive
            if base < hi and base + count > lo:
                return None
        for ip in self._by_ip:
            if base <= ip < base + count:
                return None
        self._ip_counter = base + count
        self._blocks.append((base, base + count))
        return base

    def adopt(self, addr: Address) -> None:
        """Register a lazily-built Address (a table row's, resolved for the
        first time) under the block reservation that already owns its IP."""
        self._by_name[addr.name] = addr
        self._by_ip[addr.ip] = addr

    def register(self, host_id: int, name: str, requested_ip: Optional[int] = None,
                 mac: int = 0) -> Address:
        if name in self._by_name:
            raise ValueError(f"hostname {name!r} is already registered")
        if requested_ip is not None and not _is_restricted(requested_ip) \
                and requested_ip not in self._by_ip \
                and not self._in_reserved_block(requested_ip):
            # a hint inside a reserved block would silently duplicate a
            # table row's IP (block IPs are assigned but not in _by_ip)
            ip = requested_ip
        else:
            ip = self.unique_ip()
        addr = Address(host_id, ip, name, mac=mac)
        self._by_name[name] = addr
        self._by_ip[ip] = addr
        return addr

    def deregister(self, addr: Address) -> None:
        self._by_name.pop(addr.name, None)
        self._by_ip.pop(addr.ip, None)

    def resolve_name(self, name: str) -> Optional[Address]:
        addr = self._by_name.get(name)
        if addr is None and self.lazy_resolver is not None:
            addr = self.lazy_resolver(name=name)
        return addr

    def resolve_ip(self, ip: int) -> Optional[Address]:
        addr = self._by_ip.get(ip)
        if addr is None and self.lazy_resolver is not None:
            addr = self.lazy_resolver(ip=ip)
        return addr

    def __len__(self) -> int:
        return len(self._by_ip)
