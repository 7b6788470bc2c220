"""Host: everything a virtual node owns.

Capability parity with the reference's Host (host/host.c struct :47-105 and
host_setup :162-220): per-host params, the IP->interface map (loopback +
eth), the upstream Router with AQM, CPU model, Tracker, process list, the
virtual descriptor table, per-host deterministic RNG, and the counters that
feed the global event order (event sequence) and qdisc tiebreaks (packet
priority).
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..core.logger import get_logger
from ..core.rng import RandomSource
from ..routing.address import LOCALHOST_IP, Address
from .cpu import CPU
from .network_interface import NetworkInterface
from .router import Router, make_queue
from .tracker import Tracker

# >>> simgen:begin region=port-alloc spec=293c930bb679 body=00a7ffddc53c
MIN_EPHEMERAL_PORT = 10000
MAX_PORT = 65535
# <<< simgen:end region=port-alloc


class HostParams:
    """Knobs resolved from config + CLI defaults (configuration.h host attrs
    cascaded per master.c:336-377)."""

    def __init__(self, name: str, bw_down_kibps: int, bw_up_kibps: int,
                 qdisc: str = "fifo", router_queue: str = "codel",
                 tcp_cc: Optional[str] = None,
                 recv_buf_size: int = 174760, send_buf_size: int = 131072,
                 autotune_recv: bool = True, autotune_send: bool = True,
                 cpu_frequency_khz: int = 0, cpu_threshold_ns: int = -1,
                 cpu_precision_ns: int = 200, interface_buffer: int = 1024000,
                 heartbeat_interval_sec: int = 0, log_pcap: bool = False,
                 pcap_dir: Optional[str] = None, ip_hint: Optional[str] = None,
                 city_hint: Optional[str] = None, country_hint: Optional[str] = None,
                 geocode_hint: Optional[str] = None, type_hint: Optional[str] = None,
                 log_level: Optional[str] = None,
                 heartbeat_log_level: Optional[str] = None):
        self.name = name
        self.bw_down_kibps = bw_down_kibps
        self.bw_up_kibps = bw_up_kibps
        self.qdisc = qdisc
        self.router_queue = router_queue
        # per-host congestion-control override (<host tcpcc="...">);
        # None = the engine-wide --tcp-congestion-control choice
        self.tcp_cc = tcp_cc
        self.recv_buf_size = recv_buf_size
        self.send_buf_size = send_buf_size
        self.autotune_recv = autotune_recv
        self.autotune_send = autotune_send
        self.cpu_frequency_khz = cpu_frequency_khz
        self.cpu_threshold_ns = cpu_threshold_ns
        self.cpu_precision_ns = cpu_precision_ns
        self.interface_buffer = interface_buffer
        self.heartbeat_interval_sec = heartbeat_interval_sec
        self.log_pcap = log_pcap
        self.pcap_dir = pcap_dir
        self.ip_hint = ip_hint
        self.city_hint = city_hint
        self.country_hint = country_hint
        self.geocode_hint = geocode_hint
        self.type_hint = type_hint
        # per-host log filter (reference per-host loglevel attr)
        self.log_level = log_level
        self.heartbeat_log_level = heartbeat_log_level


class Host:
    # C data plane back-reference; an instance attribute when
    # parallel/native_plane.py attaches.  Class-level default so the hot
    # wake paths (process.py _schedule_continue/_dispatch) read it as a
    # plain attribute instead of paying getattr's missing-attr exception
    # per wake on python-plane runs.
    native_plane = None

    def __init__(self, host_id: int, params: HostParams, root_key: int):
        self.id = host_id
        self.name = params.name
        self.params = params
        self.random = RandomSource(root_key).spawn("host", host_id)
        self.cpu = CPU(params.cpu_frequency_khz, 0, params.cpu_threshold_ns,
                       params.cpu_precision_ns) if params.cpu_frequency_khz else None
        self.tracker = Tracker(self)
        self.interfaces: Dict[int, NetworkInterface] = {}
        self.default_address: Optional[Address] = None
        self.processes: List = []
        # descriptor table (host.c:492+): handle -> Descriptor
        self._descriptors: Dict[int, object] = {}
        self._next_handle = 1000  # leave room below for stdio-like handles
        self._next_port = MIN_EPHEMERAL_PORT
        # deterministic counters
        self._event_seq = 0
        self._packet_counter = 0
        self._packet_priority = 0
        self._process_id_counter = 1000
        self.engine = None  # set on registration
        # virtual clock mirror: the executing worker stamps the event time
        # here so host-side code (TCP, router) reads the clock with one
        # attribute access instead of a thread-local lookup
        self.now = 0
        # topology matrix row, cached by Engine.add_host at attach time
        self.topo_row: int = 0

    # -- setup (host_setup :162-220) --------------------------------------
    def setup(self, engine, eth_address: Address) -> None:
        self.engine = engine
        self.default_address = eth_address
        lo_addr = Address(self.id, LOCALHOST_IP, f"{self.name}-lo", is_local=True)
        pcap = None
        if self.params.log_pcap:
            from ..utils.pcap import PcapWriter
            pcap = PcapWriter.for_host(self.params.pcap_dir or engine.data_directory,
                                       self.name)
        lo = NetworkInterface(self, lo_addr, 0, 0, qdisc=self.params.qdisc,
                              pcap_writer=None)
        eth = NetworkInterface(self, eth_address, self.params.bw_down_kibps,
                               self.params.bw_up_kibps, qdisc=self.params.qdisc,
                               pcap_writer=pcap)
        eth.router = Router(make_queue(self.params.router_queue), eth)
        self.interfaces[LOCALHOST_IP] = lo
        self.interfaces[eth_address.ip] = eth

    def boot(self) -> None:
        """Per-host boot hook (host_boot :372-390).  Heartbeats are no
        longer scheduled here: ONE engine-level sweep event per distinct
        interval heartbeats every owned host in a single pass (ISSUE 10
        batched control plane; Engine._schedule_heartbeat_sweeps) — a
        10k-host run pays one event + one bulk C tracker snapshot per
        interval instead of 10k events with a C round-trip each."""

    # -- addressing --------------------------------------------------------
    @property
    def ip(self) -> int:
        return self.default_address.ip

    def interface_for_ip(self, ip: int) -> Optional[NetworkInterface]:
        iface = self.interfaces.get(ip)
        if iface is None and ip in (0, None):
            iface = self.interfaces.get(self.default_address.ip)
        return iface

    # -- deterministic counters -------------------------------------------
    def next_event_sequence(self) -> int:
        self._event_seq += 1
        return self._event_seq

    def next_packet_uid(self) -> int:
        """Globally unique, deterministic: (host_id << 40) | per-host count.
        Keys the order-independent packet drop draw."""
        self._packet_counter += 1
        return (self.id << 40) | self._packet_counter

    def next_packet_priority(self) -> int:
        self._packet_priority += 1
        return self._packet_priority

    def next_process_id(self) -> int:
        self._process_id_counter += 1
        return self._process_id_counter

    # -- descriptor table --------------------------------------------------
    def descriptor_table_add(self, desc) -> int:
        handle = self._next_handle
        self._next_handle += 1
        self._descriptors[handle] = desc
        return handle

    def descriptor_table_get(self, handle: int):
        return self._descriptors.get(handle)

    def descriptor_table_remove(self, handle: int) -> None:
        self._descriptors.pop(handle, None)

    def allocate_handle(self) -> int:
        h = self._next_handle
        self._next_handle += 1
        return h

    def register_descriptor(self, desc) -> None:
        """Single registration point for descriptors constructed with a
        pre-allocated handle (allocate_handle + constructor)."""
        self._descriptors[desc.handle] = desc

    # -- port management ---------------------------------------------------
    def allocate_ephemeral_port(self, protocol: str, iface_ip: int,
                                ifaces=None) -> int:
        """Deterministic ephemeral port scan (reference uses host random;
        we scan from a rotating cursor for speed and determinism).  Pass
        ``ifaces`` to require the port free on several interfaces at once
        (wildcard binds claim every interface)."""
        check = ifaces if ifaces is not None else [self.interface_for_ip(iface_ip)]
        for _ in range(MAX_PORT - MIN_EPHEMERAL_PORT + 1):
            port = self._next_port
            self._next_port += 1
            if self._next_port > MAX_PORT:
                self._next_port = MIN_EPHEMERAL_PORT
            if all(i is None or not i.is_associated(protocol, port)
                   for i in check):
                return port
        raise OSError("EADDRINUSE: ephemeral ports exhausted")

    def autobind_socket(self, sock, dst_ip: int) -> None:
        """Implicit bind on send/connect without bind() (socket.c behavior)."""
        src_ip = LOCALHOST_IP if dst_ip == LOCALHOST_IP else self.default_address.ip
        port = self.allocate_ephemeral_port(sock.kind, src_ip)
        sock.bind_to(src_ip, port)
        iface = self.interface_for_ip(src_ip)
        if iface is not None:
            iface.associate(sock, sock.kind, port)

    # -- process registry --------------------------------------------------
    def add_process(self, process) -> None:
        self.processes.append(process)

    def __repr__(self) -> str:  # pragma: no cover
        return f"Host({self.name}#{self.id})"
