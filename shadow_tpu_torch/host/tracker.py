"""Tracker: per-host metrics and heartbeat logging.

Capability of the reference's Tracker (host/tracker.c): processing/delay
time, per-interface packet/byte counters with local/remote and
data/control/retransmit splits (:25-49), socket buffer stats, allocation
tallies, and periodic heartbeat log lines.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict

from ..core.logger import get_logger
from ..routing.address import LOCALHOST_IP


def format_heartbeat_line(name: str, vals: Dict) -> str:
    """THE ``[shadow-heartbeat]`` line — one spelling shared by
    Tracker.heartbeat (live hosts) and HostTable.heartbeat_row (quiet
    table rows), so the two surfaces can never drift apart and
    tools/plot_log.py parses one shape."""
    return (f"[shadow-heartbeat] [{name}] "
            f"rx={vals['rx']} tx={vals['tx']} "
            f"rx_pkts={vals['rx_pkts']} tx_pkts={vals['tx_pkts']} "
            f"retrans={vals['retrans']} drops={vals['drops']} "
            f"proc_ms={vals['proc_ms']:.3f}")


class _Counters:
    __slots__ = ("packets_total", "bytes_total", "packets_control",
                 "bytes_control", "packets_data", "bytes_data",
                 "packets_retrans", "bytes_retrans")

    def __init__(self):
        self.packets_total = 0
        self.bytes_total = 0
        self.packets_control = 0
        self.bytes_control = 0
        self.packets_data = 0
        self.bytes_data = 0
        self.packets_retrans = 0
        self.bytes_retrans = 0

    def add(self, packet, retransmit: bool = False) -> None:
        n = packet.total_size
        self.packets_total += 1
        self.bytes_total += n
        if packet.payload_size == 0:
            self.packets_control += 1
            self.bytes_control += n
        else:
            self.packets_data += 1
            self.bytes_data += n
        if retransmit:
            self.packets_retrans += 1
            self.bytes_retrans += n

    def snapshot(self) -> Dict[str, int]:
        return {k: getattr(self, k) for k in self.__slots__}


class Tracker:
    def __init__(self, host):
        self.host = host
        self.processing_ns = 0
        self.delay_ns = 0
        self.delay_count = 0
        # split local (loopback) vs remote, in vs out
        self.in_local = _Counters()
        self.in_remote = _Counters()
        self.out_local = _Counters()
        self.out_remote = _Counters()
        self.drops = 0
        self.allocated_bytes = 0
        self.deallocated_bytes = 0
        self.socket_stats: Dict[int, Dict[str, int]] = defaultdict(dict)
        # authoritative external counter feeds, folded in lazily:
        # _native -> (NativePlane, hid): the C data plane's counters;
        # _device_feed -> (DeviceTrafficPlane, node indices): the device
        # plane's vectorized per-node byte deltas (pull_device)
        self._native = None
        self._device_feed = None

    def add_input_bytes(self, packet, iface_ip: int) -> None:
        c = self.in_local if iface_ip == LOCALHOST_IP else self.in_remote
        c.add(packet)

    def add_output_bytes(self, packet, iface_ip: int, retransmit: bool = False) -> None:
        c = self.out_local if iface_ip == LOCALHOST_IP else self.out_remote
        # TCP marks retransmissions on the packet (the reference's split
        # comes from packet delivery-status flags too, tracker.c:25-49)
        c.add(packet, retransmit or packet.retransmit)

    def add_drop(self, packet) -> None:
        self.drops += 1

    def add_processing_time(self, ns: int) -> None:
        self.processing_ns += ns

    def add_virtual_delay(self, ns: int) -> None:
        self.delay_ns += ns
        self.delay_count += 1

    def update_socket_stats(self, handle: int, rx_buf: int, rx_len: int,
                            tx_buf: int, tx_len: int) -> None:
        self.socket_stats[handle] = {"rx_buffer": rx_buf, "rx_length": rx_len,
                                     "tx_buffer": tx_buf, "tx_length": tx_len}

    def heartbeat_values(self) -> Dict:
        """The heartbeat payload, computed once: the legacy log line is
        formatted from THIS dict and the metrics registry records the same
        dict, so the two surfaces can never disagree (ISSUE 3 promotion —
        tools/plot_log.py keeps scraping the line against the same
        values)."""
        r_in, r_out = self.in_remote, self.out_remote
        return {"rx": r_in.bytes_total, "tx": r_out.bytes_total,
                "rx_pkts": r_in.packets_total,
                "tx_pkts": r_out.packets_total,
                "retrans": r_out.packets_retrans, "drops": self.drops,
                "proc_ms": round(self.processing_ns / 1e6, 3)}

    def pull_device(self) -> None:
        """Fold pending device-plane byte deltas into the counters (no-op
        unless this host contributes plane nodes): the device plane's
        collects accumulate per-node deltas in ONE numpy array, and the
        per-host split happens here, only when something actually reads
        the tracker (heartbeat, state digest, teardown)."""
        feed = self._device_feed
        if feed is not None:
            plane, nodes = feed
            plane.pull_tracker_nodes(self, nodes)

    def heartbeat(self, now: int) -> None:
        if self._native is not None:
            # native dataplane: the authoritative counters live in C
            plane, hid = self._native
            plane.sync_tracker(hid, self)
        self.pull_device()
        # the owning engine's registry when attached (robust against
        # another engine re-installing the global between construction and
        # shutdown, e.g. interleaved parity runs); the global otherwise
        registry = getattr(getattr(self.host, "engine", None),
                           "metrics", None)
        if registry is None:
            from ..obs.metrics import get_metrics
            registry = get_metrics()
        level = getattr(self.host.params, "heartbeat_log_level", None) \
            or "message"
        log = get_logger()
        emit = log.would_log(level)
        if not emit and not registry.enabled:
            return                  # 10k silent hosts pay only the pulls
        vals = self.heartbeat_values()
        registry.record_host_heartbeat(self.host.name, vals)
        if not emit:
            # the log line is filtered out: skip the format entirely —
            # the registry record above carries the same values
            return
        log.log(level, "tracker",
                format_heartbeat_line(self.host.name, vals),
                sim_time=now)
