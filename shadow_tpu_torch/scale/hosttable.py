"""HostTable: struct-of-arrays host state for internet-scale runs.

The eager boot path (core/controller.py) materializes one ``Host`` — plus
two interfaces, a router, a tracker, an RNG stream, and its ``Process``
objects — per ``quantity`` expansion.  At 100k hosts that is gigabytes of
Python objects and minutes of boot before the first round runs, even
though in a device-plane workload ~all of those hosts never execute a
single host-side event (ROADMAP item 2; the batch-scheduling playbook of
arxiv 2002.07062: device-resident work needs array rows, not objects).

The table replaces that with numpy columns (ids, ips, topology rows,
resolved bandwidths, token-bucket remainders, tracker byte/packet
counters, per-host RNG key lanes) plus ONE ``_HostGroup`` record per
config entry.  Everything a quiet host contributes to the simulation —
its DNS entry, its topology attachment, its digest state, its next boot
event time — is derived arithmetically from those columns:

* **names** are ``f"{group.id}{q+1}"`` computed on demand, never stored;
* **IPs** are a contiguous DNS block (``DNS.reserve_block``), so
  name<->ip resolution is arithmetic; an ``Address`` object is built
  lazily on first resolve;
* **RNG keys** are the vectorized ``derive(root, "host", id)`` family
  (``rng.derive_np``) — one threefry call for a whole group, bitwise
  identical to the scalar chain each eager ``Host`` performs;
* **wake times** (the earliest boot event a host would have scheduled:
  first process start/stop, heartbeat) feed the engine's window
  computation through ``Scheduler.next_event_time``, so round boundaries
  are identical to the eager run's.

A full ``Host`` is *materialized* only when the simulation first needs
it: the round-top promotion sweep (``promote_due``) materializes rows
whose wake time falls inside the new window and replays the exact boot
sequence the eager path ran at t=0 (same event times, same per-host
sequence numbers, same RNG counters), and ``Engine.host_by_ip/name``
materialize on lookup when another host's traffic reaches a quiet row.
Digest parity table-on vs table-off is therefore by construction —
tests/test_scale.py pins it on tor200 + star across serial/tpu/procs.

Device-plane integration: rows referenced by plane nodes register their
node indices here; the plane's per-node byte deltas fold into the
table's tracker columns at observation points (digest, teardown) exactly
as ``Tracker.pull_device`` folds them for materialized hosts.
"""

from __future__ import annotations

import heapq
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core import stime
from ..core.defs import (CONFIG_MTU, INTERFACE_CAPACITY_FACTOR,
                         INTERFACE_REFILL_INTERVAL_NS)
from ..core.logger import get_logger
from ..core.rng import derive_np
from ..routing.address import Address, ip_to_int

_MAX = stime.SIM_TIME_MAX


def bucket_capacity(rate_kibps: int) -> int:
    """A fresh TokenBucket's bytes_remaining for ``rate_kibps`` — the same
    arithmetic (and the same constants) as
    host.network_interface.TokenBucket.__init__, kept in sync by the
    table-vs-object digest parity gates."""
    time_factor = stime.SIM_TIME_SEC // INTERFACE_REFILL_INTERVAL_NS
    refill = (rate_kibps * 1024) // time_factor
    return refill * INTERFACE_CAPACITY_FACTOR + CONFIG_MTU


class _HostGroup:
    """One config entry (``HostConfig``) worth of table rows: everything
    that is identical across its quantity expansion lives here once."""

    __slots__ = ("hc", "params_kwargs", "first_row", "count", "first_id",
                 "ip_base", "per_row_ips", "process_specs", "wake",
                 "add_process", "heartbeat_sec", "n_boot_events")

    def __init__(self, hc, params_kwargs, first_row, count, first_id):
        self.hc = hc
        self.params_kwargs = params_kwargs
        self.first_row = first_row
        self.count = count
        self.first_id = first_id
        self.ip_base = 0            # block-reserved groups
        self.per_row_ips = None     # hint groups: explicit per-row ips
        self.process_specs = []     # (ProcessConfig, app_path, args)
        self.wake = _MAX
        self.add_process = None     # controller-provided (host, pc) adder
        self.heartbeat_sec = 0
        self.n_boot_events = 0      # boot events eager mode would schedule

    def name_of(self, q: int) -> str:
        return self.hc.id if self.hc.quantity == 1 else f"{self.hc.id}{q + 1}"

    def row_of_name(self, name: str) -> Optional[int]:
        hc = self.hc
        if hc.quantity == 1:
            return self.first_row if name == hc.id else None
        if not name.startswith(hc.id):
            return None
        suffix = name[len(hc.id):]
        if not suffix.isdigit():
            return None
        q = int(suffix) - 1
        if 0 <= q < self.count and suffix == str(q + 1):
            # the canonical spelling only: "client01" must NOT alias
            # client1 — eager boot would fail to resolve it, so the lazy
            # path must too
            return self.first_row + q
        return None


class HostTable:
    """The struct-of-arrays host plane.  Built by the Controller at setup
    (reserve_group per config entry, then freeze()), attached to the
    engine as ``engine.host_table``."""

    def __init__(self, engine, capacity: int):
        self.engine = engine
        self.capacity = capacity
        self.rows = 0
        self.groups: List[_HostGroup] = []
        self._lock = threading.RLock()
        # columns (int64 unless noted)
        self.ids = np.zeros(capacity, dtype=np.int64)
        self.ips = np.zeros(capacity, dtype=np.int64)
        self.topo_rows = np.zeros(capacity, dtype=np.int64)
        self.bw_down = np.zeros(capacity, dtype=np.int64)
        self.bw_up = np.zeros(capacity, dtype=np.int64)
        # iface token-bucket state (full buckets until first host-side use,
        # which requires materialization — kept as explicit columns so the
        # digest contract is visible, and so future vectorized planes can
        # spend from them directly)
        self.snd_remaining = np.zeros(capacity, dtype=np.int64)
        self.rcv_remaining = np.zeros(capacity, dtype=np.int64)
        # tracker counters (remote in/out; the device plane's per-node byte
        # deltas fold in here for table-resident hosts)
        self.rx_bytes = np.zeros(capacity, dtype=np.int64)
        self.rx_pkts = np.zeros(capacity, dtype=np.int64)
        self.tx_bytes = np.zeros(capacity, dtype=np.int64)
        self.tx_pkts = np.zeros(capacity, dtype=np.int64)
        # per-host RNG key lanes (derive(root, "host", id), vectorized)
        self.rng_keys = np.zeros(capacity, dtype=np.uint64)
        self.group_idx = np.zeros(capacity, dtype=np.int32)
        self.materialized = np.zeros(capacity, dtype=bool)
        self._grp_remaining: List[int] = []   # owned, unmaterialized rows
        self._wake_heap: List[Tuple[int, int]] = []
        # device-plane node registration: row -> node index list
        self._dev_nodes: Dict[int, List[int]] = {}
        self._dev_plane = None
        # flows (processless device-plane transfers): raw per-row tuples
        # (row, route_down, route_up, down_bytes, up_bytes, start_ns)
        self.flows: List[tuple] = []
        self.materialized_count = 0
        self._closed_counters = False

    # -- construction (Controller.setup) ----------------------------------
    def reserve_group(self, hc, params_kwargs: dict, add_process) -> None:
        """Register one config entry's rows: ids, DNS, topology placement,
        resolved bandwidths, RNG keys, wake time.  No Host objects."""
        engine = self.engine
        n = hc.quantity
        first_row = self.rows
        first_id = engine.next_host_id()
        for _ in range(n - 1):
            engine.next_host_id()
        grp = _HostGroup(hc, params_kwargs, first_row, n, first_id)
        grp.add_process = add_process
        # name-domain collision guard: eager boot would raise at
        # dns.register on a duplicate name; block-reserved groups resolve
        # names lazily, so prefix-related groups (id "client" x20 vs a
        # separate "client12") must be rejected here instead.  Only
        # prefix-related pairs can collide, and those are rare enough to
        # scan the smaller group's name domain outright.
        for other in self.groups:
            a, b = grp, other
            if not (a.hc.id.startswith(b.hc.id)
                    or b.hc.id.startswith(a.hc.id)):
                continue
            small = a if a.count <= b.count else b
            big = b if small is a else a
            for q in range(small.count):
                if big.row_of_name(small.name_of(q)) is not None:
                    raise ValueError(
                        f"hostname {small.name_of(q)!r} is claimed by both "
                        f"host groups {a.hc.id!r} and {b.hc.id!r}")
        gidx = len(self.groups)
        self.groups.append(grp)
        sl = slice(first_row, first_row + n)
        ids = np.arange(first_id, first_id + n, dtype=np.int64)
        self.ids[sl] = ids
        self.group_idx[sl] = gidx
        # RNG key lanes: one vectorized threefry call for the whole group
        self.rng_keys[sl] = derive_np(engine.root_key, "host", ids)
        # DNS: a contiguous block when one is cleanly available at the
        # counter (arithmetic name<->ip, lazy Addresses); per-row
        # registration otherwise — for ip-hint groups, and whenever the
        # candidate block would collide with a registered IP or a
        # restricted range (unique_ip skips only the colliding addresses,
        # so the assignment must too, or table-on/off IPs diverge)
        block = None if hc.ip_hint else engine.dns.try_reserve_block(n)
        if block is None:
            grp.per_row_ips = np.zeros(n, dtype=np.int64)
            req = ip_to_int(hc.ip_hint) if hc.ip_hint else None
            for q in range(n):
                addr = engine.dns.register(first_id + q, grp.name_of(q), req)
                grp.per_row_ips[q] = addr.ip
            self.ips[sl] = grp.per_row_ips
        else:
            grp.ip_base = block
            self.ips[sl] = np.arange(block, block + n, dtype=np.int64)
        # topology attachment: one call per row (memoized candidate lists
        # make it cheap), consuming each host stream's draw #0 exactly as
        # Host.setup would — the vectorized first-draw family
        from ..core.rng import bits64_keys_np
        draws = bits64_keys_np(self.rng_keys[sl], 0)
        topo = engine.topology
        bw_cache: Dict[int, Tuple[int, int]] = {}
        for q in range(n):
            row = first_row + q
            ip = int(self.ips[row])
            vidx = topo.attach_host(
                ip, ip_hint=hc.ip_hint, city_hint=hc.city_hint,
                country_hint=hc.country_hint, geocode_hint=hc.geocode_hint,
                type_hint=hc.type_hint, choice_rand=int(draws[q]))
            down, up = hc.bandwidth_down_kibps, hc.bandwidth_up_kibps
            if down <= 0 or up <= 0:
                vbw = bw_cache.get(vidx)
                if vbw is None:
                    vbw = bw_cache[vidx] = topo.vertex_bandwidth_kibps(vidx)
                if down <= 0:
                    down = vbw[0] or 102400
                if up <= 0:
                    up = vbw[1] or 102400
            self.bw_down[row] = down
            self.bw_up[row] = up
            self.topo_rows[row] = topo.row_for_ip(ip)
        self.snd_remaining[sl] = [bucket_capacity(int(b))
                                  for b in self.bw_up[sl]]
        self.rcv_remaining[sl] = [bucket_capacity(int(b))
                                  for b in self.bw_down[sl]]
        self.rows += n
        # wake: the earliest boot event the eager path would schedule
        # (events at or past end_time are dropped by schedule_task and
        # never pend, so they are excluded here too)
        cands = []
        # heartbeats are NOT boot candidates: the eager path no longer
        # schedules a per-host heartbeat event either — one engine-level
        # sweep per interval covers rows and Hosts alike (ISSUE 10), so a
        # quiet row is never materialized just to report its counters
        grp.heartbeat_sec = params_kwargs.get("heartbeat_interval_sec", 0)
        for pc in hc.processes:
            cands.append(stime.from_seconds(pc.start_time_sec))
            if pc.stop_time_sec:
                cands.append(stime.from_seconds(pc.stop_time_sec))
        cands = [c for c in cands if c < engine.end_time]
        grp.wake = min(cands) if cands else _MAX
        grp.n_boot_events = len(cands)
        owned = self._owned_count(grp)
        self._grp_remaining.append(owned)
        if grp.wake < _MAX and owned:
            heapq.heappush(self._wake_heap, (grp.wake, gidx))
        # flows: expanded to per-row route tuples (scale/genscen.py owns
        # the tor-shape path derivation)
        if hc.flows:
            from .genscen import expand_flows
            self.flows.extend(expand_flows(self, grp))

    def add_group_process_spec(self, grp: _HostGroup, pc, app_path: str,
                               args: List[str]) -> None:
        grp.process_specs.append((pc, app_path, args))

    def freeze(self) -> None:
        """End of reservation: install the lazy DNS resolver and log."""
        self.engine.dns.lazy_resolver = self._lazy_resolve
        get_logger().message(
            "scale",
            f"host table: {self.rows} rows in {len(self.groups)} groups, "
            f"{self.nbytes() // 1024} KiB of columns, "
            f"{len(self.flows)} device flows")

    def nbytes(self) -> int:
        """Total column bytes (the exact part of the bytes-per-host
        budget; scale/memprof.py adds the RSS view)."""
        cols = (self.ids, self.ips, self.topo_rows, self.bw_down, self.bw_up,
                self.snd_remaining, self.rcv_remaining, self.rx_bytes,
                self.rx_pkts, self.tx_bytes, self.tx_pkts, self.rng_keys,
                self.group_idx, self.materialized)
        return int(sum(c.nbytes for c in cols))

    # -- ownership / lookup ------------------------------------------------
    def _owns_id(self, hid: int) -> bool:
        eng = self.engine
        return eng.shard_count == 1 \
            or (hid - 1) % eng.shard_count == eng.shard_id

    def _owned_count(self, grp: _HostGroup) -> int:
        if self.engine.shard_count == 1:
            return grp.count
        return sum(1 for q in range(grp.count)
                   if self._owns_id(grp.first_id + q))

    def row_of_name(self, name: str) -> Optional[int]:
        for grp in self.groups:
            row = grp.row_of_name(name)
            if row is not None:
                return row
        return None

    def row_of_ip(self, ip: int) -> Optional[int]:
        for grp in self.groups:
            if grp.per_row_ips is not None:
                hits = np.flatnonzero(grp.per_row_ips == ip)
                if len(hits):
                    return grp.first_row + int(hits[0])
            elif grp.ip_base <= ip < grp.ip_base + grp.count:
                return grp.first_row + (ip - grp.ip_base)
        return None

    def row_of_id(self, hid: int) -> Optional[int]:
        for grp in self.groups:
            if grp.first_id <= hid < grp.first_id + grp.count:
                return grp.first_row + (hid - grp.first_id)
        return None

    def name_of(self, row: int) -> str:
        grp = self.groups[self.group_idx[row]]
        return grp.name_of(row - grp.first_row)

    def _lazy_resolve(self, name: Optional[str] = None,
                      ip: Optional[int] = None) -> Optional[Address]:
        """DNS fallback: build (and register) the Address for a table row
        on first resolution — quiet hosts that nobody ever names pay no
        Address object at all."""
        row = self.row_of_name(name) if name is not None else \
            self.row_of_ip(ip)
        if row is None:
            return None
        addr = Address(int(self.ids[row]), int(self.ips[row]),
                       self.name_of(row))
        self.engine.dns.adopt(addr)
        return addr

    def unmaterialized_count(self) -> int:
        return self.rows - self.materialized_count

    # -- window integration ------------------------------------------------
    def next_wake(self) -> int:
        """Earliest boot-event time over owned, unmaterialized rows —
        folded into Scheduler.next_event_time so windows land on the same
        boundaries as the eager run's."""
        heap = self._wake_heap
        while heap and self._grp_remaining[heap[0][1]] <= 0:
            heapq.heappop(heap)
        return heap[0][0] if heap else _MAX

    def pending_boot_events(self) -> int:
        """Deferred boot events for owned, unmaterialized rows — the
        events an eager boot would already have sitting in the queues
        (none executed: an unmaterialized row's wake is still in the
        future).  Folded into Scheduler.pending_count so MID-RUN state
        digests (checkpoints) carry the same pending_events either way."""
        return sum(self.groups[g].n_boot_events * rem
                   for g, rem in enumerate(self._grp_remaining) if rem > 0)

    def heartbeat_intervals(self) -> set:
        """Distinct nonzero heartbeat intervals across groups with owned
        rows — the engine's sweep scheduler unions these with the live
        hosts' intervals.  Groups fully owned by other shards contribute
        nothing (their owners sweep them)."""
        return {g.heartbeat_sec for g in self.groups
                if g.heartbeat_sec > 0 and self._owned_count(g) > 0}

    def heartbeat_rows(self, interval_sec: int):
        """The sweep tick's table leg, part 1: every owned UNMATERIALIZED
        row on this interval as sorted ``(host_id, row, level, emit)``
        tuples — the engine merges them with the live hosts by id so the
        heartbeat log keeps GLOBAL host-id order.  No Host is ever
        materialized to heartbeat (the eager path's per-host events used
        to force exactly that).  Same emit gating as Tracker.heartbeat:
        with the log level filtered and the registry off, 100k quiet rows
        cost one group scan."""
        from ..core.logger import get_logger
        from ..obs.metrics import get_metrics
        registry = getattr(self.engine, "metrics", None) or get_metrics()
        log = get_logger()
        out = []
        for grp in self.groups:
            if grp.heartbeat_sec != interval_sec:
                continue
            level = grp.params_kwargs.get("heartbeat_log_level") \
                or "message"
            emit = log.would_log(level)
            if not emit and not registry.enabled:
                continue
            for q in range(grp.count):
                row = grp.first_row + q
                hid = grp.first_id + q
                if not self.materialized[row] and self._owns_id(hid):
                    out.append((hid, row, level, emit))
        out.sort()
        return out

    def heartbeat_row(self, entry, now: int) -> None:
        """Part 2: report ONE quiet row from columns — registry record +
        the SAME legacy line Tracker.heartbeat emits (one shared
        formatter, so the two surfaces cannot drift)."""
        from ..core.logger import get_logger
        from ..host.tracker import format_heartbeat_line
        from ..obs.metrics import get_metrics
        hid, row, level, emit = entry
        self._fold_device_row(row)
        name = self.name_of(row)
        vals = {"rx": int(self.rx_bytes[row]),
                "tx": int(self.tx_bytes[row]),
                "rx_pkts": int(self.rx_pkts[row]),
                "tx_pkts": int(self.tx_pkts[row]),
                "retrans": 0, "drops": 0, "proc_ms": 0.0}
        registry = getattr(self.engine, "metrics", None) or get_metrics()
        registry.record_host_heartbeat(name, vals)
        if emit:
            get_logger().log(level, "tracker",
                             format_heartbeat_line(name, vals),
                             sim_time=now)

    def promote_due(self, window_end: int) -> None:
        """Round-top promotion sweep: materialize + boot every owned row
        whose first boot event falls inside the new window.  Runs on the
        engine main thread between rounds (workers parked)."""
        heap = self._wake_heap
        while heap:
            wake, gidx = heap[0]
            if self._grp_remaining[gidx] <= 0:
                heapq.heappop(heap)
                continue
            if wake >= window_end:
                return
            heapq.heappop(heap)
            grp = self.groups[gidx]
            for q in range(grp.count):
                row = grp.first_row + q
                if not self.materialized[row] \
                        and self._owns_id(grp.first_id + q):
                    self.materialize_row(row)

    # -- materialization ---------------------------------------------------
    def materialize_row(self, row: int):
        """Promote one table row to a full Host, replaying exactly what
        the eager path did at setup + boot: same HostParams, same derived
        RNG stream (counter advanced past the topology-attach draw), same
        process construction order, and — for owned rows after boot — the
        same boot events at their original times (a transient worker clock
        of 0 reproduces schedule_task's ``t = now + delay`` arithmetic)."""
        with self._lock:
            if self.materialized[row]:
                return self.engine.hosts.get(int(self.ids[row]))
            from ..host.host import Host, HostParams
            engine = self.engine
            grp = self.groups[self.group_idx[row]]
            q = row - grp.first_row
            hid = int(self.ids[row])
            params = HostParams(name=grp.name_of(q),
                                bw_down_kibps=int(self.bw_down[row]),
                                bw_up_kibps=int(self.bw_up[row]),
                                **grp.params_kwargs)
            host = Host(hid, params, engine.root_key)
            # the topology-attach draw was consumed (vectorized) at reserve
            host.random.counter = 1
            addr = engine.dns.resolve_name(params.name)
            host.topo_row = int(self.topo_rows[row])
            engine.adopt_host(host, addr, owned=self._owns_id(hid))
            # tracker seed: bytes the device plane already folded into the
            # table's columns while the host was a row
            t = host.tracker
            for ctr, nbytes, npkts in (
                    (t.in_remote, int(self.rx_bytes[row]),
                     int(self.rx_pkts[row])),
                    (t.out_remote, int(self.tx_bytes[row]),
                     int(self.tx_pkts[row]))):
                if nbytes or npkts:
                    ctr.bytes_total += nbytes
                    ctr.bytes_data += nbytes
                    ctr.packets_total += npkts
                    ctr.packets_data += npkts
            nodes = self._dev_nodes.get(row)
            if nodes is not None and self._dev_plane is not None:
                t._device_feed = (self._dev_plane, nodes)
            for pc, _path, _args in grp.process_specs:
                grp.add_process(host, pc)
            self.materialized[row] = True
            self.materialized_count += 1
            if self._owns_id(hid):
                self._grp_remaining[self.group_idx[row]] -= 1
                if getattr(engine, "_boot_done", False):
                    self._replay_boot(host)
            return host

    def _replay_boot(self, host) -> None:
        from ..core.worker import Worker, current_worker, set_current_worker
        w = current_worker()
        transient = w is None
        if transient:
            w = Worker(0, self.engine)
            set_current_worker(w)
        saved = (w.now, w.active_host)
        w.now = 0
        w.active_host = host
        try:
            host.boot()
            for proc in host.processes:
                proc.schedule_start(w)
        finally:
            w.now, w.active_host = saved
            if transient:
                set_current_worker(None)
                w.finish()

    def materialize_by_ip(self, ip: int):
        row = self.row_of_ip(ip)
        return self.materialize_row(row) if row is not None else None

    def materialize_by_id(self, hid: int):
        row = self.row_of_id(hid)
        return self.materialize_row(row) if row is not None else None

    def materialize_by_name(self, name: str):
        row = self.row_of_name(name)
        return self.materialize_row(row) if row is not None else None

    def materialize_all(self) -> None:
        for row in range(self.rows):
            if not self.materialized[row]:
                self.materialize_row(row)

    # -- device-plane integration -----------------------------------------
    def plane_host_info(self, name: str) -> Optional[Tuple[int, int, int]]:
        """(topo_row, bw_up, bw_down) for the device plane's node layout —
        reads columns, never materializes."""
        row = self.row_of_name(name)
        if row is None:
            return None
        return (int(self.topo_rows[row]), int(self.bw_up[row]),
                int(self.bw_down[row]))

    def set_device_nodes(self, name: str, nodes: List[int], plane) -> bool:
        """Register a table row's plane node indices.  Returns False when
        ``name`` is not a table row (caller wires the Host directly)."""
        row = self.row_of_name(name)
        if row is None:
            return False
        self._dev_nodes[row] = nodes
        self._dev_plane = plane
        return True

    def set_device_rows(self, rows, nodes: List[List[int]], plane) -> None:
        """Register the plane node indices of many table rows at once:
        ``nodes[k]`` is row ``rows[k]``'s list (the device plane's layout
        resolves names to rows itself)."""
        self._dev_nodes.update(zip(np.asarray(rows).tolist(), nodes))
        self._dev_plane = plane

    def _fold_device_row(self, row: int) -> None:
        """The table-side twin of Tracker.pull_device: fold the plane's
        pending per-node byte deltas into this row's tracker columns."""
        plane = self._dev_plane
        nodes = self._dev_nodes.get(row)
        if plane is None or nodes is None or self.materialized[row]:
            return
        for i in nodes:
            ncells, nbytes = plane.take_node_delta(i)
            if not nbytes:
                continue
            if plane.node_kind[i] == "tx":
                self.tx_bytes[row] += nbytes
                self.tx_pkts[row] += ncells
            else:
                self.rx_bytes[row] += nbytes
                self.rx_pkts[row] += ncells

    def flush_device_nodes(self, plane) -> None:
        """Teardown/observation sweep over every row that contributes
        plane nodes (materialized rows pull through their Tracker)."""
        for row in sorted(self._dev_nodes):
            if self.materialized[row]:
                host = self.engine.hosts.get(int(self.ids[row]))
                if host is not None:
                    host.tracker.pull_device()
            else:
                self._fold_device_row(row)

    # -- process/flow spec iteration (device-plane build) ------------------
    def iter_process_specs(self):
        """(host_id, host_name, app_path, args) for every deferred process,
        in host-id order — what build_plane_from_engine scans in place of
        ``host.processes`` for table rows."""
        for grp in self.groups:
            if not grp.process_specs:
                continue
            for q in range(grp.count):
                if self.materialized[grp.first_row + q]:
                    continue        # scanned via the live Host instead
                name = grp.name_of(q)
                for _pc, app_path, args in grp.process_specs:
                    yield grp.first_id + q, name, app_path, args

    # -- digest state ------------------------------------------------------
    def host_state(self, row: int) -> Dict:
        """The ``checkpoint._host_state`` dict a quiet eager Host would
        produce, synthesized from columns (plain ints — the digest is
        canonical JSON and numpy scalars must not leak into it)."""
        from ..routing.address import LOCALHOST_IP
        self._fold_device_row(row)
        grp = self.groups[self.group_idx[row]]
        q = row - grp.first_row
        name = grp.name_of(q)
        lo_cap = bucket_capacity(0)
        return {
            "name": name,
            "descriptors": {},
            "tracker": (int(self.rx_bytes[row]), int(self.tx_bytes[row]),
                        int(self.rx_pkts[row]), int(self.tx_pkts[row]),
                        0, 0),
            "processes": [(f"{name}.{pc.plugin}", False, False, None)
                          for pc, _path, _args in grp.process_specs],
            "ifaces": {LOCALHOST_IP: (lo_cap, lo_cap),
                       int(self.ips[row]): (int(self.snd_remaining[row]),
                                            int(self.rcv_remaining[row]))},
        }

    def host_states(self) -> Dict[int, Dict]:
        """Digest states for every owned, unmaterialized row (materialized
        hosts are collected through engine.hosts as usual)."""
        out: Dict[int, Dict] = {}
        for grp in self.groups:
            for q in range(grp.count):
                row = grp.first_row + q
                hid = grp.first_id + q
                if not self.materialized[row] and self._owns_id(hid):
                    out[hid] = self.host_state(row)
        return out

    # -- teardown ----------------------------------------------------------
    def close_counters(self) -> None:
        """Balance the host ObjectCounter ledger for rows that never
        materialized (eager mode counts new at setup + free at teardown;
        table rows do both here, in bulk, so totals and the leak report
        match)."""
        if self._closed_counters:
            return
        self._closed_counters = True
        n = sum(1 for grp in self.groups
                for q in range(grp.count)
                if not self.materialized[grp.first_row + q]
                and self._owns_id(grp.first_id + q))
        if n:
            self.engine.counters.count_new("host", n)
            self.engine.counters.count_free("host", n)

    def stats(self) -> Dict[str, int]:
        return {
            "scale.table_rows": self.rows,
            "scale.materialized_hosts": self.materialized_count,
            "scale.table_bytes": self.nbytes(),
            "scale.device_flows": len(self.flows),
        }
