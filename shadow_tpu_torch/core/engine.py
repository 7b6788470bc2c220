"""Engine: the per-machine simulation engine (reference Slave, core/slave.c).

Owns the Scheduler, host registry, DNS, program registry, data directories,
object counters, and the round loop (slave_run :413, round loop :437-462):

    while events remain:
        window = [min_next_event_time, +lookahead)
        workers drain their queues up to the window end     (parallel)
        flush logger, heartbeat                              (main thread)
        compute next window from global min next event time

Multi-worker execution uses Python threads with two CountDownLatch barriers
per round (the reference uses five; ours fold the start/prepare pairs).
"""

from __future__ import annotations

import os
import resource
import threading
import time as _walltime
from typing import Dict, List, Optional

from ..routing.dns import DNS
from ..utils.count_down_latch import CountDownLatch
from . import stime
from .counters import ObjectCounter
from .logger import get_logger
from .rng import RandomSource, derive, uniform_np
from .scheduler import Scheduler
from .task import Task
from .worker import Worker, current_worker, set_current_worker


def _tracker_sweep_task(args, _unused) -> None:
    """The per-interval heartbeat tick: RECORD the due sweep and reschedule.
    The tracker work itself runs at the round boundary (_flush_round, main
    thread, workers parked) — an in-event sweep over ALL hosts would race
    the other workers' event execution on those hosts' trackers, which the
    retired per-host heartbeat events never did (they ran under each
    host's own execution serialization)."""
    engine, interval_sec = args
    w = current_worker()
    engine._pending_sweeps.append((interval_sec,
                                   w.now if w is not None else 0))
    if w is not None:
        w.schedule_task(Task(_tracker_sweep_task, (engine, interval_sec),
                             None, name="heartbeat"),
                        interval_sec * stime.SIM_TIME_SEC, dst_host=None)

DEFAULT_LOOKAHEAD_NS = 10 * stime.SIM_TIME_MS  # master.c:133-146 default jump


class Engine:
    def __init__(self, options, topology, seed_key: Optional[int] = None):
        self.options = options
        self.topology = topology
        # observability plane (shadow_tpu/obs/): installed module-global
        # like the logger, FIRST, so everything built below (scheduler,
        # native plane, device plane, plugins) binds the run's tracer
        from ..obs import configure_observability
        self.tracer, self.metrics, self._metrics_writer = \
            configure_observability(options)
        self.root_key = seed_key if seed_key is not None else derive(options.seed, "root")
        self.dns = DNS()
        self.random = RandomSource(derive(self.root_key, "engine"))
        self.hosts: Dict[int, object] = {}          # id -> Host
        self.hosts_by_ip: Dict[int, object] = {}
        self.hosts_by_name: Dict[str, object] = {}
        self.end_time = options.stop_time_sec * stime.SIM_TIME_SEC
        self.bootstrap_end = options.bootstrap_end_sec * stime.SIM_TIME_SEC
        self.counters = ObjectCounter()
        self._counters_lock = threading.Lock()
        self.plugin_errors = 0
        self.data_directory = options.data_directory
        # --data-template: seed the data directory from a template tree
        # (reference slave.c:201-218 copies dataDirTemplatePath)
        template = getattr(options, "data_template", None)
        if template:
            if not os.path.isdir(template):
                raise FileNotFoundError(
                    f"--data-template {template!r} is not a directory")
            if os.path.exists(self.data_directory):
                get_logger().warning(
                    "engine",
                    f"--data-template ignored: data directory "
                    f"{self.data_directory!r} already exists (delete it to "
                    "re-seed from the template)")
            else:
                import shutil
                shutil.copytree(template, self.data_directory)
        self.scheduler = Scheduler(self, options.scheduler_policy,
                                   options.workers, derive(self.root_key, "sched"))
        self._drop_key = derive(self.root_key, "packet_drop")
        # Process-parallel sharding (parallel/procs.py): this engine OWNS
        # hosts with (id-1) % shard_count == shard_id and executes only their
        # events; packets bound for other shards are appended to per-shard
        # outboxes drained at the round barrier.  shard_count == 1 (the
        # default) means everything below is inert.
        self.shard_id = int(getattr(options, "shard_id", 0) or 0)
        self.shard_count = max(1, int(getattr(options, "shard_count", 1) or 1))
        self.shard_outboxes: List[list] = [[] for _ in range(self.shard_count)]
        self._global_seq = 0
        self._running = True
        self._host_id_counter = 0
        self.sim_start_wall: float = 0.0
        self.rounds_executed = 0
        self.events_executed = 0
        # per-round perf introspection (reference logs per-thread barrier
        # waits + Dijkstra timings, scheduler.c:266-268 / topology.c:1785-88;
        # ours splits each round into host-execute vs flush/device wall time)
        self.host_exec_ns = 0
        self.flush_ns = 0
        # compacted-flush dirty tracking (ISSUE 10): rounds whose whole
        # flush phase (policy flush + checkpoint + logger) did no work,
        # and what those quiet rounds still cost — the bench-smoke gate
        # pins the per-quiet-round cost ~zero
        self.flush_quiet_skips = 0
        self.flush_quiet_ns = 0
        # heartbeat sweeps due this round: (interval_sec, tick sim time),
        # recorded by the tick event (worker 0) and drained at the round
        # boundary by _flush_round on the main thread — the round latch
        # orders the append before the drain
        self._pending_sweeps: List = []
        # wall ns spent resuming plugin code (green-thread continues +
        # native RPC serving), accumulated under _counters_lock from
        # process/process.py — subtracted from host_exec for the
        # plugin-vs-control-plane split the perf hunt steers by
        self.plugin_exec_ns = 0
        self._last_heartbeat_wall = 0.0
        self.heartbeat_wall_interval = 5.0
        # adaptive heartbeat gate: between wall reads the per-round cost is
        # one integer decrement (the monotonic() syscall per round was
        # measurable at tor10k round rates)
        self._hb_countdown = 0
        self._hb_stride = 1
        self._hb_last_check = 0.0
        # superwindow negotiation (ISSUE 7): how many consecutive lookahead
        # rounds one device-plane launch may merge when no host-side event
        # falls inside them; 1 disables
        self._superwindow = max(
            1, int(getattr(options, "superwindow_rounds", 8) or 1))
        # device-resident traffic plane (parallel/device_plane.py); set by
        # the Controller when the workload has device-mode flows
        self.device_plane = None
        # C data plane (parallel/native_plane.py); set by attach() when the
        # run is eligible — protocol/interface/hop events then execute in C
        self.native_plane = None
        # struct-of-arrays host plane (scale/hosttable.py); set by the
        # Controller when hosts boot as table rows — quiet hosts then cost
        # array columns, and Host objects materialize lazily on their
        # first boot event or incoming lookup
        self.host_table = None
        self._boot_done = False
        # supervision ledger: watchdog fires, degradations, resume state
        # (core/supervision.py) — every fault seam reports here
        from .supervision import SupervisionStats
        self.supervision = SupervisionStats()
        self._checkpointer = None
        if getattr(options, "checkpoint_interval_sec", 0) > 0 \
                or getattr(options, "checkpoint_every_rounds", 0) > 0:
            from .checkpoint import CheckpointWriter
            self._checkpointer = CheckpointWriter(
                options.checkpoint_interval_sec, options.checkpoint_dir,
                getattr(options, "checkpoint_every_rounds", 0))
        # --resume: deterministic replay to the snapshot's virtual time,
        # digest-verified there (_verify_resume), then the run continues —
        # recovery leans on the determinism kernel, so restart-after-crash
        # is exact rather than approximate
        self._resume_snapshot = None
        resume = getattr(options, "resume_path", None)
        if resume:
            from .checkpoint import find_last_good_snapshot
            snap, resolved = find_last_good_snapshot(resume)
            self._resume_snapshot = snap
            self.supervision.resume_path = resolved
            get_logger().message(
                "engine",
                f"resuming from {resolved} "
                f"(t={snap['sim_time_ns'] / 1e9:.3f}s, "
                f"rounds={snap['rounds']}): replaying to the snapshot "
                "boundary, digest-verified there")
        # metrics sources: the engine's phase split, the policy/kernel and
        # plane introspection, and the supervision ledger all scrape from
        # ONE registry — bench.py reads flush_sec / device_wait_sec /
        # pipeline_overlap_sec here instead of re-deriving them with
        # ad-hoc timers per run
        self.metrics.source("engine", self._scrape_metrics)
        self.metrics.source(
            "supervision",
            lambda: {f"supervision.{k}": v
                     for k, v in self.supervision.summary().items()})
        self.metrics.gauge(
            "engine.wall_uptime_sec",
            lambda: round(_walltime.monotonic() - self.sim_start_wall, 3))
        self._checkpoint_counter = self.metrics.counter(
            "engine.checkpoints_written")

    # -- registry ----------------------------------------------------------
    def add_host(self, host, requested_ip: Optional[int] = None) -> None:
        """Register + set up a host (slave_addNewVirtualHost :296)."""
        addr = self.dns.register(host.id, host.name, requested_ip)
        if not self.owns_host(host):
            # replica on another shard's engine: opening its pcap file here
            # would truncate the owner's capture (N processes, same path)
            host.params.log_pcap = False
        host.setup(self, addr)
        vidx = self.topology.attach_host(
            addr.ip, ip_hint=host.params.ip_hint, city_hint=host.params.city_hint,
            country_hint=host.params.country_hint,
            geocode_hint=host.params.geocode_hint, type_hint=host.params.type_hint,
            choice_rand=host.random.next_u64())
        # fill in bandwidths from the topology vertex if unset (master.c:336-377)
        if host.params.bw_down_kibps <= 0 or host.params.bw_up_kibps <= 0:
            down, up = self.topology.vertex_bandwidth_kibps(vidx)
            if host.params.bw_down_kibps <= 0:
                host.params.bw_down_kibps = down or 102400
            if host.params.bw_up_kibps <= 0:
                host.params.bw_up_kibps = up or 102400
            # rebuild the eth token buckets with resolved rates
            eth = host.interfaces[addr.ip]
            from ..host.network_interface import TokenBucket
            eth.send_bucket = TokenBucket(host.params.bw_up_kibps)
            eth.receive_bucket = TokenBucket(host.params.bw_down_kibps)
        # cache the topology matrix row so the hot path never does the
        # ip->row dict lookup per packet (rows are fixed at attach time)
        host.topo_row = self.topology.row_for_ip(addr.ip)
        self.hosts[host.id] = host
        self.hosts_by_ip[addr.ip] = host
        self.hosts_by_name[host.name] = host
        self.scheduler.add_host(host)
        if self.owns_host(host):
            self.counters.count_new("host")

    def adopt_host(self, host, addr, owned: bool = True) -> None:
        """Register a host whose DNS entry and topology attachment already
        happened at table-reserve time (scale/hosttable.py materialize):
        the add_host tail without re-registering or re-attaching.  The
        caller provides params with RESOLVED bandwidths, so no bucket
        rebuild is needed either."""
        if not owned:
            host.params.log_pcap = False    # replica: owner holds the pcap
        host.setup(self, addr)
        self.hosts[host.id] = host
        self.hosts_by_ip[addr.ip] = host
        self.hosts_by_name[host.name] = host
        self.scheduler.add_host(host)
        if owned:
            with self._counters_lock:
                self.counters.count_new("host")

    def next_host_id(self) -> int:
        self._host_id_counter += 1
        return self._host_id_counter

    def total_host_count(self) -> int:
        """Materialized hosts + still-quiet table rows."""
        n = len(self.hosts)
        if self.host_table is not None:
            n += self.host_table.unmaterialized_count()
        return n

    def host_by_ip(self, ip: int):
        h = self.hosts_by_ip.get(ip)
        if h is None and self.host_table is not None:
            # a packet (or policy delivery) reached a quiet table row:
            # materialize it so routers/RST paths behave exactly as the
            # eager host would
            h = self.host_table.materialize_by_ip(ip)
        return h

    def shard_of(self, host) -> int:
        """The single definition of the host partition (round-robin by id);
        owns_host and every outbox index derive from it."""
        return (host.id - 1) % self.shard_count

    def owns_host(self, host) -> bool:
        """True iff this engine executes ``host``'s events (every host in a
        single-process run; the shard's partition under --processes N)."""
        return self.shard_count == 1 or self.shard_of(host) == self.shard_id

    def drain_outboxes(self) -> List[list]:
        out = self.shard_outboxes
        self.shard_outboxes = [[] for _ in range(self.shard_count)]
        return out

    def host_by_name(self, name: str):
        h = self.hosts_by_name.get(name)
        if h is None and self.host_table is not None:
            h = self.host_table.materialize_by_name(name)
        return h

    def host_by_id(self, hid: int):
        h = self.hosts.get(hid)
        if h is None and self.host_table is not None:
            h = self.host_table.materialize_by_id(hid)
        return h

    def iter_process_specs(self):
        """(host_id, host_name, app_path, args) over every configured
        process — live Host objects and deferred table rows alike, in
        host-id order.  The device plane's spec scan uses this so table-on
        and table-off builds see identical workloads."""
        specs = []
        for hid in sorted(self.hosts):
            host = self.hosts[hid]
            for proc in host.processes:
                specs.append((hid, host.name,
                              str(getattr(proc, "app_path", "")), proc.args))
        if self.host_table is not None:
            specs.extend(self.host_table.iter_process_specs())
        specs.sort(key=lambda s: s[0])
        return specs

    def host_stream_key(self, name: str) -> Optional[int]:
        """The per-host deterministic RNG stream key (what Host.random is
        seeded with), WITHOUT materializing a table row — derivation is
        arithmetic on (root_key, host id)."""
        h = self.hosts_by_name.get(name)
        if h is not None:
            return h.random.key
        if self.host_table is not None:
            row = self.host_table.row_of_name(name)
            if row is not None:
                return int(self.host_table.rng_keys[row])
        return None

    # -- deterministic draws ----------------------------------------------
    def packet_drop_uniform(self, packet_uid: int) -> float:
        """Order-independent drop draw keyed by packet uid (shared with the
        TPU kernel; see ops/round_step.py)."""
        import numpy as np
        return float(uniform_np(self._drop_key, np.uint64(packet_uid)))

    def count_packet_drop(self, packet) -> None:
        self.counters.count_new("packet_drop")

    # -- misc --------------------------------------------------------------
    def is_running(self) -> bool:
        return self._running

    def next_global_sequence(self) -> int:
        self._global_seq += 1
        return self._global_seq

    def merge_counters(self, c: ObjectCounter) -> None:
        with self._counters_lock:
            self.counters.merge(c)

    def increment_plugin_error(self) -> None:
        self.plugin_errors += 1

    def add_plugin_exec_ns(self, ns: int) -> None:
        """Accumulate plugin-execution wall time (called once per
        process-continue / RPC leg, from worker threads on threaded
        schedulers — hence the lock)."""
        with self._counters_lock:
            self.plugin_exec_ns += ns

    @property
    def lookahead_ns(self) -> int:
        if self.options.runahead_ms > 0:
            return self.options.runahead_ms * stime.SIM_TIME_MS
        m = getattr(self.topology, "min_latency_ns", 0)
        if 0 < m < stime.SIM_TIME_MAX:
            return m
        return DEFAULT_LOOKAHEAD_NS

    # -- observability -----------------------------------------------------
    def _scrape_metrics(self) -> Dict:
        """The 'engine' metrics source: phase wall split + policy/kernel +
        plane + native-plane introspection, one flat namespace."""
        with self._counters_lock:
            plugin_ns = self.plugin_exec_ns
        out = {
            "engine.rounds": self.rounds_executed,
            "engine.events": self.events_executed,
            "engine.host_exec_sec": round(self.host_exec_ns / 1e9, 4),
            # the host_exec split (ISSUE 7): wall spent resuming plugin
            # code vs everything else on the round path (event dispatch,
            # scheduler, protocol control plane) — the number that says
            # whether the remaining wall is app work or engine overhead
            "engine.host_exec_plugin_sec": round(plugin_ns / 1e9, 4),
            "engine.host_exec_ctrl_sec": round(
                max(self.host_exec_ns - plugin_ns, 0) / 1e9, 4),
            "engine.flush_sec": round(self.flush_ns / 1e9, 4),
            "engine.flush_quiet_skips": self.flush_quiet_skips,
            "engine.flush_quiet_sec": round(self.flush_quiet_ns / 1e9, 4),
        }
        pol = self.scheduler.policy
        if hasattr(pol, "device_ns"):       # tpu policy phase timers
            out["policy.device_wait_sec"] = round(pol.device_ns / 1e9, 4)
            out["policy.flush_host_sec"] = round(pol.host_flush_ns / 1e9, 4)
        kern = getattr(pol, "_kernel", None)
        if kern is not None:
            out["policy.device_calls"] = kern.device_calls
            out["policy.host_calls"] = kern.host_calls
        if self.device_plane is not None:
            out.update({f"plane.{k}": v
                        for k, v in self.device_plane.stats().items()})
        if self.native_plane is not None:
            sched, execd, drops, _last = self.native_plane.counters()
            out["native.events_scheduled"] = sched
            out["native.events_executed"] = execd
            out["native.drops"] = drops
            pol = self.scheduler.policy
            if hasattr(pol, "round_windows"):
                # C round executor engagement (ISSUE 10): windows driven
                # by ONE extension call, and whether a failure demoted the
                # executor back to the per-event path
                out["native.round_windows"] = pol.round_windows
                out["native.round_demoted"] = int(pol.round_demoted)
                out["native.round_repromoted"] = int(
                    getattr(pol, "round_repromoted", False))
            # batched continuation plane (ISSUE 12): green-thread resumes
            # delivered per py_exec_batch call vs one-callback-each
            # (getattr: test stand-in planes predate the ledger)
            np_ = self.native_plane
            batches = getattr(np_, "py_exec_batch_calls", 0)
            fused = getattr(np_, "continuations_fused", 0)
            out["native.py_exec_batch_calls"] = batches
            out["native.continuations_fused"] = fused
            out["native.continuations_single"] = getattr(
                np_, "continuations_single", 0)
            out["native.continuation_batch_size"] = round(
                fused / max(batches, 1), 2)
        return out

    def _obs_round_end(self) -> None:
        """Round-cadence observability hook (both run loops): scrape the
        registry to the JSONL stream when due.  One None-check per round
        when metrics are off."""
        if self._metrics_writer is not None:
            self._metrics_writer.maybe_write(self.metrics,
                                             self.rounds_executed,
                                             self.scheduler.window_start)

    def _obs_emergency(self) -> None:
        """Crash-path observability: export whatever the flight recorder
        holds and close the metrics stream with a summary.  Every step is
        best-effort — this runs while an exception is propagating and must
        never mask it."""
        try:
            if self.tracer.enabled and self.shard_count == 1:
                path = self.tracer.export()
                if path:
                    get_logger().warning(
                        "engine",
                        f"flight recorder exported after abnormal "
                        f"termination: {path}")
            if self._metrics_writer is not None:
                self._metrics_writer.write_summary(
                    self.metrics, self.rounds_executed,
                    self.scheduler.window_start)
            get_logger().flush()
        except Exception:
            pass

    def _obs_finish(self) -> None:
        """End-of-run observability: final metrics summary (carrying the
        ObjectCounter leak report + supervision ledger + plane stats) and
        the trace export.  Shard engines skip the export — their rings are
        drained over the procs protocol and merged by the parent."""
        if self._metrics_writer is not None:
            # final tracker sweep: one closing heartbeat per host so the
            # summary's tracker.* aggregates (and the last legacy log
            # sample tools parse) reflect END-of-run totals, not the last
            # sim-gated heartbeat's.  Under the native plane the sweep's
            # counter reads come from ONE bulk C snapshot, not a C
            # round-trip per host (ISSUE 7 control-plane cut).
            from contextlib import nullcontext
            ctx = self.native_plane.bulk_sync() \
                if self.native_plane is not None else nullcontext()
            with ctx:
                for hid in sorted(self.hosts):
                    host = self.hosts[hid]
                    if self.owns_host(host):
                        host.tracker.heartbeat(self.scheduler.window_start)
            for key, val in self.counters.summary().items():
                self.metrics.set_summary_info(key, val)
            self._metrics_writer.write_summary(self.metrics,
                                               self.rounds_executed,
                                               self.scheduler.window_start)
            get_logger().message(
                "engine",
                f"metrics written: {self._metrics_writer.path} "
                f"({self._metrics_writer.records_written} records)")
        if self.tracer.enabled and self.shard_count == 1:
            path = self.tracer.export()
            if path:
                get_logger().message("engine", f"trace written: {path}")

    # -- boot events -------------------------------------------------------
    def schedule_boot(self) -> None:
        """Host boots + process starts at t=0 (host_boot :372-390)."""
        # commit the host->worker assignment (seeded Fisher-Yates shuffle,
        # reference scheduler.c:437-472) now that every host is registered
        self.scheduler.finalize_hosts()
        boot_worker = Worker(0, self)
        set_current_worker(boot_worker)
        try:
            for hid in sorted(self.hosts):
                host = self.hosts[hid]
                if not self.owns_host(host):
                    # replica of a host another shard executes: it exists so
                    # DNS/topology/addressing resolve identically, but it
                    # boots (and runs) only on its owner
                    continue
                boot_worker.set_active_host(host)
                host.boot()
                for proc in host.processes:
                    proc.schedule_start(boot_worker)
                boot_worker.set_active_host(None)
            self._schedule_heartbeat_sweeps(boot_worker)
        finally:
            set_current_worker(None)
        self.merge_counters(boot_worker.counters)
        # table rows boot lazily from here on: a row materialized after
        # this point replays this exact sequence for itself
        self._boot_done = True

    def _schedule_heartbeat_sweeps(self, worker) -> None:
        """ONE recurring sweep event per distinct per-host heartbeat
        interval replaces the per-host heartbeat events (ISSUE 10 batched
        control plane): at each tick the sweep heartbeats every owned host
        on that interval in one pass — under the native plane through ONE
        bulk C tracker snapshot — so a 10k-host run pays one event + one
        extension call per interval, not 10k events with a C round-trip
        each.  Log lines keep the same sim-time stamps and global host-id
        order; the VALUES are sampled at the tick's round boundary (the
        sweep drains there, workers parked) rather than the tick's exact
        slot in the event order, so they can include up to one lookahead
        window of post-tick traffic — deterministic, and fresher, but not
        bit-equal to the retired per-host events' mid-round samples."""
        intervals = {h.params.heartbeat_interval_sec
                     for h in self.hosts.values()
                     if self.owns_host(h)
                     and h.params.heartbeat_interval_sec > 0}
        if self.host_table is not None:
            intervals |= self.host_table.heartbeat_intervals()
        for sec in sorted(intervals):
            worker.schedule_task(
                Task(_tracker_sweep_task, (self, sec), None,
                     name="heartbeat"),
                sec * stime.SIM_TIME_SEC, dst_host=None)

    def run_tracker_sweep(self, interval_sec: int, now: int) -> None:
        """One heartbeat sweep tick, run at the round boundary (workers
        parked — no tracker races): heartbeat every owned host on this
        interval in GLOBAL host-id order, quiet table rows merged in place
        (reported from columns, never materialized), with ONE bulk C
        tracker snapshot when the native plane is attached.  Quiet hosts
        pay the prev==row dirty check inside sync_tracker and the
        filtered-level early-out inside heartbeat."""
        from contextlib import nullcontext
        rows = self.host_table.heartbeat_rows(interval_sec) \
            if self.host_table is not None else []
        ri = 0
        ctx = self.native_plane.bulk_sync() \
            if self.native_plane is not None else nullcontext()
        with ctx:
            for hid in sorted(self.hosts):
                while ri < len(rows) and rows[ri][0] < hid:
                    self.host_table.heartbeat_row(rows[ri], now)
                    ri += 1
                host = self.hosts[hid]
                if host.params.heartbeat_interval_sec == interval_sec \
                        and self.owns_host(host):
                    host.tracker.heartbeat(now)
        while ri < len(rows):
            self.host_table.heartbeat_row(rows[ri], now)
            ri += 1

    # -- round loop --------------------------------------------------------
    def run(self) -> int:
        """The slave_run equivalent.  Returns process-style exit code."""
        log = get_logger()
        # per-packet delivery-status audit trails only when debugging
        # (packet.c PDS_* flags are logged at debug level there too);
        # sampled at run start so set_level() before run() is honored
        from ..routing import packet as packet_mod
        packet_mod.AUDIT_STATUSES = log.would_log("debug")
        self.sim_start_wall = _walltime.monotonic()
        self.schedule_boot()
        # The hot loop allocates millions of short-lived Events/Packets that
        # die by refcount; cyclic GC passes over them are pure overhead (the
        # few true cycles — e.g. TCP parent/child links — are reclaimed by
        # the final collect).  Mirrors the reference's G_SLICE tuning intent.
        import gc
        gc_was_enabled = gc.isenabled()
        if gc_was_enabled:
            gc.collect()
            gc.freeze()
            gc.disable()
        lookahead = self.lookahead_ns
        log.message("engine",
                    f"starting simulation: {self.total_host_count()} hosts, "
                    f"policy={self.scheduler.policy_name}, "
                    f"workers={self.options.workers}, "
                    f"lookahead={lookahead / 1e6:.3f} ms, "
                    f"end={self.end_time / 1e9:.1f} s")
        try:
            if self.options.workers == 0:
                self._run_serial(lookahead)
            else:
                self._run_threaded(lookahead)
        except BaseException:
            # abnormal termination: best-effort flight-recorder export +
            # metrics summary BEFORE the exception propagates — the
            # post-mortem timeline is exactly what the flight recorder
            # exists to preserve (the success path exports in _obs_finish)
            self._obs_emergency()
            raise
        finally:
            if gc_was_enabled:
                gc.enable()
                gc.unfreeze()
                gc.collect()
        self._running = False
        if self.device_plane is not None:
            # fold every pending device-plane byte delta so post-run
            # readers see final tracker totals
            self.device_plane.flush_all_trackers()
        if self.native_plane is not None:
            # post-run reads (tests, tools, digests) see the Python tracker
            # objects; the authoritative counts accumulated in C — fetched
            # with ONE bulk C call for all hosts, not 10k round trips
            with self.native_plane.bulk_sync():
                for host in self.hosts.values():
                    self.native_plane.sync_tracker(host.id, host.tracker)
        # teardown: hosts (and their descriptors) are reclaimed here
        for host in self.hosts.values():
            # dict.fromkeys: dedupe multi-IP interfaces in insertion order
            # (set iteration order varies run-to-run — SIM003)
            for iface in dict.fromkeys(host.interfaces.values()):
                if iface.pcap is not None:
                    iface.pcap.close()
            self.counters.count_free("host")
        if self.host_table is not None:
            # never-materialized rows: balance the host ledger in bulk
            self.host_table.close_counters()
        log.flush()
        leaks = self.counters.leaks()
        if self.device_plane is not None:
            st = self.device_plane.stats()
            log.message(
                "engine",
                f"device plane: {st['completed']}/{st['circuits']} flows "
                f"complete, {st['forwards']} cell forwards on-device over "
                f"{st['dispatches']} dispatches (mode={st['mode']})")
        log.message("engine",
                    f"simulation finished: {self.rounds_executed} rounds, "
                    f"{self.events_executed} events, "
                    f"{_walltime.monotonic() - self.sim_start_wall:.3f}s wall "
                    f"(host_exec {self.host_exec_ns / 1e9:.3f}s, "
                    f"flush {self.flush_ns / 1e9:.3f}s)")
        if self._resume_snapshot is not None:
            from .checkpoint import warn_resume_unreached
            warn_resume_unreached(self._resume_snapshot, "engine")
        if self.supervision.recoveries:
            log.message("engine",
                        f"supervision: {self.supervision.summary()}")
        if leaks:
            log.message("engine", self.counters.report())
        self._obs_finish()
        log.flush()
        return 1 if self.plugin_errors else 0

    def _flush_round(self) -> bool:
        """Round-boundary hook for batching policies (tpu): LAUNCH the device
        step for the packets sent this round.  In async mode the results are
        materialized by _consume_flush at the top of the next loop iteration
        (always before the next window is computed), so the device computes
        through the logger flush / heartbeat / window bookkeeping.  (The
        device traffic plane launches EARLIER — _launch_plane at the top of
        the round — so its dispatch overlaps the whole round's host work.)

        Returns True when any leg did real work — the round loop's
        dirty-tracking signal (ISSUE 10 compacted flush): quiet rounds are
        counted and their flush cost pinned ~zero by the bench-smoke
        control-plane gate."""
        did = False
        if self._pending_sweeps:
            # heartbeat sweeps recorded by this round's tick events run
            # HERE, at the quiescent boundary (workers parked), so the
            # tracker reads/folds never race worker-thread event execution
            sweeps, self._pending_sweeps = self._pending_sweeps, []
            for interval_sec, now in sweeps:
                self.run_tracker_sweep(interval_sec, now)
            did = True
        flush = getattr(self.scheduler.policy, "flush_round", None)
        if flush is not None:
            did = bool(flush(self)) or did
        ws = self.scheduler.window_start
        if self._resume_snapshot is not None \
                and ws >= self._resume_snapshot["sim_time_ns"]:
            self._consume_flush()
            self._verify_resume(ws)
            did = True
        if self._checkpointer is not None \
                and self._checkpointer.due(ws, self.rounds_executed):
            # snapshots must include every in-flight delivery: consume first
            # (only on rounds that actually write — an unconditional consume
            # here would forfeit the async launch/consume overlap for the
            # whole run)
            self._consume_flush()
            with self.tracer.span("checkpoint.write", "engine", sim_ns=ws):
                path = self._checkpointer.maybe_write(self)
            did = True
            if path:
                self._checkpoint_counter.inc()
                get_logger().message("engine", f"checkpoint written: {path}")
        return did

    def _verify_resume(self, window_start: int) -> None:
        from .checkpoint import (collect_state, digest_of_state,
                                 verify_resume_boundary)
        snap, self._resume_snapshot = self._resume_snapshot, None
        verify_resume_boundary(snap, window_start,
                               digest_of_state(collect_state(self)),
                               "engine")
        self.supervision.resume_verified = True

    def _consume_flush(self) -> None:
        """Materialize + push any async flush results (no-op otherwise)."""
        consume = getattr(self.scheduler.policy, "consume_flush", None)
        if consume is not None:
            consume(self)
        if self.device_plane is not None:
            self.device_plane.consume(self)

    def _launch_plane(self) -> None:
        """Pipeline stage boundary: launch the device traffic plane's window
        dispatch at the TOP of the round, right after the window is
        computed — the dispatch then computes while the host drains the
        round's arrivals (plugin execution + the native C plane), and
        _consume_flush collects it at the next loop iteration, always
        before the next window.  The previous dispatch was committed by
        that same _consume_flush, so round N's state is final before round
        N+1's staged injections are folded in (the determinism contract
        tests/test_device_pipeline.py pins)."""
        if self.device_plane is not None:
            self.device_plane.advance(self)

    def _superwindow_budget(self):
        """(max_rounds, cap_time) for this round's superwindow negotiation.
        Checkpoint and resume boundaries must land on span starts with K=1
        semantics — the snapshot digest is collected (and --resume verified)
        at an exact round boundary, so merging may never cross one: cap_time
        caps merged windows below the next sim-time boundary, and the round
        budget stops the counter short of the next round-cadence write."""
        max_rounds = self._superwindow
        cap = None
        if self._resume_snapshot is not None:
            cap = self._resume_snapshot["sim_time_ns"]
        ck = self._checkpointer
        if ck is not None:
            if ck.next_at is not None:
                cap = ck.next_at if cap is None else min(cap, ck.next_at)
            if ck.next_round is not None:
                max_rounds = min(
                    max_rounds,
                    max(ck.next_round - 1 - self.rounds_executed, 1))
        return max_rounds, cap

    def _advance_window(self, lookahead: int) -> bool:
        # the earliest HOST-side event: the Python queues (and, under the
        # native merged policy, the C heap — its next_time folds both)
        host_next = self.scheduler.next_event_time()
        nxt = host_next
        if self.device_plane is not None:
            # a busy device plane needs windows even when the Python plane
            # is idle (its dispatch cadence is the "next event")
            nxt = min(nxt, self.device_plane.next_time())
        if nxt >= self.end_time or nxt >= stime.SIM_TIME_MAX:
            return False
        self.scheduler.window_start = nxt
        self.scheduler.window_end = min(nxt + lookahead, self.end_time)
        if self.device_plane is not None and self._superwindow > 1:
            # superwindow negotiation (ISSUE 7): when no host event falls
            # inside the next K lookahead rounds, merge them into ONE
            # window so the plane executes them in one kernel launch
            max_rounds, cap = self._superwindow_budget()
            merged = self.device_plane.negotiate_superwindow(
                nxt, lookahead, host_next, self.end_time, cap, max_rounds)
            if merged is not None:
                self.scheduler.window_end = merged
        if self.native_plane is not None:
            # the C plane clamps its cross-host pushes to the same barrier
            self.native_plane.set_window(self.scheduler.window_end)
        if self.host_table is not None:
            # promotion sweep: table rows whose first boot event falls in
            # this window materialize NOW (main thread, workers parked) and
            # replay their boot — event times identical to an eager boot
            self.host_table.promote_due(self.scheduler.window_end)
        return True

    def _heartbeat(self) -> None:
        """Periodic (wall-clock-gated) engine heartbeat with the per-round
        host-vs-device split the perf hunt steers by.  The values are
        computed ONCE into a dict that feeds both the legacy log line
        (tools/plot_log.py keeps scraping it) and the metrics registry —
        the promotion ISSUE 3 asks for, with both consumers guaranteed to
        read the same numbers.

        Cadence-gated (ISSUE 7): between wall-clock reads the per-round
        cost is ONE integer decrement.  The stride adapts geometrically so
        the wall is still checked ~4x per reporting interval — fast rounds
        (tor10k reaches 10k+ rounds/s with the C plane) stop paying a
        monotonic() syscall each, slow rounds keep prompt heartbeats."""
        if self._hb_countdown > 0:
            self._hb_countdown -= 1
            return
        now_wall = _walltime.monotonic()
        gap = now_wall - self._hb_last_check
        self._hb_last_check = now_wall
        target = self.heartbeat_wall_interval / 4.0
        if gap < target / 4.0:
            # the 256 cap bounds the silence after a fast->slow phase flip
            # (256 suddenly-1s rounds, then the reset below) while still
            # cutting the syscall rate ~256x at tor10k round rates
            self._hb_stride = min(self._hb_stride * 2, 256)
        elif gap > target:
            # overshot: rounds turned slow — reset (not halve) so the next
            # heartbeat is at most one round late, not a geometric tail
            self._hb_stride = 1
        self._hb_countdown = self._hb_stride - 1
        if now_wall - self._last_heartbeat_wall < self.heartbeat_wall_interval:
            return
        self._last_heartbeat_wall = now_wall
        policy = self.scheduler.policy
        # resource usage line, reference slave.c:390-411 heartbeat getrusage
        ru = resource.getrusage(resource.RUSAGE_SELF)
        vals = {
            "rounds": self.rounds_executed,
            "simtime_s": round(self.scheduler.window_start / 1e9, 3),
            "wall_s": round(now_wall - self.sim_start_wall, 1),
            "host_exec_ms": round(self.host_exec_ns / 1e6, 1),
            "flush_ms": round(self.flush_ns / 1e6, 1),
            "cpu_user_s": round(ru.ru_utime, 1),
            "cpu_sys_s": round(ru.ru_stime, 1),
            "maxrss_mb": round(ru.ru_maxrss / 1024),
        }
        extra = ""
        if self.native_plane is not None:
            _sched, execd, drops, _last = self.native_plane.counters()
            vals["native_events"] = execd
            vals["native_drops"] = drops
            extra = f" native_events={execd} native_drops={drops}"
        kern = getattr(policy, "_kernel", None)
        if kern is not None:
            vals["device_ms"] = round(policy.device_ns / 1e6, 1)
            vals["flush_host_ms"] = round(policy.host_flush_ns / 1e6, 1)
            vals["last_batch"] = policy.last_batch
            vals["device_calls"] = kern.device_calls
            vals["recompiles"] = len(kern.buckets_seen)
            extra = (f" device_ms={vals['device_ms']:.1f}"
                     f" flush_host_ms={vals['flush_host_ms']:.1f}"
                     f" last_batch={policy.last_batch}"
                     f" device_calls={kern.device_calls}"
                     f" recompiles={len(kern.buckets_seen)}")
        self.metrics.record_engine_heartbeat(vals)
        self.tracer.instant("engine.heartbeat", "engine",
                            sim_ns=self.scheduler.window_start)
        get_logger().message(
            "engine",
            f"[engine-heartbeat] rounds={vals['rounds']}"
            f" simtime={vals['simtime_s']:.3f}s"
            f" wall={vals['wall_s']:.1f}s"
            f" host_exec_ms={vals['host_exec_ms']:.1f}"
            f" flush_ms={vals['flush_ms']:.1f}"
            f" cpu_user_s={vals['cpu_user_s']:.1f}"
            f" cpu_sys_s={vals['cpu_sys_s']:.1f}"
            f" maxrss_mb={vals['maxrss_mb']}{extra}",
            sim_time=self.scheduler.window_start)

    def _run_serial(self, lookahead: int) -> None:
        worker = Worker(0, self)
        set_current_worker(worker)
        perf = _walltime.perf_counter_ns
        tracer = self.tracer
        log = get_logger()
        plane = self.device_plane
        try:
            while True:
                tc = perf()
                # plane interaction disqualifies the iteration from the
                # quiet-round count below: a collect (in-flight dispatch
                # materialized here) or a launch is flush-phase work
                plane_active = plane is not None and plane._inflight
                with tracer.span("collect", "engine",
                                 sim_ns=self.scheduler.window_start):
                    self._consume_flush()
                self.flush_ns += perf() - tc
                if not self._advance_window(lookahead):
                    break
                ws = self.scheduler.window_start
                tl = perf()
                dispatches0 = plane.dispatches if plane is not None else 0
                with tracer.span("dispatch.launch", "engine", sim_ns=ws):
                    self._launch_plane()
                self.flush_ns += perf() - tl
                plane_active = plane_active or (
                    plane is not None and plane.dispatches != dispatches0)
                worker.round_end = self.scheduler.window_end
                t0 = perf()
                with tracer.span("round", "engine", sim_ns=ws,
                                 args={"round": self.rounds_executed}):
                    worker.run_round()
                t1 = perf()
                with tracer.span("flush", "engine", sim_ns=ws):
                    did_flush = self._flush_round()
                t2 = perf()
                self.flush_ns += t2 - t1
                self.host_exec_ns += t1 - t0
                self.rounds_executed += 1
                self._heartbeat()
                self._obs_round_end()
                # compacted flush (ISSUE 10): one pending() read skips the
                # whole sort-and-emit leg (and its span) on quiet rounds
                if log.pending():
                    with tracer.span("log.flush", "engine", sim_ns=ws):
                        log.flush()
                elif not (did_flush or plane_active):
                    self.flush_quiet_skips += 1
                    self.flush_quiet_ns += t2 - t1
            self.events_executed = worker.counters._free.get("event", 0)
            self._fold_native_events(worker.counters)
        finally:
            worker.finish()
            set_current_worker(None)

    def _run_threaded(self, lookahead: int) -> None:
        n = self.scheduler.n_threads
        start_latch = CountDownLatch(n + 1)
        done_latch = CountDownLatch(n + 1)
        stop_flag = {"stop": False}
        errors: List[BaseException] = []
        workers = [Worker(i, self) for i in range(n)]

        def body(worker: Worker) -> None:
            set_current_worker(worker)
            try:
                while True:
                    start_latch.count_down_await()
                    if stop_flag["stop"]:
                        break
                    try:
                        worker.round_end = self.scheduler.window_end
                        worker.run_round()
                    except BaseException as e:  # surface, don't deadlock the latch
                        errors.append(e)  # simlint: disable=SIM102 -- done_latch's condvar orders this append before the parent's post-barrier read
                    done_latch.count_down_await()
            finally:
                worker.finish()
                set_current_worker(None)

        threads = [threading.Thread(target=body, args=(w,), daemon=True,
                                    name=f"worker-{w.id}") for w in workers]
        for t in threads:
            t.start()
        perf = _walltime.perf_counter_ns
        tracer = self.tracer
        log = get_logger()
        plane = self.device_plane
        try:
            while True:
                tc = perf()
                plane_active = plane is not None and plane._inflight
                with tracer.span("collect", "engine",
                                 sim_ns=self.scheduler.window_start):
                    self._consume_flush()
                self.flush_ns += perf() - tc
                if not self._advance_window(lookahead):
                    break
                ws = self.scheduler.window_start
                tl = perf()
                dispatches0 = plane.dispatches if plane is not None else 0
                with tracer.span("dispatch.launch", "engine", sim_ns=ws):
                    self._launch_plane()
                self.flush_ns += perf() - tl
                plane_active = plane_active or (
                    plane is not None and plane.dispatches != dispatches0)
                t0 = perf()
                with tracer.span("round", "engine", sim_ns=ws,
                                 args={"round": self.rounds_executed,
                                       "workers": n}):
                    start_latch.count_down_await()
                    start_latch.reset()
                    done_latch.count_down_await()
                    done_latch.reset()
                t1 = perf()
                if errors:
                    raise errors[0]
                with tracer.span("flush", "engine", sim_ns=ws):
                    did_flush = self._flush_round()
                t2 = perf()
                self.flush_ns += t2 - t1
                self.host_exec_ns += t1 - t0
                self.rounds_executed += 1
                self._heartbeat()
                self._obs_round_end()
                if log.pending():
                    with tracer.span("log.flush", "engine", sim_ns=ws):
                        log.flush()
                elif not (did_flush or plane_active):
                    self.flush_quiet_skips += 1
                    self.flush_quiet_ns += t2 - t1
        finally:
            stop_flag["stop"] = True
            start_latch.count_down_await()
            for t in threads:
                t.join(timeout=30)
        self.events_executed = self.counters._free.get("event", 0)
        self._fold_native_events(self.counters)

    def _fold_native_events(self, counters: ObjectCounter) -> None:
        """Fold the C plane's event lifecycle into the engine's totals
        (created at schedule, freed at execution — same accounting the
        Python events get).  Shared by BOTH runners: _run_threaded used to
        skip this fold entirely, so a threaded run with a native plane
        attached under-reported events_executed and leaked the C plane's
        event/drop counts from the ObjectCounter ledger (ISSUE 7
        satellite; regression-pinned by tests/test_superwindow.py)."""
        if self.native_plane is None:
            return
        sched, execd, drops, _last = self.native_plane.counters()
        self.events_executed += execd
        counters.count_new("event", sched)
        counters.count_free("event", execd)
        if drops:
            counters.count_new("packet_drop", drops)
