"""Process-parallel scale-out: shard engines + a conservative round barrier.

``--processes N`` partitions the hosts round-robin across N OS processes.
Each child builds the COMPLETE simulation skeleton (hosts, DNS, topology —
so addressing, bandwidth resolution, and RNG derivations are bitwise
identical to a single-process run) but boots and executes events only for
its owned partition.  The only cross-host coupling in the whole simulator is
the packet hop (core/worker.py ``send_packet``), so the shard boundary is a
packet boundary: hops whose destination lives on another shard are finished
locally (reliability draw + latency lookup — both keyed by packet uid /
topology, identical everywhere) and shipped to the owner at the round
barrier, which pushes the delivery event with the identical
(time, dst, src, seq) order tuple.

Why this is exact, not approximate: every scheduler policy already clamps
cross-host deliveries to the current window end (core/scheduler.py ``push``),
and the window size never exceeds the minimum topology latency — so no
packet sent during round R can be delivered inside round R.  Exchanging
packets at the barrier therefore reproduces the serial event timeline
bit-for-bit; the parity tests assert equal state digests against a
single-process run.

This is the analog of the reference's master/slave split taken across
process boundaries (the reference kept all workers in one process and
scaled with pthreads, core/scheduler.c:266-333; a C simulator can — for
CPython the GIL makes threads useless for compute, so real multicore
scaling needs processes).  The round protocol is the classic conservative
PDES exchange (null-message-free, barrier-synchronized), the same shape an
MPI/NCCL allreduce-per-round backend would have on a multi-host deployment:
``out``-boxes are the all-to-all, the min-next-time gather is the allreduce.

Per round, parent <-> children exchange:

    parent -> all : ("run", window_start, window_end)
    child  -> par : ("out", [outbox per shard])      after draining the round
    parent -> all : ("in", inbox)                     routed all-to-all
    child  -> par : ("min", next_event_time, pending) after ingesting inbox

plus ("collect" -> "hosts") for assembled checkpoints and
("stop" -> "final") at the end.  Checkpoints taken by the parent merge the
shards' per-host states through the same ``assemble_state`` the serial
writer uses, so snapshot digests are comparable across process counts.

Self-healing (ISSUE 17): a shard that dies mid-protocol (SIGKILL, OOM,
``os._exit``) no longer ends the run.  The surviving shards are already
quiesced at the round barrier (they park in ``conn.recv`` until the parent
routes their inbox — the barrier IS the checkpoint boundary), so the parent
respawns the dead shard and drives it through a deterministic replay of the
recorded protocol history: the identical ("run", ws, we) windows and
("in", inbox) payloads, with every replayed round's outbox signature and
min-report cross-checked against the first life, and the shard's host-state
digest verified at the newest recorded snapshot boundary (the join-boundary
digest check; pure round-zero replay when no checkpoint was written).  Any
divergence aborts loudly — a resurrection may never silently simulate
something else.  Bounded by ``--max-resurrections`` with exponential
backoff; each detour is counted in ``SupervisionStats`` with its MTTR.
The replay history (window list + per-shard inboxes) is retained in the
parent for the life of the run — the price of being able to rebuild any
shard from round zero, same as the determinism-kernel resume contract.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import time as _walltime
from typing import Dict, List, Optional

from ..core import stime
from ..core.logger import SimLogger, get_logger, set_logger


# ---------------------------------------------------------------------------
# child (shard) side
# ---------------------------------------------------------------------------

def _shard_main(conn, options, config) -> None:
    """Entry point of one shard process (spawned; top-level for pickling)."""
    try:
        set_logger(SimLogger(level=options.log_level))
        _shard_body(conn, options, config)
    except BaseException as e:  # noqa: BLE001 - surfaced to the parent
        import traceback
        try:
            conn.send(("error", f"{e!r}\n{traceback.format_exc()}"))
        except Exception:
            pass
        raise


def _shard_body(conn, options, config) -> None:
    from ..core.checkpoint import collect_host_states
    from ..core.controller import Controller
    from ..core.event import Event
    from ..core.task import Task
    from ..core.worker import Worker, set_current_worker, \
        _deliver_packet_task
    from ..routing.packet import Packet

    ctrl = Controller(options, config)
    ctrl.setup()
    engine = ctrl.engine
    log = get_logger()

    # fault harness (shard-exit:SID:ROUND): this shard hard-exits at the
    # start of round ROUND — os._exit skips the ("error", ...) report, so
    # the parent sees exactly what a SIGKILL/OOM kill looks like and must
    # recover via dead-shard detection, never a hang
    from ..core.supervision import parse_fault_inject
    fault = parse_fault_inject(getattr(options, "fault_inject", "") or "")
    fault_exit_round = 0
    if fault and fault["kind"] in ("shard-exit", "shard-exit-resurrect") \
            and fault["shard"] == engine.shard_id:
        fault_exit_round = fault["round"]

    engine.sim_start_wall = _walltime.monotonic()
    engine.schedule_boot()
    worker = Worker(0, engine)
    set_current_worker(worker)
    tracer = engine.tracer

    import gc
    gc_was_enabled = gc.isenabled()
    if gc_was_enabled:
        gc.collect()
        gc.freeze()
        gc.disable()

    hosts_by_id = engine.hosts
    scheduler = engine.scheduler
    try:
        conn.send(("ready", engine.lookahead_ns, engine.end_time,
                   len(engine.hosts)))
        conn.send(("min", scheduler.next_event_time(),
                   scheduler.pending_count()))
        while True:
            msg = conn.recv()
            kind = msg[0]
            if kind == "stop":
                break
            if kind == "collect":
                conn.send(("hosts", collect_host_states(engine)))
                continue
            ws, we = msg[1], msg[2]
            if fault_exit_round and \
                    engine.rounds_executed + 1 >= fault_exit_round:
                os._exit(3)
            scheduler.window_start = ws
            scheduler.window_end = we
            worker.round_end = we
            if engine.native_plane is not None:
                engine.native_plane.set_window(we)
            if engine.host_table is not None:
                # same round-top promotion sweep the serial loop runs
                engine.host_table.promote_due(we)
            with tracer.span("round", "engine", sim_ns=ws,
                             args={"round": engine.rounds_executed,
                                   "shard": engine.shard_id}):
                worker.run_round()
            with tracer.span("flush", "engine", sim_ns=ws):
                engine._flush_round()
            conn.send(("out", engine.drain_outboxes()))
            with tracer.span("exchange", "engine", sim_ns=ws):
                inbox = conn.recv()[1]
            for t, dst_id, src_id, seq, wire in inbox:
                if engine.native_plane is not None:
                    # C-plane shard: the hop lands straight in the C event
                    # heap (all TCP/UDP sockets live there); same clamp,
                    # same sender-claimed identity
                    engine.native_plane.c.push_deliver(int(t), int(dst_id),
                                                       int(src_id),
                                                       int(seq), wire)
                    continue
                # table rows materialize on first delivery, exactly like
                # the in-process host_by_ip path (the owner side boots the
                # row; the replica side exists for identity only)
                dst_host = engine.host_by_id(dst_id)
                src_host = engine.host_by_id(src_id)
                pkt = Packet.from_wire(wire)
                ev = Event(Task(_deliver_packet_task, dst_host, pkt,
                                name="deliver_packet"),
                           t, dst_host, src_host, seq)
                # the push clamp (still at this round's window end) matches
                # what the serial run applied when the hop was scheduled
                scheduler.push(ev, worker)
            engine.rounds_executed += 1
            engine._heartbeat()
            log.flush()
            conn.send(("min", scheduler.next_event_time(),
                       scheduler.pending_count()))
    finally:
        if gc_was_enabled:
            gc.enable()
            gc.unfreeze()
            gc.collect()
        set_current_worker(None)

    events = worker.counters._free.get("event", 0)
    if engine.native_plane is not None:
        # fold the C plane's event lifecycle into this shard's totals
        # (mirrors Engine._run_serial's accounting)
        sched, execd, drops, _last = engine.native_plane.counters()
        events += execd
        worker.counters.count_new("event", sched)
        worker.counters.count_free("event", execd)
        if drops:
            worker.counters.count_new("packet_drop", drops)
        # the shard teardown sweep reads every host's C counters from ONE
        # bulk snapshot, exactly like the serial/threaded final sweeps
        # (ISSUE 10 satellite; this used to pay a C round-trip per host)
        with engine.native_plane.bulk_sync():
            for host in engine.hosts.values():
                engine.native_plane.sync_tracker(host.id, host.tracker)
    worker.finish()
    host_states = collect_host_states(engine)
    for host in engine.hosts.values():
        # dict.fromkeys: deterministic dedupe (set order varies — SIM003)
        for iface in dict.fromkeys(host.interfaces.values()):
            if iface.pcap is not None:
                iface.pcap.close()
        if engine.owns_host(host):
            engine.counters.count_free("host")
    if engine.host_table is not None:
        engine.host_table.close_counters()
    log.flush()
    # observability merge (ISSUE 3): the shard's flight-recorder ring and
    # metrics scrape ride the final message; the parent merges traces onto
    # per-shard tracks (Chrome pid = shard id) and folds the scrapes into
    # its summary.  Shard engines never export/write files themselves.
    from ..obs.metrics import get_metrics
    from ..obs.trace import get_tracer
    if get_metrics().enabled:
        # closing tracker sweep (same as Engine._obs_finish): the shard's
        # scrape ships end-of-run tracker totals to the parent summary,
        # and the heartbeat lines it logs need one more flush to reach
        # the shard's log (the earlier flush predates the sweep).  Under
        # the native plane the counter reads come from ONE bulk snapshot
        # (ISSUE 10 satellite — the serial sweep already did).
        from contextlib import nullcontext
        ctx = engine.native_plane.bulk_sync() \
            if engine.native_plane is not None else nullcontext()
        with ctx:
            for host in engine.hosts.values():
                if engine.owns_host(host):
                    host.tracker.heartbeat(engine.scheduler.window_start)
        log.flush()
    conn.send(("final", {
        "events": events,
        "rounds": engine.rounds_executed,
        "plugin_errors": engine.plugin_errors,
        "pending": scheduler.pending_count(),
        "host_states": host_states,
        "counters_new": dict(engine.counters._new),
        "counters_free": dict(engine.counters._free),
        "wall": _walltime.monotonic() - engine.sim_start_wall,
        "trace_events": get_tracer().drain(),
        "trace_epoch": get_tracer().epoch,
        "trace_dropped": get_tracer().dropped,
        "metrics": get_metrics().scrape(),
        "supervision": engine.supervision.summary(),
    }))


# ---------------------------------------------------------------------------
# parent (coordinator) side
# ---------------------------------------------------------------------------

class ShardDeadError(RuntimeError):
    """A shard process died (or went watchdog-silent) mid-protocol — the
    distinguished failure the supervision ledger counts, as opposed to a
    shard that REPORTED an error before exiting.

    ``sid`` names the dead shard; ``resurrectable`` is False for the
    live-but-silent watchdog case (killing and replaying a shard that may
    still be computing is not a recovery, it is a race — that path stays a
    diagnostic abort)."""

    sid: int = -1
    resurrectable: bool = True


def _recv_supervised(conn, proc, sid: int, watchdog_sec: float):
    """Shard supervision: a ``recv`` that polls in short slices and checks
    the shard process between them.  A shard that died without reporting
    (SIGKILL, OOM, os._exit) surfaces as a diagnostic ShardDeadError within
    ~a poll slice instead of parking the parent in ``Connection.recv``
    forever — the parent decides whether to resurrect or abort;
    ``watchdog_sec > 0`` additionally bounds how long a LIVE but silent
    shard may stall a round barrier."""
    waited = 0.0
    while True:
        if conn.poll(0.5):
            try:
                msg = conn.recv()
            except EOFError:
                raise ShardDeadError(
                    f"shard {sid} closed its pipe mid-message "
                    f"(exit code {proc.exitcode})")
            if msg[0] == "error":
                raise RuntimeError(f"shard failed:\n{msg[1]}")
            return msg
        if not proc.is_alive():
            if conn.poll(0):
                continue        # final message raced the death check
            raise ShardDeadError(
                f"shard {sid} died (exit code {proc.exitcode}) without "
                "reporting an error (dead-shard detection)")
        waited += 0.5
        if watchdog_sec > 0 and waited >= watchdog_sec:
            err = ShardDeadError(
                f"shard {sid} alive but silent for {waited:.0f}s "
                "(--shard-watchdog-sec) — aborting with diagnostics")
            err.resurrectable = False
            raise err


class ProcsController:
    """Coordinator for ``--processes N``: spawns the shard engines, drives
    the window/exchange protocol, assembles checkpoints and the final state
    digest.  Mirrors the reference Master's role (core/master.c) across
    process boundaries."""

    def __init__(self, options, config):
        if options.processes < 2:
            raise ValueError("--processes needs N >= 2 (use the regular "
                             "engine for a single process)")
        self.options = options
        self.config = config
        self.n_shards = int(options.processes)
        self.rounds_executed = 0
        self.events_executed = 0
        self.final_state: Optional[Dict] = None
        self.digest: Optional[str] = None
        self.checkpoints: List[str] = []
        self.resume_verified = False
        from ..core.supervision import SupervisionStats, parse_fault_inject
        self.supervision = SupervisionStats()
        # self-healing state (ISSUE 17): the recorded protocol history a
        # resurrected shard replays, per-shard snapshot-boundary digests
        # for the join verification, and the respawn budget.  The legacy
        # ``shard-exit`` drill keeps PR-2 abort semantics (it exists to
        # drill dead-shard DETECTION); real deaths and the
        # ``shard-exit-resurrect`` drill take the resurrection path.
        fault = parse_fault_inject(getattr(options, "fault_inject", "")
                                   or "")
        self._legacy_abort = bool(fault and fault["kind"] == "shard-exit")
        self.max_resurrections = int(
            getattr(options, "max_resurrections", 3))
        self._history: List[tuple] = []       # (ws, we, inboxes, out_sigs,
                                              #  mins) per completed round
        self._ck_verify: Dict[int, List[str]] = {}   # rounds -> per-sid
                                                     # host-state digests
        self._initial: Optional[tuple] = None  # (readies, first mins)
        self._resurrections_used = 0
        self._death_wall = 0.0
        self._last_collect_sid_digests: List[str] = []
        self._shard_wd = float(getattr(options, "shard_watchdog_sec", 0)
                               or 0)
        self._ctx = None
        self.conns: List = []
        self.procs: List = []
        # parent-side observability: the parent owns the merged trace file
        # (per-shard tracks) and the metrics summary; its own track is
        # labeled 'parent' on a pid past the shard range
        from ..obs import configure_observability
        self.tracer, self.metrics, self._metrics_writer = \
            configure_observability(options, shard_id=self.n_shards,
                                    label="parent")

    def _child_options(self, shard_id: int):
        import dataclasses
        opt = dataclasses.replace(self.options)
        opt.processes = 0
        opt.shard_id = shard_id
        opt.shard_count = self.n_shards
        # each shard drains its partition with the single serial worker; a
        # threaded scheduler inside a shard would strand events on worker>0
        # heaps that _shard_body's lone Worker(0) never pops
        opt.workers = 0
        # checkpoints are assembled by the parent from shard host-states;
        # per-shard snapshot files would be partial and misleading — and
        # the parent likewise owns resume verification over the ASSEMBLED
        # state, so shards never verify partial digests
        opt.checkpoint_interval_sec = 0
        opt.checkpoint_every_rounds = 0
        opt.resume_path = None
        # the parent seeds the data directory from the template ONCE before
        # spawning (N children racing shutil.copytree would collide)
        opt.data_template = None
        return opt

    # -- self-healing plumbing (ISSUE 17) ----------------------------------

    def _spawn(self, sid: int, clear_fault: bool = False) -> None:
        """Spawn (or respawn) shard ``sid``.  A resurrection spawns with
        the shard-exit fault harness CLEARED: the drill simulates ONE
        SIGKILL, and a replacement that re-dies at the same round would
        only drain the budget without testing anything new.  Every other
        fault kind is kept — the replacement must replay its first life
        exactly, demotions included."""
        opt = self._child_options(sid)
        if clear_fault and (opt.fault_inject or "").startswith("shard-exit"):
            opt.fault_inject = ""
        parent_conn, child_conn = self._ctx.Pipe()
        p = self._ctx.Process(target=_shard_main,
                              args=(child_conn, opt, self.config),
                              daemon=True, name=f"shard-{sid}")
        p.start()
        child_conn.close()
        if sid < len(self.conns):
            self.conns[sid] = parent_conn
            self.procs[sid] = p
        else:
            self.conns.append(parent_conn)
            self.procs.append(p)

    def _recv(self, sid: int):
        try:
            return _recv_supervised(self.conns[sid], self.procs[sid], sid,
                                    self._shard_wd)
        except ShardDeadError as e:
            # the ledger records the detection regardless of what the
            # parent does next (resurrect or abort), and the timeline
            # rides along like every other recovery seam
            self.supervision.shard_deaths_detected += 1
            self.supervision._dump_flight_recorder(
                f"shard {sid} death detected")
            self._death_wall = _walltime.monotonic()
            e.sid = sid
            raise

    def _send(self, sid: int, msg) -> None:
        try:
            self.conns[sid].send(msg)
        except (BrokenPipeError, OSError):
            self.supervision.shard_deaths_detected += 1
            self.supervision._dump_flight_recorder(
                f"shard {sid} death detected (send)")
            self._death_wall = _walltime.monotonic()
            e = ShardDeadError(
                f"shard {sid} pipe closed on send "
                f"(exit code {self.procs[sid].exitcode})")
            e.sid = sid
            raise e

    def _heal_or_raise(self, e: ShardDeadError) -> int:
        """Decide a dead shard's fate: resurrect within budget, or abort
        loudly.  Returns the shard id after a successful resurrection."""
        if self._legacy_abort or not getattr(e, "resurrectable", True):
            raise e
        if self._resurrections_used >= self.max_resurrections:
            raise RuntimeError(
                f"resurrection budget exhausted (--max-resurrections "
                f"{self.max_resurrections}, used "
                f"{self._resurrections_used}): {e} — aborting")
        self._resurrect(e.sid)
        return e.sid

    def _resurrect(self, sid: int) -> None:
        """Respawn shard ``sid`` and replay it to the current round
        barrier.  The surviving shards are quiesced (parked in their
        ``conn.recv`` at the barrier) for the duration; they never see the
        detour.  Replay is the determinism-kernel resume contract applied
        to one shard: identical windows + identical inboxes => identical
        state, cross-checked per round (outbox signature, min report) and
        digest-verified at the newest recorded snapshot boundary.  Any
        mismatch aborts loudly — a genuinely corrupt or divergent replay
        may never rejoin the barrier."""
        import hashlib

        from ..core.checkpoint import digest_of_state
        log = get_logger()
        self._resurrections_used += 1
        attempt = self._resurrections_used
        backoff = 0.05 * (2 ** (attempt - 1))
        log.warning(
            "procs",
            f"shard {sid} died mid-protocol; resurrecting (attempt "
            f"{attempt}/{self.max_resurrections}) after {backoff:.2f}s "
            "backoff — survivors stay quiesced at the round barrier")
        # real wall-clock backoff by design: the corpse's OS resources
        # (pipes, memory) need releasing before the respawn, and repeated
        # crash loops must decelerate — nothing here advances virtual time
        _walltime.sleep(backoff)  # simlint: disable=SIM005 -- supervision backoff is wall time by definition
        old = self.procs[sid]
        try:
            self.conns[sid].close()
        except Exception:
            pass
        old.join(timeout=5)
        if old.is_alive():
            old.terminate()
            old.join(timeout=5)
        if old.is_alive():
            old.kill()
            old.join(timeout=5)
        self._spawn(sid, clear_fault=True)
        ready = self._recv(sid)
        m0 = self._recv(sid)
        if self._initial is not None:
            exp_ready, exp_min = self._initial
            if tuple(ready[1:]) != tuple(exp_ready[sid][1:]) or \
                    (m0[1], m0[2]) != (exp_min[sid][1], exp_min[sid][2]):
                raise RuntimeError(
                    f"shard {sid} resurrection diverged at boot: the "
                    "replacement's ready/min report does not match its "
                    "first life — config/seed drifted; aborting")
        for r, (ws, we, inboxes, out_sigs, mins_r) in \
                enumerate(self._history):
            self._send(sid, ("run", ws, we))
            out = self._recv(sid)[1]
            sig = hashlib.sha256(repr(out).encode()).hexdigest()
            if sig != out_sigs[sid]:
                raise RuntimeError(
                    f"shard {sid} resurrection diverged at round {r}: "
                    "replayed outbox does not match the recorded one — "
                    "aborting (a resurrection may never silently simulate "
                    "something else)")
            self._send(sid, ("in", inboxes[sid]))
            m = self._recv(sid)
            if (m[1], m[2]) != (mins_r[sid][1], mins_r[sid][2]):
                raise RuntimeError(
                    f"shard {sid} resurrection diverged at round {r}: "
                    "replayed min report does not match the recorded one "
                    "— aborting")
            if r + 1 in self._ck_verify:
                # the join-boundary digest gate: at every boundary the
                # parent snapshotted, the replayed shard's own host states
                # must digest to exactly what it contributed then
                self._send(sid, ("collect",))
                states = self._recv(sid)[1]
                if digest_of_state(states) != self._ck_verify[r + 1][sid]:
                    raise RuntimeError(
                        f"shard {sid} resurrection diverged at the round-"
                        f"{r + 1} snapshot boundary: replayed host-state "
                        "digest does not match the checkpointed one — "
                        "aborting")
        mttr = int((_walltime.monotonic() - self._death_wall) * 1e9)
        self.supervision.count_shard_resurrection(sid, attempt, mttr)

    def _drive_round(self, ws: int, we: int) -> List[tuple]:
        """One conservative round with self-healing: run -> out gather ->
        inbox route -> min gather, any phase surviving a shard death by
        resurrecting and re-driving that shard through the round.  A shard
        whose outbox was already received before it died must reproduce it
        bit-identically after resurrection (the determinism pin).  Records
        the round in the replay history on success."""
        import hashlib
        n = self.n_shards
        run_sent = [False] * n
        outs: Dict[int, list] = {}
        expect_outs: Dict[int, list] = {}
        inboxes: Optional[List[list]] = None
        in_sent = [False] * n
        mins: Dict[int, tuple] = {}
        while True:
            try:
                for sid in range(n):
                    if not run_sent[sid]:
                        self._send(sid, ("run", ws, we))
                        run_sent[sid] = True
                for sid in range(n):
                    if sid not in outs:
                        outs[sid] = self._recv(sid)[1]
                        if sid in expect_outs \
                                and outs[sid] != expect_outs[sid]:
                            raise RuntimeError(
                                f"shard {sid} resurrection diverged: the "
                                "re-driven round's outbox does not match "
                                "what the first life sent — aborting")
                if inboxes is None:
                    inboxes = [[] for _ in range(n)]
                    for s in range(n):
                        for d in range(n):
                            inboxes[d].extend(outs[s][d])
                with self.tracer.span("exchange", "procs", sim_ns=ws):
                    for sid in range(n):
                        if not in_sent[sid]:
                            self._send(sid, ("in", inboxes[sid]))
                            in_sent[sid] = True
                    for sid in range(n):
                        if sid not in mins:
                            mins[sid] = self._recv(sid)
                break
            except ShardDeadError as e:
                sid = self._heal_or_raise(e)
                # re-drive the resurrected shard through THIS round from
                # the top; everything it already delivered is cross-checked
                run_sent[sid] = False
                if sid in outs:
                    expect_outs[sid] = outs.pop(sid)
                in_sent[sid] = False
                mins.pop(sid, None)
        out_sigs = [hashlib.sha256(repr(outs[s]).encode()).hexdigest()
                    for s in range(n)]
        mins_list = [mins[s] for s in range(n)]
        self._history.append((ws, we, inboxes, out_sigs, mins_list))
        return mins_list

    def run(self) -> int:
        from ..core.checkpoint import assemble_state, digest_of_state

        log = get_logger()
        n = self.n_shards
        template = getattr(self.options, "data_template", None)
        if template and not os.path.exists(self.options.data_directory):
            import shutil
            shutil.copytree(template, self.options.data_directory)
        self._ctx = mp.get_context("spawn")
        t_start = _walltime.monotonic()
        for sid in range(n):
            self._spawn(sid)
        conns, procs = self.conns, self.procs

        try:
            # boot-phase deaths stay aborts: a shard that cannot even
            # reach its first barrier would die again on respawn
            readies = [self._recv(sid) for sid in range(n)]
            lookahead = readies[0][1]
            end_time = readies[0][2]
            assert all(r[1] == lookahead and r[2] == end_time
                       for r in readies), "shards disagree on lookahead/end"
            mins = [self._recv(sid) for sid in range(n)]
            self._initial = (readies, mins)
            log.message(
                "procs",
                f"starting sharded simulation: {readies[0][3]} hosts over "
                f"{n} processes, lookahead={lookahead / 1e6:.3f} ms, "
                f"end={end_time / 1e9:.1f} s")

            writer = None
            if self.options.checkpoint_interval_sec > 0 \
                    or getattr(self.options,
                               "checkpoint_every_rounds", 0) > 0:
                from ..core.checkpoint import CheckpointWriter
                writer = CheckpointWriter(
                    self.options.checkpoint_interval_sec,
                    self.options.checkpoint_dir,
                    getattr(self.options, "checkpoint_every_rounds", 0))
            resume_snap = None
            if getattr(self.options, "resume_path", None):
                from ..core.checkpoint import find_last_good_snapshot
                resume_snap, resolved = find_last_good_snapshot(
                    self.options.resume_path)
                log.message(
                    "procs",
                    f"resuming from {resolved} "
                    f"(t={resume_snap['sim_time_ns'] / 1e9:.3f}s): "
                    "replaying to the snapshot boundary, digest-verified "
                    "there")
            self.metrics.source(
                "procs", lambda: {"procs.rounds": self.rounds_executed,
                                  "procs.shards": n})
            self.metrics.source(
                "supervision",
                lambda: {f"supervision.{k}": v
                         for k, v in self.supervision.summary().items()})
            last_ws = 0
            while True:
                nxt = min(m[1] for m in mins)
                if nxt >= end_time or nxt >= stime.SIM_TIME_MAX:
                    break
                ws, we = nxt, min(nxt + lookahead, end_time)
                with self.tracer.span("round", "procs", sim_ns=ws,
                                      args={"round": self.rounds_executed}):
                    mins = self._drive_round(ws, we)
                last_ws = ws
                if resume_snap is not None \
                        and ws >= resume_snap["sim_time_ns"]:
                    self._verify_resume(ws, resume_snap,
                                        sum(m[2] for m in mins))
                    resume_snap = None
                # parent-assembled checkpoint at the same boundaries the
                # serial CheckpointWriter uses (shared due()/path_for
                # cadence, BEFORE the round counter increments — so
                # snapshot names and digests line up with a serial run)
                if writer is not None \
                        and writer.due(ws, self.rounds_executed):
                    with self.tracer.span("checkpoint.write", "procs",
                                          sim_ns=ws):
                        self._write_checkpoint(ws, sum(m[2] for m in mins),
                                               writer)
                self.rounds_executed += 1
                if self._metrics_writer is not None:
                    self._metrics_writer.maybe_write(
                        self.metrics, self.rounds_executed, ws)

            if resume_snap is not None:
                from ..core.checkpoint import warn_resume_unreached
                warn_resume_unreached(resume_snap, "procs")
            finals = self._gather_finals()
        except BaseException:
            # abnormal termination (shard death, protocol error): export
            # the parent's own flight-recorder events best-effort so the
            # abort keeps its timeline; shard rings die with their
            # processes — the log dump in the recv handler is their trace
            try:
                if self.tracer.enabled:
                    self.tracer.export()
                if self._metrics_writer is not None:
                    self._metrics_writer.write_summary(
                        self.metrics, self.rounds_executed, 0)
            except Exception:
                pass
            raise
        finally:
            # closing the pipes first unblocks any shard still parked in
            # conn.recv() (EOFError -> exit), so a mid-run failure tears
            # down immediately instead of waiting out join timeouts
            for c in conns:
                try:
                    c.close()
                except Exception:
                    pass
            # straggler sweep: escalate terminate -> grace -> kill and
            # REAP after each step, so a shard that died during quiesce
            # (or wedged ignoring SIGTERM) cannot leave a zombie racing
            # the checkpoint barrier of a subsequent run
            for p in procs:
                p.join(timeout=60)
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)

        host_states: Dict = {}
        for f in finals:
            host_states.update(f["host_states"])
        self.events_executed = sum(f["events"] for f in finals)
        assert all(f["rounds"] == self.rounds_executed for f in finals)
        state = assemble_state(last_ws, self.rounds_executed, host_states,
                               sum(f["pending"] for f in finals))
        self.final_state = state
        self.digest = digest_of_state(state)
        plugin_errors = sum(f["plugin_errors"] for f in finals)

        from ..core.counters import ObjectCounter
        totals = ObjectCounter()
        for f in finals:
            for k, v in f["counters_new"].items():
                totals.count_new(k, v)
            for k, v in f["counters_free"].items():
                totals.count_free(k, v)
        log.message(
            "procs",
            f"sharded simulation finished: {self.rounds_executed} rounds, "
            f"{self.events_executed} events, {n} processes, "
            f"{_walltime.monotonic() - t_start:.3f}s wall")
        if totals.leaks():
            log.message("procs", totals.report())
        self._obs_finish(finals, totals, last_ws)
        log.flush()
        return 1 if plugin_errors else 0

    def _obs_finish(self, finals, totals, last_ws: int) -> None:
        """Merge the shards' observability payloads: flight-recorder rings
        land on per-shard tracks in ONE trace file; metrics scrapes and the
        assembled leak report land in the parent's summary record."""
        if self.tracer.enabled:
            for f in finals:
                self.tracer.ingest(f.get("trace_events") or [],
                                   f.get("trace_epoch"))
                # the merged file's drop count must cover the SHARDS' ring
                # evictions, not just the parent's (no silent truncation)
                self.tracer.dropped += int(f.get("trace_dropped") or 0)
            path = self.tracer.export()
            if path:
                get_logger().message("procs", f"trace written: {path}")
        if self._metrics_writer is not None:
            for key, val in totals.summary().items():
                self.metrics.set_summary_info(key, val)
            self.metrics.set_summary_info(
                "shards", [f.get("metrics", {}) for f in finals])
            self.metrics.set_summary_info(
                "shard_supervision", [f.get("supervision", {})
                                      for f in finals])
            self._metrics_writer.write_summary(self.metrics,
                                               self.rounds_executed,
                                               last_ws)
            get_logger().message(
                "procs",
                f"metrics written: {self._metrics_writer.path} "
                f"({self._metrics_writer.records_written} records)")

    def _collect_assembled(self, ws: int, pending: int) -> Dict:
        """Gather every shard's host states and assemble the canonical
        digestible state (shared by checkpoint writes and resume verify).
        Heal-aware: a shard dying mid-collect is resurrected and re-asked
        (collect is state-neutral, so a re-ask is exact).  Records each
        shard's own host-state digest so a later resurrection replay can
        be digest-verified at this exact boundary."""
        from ..core.checkpoint import assemble_state, digest_of_state
        n = self.n_shards
        sent = [False] * n
        by_sid: Dict[int, Dict] = {}
        while True:
            try:
                for sid in range(n):
                    if not sent[sid]:
                        self._send(sid, ("collect",))
                        sent[sid] = True
                for sid in range(n):
                    if sid not in by_sid:
                        by_sid[sid] = self._recv(sid)[1]
                break
            except ShardDeadError as e:
                sid = self._heal_or_raise(e)
                sent[sid] = False
                by_sid.pop(sid, None)
        self._last_collect_sid_digests = [digest_of_state(by_sid[s])
                                          for s in range(n)]
        host_states: Dict = {}
        for s in range(n):
            host_states.update(by_sid[s])
        return assemble_state(ws, self.rounds_executed, host_states, pending)

    def _gather_finals(self) -> List[Dict]:
        """Heal-aware stop/final gather: a shard dying at the very last
        barrier is resurrected (full-history replay) and re-stopped — its
        final payload is deterministic, so the run still ends digest-clean
        (wall-clock fields differ but are never digested)."""
        n = self.n_shards
        sent = [False] * n
        by_sid: Dict[int, Dict] = {}
        while True:
            try:
                for sid in range(n):
                    if not sent[sid]:
                        self._send(sid, ("stop",))
                        sent[sid] = True
                for sid in range(n):
                    if sid not in by_sid:
                        by_sid[sid] = self._recv(sid)[1]
                break
            except ShardDeadError as e:
                sid = self._heal_or_raise(e)
                sent[sid] = False
                by_sid.pop(sid, None)
        return [by_sid[s] for s in range(n)]

    def _verify_resume(self, ws: int, snap: Dict, pending: int) -> None:
        """--resume under --processes: the shared boundary gate computed
        over the parent-assembled state."""
        from ..core.checkpoint import digest_of_state, verify_resume_boundary
        verify_resume_boundary(
            snap, ws,
            digest_of_state(self._collect_assembled(ws, pending)),
            "procs")
        self.resume_verified = True
        self.supervision.resume_verified = True

    def _write_checkpoint(self, ws: int, pending: int, writer) -> None:
        from ..core.checkpoint import save_state
        state = self._collect_assembled(ws, pending)
        # arm the join-boundary gate: len(self._history) rounds are
        # complete at this barrier; a future resurrection replaying past
        # it must reproduce each shard's digest recorded here
        self._ck_verify[len(self._history)] = \
            list(self._last_collect_sid_digests)
        os.makedirs(self.options.checkpoint_dir, exist_ok=True)
        path = writer.path_for(ws, self.rounds_executed)
        save_state(state, path, {
            "seed": self.options.seed,
            "scheduler_policy": self.options.scheduler_policy,
            # record the EFFECTIVE worker count: every shard runs with
            # workers=0 (see _child_options), whatever the user passed.
            "workers": 0,
            "stop_time_sec": self.options.stop_time_sec,
            "processes": self.n_shards,
        })
        writer.mark_written(ws, self.rounds_executed, path)
        self.checkpoints.append(path)
        get_logger().message("procs", f"checkpoint written: {path}")


def run_sharded(options, config) -> int:
    return ProcsController(options, config).run()
