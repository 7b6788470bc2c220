"""Worker: the per-thread execution context and event loop.

Capability parity with the reference's Worker (core/worker.c): a thread-local
context holding the clocks (now / last-executed / round barrier), the active
host/process, and the two hot operations:

* :meth:`Worker.schedule_task` — push a task onto the event queue with the
  per-source-host sequence id that completes the deterministic order tuple
  (worker.c:218).
* :meth:`Worker.send_packet` — the inter-host hot path (worker.c:243-304):
  reliability draw → maybe drop; latency lookup → delivery time; push a
  deliver-packet event to the destination host, clamped to the round barrier
  for causality.

Under the ``tpu`` scheduler policy, send_packet instead appends the packet to
the round's device batch; the TPU kernel performs the latency gather +
reliability draw for all packets at once (see ops/round_step.py).  Both paths
use the same counter-based RNG keyed by packet uid, so drops are identical.
"""

from __future__ import annotations

import threading
from typing import Optional

from . import stime
from .event import Event
from .task import Task
from .counters import ObjectCounter
from .logger import get_logger

_tls = threading.local()


def current_worker() -> Optional["Worker"]:
    return getattr(_tls, "worker", None)


def set_current_worker(w: Optional["Worker"]) -> None:
    _tls.worker = w


class Worker:
    def __init__(self, worker_id: int, engine):
        self.id = worker_id
        self.engine = engine                  # Slave-equivalent
        self.scheduler = engine.scheduler
        self.now: int = 0                     # current virtual time
        self.last_event_time: int = 0
        self.round_end: int = stime.SIM_TIME_MAX
        self.active_host = None
        self.active_process = None
        self.counters = ObjectCounter()
        self.min_next_event_time: int = stime.SIM_TIME_MAX

    # -- context -----------------------------------------------------------
    def set_active_host(self, host) -> None:
        self.active_host = host

    @property
    def emulated_now(self) -> int:
        return stime.emulated_from_sim(self.now)

    def is_bootstrapping(self) -> bool:
        """During the bootstrap grace period links are perfectly reliable and
        unthrottled (reference worker.c:445-453, master.c:261-268)."""
        return self.now < self.engine.bootstrap_end

    # -- scheduling --------------------------------------------------------
    def schedule_task(self, task: Task, delay_ns: int, dst_host=None) -> Optional[Event]:
        """Schedule ``task`` on ``dst_host`` (default: active host) after
        ``delay_ns``.  Reference worker.c:218 ``worker_scheduleTask``."""
        if not self.engine.is_running():
            return None
        src_host = self.active_host
        dst_host = dst_host if dst_host is not None else src_host
        t = self.now + max(0, int(delay_ns))
        if t >= self.engine.end_time:
            return None
        seq_owner = src_host if src_host is not None else dst_host
        seq = seq_owner.next_event_sequence() if seq_owner is not None \
            else self.engine.next_global_sequence()
        ev = Event(task, t, dst_host, src_host, seq)
        self.counters.count_new("event")
        self.scheduler.push(ev, self)
        return ev

    def reschedule_event(self, ev: Event, new_time: int) -> None:
        ev.time = int(new_time)
        self.scheduler.push(ev, self)

    # -- the inter-host hot path ------------------------------------------
    def send_packet(self, packet) -> None:
        """Move a packet from its source host toward its destination host.

        Mirrors reference worker.c:243-304: look up path reliability, draw a
        uniform keyed by the packet uid (NOT by execution order), drop or
        schedule delivery at now + latency.  The scheduler policy may clamp
        the delivery time to the next round barrier (causality; reference
        scheduler_policy_host_steal.c:229-242 does this for cross-host pushes).
        """
        if not self.engine.is_running():
            return
        offer = getattr(self.scheduler.policy, "offer_packet", None)
        if offer is not None:
            # tpu policy: defer the hop to the round's batched device step
            offer(packet, self)
            return
        topo = self.engine.topology
        src_ip, dst_ip = packet.src_ip, packet.dst_ip
        reliability = topo.reliability_ip(src_ip, dst_ip)
        # Bootstrap period: force-reliable links.
        if not self.is_bootstrapping() and reliability < 1.0:
            u = self.engine.packet_drop_uniform(packet.uid)
            if u > reliability:
                packet.add_status("INET_DROPPED")
                self.engine.count_packet_drop(packet)
                return
        latency = topo.latency_ns_ip(src_ip, dst_ip)
        packet.add_status("INET_SENT")
        engine = self.engine
        dst_host = engine.host_by_ip(dst_ip)
        if dst_host is None:
            packet.add_status("INET_DROPPED")
            return
        if not engine.owns_host(dst_host):
            # --processes shard boundary: claim the source-host sequence id
            # exactly where the local path would (inside schedule_task), then
            # ship the finished hop to the owner shard; it pushes the
            # delivery event with the identical (time, dst, src, seq) tuple.
            t = self.now + max(0, int(latency))  # schedule_task's normalization
            if t >= engine.end_time:
                return
            src_host = self.active_host
            if src_host is None:
                raise RuntimeError("cross-shard send without an active host")
            seq = src_host.next_event_sequence()
            self.counters.count_new("event")
            engine.shard_outboxes[engine.shard_of(dst_host)].append(
                (t, dst_host.id, src_host.id, seq, packet.to_wire()))
            return
        task = Task(_deliver_packet_task, dst_host, packet, name="deliver_packet")
        self.schedule_task(task, latency, dst_host=dst_host)

    # -- event loop --------------------------------------------------------
    def run_round(self) -> None:
        """Drain this worker's runnable events for the current window
        (reference worker.c:149-216 inner loop; the pop returns None at the
        window end).

        When the scheduler policy exposes a round executor (the native
        merged policy's ``run_window``, ISSUE 10), the WHOLE window is
        driven from one extension call and this loop never spins; the
        per-event loop below remains the fallback — and the continuation
        path when a mid-window executor failure demotes it (both paths
        execute the identical total order, so finishing a half-executed
        window per-event is exact)."""
        sched = self.scheduler
        rw = getattr(sched.policy, "run_window", None)
        if rw is not None and sched.is_running \
                and rw(self, sched.window_end):
            return
        while True:
            ev = self.scheduler.pop(self)
            if ev is None:
                break
            self.now = ev.time
            try:
                if ev.execute(self):
                    self.last_event_time = ev.time
                    self.counters.count_free("event")
                # else: CPU model deferred it — the same Event object was
                # re-pushed with a later time and will be accounted when it
                # actually runs.
            finally:
                # release the host execution lock taken by the policy pop
                self.scheduler.event_done(ev, self)

    def finish(self) -> None:
        self.engine.merge_counters(self.counters)


def _deliver_packet_task(dst_host, packet) -> None:
    """Arrival at the destination: enqueue into the upstream router (CoDel
    admit/drop) which feeds the interface receive loop.  Reference
    worker.c:236-241 ``_worker_runDeliverPacketTask`` → router_enqueue."""
    packet.add_status("ROUTER_ENQUEUED")
    iface = dst_host.interface_for_ip(packet.dst_ip)
    if iface is None:
        packet.add_status("INET_DROPPED")
        return
    if iface.router is not None:
        iface.router.enqueue(packet)
    else:
        iface.push_arrival(packet)
