"""Event: a Task bound to a virtual time, with a total deterministic order.

The causality contract of the whole simulator lives here.  The reference
orders events by the tuple (time, dstHostID, srcHostID, srcHostEventID)
(core/work/event.c:110-153 ``event_compare``); every scheduler policy — and
our batched TPU kernel — must produce executions consistent with that total
order.  We keep the exact same key so CPU/TPU event-order parity can be
checked bit-for-bit.

``event.execute`` also applies the host CPU-delay model before running the
task (reference event.c:65-93): if the destination host's virtual CPU is
"blocked" (accumulated delay above threshold), the event is rescheduled
instead of executed.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple


class Event:
    __slots__ = ("task", "time", "dst_host", "src_host", "sequence",
                 "pq_entry")

    def __init__(self, task, time: int, dst_host, src_host, sequence: int):
        self.task = task
        self.time = time
        self.dst_host = dst_host      # Host object (owns execution context)
        self.src_host = src_host      # Host that scheduled it
        self.sequence = sequence      # per-src-host monotonic event id
        self.pq_entry = None          # intrusive heap slot (utils/pqueue.py)

    def order_key(self) -> Tuple[int, int, int, int]:
        return (self.time,
                self.dst_host.id if self.dst_host is not None else -1,
                self.src_host.id if self.src_host is not None else -1,
                self.sequence)

    def __lt__(self, other: "Event") -> bool:
        return self.order_key() < other.order_key()

    def execute(self, worker) -> bool:
        """Run the task under the destination host's context.

        Returns False if the host CPU model deferred the event (it was
        rescheduled; reference event.c:75-84), True if the task ran.
        """
        host = self.dst_host
        if host is not None:
            cpu = host.cpu
            if cpu is not None:
                cpu.update_time(self.time)
                delay = cpu.get_delay()
                if cpu.is_blocked():
                    # Defer by the pending CPU delay; keep ordering stable by
                    # re-inserting with the same (src,seq) identity.
                    worker.reschedule_event(self, self.time + delay)
                    return False
            host.now = self.time
            worker.active_host = host
            t = self.task
            try:
                t.callback(t.obj, t.arg)   # Task.execute, inlined (hot)
            finally:
                worker.active_host = None
        else:
            t = self.task
            t.callback(t.obj, t.arg)
        return True

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        d = self.dst_host.id if self.dst_host is not None else -1
        return f"Event(t={self.time}, dst={d}, task={self.task.name})"
