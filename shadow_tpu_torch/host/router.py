"""Upstream router with pluggable queue management (AQM).

Capability of the reference's Router (host/router.c) + its three queue
managers: the router models the host's upstream ISP buffer on the receive
side.  Arriving packets are enqueued (the AQM may drop); the network
interface dequeues while it has bandwidth tokens.

Queue disciplines (vtable router.c:26-37):
  * codel  — RFC 8289 CoDel AQM (default; router_queue_codel.c)
  * single — one-packet buffer (router_queue_single.c)
  * static — fixed-capacity drop-tail FIFO (router_queue_static.c)
"""

from __future__ import annotations

from collections import deque
from typing import Optional

from ..core.worker import current_worker

# >>> simgen:begin region=router-static spec=293c930bb679 body=424e965b21b5
STATIC_CAPACITY = 1024  # packets (reference router_queue_static.c)
# <<< simgen:end region=router-static


class QueueManager:
    """Interface: enqueue(packet, now) -> bool admitted; dequeue(now) ->
    packet|None; peek() -> packet|None."""

    def enqueue(self, packet, now: int) -> bool:
        raise NotImplementedError

    def dequeue(self, now: int):
        raise NotImplementedError

    def peek(self):
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError


class SingleQueue(QueueManager):
    """1-packet buffer; new arrivals drop while occupied
    (router_queue_single.c)."""

    def __init__(self):
        self._slot = None

    def enqueue(self, packet, now: int) -> bool:
        if self._slot is not None:
            return False
        self._slot = packet
        return True

    def dequeue(self, now: int):
        p, self._slot = self._slot, None
        return p

    def peek(self):
        return self._slot

    def __len__(self):
        return 0 if self._slot is None else 1


class StaticQueue(QueueManager):
    """Fixed-capacity drop-tail FIFO (router_queue_static.c)."""

    def __init__(self, capacity_packets: int = STATIC_CAPACITY):
        self.capacity = capacity_packets
        self._q = deque()

    def enqueue(self, packet, now: int) -> bool:
        if len(self._q) >= self.capacity:
            return False
        self._q.append(packet)
        return True

    def dequeue(self, now: int):
        return self._q.popleft() if self._q else None

    def peek(self):
        return self._q[0] if self._q else None

    def __len__(self):
        return len(self._q)


class CoDelQueue(QueueManager):
    """RFC 8289 Controlled Delay AQM (router_queue_codel.c).

    Parameters match the reference: target sojourn 10 ms, interval 100 ms
    (:34-48); drop-next control law interval/sqrt(count) (:198-205); hard
    size cap to bound memory like the kernel's implementation.
    """

    # >>> simgen:begin region=codel-params spec=293c930bb679 body=eb7dab75d865
    TARGET_NS = 10000000
    INTERVAL_NS = 100000000
    HARD_LIMIT = 1000  # packets
    # <<< simgen:end region=codel-params

    def __init__(self):
        self._q = deque()              # (enqueue_time, packet)
        self.dropping = False
        self.drop_next = 0
        self.drop_count = 0
        self.last_drop_count = 0
        self.total_drops = 0
        self._first_above_time = 0

    def __len__(self):
        return len(self._q)

    def enqueue(self, packet, now: int) -> bool:
        if len(self._q) >= self.HARD_LIMIT:
            self.total_drops += 1
            return False
        self._q.append((now, packet))
        return True

    def peek(self):
        return self._q[0][1] if self._q else None

    def _control_law(self, t: int, count: int) -> int:
        import math
        return t + int(self.INTERVAL_NS / math.sqrt(max(1, count)))

    def _do_dequeue(self, now: int):
        """Returns (packet, ok_to_drop)."""
        if not self._q:
            self._first_above_time = 0
            return None, False
        enq_time, packet = self._q.popleft()
        sojourn = now - enq_time
        if sojourn < self.TARGET_NS or not self._q_has_backlog():
            self._first_above_time = 0
            return packet, False
        if self._first_above_time == 0:
            self._first_above_time = now + self.INTERVAL_NS
            return packet, False
        return packet, now >= self._first_above_time

    def _q_has_backlog(self) -> bool:
        # kernel codel only considers drop when backlog > MTU; approximate
        # with >1 packet queued.
        return len(self._q) >= 1

    def dequeue(self, now: int):
        packet, ok_to_drop = self._do_dequeue(now)
        if packet is None:
            self.dropping = False
            return None
        if self.dropping:
            if not ok_to_drop:
                self.dropping = False
            else:
                while now >= self.drop_next and self.dropping:
                    packet.add_status("ROUTER_DROPPED")
                    self.total_drops += 1
                    self.drop_count += 1
                    packet, ok_to_drop = self._do_dequeue(now)
                    if packet is None:
                        self.dropping = False
                        return None
                    if not ok_to_drop:
                        self.dropping = False
                    else:
                        self.drop_next = self._control_law(self.drop_next, self.drop_count)
        elif ok_to_drop:
            packet.add_status("ROUTER_DROPPED")
            self.total_drops += 1
            packet, _ = self._do_dequeue(now)
            if packet is None:
                return None
            self.dropping = True
            delta = self.drop_count - self.last_drop_count
            self.drop_count = 1
            if delta > 1 and now - self.drop_next < 16 * self.INTERVAL_NS:
                self.drop_count = delta
            self.drop_next = self._control_law(now, self.drop_count)
            self.last_drop_count = self.drop_count
        return packet


def make_queue(kind: str) -> QueueManager:
    if kind == "codel":
        return CoDelQueue()
    if kind == "single":
        return SingleQueue()
    if kind == "static":
        return StaticQueue()
    raise ValueError(f"unknown router queue kind {kind!r}")


class Router:
    """The upstream-ISP attachment point of an interface (router.c)."""

    def __init__(self, queue: QueueManager, interface=None):
        self.queue = queue
        self.interface = interface
        # Staging slot: the AQM's dequeue both drops and returns packets, so
        # the interface peeks the *actual* next deliverable packet here (and
        # charges bandwidth tokens for its true size) before taking it.
        self._staged = None

    def enqueue(self, packet) -> None:
        """Arrival from the internet core (router.c:104-122): AQM admit or
        drop, then nudge the interface to start receiving if this is the
        first buffered packet."""
        iface = self.interface
        if iface is not None:
            now = iface.host.now
        else:
            w = current_worker()
            now = w.now if w is not None else 0
        was_empty = len(self.queue) == 0
        admitted = self.queue.enqueue(packet, now)
        if not admitted:
            packet.add_status("ROUTER_DROPPED")
            return
        if was_empty and self.interface is not None:
            self.interface.on_router_ready()

    def dequeue(self, now: int):
        if self._staged is not None:
            p, self._staged = self._staged, None
            return p
        return self.queue.dequeue(now)

    def peek_deliverable(self, now: int):
        """The next packet that WILL be delivered (AQM drops applied), left
        staged until :meth:`dequeue` takes it.  Lets the interface size its
        token spend to the delivered packet, not a packet the AQM is about
        to drop."""
        if self._staged is None:
            self._staged = self.queue.dequeue(now)
        return self._staged

    def peek(self):
        if self._staged is not None:
            return self._staged
        return self.queue.peek()

    def __len__(self) -> int:
        return len(self.queue) + (1 if self._staged is not None else 0)
