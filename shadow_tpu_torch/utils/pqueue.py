"""Priority queues for events.

The reference wraps GLib heaps with a membership hash for O(1) find/remove
(utility/priority_queue.c) and a mutexed variant
(utility/async_priority_queue.c).  We build on ``heapq`` with lazy deletion —
removal marks the entry dead; dead entries are skipped on pop.

Hot-path design: the membership hash is replaced by an intrusive slot on the
item itself (``item.pq_entry`` — Event reserves it).  A push that reschedules
an already-queued item invalidates its live entry through the slot instead of
a dict lookup; pops clear the entry's live bit as it leaves the heap.  One
item is in at most one queue at a time (the scheduler policies' invariant —
steal migration pops before re-pushing), which is what makes the single slot
sufficient.
"""

from __future__ import annotations

import heapq
import threading
from typing import Any, Generic, List, Optional, TypeVar

T = TypeVar("T")


class PriorityQueue(Generic[T]):
    """Min-heap keyed by item.order_key() (or an explicit key), with lazy
    removal.  Items must expose a writable ``pq_entry`` attribute."""

    __slots__ = ("_heap", "_count", "_len")

    def __init__(self):
        self._heap: List[list] = []   # [key, tiebreak, item, live, owner]
        self._count = 0               # insertion tiebreak for identical keys
        self._len = 0                 # live entries

    def __len__(self) -> int:
        return self._len

    def push(self, item: T, key=None) -> None:
        if key is None:
            key = item.order_key()
        old = item.pq_entry
        if old is not None and old[3]:
            # re-push = reschedule: kill the stale live entry so one item
            # never has two live entries (the membership hash the
            # reference's priority_queue.c maintains for the same reason).
            # A live entry in ANOTHER queue would mean the one-queue-at-a-
            # time invariant broke upstream; mutating that queue from here
            # would race its lock, so fail loudly instead.  Unconditional
            # (not assert): under python -O a silent violation would corrupt
            # the other queue's _len and skew state digests.
            if old[4] is not self:
                raise RuntimeError("item is live in another queue")
            old[3] = False
            old[2] = None
            self._len -= 1
        entry = [key, self._count, item, True, self]
        self._count += 1
        item.pq_entry = entry
        heapq.heappush(self._heap, entry)
        self._len += 1

    def remove(self, item: T) -> bool:
        entry = getattr(item, "pq_entry", None)
        if entry is None or not entry[3] or entry[4] is not self:
            return False
        entry[3] = False
        entry[2] = None
        self._len -= 1
        return True

    def __contains__(self, item: T) -> bool:
        entry = getattr(item, "pq_entry", None)
        return entry is not None and entry[3] and entry[4] is self

    def _prune(self) -> None:
        heap = self._heap
        while heap and not heap[0][3]:
            heapq.heappop(heap)

    def peek(self) -> Optional[T]:
        self._prune()
        return self._heap[0][2] if self._heap else None

    def peek_key(self):
        self._prune()
        return self._heap[0][0] if self._heap else None

    def pop(self) -> Optional[T]:
        heap = self._heap
        while heap:
            entry = heapq.heappop(heap)
            if entry[3]:
                entry[3] = False
                item = entry[2]
                # Clear both directions of the entry<->item link: the engine
                # runs with cyclic GC disabled, and a dead [.., item, ..] cell
                # still referenced by item.pq_entry is an uncollectable cycle
                # that would pin every executed Event until shutdown.
                entry[2] = None
                item.pq_entry = None
                self._len -= 1
                return item
        return None

    def pop_before(self, time_limit) -> Optional[T]:
        """Pop the min item iff its key's time field (key[0]) < time_limit —
        the scheduler's window-bounded pop in ONE heap pass."""
        heap = self._heap
        while heap:
            entry = heap[0]
            if not entry[3]:
                heapq.heappop(heap)
                continue
            if entry[0][0] >= time_limit:
                return None
            heapq.heappop(heap)
            entry[3] = False
            item = entry[2]
            entry[2] = None          # break the cycle (see pop())
            item.pq_entry = None
            self._len -= 1
            return item
        return None


class AsyncPriorityQueue(PriorityQueue[T]):
    """Mutex-protected variant (reference utility/async_priority_queue.c)."""

    __slots__ = ("_lock",)

    def __init__(self):
        super().__init__()
        self._lock = threading.Lock()

    def __len__(self) -> int:
        with self._lock:
            return super().__len__()

    def push(self, item: T, key=None) -> None:
        with self._lock:
            super().push(item, key)

    def remove(self, item: T) -> bool:
        with self._lock:
            return super().remove(item)

    def peek(self) -> Optional[T]:
        with self._lock:
            return super().peek()

    def peek_key(self):
        with self._lock:
            return super().peek_key()

    def pop(self) -> Optional[T]:
        with self._lock:
            return super().pop()

    def pop_before(self, time_limit) -> Optional[T]:
        with self._lock:
            return super().pop_before(time_limit)
