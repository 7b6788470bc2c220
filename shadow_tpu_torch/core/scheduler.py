"""Scheduler: event queues, round barriers, worker thread pool.

Capability parity with the reference scheduler (core/scheduler/scheduler.c +
the policy vtable scheduler_policy.h:40-51): a policy owns the event-queue
topology (who stores which host's events, who may pop them); the scheduler
drives rounds — conservative time windows [start, end) sized by the topology
lookahead — with barriers between phases (the reference uses 5 CountDownLatch
barriers per round, scheduler.c:35-42).

Policies implemented (slave.c:104-120 name mapping):
  * ``global``        — one queue, single thread (SP_SERIAL_GLOBAL)
  * ``host``          — per-host queues, threads own fixed host sets
  * ``steal``         — per-host queues + work stealing (default)
  * ``thread``        — one queue per worker thread
  * ``threadXthread`` — N×N mailbox queues
  * ``threadXhost``   — per-(thread,host) queues
  * ``tpu``           — per-host queues + device-batched packet hop
                        (parallel/tpu_policy.py)

The causality contract: an event pushed across hosts during a round is
clamped to at least the next round barrier (reference
scheduler_policy_host_steal.c:225-242); with lookahead = min path latency the
clamp never actually fires for packet events, it is a safety net.
"""

from __future__ import annotations

import heapq
import threading
from typing import Dict, List, Optional

from ..utils.count_down_latch import CountDownLatch
from ..utils.pqueue import PriorityQueue
from . import stime
from .event import Event
from .logger import get_logger


class SchedulerPolicy:
    """Vtable equivalent of scheduler_policy.h:40-51."""

    def add_host(self, host, worker_id: int) -> None:
        raise NotImplementedError

    def assigned_hosts(self, worker_id: int) -> List:
        raise NotImplementedError

    def push(self, event: Event, worker_id: int, barrier: int) -> None:
        raise NotImplementedError

    def push_batch(self, events: List[Event], worker_id: int,
                   barrier: int) -> None:
        """Land a pre-built batch of events in one call — the scheduler
        seam for vectorized producers (the device plane's completion-wake
        fold, ISSUE 10).  Policies with per-event side channels (the
        native merged policy's lower_limit) inherit them through push."""
        for ev in events:
            self.push(ev, worker_id, barrier)

    def pop(self, worker_id: int, window_end: int) -> Optional[Event]:
        raise NotImplementedError

    def done(self, event: Event, worker_id: int) -> None:
        """Called by the worker after executing a popped event (lets policies
        that migrate hosts know the host's state is no longer in use)."""

    def next_time(self) -> int:
        """Min event time across all queues (for the next round window)."""
        raise NotImplementedError

    def pending_count(self) -> int:
        """Total queued events (round-boundary state digests; called only
        at quiescent points, so unlocked sums are safe)."""
        raise NotImplementedError


class GlobalSinglePolicy(SchedulerPolicy):
    """One global pqueue drained by worker 0 only — the serial total-order
    policy (scheduler_policy_global_single.c).  Locked so stray pushes from
    other threads (e.g. a misconfigured --workers N run) stay safe; pops from
    workers other than 0 return nothing, preserving the serial guarantee."""

    def __init__(self):
        self.queue: PriorityQueue = PriorityQueue()
        self.hosts: List = []
        self._lock = threading.Lock()
        # set by Scheduler when n_workers == 0: the whole simulation runs on
        # one thread, so the queue lock is pure overhead on the hottest path
        self.serial = False

    def add_host(self, host, worker_id: int) -> None:
        self.hosts.append(host)

    def assigned_hosts(self, worker_id: int) -> List:
        return self.hosts if worker_id == 0 else []

    def push(self, event: Event, worker_id: int, barrier: int) -> None:
        if event.dst_host is not event.src_host and event.time < barrier:
            event.time = barrier
        if self.serial:
            self.queue.push(event)
            return
        with self._lock:
            self.queue.push(event)

    def pop(self, worker_id: int, window_end: int) -> Optional[Event]:
        if worker_id != 0:
            return None
        if self.serial:
            return self.queue.pop_before(window_end)
        with self._lock:
            return self.queue.pop_before(window_end)

    def next_time(self) -> int:
        with self._lock:
            key = self.queue.peek_key()
        return key[0] if key is not None else stime.SIM_TIME_MAX

    def pending_count(self) -> int:
        return len(self.queue)


class HostQueuesPolicy(SchedulerPolicy):
    """Per-host locked queues with fixed host->worker assignment — the
    ``host`` policy (scheduler_policy_host_single.c); base for ``steal`` and
    ``tpu``.

    Indexed ready tracking: each worker keeps a lazy min-heap of
    ``(order_key, host_id)`` entries so pop() is O(log hosts) instead of the
    O(hosts) scan the naive layout needs (the reference keeps explicit
    unprocessed/processed host lists for the same reason,
    scheduler_policy_host_steal.c:28-45).  The published-key map records the
    earliest entry each host currently has in ANY heap; a push that lowers a
    queue's minimum publishes a fresh (earlier) entry, so the invariant is:
    every non-empty host queue has an entry with key <= its actual top.
    Entries are validated against the queue top when popped; stale ones are
    discarded (and the live top re-published), which keeps the index exact
    without ever rebuilding it."""

    def __init__(self):
        self._host_queues: Dict[int, PriorityQueue] = {}
        self._host_locks: Dict[int, threading.Lock] = {}
        self._assignment: Dict[int, List] = {}       # worker -> hosts
        self._host_worker: Dict[int, int] = {}       # host id -> worker
        self._create_lock = threading.Lock()         # lazy queue creation
        # Per-host execution locks, held from pop() to done(): a host's
        # events never execute on two threads at once, even across a
        # work-stealing migration (the reference guarantees this with its
        # unprocessed/processed host lists + ordered dual-locking,
        # scheduler_policy_host_steal.c:366-416).
        self._exec_locks: Dict[int, threading.Lock] = {}
        # ready-host index: worker -> heap of (key, hid), plus the earliest
        # published key per host; one lock guards the whole index (pushes
        # already serialize on host locks, and index ops are tiny)
        self._ready_heaps: Dict[int, List] = {}
        self._ready_lock = threading.Lock()
        self._published: Dict[int, tuple] = {}       # hid -> earliest entry key
        # set by Scheduler when n_workers == 0: single-threaded, so host
        # locks, exec locks and the ready-index lock are pure overhead
        self.serial = False

    def pending_count(self) -> int:
        return sum(len(q) for q in self._host_queues.values())

    def _queue_for_host(self, hid: int) -> PriorityQueue:
        q = self._host_queues.get(hid)
        if q is None:
            with self._create_lock:
                q = self._host_queues.get(hid)
                if q is None:
                    self._host_locks[hid] = threading.Lock()
                    self._exec_locks[hid] = threading.Lock()
                    q = self._host_queues[hid] = PriorityQueue()
        return q

    def _publish(self, wid: int, key, hid: int) -> None:
        """Publish 'host hid has pending work, earliest = key' to worker
        wid's ready heap unless an entry at least as early already exists."""
        with self._ready_lock:
            cur = self._published.get(hid)
            if cur is None or key < cur:
                self._published[hid] = key
                heap = self._ready_heaps.get(wid)
                if heap is None:
                    heap = self._ready_heaps[wid] = []
                heapq.heappush(heap, (key, hid))

    def add_host(self, host, worker_id: int) -> None:
        self._queue_for_host(host.id)
        with self._ready_lock:
            self._ready_heaps.setdefault(worker_id, [])
        self._assignment.setdefault(worker_id, []).append(host)
        self._host_worker[host.id] = worker_id

    def assigned_hosts(self, worker_id: int) -> List:
        return self._assignment.get(worker_id, [])

    def push(self, event: Event, worker_id: int, barrier: int) -> None:
        if event.dst_host is not event.src_host and event.time < barrier:
            event.time = barrier
        hid = event.dst_host.id if event.dst_host is not None else -1
        q = self._queue_for_host(hid)
        if self.serial:
            q.push(event)
            top = q.peek_key()
            cur = self._published.get(hid)
            if cur is None or top < cur:
                self._published[hid] = top
                heap = self._ready_heaps.get(0)
                if heap is None:
                    heap = self._ready_heaps[0] = []
                heapq.heappush(heap, (top, hid))
            return
        with self._host_locks[hid]:
            q.push(event)
            top = q.peek_key()
        self._publish(self._host_worker.get(hid, 0), top, hid)

    def _pop_from_heap(self, heap_wid: int, window_end: int) -> Optional[Event]:
        """Pop the earliest runnable event reachable through worker
        ``heap_wid``'s ready heap.  Busy hosts (exec lock held elsewhere)
        are set aside and re-published before returning."""
        heap = self._ready_heaps.get(heap_wid)
        if heap is None:
            return None
        busy: List = []
        result = None
        while True:
            with self._ready_lock:
                if not heap or heap[0][0][0] >= window_end:
                    break
                key, hid = heapq.heappop(heap)
                if self._published.get(hid) == key:
                    del self._published[hid]
            q = self._host_queues[hid]
            exec_lock = self._exec_locks[hid]
            if not exec_lock.acquire(blocking=False):
                # mid-event on another thread; retry it later
                busy.append((key, hid))
                continue
            with self._host_locks[hid]:
                actual = q.peek_key()
                if actual is None:
                    exec_lock.release()
                    continue          # stale entry; queue drained
                if actual[0] >= window_end:
                    exec_lock.release()
                    # live again next round
                    self._publish(self._host_worker.get(hid, heap_wid),
                                  actual, hid)
                    continue
                result = q.pop()
                nxt = q.peek_key()
            if nxt is not None:
                self._publish(self._host_worker.get(hid, heap_wid), nxt, hid)
            break
        for key, hid in busy:
            self._publish(self._host_worker.get(hid, heap_wid), key, hid)
        return result

    def _pop_serial(self, window_end: int) -> Optional[Event]:
        """Single-threaded pop: same index algorithm, no locks."""
        heap = self._ready_heaps.get(0)
        if not heap:
            return None
        published = self._published
        queues = self._host_queues
        while heap:
            key, hid = heap[0]
            if key[0] >= window_end:
                return None
            heapq.heappop(heap)
            if published.get(hid) == key:
                del published[hid]
            q = queues[hid]
            actual = q.peek_key()
            if actual is None:
                continue
            if actual[0] >= window_end:
                cur = published.get(hid)
                if cur is None or actual < cur:
                    published[hid] = actual
                    heapq.heappush(heap, (actual, hid))
                continue
            ev = q.pop()
            nxt = q.peek_key()
            if nxt is not None:
                cur = published.get(hid)
                if cur is None or nxt < cur:
                    published[hid] = nxt
                    heapq.heappush(heap, (nxt, hid))
            return ev
        return None

    def pop(self, worker_id: int, window_end: int) -> Optional[Event]:
        if self.serial:
            return self._pop_serial(window_end)
        return self._pop_from_heap(worker_id, window_end)

    def done(self, event: Event, worker_id: int) -> None:
        """Release the host execution lock taken by pop()."""
        if self.serial:
            return
        hid = event.dst_host.id if event.dst_host is not None else -1
        lk = self._exec_locks.get(hid)
        if lk is not None and lk.locked():
            try:
                lk.release()
            except RuntimeError:  # pragma: no cover - not ours (detached)
                pass

    def next_time(self) -> int:
        """Min pending event time.  Called at quiescent round boundaries
        (workers parked).  Stale entries surfacing at a heap top are dropped
        and the queue's live top re-published until the top entry is exact;
        entries <= the published invariant make the first exact top the true
        global minimum for that heap."""
        t = stime.SIM_TIME_MAX
        for wid, heap in self._ready_heaps.items():
            while heap:
                key, hid = heap[0]
                actual = self._host_queues[hid].peek_key()
                if actual == key:
                    if key[0] < t:
                        t = key[0]
                    break
                heapq.heappop(heap)
                if self._published.get(hid) == key:
                    del self._published[hid]
                if actual is not None:
                    cur = self._published.get(hid)
                    if cur is None or actual < cur:
                        self._published[hid] = actual
                        heapq.heappush(heap, (actual, hid))
        return t


class HostStealPolicy(HostQueuesPolicy):
    """Work stealing on top of per-host queues
    (scheduler_policy_host_steal.c): when a worker's own ready heap is
    drained for this window, it pops directly from other workers' heaps
    (earliest-first) and migrates the host it took (host_migrate :172-196),
    so future pushes for that host land on this worker.  Exclusive execution
    is enforced by the per-host exec locks in the base pop, so a racy
    migration can never run one host on two threads."""

    def __init__(self):
        super().__init__()
        self._steal_lock = threading.Lock()

    def _migrate(self, hid: int, to_worker: int) -> None:
        with self._steal_lock:
            victim = self._host_worker.get(hid)
            if victim is None or victim == to_worker:
                return
            for host in self._assignment.get(victim, []):
                if host.id == hid:
                    self._assignment[victim].remove(host)
                    self._assignment.setdefault(to_worker, []).append(host)
                    break
            self._host_worker[hid] = to_worker

    def pop(self, worker_id: int, window_end: int) -> Optional[Event]:
        ev = self._pop_from_heap(worker_id, window_end)
        if ev is not None:
            return ev
        # steal from the victim whose earliest entry is oldest; snapshot the
        # heap tops under the index lock (concurrent pops mutate the heaps)
        with self._ready_lock:
            tops = [(heap[0], wid)
                    for wid, heap in self._ready_heaps.items()
                    if wid != worker_id and heap]
        for _top, wid in sorted(tops):
            ev = self._pop_from_heap(wid, window_end)
            if ev is not None:
                hid = ev.dst_host.id if ev.dst_host is not None else -1
                self._migrate(hid, worker_id)
                return ev
        return None


class ThreadSinglePolicy(SchedulerPolicy):
    """One locked queue per worker thread
    (scheduler_policy_thread_single.c): all events for a worker's hosts land
    in that worker's single queue."""

    def __init__(self):
        self._queues: Dict[int, PriorityQueue] = {}
        self._locks: Dict[int, threading.Lock] = {}
        self._assignment: Dict[int, List] = {}
        self._host_worker: Dict[int, int] = {}
        # guards lazy queue/mailbox CREATION: a first-push from worker A
        # while worker B iterates the dict raised "dictionary changed
        # size during iteration" (fuzz-era flake); iterations below also
        # snapshot via list() (atomic under the GIL) so a racing create
        # can never invalidate a live iterator
        self._create_lock = threading.Lock()

    def add_host(self, host, worker_id: int) -> None:
        self._assignment.setdefault(worker_id, []).append(host)
        self._host_worker[host.id] = worker_id
        if worker_id not in self._queues:
            with self._create_lock:
                if worker_id not in self._queues:
                    self._locks[worker_id] = threading.Lock()
                    self._queues[worker_id] = PriorityQueue()

    def assigned_hosts(self, worker_id: int) -> List:
        return self._assignment.get(worker_id, [])

    def _queue_for(self, event: Event) -> int:
        hid = event.dst_host.id if event.dst_host is not None else -1
        return self._host_worker.get(hid, 0)

    def push(self, event: Event, worker_id: int, barrier: int) -> None:
        if event.dst_host is not event.src_host and event.time < barrier:
            event.time = barrier
        w = self._queue_for(event)
        if w not in self._queues:
            with self._create_lock:
                if w not in self._queues:
                    # lock first: anyone who can see the queue key must
                    # be able to take its lock
                    self._locks[w] = threading.Lock()
                    self._queues[w] = PriorityQueue()
        with self._locks[w]:
            self._queues[w].push(event)

    def pop(self, worker_id: int, window_end: int) -> Optional[Event]:
        q = self._queues.get(worker_id)
        if q is None:
            return None
        with self._locks[worker_id]:
            key = q.peek_key()
            if key is None or key[0] >= window_end:
                return None
            return q.pop()

    def next_time(self) -> int:
        t = stime.SIM_TIME_MAX
        for w, q in list(self._queues.items()):
            with self._locks[w]:
                key = q.peek_key()
            if key is not None:
                t = min(t, key[0])
        return t

    def pending_count(self) -> int:
        return sum(len(q) for q in list(self._queues.values()))


class ThreadPerThreadPolicy(ThreadSinglePolicy):
    """N×N mailboxes (scheduler_policy_thread_perthread.c): queue (i,j)
    holds events pushed by worker i for worker j's hosts, so at most two
    threads ever contend on a queue."""

    def __init__(self):
        super().__init__()
        self._mailboxes: Dict[tuple, PriorityQueue] = {}
        self._mlocks: Dict[tuple, threading.Lock] = {}

    def pending_count(self) -> int:
        return (sum(len(q) for q in list(self._queues.values()))
                + sum(len(q) for q in list(self._mailboxes.values())))

    def push(self, event: Event, worker_id: int, barrier: int) -> None:
        if event.dst_host is not event.src_host and event.time < barrier:
            event.time = barrier
        dst_worker = self._queue_for(event)
        key = (worker_id, dst_worker)
        if key not in self._mailboxes:
            with self._create_lock:
                if key not in self._mailboxes:
                    self._mlocks[key] = threading.Lock()
                    self._mailboxes[key] = PriorityQueue()
        with self._mlocks[key]:
            self._mailboxes[key].push(event)

    def pop(self, worker_id: int, window_end: int) -> Optional[Event]:
        best_key, best_mb = None, None
        for (src, dst), q in list(self._mailboxes.items()):
            if dst != worker_id:
                continue
            with self._mlocks[(src, dst)]:
                key = q.peek_key()
            if key is not None and key[0] < window_end and (
                    best_key is None or key < best_key):
                best_key, best_mb = key, (src, dst)
        if best_mb is None:
            return None
        with self._mlocks[best_mb]:
            return self._mailboxes[best_mb].pop()

    def next_time(self) -> int:
        t = stime.SIM_TIME_MAX
        for key, q in list(self._mailboxes.items()):
            with self._mlocks[key]:
                k = q.peek_key()
            if k is not None:
                t = min(t, k[0])
        return t


class ThreadPerHostPolicy(SchedulerPolicy):
    """Per-(thread, src-host) mailboxes + one main queue per thread
    (scheduler_policy_thread_perhost.c:1-258): a push whose destination host
    belongs to the pushing thread goes straight into that thread's main
    queue (:131-134); a cross-thread push lands in the destination thread's
    per-source-host mailbox (:141-148, locked only when the pusher isn't the
    destination thread); mailboxes are drained into the main queues at round
    boundaries (:194-206 getNextTime), so during a round each worker pops
    its main queue with zero cross-thread contention."""

    def __init__(self):
        self._main: Dict[int, PriorityQueue] = {}
        self._main_locks: Dict[int, threading.Lock] = {}
        self._mailboxes: Dict[tuple, PriorityQueue] = {}  # (dst_wid, src_hid)
        self._mbox_locks: Dict[int, threading.Lock] = {}  # per dst wid
        self._assignment: Dict[int, List] = {}
        self._host_worker: Dict[int, int] = {}
        self._create_lock = threading.Lock()

    def _ensure_worker(self, wid: int) -> None:
        if wid not in self._main:
            with self._create_lock:
                if wid not in self._main:
                    self._main_locks[wid] = threading.Lock()
                    self._mbox_locks[wid] = threading.Lock()
                    self._main[wid] = PriorityQueue()

    def add_host(self, host, worker_id: int) -> None:
        self._ensure_worker(worker_id)
        self._assignment.setdefault(worker_id, []).append(host)
        self._host_worker[host.id] = worker_id

    def assigned_hosts(self, worker_id: int) -> List:
        return self._assignment.get(worker_id, [])

    def push(self, event: Event, worker_id: int, barrier: int) -> None:
        src_hid = event.src_host.id if event.src_host is not None else -1
        dst_hid = event.dst_host.id if event.dst_host is not None else -1
        src_wid = self._host_worker.get(src_hid, worker_id)
        dst_wid = self._host_worker.get(dst_hid, 0)
        # inter-thread events are delayed to the barrier for causality
        # (thread_perhost.c:120-124 clamps when the threads differ)
        if src_wid != dst_wid and event.time < barrier:
            event.time = barrier
        self._ensure_worker(dst_wid)
        if dst_wid == worker_id:
            with self._main_locks[dst_wid]:
                self._main[dst_wid].push(event)
            return
        with self._mbox_locks[dst_wid]:
            key = (dst_wid, src_hid)
            mb = self._mailboxes.get(key)
            if mb is None:
                mb = self._mailboxes[key] = PriorityQueue()
            mb.push(event)

    def pop(self, worker_id: int, window_end: int) -> Optional[Event]:
        q = self._main.get(worker_id)
        if q is None:
            return None
        with self._main_locks[worker_id]:
            key = q.peek_key()
            if key is None or key[0] >= window_end:
                return None
            return q.pop()

    def _drain_mailboxes(self) -> None:
        """Between rounds (quiescent): empty every mailbox into its
        destination thread's main queue (thread_perhost.c:194-206)."""
        for (dst_wid, _src), mb in self._mailboxes.items():
            q = self._main[dst_wid]
            while True:
                ev = mb.pop()
                if ev is None:
                    break
                q.push(ev)

    def next_time(self) -> int:
        self._drain_mailboxes()
        t = stime.SIM_TIME_MAX
        for wid, q in self._main.items():
            key = q.peek_key()
            if key is not None and key[0] < t:
                t = key[0]
        return t

    def pending_count(self) -> int:
        return (sum(len(q) for q in self._main.values())
                + sum(len(mb) for mb in self._mailboxes.values()))


def make_policy(name: str, n_workers: int = 0) -> SchedulerPolicy:
    if name == "global":
        return GlobalSinglePolicy()
    if name == "host":
        return HostQueuesPolicy()
    if name == "steal":
        return HostStealPolicy()
    if name == "thread":
        return ThreadSinglePolicy()
    if name == "threadXthread":
        return ThreadPerThreadPolicy()
    if name == "threadXhost":
        return ThreadPerHostPolicy()
    if name == "tpu":
        # storage layout follows the execution mode: the single global
        # queue for serial runs (per-host queues cost a min-scan per pop
        # for no benefit without threads), per-host queues when workers
        # pop in parallel
        if n_workers == 0:
            from ..parallel.tpu_policy import TPUSerialPolicy
            return TPUSerialPolicy()
        from ..parallel.tpu_policy import TPUPolicy
        return TPUPolicy()
    raise ValueError(f"unknown scheduler policy {name!r}")


def shuffle_permutation(n: int, seed_key: int):
    """The seeded Fisher-Yates permutation of range(n) as an index array.
    The swap draws are the sequential stream ``next_int(i+1)`` for
    i = n-1..1 — evaluated as ONE vectorized threefry call (counter c for
    the c-th draw), bitwise identical to RandomSource's scalar chain."""
    import numpy as np
    from .rng import bits64_np, derive
    idx = np.arange(n, dtype=np.int64)
    if n < 2:
        return idx
    key = derive(seed_key, "host-shuffle")
    counters = np.arange(n - 1, dtype=np.uint64)
    bounds = np.arange(n, 1, -1, dtype=np.uint64)     # i+1 for i=n-1..1
    draws = bits64_np(key, counters) % bounds
    for k, i in enumerate(range(n - 1, 0, -1)):
        j = int(draws[k])
        idx[i], idx[j] = idx[j], idx[i]
    return idx


def shuffle_hosts(hosts: List, seed_key: int) -> List:
    """Deal order for finalize_hosts: ``hosts`` permuted by the seeded
    Fisher-Yates index array."""
    perm = shuffle_permutation(len(hosts), seed_key)
    return [hosts[int(i)] for i in perm]


class Scheduler:
    """Drives rounds over worker threads (serial when n_workers == 0)."""

    def __init__(self, engine, policy_name: str, n_workers: int, seed_key: int):
        self.engine = engine
        self.policy_name = policy_name
        self.n_workers = max(0, n_workers)
        self.n_threads = max(1, self.n_workers)
        if self.n_workers == 0 and policy_name == "steal":
            # reference falls back to a serial queue for 0 workers
            # (scheduler.c:139-142)
            policy_name = "global"
            self.policy_name = "global"
        self.policy = make_policy(policy_name, self.n_workers)
        if self.n_workers == 0 and isinstance(
                self.policy, (GlobalSinglePolicy, HostQueuesPolicy)):
            self.policy.serial = True
        self.seed_key = seed_key
        self.window_start = 0
        self.window_end = 1
        self._next_host_worker = 0
        self._host_count = 0
        self._pending_hosts: List = []
        self._hosts_finalized = False
        self._late_add_lock = threading.Lock()
        self._running = True
        self._threads: List[threading.Thread] = []
        self._workers: List = []
        self._round_start_latch: Optional[CountDownLatch] = None
        self._round_done_latch: Optional[CountDownLatch] = None

    # -- host assignment (scheduler.c:437-531 random shuffle) --------------
    def add_host(self, host) -> None:
        """Hosts registered before finalize_hosts() are collected and dealt
        to workers in seeded-shuffle order at boot.  A host added after
        boot — a HostTable row materializing on first need — is dealt
        round-robin from the cursor, serialized by a lock because a
        mid-round promote-on-lookup runs on whichever worker thread's
        packet reached the quiet row first.  Late-assignment order is
        therefore arrival order, exactly like a work-stealing migration:
        it moves load balance only, never results (state digests are
        assignment-independent — the cross-policy parity gates and the
        threaded table-parity test pin that)."""
        if self._hosts_finalized:
            with self._late_add_lock:
                self._assign(host)
            return
        self._pending_hosts.append(host)

    def _assign(self, host) -> None:
        wid = self._next_host_worker
        self._next_host_worker = (self._next_host_worker + 1) % self.n_threads
        self.policy.add_host(host, wid)
        self._host_count += 1

    def finalize_hosts(self) -> None:
        """Commit the host->worker assignment: a Fisher-Yates shuffle keyed
        off the simulation seed (the reference shuffles its host list with
        the scheduler RNG before dealing round-robin, scheduler.c:437-472),
        so no adversarial config ordering can pile heavy hosts onto one
        worker.  Deterministic: same seed, same assignment — and the final
        state digest is assignment-independent anyway (the cross-policy
        parity gates pin that), so the shuffle affects load balance only.

        The shuffle operates on a host-ID ARRAY with all swap indices
        drawn in one vectorized threefry call — bitwise identical to the
        sequential next_int chain it replaces (tests/test_scale.py pins
        the permutation AND the per-seed digest), but a 100k-host boot no
        longer permutes a Python list of Host objects through 100k scalar
        cipher evaluations."""
        if self._hosts_finalized:
            return
        self._hosts_finalized = True
        hosts, self._pending_hosts = self._pending_hosts, []
        for host in shuffle_hosts(hosts, self.seed_key):
            self._assign(host)

    # -- push/pop (worker-facing) -----------------------------------------
    def push(self, event: Event, worker) -> None:
        self.policy.push(event, worker.id, self.window_end)

    def pop(self, worker) -> Optional[Event]:
        if not self._running:
            return None
        return self.policy.pop(worker.id, self.window_end)

    def event_done(self, event: Event, worker) -> None:
        self.policy.done(event, worker.id)

    def next_event_time(self) -> int:
        """Min pending host-side event time: the policy's queues, the
        native C heap (folded inside the merged policy), and — under the
        scale tier — the host table's earliest boot wake, so windows land
        on the same boundaries whether a host is an object or a row."""
        t = self.policy.next_time()
        table = getattr(self.engine, "host_table", None)
        if table is not None:
            wake = table.next_wake()
            if wake < t:
                t = wake
        return t

    def pending_count(self) -> int:
        """Queued events + the host table's deferred boot events (events
        an eager boot would already hold in queues for still-quiet rows)
        — the digest's pending_events field must not depend on which
        boot path ran."""
        n = self.policy.pending_count()
        table = getattr(self.engine, "host_table", None)
        if table is not None:
            n += table.pending_boot_events()
        return n

    def set_window(self, start: int, end: int) -> None:
        """Rebind the current round window.  Used by the device plane's
        superwindow collect to align the engine's bookkeeping with the
        virtual round a multi-round kernel launch actually reached (the
        kernel may halt at an earlier negotiated boundary on a completion
        — parallel/device_plane.py consume())."""
        self.window_start = start
        self.window_end = end

    def stop(self) -> None:
        self._running = False

    @property
    def is_running(self) -> bool:
        return self._running
