"""Native (C) data plane: glue between the engine and _shadow_dataplane.so.

The C extension (native/dataplane.cc) owns the per-event hot path — TCP/UDP
protocol pipeline, interface token buckets + qdisc, router AQM, protocol
timers, and the inter-host hop — as a faithful C re-expression of this
repo's own Python modules, so a native run produces bit-identical state
digests to a Python-plane run (tests/test_native_dataplane.py pins this).

This module provides:

* :class:`NativeSocket` — the Python descriptor wrapper apps/epoll/process
  blocking interact with; every data operation is one C call.
* :class:`NativePlane` — engine-side owner: host registration, the status
  callback shim (fires Python descriptor listeners at the exact points the
  Python plane fires them, with the worker clock/active-host mirrored so
  wakeup events draw the same sequence ids), digest/tracker access.
* :class:`NativeGlobalPolicy` — the serial scheduler policy that merges the
  C event heap with the Python event queue into one total order: runs of
  consecutive C events execute in a single ``plane.run`` call (no Python
  dispatch per protocol event — the 3x+ events/s lever, VERDICT r4 next
  #1); a Python callback that schedules an earlier Python event shrinks the
  active run's horizon through ``lower_limit``, keeping the merge exact.

Reference analog: the reference runs this loop in C end-to-end
(worker.c:149-216, tcp.c:1121-1278, network_interface.c:421-579); here the
control plane stays Python and only the data plane is native.
"""

from __future__ import annotations

import importlib.util
import os
import subprocess
import time as _walltime
from contextlib import contextmanager
from typing import List, Optional

from ..core import stime
from ..core.logger import get_logger
from ..core.scheduler import GlobalSinglePolicy
from ..core.worker import current_worker

CB_STATUS, CB_CHILD, CB_CLOSED, CB_EPOLL = 0, 1, 2, 3
K_TCP, K_UDP = 0, 1
_SENT_D = -(2 ** 31)
_SENT_Q = -(2 ** 63)

_MOD = None
_MOD_TRIED = False


def _load_module():
    """Import the port's own build of the extension.

    The port builds ``native/dataplane.cc`` into ``shadow_tpu_torch/native/``
    at first use (utils/native_build.py: rebuilt when the source is newer,
    under a lock; never into ``shadow_tpu/native/``, whose tracked binaries
    belong to the JAX package).  ``SHADOW_SANITIZE=address,undefined`` (any
    -fsanitize= spec) selects the sanitizer-instrumented twin
    ``_shadow_dataplane_san.so``, ``SHADOW_SANITIZE=thread`` the
    ThreadSanitizer twin ``_shadow_dataplane_tsan.so``; each is built only
    when asked for.  Loading one into a stock interpreter needs its runtime
    preloaded (LD_PRELOAD=libasan.so / libtsan.so).  A build that fails,
    or an artifact that does not import, leaves the plane unavailable
    (logged): ``--dataplane=native`` then raises, ``auto`` falls back."""
    global _MOD, _MOD_TRIED
    if _MOD_TRIED:
        return _MOD
    _MOD_TRIED = True
    from ..utils import native_build
    san = os.environ.get("SHADOW_SANITIZE", "").strip()
    if san == "thread":
        artifact = "_shadow_dataplane_tsan.so"
    elif san:
        artifact = "_shadow_dataplane_san.so"
    else:
        artifact = "_shadow_dataplane.so"
    try:
        path = native_build.ensure(artifact, sanitize=san)
    except native_build.NativeBuildError as e:
        get_logger().warning("native-plane", str(e))
        return None
    _MOD = _try_import(path)
    return _MOD


def _try_import(path: str):
    """The extension at ``path`` as a module object of its own: its spec
    name is ``_shadow_dataplane`` (its ``PyInit_`` symbol fixes it), and it
    is not put in ``sys.modules``, so the JAX package's extension of the
    same name can live in the same process."""
    try:
        spec = importlib.util.spec_from_file_location("_shadow_dataplane",
                                                      path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
    except Exception as e:  # noqa: BLE001 - reported, the plane stays off
        get_logger().warning("native-plane", f"{path} did not load: {e!r}")
        return None


def native_available() -> bool:
    return _load_module() is not None


def _cc_kinds() -> dict:
    """config-token -> C-plane CcKind id, from the authoritative spec so
    a spec-defined family (cubicx, bbrx) is selectable here with no hand
    edit.  Read as JSON — this module must not import ops.protocol_tables
    (jax import side effect; see tests/test_simgen.py)."""
    import json
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.path.join(pkg, "..", "spec", "protocol_spec.json")
    try:
        with open(path, encoding="utf-8") as f:
            return dict(json.load(f)["congestion"]["kinds"])
    except (OSError, KeyError, ValueError):
        return {"reno": 0, "aimd": 1, "cubic": 2, "cubicx": 3, "bbrx": 4}


_CC_KINDS = _cc_kinds()
_RQ_KINDS = {"codel": 0, "single": 1, "static": 2}


class NativeSocket:
    """Descriptor-API wrapper over one C-plane socket.

    Mirrors the surface SyscallAPI / epoll / the process block-dispatch use
    on TCPSocket/UDPSocket.  Status bits live in C; listener registration
    toggles the C-side ``watched`` flag so unwatched sockets never pay a
    callback."""

    __slots__ = ("plane", "sid", "handle", "host", "kind", "closed",
                 "_listeners", "_nonblock", "unix_path")

    def __init__(self, plane: "NativePlane", sid: int, handle: int, host,
                 kind: str):
        self.plane = plane
        self.sid = sid
        self.handle = handle
        self.host = host
        self.kind = kind
        self.closed = False
        self._listeners: List = []
        self._nonblock = False      # set by the shim's fcntl(O_NONBLOCK)
        self.unix_path = None

    # -- status / listeners (descriptor/base.py) --------------------------
    @property
    def status(self) -> int:
        return self.plane.c.status(self.sid)

    def has_status(self, bits: int) -> bool:
        return (self.plane.c.status(self.sid) & bits) == bits

    def add_listener(self, cb) -> None:
        if cb not in self._listeners:
            self._listeners.append(cb)
            if len(self._listeners) == 1:
                self.plane.c.watch(self.sid, 1)

    def remove_listener(self, cb) -> None:
        if cb in self._listeners:
            self._listeners.remove(cb)
            if not self._listeners:
                self.plane.c.watch(self.sid, 0)

    def _notify(self, changed: int) -> None:
        for cb in list(self._listeners):
            cb(self, changed)

    # -- naming -----------------------------------------------------------
    def _fields(self):
        return self.plane.c.sock_fields(self.sid)

    @property
    def bound_ip(self):
        return self._fields()[3]

    @property
    def bound_port(self):
        return self._fields()[4]

    @property
    def peer_ip(self):
        return self._fields()[5]

    @property
    def peer_port(self):
        return self._fields()[6]

    @property
    def state(self):
        return self._fields()[7]

    @property
    def is_bound(self) -> bool:
        return self._fields()[4] is not None

    @property
    def in_bytes(self) -> int:
        """FIONREAD surface (RPC shim ioctl): buffered input bytes.  The C
        plane tracks the same quantity the Python sockets do (UDP: queued
        datagram bytes incl. headers; TCP: 0 — tcp.py never maintains
        in_bytes, read_bytes is its measure), so parity holds exactly."""
        return self.plane.c.sock_state(self.sid)[6]

    # -- buffer sizes (RPC shim setsockopt/getsockopt) --------------------
    @property
    def send_buf_size(self) -> int:
        return self.plane.c.buf_sizes(self.sid)[0]

    @send_buf_size.setter
    def send_buf_size(self, v: int) -> None:
        self.plane.c.set_buf_size(self.sid, 0, int(v))

    @property
    def recv_buf_size(self) -> int:
        return self.plane.c.buf_sizes(self.sid)[1]

    @recv_buf_size.setter
    def recv_buf_size(self, v: int) -> None:
        self.plane.c.set_buf_size(self.sid, 1, int(v))

    # -- data/user API (SyscallAPI surface) -------------------------------
    def bind_native(self, ip: int, port: int, wildcard: bool) -> int:
        return self.plane.c.bind(self.sid, ip, port, 1 if wildcard else 0)

    def connect_to(self, dst_ip: int, dst_port: int) -> bool:
        return self.plane.c.connect(self.sid, dst_ip, dst_port,
                                    self.host.now)

    def take_socket_error(self) -> Optional[str]:
        return self.plane.c.take_error(self.sid)

    def listen(self, backlog: int = 128) -> None:
        self.plane.c.listen(self.sid, backlog)

    def accept_child(self) -> Optional["NativeSocket"]:
        r = self.plane.c.accept(self.sid, self.host.now)
        if r is None:
            return None
        cid = r[0]
        return self.plane.wrappers[cid]

    def send_user_data(self, data, dst_ip: int = 0, dst_port: int = 0) -> int:
        return self.plane.c.send(self.sid, data, dst_ip, dst_port,
                                 self.host.now)

    def receive_user_data(self, nbytes: int):
        return self.plane.c.recv(self.sid, nbytes, self.host.now)

    def peek_user_data(self, nbytes: int):
        return self.plane.c.peek(self.sid, nbytes)

    def shutdown(self, how: int) -> None:
        self.plane.c.shutdown(self.sid, how, self.host.now)

    def close(self) -> None:
        self.plane.c.close(self.sid, self.host.now)

    # -- digest (core/checkpoint.py _socket_state) ------------------------
    def digest_tuple(self) -> tuple:
        return self.plane.c.sock_state(self.sid)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"NativeSocket(fd={self.handle}, kind={self.kind})"


class ContinuationLedger:
    """Green-thread continuation ledger (ISSUE 12): the Python side of the
    batched continuation plane.

    Every suspended-plugin wake — sleep expiry, descriptor-block
    satisfaction/timeout, device-flow completion, coalesced process
    continue — lives as ONE C-heap event (``EV_PY_CONT``) carrying an index
    into this table, instead of a Python Task+Event through the scheduler
    queue.  The C round executor delivers *runs* of consecutive
    continuations through one ``py_exec_batch`` callback (``pop_cont``
    re-checks the total order every step, so the run is exactly as long as
    the per-event order allows); the per-event path (`cont_cb`, used by the
    demoted pop loop) delivers the same entries one callback each.  Wakes
    the C plane decides itself (socket-block waiters) arrive through
    ``take_fired`` and are applied before any resume, preserving the
    fire-before-continue ordering of the retired Python listener closures.

    Delivery order is the event total order: at equal times that is
    (host id, per-host sequence) — i.e. host-id order across processes and
    wake order within one, with each process's threads resumed in creation
    order by ``continue_`` — the deterministic drain the batched plane
    pins against the per-event path."""

    __slots__ = ("plane", "entries", "_free")

    def __init__(self, plane: "NativePlane"):
        self.plane = plane
        self.entries: List = []
        self._free: List[int] = []

    def add(self, entry) -> int:
        if self._free:
            cid = self._free.pop()
            self.entries[cid] = entry
        else:
            cid = len(self.entries)
            self.entries.append(entry)
        return cid

    def free(self, cid: int) -> None:
        self.entries[cid] = None
        self._free.append(cid)

    def apply_fired(self) -> None:
        """Apply every C-decided block wake (sock waiters satisfied at
        status-change time): set the woken thread's resume value + state.
        The owning process's coalesced continue event was pushed by C at
        fire time, so application is pure bookkeeping — it must happen
        before ANY continuation resumes (a timeout event ordered before
        the continue must observe the disarm)."""
        fired = self.plane.c.take_fired()
        if fired is None:
            return
        from ..process.process import BLOCKED, RUNNABLE
        for cid in fired:
            e = self.entries[cid]
            self.free(cid)
            if e is None:
                continue
            _kind, _host, _process, thread, box = e
            if not box[0]:
                continue
            box[0] = False
            if thread.state == BLOCKED:
                thread.wake_value = True
                thread.state = RUNNABLE
                thread._unblock_cb = None

    def deliver(self, cid: int, t: int) -> None:
        """Execute one continuation event: mirror the worker/host context
        exactly as ``Event.execute`` would, then resume.  Simulation-side
        exceptions are marked (plane.sim_exc) so the round executor's
        demotion guard re-raises them untouched."""
        self.apply_fired()
        e = self.entries[cid]
        kind = e[0]
        host = e[1]
        w = current_worker()
        if w is not None:
            w.now = t
            w.active_host = host
        host.now = t
        try:
            if kind == "continue":
                # persistent per-process entry (never freed); C cleared the
                # coalescing flag before delivery
                e[2]._continue_now()
                return
            self.free(cid)
            from ..process.process import BLOCKED, RUNNABLE
            if kind == "wake":
                # sleep expiry: the wake IS the continue
                _k, _h, process, thread = e
                if thread.state == BLOCKED:
                    thread.state = RUNNABLE
                    thread._unblock_cb = None
                process._continue_now()
            elif kind == "timeout":
                # block timeout: lost the race iff the box was disarmed
                _k, _h, process, thread, box, sid, block_cid, cancel = e
                if not box[0]:
                    return
                box[0] = False
                if sid is not None:
                    self.plane.c.sock_unblock(sid, block_cid)
                    self.free(block_cid)
                elif cancel is not None:
                    cancel()
                if thread.state == BLOCKED:
                    thread.wake_value = False
                    process._wake_thread(thread)
            elif kind == "device":
                # device-flow completion (device_plane._device_wake_task
                # semantics): resume the joining client directly
                _k, _h, dplane, circuit, waiter = e
                if waiter is None:
                    waiter = dplane._waiters.pop(circuit, None)
                if waiter is None or circuit in dplane._woken:
                    return
                dplane._woken.add(circuit)
                process, thread = waiter
                thread.wake_value = dplane._done[circuit]
                if thread.state == BLOCKED:
                    thread.state = RUNNABLE
                    thread._unblock_cb = None
                    process._continue_now()
            else:  # pragma: no cover - ledger corruption is a plane bug
                raise RuntimeError(f"unknown continuation kind {kind!r}")
        except BaseException as exc:
            self.plane.sim_exc = exc
            raise
        finally:
            if w is not None:
                w.active_host = None


class NativeGlobalPolicy(GlobalSinglePolicy):
    """Serial global policy merging the C event heap into the total order.

    Two dispatch paths over the SAME total order:

    * the **C round executor** (``run_window``, ISSUE 10): one extension
      call drives the whole window — C events execute natively, Python
      events through one ``py_exec`` callback each.  The default.
    * the **per-event pop loop** (``pop``): the pre-executor merge, kept
      as the permanent demotion target — a round-executor failure finishes
      its window here (events are atomic and both paths execute the
      identical order, so the hand-off is exact) and stays here.
    """

    def __init__(self, plane: "NativePlane"):
        super().__init__()
        self._plane = plane
        self.serial = True
        # native-plane call spans (ISSUE 3): bound ONCE at construction —
        # the traced wrapper only exists when the run is traced, so the
        # untraced hot path pays nothing (c.run is called per pop-loop
        # leg, far too hot for a per-call enabled check)
        from ..obs.trace import get_tracer
        self._tracer = get_tracer()
        self._run_c = self._run_c_traced if self._tracer.enabled \
            else plane.c.run
        # round-executor state (ISSUE 10): window count for metrics, the
        # demotion latch, and the deterministic fault countdown
        # (--fault-inject native-round:N)
        self.round_windows = 0
        self.round_demoted = False
        # recovery-ladder re-promotion (ISSUE 17): after --repromote-after
        # clean per-event windows the executor is re-attempted ONCE; a
        # second failure re-demotes permanently (the one-shot latch)
        self._repromote_after = int(
            getattr(plane.engine.options, "repromote_after", 0) or 0)
        self._probation_clean = 0
        self.round_repromoted = False
        self._py_exc = None
        from ..core.supervision import parse_fault_inject
        fault = parse_fault_inject(
            getattr(plane.engine.options, "fault_inject", "") or "")
        self._fault_countdown = fault["window"] \
            if fault and fault["kind"] == "native-round" else 0
        # --fault-inject continuation-batch:N — the Nth py_exec_batch call
        # raises, drilling demotion to the per-event pop loop (where
        # continuations deliver one cont_cb each)
        self._cont_fault_countdown = fault["batch"] \
            if fault and fault["kind"] == "continuation-batch" else 0

    def _run_c_traced(self, t, d, s, q) -> None:
        with self._tracer.span("native.run", "native", sim_ns=int(t)):
            self._plane.c.run(t, d, s, q)

    def _batch_drilled(self) -> int:
        """drain_cont_batch wrapped in the continuation-batch:N countdown
        (--fault-inject): the Nth batch delivery raises, and the window
        finishes on the per-event pop loop — the drilled demotion target."""
        self._cont_fault_countdown -= 1
        if self._cont_fault_countdown == 0:
            raise RuntimeError("fault injection: continuation batch")
        return self._plane.drain_cont_batch()

    def run_window(self, worker, window_end) -> bool:
        """Execute the whole window via the C round executor.  Returns
        False when demoted (caller falls back to the per-event loop, which
        also FINISHES a window the executor failed partway through)."""
        if worker.id != 0:
            return False
        if self.round_demoted:
            # probation clock (ISSUE 17): each window the per-event loop
            # completes cleanly counts; at the threshold the executor is
            # re-attempted once — the hand-off is exact in both
            # directions (both paths execute the identical total order),
            # so the climb back is as safe as the demotion was
            if self._repromote_after > 0 and not self.round_repromoted \
                    and self._probation_clean >= self._repromote_after:
                self.round_demoted = False
                self.round_repromoted = True
                self._plane.engine.supervision.count_repromotion(
                    "native round executor", self._probation_clean)
            else:
                self._probation_clean += 1
                return False
        q = self.queue
        we = int(window_end)
        counters = worker.counters
        self._py_exc = None

        def py_exec():
            # invoked by C exactly when the Python top precedes the C heap
            # top: pop THE earliest Python event, execute it, and return
            # the queue's new top key so the C-side mirror stays exact
            ev = q.pop_before(we)
            if ev is None:      # pragma: no cover - mirror guarantees one
                return None
            worker.now = ev.time
            try:
                if ev.execute(worker):
                    worker.last_event_time = ev.time
                    counters.count_free("event")
            except BaseException as e:
                # mark app/event errors so the guard below re-raises them
                # instead of demoting the executor over someone else's bug
                self._py_exc = e
                raise
            return q.peek_key()

        batch = self._batch_drilled if self._cont_fault_countdown > 0 \
            else self._plane.drain_cont_batch
        try:
            if self._fault_countdown > 0:
                self._fault_countdown -= 1
                if self._fault_countdown == 0:
                    raise RuntimeError(
                        "fault injection: native round executor")
            if self._tracer.enabled:
                with self._tracer.span("native.round", "native",
                                       sim_ns=we):
                    self._plane.c.run_window(we, q.peek_key(), py_exec,
                                             batch)
            else:
                self._plane.c.run_window(we, q.peek_key(), py_exec, batch)
        except BaseException as e:
            if e is self._py_exc or e is self._plane.sim_exc \
                    or not isinstance(e, Exception):
                # simulated-app failures propagate exactly as on the
                # per-event path, and KeyboardInterrupt/SystemExit are
                # never the executor's fault — demoting would swallow a
                # Ctrl-C and run the simulation to completion (the device
                # dispatch guard catches Exception only for the same
                # reason)
                raise
            self.round_demoted = True
            self._plane.engine.supervision.count_native_round_demotion(
                repr(e))
            return False        # per-event loop completes this window
        self.round_windows += 1
        return True

    def push(self, event, worker_id: int, barrier: int) -> None:
        if event.dst_host is not event.src_host and event.time < barrier:
            event.time = barrier
        self.queue.push(event)
        # a callback-scheduled Python event may precede the C heap's next
        # event: shrink the active C run's horizon (no-op outside run)
        self._plane.c.lower_limit(*event.order_key())

    def pop(self, worker_id: int, window_end: int):
        if worker_id != 0:
            return None
        c = self._plane.c
        q = self.queue
        while True:
            pk = q.peek_key()
            ck = c.next_key()
            py_ok = pk is not None and pk[0] < window_end
            c_ok = ck is not None and ck[0] < window_end
            if c_ok and (not py_ok or ck < pk):
                # execute the C run up to the next Python event (or the
                # window end); callbacks may add Python events and shrink
                # the horizon, so re-evaluate afterwards
                if py_ok:
                    self._run_c(pk[0], pk[1], pk[2], pk[3])
                else:
                    # int(): window_end inherits float-ness from fractional
                    # <shadow stoptime> configs
                    self._run_c(int(window_end), _SENT_D, _SENT_D, _SENT_Q)
                continue
            if not py_ok:
                return None
            return q.pop_before(window_end)

    def next_time(self) -> int:
        t = super().next_time()
        ck = self._plane.c.next_key()
        if ck is not None and ck[0] < t:
            t = ck[0]
        return t

    def pending_count(self) -> int:
        return len(self.queue) + self._plane.c.pending()


class NativePlane:
    """Engine-side owner of the C data plane."""

    def __init__(self, engine):
        mod = _load_module()
        if mod is None:
            raise RuntimeError("native dataplane extension unavailable "
                               "(make -C native)")
        self.engine = engine
        self.c = mod.Plane()
        self.wrappers: List[Optional[NativeSocket]] = []
        self._synced = {}           # hid -> last-synced C tracker tuple
        self._bulk_rows = None      # hid -> row, inside bulk_sync() only
        self.sim_exc = None         # last simulation-code exception (the
                                    # round-executor guard re-raises these)
        # batched continuation plane (ISSUE 12)
        self.ledger = ContinuationLedger(self)
        self.eps: List = []         # epoll token -> Epoll (readiness cache)
        self.py_exec_batch_calls = 0
        self.continuations_fused = 0    # delivered through py_exec_batch
        self.continuations_single = 0   # delivered per-event (demoted path)
        topo = engine.topology
        opts = engine.options
        lat = topo.latency_ns
        rel = topo.reliability
        cnt = topo.path_packet_counts
        self.c.configure(
            lat.ctypes.data, rel.ctypes.data, cnt.ctypes.data,
            int(lat.shape[0]), int(engine._drop_key),
            int(engine.bootstrap_end), int(engine.end_time),
            _CC_KINDS[getattr(opts, "tcp_congestion_control", "reno")],
            int(getattr(opts, "tcp_ssthresh", 0)),
            int(getattr(opts, "tcp_windows", 10)),
            lat, rel, cnt)
        self.c.set_callback(self._callback)
        self.c.set_cont_callback(self._deliver_cont)
        if engine.shard_count > 1:
            # --processes: finished cross-shard hops land in the engine's
            # outboxes exactly where the Python plane appends them
            # (core/worker.py:129-141); the unused slot keeps the C
            # signature uniform
            def _xshard(t, dst_hid, src_hid, _unused, seq, wire,
                        _eng=engine):
                try:
                    dst = _eng.hosts[dst_hid]
                    _eng.shard_outboxes[_eng.shard_of(dst)].append(
                        (t, dst_hid, src_hid, seq, wire))
                except BaseException as e:
                    # simulation-side failure: the round executor's guard
                    # must PROPAGATE it (same marking as _callback), not
                    # demote-and-continue past a half-executed event
                    self.sim_exc = e
                    raise
            self.c.set_xshard_callback(_xshard)
        self._attach_hosts()

    # -- host registration + counter proxying -----------------------------
    def _attach_hosts(self) -> None:
        from ..routing.address import LOCALHOST_IP
        eng = self.engine
        for hid in sorted(eng.hosts):
            host = eng.hosts[hid]
            p = host.params
            self.c.add_host(
                int(hid), int(host.ip), int(LOCALHOST_IP),
                int(host.topo_row), int(p.bw_down_kibps), int(p.bw_up_kibps),
                1 if p.qdisc == "rr" else 0, _RQ_KINDS[p.router_queue],
                int(p.recv_buf_size), int(p.send_buf_size),
                1 if p.autotune_recv else 0, 1 if p.autotune_send else 0,
                int(host._next_handle), int(host._next_port),
                int(host._event_seq), int(host._packet_counter),
                int(host._packet_priority),
                1 if eng.owns_host(host) else 0,
                _CC_KINDS[p.tcp_cc] if getattr(p, "tcp_cc", None)
                else -1)
            # the per-host deterministic counters move into C so both
            # planes draw from the same sequence space, interleaved exactly
            host.native_plane = self
            host.next_event_sequence = \
                (lambda c=self.c, h=hid: lambda: c.next_seq(h))()
            host.allocate_handle = \
                (lambda c=self.c, h=hid: lambda: c.alloc_handle(h))()
            host.next_packet_uid = \
                (lambda c=self.c, h=hid: lambda: c.next_packet_uid(h))()
            host.next_packet_priority = \
                (lambda c=self.c, h=hid: lambda: c.next_packet_priority(h))()
            host.tracker._native = (self, hid)

    # -- socket creation ---------------------------------------------------
    def create_socket(self, host, kind: str) -> NativeSocket:
        sid, handle = self.c.socket(host.id, K_TCP if kind == "tcp"
                                    else K_UDP)
        w = NativeSocket(self, sid, handle, host, kind)
        while len(self.wrappers) <= sid:
            self.wrappers.append(None)
        self.wrappers[sid] = w
        host.register_descriptor(w)
        return w

    # -- continuation plane (ISSUE 12) -------------------------------------
    def token_for(self, process) -> int:
        """The process's C-side coalescing token (lazily registered with a
        persistent 'continue' ledger entry)."""
        tok = process._cont_token
        if tok is None:
            host = process.host
            cid = self.ledger.add(("continue", host, process))
            tok = self.c.register_proc(host.id, cid)
            process._cont_token = tok
        return tok

    def sched_continue(self, process, now: int) -> None:
        """Coalesced process-continue: ONE EV_PY_CONT in flight per process
        (the C-side mirror of Process._continue_scheduled, shared with the
        C-decided socket-block wakes)."""
        self.c.sched_continue(now, self.token_for(process))

    def push_sleep(self, process, thread, now: int, delay_ns: int) -> None:
        host = process.host
        cid = self.ledger.add(("wake", host, process, thread))
        if self.c.push_cont(now, host.id, delay_ns, cid) is None:
            self.ledger.free(cid)    # past end time: never wakes (parity
                                     # with schedule_task's decline)

    def block_native(self, process, thread, desc, bits: int,
                     timeout_ns: int, now: int) -> bool:
        """Register a C-side socket-block waiter: the wake condition
        (status & (bits|S_CLOSED)) is decided IN C at status-change time,
        with no per-change Python callback.  Returns False when the
        condition already holds (caller resumes synchronously)."""
        host = process.host
        box = [True]
        cid = self.ledger.add(("block", host, process, thread, box))
        tok = self.token_for(process)
        if not self.c.sock_block(desc.sid, bits, cid, tok):
            self.ledger.free(cid)
            return False
        if timeout_ns >= 0:
            tid = self.ledger.add(("timeout", host, process, thread, box,
                                   desc.sid, cid, None))
            if self.c.push_cont(now, host.id, timeout_ns, tid) is None:
                self.ledger.free(tid)
        return True

    def push_block_timeout(self, process, thread, box, now: int,
                           timeout_ns: int, cancel) -> None:
        """Timeout leg for a block on a PYTHON descriptor under the native
        plane: the wake detection stays a Python listener, but the timeout
        event lives in the C heap like every other continuation."""
        host = process.host
        cid = self.ledger.add(("timeout", host, process, thread, box,
                               None, None, cancel))
        if self.c.push_cont(now, host.id, timeout_ns, cid) is None:
            self.ledger.free(cid)

    def push_device_wakes(self, items) -> None:
        """Land a collect's completion wakes in ONE extension call:
        ``items`` = [(when, host, dplane, circuit, waiter), ...] in the
        per-event fold's order, so the C-side per-host sequence claims are
        identical to the retired push_batch Event chain."""
        batch = []
        for when, host, dplane, circuit, waiter in items:
            cid = self.ledger.add(("device", host, dplane, circuit, waiter))
            batch.append((when, host.id, 0, cid))
        self.c.push_cont_batch(batch)

    def ep_token(self, ep) -> int:
        tok = getattr(ep, "_native_tok", None)
        if tok is None:
            tok = len(self.eps)
            self.eps.append(ep)
            ep._native_tok = tok
        return tok

    def _deliver_cont(self, cid: int, t: int) -> None:
        """Per-event continuation delivery (the demoted pop loop / a lone
        continuation executed by plane_exec)."""
        self.continuations_single += 1
        t0 = _walltime.perf_counter_ns()
        try:
            self.ledger.deliver(cid, t)
        finally:
            self.engine.add_plugin_exec_ns(
                _walltime.perf_counter_ns() - t0)

    def drain_cont_batch(self) -> int:
        """The py_exec_batch callback: drain the maximal run of consecutive
        continuations in one C->Python round trip.  ``pop_cont`` re-checks
        the merged total order each step (window horizon, the Python-top
        mirror, AND any C event a resume just scheduled), so the batch ends
        exactly where per-event dispatch would interleave something else.
        Plugin wall is attributed once per batch, not per resume."""
        n = 0
        pop = self.c.pop_cont
        deliver = self.ledger.deliver
        t0 = _walltime.perf_counter_ns()
        try:
            e = pop()
            while e is not None:
                n += 1
                deliver(e[0], e[1])
                e = pop()
        finally:
            self.py_exec_batch_calls += 1
            self.continuations_fused += n
            self.engine.add_plugin_exec_ns(
                _walltime.perf_counter_ns() - t0)
        return n

    # -- callback shim -----------------------------------------------------
    def _callback(self, kind: int, hid: int, t: int, a: int, b: int) -> None:
        """Invoked by C at listener/lifecycle points.  Mirrors the clock and
        active host the way event.execute does, so any task a listener
        schedules gets the same (time, dst, src, seq) tuple as on the
        Python plane."""
        eng = self.engine
        host = eng.hosts[hid]
        w = current_worker()
        prev = (w.now, w.active_host, host.now) if w is not None else None
        if w is not None:
            w.now = t
            w.active_host = host
        host.now = t
        try:
            if kind == CB_STATUS:
                wrap = self.wrappers[a]
                if wrap is not None:
                    wrap._notify(b)
            elif kind == CB_CHILD:
                # a LISTEN socket spawned a child (C allocated its handle):
                # register the wrapper so accept()/digests see it
                child = NativeSocket(self, a, b, host, "tcp")
                while len(self.wrappers) <= a:
                    self.wrappers.append(None)
                self.wrappers[a] = child
                host.register_descriptor(child)
            elif kind == CB_CLOSED:
                wrap = self.wrappers[a]
                if wrap is not None:
                    wrap.closed = True
                    host.descriptor_table_remove(wrap.handle)
            elif kind == CB_EPOLL:
                # C readiness cache delivery: b = (ep_tok << 16) | revents,
                # fired only when the epoll-visible outcome changed
                ep = self.eps[b >> 16]
                wrap = self.wrappers[a]
                if wrap is not None:
                    ep._apply_native_revents(wrap.handle, b & 0xFFFF)
        except BaseException as e:
            # mark simulation-side failures so the round executor's guard
            # PROPAGATES them (a listener/app bug is not the executor's
            # fault and must surface exactly as on the per-event path)
            self.sim_exc = e
            raise
        finally:
            if prev is not None:
                w.now, w.active_host, host.now = prev

    # -- engine integration ------------------------------------------------
    def set_window(self, window_end: int) -> None:
        # window_end inherits float-ness from a fractional <shadow stoptime>
        self.c.set_window(int(window_end))

    def counters(self):
        """(events_scheduled, events_executed, packet_drops, last_time)."""
        return self.c.counters()

    @contextmanager
    def bulk_sync(self):
        """Snapshot EVERY host's C tracker counters in one extension call;
        ``sync_tracker`` calls inside the block read rows from the
        snapshot instead of paying a per-host C round-trip (the ISSUE 7
        vectorized control-plane cut: a 10k-host end-of-run sweep is one
        C call + one numpy reshape, not 10k `c.tracker()` trips)."""
        import numpy as np
        rows = np.frombuffer(self.c.tracker_all(),
                             dtype=np.int64).reshape(-1, 34)
        self._bulk_rows = {int(r[0]): r for r in rows}
        try:
            yield
        finally:
            self._bulk_rows = None

    def sync_tracker(self, hid: int, tracker) -> None:
        """Fold the C plane's counter DELTAS since the last sync into the
        Python tracker.  Additive, not overwriting: other engine components
        (the device-resident traffic plane's per-node byte feed) also add
        into the same Python counters, exactly as on the Python plane."""
        if self._bulk_rows is not None:
            v = tuple(int(x) for x in self._bulk_rows[hid][1:])
        else:
            v = self.c.tracker(hid)
        prev = self._synced.get(hid)
        if prev == v:
            return                  # quiet host: nothing moved since
        self._synced[hid] = v
        names = ("packets_total", "bytes_total", "packets_control",
                 "bytes_control", "packets_data", "bytes_data",
                 "packets_retrans", "bytes_retrans")
        k = 0
        for ctr in (tracker.in_local, tracker.in_remote, tracker.out_local,
                    tracker.out_remote):
            for n in names:
                delta = v[k] - (prev[k] if prev else 0)
                if delta:
                    setattr(ctr, n, getattr(ctr, n) + delta)
                k += 1
        drop_delta = v[k] - (prev[k] if prev else 0)
        if drop_delta:
            tracker.drops += drop_delta

    def iface_digest(self, hid: int) -> dict:
        """{ip: (send_remaining, recv_remaining)} for checkpoint.

        The C plane models exactly two interfaces per host (lo + eth, the
        reference's layout); if the Python host ever grows more, this digest
        would silently omit them and diverge from the Python plane's — fail
        loudly instead."""
        from ..routing.address import LOCALHOST_IP
        host = self.engine.hosts[hid]
        if len(host.interfaces) != 2:
            raise RuntimeError(
                f"native plane: host {host.name!r} has "
                f"{len(host.interfaces)} interfaces; the C plane digests "
                "exactly two (lo + eth) — a topology change here needs a "
                "matching dataplane.cc iface_state extension")
        lo_s, lo_r, eth_s, eth_r = self.c.iface_state(hid)
        return {LOCALHOST_IP: (lo_s, lo_r), host.ip: (eth_s, eth_r)}


def eligible(engine, log_reason: bool = False) -> Optional[str]:
    """None when the native plane can engage; otherwise the blocking reason
    (auto mode logs and falls back; --dataplane=native raises it)."""
    opts = engine.options
    if opts.workers != 0:
        return "threaded run (native plane is serial-only)"
    table = getattr(engine, "host_table", None)
    if table is not None and table.unmaterialized_count() > 0:
        # the C plane registers every host at attach; lazily-materialized
        # table rows would be invisible to it.  Digest parity Python-vs-C
        # is pinned, so the fallback costs speed only.
        return "host table active (lazy hosts; C plane needs all hosts " \
               "at attach)"
    if engine.scheduler.policy_name != "global":
        return (f"policy {engine.scheduler.policy_name!r} "
                "(native plane backs the serial global policy)")
    for host in engine.hosts.values():
        if host.params.log_pcap:
            return "pcap capture enabled"
        if host.cpu is not None and host.cpu.enabled:
            return "host CPU delay model enabled"
    log = get_logger()
    if log.would_log("debug"):
        return "debug logging (per-packet audit trails are Python-plane)"
    if not native_available():
        return "extension not built (make -C native)"
    return None


def attach(engine) -> Optional[NativePlane]:
    """Build the plane, swap in the merging policy, and mark the engine.
    Returns the plane (None when ineligible in auto mode)."""
    mode = getattr(engine.options, "dataplane", "auto")
    if mode == "python":
        return None
    reason = eligible(engine)
    if reason is not None:
        if mode == "native":
            raise RuntimeError(f"--dataplane=native unavailable: {reason}")
        get_logger().message("engine",
                             f"native dataplane off: {reason}")
        return None
    plane = NativePlane(engine)
    # The extension's Plane holds its callbacks strongly and is invisible
    # to the garbage collector, so callbacks bound to the plane would keep
    # the plane, its engine and every host alive forever.  Re-register
    # them through a weak reference: the Plane then holds nothing that
    # leads back, and an engine that ran on the C plane is freed as soon
    # as it is unreachable.
    import weakref
    ref = weakref.ref(plane)

    def _status(kind, hid, t, a, b):
        return ref()._callback(kind, hid, t, a, b)

    def _cont(cid, t):
        return ref()._deliver_cont(cid, t)
    plane.c.set_callback(_status)
    plane.c.set_cont_callback(_cont)
    if engine.shard_count > 1:
        def _xshard(t, dst_hid, src_hid, _unused, seq, wire):
            pl = ref()
            eng = pl.engine
            try:
                dst = eng.hosts[dst_hid]
                eng.shard_outboxes[eng.shard_of(dst)].append(
                    (t, dst_hid, src_hid, seq, wire))
            except BaseException as e:
                # as NativePlane.__init__'s: the round executor's guard
                # must propagate a simulation-side failure
                pl.sim_exc = e
                raise
        plane.c.set_xshard_callback(_xshard)
    policy = NativeGlobalPolicy(plane)
    policy.hosts = engine.scheduler.policy.hosts
    engine.scheduler.policy = policy
    engine.native_plane = plane
    get_logger().message(
        "engine",
        f"native C dataplane engaged: {len(engine.hosts)} hosts "
        "(TCP/UDP pipeline + interface + router + hop in C)")
    return plane
