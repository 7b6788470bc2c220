"""Virtual processes: application code running under the simulated kernel.

The reference runs *real binaries* via LD_PRELOAD interposition + rpth green
threads (host/process.c: 257 process_emu_* syscalls, pth_gctx per process;
SURVEY.md §2.4/§2.7).  The TPU rebuild keeps that capability split in two
planes:

* **Python plugin plane (this module)**: apps are Python generator
  coroutines — the direct analog of rpth green threads under a virtual
  clock.  Every syscall is a ``yield`` to the simulated kernel
  (:class:`SyscallAPI`), which either completes it immediately or suspends
  the green thread until a descriptor status change / timer wakes it —
  exactly the descriptor->epoll->process_continue resumption chain of the
  reference (process.c:1197 process_continue).
* **Native plugin plane** (native/, later rounds): LD_PRELOAD interposer
  for unmodified C binaries speaking the same virtual-kernel API over IPC.

Determinism: threads resume in creation order; all syscall effects happen at
the virtual time of the event that woke them.
"""

from __future__ import annotations

import inspect
import time as _walltime
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..core import stime
from ..core.logger import get_logger
from ..core.task import Task
from ..descriptor.base import S_CLOSED, S_READABLE, S_WRITABLE
from ..core.worker import current_worker
from ..obs.trace import get_tracer

_perf = _walltime.perf_counter_ns

RUNNABLE = "runnable"
BLOCKED = "blocked"
DONE = "done"


class _Syscall:
    """Base class for yielded syscall requests."""
    __slots__ = ()


class _Block(_Syscall):
    """Block until ``desc`` has any of ``bits`` (or is closed), with an
    optional timeout.  Resumes with True if the condition fired, False on
    timeout."""
    __slots__ = ("desc", "bits", "timeout_ns")

    def __init__(self, desc, bits, timeout_ns: int = -1):
        self.desc = desc
        self.bits = bits
        self.timeout_ns = timeout_ns


class _Sleep(_Syscall):
    __slots__ = ("ns",)

    def __init__(self, ns: int):
        self.ns = ns


class _DeviceWait(_Syscall):
    """Block until a device-plane flow completes (parallel/device_plane.py);
    wake_value = the completion sim time ns."""
    __slots__ = ("circuit",)

    def __init__(self, circuit: int):
        self.circuit = circuit


class _Stop(_Syscall):
    __slots__ = ()


class GreenThread:
    _ids = 0

    def __init__(self, process: "Process", gen):
        GreenThread._ids += 1
        self.tid = GreenThread._ids
        self.process = process
        self.gen = gen
        self.state = RUNNABLE
        self.wake_value: Any = None
        self.wake_exception: Optional[BaseException] = None
        self._unblock_cb = None  # cleanup for registered waiters


class Process:
    """A virtual process on a Host (reference process.c capability)."""

    def __init__(self, host, name: str, app_main: Callable, args: List[str],
                 start_time_ns: int, stop_time_ns: int = 0,
                 preload: Optional[str] = None):
        self.host = host
        self.name = name
        # per-process extra LD_PRELOAD libs (reference <process preload=...>)
        self.preload = preload
        self.pid = host.next_process_id()
        self.app_main = app_main
        self.args = args
        self.start_time_ns = start_time_ns
        self.stop_time_ns = stop_time_ns
        self.threads: List[GreenThread] = []
        self.api = SyscallAPI(self)
        self.running = False
        self.exited = False
        self.exit_code: Optional[int] = None
        # set by a watchdog (process/native.py _supervise_kill) when this
        # process was torn down BY DESIGN: the nonzero exit then counts as
        # a supervision recovery, not a plugin error
        self.supervised_kill: Optional[str] = None
        self.return_values: Dict[int, Any] = {}
        self.app_state: Any = None  # apps may park observable state here (tests)
        self._continue_scheduled = False
        self._in_continue = False   # suppress redundant continue events for
                                    # wakes arriving DURING continue_ (the
                                    # running loop rescans — ISSUE 12)
        self._cont_token = None     # C-side coalescing token (native plane)
        # tracer hook bound ONCE at construction (the zero-cost pattern
        # native.run uses): the untraced resume path pays no span
        # construction, no get_tracer lookup, no null context manager
        tracer = get_tracer()
        self._continue_now = self._continue_traced if tracer.enabled \
            else self._continue_fast
        self._tracer = tracer
        self._signal_fds: List = []   # open SignalFD descriptors (delivery)
        # the kernel's per-process pending-signal set, shared by every
        # signalfd this process opens (descriptor/signalfd.py)
        from ..descriptor.signalfd import SharedSignalPending
        self._signal_pending = SharedSignalPending()
        host.add_process(self)

    # -- lifecycle ---------------------------------------------------------
    def schedule_start(self, worker) -> None:
        worker.schedule_task(Task(_process_start_task, self, None,
                                  name=f"start:{self.name}"),
                             self.start_time_ns, dst_host=self.host)
        if self.stop_time_ns > 0:
            worker.schedule_task(Task(_process_stop_task, self, None,
                                      name=f"stop:{self.name}"),
                                 self.stop_time_ns, dst_host=self.host)

    def start(self) -> None:
        if self.running or self.exited:
            return
        self.running = True
        get_logger().info("process", f"starting process {self.name} (pid {self.pid})")
        gen = self.app_main(self.api, self.args)
        if not inspect.isgenerator(gen):
            # app completed synchronously (no syscalls)
            self.exited = True
            self.exit_code = gen if isinstance(gen, int) else 0
            return
        self.spawn_thread(gen)
        self.continue_()

    def stop(self) -> None:
        if self.exited:
            return
        for t in self.threads:
            if t.state != DONE:
                t.gen.close()
                t.state = DONE
        self._finish(exit_code=0)

    def _finish(self, exit_code: int) -> None:
        self.exited = True
        self.running = False
        self.exit_code = exit_code
        get_logger().info("process",
                          f"process {self.name} (pid {self.pid}) exited with {exit_code}")
        if exit_code != 0 and self.host.engine is not None:
            if self.supervised_kill:
                self.host.engine.supervision.count_plugin_kill(
                    self.name, self.supervised_kill)
            else:
                self.host.engine.increment_plugin_error()

    # -- green threads -----------------------------------------------------
    def spawn_thread(self, gen) -> GreenThread:
        t = GreenThread(self, gen)
        self.threads.append(t)
        return t

    def continue_(self) -> None:
        """Resume all runnable green threads until everything blocks
        (reference process_continue :1197-1275), attributing the wall to
        the plugin side of the host_exec split.  Batched deliveries
        (parallel/native_plane.py ContinuationLedger) call
        ``_continue_now`` directly and time the whole batch once."""
        if self.exited:
            return
        t0 = _perf()
        self._continue_now()
        engine = self.host.engine
        if engine is not None:
            engine.add_plugin_exec_ns(_perf() - t0)

    def _continue_traced(self) -> None:
        """One plugin-execution span per resume when the run is traced
        (ISSUE 3); selected at construction so the untraced path never
        pays the span machinery (ISSUE 12 satellite)."""
        if self.exited:
            return
        with self._tracer.span("plugin.continue", "plugin",
                               sim_ns=self.host.now,
                               args={"proc": self.name}):
            self._run_runnable()

    def _continue_fast(self) -> None:
        if self.exited:
            return
        self._run_runnable()

    def _run_runnable(self) -> None:
        # _in_continue: a wake arriving DURING the loop (an app send making
        # another descriptor of this process readable) marks its thread
        # RUNNABLE and the rescan resumes it — scheduling a continue event
        # for it would execute as a redundant no-op (ISSUE 12 satellite:
        # the coalescing flag used to reset before the generators ran)
        self._in_continue = True
        try:
            progressed = True
            while progressed:
                progressed = False
                for t in list(self.threads):
                    if t.state == RUNNABLE:
                        progressed = True
                        self._run_thread(t)
        finally:
            self._in_continue = False
        if all(t.state == DONE for t in self.threads) and not self.exited:
            main_done = self.threads[0].state == DONE if self.threads else True
            if main_done:
                rv = self.return_values.get(self.threads[0].tid) if self.threads else 0
                self._finish(exit_code=rv if isinstance(rv, int) else 0)

    def _run_thread(self, t: GreenThread) -> None:
        while t.state == RUNNABLE:
            try:
                if t.wake_exception is not None:
                    exc, t.wake_exception = t.wake_exception, None
                    req = t.gen.throw(exc)
                else:
                    req = t.gen.send(t.wake_value)
                t.wake_value = None
            except StopIteration as si:
                t.state = DONE
                self.return_values[t.tid] = si.value
                return
            except Exception as e:  # app crashed
                t.state = DONE
                get_logger().error("process",
                                   f"process {self.name} thread {t.tid} crashed: {e!r}")
                import traceback
                get_logger().debug("process", traceback.format_exc())
                self._finish(exit_code=1)
                return
            self._dispatch(t, req)

    def _dispatch(self, t: GreenThread, req) -> None:
        w = current_worker()
        plane = self.host.native_plane
        if isinstance(req, _Sleep):
            t.state = BLOCKED
            if w is not None:
                if plane is not None:
                    # one C-heap continuation event, no Python Task/Event
                    plane.push_sleep(self, t, w.now, req.ns)
                else:
                    w.schedule_task(Task(_thread_wake_task, (self, t), None,
                                         name="sleep_wake"), req.ns,
                                    dst_host=self.host)
            return
        if isinstance(req, _Block):
            desc, bits = req.desc, req.bits
            if plane is not None and desc.plane is plane:
                # C-plane socket: the block waiter lives in C — the wake
                # condition is decided at status-change time with no
                # Python callback, and the wake itself is a C-heap
                # continuation event (ISSUE 12)
                t.state = BLOCKED
                if not plane.block_native(self, t, desc, bits,
                                          req.timeout_ns if w is not None
                                          else -1,
                                          w.now if w is not None else
                                          self.host.now):
                    t.state = RUNNABLE
                    t.wake_value = True  # condition already true
                return
            if desc.status & (bits | S_CLOSED):
                t.wake_value = True  # condition already true; loop continues
                return
            t.state = BLOCKED
            armed = [True]

            def on_status(d, changed, _t=t, _bits=bits):
                if armed[0] and d.status & (_bits | S_CLOSED):
                    armed[0] = False
                    d.remove_listener(on_status)
                    _t.wake_value = True
                    self._wake_thread(_t)

            desc.add_listener(on_status)
            t._unblock_cb = (desc, on_status)
            if req.timeout_ns >= 0 and w is not None:
                if plane is not None:
                    # Python-descriptor block under the native plane: the
                    # wake stays a listener, the timeout is a C-heap
                    # continuation event
                    plane.push_block_timeout(
                        self, t, armed, w.now, req.timeout_ns,
                        (lambda _desc=desc, _cb=on_status:
                         _desc.remove_listener(_cb)))
                    return

                def on_timeout(_pair, _arg, _t=t, _desc=desc):
                    if armed[0] and _t.state == BLOCKED:
                        armed[0] = False
                        _desc.remove_listener(on_status)
                        _t.wake_value = False
                        self._wake_thread(_t)

                w.schedule_task(Task(on_timeout, None, None, name="block_timeout"),
                                req.timeout_ns, dst_host=self.host)
            return
        if isinstance(req, _DeviceWait):
            plane = getattr(self.host.engine, "device_plane", None)
            if plane is None:
                raise RuntimeError(
                    f"{self.name}: device flow wait but the engine has no "
                    "device plane (is the client missing its 'device' arg?)")
            if plane.is_done(req.circuit):
                t.wake_value = plane.result(req.circuit)
            else:
                plane.register_waiter(req.circuit, self, t)
                t.state = BLOCKED
            return
        if isinstance(req, _Stop):
            t.state = DONE
            return
        # unknown yield: treat as cooperative yield point
        t.wake_value = None

    def _wake_thread(self, t: GreenThread) -> None:
        if t.state != BLOCKED:
            return
        t.state = RUNNABLE
        t._unblock_cb = None
        self._schedule_continue()

    def _schedule_continue(self) -> None:
        """Coalesced process_continue wakeup: ONE continue event in flight
        per process.  The flag (Python-plane ``_continue_scheduled``; the
        C-side token mirror under the native plane) clears when the event
        DELIVERS, not when continue_ starts — and wakes arriving while
        continue_ is running schedule nothing at all (the loop rescans), so
        no redundant same-time events exist on either path (ISSUE 12
        satellite: the old reset-at-entry scheduled one per mid-continue
        wake)."""
        if self.exited or self._in_continue:
            return
        w = current_worker()
        if w is None:
            self.continue_()
            return
        plane = self.host.native_plane
        if plane is not None:
            plane.sched_continue(self, w.now)
            return
        if self._continue_scheduled:
            return
        self._continue_scheduled = True
        w.schedule_task(Task(_process_continue_task, self, None,
                             name=f"continue:{self.name}"), 0, dst_host=self.host)


def _process_start_task(process: Process, _arg) -> None:
    process.start()


def _process_stop_task(process: Process, _arg) -> None:
    process.stop()


def _process_continue_task(process: Process, _arg) -> None:
    # the in-flight continue event has left the queue: clear the coalescing
    # flag BEFORE resuming (a wake during continue_ is absorbed by the
    # rescan; one arriving after schedules a fresh event)
    process._continue_scheduled = False
    process.continue_()


def _thread_wake_task(pair, _arg) -> None:
    # sleep wake is itself the continue event: resume directly, without
    # routing through _schedule_continue (which would queue a redundant
    # same-time continue event — ISSUE 12 satellite)
    process, t = pair
    if t.state == BLOCKED:
        t.state = RUNNABLE
        t._unblock_cb = None
    process.continue_()


class SyscallAPI:
    """The virtual-kernel call surface handed to apps.

    Mirrors (at capability level) the reference's process_emu_* families
    (process.c:1412-7671): sockets, epoll, timers, time, DNS, random, pipes,
    sleeping, logging.  Blocking calls are generators — app code uses
    ``yield from api.recv(fd, n)``; non-blocking variants return immediately.
    """

    def __init__(self, process: Process):
        self.process = process
        self.host = process.host

    # -- time (process.c time family -> worker_getEmulatedTime) -----------
    def now_ns(self) -> int:
        w = current_worker()
        return w.now if w is not None else 0

    def time(self) -> float:
        """Emulated wall-clock seconds (epoch-offset like the reference)."""
        return stime.emulated_from_sim(self.now_ns()) / stime.SIM_TIME_SEC

    def sleep(self, seconds: float):
        yield _Sleep(stime.from_seconds(seconds))

    def usleep(self, usec: int):
        yield _Sleep(usec * stime.SIM_TIME_US)

    # -- identity / DNS ----------------------------------------------------
    def gethostname(self) -> str:
        return self.host.name

    def gethostbyname(self, name: str) -> int:
        addr = self.host.engine.dns.resolve_name(name)
        if addr is None:
            raise OSError(f"EAI_NONAME: unknown host {name!r}")
        return addr.ip

    def getaddrinfo(self, name: str, port: int) -> Tuple[int, int]:
        return (self.gethostbyname(name), port)

    # -- random (process.c rand family -> host Random) ---------------------
    def rand(self) -> int:
        return self.host.random.next_int(2 ** 31)

    def random_bytes(self, n: int) -> bytes:
        return self.host.random.next_bytes(n)

    # -- sockets -----------------------------------------------------------
    def socket(self, kind: str) -> int:
        host = self.host
        plane = getattr(host, "native_plane", None)
        if plane is not None and kind in ("tcp", "udp"):
            # C data plane: the socket state lives natively; the wrapper
            # carries the descriptor surface (parallel/native_plane.py)
            return plane.create_socket(host, kind).handle
        handle = host.allocate_handle()
        if kind == "udp":
            from ..descriptor.udp import UDPSocket
            sock = UDPSocket(host, handle, host.params.recv_buf_size,
                             host.params.send_buf_size)
        elif kind == "tcp":
            from ..descriptor.tcp import TCPSocket
            sock = TCPSocket(host, handle, host.params.recv_buf_size,
                             host.params.send_buf_size)
        else:
            raise ValueError(f"unsupported socket kind {kind!r}")
        host.register_descriptor(sock)
        return handle

    def _sock(self, fd: int):
        s = self.host.descriptor_table_get(fd)
        if s is None:
            raise OSError(f"EBADF: {fd}")
        return s

    def bind(self, fd: int, addr: Tuple[Any, int]) -> None:
        sock = self._sock(fd)
        wildcard = addr[0] in ("", "0.0.0.0", None, 0)
        ip = self._resolve(addr[0])
        if hasattr(sock, "bind_native"):
            # C-plane socket: the binding tables live natively
            sock.bind_native(ip, addr[1], wildcard)
            return
        iface = self.host.interface_for_ip(ip)
        if iface is None:
            raise OSError("EADDRNOTAVAIL")
        # INADDR_ANY claims the port on every interface (loopback + eth),
        # like the reference's bind-to-any association — so both the
        # ephemeral-port scan and the in-use check must cover every
        # interface it will claim
        # dict.fromkeys: dedupe in insertion order so the ephemeral-port
        # scan and association order are run-to-run stable (SIM003)
        targets = list(dict.fromkeys(self.host.interfaces.values())) \
            if wildcard else [iface]
        port = addr[1]
        if port == 0:
            port = self.host.allocate_ephemeral_port(sock.kind, ip,
                                                     ifaces=targets)
        if any(t.is_associated(sock.kind, port) for t in targets):
            raise OSError("EADDRINUSE")
        sock.bind_to(iface.address.ip, port)
        for t in targets:
            t.associate(sock, sock.kind, port)

    def _resolve(self, name_or_ip) -> int:
        if isinstance(name_or_ip, int):
            return name_or_ip
        if name_or_ip in ("", "0.0.0.0", None):
            return self.host.default_address.ip
        if name_or_ip in ("localhost", "127.0.0.1"):
            from ..routing.address import LOCALHOST_IP
            return LOCALHOST_IP
        try:
            from ..routing.address import ip_to_int
            return ip_to_int(name_or_ip)
        except Exception:
            return self.gethostbyname(name_or_ip)

    def sendto(self, fd: int, data: bytes, addr: Optional[Tuple[Any, int]] = None) -> int:
        sock = self._sock(fd)
        if addr is not None:
            return sock.send_user_data(data, self._resolve(addr[0]), addr[1])
        return sock.send_user_data(data)

    def send(self, fd: int, data: bytes):
        """Blocking send: waits for buffer space (generator)."""
        sock = self._sock(fd)
        if type(data) is not bytes:
            data = bytes(data)
        if not data:
            return 0
        # fast path: the whole buffer fits in one call (no copies)
        n = sock.send_user_data(data)
        total = n
        size = len(data)
        while total < size:
            if n == 0:
                yield _Block(sock, S_WRITABLE)
            n = sock.send_user_data(data[total:])
            total += n
        return total

    def recvfrom(self, fd: int, nbytes: int = 65536):
        """Blocking receive (generator): returns (data, (src_ip, src_port))."""
        sock = self._sock(fd)
        while True:
            r = sock.receive_user_data(nbytes)
            if r is not None:
                data, ip, port = r
                return data, (ip, port)
            if sock.closed or sock.has_status(S_CLOSED):
                return b"", (0, 0)
            yield _Block(sock, S_READABLE)

    def recv(self, fd: int, nbytes: int = 65536):
        """Blocking receive, data only (flattened: one generator frame)."""
        sock = self._sock(fd)
        while True:
            r = sock.receive_user_data(nbytes)
            if r is not None:
                return r[0]
            if sock.closed or sock.has_status(S_CLOSED):
                return b""
            yield _Block(sock, S_READABLE)

    def recv_exact(self, fd: int, nbytes: int):
        """Blocking read of exactly ``nbytes``; None on EOF mid-read.  The
        shared framing helper for stream-protocol apps (flattened — this is
        the hottest read path of the cell-based app models)."""
        sock = self._sock(fd)
        parts = []
        got = 0
        while got < nbytes:
            r = sock.receive_user_data(nbytes - got)
            if r is None:
                if sock.closed or sock.has_status(S_CLOSED):
                    return None
                yield _Block(sock, S_READABLE)
                continue
            data = r[0]
            if not data:
                return None
            parts.append(data)
            got += len(data)
        return parts[0] if len(parts) == 1 else b"".join(parts)

    def try_recvfrom(self, fd: int, nbytes: int = 65536):
        """Non-blocking: None if nothing available."""
        r = self._sock(fd).receive_user_data(nbytes)
        if r is None:
            return None
        data, ip, port = r
        return data, (ip, port)

    def close(self, fd: int) -> None:
        d = self.host.descriptor_table_get(fd)
        if d is not None:
            d.close()

    def shutdown(self, fd: int, how: int = 1) -> None:
        """shutdown(2) on a connected TCP socket (0=RD, 1=WR, 2=RDWR)."""
        sock = self._sock(fd)
        if hasattr(sock, "shutdown"):
            sock.shutdown(how)
        else:
            raise OSError("ENOTSOCK")

    # -- TCP-specific (listen/accept/connect implemented with the TCP stack;
    # available once descriptor/tcp.py lands) ------------------------------
    def listen(self, fd: int, backlog: int = 128) -> None:
        self._sock(fd).listen(backlog)

    def accept(self, fd: int):
        sock = self._sock(fd)
        while True:
            child = sock.accept_child()
            if child is not None:
                return child.handle, (child.peer_ip, child.peer_port)
            yield _Block(sock, S_READABLE)

    def connect(self, fd: int, addr: Tuple[Any, int]):
        sock = self._sock(fd)
        ip = self._resolve(addr[0])
        done = sock.connect_to(ip, addr[1])
        if not done:
            yield _Block(sock, S_WRITABLE)
            err = sock.take_socket_error()
            if err:
                raise OSError(err)
        return 0

    # -- epoll -------------------------------------------------------------
    def epoll_create(self) -> int:
        from ..descriptor.epoll import Epoll
        host = self.host
        handle = host.allocate_handle()
        ep = Epoll(host, handle)
        host.register_descriptor(ep)
        return handle

    def epoll_ctl(self, epfd: int, op: str, fd: int, events: int = 0, data=None) -> None:
        ep = self._sock(epfd)
        desc = self._sock(fd)
        if op == "add":
            ep.ctl_add(desc, events, data if data is not None else fd)
        elif op == "mod":
            ep.ctl_mod(desc, events, data if data is not None else fd)
        elif op == "del":
            ep.ctl_del(desc)
        else:
            raise ValueError(op)

    def epoll_wait(self, epfd: int, timeout_sec: float = -1.0, max_events: int = 64):
        """Blocking epoll_wait (generator)."""
        ep = self._sock(epfd)
        if ep.has_ready():
            return ep.wait(max_events)
        if timeout_sec == 0:
            return []
        if timeout_sec > 0:
            deadline = self.now_ns() + stime.from_seconds(timeout_sec)
            while not ep.has_ready():
                remaining = deadline - self.now_ns()
                if remaining <= 0:
                    break
                fired = yield _Block(ep, S_READABLE, timeout_ns=remaining)
                if not fired:
                    break
            return ep.wait(max_events)
        while not ep.has_ready():
            yield _Block(ep, S_READABLE)
        return ep.wait(max_events)

    # -- timers ------------------------------------------------------------
    def timerfd_create(self) -> int:
        from ..descriptor.timer import Timer
        host = self.host
        handle = host.allocate_handle()
        tm = Timer(host, handle)
        host.register_descriptor(tm)
        return handle

    def eventfd_create(self, initval: int = 0, semaphore: bool = False) -> int:
        """eventfd(2): counter descriptor (thread-pool wakeups in epoll)."""
        from ..descriptor.eventfd import EventFD
        host = self.host
        handle = host.allocate_handle()
        ev = EventFD(host, handle, initval, semaphore)
        host.register_descriptor(ev)
        return handle

    def signalfd_create(self, mask: int) -> int:
        """signalfd(2): virtual-signal queue descriptor for this process."""
        from ..descriptor.signalfd import SignalFD
        host = self.host
        handle = host.allocate_handle()
        sfd = SignalFD(host, handle, mask, shared=self.process._signal_pending)
        host.register_descriptor(sfd)
        self.process._signal_fds.append(sfd)
        return handle

    def deliver_signal(self, signo: int) -> int:
        """Route a virtual signal raised by this process (raise()/kill() on
        the virtual pid).  signalfd(2) semantics: a blocked pending signal
        is ONE process-wide instance visible on EVERY open matching
        signalfd (all of them become readable — two epoll loops with
        overlapping masks both wake), and the FIRST read consumes it.
        Returns the number of matching signalfds; 0 = caller may fall back
        to its recorded handler (which is what the shim does).  Routing and
        liveness pruning live in the shared store (SharedSignalPending) —
        the process's _signal_fds list is just the descriptor registry."""
        return self.process._signal_pending.deliver(signo)

    def timerfd_settime(self, fd: int, initial_sec: float, interval_sec: float = 0.0) -> None:
        self._sock(fd).arm(stime.from_seconds(initial_sec),
                           stime.from_seconds(interval_sec))

    def timerfd_read(self, fd: int) -> int:
        return self._sock(fd).read_expirations()

    # -- pipes -------------------------------------------------------------
    def pipe(self) -> Tuple[int, int]:
        from ..descriptor.channel import Channel
        host = self.host
        rh, wh = host.allocate_handle(), host.allocate_handle()
        r, w = Channel.new_pipe(host, rh, wh)
        host.register_descriptor(r)
        host.register_descriptor(w)
        return rh, wh

    def socketpair(self) -> Tuple[int, int]:
        from ..descriptor.channel import Channel
        host = self.host
        ha, hb = host.allocate_handle(), host.allocate_handle()
        a, b = Channel.new_socketpair(host, ha, hb)
        host.register_descriptor(a)
        host.register_descriptor(b)
        return ha, hb

    def write(self, fd: int, data: bytes) -> int:
        return self._sock(fd).send_user_data(data)

    def read(self, fd: int, nbytes: int = 65536):
        """Blocking read from a pipe/channel (generator)."""
        d = self._sock(fd)
        while True:
            r = d.receive_user_data(nbytes)
            if r is not None:
                return r[0]
            yield _Block(d, S_READABLE)

    # -- threads (pthread family -> green threads) -------------------------
    def spawn(self, gen_func, *args) -> int:
        """pthread_create analog: runs another generator coroutine in this
        process."""
        t = self.process.spawn_thread(gen_func(*args))
        return t.tid

    def yield_(self):
        """Cooperative yield (pth_yield)."""
        yield None

    # -- device traffic plane ---------------------------------------------
    def device_flow_start(self, cells: Optional[int] = None,
                          route=None) -> int:
        """Hand this host's registered bulk transfer to the device traffic
        plane (parallel/device_plane.py); returns the flow handle.  The
        flow's route/size come from the process's own config args — apps
        call this once their control-plane setup (e.g. circuit build) is
        done, which is the moment the cells start moving on-device.
        ``route`` (hop host names, client-side order) cross-checks the
        runtime path against the plane's startup prediction for auto:
        consensus clients — a mismatch means the predicted consensus
        diverged from the fetched one, and must fail loudly."""
        plane = getattr(self.host.engine, "device_plane", None)
        if plane is None:
            raise RuntimeError("no device traffic plane in this simulation")
        if route is not None:
            plane.check_route(self.host.name, list(route))
        return plane.activate(self.host.name, cells)

    def device_flow_join(self, circuit: int):
        """Block until the device flow completes; returns the completion
        sim time ns (generator)."""
        result = yield _DeviceWait(circuit)
        return result

    # -- logging -----------------------------------------------------------
    def log(self, text: str, level: str = "message") -> None:
        """App log line, honoring the host's per-host loglevel filter
        (reference per-host ``loglevel`` attribute)."""
        from ..core.logger import LEVELS
        host_level = getattr(self.host.params, "log_level", None)
        if host_level is not None \
                and LEVELS.get(level, 3) > LEVELS.get(host_level, 3):
            return
        get_logger().log(level, f"app/{self.process.name}", text)


