"""Native plugin plane: run real, unmodified binaries under the simulator.

Capability parity with the reference's interposition substrate — preload/
interposer.c routing libc calls to process.c's process_emu_* family, with
rpth green threads providing blocking semantics against the virtual clock
(SURVEY.md §2.7).  Our architecture runs each plugin as a real OS process
with ``libshadow_preload.so`` (native/preload/shim.cc) LD_PRELOADed; every
interposed libc call arrives here over a socketpair as a framed request
(native/preload/protocol.h) and is executed against the same virtual-kernel
objects the Python plugin plane uses (descriptors, DNS, timers, random).

Scheduling contract (the determinism core): the plugin process only executes
between our response and its next request.  The green thread that serves a
plugin blocks in a *real* ``recv`` while the plugin computes — plugin code
is "instantaneous" in virtual time, exactly like the reference's pth model
(process.c:1197 process_continue runs green threads until all block).  When
a request can't complete (blocking recv on an empty socket), the serving
green thread yields to the simulator and the response is simply delayed
until the virtual clock makes the operation ready — which is how real
blocking apps run under a discrete-event clock.
"""

from __future__ import annotations

import atexit
import errno as errno_mod
import os
import socket as real_socket
import struct
import subprocess
from typing import List, Optional

from ..core import stime
from ..core.logger import get_logger
from ..descriptor.base import Descriptor, S_CLOSED, S_READABLE, S_WRITABLE
from ..descriptor.epoll import Epoll, EPOLLERR, EPOLLHUP, EPOLLIN, EPOLLOUT
from ..obs.trace import get_tracer
from .process import _Block, _Sleep

# -- protocol constants (mirror native/preload/protocol.h) -------------------
OP_SOCKET = 1
OP_BIND = 2
OP_LISTEN = 3
OP_ACCEPT = 4
OP_CONNECT = 5
OP_SEND = 6
OP_SENDTO = 7
OP_RECV = 8
OP_RECVFROM = 9
OP_CLOSE = 10
OP_EPOLL_CREATE = 11
OP_EPOLL_CTL = 12
OP_EPOLL_WAIT = 13
OP_POLL = 14
OP_GETTIME = 15
OP_SLEEP = 16
OP_GETADDRINFO = 17
OP_GETHOSTNAME = 18
OP_RANDOM = 19
OP_SETSOCKOPT = 20
OP_GETSOCKOPT = 21
OP_GETSOCKNAME = 22
OP_GETPEERNAME = 23
OP_SHUTDOWN = 24
OP_FCNTL = 25
OP_IOCTL = 26
OP_OPEN_RANDOM = 27
OP_READ = 28
OP_WRITE = 29
OP_EXIT = 30
OP_LOG = 31
OP_TIMERFD_CREATE = 32
OP_TIMERFD_SETTIME = 33
OP_PIPE = 34
OP_SOCKETPAIR = 35
OP_EVENTFD = 36
OP_SIGNALFD = 37
OP_KILL = 38
OP_GETNAMEINFO = 39

REQ_HDR = struct.Struct("<IIqqqq")
RESP_HDR = struct.Struct("<IIqq")

O_NONBLOCK = 0o4000
F_GETFL = 3
F_SETFL = 4
FIONREAD = 0x541B
SOCK_STREAM = 1
SOCK_DGRAM = 2
SOL_SOCKET = 1
SO_ERROR = 4
SO_SNDBUF = 7
SO_RCVBUF = 8
POLLIN = 0x001
POLLOUT = 0x004
POLLERR = 0x008
POLLHUP = 0x010

_PRELOAD_LIB = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                            "native", "libshadow_preload.so")

# A plugin that spins without making a syscall would freeze the virtual
# clock forever (the simulator's determinism seam is a blocking read while
# plugin code runs).  The reference bounds this with its CPU model + pth
# preemption; our analog is a generous wall-clock stall watchdog: a plugin
# silent for this long is declared dead and torn down loudly.
STALL_TIMEOUT_SEC = float(os.environ.get("SHADOW_TPU_PLUGIN_STALL_TIMEOUT",
                                         "300"))


def _watchdog_sec(api) -> float:
    """The plugin RPC watchdog budget: ``--plugin-watchdog-sec`` when set,
    else the module/env default.  One resolution point so the serve loop,
    the handshake wait, and the pooled loop all honor the same knob."""
    opts = getattr(getattr(api.host, "engine", None), "options", None)
    v = float(getattr(opts, "plugin_watchdog_sec", 0) or 0)
    return v if v > 0 else STALL_TIMEOUT_SEC


def _supervise_kill(api, reason: str) -> None:
    """Mark the simulated process as supervisor-killed: its app generator
    exits with code 124 (the timeout convention), process._finish routes
    the exit to the supervision ledger instead of plugin_errors, and the
    host + round loop continue."""
    get_logger().warning("native", f"{api.process.name}: {reason}")
    api.process.supervised_kill = reason


def _fault_stall_after(api) -> int:
    """Fault harness: ``plugin-stall:NAME:NREQ`` -> NREQ for this process
    (SIGSTOP its child after serving that many requests), else 0."""
    opts = getattr(getattr(api.host, "engine", None), "options", None)
    spec = getattr(opts, "fault_inject", "") or ""
    if spec.startswith("plugin-stall:"):
        from ..core.supervision import parse_fault_inject
        f = parse_fault_inject(spec)
        if f["name"] in api.process.name:
            return f["nreq"]
    return 0

_live_children: List[subprocess.Popen] = []


def _kill_stragglers(grace_sec: float = 2.0) -> None:
    """Tear down surviving plugin/pool children: terminate -> grace ->
    kill, then ``wait`` (waitpid) each one so no zombies outlive a run —
    a bare SIGKILL without reaping used to leave defunct entries behind
    for the life of the test process."""
    import time as _wt
    live = [p for p in _live_children if p.poll() is None]
    for p in live:
        try:
            p.terminate()
        except OSError:
            pass
    deadline = _wt.monotonic() + grace_sec
    for p in live:
        try:
            p.wait(timeout=max(0.0, deadline - _wt.monotonic()))
        except subprocess.TimeoutExpired:
            try:
                p.kill()
            except OSError:
                pass
            try:
                p.wait(timeout=5.0)
            except subprocess.TimeoutExpired:  # pragma: no cover - D state
                pass
        except OSError:  # pragma: no cover - already reaped elsewhere
            pass


atexit.register(_kill_stragglers)


def preload_lib_path() -> str:
    return _PRELOAD_LIB


def host_data_dir(host) -> str:
    """The single definition of the per-host data layout
    (<data-directory>/hosts/<name>, reference slave.c hostDataPath);
    created on first use."""
    data_root = getattr(getattr(host, "engine", None), "data_directory",
                        None) or "shadow.data"
    host_dir = os.path.join(data_root, "hosts", host.name)
    os.makedirs(host_dir, exist_ok=True)
    return host_dir


def _errno_of(exc: OSError) -> int:
    """Map our virtual-kernel OSError style ('EADDRINUSE: detail') to a
    numeric errno."""
    if exc.errno:
        return exc.errno
    text = (exc.args[0] if exc.args else "") or ""
    name = str(text).split(":")[0].strip().split()[0] if text else ""
    return getattr(errno_mod, name, errno_mod.EINVAL)


class RandomDescriptor(Descriptor):
    """Deterministic /dev/random-style source (the reference keeps per-host
    /dev/random handles, host.c:47-105; reads come from the host PRNG)."""

    def __init__(self, host, handle: int):
        super().__init__(host, handle, "random")
        self.adjust_status(S_READABLE, True)

    def read_bytes(self, n: int) -> bytes:
        return self.host.random.next_bytes(n)


class NativeKernel:
    """Dispatches one plugin's protocol requests against the virtual kernel.

    Runs inside the plugin's green thread: handlers that must wait for
    virtual readiness ``yield`` simulator blocks, so one kernel instance
    serves exactly one plugin process, serially.
    """

    def __init__(self, api, conn: real_socket.socket):
        self.api = api
        self.host = api.host
        self.conn = conn
        self.exit_code: Optional[int] = None

    # -- descriptor helpers ------------------------------------------------
    def _desc(self, handle: int):
        d = self.host.descriptor_table_get(int(handle))
        if d is None:
            raise OSError("EBADF")
        return d

    def _nonblock(self, desc) -> bool:
        return bool(getattr(desc, "_nonblock", False))

    def _recv_payload(self, desc, nbytes: int):
        """One receive attempt -> payload tuple or None."""
        return desc.receive_user_data(int(nbytes))

    def _is_eof(self, desc) -> bool:
        return desc.closed or desc.has_status(S_CLOSED)

    # -- dispatch ----------------------------------------------------------
    def dispatch(self, op: int, a: int, b: int, c: int, d: int,
                 payload: bytes):
        """Generator: returns (ret, resp_payload)."""
        try:
            handler = self._HANDLERS[op]
        except KeyError:
            return -errno_mod.ENOSYS, b""
        try:
            result = yield from handler(self, a, b, c, d, payload)
        except OSError as e:
            return -_errno_of(e), b""
        except (FileExistsError, FileNotFoundError) as e:
            return -_errno_of(e), b""
        return result

    # -- socket ops --------------------------------------------------------
    def op_socket(self, a, b, c, d, payload):
        kind = "tcp" if b == SOCK_STREAM else "udp"
        fd = self.api.socket(kind)
        return fd, b""
        yield  # pragma: no cover — make this a generator

    def op_bind(self, a, b, c, d, payload):
        self.api.bind(int(a), (int(b), int(c)))
        return 0, b""
        yield  # pragma: no cover

    def op_listen(self, a, b, c, d, payload):
        self.api.listen(int(a), int(b))
        return 0, b""
        yield  # pragma: no cover

    def op_accept(self, a, b, c, d, payload):
        sock = self._desc(a)
        nonblock = self._nonblock(sock) or bool(b)
        while True:
            child = sock.accept_child()
            if child is not None:
                break
            if nonblock:
                return -errno_mod.EAGAIN, b""
            if self._is_eof(sock):
                return -errno_mod.EINVAL, b""
            yield _Block(sock, S_READABLE)
        resp = struct.pack("<IH", child.peer_ip & 0xFFFFFFFF, child.peer_port)
        return child.handle, resp

    def op_connect(self, a, b, c, d, payload):
        sock = self._desc(a)
        done = sock.connect_to(int(b), int(c))
        if done:
            return 0, b""
        if self._nonblock(sock) or bool(d):
            return -errno_mod.EINPROGRESS, b""
        yield _Block(sock, S_WRITABLE)
        err = sock.take_socket_error()
        if err:
            return -getattr(errno_mod, str(err).split(":")[0], errno_mod.ECONNREFUSED), b""
        return 0, b""

    def op_send(self, a, b, c, d, payload):
        sock = self._desc(a)
        nonblock = self._nonblock(sock) or bool(b)
        total = 0
        view = memoryview(payload)
        while total < len(view):
            # bounded slice: re-materializing the whole tail each retry
            # would make a large blocking write O(n^2) in copied bytes
            chunk = bytes(view[total:total + 262144])
            n = sock.send_user_data(chunk)
            total += n
            if total >= len(view) or nonblock:
                break
            if n == 0:
                if self._is_eof(sock):
                    return (total if total else -errno_mod.EPIPE), b""
                yield _Block(sock, S_WRITABLE)
        if total == 0 and nonblock and len(view) > 0:
            return -errno_mod.EAGAIN, b""
        return total, b""

    def op_sendto(self, a, b, c, d, payload):
        sock = self._desc(a)
        nonblock = self._nonblock(sock) or bool(b)
        while True:
            n = sock.send_user_data(payload, int(c), int(d))
            if n > 0 or len(payload) == 0:
                return n, b""
            if nonblock:
                return -errno_mod.EAGAIN, b""
            yield _Block(sock, S_WRITABLE)

    def op_recv(self, a, b, c, d, payload):
        sock = self._desc(a)
        nonblock = self._nonblock(sock) or bool(c)
        peek = bool(d)
        while True:
            if peek:
                peeker = getattr(sock, "peek_user_data", None)
                if peeker is None:
                    return -errno_mod.EINVAL, b""
                r = peeker(int(b))
            else:
                r = self._recv_payload(sock, b)
            if r is not None:
                data = r[0] if isinstance(r, tuple) else r
                return len(data), bytes(data)
            if self._is_eof(sock):
                return 0, b""
            if nonblock:
                return -errno_mod.EAGAIN, b""
            yield _Block(sock, S_READABLE)

    def op_recvfrom(self, a, b, c, d, payload):
        sock = self._desc(a)
        nonblock = self._nonblock(sock) or bool(c)
        while True:
            r = self._recv_payload(sock, b)
            if r is not None:
                data, ip, port = r[0], r[1], r[2]
                hdr = struct.pack("<IH", ip & 0xFFFFFFFF, port & 0xFFFF)
                return len(data), hdr + bytes(data)
            if self._is_eof(sock):
                return 0, struct.pack("<IH", 0, 0)
            if nonblock:
                return -errno_mod.EAGAIN, b""
            yield _Block(sock, S_READABLE)

    def op_close(self, a, b, c, d, payload):
        self.api.close(int(a))
        return 0, b""
        yield  # pragma: no cover

    def op_shutdown(self, a, b, c, d, payload):
        sock = self._desc(a)
        if hasattr(sock, "shutdown"):
            sock.shutdown(int(b))
        else:
            sock.close()
        return 0, b""
        yield  # pragma: no cover

    def op_getsockopt(self, a, b, c, d, payload):
        sock = self._desc(a)
        val = 0
        if b == SOL_SOCKET and c == SO_ERROR:
            err = sock.take_socket_error() if hasattr(sock, "take_socket_error") else None
            val = getattr(errno_mod, str(err).split(":")[0], 0) if err else 0
        elif b == SOL_SOCKET and c == SO_SNDBUF:
            val = getattr(sock, "send_buf_size", 0)
        elif b == SOL_SOCKET and c == SO_RCVBUF:
            val = getattr(sock, "recv_buf_size", 0)
        return 0, struct.pack("<i", int(val))
        yield  # pragma: no cover

    def op_setsockopt(self, a, b, c, d, payload):
        sock = self._desc(a)
        if b == SOL_SOCKET and c in (SO_SNDBUF, SO_RCVBUF) and len(payload) >= 4:
            (val,) = struct.unpack("<i", payload[:4])
            # the kernel doubles setsockopt buffer sizes (reference honors
            # this in options --socket-recv-buffer semantics)
            if c == SO_SNDBUF and hasattr(sock, "send_buf_size"):
                sock.send_buf_size = max(4096, val)
            if c == SO_RCVBUF and hasattr(sock, "recv_buf_size"):
                sock.recv_buf_size = max(4096, val)
        return 0, b""
        yield  # pragma: no cover

    def _name_payload(self, ip, port):
        return struct.pack("<IH", (ip or 0) & 0xFFFFFFFF, (port or 0) & 0xFFFF)

    def op_getsockname(self, a, b, c, d, payload):
        sock = self._desc(a)
        return 0, self._name_payload(getattr(sock, "bound_ip", 0),
                                     getattr(sock, "bound_port", 0))
        yield  # pragma: no cover

    def op_getpeername(self, a, b, c, d, payload):
        sock = self._desc(a)
        ip = getattr(sock, "peer_ip", 0)
        if not ip:
            return -errno_mod.ENOTCONN, b""
        return 0, self._name_payload(ip, getattr(sock, "peer_port", 0))
        yield  # pragma: no cover

    # -- generic fd ops ----------------------------------------------------
    def op_read(self, a, b, c, d, payload):
        desc = self._desc(a)
        if isinstance(desc, RandomDescriptor):
            return 0, desc.read_bytes(int(b))
        if desc.kind == "timer":
            while desc.expire_count == 0:
                if self._nonblock(desc) or bool(c):
                    return -errno_mod.EAGAIN, b""
                yield _Block(desc, S_READABLE)
            n = desc.read_expirations()
            return 8, struct.pack("<Q", n)
        if desc.kind == "eventfd":
            while True:
                v = desc.read_value()
                if v is not None:
                    return 8, struct.pack("<Q", v)
                if self._nonblock(desc) or bool(c):
                    return -errno_mod.EAGAIN, b""
                yield _Block(desc, S_READABLE)
        if desc.kind == "signalfd":
            while True:
                rec = desc.read_siginfo()
                if rec is not None:
                    return len(rec), rec
                if self._nonblock(desc) or bool(c):
                    return -errno_mod.EAGAIN, b""
                yield _Block(desc, S_READABLE)
        r = yield from self.op_recv(a, b, c, d, payload)
        return r

    def op_write(self, a, b, c, d, payload):
        desc = self._desc(a)
        if desc.kind == "eventfd":
            if len(payload) < 8:            # kernel: EINVAL under 8 bytes,
                return -errno_mod.EINVAL, b""   # first 8 used otherwise
            val = struct.unpack("<Q", payload[:8])[0]
            while True:
                r = desc.write_value(val)
                if r is None:
                    return -errno_mod.EINVAL, b""
                if r:
                    return 8, b""
                if self._nonblock(desc) or bool(b):
                    return -errno_mod.EAGAIN, b""
                # can't park on S_WRITABLE: POLLOUT stays asserted while
                # counter < max even though THIS (large) value won't fit
                # (eventfd(2)); retry each refill tick of virtual time
                yield _Sleep(1_000_000)
        r = yield from self.op_send(a, b, c, d, payload)
        return r

    def op_fcntl(self, a, b, c, d, payload):
        desc = self._desc(a)
        if b == F_GETFL:
            return (O_NONBLOCK if self._nonblock(desc) else 0), b""
        if b == F_SETFL:
            desc._nonblock = bool(int(c) & O_NONBLOCK)
            return 0, b""
        return -errno_mod.EINVAL, b""
        yield  # pragma: no cover

    def op_ioctl(self, a, b, c, d, payload):
        desc = self._desc(a)
        if b == FIONREAD:
            return int(getattr(desc, "in_bytes", 0)), b""
        return -errno_mod.ENOTTY, b""
        yield  # pragma: no cover

    # -- epoll/poll --------------------------------------------------------
    def op_epoll_create(self, a, b, c, d, payload):
        return self.api.epoll_create(), b""
        yield  # pragma: no cover

    def op_epoll_ctl(self, a, b, c, d, payload):
        ep = self._desc(a)
        desc = self._desc(c)
        data = struct.unpack("<Q", payload[:8])[0] if len(payload) >= 8 else int(c)
        if b == 1:
            ep.ctl_add(desc, int(d), data)
        elif b == 2:
            ep.ctl_mod(desc, int(d), data)
        else:
            ep.ctl_del(desc)
        return 0, b""
        yield  # pragma: no cover

    def op_epoll_wait(self, a, b, c, d, payload):
        ep = self._desc(a)
        timeout_ms = int(c)
        if not ep.has_ready():
            if timeout_ms == 0:
                return 0, b""
            if timeout_ms > 0:
                deadline = self.api.now_ns() + timeout_ms * stime.SIM_TIME_MS
                while not ep.has_ready():
                    remaining = deadline - self.api.now_ns()
                    if remaining <= 0:
                        break
                    fired = yield _Block(ep, S_READABLE, timeout_ns=remaining)
                    if not fired:
                        break
            else:
                while not ep.has_ready():
                    yield _Block(ep, S_READABLE)
        events = ep.wait(int(b))
        out = b"".join(struct.pack("<IQ", rev & 0xFFFFFFFF, int(data))
                       for data, rev in events)
        return len(events), out

    def op_poll(self, a, b, c, d, payload):
        nfds = int(a)
        timeout_ms = int(b)
        entries = []
        for i in range(nfds):
            h, ev = struct.unpack_from("<ih", payload, i * 6)
            entries.append((h, ev))

        def scan():
            revents = []
            ready = 0
            for h, ev in entries:
                desc = self.host.descriptor_table_get(h) if h >= 0 else None
                r = 0
                if desc is not None:
                    if (ev & POLLIN) and desc.has_status(S_READABLE):
                        r |= POLLIN
                    if (ev & POLLOUT) and desc.has_status(S_WRITABLE):
                        r |= POLLOUT
                    if desc.has_status(S_CLOSED):
                        r |= POLLHUP
                elif h >= 0:
                    r |= POLLERR  # stale sim fd
                if r:
                    ready += 1
                revents.append(r)
            return ready, revents

        ready, revents = scan()
        if ready == 0 and timeout_ms != 0:
            # block on all polled descriptors via a scratch epoll (the
            # reference implements poll on top of its epoll too)
            ep = Epoll(self.host, self.host.allocate_handle())
            added = []
            for h, ev in entries:
                desc = self.host.descriptor_table_get(h) if h >= 0 else None
                if desc is None or desc is ep:
                    continue
                want = 0
                if ev & POLLIN:
                    want |= EPOLLIN
                if ev & POLLOUT:
                    want |= EPOLLOUT
                try:
                    ep.ctl_add(desc, want, h)
                    added.append(desc)
                except (OSError, FileExistsError):
                    pass
            try:
                if added:
                    if timeout_ms > 0:
                        yield _Block(ep, S_READABLE,
                                     timeout_ns=timeout_ms * stime.SIM_TIME_MS)
                    else:
                        yield _Block(ep, S_READABLE)
                elif timeout_ms > 0:
                    yield _Sleep(timeout_ms * stime.SIM_TIME_MS)
            finally:
                for desc in added:
                    try:
                        ep.ctl_del(desc)
                    except (OSError, FileNotFoundError):
                        pass
                ep.close()
            ready, revents = scan()
        out = b"".join(struct.pack("<h", r) for r in revents)
        return ready, out

    # -- time/sleep --------------------------------------------------------
    def op_gettime(self, a, b, c, d, payload):
        return 0, b""
        yield  # pragma: no cover

    def op_sleep(self, a, b, c, d, payload):
        if a > 0:
            yield _Sleep(int(a))
        return 0, b""

    # -- identity / DNS / random ------------------------------------------
    def op_getaddrinfo(self, a, b, c, d, payload):
        name = payload.decode("utf-8", "replace")
        try:
            ip = self.api.gethostbyname(name)
        except OSError:
            return -errno_mod.ENOENT, b""
        return 0, struct.pack("<I", ip & 0xFFFFFFFF)
        yield  # pragma: no cover

    def op_getnameinfo(self, a, b, c, d, payload):
        """Reverse lookup (getnameinfo without NI_NUMERICHOST): ip -> the
        simulated host's name through the engine DNS."""
        addr = self.host.engine.dns.resolve_ip(int(a))
        if addr is None:
            return -errno_mod.ENOENT, b""
        return 0, addr.name.encode()
        yield  # pragma: no cover

    def op_gethostname(self, a, b, c, d, payload):
        return 0, self.api.gethostname().encode()
        yield  # pragma: no cover

    def op_random(self, a, b, c, d, payload):
        n = max(0, min(int(a), 4096))
        return n, self.api.random_bytes(n)
        yield  # pragma: no cover

    def op_open_random(self, a, b, c, d, payload):
        handle = self.host.allocate_handle()
        self.host.register_descriptor(RandomDescriptor(self.host, handle))
        return handle, b""
        yield  # pragma: no cover

    # -- timers / pipes ----------------------------------------------------
    def op_timerfd_create(self, a, b, c, d, payload):
        return self.api.timerfd_create(), b""
        yield  # pragma: no cover

    def op_timerfd_settime(self, a, b, c, d, payload):
        self._desc(a).arm(int(b), int(c))
        return 0, b""
        yield  # pragma: no cover

    def op_pipe(self, a, b, c, d, payload):
        rh, wh = self.api.pipe()
        return rh, struct.pack("<I", wh)
        yield  # pragma: no cover

    def op_socketpair(self, a, b, c, d, payload):
        ha, hb = self.api.socketpair()
        return ha, struct.pack("<I", hb)
        yield  # pragma: no cover

    def op_eventfd(self, a, b, c, d, payload):
        # a=initval, b: bit0 = EFD_SEMAPHORE (shim-decoded)
        return self.api.eventfd_create(int(a), bool(int(b) & 1)), b""
        yield  # pragma: no cover

    def op_signalfd(self, a, b, c, d, payload):
        # a = 64-bit signal mask bitmap (bit signo-1)
        return self.api.signalfd_create(int(a)), b""
        yield  # pragma: no cover

    def op_kill(self, a, b, c, d, payload):
        # a = signo, self-directed (shim routes only own-pid kills here);
        # returns the number of matching signalfds so the shim can fall
        # back to its recorded handler when none matched
        return self.api.deliver_signal(int(a)), b""
        yield  # pragma: no cover

    # -- misc --------------------------------------------------------------
    def op_exit(self, a, b, c, d, payload):
        self.exit_code = int(a)
        return 0, b""
        yield  # pragma: no cover

    def op_log(self, a, b, c, d, payload):
        self.api.log(payload.decode("utf-8", "replace"))
        return 0, b""
        yield  # pragma: no cover

    _HANDLERS = {
        OP_SOCKET: op_socket, OP_BIND: op_bind, OP_LISTEN: op_listen,
        OP_ACCEPT: op_accept, OP_CONNECT: op_connect, OP_SEND: op_send,
        OP_SENDTO: op_sendto, OP_RECV: op_recv, OP_RECVFROM: op_recvfrom,
        OP_CLOSE: op_close, OP_EPOLL_CREATE: op_epoll_create,
        OP_EPOLL_CTL: op_epoll_ctl, OP_EPOLL_WAIT: op_epoll_wait,
        OP_POLL: op_poll, OP_GETTIME: op_gettime, OP_SLEEP: op_sleep,
        OP_GETADDRINFO: op_getaddrinfo, OP_GETHOSTNAME: op_gethostname,
        OP_RANDOM: op_random, OP_SETSOCKOPT: op_setsockopt,
        OP_GETSOCKOPT: op_getsockopt, OP_GETSOCKNAME: op_getsockname,
        OP_GETPEERNAME: op_getpeername, OP_SHUTDOWN: op_shutdown,
        OP_FCNTL: op_fcntl, OP_IOCTL: op_ioctl,
        OP_OPEN_RANDOM: op_open_random, OP_READ: op_read,
        OP_WRITE: op_write, OP_EXIT: op_exit, OP_LOG: op_log,
        OP_TIMERFD_CREATE: op_timerfd_create,
        OP_TIMERFD_SETTIME: op_timerfd_settime, OP_PIPE: op_pipe,
        OP_SOCKETPAIR: op_socketpair, OP_EVENTFD: op_eventfd,
        OP_SIGNALFD: op_signalfd, OP_KILL: op_kill,
        OP_GETNAMEINFO: op_getnameinfo,
    }


def _read_exact_raising(conn: real_socket.socket, n: int) -> Optional[bytes]:
    """Blocking read of exactly n bytes; None on EOF; socket timeouts
    propagate (TimeoutError) so every bounded read distinguishes 'child
    stalled' (a watchdog fire) from 'child exited' (a normal teardown).

    This *real* blocking read is the determinism seam: while we're here, the
    plugin is executing (instantaneous in virtual time); it will either send
    another request, stall, or exit."""
    chunks = []
    got = 0
    while got < n:
        chunk = conn.recv(n - got)
        if not chunk:
            return None
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def _dispatch_traced(tracer, kernel, name: str, op: int, a, b, c, d,
                     payload):
    """One native-plugin RPC wrapped in a ``plugin.rpc`` span (ISSUE 3:
    plugin execution is a named span).  Only called on TRACED runs — the
    serve loops call ``kernel.dispatch`` directly otherwise, so the
    disabled per-syscall path gains no extra generator frame.  The span's
    wall duration covers any virtual-time blocking the syscall performed —
    i.e. it is the request's *service* time, which is what the flight
    recorder wants around a watchdog fire."""
    with tracer.span("plugin.rpc", "plugin", sim_ns=kernel.api.now_ns(),
                     args={"op": op, "proc": name}):
        ret = yield from kernel.dispatch(op, a, b, c, d, payload)
    return ret


def run_native_plugin(api, args: List[str], binary: str,
                      extra_env: Optional[dict] = None):
    """App-main generator serving one native plugin process.

    The reference's equivalent flow: _process_start loads the plugin into a
    namespace and pth-schedules its main (process.c:1055-1195); here we exec
    the real binary with the shim preloaded and serve its syscall stream.
    """
    log = get_logger()
    name = api.process.name
    sim_side, child_side = real_socket.socketpair()
    env = dict(os.environ)
    # config-level environment injection (<shadow environment=...>) FIRST,
    # then the shim is prepended so an injected LD_PRELOAD (the config
    # 'preload' attribute) chains behind it instead of clobbering it
    env.update(getattr(getattr(api.host, "engine", None),
                       "plugin_environment", None) or {})
    # LD_PRELOAD chain: shim first, then <process preload=...>, then any
    # config/ambient preloads (reference per-process preload attribute)
    proc_preload = getattr(api.process, "preload", None)
    chain = [_PRELOAD_LIB]
    if proc_preload:
        chain.append(proc_preload)
    if env.get("LD_PRELOAD"):
        chain.append(env["LD_PRELOAD"])
    env["LD_PRELOAD"] = " ".join(chain)
    env["SHADOW_TPU_FD"] = str(child_side.fileno())
    env["SHADOW_TPU_EPOCH_NS"] = str(stime.EMULATED_TIME_OFFSET)
    # deterministic virtual pid (the reference's plugins see their virtual
    # process id through process_emu_getpid)
    env["SHADOW_TPU_PID"] = str(api.process.pid)
    # per-host file namespace: the plugin's cwd is its host's data dir
    # (reference slave.c data-dir layout: each host gets hostDataPath and
    # plugins run against it), so relative paths isolate per host
    host_dir = host_data_dir(api.host)
    env["SHADOW_TPU_DATA_DIR"] = os.path.abspath(host_dir)
    if extra_env:
        env.update(extra_env)
    # stdout/stderr go to per-process files (the reference writes each
    # plugin's output under its host data dir, slave.c data-dir layout);
    # a pipe could deadlock a chatty plugin against our blocking read loop
    import tempfile
    out_file = tempfile.NamedTemporaryFile(
        mode="w+b", prefix=f"shadow-{name.replace('/', '_')}-", suffix=".out",
        delete=False)
    try:
        proc = subprocess.Popen([binary] + list(args), env=env,
                                pass_fds=(child_side.fileno(),),
                                stdout=out_file, stderr=subprocess.STDOUT,
                                cwd=host_dir, close_fds=True)
    except OSError as e:
        log.warning("native", f"{name}: failed to exec {binary}: {e}")
        child_side.close()
        sim_side.close()
        out_file.close()
        os.unlink(out_file.name)
        return 127
    _live_children.append(proc)
    child_side.close()
    kernel = NativeKernel(api, sim_side)
    tracer = get_tracer()
    wd = _watchdog_sec(api)
    stall_after = _fault_stall_after(api)
    served = 0
    try:
        # the shim's constructor sends a GETTIME before the plugin's main()
        # runs, so the first request arrives within exec latency.  A binary
        # the shim cannot interpose (statically linked, exec'd helper)
        # would otherwise block the whole simulator in the first read —
        # bound that wait and fail loudly instead.
        # Wall-clock pressure must not change simulation outcomes, so a
        # slow-but-alive child gets generous retries; only a child that is
        # alive yet silent for the full watchdog budget (the shim speaks
        # before main() runs, so silence means it isn't interposed) is
        # killed.
        import select as _select
        spoke = False
        waited = 0.0
        slice_sec = min(10.0, wd)
        while waited < wd:
            readable, _, _ = _select.select([sim_side], [], [], slice_sec)
            if readable or proc.poll() is not None:
                spoke = True
                break
            waited += slice_sec
        if not spoke:
            log.warning("native",
                        f"{name}: {binary} never spoke the interposition "
                        "protocol (statically linked? exec'd a helper?); "
                        "killing it")
            raise OSError("plugin not interposable")
        # select only guarantees one readable byte: bound the header read
        # too, so a child that writes a partial/garbage header then hangs
        # fails loudly instead of freezing the simulator
        sim_side.settimeout(min(30.0, wd))
        try:
            hdr = _read_exact_raising(sim_side, REQ_HDR.size)
        except TimeoutError:
            log.warning("native",
                        f"{name}: {binary} sent a partial first header and "
                        "stalled; killing it")
            raise OSError("plugin handshake timeout")
        # stall watchdog for the whole run: a TIMEOUT (as opposed to EOF)
        # means the plugin went silent without exiting — a supervised kill:
        # the simulated process is marked exited with the reason, the host
        # and round loop continue (the finally block kills + reaps the OS
        # process)
        sim_side.settimeout(wd)
        first = True
        while True:
            if not first:
                try:
                    hdr = _read_exact_raising(sim_side, REQ_HDR.size)
                except TimeoutError:
                    _supervise_kill(
                        api, f"no syscall for {wd:.0f}s wall (SIGSTOP'd? "
                        "busy spin without syscalls?); watchdog killing "
                        "the plugin")
                    hdr = None
            first = False
            if hdr is None:
                break
            length, op, a, b, c, d = REQ_HDR.unpack(hdr)
            plen = length - REQ_HDR.size
            payload = b""
            if plen > 0:
                # the payload read must distinguish timeout from EOF too: a
                # plugin frozen MID-REQUEST (header delivered, payload
                # stalled — exactly where a SIGSTOP can land) is a watchdog
                # kill, not a silent exit
                try:
                    payload = _read_exact_raising(sim_side, plen)
                except TimeoutError:
                    _supervise_kill(
                        api, f"request truncated mid-payload for "
                        f"{wd:.0f}s wall; watchdog killing the plugin")
                    payload = None
                except OSError:
                    payload = None      # reset mid-payload = plugin exit
                if payload is None:
                    break
            if tracer.enabled:
                ret, resp_payload = yield from _dispatch_traced(
                    tracer, kernel, name, op, a, b, c, d, payload)
            else:
                ret, resp_payload = yield from kernel.dispatch(
                    op, a, b, c, d, payload)
            resp = RESP_HDR.pack(RESP_HDR.size + len(resp_payload), 0,
                                 int(ret), api.now_ns()) + resp_payload
            try:
                sim_side.sendall(resp)
            except TimeoutError:
                # response stuck for the full watchdog budget: the plugin
                # stopped draining its socket mid-syscall — same supervised
                # teardown as request-side silence
                _supervise_kill(
                    api, f"response undeliverable for {wd:.0f}s wall; "
                    "watchdog killing the plugin")
                break
            except OSError:
                break
            served += 1
            if stall_after and served == stall_after:
                # fault harness (plugin-stall:NAME:NREQ): freeze the child
                # mid-syscall-stream, deterministically — the next request
                # read must trip the watchdog, never hang the simulator
                import signal as _signal
                log.warning("native",
                            f"{name}: fault injection — SIGSTOP after "
                            f"request #{served}")
                os.kill(proc.pid, _signal.SIGSTOP)
    finally:
        sim_side.close()
        if proc.poll() is None:
            proc.kill()
        proc.wait()
        if proc in _live_children:
            _live_children.remove(proc)
        out_file.flush()
        out_file.seek(0)
        captured = out_file.read()
        out_file.close()
        os.unlink(out_file.name)
        api.process.app_state = {"stdout": captured,
                                 "returncode": proc.returncode}
        if captured:
            log.debug("native", f"{name} output: {captured[:2000]!r}")
    if getattr(api.process, "supervised_kill", None):
        return 124          # timeout convention; routed to the supervision
                            # ledger by process._finish, not plugin_errors
    rc = kernel.exit_code if kernel.exit_code is not None else proc.returncode
    return rc if rc is not None else 0


def make_native_app(binary: str):
    """Registry adapter: a plugin path that is a real executable becomes an
    app whose main serves the interposition protocol."""
    def app_main(api, args):
        rc = yield from run_native_plugin(api, args, binary)
        return rc
    return app_main


# ---------------------------------------------------------------------------
# Pooled plugins: many instances per OS process (native/pool/pool_main.cc).
#
# The reference hosts thousands of plugin namespaces in ONE process via its
# custom elf-loader (dlmopen, SURVEY.md §2.7); shadow_pool is the same
# capability on glibc dlmopen.  Plugins must be `.so`s linked against
# libshadow_preload.so (reference plugins likewise link shadow's libs).
# Each pool holds up to POOL_CAPACITY instances (glibc's DL_NNS namespace
# limit is 16); the manager spawns additional pools as needed, so N
# instances cost ceil(N / POOL_CAPACITY) OS processes instead of N.
# ---------------------------------------------------------------------------

POOL_CAPACITY = 13
_POOL_BIN = os.path.join(os.path.dirname(_PRELOAD_LIB), "shadow_pool")


class NativePool:
    """One shadow_pool helper process + its control channel."""

    def __init__(self, extra_env: Optional[dict] = None):
        self.control, child_control = real_socket.socketpair()
        env = dict(os.environ)
        if extra_env:
            env.update(extra_env)
        env.pop("SHADOW_TPU_FD", None)  # the pool itself is not interposed
        # every dlmopen namespace carries its own libc/shim static TLS; the
        # default surplus covers ~10 namespaces, so raise it (the reference
        # solved the same problem by computing LD_STATIC_TLS_EXTRA before
        # re-exec, main.c:283-320 — glibc 2.35+ exposes it as a tunable)
        tls = "glibc.rtld.optional_static_tls=4096000"
        env["GLIBC_TUNABLES"] = (env["GLIBC_TUNABLES"] + ":" + tls
                                 if env.get("GLIBC_TUNABLES") else tls)
        # let pooled plugin .so's resolve libshadow_preload.so
        lib_dir = os.path.dirname(_PRELOAD_LIB)
        env["LD_LIBRARY_PATH"] = (lib_dir + ":" + env["LD_LIBRARY_PATH"]
                                  if env.get("LD_LIBRARY_PATH") else lib_dir)
        # pass_fds preserves the parent's fd number; tell the pool which
        env["SHADOW_POOL_CONTROL_FD"] = str(child_control.fileno())
        self.proc = subprocess.Popen(
            [_POOL_BIN], env=env, pass_fds=(child_control.fileno(),),
            stdout=subprocess.DEVNULL, close_fds=True)
        child_control.close()
        _live_children.append(self.proc)
        self.count = 0

    def add_instance(self, so_path: str, args: List[str], vpid: int,
                     data_dir: str = ""):
        """Returns the simulator-side protocol socket for the new instance.
        ``data_dir`` is the instance's host data dir (op 2 payload leads
        with it), cached by the namespace's shim for per-host absolute-path
        virtualization (shim_files.cc)."""
        sim_side, inst_side = real_socket.socketpair()
        argv = [so_path] + list(args)
        payload = data_dir.encode() + b"\0" \
            + b"".join(a.encode() + b"\0" for a in argv)
        hdr = struct.pack("<IIq", 16 + len(payload), 2, int(vpid))
        real_socket.send_fds(self.control, [hdr + payload],
                             [inst_side.fileno()])
        inst_side.close()
        self.count += 1
        return sim_side

    def close(self) -> None:
        try:
            self.control.close()
        except OSError:
            pass


def _pool_for(engine) -> NativePool:
    pools = getattr(engine, "_native_pools", None)
    if pools is None:
        pools = engine._native_pools = []
    if not pools or pools[-1].count >= POOL_CAPACITY \
            or pools[-1].proc.poll() is not None:
        pools.append(NativePool(
            extra_env=getattr(engine, "plugin_environment", None)))
    return pools[-1]


def run_pooled_plugin(api, args: List[str], so_path: str):
    """App-main generator serving one pooled plugin instance: same protocol
    loop as run_native_plugin, but the instance lives inside a shared
    shadow_pool process instead of its own."""
    log = get_logger()
    name = api.process.name
    engine = api.host.engine
    pool = _pool_for(engine)
    host_dir = host_data_dir(api.host)
    try:
        sim_side = pool.add_instance(so_path, args, api.process.pid,
                                     os.path.abspath(host_dir))
    except OSError as e:
        log.warning("native", f"{name}: pool add_instance failed: {e}")
        return 127
    kernel = NativeKernel(api, sim_side)
    tracer = get_tracer()
    wd = _watchdog_sec(api)
    sim_side.settimeout(wd)
    try:
        while True:
            try:
                hdr = _read_exact_raising(sim_side, REQ_HDR.size)
            except TimeoutError:
                _supervise_kill(
                    api, f"no syscall for {wd:.0f}s wall; watchdog "
                    "retiring the pooled instance")
                hdr = None
            if hdr is None:
                break
            length, op, a, b, c, d = REQ_HDR.unpack(hdr)
            plen = length - REQ_HDR.size
            payload = b""
            if plen > 0:
                try:
                    payload = _read_exact_raising(sim_side, plen)
                except TimeoutError:
                    _supervise_kill(
                        api, f"request truncated mid-payload for "
                        f"{wd:.0f}s wall; watchdog retiring the pooled "
                        "instance")
                    payload = None
                except OSError:
                    payload = None      # reset mid-payload = instance exit
                if payload is None:
                    break
            if tracer.enabled:
                ret, resp_payload = yield from _dispatch_traced(
                    tracer, kernel, name, op, a, b, c, d, payload)
            else:
                ret, resp_payload = yield from kernel.dispatch(
                    op, a, b, c, d, payload)
            resp = RESP_HDR.pack(RESP_HDR.size + len(resp_payload), 0,
                                 int(ret), api.now_ns()) + resp_payload
            try:
                sim_side.sendall(resp)
            except TimeoutError:
                # same supervised teardown as the standalone loop: an
                # instance that stops draining its socket mid-response is
                # a watchdog fire, not a clean exit
                _supervise_kill(
                    api, f"response undeliverable for {wd:.0f}s wall; "
                    "watchdog retiring the pooled instance")
                break
            except OSError:
                break
    finally:
        sim_side.close()
    if getattr(api.process, "supervised_kill", None):
        return 124
    return kernel.exit_code if kernel.exit_code is not None else 0


def make_pooled_app(so_path: str):
    """Registry adapter for `.so` plugins: hosted in shared pool processes,
    ceil(N/13) OS processes for N instances."""
    def app_main(api, args):
        rc = yield from run_pooled_plugin(api, args, so_path)
        return rc
    return app_main
