"""Simulated epoll.

Capability of the reference's Epoll (host/descriptor/epoll.c): watches
descriptor status bits via the listener mechanism, maintains a ready set,
and — crucially — is the glue that resumes virtual processes: when a watched
descriptor becomes ready, the owning process gets a ``process_continue``
wakeup (epoll.c drives this in the reference; here the Process registers a
wakeup callback).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .base import Descriptor, S_CLOSED, S_READABLE, S_WRITABLE

# >>> simgen:begin region=epoll-bits spec=293c930bb679 body=d97e3afb8d41
EPOLLIN = 0x001
EPOLLOUT = 0x004
EPOLLERR = 0x008
EPOLLHUP = 0x010
# <<< simgen:end region=epoll-bits
EPOLLET = 1 << 31


def _revents_from_status(status: int, want: int) -> int:
    """The readiness computation, from an already-read status word — ONE
    status read per refresh (the native-plane mirror of this function is
    dataplane.cc ep_revents; the two are a simtwin epoll-readiness
    surface)."""
    r = 0
    if (want & EPOLLIN) and (status & S_READABLE):
        r |= EPOLLIN
    if (want & EPOLLOUT) and (status & S_WRITABLE):
        r |= EPOLLOUT
    if status & S_CLOSED:
        r |= EPOLLHUP
    return r


class Epoll(Descriptor):
    def __init__(self, host, handle: int):
        super().__init__(host, handle, "epoll")
        self._watches: Dict[int, Tuple[Descriptor, int, object]] = {}  # fd -> (desc, events, data)
        self._ready: Dict[int, int] = {}  # fd -> revents
        # edge-trigger bookkeeping (reference epoll.c EWF_EDGETRIGGER,
        # :275-305): an ET watch reports a condition only when it BECOMES
        # true; collecting it re-arms the edge
        self._prev: Dict[int, int] = {}   # fd -> last observed revents
        self._wakeup_callbacks: List = []

    # -- control -----------------------------------------------------------
    @staticmethod
    def _native_plane_of(desc) -> Optional[object]:
        """The C plane when ``desc`` is a C-plane socket (its status bits
        and this epoll's readiness computation then live natively —
        ISSUE 12 C-side readiness cache), else None."""
        return getattr(desc, "plane", None)

    def ctl_add(self, desc: Descriptor, events: int, data=None) -> None:
        if desc.handle in self._watches:
            raise FileExistsError("EEXIST")
        self._watches[desc.handle] = (desc, events, data)
        plane = self._native_plane_of(desc)
        if plane is not None:
            # the watch registers in C: revents are computed at
            # status-change time natively and delivered (CB_EPOLL) only
            # when the epoll-visible outcome changes — no per-change
            # Python recompute, no listener
            tok = plane.ep_token(self)
            r = plane.c.ep_add(tok, desc.sid, events & 0xFFFFFFFF)
            self._apply_native_revents(desc.handle, r)
            return
        desc.add_listener(self._on_status)
        self._refresh(desc)

    def ctl_mod(self, desc: Descriptor, events: int, data=None) -> None:
        if desc.handle not in self._watches:
            raise FileNotFoundError("ENOENT")
        self._watches[desc.handle] = (desc, events, data)
        plane = self._native_plane_of(desc)
        if plane is not None:
            tok = plane.ep_token(self)
            r = plane.c.ep_mod(tok, desc.sid, events & 0xFFFFFFFF)
            self._apply_native_revents(desc.handle, r)
            return
        self._refresh(desc)

    def ctl_del(self, desc: Descriptor) -> None:
        if desc.handle not in self._watches:
            raise FileNotFoundError("ENOENT")
        del self._watches[desc.handle]
        plane = self._native_plane_of(desc)
        if plane is not None:
            plane.c.ep_del(plane.ep_token(self), desc.sid)
        else:
            desc.remove_listener(self._on_status)
        self._ready.pop(desc.handle, None)
        self._prev.pop(desc.handle, None)
        self._update_own_status()

    # -- status tracking ---------------------------------------------------
    def _revents_for(self, desc: Descriptor, want: int) -> int:
        return _revents_from_status(desc.status, want)

    def _refresh(self, desc: Descriptor) -> None:
        entry = self._watches.get(desc.handle)
        if entry is None:
            return
        _, want, _ = entry
        r = self._revents_for(desc, want)
        if want & EPOLLET:
            # edge-triggered: only 0->1 transitions become reportable; the
            # pending set accumulates until wait() collects (and re-arms)
            prev = self._prev.get(desc.handle, 0)
            self._prev[desc.handle] = r
            edges = r & ~prev
            if edges:
                newly = desc.handle not in self._ready
                self._ready[desc.handle] = self._ready.get(desc.handle, 0) | edges
                if newly:
                    self._notify_wakeups()
        elif r:
            newly = desc.handle not in self._ready
            self._ready[desc.handle] = r
            if newly:
                self._notify_wakeups()
        else:
            self._ready.pop(desc.handle, None)
        self._update_own_status()

    def _on_status(self, desc: Descriptor, changed_bits: int) -> None:
        self._refresh(desc)

    def _apply_native_revents(self, fd: int, r: int) -> None:
        """Apply a C-computed readiness delivery for a native-socket watch:
        the dict bookkeeping of _refresh with the revents already decided
        (LT: the full current set; ET: the fresh edges).  Transition order
        across Python and native watches is preserved naturally — the
        delivery arrives synchronously at the status change, and _ready is
        ONE insertion-ordered dict for both kinds."""
        entry = self._watches.get(fd)
        if entry is None:
            return
        _, want, _ = entry
        if want & EPOLLET:
            if r:
                newly = fd not in self._ready
                self._ready[fd] = self._ready.get(fd, 0) | r
                if newly:
                    self._notify_wakeups()
        elif r:
            newly = fd not in self._ready
            self._ready[fd] = r
            if newly:
                self._notify_wakeups()
        else:
            self._ready.pop(fd, None)
        self._update_own_status()

    def _update_own_status(self) -> None:
        # an epoll fd is itself readable when it has ready events (epoll
        # nesting works in the reference too)
        self.adjust_status(S_READABLE, bool(self._ready))

    # -- wakeup integration ------------------------------------------------
    def add_wakeup_callback(self, cb) -> None:
        if cb not in self._wakeup_callbacks:
            self._wakeup_callbacks.append(cb)

    def remove_wakeup_callback(self, cb) -> None:
        if cb in self._wakeup_callbacks:
            self._wakeup_callbacks.remove(cb)

    def _notify_wakeups(self) -> None:
        for cb in list(self._wakeup_callbacks):
            cb()

    # -- wait --------------------------------------------------------------
    def wait(self, max_events: int = 64) -> List[Tuple[object, int]]:
        """Non-blocking collect of (data, revents); blocking semantics are
        provided by the process layer (green thread suspends until the
        wakeup callback fires).

        Native-socket entries are cross-checked against the LIVE C status
        at collect time: a desynced readiness cache (the poison drill —
        and the failure mode of any future C-side bug) fails loudly here
        instead of handing the app a wake for data that is not there."""
        out = []
        for fd, revents in list(self._ready.items())[:max_events]:
            desc, want, data = self._watches[fd]
            if not (want & EPOLLET) \
                    and self._native_plane_of(desc) is not None:
                live = _revents_from_status(desc.status, want)
                if live != revents:
                    raise RuntimeError(
                        f"epoll readiness cache desync on fd {fd}: C cache "
                        f"delivered revents {revents:#x} but live status "
                        f"computes {live:#x} — refusing to deliver a wrong "
                        "wake")
            out.append((data if data is not None else fd, revents))
            if want & EPOLLET:
                # collected: the edge is consumed until the next transition
                del self._ready[fd]
        if out:
            self._update_own_status()
        return out

    def has_ready(self) -> bool:
        return bool(self._ready)
