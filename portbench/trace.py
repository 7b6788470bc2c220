"""The card's activity over a window, from ``torch.profiler``.

Copied from ``chip_smoke.py`` (``card_trace``, ``busy_intervals``,
``retake``, the marker constants), rewritten to keep each device
interval by name, to time the markers on the monotonic clock the harness
stamps its phases with, and to list the idle gaps between busy intervals.

On the H100 machine the profiler drops the first device events of a
trace, and now and then all of them.  A lead-in of small kernels takes
the first loss; the window's events are those between two marker kernels
(``torch.cuda._sleep``), and a trace that kept both markers kept them all.
:func:`busy_intervals` refuses one that did not (:class:`IncompleteTrace`)
and :func:`retake` runs the window again.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List, Tuple

MARKER = "spin"
MARKER_CYCLES = 1000
MARKER_GUARD_S = 0.5
LEAD_IN = 2000
LEAD_IN_GAP_S = 0.0005


class IncompleteTrace(Exception):
    """A trace that lacks one of its two marker kernels."""


@contextlib.contextmanager
def card_trace(trace: bool):
    """The card's activity over the body under torch.profiler (nothing when
    not ``trace``), the profile as the context's value, the body between
    two marker kernels whose launches are stamped on ``time.monotonic``
    in ``prof.marker_host_s``."""
    if not trace:
        yield None
        return
    import torch
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])
    prof.marker_host_s = []
    with prof:
        torch.cuda.synchronize()
        time.sleep(MARKER_GUARD_S)
        lead = torch.zeros(1, device="cuda")
        for _ in range(LEAD_IN):
            lead.add_(1)
            time.sleep(LEAD_IN_GAP_S)
        torch.cuda.synchronize()
        prof.marker_host_s.append(time.monotonic())
        torch.cuda._sleep(MARKER_CYCLES)
        torch.cuda.synchronize()
        yield prof
        torch.cuda.synchronize()
        prof.marker_host_s.append(time.monotonic())
        torch.cuda._sleep(MARKER_CYCLES)
        torch.cuda.synchronize()
        time.sleep(MARKER_GUARD_S)


def retake(run: Callable, takes: Callable[[], bool]):
    """``run()`` (a traced window, run anew each time) again while its
    trace is incomplete and ``takes()`` still allows another take."""
    while True:
        try:
            return run()
        except IncompleteTrace as e:
            if not takes():
                raise
            print(f"trace: take incomplete ({e}); the window runs again",
                  flush=True)


def busy_intervals(prof) -> Dict:
    """The card's time between the two markers: every kernel, copy and set
    interval merged where they overlap (``busy_s``), the marker-to-marker
    span (``window_s``), the seconds of each device operation by name, the
    merged busy intervals, and the offset that turns the trace's clock
    (seconds) into the host's monotonic clock."""
    from torch.autograd import DeviceType
    events = [(e.time_range.start * 1e-6, e.time_range.end * 1e-6, e.name)
              for e in prof.events() if e.device_type == DeviceType.CUDA]
    markers = sorted(a for a, _b, name in events if MARKER in name)
    if len(markers) != 2:
        rest = sorted(a for a, _b, name in events if MARKER not in name)
        raise IncompleteTrace(
            f"{len(markers)} of its 2 marker kernels; {len(rest)} other "
            "device events")
    spans: List[Tuple[float, float]] = []
    by_name: Dict[str, List[float]] = {}
    for a, b, name in events:
        if MARKER in name or not markers[0] < a < markers[1]:
            continue
        spans.append((a, b))
        by_name.setdefault(name, []).append(b - a)
    spans.sort()
    merged: List[List[float]] = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged)
    return {"busy_s": busy, "window_s": markers[1] - markers[0],
            "by_name": by_name, "merged": merged,
            "bounds": (markers[0], markers[1]),
            "to_host_s": prof.marker_host_s[0] - markers[0]}


def top_ops(tr: Dict, n: int = 10) -> List[List]:
    """The ``n`` device operations that took most time: [name, seconds]."""
    tot = sorted(((sum(v), k) for k, v in tr["by_name"].items()),
                 reverse=True)
    return [[k, s] for s, k in tot[:n]]


def idle_gaps(tr: Dict, label: Callable[[float], str],
              n: int = 10) -> List[List]:
    """The ``n`` longest idle gaps in the window, each [what the host was
    doing at its middle, seconds]; ``label`` takes a host monotonic time."""
    edges = [tr["bounds"][0]]
    for a, b in tr["merged"]:
        edges += [a, b]
    edges.append(tr["bounds"][1])
    gaps = [(edges[i + 1] - edges[i], edges[i])
            for i in range(0, len(edges) - 1, 2) if edges[i + 1] > edges[i]]
    gaps.sort(reverse=True)
    off = tr["to_host_s"]
    return [[label(start + d / 2 + off), d] for d, start in gaps[:n]]
