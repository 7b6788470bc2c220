"""Fully device-resident PHOLD: every hop of the classic PDES scheduler
benchmark on the device.

Port of the JAX package's ``ops/phold_device.py``.  PHOLD (reference
src/test/phold/test_phold.c; apps/phold.py is the engine-driven twin): a
fixed population of messages bounces between hosts, each hop at the
receiver's time plus the path latency.  Message state lives on the device,
rounds are conservative lookahead windows exactly like the engine's (window
= the minimum positive latency), and the windows run with no host round
trip.

Semantics (deterministic): message m at host h with ripeness time t
forwards to dst = threefry(key, (m, window)) % (H-1), skipping self, and
arrives at t + latency[h, dst].  A window processes every message with t <
window_end; remaining messages keep their state.  Event count = total hops.

Three layers:

* the plain torch version :func:`phold_run_torch` (a Python loop over
  windows, any device) and the numpy twin :func:`phold_run_numpy` (copied
  unchanged);
* the dispatch :func:`phold_run`: on CPU tensors the plain version, on CUDA
  tensors one launch of the hand-written kernel ``csrc/phold.cu`` (the whole
  run in one block), counted in ``phold_run.launches``;
* :class:`DevicePhold`, which builds an instance with the JAX class's numpy
  calls in the same order, so one seed gives the same arrays.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple, Union

import numpy as np
import torch

from ..core.rng import threefry2x32_torch
from ..device import resolve_device
from ._build import check_tensor, entry

NO_LOOKAHEAD = 2 ** 62


def _key_words(key) -> Tuple[int, int]:
    """(key_lo, key_hi) from a uint32 [2] key given as a sequence, an array
    or a tensor."""
    if torch.is_tensor(key):
        key = key.cpu().numpy()
    k = np.asarray(key).reshape(-1)
    if k.shape != (2,):
        raise ValueError(f"phold: the key must be two uint32 words, got "
                         f"shape {k.shape}")
    return int(k[0]) & 0xFFFFFFFF, int(k[1]) & 0xFFFFFFFF


def phold_run_torch(latency_ns: torch.Tensor, msg_host: torch.Tensor,
                    msg_time: torch.Tensor, key: Sequence[int],
                    horizon_ns: Union[int, torch.Tensor],
                    with_windows: bool = False):
    """Plain torch version of the JAX package's ``phold_run``: run to the
    first window whose start is at or past ``horizon_ns``.  Returns
    (msg_host int32 [M], msg_time int64 [M], hops as a 0-d int64 tensor),
    and the windows run as a fourth (0-d int64) with ``with_windows``.
    Pure.  It reads each window's start on the host, which is the plain
    version's privilege; the kernel keeps its loop on the card."""
    dev = msg_time.device
    key_lo, key_hi = _key_words(key)
    horizon = int(horizon_ns)
    n_hosts = latency_ns.shape[0]
    pos = latency_ns[latency_ns > 0]
    lookahead = int(pos.min()) if pos.numel() else NO_LOOKAHEAD
    host = msg_host.to(torch.int64)
    time = msg_time.clone()
    m = host.shape[0]
    idx = torch.arange(m, dtype=torch.int64, device=dev)
    hops = torch.zeros((), dtype=torch.int64, device=dev)
    counter = 0
    while True:
        start = int(time.min())
        if start >= horizon:
            break
        end = (start + lookahead + 2 ** 63) % 2 ** 64 - 2 ** 63  # int64 wrap
        ripe = time < end
        x0, _ = threefry2x32_torch(key_lo, key_hi, idx,
                                   torch.full_like(idx, counter))
        k = torch.remainder(x0, n_hosts - 1)
        dst = torch.where(k >= host, k + 1, k)
        lat = latency_ns[host, dst]
        host = torch.where(ripe, dst, host)
        time = torch.where(ripe, time + lat, time)
        hops = hops + ripe.sum()
        counter += 1
    out = (host.to(torch.int32), time, hops)
    if with_windows:
        out += (torch.tensor(counter, dtype=torch.int64, device=dev),)
    return out


def phold_run_numpy(latency_ns: np.ndarray, msg_host: np.ndarray,
                    msg_time: np.ndarray, key_lo: int, key_hi: int,
                    horizon_ns: int):
    """Bit-identical host twin (same cipher, same window logic) — the
    parity oracle for the device loop."""
    from ..core.rng import threefry2x32_np

    host = msg_host.astype(np.int64).copy()
    time = msg_time.astype(np.int64).copy()
    n_hosts = latency_ns.shape[0]
    pos = latency_ns[latency_ns > 0]
    lookahead = int(pos.min()) if pos.size else 1
    hops = 0
    counter = 0
    m = len(host)
    idx = np.arange(m, dtype=np.uint32)
    while time.min() < horizon_ns:
        end = time.min() + lookahead
        ripe = time < end
        x0, _ = threefry2x32_np(np.uint32(key_lo), np.uint32(key_hi),
                                idx, np.full(m, counter, dtype=np.uint32))
        k = (x0 % np.uint32(n_hosts - 1)).astype(np.int64)
        dst = np.where(k >= host, k + 1, k)
        lat = latency_ns[host, dst]
        host = np.where(ripe, dst, host)
        time = np.where(ripe, time + lat, time)
        hops += int(ripe.sum())
        counter += 1
    return host, time, hops


_VP = ctypes.c_void_p
_I64 = ctypes.c_int64
_U32 = ctypes.c_uint32
_ARGTYPES = ([_VP, _I64, _VP, _VP, _I64, _U32, _U32, _I64] + [_VP] * 4)


def phold_run(latency_ns: torch.Tensor, msg_host: torch.Tensor,
              msg_time: torch.Tensor, key: Sequence[int],
              horizon_ns: Union[int, torch.Tensor],
              with_windows: bool = False):
    """PHOLD to ``horizon_ns`` (the JAX package's ``phold_run`` argument
    list: latency int64 [H, H], msg_host int32 [M], msg_time int64 [M], the
    two key words, the horizon).  On CPU tensors the plain version; on CUDA
    tensors one launch of csrc/phold.cu on the current stream, no
    synchronisation, counted in ``phold_run.launches``.  Returns (msg_host
    int32 [M], msg_time int64 [M], hops as a 0-d int64 tensor), and the
    windows run as a fourth with ``with_windows``."""
    dev = msg_time.device
    if dev.type == "cpu":
        return phold_run_torch(latency_ns, msg_host, msg_time, key,
                               horizon_ns, with_windows)
    if dev.type != "cuda":
        raise ValueError(f"phold_run: unsupported device {dev}")
    h = latency_ns.shape[0]
    m = msg_time.shape[0]
    check_tensor("phold_run: latency_ns", latency_ns, torch.int64, (h, h),
                 dev)
    check_tensor("phold_run: msg_host", msg_host, torch.int32, (m,), dev)
    check_tensor("phold_run: msg_time", msg_time, torch.int64, (m,), dev)
    if h < 2 or m < 1:
        raise ValueError(f"phold_run: needs H >= 2 hosts and M >= 1 "
                         f"messages, got H={h}, M={m}")
    key_lo, key_hi = _key_words(key)
    host_out = torch.empty(m, dtype=torch.int32, device=dev)
    time_out = torch.empty(m, dtype=torch.int64, device=dev)
    stats = torch.empty(2, dtype=torch.int64, device=dev)  # hops, windows
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = entry("phold", "phold_launch", _ARGTYPES)(
        latency_ns.data_ptr(), h, msg_host.data_ptr(), msg_time.data_ptr(),
        m, key_lo, key_hi, int(horizon_ns), host_out.data_ptr(),
        time_out.data_ptr(), stats.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"phold kernel launch failed: CUDA error {rc} "
                           f"(H={h}, M={m})")
    phold_run.launches += 1
    if with_windows:
        return host_out, time_out, stats[0], stats[1]
    return host_out, time_out, stats[0]


phold_run.launches = 0


class DevicePhold:
    """Build a PHOLD instance and run it on ``device`` (default the card;
    ``"cpu"`` runs the plain version)."""

    def __init__(self, n_hosts: int, n_msgs: int, seed: int = 7,
                 min_latency_ms: float = 1.0, max_latency_ms: float = 150.0,
                 device: str = "cuda"):
        rng = np.random.default_rng(seed)
        lat = rng.integers(int(min_latency_ms * 1e6),
                           int(max_latency_ms * 1e6),
                           size=(n_hosts, n_hosts)).astype(np.int64)
        np.fill_diagonal(lat, 0)
        self.latency_np = lat
        self.msg_host = rng.integers(0, n_hosts, size=n_msgs).astype(np.int32)
        self.msg_time = np.zeros(n_msgs, dtype=np.int64)
        self.key_lo = 0xDEADBEEF
        self.key_hi = 0x12345678
        self.device = resolve_device(device)
        self.latency = torch.as_tensor(lat, device=self.device)

    def run_device(self, horizon_ns: int):
        """One call of :func:`phold_run` (on the card: the messages
        uploaded, one launch, the results read back).  Returns numpy
        (msg_host int32, msg_time int64) and the hops as an int."""
        host, time, hops = phold_run(
            self.latency, torch.as_tensor(self.msg_host, device=self.device),
            torch.as_tensor(self.msg_time, device=self.device),
            (self.key_lo, self.key_hi), horizon_ns)
        return host.cpu().numpy(), time.cpu().numpy(), int(hops)

    def run_numpy(self, horizon_ns: int):
        return phold_run_numpy(self.latency_np, self.msg_host, self.msg_time,
                               self.key_lo, self.key_hi, horizon_ns)
