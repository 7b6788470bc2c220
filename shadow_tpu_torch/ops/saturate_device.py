"""Fully device-resident bandwidth saturation: token-bucket pacing, drop-tail
queue admission and the interface refill task's lifetime, for H independent
constant-bit-rate flows, in one device program.

Port of the JAX package's ``ops/saturate_device.py``.  The model is an exact
twin of the engine's interface dynamics for one fixed-size packet per 1 ms
tick per source (reference hot path: network_interface.c:421-455 receive
loop, :121-183 self-suspending refill, router_queue_static.c drop-tail):

* the refill task refills only while it is alive, and it stays alive
  exactly while the queue is non-empty after the tick's final drain;
* a tick's arrival drains with PRE-refill tokens when the refill event
  shares its timestamp;
* whole-packet token spending and drop-tail admission against a
  packet-capacity queue, whose effective capacity is ``qcap + 1`` (one
  packet is staged outside the router queue while any is waiting).

Three layers:

* the plain torch version :func:`saturate_run_torch` (a Python loop over
  ticks, any device) and the numpy twin :func:`saturate_run_numpy` (copied
  unchanged);
* the dispatch :func:`saturate_run`: on CPU tensors the plain version, on
  CUDA tensors one launch of the hand-written kernel ``csrc/saturate.cu``
  (one thread per host, every tick in registers), counted in
  ``saturate_run.launches``;
* :class:`DeviceSaturate`, which sizes the buckets the way the engine does.
"""

from __future__ import annotations

import ctypes
from typing import Tuple, Union

import numpy as np
import torch

from ..core import defs
from ..device import resolve_device
from ._build import check_tensor, entry
from .bandwidth import bucket_params

Scalar = Union[int, torch.Tensor]


def saturate_run_torch(first_tick: torch.Tensor, n_pkts: torch.Tensor,
                       size: Scalar, refill: torch.Tensor,
                       capacity: torch.Tensor, qcap_pkts: Scalar,
                       ticks: Scalar) -> Tuple[torch.Tensor, ...]:
    """Plain torch version of the JAX package's ``saturate_run``: per tick
    and host, one packet arrives while the flow is active (first_tick <= t <
    first_tick + n_pkts); drop-tail admission; drain with pre-refill
    tokens; if the refill task is alive, refill then drain again; the task
    stays alive iff the queue is non-empty afterwards.  Returns (delivered,
    dropped, queue, tokens) per host, int64.  Pure."""
    size, qcap, ticks = int(size), int(qcap_pkts), int(ticks)
    zeros = torch.zeros_like(first_tick)
    tokens = capacity.clone()
    queue = zeros.clone()
    alive = torch.zeros_like(first_tick, dtype=torch.bool)
    delivered = zeros.clone()
    dropped = zeros.clone()
    last = first_tick + n_pkts
    for t in range(ticks):
        arr = ((first_tick <= t) & (last > t)).to(torch.int64)
        admit = torch.minimum(arr, (qcap + 1 - queue).clamp(min=0))
        dropped = dropped + (arr - admit)
        queue = queue + admit
        n1 = torch.minimum(queue, torch.div(tokens, size,
                                            rounding_mode="floor"))
        queue = queue - n1
        tokens = tokens - n1 * size
        delivered = delivered + n1
        tokens = torch.where(alive, torch.minimum(capacity, tokens + refill),
                             tokens)
        n2 = torch.where(alive, torch.minimum(
            queue, torch.div(tokens, size, rounding_mode="floor")), zeros)
        queue = queue - n2
        tokens = tokens - n2 * size
        delivered = delivered + n2
        alive = queue > 0
    return delivered, dropped, queue, tokens


def saturate_run_numpy(first_tick: np.ndarray, n_pkts: np.ndarray,
                       size: int, refill: np.ndarray, capacity: np.ndarray,
                       qcap_pkts: int, ticks: int):
    """Bit-identical host twin — the parity oracle for the device loop."""
    h = len(first_tick)
    tokens = capacity.astype(np.int64).copy()
    queue = np.zeros(h, dtype=np.int64)
    alive = np.zeros(h, dtype=bool)
    delivered = np.zeros(h, dtype=np.int64)
    dropped = np.zeros(h, dtype=np.int64)
    for t in range(ticks):
        arr = ((t >= first_tick) & (t < first_tick + n_pkts)) \
            .astype(np.int64)
        admit = np.minimum(arr, np.maximum(qcap_pkts + 1 - queue, 0))
        dropped += arr - admit
        queue += admit
        n1 = np.minimum(queue, tokens // size)
        queue -= n1
        tokens -= n1 * size
        delivered += n1
        tok_ref = np.minimum(capacity, tokens + refill)
        tokens = np.where(alive, tok_ref, tokens)
        n2 = np.where(alive, np.minimum(queue, tokens // size), 0)
        queue -= n2
        tokens -= n2 * size
        delivered += n2
        alive = queue > 0
    return delivered, dropped, queue, tokens


_VP = ctypes.c_void_p
_I64 = ctypes.c_int64
_ARGTYPES = [_VP] * 4 + [_I64] * 4 + [_VP] * 5


def saturate_run(first_tick: torch.Tensor, n_pkts: torch.Tensor,
                 size: Scalar, refill: torch.Tensor, capacity: torch.Tensor,
                 qcap_pkts: Scalar, ticks: Scalar) -> Tuple[torch.Tensor, ...]:
    """The saturation model for ``ticks`` 1 ms ticks (the JAX package's
    ``saturate_run`` argument list; the four [H] operands int64).  On CPU
    tensors the plain version; on CUDA tensors one launch of
    csrc/saturate.cu on the current stream, no synchronisation, counted in
    ``saturate_run.launches``.  Returns (delivered, dropped, queue, tokens)
    int64 [H] on the operands' device."""
    dev = first_tick.device
    if dev.type == "cpu":
        return saturate_run_torch(first_tick, n_pkts, size, refill, capacity,
                                  qcap_pkts, ticks)
    if dev.type != "cuda":
        raise ValueError(f"saturate_run: unsupported device {dev}")
    h = first_tick.shape[0]
    for name, t in (("first_tick", first_tick), ("n_pkts", n_pkts),
                    ("refill", refill), ("capacity", capacity)):
        check_tensor(f"saturate_run: {name}", t, torch.int64, (h,), dev)
    size, qcap, ticks = int(size), int(qcap_pkts), int(ticks)
    if h < 1 or size < 1:
        raise ValueError(f"saturate_run: needs H >= 1 and size >= 1, got "
                         f"H={h}, size={size}")
    outs = tuple(torch.empty(h, dtype=torch.int64, device=dev)
                 for _ in range(4))
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = entry("saturate", "saturate_launch", _ARGTYPES)(
        first_tick.data_ptr(), n_pkts.data_ptr(), refill.data_ptr(),
        capacity.data_ptr(), h, size, qcap, ticks,
        *(o.data_ptr() for o in outs), stream)
    if rc != 0:
        raise RuntimeError(f"saturate kernel launch failed: CUDA error {rc} "
                           f"(H={h}, ticks={ticks})")
    saturate_run.launches += 1
    return outs


saturate_run.launches = 0


class DeviceSaturate:
    """H independent CBR flows into H throttled receivers, parameterized the
    way the engine is (KiB/s bandwidths), on ``device`` (default the card;
    ``"cpu"`` runs the plain version)."""

    def __init__(self, bw_down_kibps: np.ndarray, payload_bytes: int = 958,
                 qcap_pkts: int = 1024, device: str = "cuda"):
        refill, capacity = bucket_params(np.asarray(bw_down_kibps))
        self.refill = refill.astype(np.int64)
        self.capacity = capacity.astype(np.int64)
        self.size = payload_bytes + defs.CONFIG_HEADER_SIZE_UDPIPETH
        self.qcap_pkts = qcap_pkts
        self.device = resolve_device(device)
        self._refill = torch.as_tensor(self.refill, device=self.device)
        self._capacity = torch.as_tensor(self.capacity, device=self.device)

    def run_device(self, first_tick: np.ndarray, n_pkts: np.ndarray,
                   ticks: int):
        """One call of :func:`saturate_run` (on the card: the flows
        uploaded, one launch, the four [H] results read back).  Returns
        numpy (delivered, dropped, queue, tokens)."""
        out = saturate_run(
            torch.as_tensor(np.asarray(first_tick, dtype=np.int64),
                            device=self.device),
            torch.as_tensor(np.asarray(n_pkts, dtype=np.int64),
                            device=self.device),
            self.size, self._refill, self._capacity, self.qcap_pkts, ticks)
        return tuple(o.cpu().numpy() for o in out)

    def run_numpy(self, first_tick: np.ndarray, n_pkts: np.ndarray,
                  ticks: int):
        return saturate_run_numpy(first_tick, n_pkts, self.size,
                                  self.refill, self.capacity,
                                  self.qcap_pkts, ticks)
