"""The per-round device kernel: all packet hops in a window as one launch.

Reference hot path (worker.c:243-304 ``worker_sendPacket``): for EACH packet,
look up path reliability, draw a uniform, maybe drop, look up path latency,
schedule delivery.  That is a per-packet scalar pipeline; on the card the
same work is one batched launch over the round's whole packet set:

    latency  = L[src_row, dst_row]          # int64 ns gather
    rel      = R[src_row, dst_row]          # f32 gather
    u        = threefry(drop_key, uid)      # counter-based, order-independent
    keep     = bootstrap | rel >= 1 | u <= rel
    deliver  = max(send_time + latency, barrier)   # int64 ns, exact

Determinism contract: the uniform is keyed by the packet uid, not execution
order, and is the bitwise-identical construction the CPU policies use
(core/rng.py), so the CPU and device schedulers drop exactly the same
packets and compute exactly the same delivery times.

Three layers, each testable on its own:

* :func:`packet_hop_packed_reference` — the plain torch version; the CPU
  tests hold it bit-exact against the JAX package's step.
* :func:`packet_hop_packed` — the wrapper: on CPU tensors it runs the plain
  version; on CUDA tensors it launches the hand-written kernel
  (csrc/packet_hop.cu) or raises.  It counts its launches.
* :func:`packet_hop_mapped` — the main path's entry: the same kernel on a
  round's own page-locked host buffers (:class:`MappedRound`), which the
  card reads and writes over the host link, so a round is one launch and
  one event with no copy.  It takes nothing else: a buffer that is not
  page-locked host memory mapped into the card is refused by name, and
  nothing falls back to copies or to the plain version.
* :class:`PacketHopKernel` — owns the device-resident topology tensors, the
  drop key, a CUDA stream and a pool of mapped round buffers; turns a
  round's numpy columns into a launched, not yet materialized
  :class:`HopHandle`.

Batches are padded to power-of-two buckets (as in the JAX package, where
each bucket is one compiled shape); the CUDA kernel compiles once for every
size, so buckets here only bound the buffer pool.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.rng import uniform_np, uniform_torch_pair

MIN_BUCKET = 256
_M32 = 0xFFFFFFFF


def bucket_size(n: int) -> int:
    """Smallest power-of-two bucket >= n (min MIN_BUCKET) — bounds the number
    of distinct padded shapes to log2(max_batch)."""
    b = MIN_BUCKET
    while b < n:
        b <<= 1
    return b


def packet_hop_packed_reference(latency: torch.Tensor,      # int64 [A, A]
                                reliability: torch.Tensor,  # f32   [A, A]
                                packed: torch.Tensor,       # int64 [1+B, 3]
                                key_lo: int, key_hi: int,
                                bootstrap_end: int,
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of the packed hop step (the JAX package's
    ``packet_hop_step_packed``).  Row 0 of ``packed`` is a header: (valid
    row count n, round barrier ns, 0).  Data row layout: word0 = (src_row
    << 32) | dst_row, word1 = the packet uid (uint64 bit pattern), word2 =
    send time ns.  Returns PADDED (deliver int64 [B], keep bool [B]);
    padding lanes come back keep=False.  Rows are clamped to [0, A) as the
    kernel clamps them (they always are in range)."""
    a = latency.shape[0]
    n = packed[0, 0]
    barrier = packed[0, 1]
    w0 = packed[1:, 0]
    uid = packed[1:, 1]
    send = packed[1:, 2]
    src = (w0 >> 32).to(torch.int32).clamp(0, a - 1).long()
    dst = (w0 & _M32).to(torch.int32).clamp(0, a - 1).long()
    # arithmetic >> then mask == logical shift for the uint64 bit pattern
    uid_lo = uid & _M32
    uid_hi = (uid >> 32) & _M32
    valid = torch.arange(w0.shape[0], device=packed.device) < n
    lat = latency[src, dst]
    rel = reliability[src, dst]
    key = (int(key_hi) << 32) | (int(key_lo) & _M32)
    u = uniform_torch_pair(key, uid_lo, uid_hi)
    keep = ((send < bootstrap_end) | (rel >= 1.0) | (u <= rel)) & valid
    deliver = torch.maximum(send + lat, barrier)
    return deliver, keep


_VP = ctypes.c_void_p
_LAUNCH_ARGTYPES = [_VP, _VP, ctypes.c_int, _VP, ctypes.c_int,
                    ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int64,
                    _VP, _VP, _VP]


def _launch_fn():
    """csrc/packet_hop.cu's C entry point, built at first use and bound
    (the library itself is cached by _build.load)."""
    from . import _build
    fn = _build.load("packet_hop").packet_hop_launch
    if fn.argtypes is None:
        fn.argtypes = _LAUNCH_ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _check_matrices(latency, reliability, dev) -> None:
    if latency.device != dev or reliability.device != dev:
        raise ValueError("packet_hop: latency, reliability and the batch "
                         f"must be on one device, got {latency.device}, "
                         f"{reliability.device}, {dev}")
    if latency.dtype != torch.int64 or latency.dim() != 2 \
            or latency.shape[0] != latency.shape[1] or latency.shape[0] < 1:
        raise ValueError("packet_hop: latency must be int64 [A, A], got "
                         f"{latency.dtype} {tuple(latency.shape)}")
    if reliability.dtype != torch.float32 \
            or reliability.shape != latency.shape:
        raise ValueError("packet_hop: reliability must be float32 "
                         f"{tuple(latency.shape)}, got {reliability.dtype} "
                         f"{tuple(reliability.shape)}")
    if latency.shape[0] >= 2 ** 31:
        raise ValueError("packet_hop: A must fit in int32")
    for name, t in (("latency", latency), ("reliability", reliability)):
        if not t.is_contiguous():
            raise ValueError(f"packet_hop: {name} must be contiguous")


def _check_cuda_args(latency, reliability, packed) -> None:
    _check_matrices(latency, reliability, packed.device)
    if packed.dtype != torch.int64 or packed.dim() != 2 \
            or packed.shape[1] != 3 or packed.shape[0] < 2:
        raise ValueError("packet_hop: packed must be int64 [1+B, 3], got "
                         f"{packed.dtype} {tuple(packed.shape)}")
    if packed.shape[0] - 1 >= 2 ** 31:
        raise ValueError("packet_hop: B must fit in int32")
    if not packed.is_contiguous():
        raise ValueError("packet_hop: packed must be contiguous")
    if packed.data_ptr() % 16:
        raise ValueError("packet_hop: packed must be 16-byte aligned (the "
                         "kernel reads it in 16-byte words)")


def packet_hop_packed(latency: torch.Tensor, reliability: torch.Tensor,
                      packed: torch.Tensor, key_lo: int, key_hi: int,
                      bootstrap_end: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The packet-hop step on ``packed``'s device.  CPU tensors run
    :func:`packet_hop_packed_reference`; CUDA tensors launch
    csrc/packet_hop.cu on the current stream (no synchronisation), and a
    refused launch raises.  ``packet_hop_packed.launches`` counts kernel
    launches.  Returns PADDED (deliver int64 [B], keep bool [B])."""
    if packed.device.type == "cpu":
        return packet_hop_packed_reference(latency, reliability, packed,
                                           key_lo, key_hi, bootstrap_end)
    if packed.device.type != "cuda":
        raise ValueError(f"packet_hop: unsupported device {packed.device}")
    _check_cuda_args(latency, reliability, packed)
    b = packed.shape[0] - 1
    deliver = torch.empty(b, dtype=torch.int64, device=packed.device)
    keep = torch.empty(b, dtype=torch.bool, device=packed.device)
    stream = torch.cuda.current_stream(packed.device).cuda_stream
    rc = _launch_fn()(
        latency.data_ptr(), reliability.data_ptr(), latency.shape[0],
        packed.data_ptr(), b, int(key_lo) & _M32, int(key_hi) & _M32,
        int(bootstrap_end), deliver.data_ptr(), keep.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"packet_hop kernel launch failed: CUDA error "
                           f"{rc} (B={b}, A={latency.shape[0]})")
    packet_hop_packed.launches += 1
    return deliver, keep


packet_hop_packed.launches = 0

_HOST_MEMORY = 1      # cudaMemoryTypeHost


class MappedRound:
    """One round's buffers in page-locked host memory that the card reads
    and writes in place: ``packed`` int64 [1+b, 3] (the batch, see
    :func:`packet_hop_packed_reference`), ``deliver`` int64 [b] and
    ``keep`` bool [b], CPU tensors.  Checked once, here: each must be a
    contiguous page-locked tensor (``packed`` 16-byte aligned) that ``cudaPointerGetAttributes`` reports
    as host memory with a device pointer on ``device``; ``ptrs`` holds those
    device pointers (not the host addresses) for the launches.  Anything
    else is refused with a ValueError naming the buffer."""

    __slots__ = ("packed", "deliver", "keep", "b", "device", "ptrs")

    def __init__(self, packed: torch.Tensor, deliver: torch.Tensor,
                 keep: torch.Tensor, device):
        b = packed.shape[0] - 1 if packed.dim() == 2 else -1
        named = (("packed", packed), ("deliver", deliver), ("keep", keep))
        for (name, t), dtype, shape in zip(
                named, (torch.int64, torch.int64, torch.bool),
                ((1 + b, 3), (b,), (b,))):
            if t.device.type != "cpu" or t.dtype != dtype \
                    or tuple(t.shape) != shape or not t.is_contiguous():
                raise ValueError(
                    f"packet_hop_mapped: {name} must be a contiguous {dtype} "
                    f"{shape} host tensor, got {t.dtype} {tuple(t.shape)} on "
                    f"{t.device}")
        for name, t in named:
            if not t.is_pinned():
                raise ValueError(f"packet_hop_mapped: {name} is not "
                                 "page-locked host memory")
        if packed.data_ptr() % 16:
            raise ValueError("packet_hop_mapped: packed must be 16-byte "
                             "aligned (the kernel reads it in 16-byte "
                             "words)")
        if not 1 <= b < 2 ** 31:
            raise ValueError(f"packet_hop_mapped: B = {b} must be in "
                             "[1, 2**31)")
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"packet_hop_mapped: buffers map into a CUDA "
                             f"device, not {self.device}")
        from ._build import entry
        query = entry("packet_hop", "packet_hop_map_host",
                      [_VP, ctypes.POINTER(ctypes.c_int),
                       ctypes.POINTER(_VP)])
        ptrs = []
        with torch.cuda.device(self.device):
            for name, t in named:
                kind, ptr = ctypes.c_int(0), _VP(None)
                rc = query(t.data_ptr(), ctypes.byref(kind),
                           ctypes.byref(ptr))
                if rc != 0:
                    raise RuntimeError(f"packet_hop_mapped: "
                                       f"cudaPointerGetAttributes failed on "
                                       f"{name}: CUDA error {rc}")
                if kind.value != _HOST_MEMORY or not ptr.value:
                    raise ValueError(
                        f"packet_hop_mapped: {name} is not page-locked host "
                        f"memory mapped into {self.device} (memory type "
                        f"{kind.value}, device pointer {ptr.value})")
                ptrs.append(ptr.value)
        self.packed, self.deliver, self.keep = packed, deliver, keep
        self.b = b
        self.ptrs = tuple(ptrs)

    @classmethod
    def allocate(cls, b: int, device) -> "MappedRound":
        """Fresh page-locked buffers for a bucket of ``b`` lanes."""
        return cls(torch.empty((1 + b, 3), dtype=torch.int64,
                               pin_memory=True),
                   torch.empty(b, dtype=torch.int64, pin_memory=True),
                   torch.empty(b, dtype=torch.bool, pin_memory=True), device)


def packet_hop_mapped(latency: torch.Tensor, reliability: torch.Tensor,
                      bufs: MappedRound, key_lo: int, key_hi: int,
                      bootstrap_end: int) -> None:
    """The packet-hop step on a round held in host memory: csrc/packet_hop.cu
    launched once on the current stream, reading ``bufs.packed`` and writing
    ``bufs.deliver`` and ``bufs.keep`` in place over the host link (no
    synchronisation; the caller waits on an event before it reads them).
    The matrices are CUDA tensors on the device ``bufs`` is mapped into.
    A refused launch raises.  Counts ``packet_hop_mapped.launches``."""
    if not isinstance(bufs, MappedRound):
        raise TypeError("packet_hop_mapped: the round's buffers must be a "
                        f"MappedRound, got {type(bufs).__name__}")
    if latency.device != bufs.device:
        raise ValueError(f"packet_hop_mapped: the matrices are on "
                         f"{latency.device}, the buffers mapped into "
                         f"{bufs.device}")
    _check_matrices(latency, reliability, latency.device)
    packed, deliver, keep = bufs.ptrs
    rc = _launch_fn()(
        latency.data_ptr(), reliability.data_ptr(), latency.shape[0],
        packed, bufs.b, int(key_lo) & _M32, int(key_hi) & _M32,
        int(bootstrap_end), deliver, keep,
        torch.cuda.current_stream(latency.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"packet_hop kernel launch failed: CUDA error "
                           f"{rc} (B={bufs.b}, A={latency.shape[0]}, "
                           "host-resident round)")
    packet_hop_mapped.launches += 1


packet_hop_mapped.launches = 0


class HopHandle:
    """One launched chunk.  :meth:`wait` blocks until its results are on
    the host and returns exact-length numpy (deliver int64, keep bool)."""

    __slots__ = ("_n", "_result", "_event", "_outs", "_release")

    def __init__(self, n: int, result=None, event=None, outs=None,
                 release=None):
        self._n = n
        self._result = result
        self._event = event
        self._outs = outs
        self._release = release

    def wait(self) -> Tuple[np.ndarray, np.ndarray]:
        if self._result is None:
            self._event.synchronize()
            deliver, keep = self._outs
            n = self._n
            self._result = (deliver.numpy()[:n].copy(),
                            keep.numpy()[:n].copy())
            # only now may the next launch overwrite these buffers
            self._release()
            self._outs = self._event = self._release = None
        return self._result


class _PinnedPool:
    """Free lists of host buffer sets per bucket size b, each made by
    ``make(b)``.  A set is held by its HopHandle from launch until its event
    has completed, so no chunk's input or output is overwritten by a later
    chunk while the card may still use it."""

    def __init__(self, make):
        self._make = make
        self._lock = threading.Lock()
        self._free: Dict[int, List] = {}

    def acquire(self, b: int):
        with self._lock:
            free = self._free.get(b)
            if free:
                return free.pop()
        return self._make(b)

    def release(self, b: int, bufs) -> None:
        with self._lock:
            self._free.setdefault(b, []).append(bufs)


class PacketHopKernel:
    """Host-side wrapper owning the device-resident topology tensors and the
    drop key; turns a round's (src_row, dst_row, uid, send_time) arrays into
    (deliver_time, keep) with one kernel launch."""

    # >0: batches below this size are computed with the bitwise-identical
    # vectorized numpy path (--tpu-device-threshold; 0 = always launch).
    # Only with the matrices on the CPU: on the card every batch launches
    # the kernel, and a kernel built with a threshold is refused.
    DEVICE_THRESHOLD = 0

    def __init__(self, topology, drop_key: int, bootstrap_end_ns: int,
                 device="cuda", device_threshold: Optional[int] = None):
        lat, rel = topology.device_tensors(device)
        self._init(np.asarray(topology.latency_ns),
                   np.asarray(topology.reliability, dtype=np.float32),
                   lat, rel, drop_key, bootstrap_end_ns, device_threshold)

    @classmethod
    def from_arrays(cls, latency_ns: np.ndarray, reliability: np.ndarray,
                    drop_key: int, bootstrap_end_ns: int, device,
                    device_threshold: Optional[int] = None
                    ) -> "PacketHopKernel":
        """A kernel over given [A, A] matrices (int64 ns latency, f32
        reliability) — e.g. the ones another package's Topology built, so
        one topology can feed both."""
        self = cls.__new__(cls)
        lat_np = np.ascontiguousarray(latency_ns, dtype=np.int64)
        rel_np = np.ascontiguousarray(reliability, dtype=np.float32)
        self._init(lat_np, rel_np,
                   torch.as_tensor(lat_np, device=device),
                   torch.as_tensor(rel_np, device=device),
                   drop_key, bootstrap_end_ns, device_threshold)
        return self

    def _init(self, lat_np, rel_np, lat, rel, drop_key, bootstrap_end_ns,
              device_threshold) -> None:
        assert lat.dtype == torch.int64 and rel.dtype == torch.float32
        self.latency = lat
        self.reliability = rel
        self._init_host(lat_np, rel_np, lat.device, drop_key,
                        bootstrap_end_ns, device_threshold)
        self.stream = self._pool = None
        if self.device.type == "cuda":
            self.stream = torch.cuda.Stream(self.device)
            # the matrices were uploaded on the current stream
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
            self._pool = self._new_pool()

    def _init_host(self, lat_np, rel_np, device, drop_key,
                   bootstrap_end_ns, device_threshold) -> None:
        """The host side: the kernel's device, the matrices' host copies,
        the drop key, the counters, the threshold's check."""
        self.device = device
        # host-side copies for the small-batch path (CPU device only) and
        # the tests' numpy oracle
        self.latency_np = lat_np
        self.reliability_np = rel_np
        kv = int(drop_key) & 0xFFFFFFFFFFFFFFFF
        self.drop_key = kv
        self.key_lo = kv & _M32
        self.key_hi = (kv >> 32) & _M32
        self.bootstrap_end_ns = int(bootstrap_end_ns)
        self.device_calls = 0
        self.host_calls = 0
        if device_threshold is not None:
            self.DEVICE_THRESHOLD = device_threshold
        if self.DEVICE_THRESHOLD > 0 and self.device.type != "cpu":
            raise ValueError(
                "--tpu-device-threshold > 0 would compute small batches on "
                "the host while the matrices are on the card; it runs only "
                "with --device cpu")
        # distinct padded batch shapes seen (the engine heartbeat reports
        # it; here it sizes the pinned pool, the kernel compiles once)
        self.buckets_seen: set = set()

    def _new_pool(self) -> _PinnedPool:
        """The card's round buffers: :class:`MappedRound` sets."""
        return _PinnedPool(
            functools.partial(MappedRound.allocate, device=self.device))

    def _step_numpy(self, src_rows, dst_rows, uids, send_times,
                    barrier_ns: int) -> Tuple[np.ndarray, np.ndarray]:
        """Vectorized host path for small rounds — same math, same cipher,
        same f32 comparison as the device kernel, so the decision per packet
        is identical bit for bit."""
        lat = self.latency_np[src_rows, dst_rows]
        rel = self.reliability_np[src_rows, dst_rows]
        u = uniform_np(self.drop_key, uids.astype(np.uint64))
        send_times = send_times.astype(np.int64, copy=False)
        keep = ((send_times < self.bootstrap_end_ns)
                | (rel >= np.float32(1.0))
                | (u.astype(np.float32) <= rel))
        deliver = np.maximum(send_times + lat, np.int64(barrier_ns))
        self.host_calls += 1
        return deliver, keep

    def _pack(self, src_rows, dst_rows, uids, send_times, b: int,
              barrier_ns: int, out: Optional[np.ndarray] = None
              ) -> np.ndarray:
        """Assemble the [1+b, 3] int64 packed batch (header row 0 carries
        n and the barrier — see packet_hop_packed_reference's layout), into
        ``out`` when given (a reused pinned buffer: padding rows are
        zeroed)."""
        n = len(src_rows)
        if out is None:
            out = np.zeros((1 + b, 3), dtype=np.int64)
        else:
            out[n + 1:] = 0
        out[0] = (n, barrier_ns, 0)
        out[1:n + 1, 0] = ((np.asarray(src_rows, dtype=np.int64) << 32)
                           | np.asarray(dst_rows, dtype=np.int64))
        out[1:n + 1, 1] = np.asarray(uids, dtype=np.uint64).view(np.int64)
        out[1:n + 1, 2] = np.asarray(send_times, dtype=np.int64)
        return out

    def launch(self, src_rows: np.ndarray, dst_rows: np.ndarray,
               uids: np.ndarray, send_times: np.ndarray,
               barrier_ns: int) -> HopHandle:
        """Dispatch one chunk WITHOUT waiting for it: the host writes the
        packed batch into a pooled :class:`MappedRound`, the kernel reads
        it and writes deliver/keep back in place over the host link on the
        kernel's own stream, and an event marks the end — one launch and
        one event, no copy.  The caller calls ``.wait()`` on the handle
        when it needs the values (the engine does so at the next round
        boundary), so device work overlaps host-side work; the buffers go
        back to the pool only then.  On the CPU device, the plain version
        and the numpy bypass (DEVICE_THRESHOLD) return finished handles
        with the same interface."""
        n = len(src_rows)
        if n == 0:
            return HopHandle(0, result=(np.empty(0, dtype=np.int64),
                                        np.empty(0, dtype=bool)))
        if self._pool is None and n < self.DEVICE_THRESHOLD:
            return HopHandle(n, result=self._step_numpy(
                np.asarray(src_rows), np.asarray(dst_rows),
                np.asarray(uids), np.asarray(send_times), barrier_ns))
        b = bucket_size(n)
        self.buckets_seen.add(b)
        self.device_calls += 1
        if self._pool is None:
            packed = torch.from_numpy(self._pack(src_rows, dst_rows, uids,
                                                 send_times, b, barrier_ns))
            deliver, keep = packet_hop_packed(
                self.latency, self.reliability, packed, self.key_lo,
                self.key_hi, self.bootstrap_end_ns)
            # simjit: disable=SIM302 -- the CPU device (no pinned pool): the plain hop ran on host tensors, nothing is in flight
            return HopHandle(n, result=(deliver.numpy()[:n],
                                        keep.numpy()[:n]))
        bufs = self._pool.acquire(b)
        # the pool hands out a set only after its last reader's event, and
        # the batch is written before the launch that reads it
        self._pack(src_rows, dst_rows, uids, send_times, b, barrier_ns,
                   out=bufs.packed.numpy())
        return HopHandle(n, event=self._launch_round(bufs),
                         outs=(bufs.deliver, bufs.keep),
                         release=functools.partial(self._pool.release, b,
                                                   bufs))

    def _launch_round(self, bufs: MappedRound):
        """The kernel on ``bufs`` on the kernel's stream, and the event
        that marks its end."""
        # the launching thread names its device: worker threads launch
        # mid-round chunks (--tpu-chunk) under the policy's launch lock
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            packet_hop_mapped(self.latency, self.reliability, bufs,
                              self.key_lo, self.key_hi,
                              self.bootstrap_end_ns)
            event = torch.cuda.Event()
            event.record(self.stream)
        return event

    def step(self, src_rows: np.ndarray, dst_rows: np.ndarray,
             uids: np.ndarray, send_times: np.ndarray,
             barrier_ns: int) -> Tuple[np.ndarray, np.ndarray]:
        """Synchronous variant of launch (materialized, exact-length)."""
        return self.launch(src_rows, dst_rows, uids, send_times,
                           barrier_ns).wait()


# ---------------------------------------------------------------------------
# The sharded round step (the JAX package's ShardedPacketHopKernel over a
# 1-D mesh, ``--tpu-devices N``): here N shards on one device
# (parallel/mesh.device_mesh).  Two layouts, as there:
#
# * batch-sharded (default): the padded batch is split into N slices, the
#   matrices whole; one launch of csrc/packet_hop_sharded.cu covers the N
#   slices (the grid's y axis), the whole matrices its one row slice;
# * matrix-sharded (``--tpu-shard-matrix``): the matrices are split into N
#   row slices (each its own allocation, the rows padded to a multiple of
#   N), the batch whole; csrc/packet_hop_sharded.cu gathers from the shard
#   that owns the packet's src row, which is the psum's sum over the shards
#   (every other shard's term is an exact zero).
#
# The row slices' pointers sit in a device table (:class:`ShardRows`)
# built once per kernel object, so a launch carries no pointer block.
#
# Both take the six padded columns of :meth:`ShardedPacketHopKernel.
# padded_batch` (the JAX package's ``_padded_batch``): src, dst int32;
# uid_lo, uid_hi (uint32 bit patterns held as int32); send int64; valid bool.
# ---------------------------------------------------------------------------

COLUMNS = ("src", "dst", "uid_lo", "uid_hi", "send", "valid")
_COL_DTYPES = (torch.int32, torch.int32, torch.int32, torch.int32,
               torch.int64, torch.bool)


def _finish_hop_torch(lat, rel, uid_lo, uid_hi, send, valid, key_lo: int,
                      key_hi: int, bootstrap_end: int, barrier: int):
    """The JAX package's ``_finish_hop``: the Threefry draw keyed by the
    uid, keep and deliver."""
    key = (int(key_hi) << 32) | (int(key_lo) & _M32)
    u = uniform_torch_pair(key, uid_lo.to(torch.int64) & _M32,
                           uid_hi.to(torch.int64) & _M32)
    keep = ((send < int(bootstrap_end)) | (rel >= 1.0) | (u <= rel)) & valid
    deliver = torch.clamp(send + lat, min=int(barrier))
    return deliver, keep


def packet_hop_step_reference(latency, reliability, src, dst, uid_lo,
                              uid_hi, send, valid, key_lo: int, key_hi: int,
                              bootstrap_end: int, barrier: int):
    """Plain torch version of the JAX package's ``packet_hop_step`` (the
    unpacked hop on padded columns): returns (deliver int64, keep bool),
    the batch's length.  Rows are clamped to [0, A), as the kernel clamps
    them."""
    a = latency.shape[0]
    s = src.to(torch.int64).clamp(0, a - 1)
    t = dst.to(torch.int64).clamp(0, a - 1)
    return _finish_hop_torch(latency[s, t], reliability[s, t], uid_lo,
                             uid_hi, send, valid, key_lo, key_hi,
                             bootstrap_end, barrier)


def batch_sharded_hop_reference(latency, reliability, cols, n_shards: int,
                                key_lo: int, key_hi: int, bootstrap_end: int,
                                barrier: int):
    """Plain torch version of the JAX package's ``_make_batch_sharded_2out``:
    :func:`packet_hop_step_reference` on each of the ``n_shards`` slices of
    the padded columns ``cols``, the results concatenated."""
    b = cols[0].shape[0]
    w = b // n_shards
    outs = [packet_hop_step_reference(
        latency, reliability, *(c[s * w:(s + 1) * w] for c in cols),
        key_lo, key_hi, bootstrap_end, barrier) for s in range(n_shards)]
    return (torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs]))


def matrix_sharded_hop_reference(lat_rows, rel_rows, a: int, cols,
                                 key_lo: int, key_hi: int, bootstrap_end: int,
                                 barrier: int, first: int = 0):
    """Plain torch version of the JAX package's
    ``_make_matrix_sharded_hop_step``: shard s holds rows s*rows_per ..
    of the [A_pad, A] matrices (``lat_rows[s]``, ``rel_rows[s]``); each
    shard gathers the entries whose src row it owns (zeros elsewhere) and
    the sum over the shards (the psum) assembles them, then the hop is
    finished.  Adding f32 zeros is exact for reliabilities >= 0.  With
    ``first``, the slices are shards ``first ..`` of a larger mesh (a
    card's): only the lanes whose src row they own are finished right."""
    src, dst, uid_lo, uid_hi, send, valid = cols
    s_ = src.to(torch.int64).clamp(0, a - 1)
    t_ = dst.to(torch.int64).clamp(0, a - 1)
    rows_per = lat_rows[0].shape[0]
    lat = torch.zeros(src.shape[0], dtype=torch.int64, device=src.device)
    rel = torch.zeros(src.shape[0], dtype=torch.float32, device=src.device)
    for s, (lr, rr) in enumerate(zip(lat_rows, rel_rows)):
        local = s_ - (first + s) * rows_per
        mine = (local >= 0) & (local < rows_per)
        idx = local.clamp(0, rows_per - 1)
        lat = lat + torch.where(mine, lr[idx, t_], torch.zeros_like(lat))
        rel = rel + torch.where(mine, rr[idx, t_], torch.zeros_like(rel))
    return _finish_hop_torch(lat, rel, uid_lo, uid_hi, send, valid, key_lo,
                             key_hi, bootstrap_end, barrier)


def _check_cols(name: str, cols, b: int, dev) -> None:
    from ._build import check_tensor
    for col, dtype, c in zip(COLUMNS, _COL_DTYPES, cols):
        check_tensor(f"{name}: {col}", c, dtype, (b,), dev)


_SHARDED_ARGTYPES = ([_VP] + [ctypes.c_int] * 4 + [_VP] * 6
                     + [ctypes.c_int] * 2
                     + [ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int64,
                        ctypes.c_int64, _VP, _VP, _VP])
MAX_SHARDS = 64       # csrc/packet_hop_sharded.cu MAX_SHARDS


class ShardRows:
    """The D row slices of the [A_pad, A] path matrices (shard s's
    [rows_per, A] int64 latency and f32 reliability rows; one slice of all
    A rows is the whole matrix, as the batch-sharded layout gives it) and,
    on the card, the device table of their pointers that
    csrc/packet_hop_sharded.cu reads (int64 [2D]: the latency rows'
    addresses, then the reliability rows'): built once, so no launch
    carries a pointer block.  Over several cards a card's ShardRows holds
    its own shards' slices, ``first`` the first of them, of the mesh's
    ``total`` (the slices of the whole mesh cover A)."""

    def __init__(self, lat_rows, rel_rows, a: int, first: int = 0,
                 total: Optional[int] = None):
        d = len(lat_rows)
        if not 1 <= d <= MAX_SHARDS or len(rel_rows) != d:
            raise ValueError(f"packet_hop_sharded: 1 to {MAX_SHARDS} "
                             f"shards, got {d} latency and {len(rel_rows)} "
                             "reliability slices")
        rows_per = lat_rows[0].shape[0]
        total = d if total is None else int(total)
        if total * rows_per < a or not 0 <= first <= total - d:
            raise ValueError(f"packet_hop_sharded: slices {first} to "
                             f"{first + d - 1} of {total} x {rows_per} rows "
                             f"for A = {a}")
        dev = lat_rows[0].device
        if dev.type == "cuda":
            from ._build import check_tensor
            for s in range(d):
                check_tensor(f"packet_hop_sharded: latency rows {s}",
                             lat_rows[s], torch.int64, (rows_per, a), dev)
                check_tensor(f"packet_hop_sharded: reliability rows {s}",
                             rel_rows[s], torch.float32, (rows_per, a), dev)
        self.lat = list(lat_rows)
        self.rel = list(rel_rows)
        self.a = int(a)
        self.d = d
        self.first = int(first)
        self.rows_per = int(rows_per)
        self.table = None if dev.type != "cuda" else torch.tensor(
            [t.data_ptr() for t in self.lat + self.rel], dtype=torch.int64,
            device=dev)


def packet_hop_sharded(rows: ShardRows, cols, key_lo: int, key_hi: int,
                       bootstrap_end: int, barrier: int, slices: int = 1):
    """The hop on the six columns ``cols`` over the row slices ``rows``,
    the batch cut into ``slices`` equal slices (the batch-sharded layout:
    ``slices`` = D over the whole matrices; the matrix-sharded layout: one
    slice over D row slices).  CPU tensors run
    :func:`batch_sharded_hop_reference` (``slices`` > 1) or
    :func:`matrix_sharded_hop_reference`; CUDA tensors launch
    csrc/packet_hop_sharded.cu once on the current stream (no
    synchronisation), and a refused launch raises.  Counts
    ``packet_hop_sharded.launches``.  Returns (deliver int64, keep bool)."""
    dev = cols[0].device
    b = cols[0].shape[0]
    if slices < 1 or b % slices or (slices > 1 and rows.d != 1):
        raise ValueError(f"packet_hop_sharded: {slices} batch slices of "
                         f"B = {b} over {rows.d} row slices")
    keys = (key_lo, key_hi, bootstrap_end, barrier)
    if dev.type == "cpu":
        if slices > 1:
            return batch_sharded_hop_reference(rows.lat[0], rows.rel[0],
                                               cols, slices, *keys)
        return matrix_sharded_hop_reference(rows.lat, rows.rel, rows.a,
                                            cols, *keys)
    if dev.type != "cuda":
        raise ValueError(f"packet_hop_sharded: unsupported device {dev}")
    if rows.table is None or rows.table.device != dev:
        raise ValueError(f"packet_hop_sharded: row slices not on {dev}")
    from ._build import entry
    _check_cols("packet_hop_sharded", cols, b, dev)
    deliver = torch.empty(b, dtype=torch.int64, device=dev)
    keep = torch.empty(b, dtype=torch.bool, device=dev)
    rc = entry("packet_hop_sharded", "packet_hop_sharded_launch",
               _SHARDED_ARGTYPES)(
        rows.table.data_ptr(), rows.d, rows.rows_per, rows.a, rows.first,
        *(c.data_ptr() for c in cols), slices, b // slices,
        int(key_lo) & _M32, int(key_hi) & _M32, int(bootstrap_end),
        int(barrier), deliver.data_ptr(), keep.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"packet_hop_sharded kernel launch failed: CUDA "
                           f"error {rc} (B={b}, A={rows.a}, D={rows.d}, "
                           f"slices={slices})")
    packet_hop_sharded.launches += 1
    return deliver, keep


packet_hop_sharded.launches = 0


class _ColumnPool(_PinnedPool):
    """Pinned (columns, deliver, keep) sets per bucket b: the six padded
    columns share one byte buffer (send int64 first, then src, dst, uid_lo,
    uid_hi int32, then valid), so a batch goes up in one copy."""

    COL_BYTES = 8 + 4 * 4 + 1

    def __init__(self):
        super().__init__(lambda b: (
            torch.empty(b * self.COL_BYTES, dtype=torch.uint8,
                        pin_memory=True),
            torch.empty(b, dtype=torch.int64, pin_memory=True),
            torch.empty(b, dtype=torch.bool, pin_memory=True)))


def column_views(buf: torch.Tensor, b: int) -> tuple:
    """The six columns (COLUMNS order) as views of one byte buffer of
    ``b * _ColumnPool.COL_BYTES`` bytes."""
    send = buf[:8 * b].view(torch.int64)
    i32 = [buf[8 * b + 4 * k * b:8 * b + 4 * (k + 1) * b].view(torch.int32)
           for k in range(4)]
    valid = buf[24 * b:25 * b].view(torch.bool)
    return (i32[0], i32[1], i32[2], i32[3], send, valid)


class CardRound:
    """One sharded round's page-locked host buffers, read and written in
    place by every card of a mesh that spans cards: ``cols`` (the six
    padded columns in one byte buffer, :func:`column_views`), ``deliver``
    int64 [b] and ``keep`` bool [b].  Checked once per card, here: each
    buffer must be host memory that ``cudaPointerGetAttributes``, with the
    card current, reports mapped into it (unified addressing); ``ptrs[c]``
    holds card c's device pointers.  Anything else is refused with a
    ValueError naming the buffer and the card."""

    __slots__ = ("cols", "deliver", "keep", "b", "ptrs")

    def __init__(self, cols: torch.Tensor, deliver: torch.Tensor,
                 keep: torch.Tensor, cards):
        b = deliver.shape[0]
        named = (("columns", cols), ("deliver", deliver), ("keep", keep))
        for name, t in named:
            if t.device.type != "cpu" or not t.is_pinned() \
                    or not t.is_contiguous():
                raise ValueError(f"packet_hop_sharded: the round's {name} "
                                 "must be contiguous page-locked host memory")
        from ._build import entry
        query = entry("packet_hop", "packet_hop_map_host",
                      [_VP, ctypes.POINTER(ctypes.c_int),
                       ctypes.POINTER(_VP)])
        self.ptrs = []
        for card in cards:
            got = []
            with torch.cuda.device(card):
                for name, t in named:
                    kind, ptr = ctypes.c_int(0), _VP(None)
                    rc = query(t.data_ptr(), ctypes.byref(kind),
                               ctypes.byref(ptr))
                    if rc != 0:
                        raise RuntimeError(
                            f"packet_hop_sharded: cudaPointerGetAttributes "
                            f"failed on the round's {name} for {card}: CUDA "
                            f"error {rc}")
                    if kind.value != _HOST_MEMORY or not ptr.value:
                        raise ValueError(
                            f"packet_hop_sharded: the round's {name} is not "
                            f"page-locked host memory mapped into {card} "
                            f"(memory type {kind.value}, device pointer "
                            f"{ptr.value})")
                    got.append(ptr.value)
            self.ptrs.append(tuple(got))
        self.cols, self.deliver, self.keep, self.b = cols, deliver, keep, b

    @classmethod
    def allocate(cls, b: int, cards) -> "CardRound":
        return cls(torch.empty(b * _ColumnPool.COL_BYTES, dtype=torch.uint8,
                               pin_memory=True),
                   torch.empty(b, dtype=torch.int64, pin_memory=True),
                   torch.empty(b, dtype=torch.bool, pin_memory=True), cards)

    def lane_ptrs(self, c: int, lane0: int) -> tuple:
        """Card c's device pointers of the columns (COLUMNS order), deliver
        and keep, each at lane ``lane0``."""
        cols, dv, kp = self.ptrs[c]
        b = self.b
        return (cols + 8 * b + 4 * lane0, cols + 12 * b + 4 * lane0,
                cols + 16 * b + 4 * lane0, cols + 20 * b + 4 * lane0,
                cols + 8 * lane0, cols + 24 * b + lane0, dv + 8 * lane0,
                kp + lane0)


class _Events:
    """Several cards' events, waited on together (a HopHandle's)."""

    __slots__ = ("events",)

    def __init__(self, events):
        self.events = events

    def synchronize(self) -> None:
        for e in self.events:
            e.synchronize()


def packet_hop_sharded_mapped(rows: ShardRows, ptrs, lanes: int,
                              slices: int, key_lo: int, key_hi: int,
                              bootstrap_end: int, barrier: int) -> None:
    """csrc/packet_hop_sharded.cu once on the current stream of the card
    ``rows`` lie on (which must be current), over ``lanes`` lanes of a
    round held in page-locked host memory (``ptrs``: CardRound.lane_ptrs),
    cut into ``slices`` slices; results written in place, no
    synchronisation.  Counts ``packet_hop_sharded.launches``."""
    from ._build import check_tensor, entry
    if rows.table is None:
        raise ValueError("packet_hop_sharded: the row slices are not on a "
                         "card")
    dev = rows.table.device
    check_tensor("packet_hop_sharded: row table", rows.table, torch.int64,
                 (2 * rows.d,), dev)
    if lanes < 1 or lanes % slices:
        raise ValueError(f"packet_hop_sharded: {slices} slices of {lanes} "
                         "lanes")
    rc = entry("packet_hop_sharded", "packet_hop_sharded_launch",
               _SHARDED_ARGTYPES)(
        rows.table.data_ptr(), rows.d, rows.rows_per, rows.a, rows.first,
        *ptrs[:6], slices, lanes // slices, int(key_lo) & _M32,
        int(key_hi) & _M32, int(bootstrap_end), int(barrier), ptrs[6],
        ptrs[7], torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"packet_hop_sharded kernel launch failed on "
                           f"{dev}: CUDA error {rc} (lanes={lanes}, "
                           f"A={rows.a}, slices {rows.first} to "
                           f"{rows.first + rows.d - 1})")
    packet_hop_sharded.launches += 1


class ShardedPacketHopKernel(PacketHopKernel):
    """Sharded kernel: same ``launch``/``step`` API as PacketHopKernel, over
    a mesh of ``n_devices`` shards on one device (``--tpu-devices N``).

    * default — the padded batch is split into N slices (the bucket is at
      least N*MIN_BUCKET and a multiple of N), the matrices whole; one
      launch of the sharded hop per batch covers the N slices, the
      matrices its one row slice;
    * ``shard_matrix=True`` (``--tpu-shard-matrix``) — the matrices are
      split into N row slices, each its own allocation (rows padded up to
      a multiple of N with zero rows, never indexed: src rows always
      reference real vertices), the batch whole; one launch of the
      matrix-sharded hop per batch.

    ``launch`` returns a :class:`HopHandle`, as the single-device kernel's
    does: on the card the columns go up in one copy from pinned memory on
    the kernel's stream and the results come back into pinned memory."""

    def __init__(self, topology, drop_key: int, bootstrap_end_ns: int,
                 n_devices: int, shard_matrix: bool = False, device="cuda",
                 device_threshold: Optional[int] = None, cards=None):
        from ..parallel.mesh import device_mesh
        mesh = device_mesh(n_devices, axis_names=("pkt",), device=device,
                           cards=cards)
        if mesh.n_cards > 1:
            self._init_cards(np.asarray(topology.latency_ns),
                             np.asarray(topology.reliability,
                                        dtype=np.float32),
                             mesh, drop_key, bootstrap_end_ns, shard_matrix,
                             device_threshold)
            return
        super().__init__(topology, drop_key, bootstrap_end_ns, device,
                         device_threshold)
        self._shard_init(n_devices, shard_matrix)

    @classmethod
    def from_arrays(cls, latency_ns, reliability, drop_key: int,
                    bootstrap_end_ns: int, device, n_devices: int = 2,
                    shard_matrix: bool = False,
                    device_threshold: Optional[int] = None, cards=None
                    ) -> "ShardedPacketHopKernel":
        from ..parallel.mesh import device_mesh
        mesh = device_mesh(n_devices, axis_names=("pkt",), device=device,
                           cards=cards)
        if mesh.n_cards > 1:
            self = cls.__new__(cls)
            self._init_cards(np.ascontiguousarray(latency_ns, dtype=np.int64),
                             np.ascontiguousarray(reliability,
                                                  dtype=np.float32),
                             mesh, drop_key, bootstrap_end_ns, shard_matrix,
                             device_threshold)
            return self
        self = super().from_arrays(latency_ns, reliability, drop_key,
                                   bootstrap_end_ns, device,
                                   device_threshold)
        self._shard_init(n_devices, shard_matrix)
        return self

    # -- over several cards ------------------------------------------------
    def _init_cards(self, lat_np, rel_np, mesh, drop_key, bootstrap_end_ns,
                    shard_matrix: bool, device_threshold) -> None:
        """The hop over the cards of ``mesh``, built from the host matrices:
        batch-sharded, each card holds the whole [A, A] matrices and takes
        its shards' slices of a batch; row-sharded, each card holds its own
        shards' row slices only (no card ever holds the whole matrix) and
        writes the lanes whose src row it owns.  On the card a round's
        columns and results stay in page-locked host memory that every
        card reads and writes through its mapping (:class:`CardRound`)."""
        self._init_host(lat_np, rel_np, mesh.device, drop_key,
                        bootstrap_end_ns, device_threshold)
        self.mesh = mesh
        self.cards = tuple(mesh.cards)
        self.n_devices = mesh.n_shards
        self.shard_matrix = bool(shard_matrix)
        self.a = int(lat_np.shape[0])
        self.latency = self.reliability = None
        on_gpu = self.device.type == "cuda"
        from ._build import on_card
        d, a = self.n_devices, self.a
        per = -(-a // d)
        if shard_matrix:
            lat_p = np.zeros((per * d, a), dtype=np.int64)
            rel_p = np.zeros((per * d, a), dtype=np.float32)
            lat_p[:a], rel_p[:a] = lat_np, rel_np
        self.card_rows, self.lat_rows, self.rel_rows = [], [], []
        self.streams = []
        for c, card in enumerate(self.cards):
            shards = mesh.shards_of(c)
            with on_card(card, slot=c):
                if shard_matrix:
                    lat = [torch.as_tensor(lat_p[s * per:(s + 1) * per],
                                           device=card) for s in shards]
                    rel = [torch.as_tensor(rel_p[s * per:(s + 1) * per],
                                           device=card) for s in shards]
                    rows = ShardRows(lat, rel, a, first=shards.start,
                                     total=d)
                    self.lat_rows += lat
                    self.rel_rows += rel
                else:
                    rows = ShardRows([torch.as_tensor(lat_np, device=card)],
                                     [torch.as_tensor(rel_np, device=card)],
                                     a)
                self.card_rows.append(rows)
            self.streams.append(torch.cuda.Stream(card) if on_gpu else None)
        self.rows = None
        self.stream = None
        self._pool = _PinnedPool(functools.partial(
            CardRound.allocate, cards=self.cards)) if on_gpu else None

    def _card_lanes(self, c: int, b: int) -> Tuple[int, int]:
        """The lanes card c computes of a batch of ``b``: its shards'
        slices (batch layout) or every lane (row layout, where it writes
        the ones it owns)."""
        if self.shard_matrix:
            return 0, b
        w = b // self.n_devices
        r = self.mesh.shards_of(c)
        return r.start * w, r.stop * w

    def _run_cards_cpu(self, cols, barrier_ns: int):
        """The plain versions card by card on CPU "cards": each card's
        lanes (batch layout), or the lanes its rows own (row layout)."""
        b = cols[0].shape[0]
        deliver = torch.zeros(b, dtype=torch.int64)
        keep = torch.zeros(b, dtype=torch.bool)
        keys = (self.key_lo, self.key_hi, self.bootstrap_end_ns, barrier_ns)
        for c, rows in enumerate(self.card_rows):
            lo, hi = self._card_lanes(c, b)
            sub = tuple(x[lo:hi] for x in cols)
            if self.shard_matrix:
                dv, kp = matrix_sharded_hop_reference(
                    rows.lat, rows.rel, rows.a, sub, *keys, first=rows.first)
                owner = sub[0].to(torch.int64).clamp(0, rows.a - 1) \
                    // rows.rows_per
                mine = (owner >= rows.first) & (owner < rows.first + rows.d)
                deliver[lo:hi] = torch.where(mine, dv, deliver[lo:hi])
                keep[lo:hi] = torch.where(mine, kp, keep[lo:hi])
            else:
                n_local = len(self.mesh.shards_of(c))
                dv, kp = batch_sharded_hop_reference(
                    rows.lat[0], rows.rel[0], sub, n_local, *keys)
                deliver[lo:hi], keep[lo:hi] = dv, kp
        return deliver, keep

    def _launch_cards(self, n: int, bufs: "CardRound", b: int,
                      barrier_ns: int) -> HopHandle:
        """One launch a card on the round in page-locked memory, each on
        its card's stream, and the events that mark their ends."""
        from ._build import on_card
        events = []
        for c, card in enumerate(self.cards):
            lo, hi = self._card_lanes(c, b)
            rows = self.card_rows[c]
            slices = 1 if self.shard_matrix \
                else len(self.mesh.shards_of(c))
            with on_card(card, self.streams[c], slot=c):
                packet_hop_sharded_mapped(
                    rows, bufs.lane_ptrs(c, lo), hi - lo, slices,
                    self.key_lo, self.key_hi, self.bootstrap_end_ns,
                    barrier_ns)
                ev = torch.cuda.Event()
                ev.record(self.streams[c])
            events.append(ev)
        return HopHandle(n, event=_Events(events),
                         outs=(bufs.deliver, bufs.keep),
                         release=functools.partial(self._pool.release, b,
                                                   bufs))

    def _shard_init(self, n_devices: int, shard_matrix: bool) -> None:
        from ..parallel.mesh import device_mesh
        self.mesh = device_mesh(n_devices, axis_names=("pkt",),
                                device=self.device)
        self.n_devices = int(n_devices)
        self.shard_matrix = bool(shard_matrix)
        self.card_rows = None
        self.cards = tuple(self.mesh.cards)
        self.a = self.latency.shape[0]
        if shard_matrix:
            rows = self.a
            padded = -(-rows // self.n_devices) * self.n_devices
            per = padded // self.n_devices
            lat = torch.nn.functional.pad(self.latency,
                                          (0, 0, 0, padded - rows))
            rel = torch.nn.functional.pad(self.reliability,
                                          (0, 0, 0, padded - rows))
            # one allocation per shard, as each chip holds its own rows
            self.lat_rows = [lat[s * per:(s + 1) * per].clone()
                             for s in range(self.n_devices)]
            self.rel_rows = [rel[s * per:(s + 1) * per].clone()
                             for s in range(self.n_devices)]
            del lat, rel
            self.rows = ShardRows(self.lat_rows, self.rel_rows, self.a)
        else:
            self.rows = ShardRows([self.latency], [self.reliability], self.a)
        if self.stream is not None:
            self.stream.wait_stream(torch.cuda.current_stream(self.device))

    def _new_pool(self) -> _PinnedPool:
        """The columns' page-locked staging buffers, copied up and back."""
        return _ColumnPool()

    def bucket(self, n: int) -> int:
        """The padded batch length: the power-of-two bucket, at least
        N*MIN_BUCKET, rounded up to a multiple of N."""
        b = max(bucket_size(n), self.n_devices * MIN_BUCKET)
        if b % self.n_devices:
            b = -(-b // self.n_devices) * self.n_devices
        return b

    def padded_batch(self, src_rows, dst_rows, uids, send_times, b: int,
                     out: Optional[tuple] = None) -> tuple:
        """The JAX package's ``_padded_batch``: the round's arrays padded to
        ``b`` with the 64-bit uids split into the (lo, hi) 32-bit pair, as
        the six columns (COLUMNS order) — numpy arrays, or written into the
        views ``out`` (a reused pinned buffer)."""
        n = len(src_rows)
        uids = np.asarray(uids, dtype=np.uint64)
        vals = (np.asarray(src_rows, dtype=np.int32),
                np.asarray(dst_rows, dtype=np.int32),
                (uids & np.uint64(_M32)).astype(np.uint32).view(np.int32),
                (uids >> np.uint64(32)).astype(np.uint32).view(np.int32),
                np.asarray(send_times, dtype=np.int64),
                np.ones(n, dtype=bool))
        if out is None:
            out = tuple(np.zeros(b, dtype=v.dtype) for v in vals)
        else:
            out = tuple(o.numpy() for o in out)
        for o, v in zip(out, vals):
            o[:n] = v
            o[n:] = 0
        return out

    def _run(self, cols, barrier_ns: int):
        """One batch's launch on ``cols`` (tensors on the kernel's
        device): deliver, keep."""
        if self.card_rows is not None:
            return self._run_cards_cpu(cols, barrier_ns)
        return packet_hop_sharded(
            self.rows, cols, self.key_lo, self.key_hi, self.bootstrap_end_ns,
            barrier_ns, slices=1 if self.shard_matrix else self.n_devices)

    def launch(self, src_rows: np.ndarray, dst_rows: np.ndarray,
               uids: np.ndarray, send_times: np.ndarray,
               barrier_ns: int) -> HopHandle:
        n = len(src_rows)
        if n == 0:
            return HopHandle(0, result=(np.empty(0, dtype=np.int64),
                                        np.empty(0, dtype=bool)))
        if self._pool is None and n < self.DEVICE_THRESHOLD:
            # the same numpy bypass as the single-device kernel
            return HopHandle(n, result=self._step_numpy(
                np.asarray(src_rows), np.asarray(dst_rows),
                np.asarray(uids), np.asarray(send_times), barrier_ns))
        b = self.bucket(n)
        self.buckets_seen.add(b)
        self.device_calls += 1
        if self._pool is None:
            cols = tuple(torch.from_numpy(c) for c in self.padded_batch(
                src_rows, dst_rows, uids, send_times, b))
            deliver, keep = self._run(cols, barrier_ns)
            # simjit: disable=SIM302 -- the CPU device (no pinned pool): the plain hop ran on host tensors, nothing is in flight
            return HopHandle(n, result=(deliver.numpy()[:n],
                                        keep.numpy()[:n]))
        bufs = self._pool.acquire(b)
        if self.card_rows is not None:
            self.padded_batch(src_rows, dst_rows, uids, send_times, b,
                              out=column_views(bufs.cols, b))
            return self._launch_cards(n, bufs, b, barrier_ns)
        cols_pin, deliver_pin, keep_pin = bufs
        self.padded_batch(src_rows, dst_rows, uids, send_times, b,
                          out=column_views(cols_pin, b))
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            cols_dev = column_views(cols_pin.to(self.device,
                                                non_blocking=True), b)
            deliver, keep = self._run(cols_dev, barrier_ns)
            deliver_pin.copy_(deliver, non_blocking=True)
            keep_pin.copy_(keep, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self.stream)
        return HopHandle(n, event=event, outs=(deliver_pin, keep_pin),
                         release=functools.partial(self._pool.release, b,
                                                   bufs))
