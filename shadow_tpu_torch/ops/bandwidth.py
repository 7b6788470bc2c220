"""Device-side token-bucket admission: the bandwidth term of the north star.

Port of the JAX package's ``ops/bandwidth.py``.  Reference semantics being
modeled (host/network_interface.c:421-455 receive loop + :93-95/:207-214
refill):

* each host's receive bucket holds ``tokens`` bytes, capacity
  ``refill * CAPACITY_FACTOR + MTU``, and gains ``refill`` bytes at every
  1 ms boundary while there is pending work;
* arriving packets drain in FIFO order; a packet is delivered when the
  bucket covers its full size, otherwise it waits for the refill tick that
  covers it.  The capacity cap only binds across idle gaps.

:func:`admit_sorted` computes one round's per-packet admission time for
every host at once over a batch sorted by (dst_row, arrival, order), so
each host's packets form a contiguous FIFO run.  On CPU tensors it runs the
plain torch version :func:`admit_sorted_torch`; on CUDA tensors one launch
of the hand-written kernel ``csrc/admit_sorted.cu`` (one thread per host
run: a block a tile of ADMIT_TILE lanes staged in shared memory, or, for a
batch of at most ADMIT_LANES_MAX lanes, a thread a lane), counted in
``admit_sorted.launches``.  :class:`BandwidthKernel` sorts
and pads a batch on the host, as the JAX class does.  The engine does not
use this kernel (the interface's self-suspending refill task also refills
the send bucket, so receive-side pacing decided ahead of time would not
keep the CPU policies' digests); ``bucket_params`` sizes every device-plane
node's bucket.
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import numpy as np
import torch

from ..core import defs, stime
from ..device import resolve_device
from ._build import check_tensor, entry

REFILL_NS = 1000000   # == defs.INTERFACE_REFILL_INTERVAL_NS (1 ms)
ADMIT_TILE = 768      # csrc/admit_sorted.cu TILE: the lanes a block owns
ADMIT_LANES_MAX = 4096  # csrc/admit_sorted.cu LANES_MAX: above, the tiles


def bucket_params(rate_kibps: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Vector twin of host/network_interface.py TokenBucket.__init__."""
    time_factor = stime.SIM_TIME_SEC // REFILL_NS
    refill = (np.asarray(rate_kibps).astype(np.int64) * 1024) // time_factor
    capacity = refill * defs.INTERFACE_CAPACITY_FACTOR + defs.CONFIG_MTU
    return refill, capacity


def _fdiv(a: torch.Tensor, b) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def admit_sorted_torch(dst_rows: torch.Tensor, sizes: torch.Tensor,
                       arrive: torch.Tensor, valid: torch.Tensor,
                       tokens0: torch.Tensor, refill: torch.Tensor,
                       capacity: torch.Tensor) -> torch.Tensor:
    """Plain torch version of the JAX package's ``admit_sorted``, the scan

        start_i = max(arrive_i, admit_{i-1})
        avail   = min(cap, tokens + ref * (tick(start_i) - tick_state))
        admit_i = start_i                  if avail >= size_i
                = (tick(start_i)+k)*REFILL with k = ceil((size-avail)/ref)

    with ref = max(refill, 1), whose carry resets from tokens0 at each valid
    lane whose dst differs from the previous VALID lane's (invalid lanes
    output 0 and leave the carry alone).  The runs between resets are
    independent, so the loop steps every run at once, one position a step.
    The contract is the JAX function's: dst_rows sorted over every lane,
    invalid lanes included.  There the two agree bit for bit.  Where an
    invalid lane of another dst sits inside a run (only an unsorted batch
    has one), JAX's scan resets its tick, tokens and admit at that lane and
    this keeps them (ROADMAP C4).  Returns int64 [N].  Pure."""
    dev = sizes.device
    n = sizes.shape[0]
    h = refill.shape[0]
    i64 = torch.int64
    admits = torch.zeros(n, dtype=i64, device=dev)
    vi = torch.nonzero(valid.to(torch.bool), as_tuple=True)[0]
    if vi.numel() == 0:
        return admits
    d = dst_rows[vi].to(i64)
    opens = torch.ones_like(d, dtype=torch.bool)
    opens[1:] = d[1:] != d[:-1]
    run = torch.cumsum(opens.to(i64), 0) - 1
    starts = torch.nonzero(opens, as_tuple=True)[0]
    pos = torch.arange(vi.numel(), device=dev) - starts[run]
    longest = int(pos.max()) + 1
    lane = torch.full((starts.numel(), longest), -1, dtype=i64, device=dev)
    lane[run, pos] = vi
    row = d[starts].clamp(0, h - 1)   # the kernel clamps its gathers too
    ref = refill[row].clamp(min=1)
    cap = capacity[row]
    tick = _fdiv(arrive[vi[starts]], REFILL_NS)
    tok = tokens0[row]
    prev = torch.zeros_like(tok)
    for k in range(longest):
        li = lane[:, k]
        live = li >= 0
        li = li.clamp(min=0)
        size = sizes[li]
        start = torch.maximum(arrive[li], prev)
        stick = _fdiv(start, REFILL_NS)
        avail = torch.minimum(cap, tok + ref * (stick - tick))
        kneed = (size - avail).clamp(min=0)
        kk = _fdiv(kneed + ref - 1, ref)
        admit = torch.where(kneed > 0, (stick + kk) * REFILL_NS, start)
        tok = torch.where(live, torch.minimum(cap, avail + kk * ref) - size,
                          tok)
        tick = torch.where(live, torch.where(kneed > 0, stick + kk, stick),
                           tick)
        prev = torch.where(live, admit, prev)
        admits[li[live]] = admit[live]
    return admits


_VP = ctypes.c_void_p
_I64 = ctypes.c_int64
_ARGTYPES = [_VP] * 7 + [_I64] * 2 + [_VP] * 2


def admit_sorted(dst_rows: torch.Tensor, sizes: torch.Tensor,
                 arrive: torch.Tensor, valid: torch.Tensor,
                 tokens0: torch.Tensor, refill: torch.Tensor,
                 capacity: torch.Tensor) -> torch.Tensor:
    """FIFO token-bucket admission times for a dst-sorted batch (the JAX
    package's ``admit_sorted`` argument list: dst_rows int32 [N], sizes and
    arrive int64 [N], valid bool [N], tokens0 / refill / capacity int64
    [H]; every valid dst_row in [0, H); dst_rows sorted over every lane,
    invalid lanes included, as :func:`admit_sorted_torch` says, which is
    also what it computes off that contract).  On CPU tensors the plain
    version;
    on CUDA tensors one launch of csrc/admit_sorted.cu on the current
    stream, no synchronisation, counted in ``admit_sorted.launches``.
    Returns int64 [N] admission times (0 on invalid lanes)."""
    dev = sizes.device
    if dev.type == "cpu":
        return admit_sorted_torch(dst_rows, sizes, arrive, valid, tokens0,
                                  refill, capacity)
    if dev.type != "cuda":
        raise ValueError(f"admit_sorted: unsupported device {dev}")
    n = sizes.shape[0]
    h = refill.shape[0]
    check_tensor("admit_sorted: dst_rows", dst_rows, torch.int32, (n,), dev)
    check_tensor("admit_sorted: valid", valid, torch.bool, (n,), dev)
    for name, t, shape in (("sizes", sizes, (n,)), ("arrive", arrive, (n,)),
                           ("tokens0", tokens0, (h,)),
                           ("refill", refill, (h,)),
                           ("capacity", capacity, (h,))):
        check_tensor(f"admit_sorted: {name}", t, torch.int64, shape, dev)
    if n < 1 or h < 1:
        raise ValueError(f"admit_sorted: needs N >= 1 and H >= 1, got N={n}, "
                         f"H={h}")
    admits = torch.empty(n, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = entry("admit_sorted", "admit_sorted_launch", _ARGTYPES)(
        dst_rows.data_ptr(), sizes.data_ptr(), arrive.data_ptr(),
        valid.data_ptr(), tokens0.data_ptr(), refill.data_ptr(),
        capacity.data_ptr(), n, h, admits.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"admit_sorted kernel launch failed: CUDA error "
                           f"{rc} (N={n}, H={h})")
    admit_sorted.launches += 1
    return admits


admit_sorted.launches = 0


def upload(parts: List[np.ndarray], device: torch.device) -> List[torch.Tensor]:
    """The arrays as tensors on ``device`` through ONE host-to-device copy:
    their bytes concatenated (wider types first, so that every part stays
    aligned), copied once, and viewed back as each part's type and shape."""
    raw = np.concatenate([np.ascontiguousarray(a).reshape(-1).view(np.uint8)
                          for a in parts])
    buf = torch.from_numpy(raw).to(device)
    out, off = [], 0
    for a in parts:
        dtype = torch.from_numpy(np.empty(0, dtype=a.dtype)).dtype
        out.append(buf[off:off + a.nbytes].view(dtype).reshape(a.shape))
        off += a.nbytes
    return out


class BandwidthKernel:
    """Host-side wrapper: sorts a round's batch by (dst, arrival, order),
    pads it to a power of two (at least 256), runs :func:`admit_sorted` on
    ``device`` (default the card; ``"cpu"`` runs the plain version) with one
    upload and one read, and scatters the results back to batch order."""

    def __init__(self, rate_down_kibps: np.ndarray, device: str = "cuda"):
        refill, capacity = bucket_params(rate_down_kibps)
        self.device = resolve_device(device)
        self.refill = torch.as_tensor(refill, device=self.device)
        self.capacity = torch.as_tensor(capacity, device=self.device)
        self.capacity_np = capacity
        self.device_calls = 0

    def admit(self, dst_rows: np.ndarray, sizes: np.ndarray,
              arrive: np.ndarray, tokens0: np.ndarray) -> np.ndarray:
        """Admission time per packet (batch order)."""
        n = len(dst_rows)
        if n == 0:
            return np.empty(0, dtype=np.int64)
        b = 1 << max(8, int(np.ceil(np.log2(n))))
        order = np.lexsort((np.arange(n), arrive, dst_rows))
        inv = np.empty(n, dtype=np.int64)
        inv[order] = np.arange(n)

        def pad(a, fill=0):
            out = np.full(b, fill, dtype=a.dtype)
            out[:n] = a
            return out

        valid = np.zeros(b, dtype=bool)
        valid[:n] = True
        sz, arr, tok0, dst, ok = upload(
            [pad(sizes[order].astype(np.int64)),
             pad(arrive[order].astype(np.int64)),
             np.asarray(tokens0, dtype=np.int64),
             pad(dst_rows[order].astype(np.int32)), valid], self.device)
        admits = admit_sorted(dst, sz, arr, ok, tok0, self.refill,
                              self.capacity)
        self.device_calls += 1
        return admits.cpu().numpy()[:n][inv]
