"""The host side of the host-resident hop (``PacketHopKernel`` on the card:
one launch of csrc/packet_hop.cu a round on page-locked buffers the card
reads and writes in place), on the CPU.

The card path is ``PacketHopKernel.launch``'s pool branch: a buffer set
from the pool, the batch written into it, ``_launch_round`` (on the card:
``packet_hop_mapped`` and an event), and a handle that copies the results
out and returns the set to the pool only after its event.  Here
``_launch_round`` is replaced by a stand-in whose event computes the plain
version when it is waited on, from the buffer as it is THEN, as a card that
runs the kernel late would: a set handed out again while still in flight,
or a batch written after its launch, would give wrong results.  Held
against the numpy cipher (``_step_numpy``): many handles in flight (as
``--tpu-chunk`` makes), waited in another order, from several threads;
a reused set read with its new contents.  ``MappedRound``, the only thing
``packet_hop_mapped`` takes, refuses a tensor that is not page-locked host
memory, naming it, before any CUDA call.  Tolerance: none (exact).
"""

import threading
import types

import numpy as np
import pytest
import torch

from shadow_tpu_torch.ops import round_step as rs

A = 61
DROP_KEY = 0x0123456789ABCDEF
BOOTSTRAP_END = 2_000_000_000


class _LateEvent:
    """What the card's event stands for: the kernel's results, computed
    when the host waits, from the buffers' contents at that moment."""

    def __init__(self, kern, bufs, log):
        self._run = lambda: self._compute(kern, bufs)
        self._log = log
        self.done = False

    @staticmethod
    def _compute(kern, bufs):
        d, k = rs.packet_hop_packed_reference(
            kern.latency, kern.reliability, bufs.packed, kern.key_lo,
            kern.key_hi, kern.bootstrap_end_ns)
        bufs.deliver.copy_(d)
        bufs.keep.copy_(k)

    def synchronize(self):
        assert not self.done, "waited twice"
        self._run()
        self.done = True
        self._log.append(self)


def _host_round(b: int):
    """A buffer set as MappedRound.allocate makes it, without a card."""
    return types.SimpleNamespace(
        packed=torch.empty((1 + b, 3), dtype=torch.int64),
        deliver=torch.empty(b, dtype=torch.int64),
        keep=torch.empty(b, dtype=torch.bool), b=b)


def _kernel(seed=0):
    rng = np.random.default_rng(seed)
    lat = rng.integers(1_000_000, 90_000_000, size=(A, A), dtype=np.int64)
    rel = rng.random((A, A)).astype(np.float32)
    rel[rng.random((A, A)) < 0.3] = 1.0
    kern = rs.PacketHopKernel.from_arrays(lat, rel, DROP_KEY, BOOTSTRAP_END,
                                          "cpu")
    assert kern._pool is None             # the CPU device: no pool
    made, waited = [], []

    def make(b):
        bufs = _host_round(b)
        made.append(bufs)
        return bufs

    kern._pool = rs._PinnedPool(make)
    kern._launch_round = lambda bufs: _LateEvent(kern, bufs, waited)
    return kern, made, waited


def _batch(rng, n, i):
    return (rng.integers(0, A, size=n, dtype=np.int32),
            rng.integers(0, A, size=n, dtype=np.int32),
            rng.integers(0, 2 ** 64, size=n, dtype=np.uint64),
            rng.integers(0, 2 * BOOTSTRAP_END, size=n, dtype=np.int64),
            BOOTSTRAP_END + 1_000_000 * i)


def test_many_handles_in_flight_keep_their_buffers():
    kern, made, waited = _kernel()
    rng = np.random.default_rng(1)
    batches = [_batch(rng, int(rng.integers(1, 700)), i) for i in range(16)]
    handles = [kern.launch(*b) for b in batches]
    assert kern.device_calls == 16 and kern.host_calls == 0
    # every chunk in flight holds a set of its own
    assert len(made) == 16 and len({id(m) for m in made}) == 16
    for i in rng.permutation(16):
        d, k = handles[i].wait()
        nd, nk = kern._step_numpy(*batches[i])
        np.testing.assert_array_equal(d, nd)
        np.testing.assert_array_equal(k, nk)
        assert handles[i].wait() is handles[i].wait()   # waited once
    assert len(waited) == 16
    # all sets back in the pool, by bucket
    assert sorted(kern._pool._free) == sorted(kern.buckets_seen)
    assert sum(len(v) for v in kern._pool._free.values()) == 16


def test_a_reused_buffer_is_read_with_its_new_contents():
    kern, made, _waited = _kernel(2)
    rng = np.random.default_rng(3)
    first, second = _batch(rng, 300, 0), _batch(rng, 260, 1)
    a = kern.launch(*first)
    busy = kern.launch(*second)           # same bucket, first in flight
    assert len(made) == 2
    np.testing.assert_array_equal(a.wait()[0],
                                  kern._step_numpy(*first)[0])
    third = _batch(rng, 290, 2)
    c = kern.launch(*third)               # takes first's set back
    assert len(made) == 2
    # the new batch's header, and its padding rows (first's last ten rows)
    # zeroed again
    assert int(made[0].packed[0, 0]) == 290
    assert int(made[0].packed[291:].abs().sum()) == 0
    for h, b in ((c, third), (busy, second)):
        d, k = h.wait()
        nd, nk = kern._step_numpy(*b)
        np.testing.assert_array_equal(d, nd)
        np.testing.assert_array_equal(k, nk)


def test_worker_threads_launch_under_one_lock():
    kern, made, waited = _kernel(4)
    lock = threading.Lock()
    errors = []

    def worker(seed):
        rng = np.random.default_rng(seed)
        try:
            for _round in range(5):
                batches = [_batch(rng, int(rng.integers(1, 600)), seed)
                           for _ in range(3)]
                with lock:                # the policy's launch lock
                    handles = [kern.launch(*b) for b in batches]
                for h, b in reversed(list(zip(handles, batches))):
                    d, k = h.wait()
                    nd, nk = kern._step_numpy(*b)
                    np.testing.assert_array_equal(d, nd)
                    np.testing.assert_array_equal(k, nk)
        except Exception as e:            # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(s,)) for s in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert not errors, errors
    assert len(waited) == kern.device_calls == 60
    assert len(made) <= 4 * 3 * len(kern.buckets_seen)


@pytest.mark.parametrize("bad", ["packed", "deliver", "keep"])
def test_mapped_round_names_a_buffer_it_refuses(bad):
    b = 256
    bufs = {"packed": torch.empty((1 + b, 3), dtype=torch.int64),
            "deliver": torch.empty(b, dtype=torch.int64),
            "keep": torch.empty(b, dtype=torch.bool)}
    # memory that is not page-locked: refused before any CUDA call (the
    # buffers are checked in the order packed, deliver, keep)
    with pytest.raises(ValueError, match="packed is not page-locked"):
        rs.MappedRound(bufs["packed"], bufs["deliver"], bufs["keep"], "cuda")
    # a wrong shape, dtype or layout, named
    t = bufs[bad]
    strided = (torch.empty((3, 1 + b), dtype=t.dtype).t() if bad == "packed"
               else torch.empty(2 * b, dtype=t.dtype)[::2])
    for wrong in (t[:, :2] if bad == "packed" else t[:-1],
                  t.to(torch.int32), strided):
        args = dict(bufs, **{bad: wrong})
        with pytest.raises(ValueError,
                           match=f"packet_hop_mapped: {bad} must be"):
            rs.MappedRound(args["packed"], args["deliver"], args["keep"],
                           "cuda")


def test_the_mapped_entry_takes_only_a_mapped_round():
    kern, _made, _waited = _kernel()
    packed = torch.zeros((257, 3), dtype=torch.int64)
    outs = (torch.empty(256, dtype=torch.int64),
            torch.empty(256, dtype=torch.bool))
    with pytest.raises(TypeError, match="MappedRound"):
        rs.packet_hop_mapped(kern.latency, kern.reliability,
                             (packed, *outs), kern.key_lo, kern.key_hi,
                             kern.bootstrap_end_ns)
    # a CPU tensor through the device wrapper runs the plain version, but
    # the card path never goes there: its launches count on the mapped
    # entry, and the CPU kernel's rounds do not
    before = (rs.packet_hop_mapped.launches, rs.packet_hop_packed.launches)
    kern._pool = None
    kern.launch(*_batch(np.random.default_rng(0), 10, 0)).wait()
    assert (rs.packet_hop_mapped.launches,
            rs.packet_hop_packed.launches) == before
