"""Deterministic, order-independent random numbers for the simulator.

The reference derives all randomness from a seed hierarchy of ``rand_r``
streams (utility/random.c:32, master.c:417 master->slave->per-host seeding).
That design couples random draws to *execution order*, which would make the
CPU scheduler policies and the batched TPU kernel diverge the moment events
are reordered within a round.

We instead use a **counter-based** generator — Threefry-2x32 (Salmon et al.,
"Parallel Random Numbers: As Easy as 1, 2, 3", SC'11), the same block cipher
JAX's PRNG is built on — keyed by a (stream, substream) pair and indexed by a
64-bit counter.  A draw is a pure function ``threefry(key, counter)``:

* the CPU event loop evaluates it with numpy (vectorized or scalar), and
* the packet-hop kernel evaluates the *identical* function in CUDA
  (ops/csrc/packet_hop.cu), and its plain version with torch,

so reliability drops, jitter draws, etc. are bitwise identical no matter which
backend executes the packet hop or in what order packets are processed.

The seed hierarchy of the reference is preserved in spirit: a root seed
expands into named child streams via the same cipher (see :func:`derive`).
"""

from __future__ import annotations

from typing import Any, Tuple

import numpy as np

_MASK32 = np.uint32(0xFFFFFFFF)
# >>> simgen:begin region=threefry spec=293c930bb679 body=73de375b3b8e
# Threefry-2x32 rotation constants (Salmon et al., Table 2).
_ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = 0x1BD11BDA  # SKEIN_KS_PARITY32
# <<< simgen:end region=threefry


def _rotl32_np(x: np.ndarray, d: int) -> np.ndarray:
    return ((x << np.uint32(d)) | (x >> np.uint32(32 - d))) & _MASK32


def threefry2x32_np(k0, k1, c0, c1) -> Tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32, 20 rounds, numpy (scalars or arrays of uint32)."""
    with np.errstate(over="ignore"):
        k0 = np.asarray(k0, dtype=np.uint32)
        k1 = np.asarray(k1, dtype=np.uint32)
        x0 = np.asarray(c0, dtype=np.uint32).copy()
        x1 = np.asarray(c1, dtype=np.uint32).copy()
        ks = (k0, k1, np.uint32(_PARITY) ^ k0 ^ k1)
        x0 = (x0 + ks[0]).astype(np.uint32)
        x1 = (x1 + ks[1]).astype(np.uint32)
        for block in range(5):  # 5 blocks of 4 rounds = 20 rounds
            rots = _ROTATIONS[0:4] if block % 2 == 0 else _ROTATIONS[4:8]
            for r in rots:
                x0 = (x0 + x1).astype(np.uint32)
                x1 = _rotl32_np(x1, r)
                x1 = x1 ^ x0
            x0 = (x0 + ks[(block + 1) % 3]).astype(np.uint32)
            x1 = (x1 + ks[(block + 2) % 3] + np.uint32(block + 1)).astype(np.uint32)
    return x0, x1


def threefry2x32_torch(k0, k1, c0, c1):
    """Threefry-2x32, 20 rounds, torch — bitwise identical to the numpy
    version above (asserted by tests/test_torch_rng.py).

    The plain torch version of the cipher that the packet-hop kernel
    (ops/csrc/packet_hop.cu) runs in uint32 registers.  Lanes are int64
    tensors holding values in [0, 2**32), masked back to 32 bits after every
    add and rotation: torch on the CPU has no uint32 ``+``, ``<<`` or
    ``>>``.  Keys may be Python ints or int64 tensors; returns (x0, x1) as
    int64 tensors in [0, 2**32)."""
    import torch

    c0 = torch.as_tensor(c0, dtype=torch.int64)
    k0 = torch.as_tensor(k0, dtype=torch.int64, device=c0.device) & _M32
    k1 = torch.as_tensor(k1, dtype=torch.int64, device=c0.device) & _M32
    x0 = c0 & _M32
    x1 = torch.as_tensor(c1, dtype=torch.int64, device=c0.device) & _M32
    ks = (k0, k1, (k0 ^ k1) ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for block in range(5):
        rots = _ROTATIONS[0:4] if block % 2 == 0 else _ROTATIONS[4:8]
        for r in rots:
            x0 = (x0 + x1) & _M32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _M32
            x1 = x1 ^ x0
        x0 = (x0 + ks[(block + 1) % 3]) & _M32
        x1 = (x1 + ks[(block + 2) % 3] + (block + 1)) & _M32
    return x0, x1


_M32 = 0xFFFFFFFF


def threefry2x32_int(k0: int, k1: int, c0: int, c1: int) -> Tuple[int, int]:
    """Threefry-2x32 on plain Python ints — bitwise identical to the numpy
    version (same ops mod 2^32; asserted by tests/test_rng.py) and ~50x
    faster for SCALAR draws: numpy scalar arithmetic pays per-op dispatch
    that dominates host boot (20k hosts x 3 derive calls) and the per-packet
    CPU drop draw."""
    k0 &= _M32
    k1 &= _M32
    x0 = c0 & _M32
    x1 = c1 & _M32
    ks = (k0, k1, (_PARITY ^ k0 ^ k1) & _M32)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for block in range(5):
        rots = _ROTATIONS[0:4] if block % 2 == 0 else _ROTATIONS[4:8]
        for r in rots:
            x0 = (x0 + x1) & _M32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _M32
            x1 ^= x0
        x0 = (x0 + ks[(block + 1) % 3]) & _M32
        x1 = (x1 + ks[(block + 2) % 3] + block + 1) & _M32
    return x0, x1


def _bits64_scalar(key: int, counter: int) -> int:
    x0, x1 = threefry2x32_int(key & _M32, (key >> 32) & _M32,
                              counter & _M32, (counter >> 32) & _M32)
    return x0 | (x1 << 32)


def _split64(v) -> Tuple[np.ndarray, np.ndarray]:
    v = np.asarray(v, dtype=np.uint64)
    return (v & np.uint64(0xFFFFFFFF)).astype(np.uint32), (v >> np.uint64(32)).astype(np.uint32)


def uniform_np(key: int, counter) -> np.ndarray:
    """Uniform float64 in [0, 1) from a 64-bit key and 64-bit counter(s).

    Uses the high lane's top 24 bits so the same construction is cheap and
    exact in float32 on device (see :func:`uniform_torch_pair`).
    """
    if isinstance(counter, (int, np.integer)):
        key_i = int(key) & 0xFFFFFFFFFFFFFFFF
        c = int(counter) & 0xFFFFFFFFFFFFFFFF
        x0, _ = threefry2x32_int(key_i & _M32, (key_i >> 32) & _M32,
                                 c & _M32, (c >> 32) & _M32)
        return np.float64((x0 >> 8) * (1.0 / (1 << 24)))
    k0, k1 = _split64(np.uint64(key & 0xFFFFFFFFFFFFFFFF))
    c0, c1 = _split64(counter)
    x0, _x1 = threefry2x32_np(k0, k1, c0, c1)
    return (x0 >> np.uint32(8)).astype(np.float64) * (1.0 / (1 << 24))


def uniform_torch_pair(key: int, c_lo, c_hi):
    """Device-side twin of :func:`uniform_np` with the 64-bit counter passed
    as two 32-bit lanes (int64 tensors holding values in [0, 2**32)).

    float32 with the same 24-bit mantissa construction — ``(x0 >> 8)`` is
    below 2**24, so the cast and the scale by 2**-24 are exact — giving
    bitwise-equal decisions for any threshold expressible in float32, which
    all reliability values are."""
    import torch

    kv = int(key) & 0xFFFFFFFFFFFFFFFF
    x0, _x1 = threefry2x32_torch(kv & _M32, (kv >> 32) & _M32, c_lo, c_hi)
    return (x0 >> 8).to(torch.float32) * (1.0 / (1 << 24))


def bits64_np(key: int, counter) -> np.ndarray:
    """64 random bits as uint64 from key + counter."""
    if isinstance(counter, (int, np.integer)):
        return np.uint64(_bits64_scalar(int(key) & 0xFFFFFFFFFFFFFFFF,
                                        int(counter) & 0xFFFFFFFFFFFFFFFF))
    k0, k1 = _split64(np.uint64(key & 0xFFFFFFFFFFFFFFFF))
    c0, c1 = _split64(counter)
    x0, x1 = threefry2x32_np(k0, k1, c0, c1)
    return x0.astype(np.uint64) | (x1.astype(np.uint64) << np.uint64(32))


def bits64_keys_np(keys, counter) -> np.ndarray:
    """64 random bits per KEY: the vector-key dual of :func:`bits64_np`
    (one key, many counters).  Used by the scale tier to evaluate the
    first draw of many per-host streams in one threefry call instead of a
    Python loop over 100k scalar ciphers (scale/hosttable.py)."""
    keys = np.asarray(keys, dtype=np.uint64)
    k0 = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    k1 = (keys >> np.uint64(32)).astype(np.uint32)
    c0, c1 = _split64(np.uint64(int(counter) & 0xFFFFFFFFFFFFFFFF))
    x0, x1 = threefry2x32_np(k0, k1, c0, c1)
    return x0.astype(np.uint64) | (x1.astype(np.uint64) << np.uint64(32))


def derive_np(key: int, label: Any, ids) -> np.ndarray:
    """Vectorized :func:`derive` over the FINAL path element: the child
    keys ``derive(key, label, i) for i in ids`` as one uint64 array.
    Bitwise identical to the scalar chain (tests/test_scale.py pins it) —
    the scalar derive folds each label with ``k = bits64(k, label)``, so
    only the last fold varies per id and the whole family is one
    vectorized cipher evaluation."""
    k1 = derive(key, label)
    return bits64_np(k1, np.asarray(ids, dtype=np.uint64))


def derive(key: int, *path: Any) -> int:
    """Derive a child 64-bit key from a parent key and a path of labels.

    Replaces the reference's seed hierarchy (master.c:417: master seeds slave,
    slave seeds scheduler and each host).  Labels may be ints or strings;
    strings are hashed with the cipher itself so derivation is stable across
    runs and platforms (no Python hash randomization).
    """
    k = np.uint64(key & 0xFFFFFFFFFFFFFFFF)
    for label in path:
        if isinstance(label, str):
            acc = np.uint64(1469598103934665603)  # FNV-1a offset basis
            for b in label.encode("utf-8"):
                acc = np.uint64((int(acc) ^ b) * 1099511628211 & 0xFFFFFFFFFFFFFFFF)
            label_int = int(acc)
        else:
            label_int = int(label) & 0xFFFFFFFFFFFFFFFF
        k = bits64_np(int(k), np.uint64(label_int))
    return int(k)


class RandomSource:
    """A sequential deterministic stream, for host-side draws that have a
    natural per-object ordering (e.g. a host's ephemeral-port allocator).

    Mirrors the role of the reference's ``Random`` (utility/random.c) but is
    built on the counter cipher, so streams never collide and reseeding is
    never needed.
    """

    __slots__ = ("key", "counter")

    def __init__(self, key: int):
        self.key = int(key) & 0xFFFFFFFFFFFFFFFF
        self.counter = 0

    def next_u64(self) -> int:
        v = _bits64_scalar(self.key, self.counter)
        self.counter += 1
        return v

    def next_double(self) -> float:
        v = float(uniform_np(self.key, self.counter))
        self.counter += 1
        return v

    def next_int(self, bound: int) -> int:
        """Uniform int in [0, bound)."""
        assert bound > 0
        return self.next_u64() % bound

    def next_bytes(self, n: int) -> bytes:
        out = bytearray()
        while len(out) < n:
            out += int(self.next_u64()).to_bytes(8, "little")
        return bytes(out[:n])

    def spawn(self, *path: Any) -> "RandomSource":
        return RandomSource(derive(self.key, *path))
