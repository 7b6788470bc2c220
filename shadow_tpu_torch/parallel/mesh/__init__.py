"""meshplane: the sharded traffic plane, D shards on one torch device.

The port's copy of the JAX package's ``parallel/mesh/``.  Three modules
turn the device-resident traffic plane (parallel/device_plane.py) from a
one-table program into a D-shard one:

* :mod:`partition` — the deterministic chain/flow partitioner and the
  padded layout builder (a verbatim copy, numpy only);
* :mod:`exchange` — the precomputed cross-shard forward schedule (the
  static shard-to-shard edge matrix decomposed into <= D-1 rotation legs)
  and the mesh superwindow step: a plain torch version that loops the
  exchange through an explicit slot buffer, and the wrapper that launches
  the hand-written kernels (csrc/mesh_span.cu and the mesh entry of
  csrc/pack_flush.cu) on CUDA tensors;
* :mod:`meshplane` — the DeviceTrafficPlane attachment and its ``mesh.*``
  metrics.

This module owns :func:`device_mesh`, the one definition of where the
shards live, shared by every sharded consumer (the traffic plane and
ops/round_step.py's ShardedPacketHopKernel).  The JAX package puts each
shard on its own XLA device (a virtual CPU device in its tests); the port
puts all D shards on the one torch device that ``--device`` names.  Each
shard keeps its own slice of the state, and the collectives become
exchanges through that device's memory inside the kernels.  Spreading the
shards over several cards (the exchange over NCCL) is ROADMAP A10b.
"""

from __future__ import annotations

import torch

from ...device import resolve_device

_LOGGED: set = set()


class DeviceMesh:
    """``n_shards`` shards on one torch ``device``.  Shard s owns the s-th
    of ``n_shards`` equal slices of every sharded array (``shard_slice``),
    as ``P(axis)`` places them in the JAX package."""

    __slots__ = ("n_shards", "device", "axis_names")

    def __init__(self, n_shards: int, device: torch.device,
                 axis_names=("flows",)):
        self.n_shards = int(n_shards)
        self.device = device
        self.axis_names = tuple(axis_names)

    def shard_slice(self, shard: int, length: int) -> slice:
        """The slice of a sharded axis of ``length`` (a multiple of
        ``n_shards``) that ``shard`` owns."""
        if length % self.n_shards:
            raise ValueError(f"axis of {length} does not split into "
                             f"{self.n_shards} shards")
        w = length // self.n_shards
        return slice(shard * w, (shard + 1) * w)

    def __repr__(self) -> str:
        return (f"DeviceMesh({self.n_shards} shards on {self.device}, "
                f"axes {self.axis_names})")


def device_mesh(n_devices: int, axis_names=("flows",),
                device="cuda") -> DeviceMesh:
    """The mesh of ``n_devices`` shards on the torch device ``device``
    names (``"cuda"``: the current card; ``"cpu"``: the CPU, where the
    kernels' plain versions run).  Every shard lives on that one device;
    the first mesh of each size logs so once."""
    if n_devices < 1:
        raise ValueError(f"a mesh needs at least one shard, got {n_devices}")
    dev = device if isinstance(device, torch.device) \
        else resolve_device(device)
    key = (int(n_devices), str(dev))
    if key not in _LOGGED:
        _LOGGED.add(key)
        from ...core.logger import get_logger
        where = "card" if dev.type == "cuda" else "CPU device"
        get_logger().message(
            "mesh", f"{n_devices} shards on one {where} ({dev}); the "
            "exchange runs through its memory")
    return DeviceMesh(n_devices, dev, axis_names)
