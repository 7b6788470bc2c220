"""meshplane: the sharded traffic plane, D shards over the cards of one host.

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
  csrc/pack_flush.cu) on CUDA tensors; over several cards, the card entry
  of csrc/mesh_span.cu in lookahead windows (:mod:`cards`), which stores
  the cells that cross cards straight into the receiving card's inbox;
* :mod:`meshplane` — the DeviceTrafficPlane attachment and its ``mesh.*``
  metrics.

This module owns :func:`device_mesh`, the one definition of where the
shards live, shared by every sharded consumer (the traffic plane and
ops/round_step.py's ShardedPacketHopKernel).  The JAX package puts each
shard on its own XLA device; the port, one process as the JAX package is,
puts shard s on card ``s * n_cards // D`` of the host's cards (contiguous
groups, so the chains the partition keeps together stay on one card).
With one card every shard lives on it and the exchange runs through its
memory inside one launch, as before; the cards may also be given
explicitly (``cards=``), repeats allowed: ``[cuda:0, cuda:0]`` is two cards
that are both the one card, ``[cpu, cpu]`` two "cards" on the CPU, where
the over-cards path runs its plain version.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ...device import resolve_device

_LOGGED: set = set()


class DeviceMesh:
    """``n_shards`` shards over ``cards`` (torch devices, one per card of
    the mesh; a device may repeat).  Shard s owns the s-th of ``n_shards``
    equal slices of every sharded array (``shard_slice``), as ``P(axis)``
    places them in the JAX package, and lives on card ``card_of(s)``.
    ``device`` is the lead card, cards[0]."""

    __slots__ = ("n_shards", "device", "axis_names", "cards")

    def __init__(self, n_shards: int, device: torch.device,
                 axis_names=("flows",),
                 cards: Optional[Sequence[torch.device]] = None):
        self.n_shards = int(n_shards)
        self.cards = tuple(cards) if cards else (device,)
        if not 1 <= len(self.cards) <= self.n_shards:
            raise ValueError(f"{len(self.cards)} cards for "
                             f"{self.n_shards} shards")
        self.device = self.cards[0]
        self.axis_names = tuple(axis_names)

    @property
    def n_cards(self) -> int:
        return len(self.cards)

    def card_of(self, shard: int) -> int:
        """The index in ``cards`` of the card that holds ``shard``."""
        return int(shard) * self.n_cards // self.n_shards

    def shards_of(self, card: int) -> range:
        """The shards card ``card`` holds (contiguous)."""
        return range(-(-int(card) * self.n_shards // self.n_cards),
                     -(-(int(card) + 1) * self.n_shards // self.n_cards))

    def shard_slice(self, shard: int, length: int) -> slice:
        """The slice of a sharded axis of ``length`` (a multiple of
        ``n_shards``) that ``shard`` owns."""
        if length % self.n_shards:
            raise ValueError(f"axis of {length} does not split into "
                             f"{self.n_shards} shards")
        w = length // self.n_shards
        return slice(shard * w, (shard + 1) * w)

    def __repr__(self) -> str:
        where = self.device if self.n_cards == 1 else \
            f"{self.n_cards} cards ({', '.join(map(str, self.cards))})"
        return (f"DeviceMesh({self.n_shards} shards on {where}, "
                f"axes {self.axis_names})")


def device_mesh(n_devices: int, axis_names=("flows",), device="cuda",
                cards: Optional[Sequence] = None) -> DeviceMesh:
    """The mesh of ``n_devices`` shards.  Without ``cards``: on the CPU
    (``device`` "cpu"), one device, where the kernels' plain versions run;
    on CUDA, the first ``min(n_devices, torch.cuda.device_count())`` cards
    of the host (one card: the one ``device`` names).  ``cards`` lists the
    cards explicitly (torch devices or their names, repeats allowed; at
    most ``n_devices`` are used).  The first mesh of each shape logs
    where its shards went."""
    if n_devices < 1:
        raise ValueError(f"a mesh needs at least one shard, got {n_devices}")
    if cards:
        cards = [c if isinstance(c, torch.device) else torch.device(c)
                 for c in list(cards)[:n_devices]]
        cards = [resolve_device("cuda") if c.type == "cuda" and c.index is None
                 else c for c in cards]      # raises without a usable card
        for c in cards:
            if c.type == "cuda":
                if c.index >= torch.cuda.device_count():
                    raise RuntimeError(
                        f"mesh card {c} is absent: torch sees "
                        f"{torch.cuda.device_count()} card(s)")
        dev = cards[0]
    else:
        dev = device if isinstance(device, torch.device) \
            else resolve_device(device)
        k = min(int(n_devices), torch.cuda.device_count()) \
            if dev.type == "cuda" else 1
        cards = [torch.device("cuda", i) for i in range(k)] if k > 1 \
            else [dev]
    key = (int(n_devices), tuple(str(c) for c in cards))
    if key not in _LOGGED:
        _LOGGED.add(key)
        from ...core.logger import get_logger
        if len(cards) == 1:
            where = "card" if dev.type == "cuda" else "CPU device"
            get_logger().message(
                "mesh", f"{n_devices} shards on one {where} ({dev}); the "
                "exchange runs through its memory")
        else:
            get_logger().message(
                "mesh", f"{n_devices} shards over {len(cards)} cards "
                f"({', '.join(map(str, cards))}); the cells that cross "
                "cards are copied between lookahead windows")
    return DeviceMesh(n_devices, dev, axis_names, cards)
