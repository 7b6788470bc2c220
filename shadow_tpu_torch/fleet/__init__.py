"""simfleet (ISSUE 18): many simulations per chip.

One compiled device program — the span/flush kernel family vmapped over
a leading batch axis — advances N *independent* scenarios per launch.
The package separates per-scenario plane STATE (each lane's arrival
ring, halt flag, flush section) from the SHARED compiled program
(scenario shapes bucketed into padded shape classes), which is the
refactor ROADMAP item 3 names and the serving shape the paper's
"thousands of simulated hosts" pitch scales out to: parameter sweeps,
CI matrices and simfuzz's mode matrix become batch lanes instead of one
subprocess each, digest-identical to the serial path.

* :mod:`shadow_tpu_torch.fleet.plane` — FleetPlane (the shared batching
  executor: shape classes, sticky batch width, barrier, compile
  counter) and FleetLane (per-scenario handle: pad/dispatch/unpad).
* :mod:`shadow_tpu_torch.fleet.driver` — FleetDriver: N lane threads
  round-robin over a job queue with per-lane attach/detach (a finished
  lane re-arms with the next queued scenario without recompiling).
* :mod:`shadow_tpu_torch.fleet.cli` — the ``simfleet`` console entry
  (``simfleet smoke``: bounded mixed fleet, digest-gated vs serial).
"""

from .driver import FleetDriver
from .plane import FleetLane, FleetPlane

__all__ = ["FleetDriver", "FleetLane", "FleetPlane"]
