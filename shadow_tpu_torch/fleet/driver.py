"""FleetDriver (ISSUE 18): N lane threads round-robin over a job queue.

Each worker thread pulls the next queued scenario job, arms a fresh
FleetLane for it (begin/end bracket the barrier's live count), and runs
the job with the lane — a finished lane is re-armed with the next
queued scenario WITHOUT recompiling: the new lane joins the same shape
class, whose sticky width keeps the jit cache key unchanged
(``FleetPlane.compiles`` is the proof the re-arm drill asserts on).

Jobs are plain callables ``fn(lane) -> result`` so both customers wrap
the same engine entry point: ``simfuzz --batched`` wraps
``fuzz.runner.run_one_mode(spec, mode, lane=lane)`` and ``simfleet
smoke`` wraps the same call for its digest gate.  The GIL serializes
the lanes' host work; the win is the shared compile cache plus the
batched launches amortizing the per-dispatch overhead N-up.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional

from .plane import FleetPlane


class FleetDriver:
    def __init__(self, lanes: int = 8, plane: Optional[FleetPlane] = None,
                 use_numpy: bool = False):
        self.lanes = max(1, int(lanes))
        self.plane = plane if plane is not None \
            else FleetPlane(use_numpy=use_numpy)

    def run(self, jobs: List[Callable]) -> List:
        """Run every job, at most ``lanes`` concurrently, preserving
        result order.  A job's exception is re-raised (the first by job
        index) after every worker has drained — lanes end in a finally,
        so one failing scenario can never wedge the barrier."""
        n = len(jobs)
        results: List = [None] * n
        errors: List = [None] * n
        cursor = {"next": 0}
        feed_lock = threading.Lock()

        def _worker() -> None:
            while True:
                with feed_lock:
                    i = cursor["next"]
                    if i >= n:
                        return
                    cursor["next"] = i + 1
                lane = self.plane.lane()
                lane.begin()
                try:
                    results[i] = jobs[i](lane)  # simlint: disable=SIM102 -- each slot i is claimed by exactly one worker under feed_lock; the spawner reads only after join()
                except BaseException as e:  # noqa: BLE001 - reported below
                    errors[i] = e  # simlint: disable=SIM102 -- same slot-ownership + join() ordering as results[i]
                finally:
                    lane.end()

        threads = [threading.Thread(target=_worker, name=f"fleet-{w}",
                                    daemon=True)
                   for w in range(min(self.lanes, max(n, 1)))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for e in errors:
            if e is not None:
                raise e
        return results
