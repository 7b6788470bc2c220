"""Episodes through the port's normal entry.

An episode is one whole experiment, its set-up included: the program's
``Configuration`` and ``Options`` built by the cell's scenario
(``portbench/scenarios/<name>.py``) from every field of the cell's
configuration and traffic files, and run by
``Controller(options, config).run()``, alone (a serial cell) or as a
lane of ``FleetDriver`` over one ``FleetPlane`` (a fleet cell).  Episode
``i``'s seeds (the engine's and the scenario's draw) come from the run's
``--seed`` and ``i``.  What the program produced is kept for the check;
the program's objects are dropped when the episode ends.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

import numpy as np


def episode_seeds(seed: int, index: int):
    """(engine seed, draw seed) of episode ``index`` of a run."""
    a, b = np.random.SeedSequence([seed % 2 ** 64, index]).generate_state(2)
    return int(a) & 0x7FFFFFFF, int(b)


def ensure_kernels(names) -> None:
    """Build the kernels the cell launches that the checkout's compile
    cache lacks (all at once), so no episode builds one."""
    from shadow_tpu_torch.ops import _build
    missing = [n for n in names
               if not os.path.exists(_build.library_path(n))]
    if missing:
        _build.build(missing)
    for n in names:
        _build.load(n)


class Experiments:
    """Episodes of one cell: its scenario, configuration and traffic, the
    run's seed, the device the program runs on, the cards the cell asks
    for, and whether the run is the control."""

    def __init__(self, scenario, config: Dict, traffic: Dict, seed: int,
                 device: str, chips: int = 1, control: bool = False):
        self.scenario = scenario
        self.config = config
        self.traffic = traffic
        self.seed = seed
        self.device = device
        self.chips = chips
        self.control = control
        self.fleet = traffic["mode"] == "fleet"

    def episode(self, index: int, stoptime: Optional[int] = None):
        """(Configuration, Options, engine seed, draw seed) of episode
        ``index``, run to ``stoptime`` (the configuration's by default)."""
        sc = self.scenario
        stop = int(stoptime or self.config["stoptime_s"])
        engine_seed, draw_seed = episode_seeds(self.seed, index)
        cfg = sc.configuration(self.config, self.traffic, stop, draw_seed)
        opts = sc.options(self.config, self.traffic, seed=engine_seed,
                          stoptime=stop, device=self.device,
                          chips=self.chips, control=self.control)
        return cfg, opts, engine_seed, draw_seed

    def run_one(self, index: int, lane=None,
                stoptime: Optional[int] = None) -> Dict:
        """One episode; the record of what it did and produced."""
        from shadow_tpu_torch.core.controller import Controller
        from shadow_tpu_torch.core.logger import (SimLogger, set_logger,
                                                  set_thread_logger)
        if lane is None:
            set_logger(SimLogger(level="warning"))
        else:
            set_thread_logger(SimLogger(level="warning"))
        try:
            t_start = time.monotonic()
            cfg, opts, engine_seed, draw_seed = self.episode(index,
                                                             stoptime)
            if lane is not None:
                opts._fleet_lane = lane
            ctl = Controller(opts, cfg)
            rc = ctl.run()
            rec = {"index": index, "engine_seed": engine_seed,
                   "draw_seed": draw_seed, "sim_s": int(cfg.stop_time_sec),
                   "rc": rc, "t_start": t_start,
                   "t_loop": ctl.engine.sim_start_wall,
                   **self.scenario.record(ctl)}
            rec["t_end"] = time.monotonic()
            return rec
        finally:
            if lane is not None:
                set_thread_logger(None)

    def warm_up(self) -> None:
        """One episode cut to the scenario's warm-up stoptime, through the
        same entry: the kernels' first launches and the boot's first pass
        happen here, not in the window."""
        stop = self.scenario.warm_stoptime(self.config, self.traffic)
        if not self.fleet:
            self.run_one(0, stoptime=stop)
            return
        from shadow_tpu_torch.fleet import FleetDriver, FleetPlane
        driver = FleetDriver(lanes=1, plane=FleetPlane(device=self.device))
        driver.run([lambda lane: self.run_one(0, lane, stop)])

    def window(self, seconds: float) -> List[Dict]:
        """Episodes from now until ``seconds`` have passed; none starts
        after that, the ones in flight finish.  Records in index order."""
        deadline = time.monotonic() + seconds
        if not self.fleet:
            out, i = [], 1
            while time.monotonic() < deadline:
                out.append(self.run_one(i))
                i += 1
            return out
        from shadow_tpu_torch.fleet import FleetDriver, FleetPlane
        lanes = int(self.traffic["lanes"])
        driver = FleetDriver(lanes=lanes,
                             plane=FleetPlane(device=self.device))

        def job(i):
            def run(lane):
                if time.monotonic() >= deadline:
                    return None
                return self.run_one(i, lane)
            return run

        done = driver.run([job(i) for i in range(1, 64 * lanes + 1)])
        return [r for r in done if r is not None]
