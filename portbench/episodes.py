"""Experiments through the port's normal entry.

An episode is one whole Tor experiment, its set-up included: the
program's ``Configuration`` built from every field of the cell's
configuration and traffic files (:func:`tor_configuration`) and run by
``Controller(options, config).run()``, alone (a serial cell) or as a
lane of ``FleetDriver`` over one ``FleetPlane`` (a fleet cell).  Episode
``i``'s seeds (the engine's and the circuits' draw) come from the run's
``--seed`` and ``i``.  What the program produced is kept for the check;
the program's objects are dropped when the episode ends.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

import numpy as np

SERIAL_KERNELS = ("torcells_span", "pack_flush")
FLEET_KERNELS = ("torcells_span_batched", "pack_flush")


# the groups of a configuration file: (host id, count key, up rate key,
# down rate key); the reference names the hosts the same way
GROUPS = (("relay", "relays", "relay_kibps", "relay_kibps"),
          ("dest", "servers", "server_kibps", "server_kibps"),
          ("torclient", "clients", "client_up_kibps", "client_down_kibps"))


def one_vertex_graphml(latency_ms: float) -> str:
    """A topology of one vertex whose self-loop takes ``latency_ms`` (a
    path between two of its hosts takes the loop twice)."""
    return (
        '<graphml xmlns="http://graphml.graphdrawing.org/xmlns">'
        '<key id="d0" for="edge" attr.name="latency" attr.type="double"/>'
        '<key id="d1" for="edge" attr.name="packetloss" attr.type="double"/>'
        '<key id="d2" for="node" attr.name="countrycode" '
        'attr.type="string"/>'
        '<key id="d3" for="node" attr.name="type" attr.type="string"/>'
        '<graph edgedefault="undirected">'
        '<node id="poi-1"><data key="d2">US</data><data key="d3">net</data>'
        '</node><edge source="poi-1" target="poi-1">'
        f'<data key="d0">{float(latency_ms)}</data>'
        '<data key="d1">0.0</data></edge></graph></graphml>')


def tor_configuration(config: Dict, traffic: Dict, stoptime: int,
                      path_seed: int):
    """The program's ``Configuration`` of one experiment: a host group for
    the relays, the servers and the clients with the file's counts and
    rates, the file's one-vertex latency, and one ``FlowConfig`` for the
    clients carrying the mix's transfer sizes and arrival waves and the
    seeded draw of each client's circuit over the file's relays and
    servers."""
    from shadow_tpu_torch.core.configuration import (Configuration,
                                                     FlowConfig, HostConfig)
    counts = [int(config[key]) for _id, key, _up, _down in GROUPS]
    if sum(counts) != int(config["hosts"]) or counts[0] < 3 \
            or counts[1] < 1 or counts[2] < 1:
        raise ValueError(
            f"portbench: {config.get('name')}: relays, servers and clients "
            f"{counts} must be >= 3, >= 1, >= 1 and add up to hosts "
            f"{config['hosts']}")
    cfg = Configuration(stop_time_sec=stoptime,
                        topology_text=one_vertex_graphml(
                            config["vertex_latency_ms"]))
    for (host_id, _key, up, down), n in zip(GROUPS, counts):
        cfg.hosts.append(HostConfig(
            id=host_id, quantity=n,
            bandwidth_down_kibps=int(config[down]),
            bandwidth_up_kibps=int(config[up])))
    cfg.hosts[-1].flows.append(FlowConfig(
        dest="", start_time_sec=float(traffic["start_s"]),
        down_bytes=int(traffic["down_bytes"]),
        up_bytes=int(traffic["up_bytes"]),
        stagger_waves=int(traffic["waves"]),
        stagger_step_sec=float(traffic["step_s"]),
        tor_path_seed=path_seed, tor_relays=counts[0],
        tor_relay_prefix=GROUPS[0][0], tor_servers=counts[1],
        tor_server_prefix=GROUPS[1][0]))
    return cfg


def episode_seeds(seed: int, index: int):
    """(engine seed, circuit seed) of episode ``index`` of a run."""
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
    """Episodes of one cell: its configuration and traffic, the run's seed
    and the device the program runs on."""

    def __init__(self, config: Dict, traffic: Dict, seed: int, device: str,
                 granule_ms: int = 0):
        self.config = config
        self.traffic = traffic
        self.seed = seed
        self.device = device
        self.granule_ms = granule_ms
        self.fleet = traffic["mode"] == "fleet"

    def scenario(self, index: int, stoptime: Optional[int] = None):
        from shadow_tpu_torch.core.options import Options
        stop = int(stoptime or self.config["stoptime_s"])
        engine_seed, path_seed = episode_seeds(self.seed, index)
        cfg = tor_configuration(self.config, self.traffic, stop, path_seed)
        opts = Options(scheduler_policy="global", device=self.device,
                       workers=0, seed=engine_seed, host_table="on",
                       heartbeat_interval_sec=0, stop_time_sec=stop,
                       log_level="warning",
                       device_plane_granule_ms=self.granule_ms)
        return cfg, opts, engine_seed, path_seed

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
            cfg, opts, engine_seed, path_seed = self.scenario(index,
                                                               stoptime)
            if lane is not None:
                opts._fleet_lane = lane
            ctl = Controller(opts, cfg)
            rc = ctl.run()
            eng = ctl.engine
            plane = eng.device_plane
            table = eng.host_table
            n = eng.total_host_count()
            rec = {"index": index, "engine_seed": engine_seed,
                   "path_seed": path_seed, "sim_s": int(cfg.stop_time_sec),
                   "rc": rc, "t_start": t_start,
                   "t_loop": eng.sim_start_wall,
                   "dispatches": plane.dispatches,
                   "device_ns": plane.device_ns,
                   "granule": plane.granule,
                   "chain_done": plane._chain_done.copy(),
                   "forwards": int(plane.total_forwards),
                   "completed": len(plane._done),
                   "tx": table.tx_bytes[:n].copy(),
                   "rx": table.rx_bytes[:n].copy(),
                   # (name, quantity, first row, rows) of each host group;
                   # never the groups themselves, which hold the engine
                   "groups": [(g.hc.id, g.hc.quantity, g.first_row, g.count)
                              for g in table.groups]}
            rec["t_end"] = time.monotonic()
            return rec
        finally:
            if lane is not None:
                set_thread_logger(None)

    def warm_up(self) -> None:
        """One experiment of the cell's network, cut to its first wave,
        through the same entry: the kernels' first launches and the boot's
        first pass happen here, not in the window."""
        stop = int(self.traffic["start_s"]) + 1
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
