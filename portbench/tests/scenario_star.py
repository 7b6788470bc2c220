"""A scenario of another shape than Tor's, for the tests: genscen's star
family, one server and processless clients each pulling a download from
it and sending an upload to it over 2-hop chains, the flow table sharded
over the configuration's ``shards`` of the device plane's mesh
(``tpu_devices``) on the run's one device.

The test copies this file to ``portbench/scenarios/star.py`` of a copy
of the benchmark, and ``star_reference.py`` beside it to
``portbench/star_reference.py``: a deployment added as files alone.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

KERNELS = {"serial": ("mesh_span", "pack_flush")}
PARTS = ("chains", "server", "clients", "forwards", "exit_code")
TINY_CONFIG = {"clients": 150, "stoptime_s": 5}
TINY_TRAFFIC = {"waves": 2}


def configuration(config: Dict, traffic: Dict, stoptime: int,
                  draw_seed: int):
    """genscen's star with the file's rates and the mix's transfers; the
    star has no draw of its own."""
    from shadow_tpu_torch.scale import genscen
    return genscen.star(
        n_clients=int(config["clients"]), stoptime=stoptime,
        down_bytes=int(traffic["down_bytes"]),
        up_bytes=int(traffic["up_bytes"]),
        start_sec=float(traffic["start_s"]),
        stagger_waves=int(traffic["waves"]),
        stagger_step_sec=float(traffic["step_s"]),
        server_bw_kibps=int(config["server_kibps"]),
        client_down_kibps=int(config["client_down_kibps"]),
        client_up_kibps=int(config["client_up_kibps"]))


def options(config: Dict, traffic: Dict, *, seed: int, stoptime: int,
            device: str, chips: int, control: bool):
    """The plane on a mesh of the file's shards; the control at a 2 ms
    tick."""
    from shadow_tpu_torch.core.options import Options
    return Options(scheduler_policy="global", device=device, seed=seed,
                   host_table="on", tpu_devices=int(config["shards"]),
                   heartbeat_interval_sec=0, stop_time_sec=stoptime,
                   log_level="warning",
                   device_plane_granule_ms=2 if control else 0)


def warm_stoptime(config: Dict, traffic: Dict) -> int:
    return int(traffic["start_s"]) + 1


def record(ctl) -> Dict:
    eng = ctl.engine
    plane = eng.device_plane
    table = eng.host_table
    n = eng.total_host_count()
    return {"granule": plane.granule,
            "chain_done": plane._chain_done.copy(),
            "forwards": int(plane.total_forwards),
            "tx": table.tx_bytes[:n].copy(),
            "rx": table.rx_bytes[:n].copy()}


def check(rec: Dict, config: Dict, traffic: Dict, device):
    """Chains by their completion in ms (the end of the tick), the
    server's and the clients' bytes, the cells forwarded.  The star's
    host rows are in the order of its groups: the server, then the
    clients."""
    # imported here, not when the scenario is loaded: the tests load it
    # in-process from a copy whose reference this package does not have
    from portbench import star_reference
    out = star_reference.simulate(star_reference.star_network(config,
                                                              traffic))

    def ms(done, granule):
        return np.where(done >= 0, (done + 1) * granule, -1)

    got = ms(rec["chain_done"], rec["granule"])
    want = ms(out["done_tick"], out["granule_ms"])
    bytes_off = (rec["tx"] != out["host_tx"]) | (rec["rx"] != out["host_rx"])
    off = {"chains": (len(want) if got.shape != want.shape
                      else int((got != want).sum())),
           "server": int(bytes_off[0]),
           "clients": int(bytes_off[1:].sum()),
           "forwards": int(rec["forwards"] != out["forwards"]),
           "exit_code": int(rec["rc"] != 0)}
    return off, out
