"""The device-resident model workloads, end to end: PHOLD, bandwidth
saturation, the onion-relay cell model and token-bucket admission on the
device, and the engine's PHOLD twin.

    python -m shadow_tpu_torch.tools.modelbench [--device cuda|cpu] [--small]

The port's counterpart of the JAX package's ``bench.py`` ``bench_phold``:
the same instances, sizes and warm-up calls, and one JSON line with the same
keys, plus the counts that decide parity with the JAX package
(``phold_device_digest``: sha256 of the final host int32 and time int64
arrays; ``torcells_device_ticks``; ``torcells_device_delivered``), the
kernel launches each workload made and the device it ran on.  It adds one
workload bench.py does not run: ``BandwidthKernel`` admitting one batch of
65,536 packets to 2,050 hosts (tor1k's host count), drawn as the JAX
package's tests/test_bandwidth_ops.py draws its batches
(``bandwidth_device_*``; ``bandwidth_device_admits_digest`` is sha256 of
the int64 admission times).  On ``cuda`` (the default) every device
workload is one launch of its hand-written kernel per call; ``--device
cpu`` runs the plain torch versions, and ``--small`` runs every workload at
a test size.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time as _walltime
from typing import Optional

import numpy as np

# bench.py's sizes
FULL = {
    "phold_hosts": 1024, "phold_msgs": 16384, "phold_seed": 7,
    "phold_warm_ns": int(1e8), "phold_horizon_ns": int(30e9),
    "sat_ifs": 4096, "sat_seed": 17, "sat_pkts": 20_000, "sat_warm": 100,
    "sat_ticks": 30_000,
    "tc_relays": 200, "tc_circuits": 2000, "tc_seed": 23, "tc_bw": 4096,
    "tc_warm": (2, 10_000), "tc_cells": 200, "tc_max_ticks": 500_000,
    "engine_hosts": 64, "engine_stop": 30,
    "bw_hosts": 2050, "bw_pkts": 65_536, "bw_seed": 41,
}
# the JAX package's test sizes (tests/test_phold_device.py,
# test_saturate_device.py, test_torcells_device.py), for a run in seconds
SMALL = dict(FULL, phold_hosts=32, phold_msgs=64, phold_seed=11,
             phold_horizon_ns=int(2e9), sat_ifs=64, sat_pkts=3000,
             sat_ticks=5000, tc_relays=20, tc_circuits=60, tc_seed=3,
             tc_bw=512, tc_cells=40, tc_max_ticks=40_000, engine_hosts=8,
             engine_stop=5, bw_hosts=8, bw_pkts=400)


def phold_digest(host: np.ndarray, time_ns: np.ndarray) -> str:
    """sha256 of PHOLD's final state: host as int32, then time as int64."""
    return hashlib.sha256(
        np.ascontiguousarray(host, dtype=np.int32).tobytes()
        + np.ascontiguousarray(time_ns, dtype=np.int64).tobytes()).hexdigest()


def saturate_flows(sizes: dict):
    """bench.py's saturation instance: bandwidths 200-4000 KiB/s from
    default_rng(sat_seed), every flow from tick 0, sat_pkts packets."""
    rng = np.random.default_rng(sizes["sat_seed"])
    n_if = sizes["sat_ifs"]
    bw = rng.integers(200, 4000, size=n_if)
    first = np.zeros(n_if, dtype=np.int64)
    npk = np.full(n_if, sizes["sat_pkts"], dtype=np.int64)
    return bw, first, npk


def admission_batch(sizes: dict):
    """One round's batch as tests/test_bandwidth_ops.py draws it: uniform
    destinations, 60 B to MTU packets arriving over 20 ms, receive rates
    80-2000 KiB/s and buckets filled anywhere up to capacity.  Returns
    (rates, dst_rows, sizes, arrive, tokens0)."""
    from ..core import defs
    from ..ops.bandwidth import REFILL_NS, bucket_params
    rng = np.random.default_rng(sizes["bw_seed"])
    n_hosts, n = sizes["bw_hosts"], sizes["bw_pkts"]
    dst = rng.integers(0, n_hosts, size=n).astype(np.int32)
    pkt = rng.integers(60, defs.CONFIG_MTU + 1, size=n).astype(np.int64)
    arrive = rng.integers(10 * REFILL_NS, 30 * REFILL_NS,
                          size=n).astype(np.int64)
    rates = rng.integers(80, 2000, size=n_hosts).astype(np.int64)
    _refill, capacity = bucket_params(rates)
    tokens0 = rng.integers(0, capacity + 1, size=n_hosts).astype(np.int64)
    return rates, dst, pkt, arrive, tokens0


def engine_xml(n: int, stop: int) -> str:
    """bench.py's engine PHOLD twin: n hosts, 4 messages each in flight."""
    return (f'<shadow stoptime="{stop}"><plugin id="phold" '
            f'path="python:phold" /><host id="phold" quantity="{n}" '
            f'bandwidthdown="10240" bandwidthup="10240"><process '
            f'plugin="phold" starttime="1" arguments="{n} 4 9000" /></host>'
            f'</shadow>')


def _launches() -> dict:
    from ..ops import bandwidth, phold_device, saturate_device, torcells_device
    return {"phold": phold_device.phold_run.launches,
            "saturate": saturate_device.saturate_run.launches,
            "torcells_run": torcells_device.torcells_run.launches,
            "admit_sorted": bandwidth.admit_sorted.launches}


def run_engine(sizes: dict, device: str) -> dict:
    """The engine twin through the port's Controller (global policy)."""
    from ..core import configuration
    from ..core.controller import Controller
    from ..core.logger import SimLogger, set_logger
    from ..core.options import Options
    set_logger(SimLogger(level="warning"))
    stop = sizes["engine_stop"]
    cfg = configuration.parse_xml(engine_xml(sizes["engine_hosts"], stop))
    cfg.stop_time_sec = stop
    ctl = Controller(Options(scheduler_policy="global", workers=0,
                             stop_time_sec=stop, device=device), cfg)
    t0 = _walltime.perf_counter()
    rc = ctl.run()
    wall = _walltime.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"modelbench: the engine twin exited {rc}")
    events = ctl.engine.events_executed
    return {"phold_engine_events": events,
            "phold_engine_events_per_sec": round(events / wall),
            "phold_engine_wall_s": wall}


def run(device: str = "cuda", sizes: Optional[dict] = None,
        engine: bool = True) -> dict:
    """Every workload once after its warm-up call, on ``device``; the
    engine twin too unless ``engine`` is False.  Returns bench.py's keys,
    the parity counts, the launches each workload made (warm-up included)
    and the walls, unrounded beside bench.py's rounded rates."""
    import torch
    from ..device import resolve_device
    from ..ops.bandwidth import BandwidthKernel
    from ..ops.phold_device import DevicePhold
    from ..ops.saturate_device import DeviceSaturate
    from ..ops.torcells_device import DeviceTorCells
    sizes = FULL if sizes is None else sizes
    dev = resolve_device(device)
    out = {"device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else "cpu")}
    before = _launches()

    # device-resident PHOLD; the horizon is a runtime argument, so the
    # warm-up call builds and loads the kernel for the timed one
    p = DevicePhold(n_hosts=sizes["phold_hosts"], n_msgs=sizes["phold_msgs"],
                    seed=sizes["phold_seed"], device=device)
    p.run_device(sizes["phold_warm_ns"])
    t0 = _walltime.perf_counter()
    host, tm, hops = p.run_device(sizes["phold_horizon_ns"])
    dt = _walltime.perf_counter() - t0
    sim_s = sizes["phold_horizon_ns"] / 1e9
    out.update(phold_device_hops=hops,
               phold_device_hops_per_sec=round(hops / dt),
               phold_device_sim_sec_per_wall_sec=round(sim_s / dt, 1),
               phold_device_digest=phold_digest(host, tm),
               phold_device_wall_s=dt)

    # token-bucket pacing + drop-tail + refill lifetime, every interface
    bw, first, npk = saturate_flows(sizes)
    sat = DeviceSaturate(bw, device=device)
    sat.run_device(first, npk, sizes["sat_warm"])
    t0 = _walltime.perf_counter()
    delivered, dropped, _q, _t = sat.run_device(first, npk,
                                                sizes["sat_ticks"])
    dt = _walltime.perf_counter() - t0
    n_if = sizes["sat_ifs"]
    out.update(saturate_device_interfaces=n_if,
               saturate_device_if_ticks_per_sec=round(
                   n_if * sizes["sat_ticks"] / dt),
               saturate_device_delivered_pkts=int(delivered.sum()),
               saturate_device_dropped_pkts=int(dropped.sum()),
               saturate_device_wall_s=dt)

    # circuits over contended relays, bulk cells to completion
    tc = DeviceTorCells(n_relays=sizes["tc_relays"],
                        n_circuits=sizes["tc_circuits"],
                        seed=sizes["tc_seed"],
                        relay_bw_kibps=sizes["tc_bw"], device=device)
    tc.run_device(*sizes["tc_warm"])
    t0 = _walltime.perf_counter()
    d, ticks, fwd = tc.run_device(sizes["tc_cells"], sizes["tc_max_ticks"])
    dt = _walltime.perf_counter() - t0
    out.update(torcells_device_circuits=sizes["tc_circuits"],
               torcells_device_cell_forwards=fwd,
               torcells_device_forwards_per_sec=round(fwd / dt),
               torcells_device_sim_sec_per_wall_sec=round(ticks / 1000 / dt,
                                                          1),
               torcells_device_ticks=ticks,
               torcells_device_delivered=int(d.sum()),
               torcells_device_wall_s=dt)

    # FIFO token-bucket admission of one round's batch at every host
    rates, dst, pkt, arrive, tokens0 = admission_batch(sizes)
    bk = BandwidthKernel(rates, device=device)
    bk.admit(dst, pkt, arrive, tokens0)
    t0 = _walltime.perf_counter()
    admits = bk.admit(dst, pkt, arrive, tokens0)
    dt = _walltime.perf_counter() - t0
    out.update(bandwidth_device_packets=len(dst),
               bandwidth_device_pkts_per_sec=round(len(dst) / dt),
               bandwidth_device_admits_digest=hashlib.sha256(
                   np.ascontiguousarray(admits, dtype=np.int64).tobytes())
               .hexdigest(),
               bandwidth_device_delayed=int((admits > arrive).sum()),
               bandwidth_device_wall_s=dt)

    after = _launches()
    out["launches"] = {k: after[k] - before[k] for k in after}
    if engine:
        out.update(run_engine(sizes, device))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default): the hand-written kernels; cpu: "
                    "their plain torch versions")
    ap.add_argument("--small", action="store_true",
                    help="the JAX package's test sizes instead of bench.py's")
    args = ap.parse_args(argv)
    res = run(args.device, SMALL if args.small else FULL)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
