"""The model workloads slice (``shadow_tpu_torch.tools.modelbench``) as a
whole, on the CPU, against the JAX package.

At the JAX package's test sizes (``modelbench.SMALL``) every count the
port's slice prints (PHOLD's hops and final-state digest, saturation's
delivered and dropped packets, the cell model's ticks, forwards and
delivered cells, the admission batch's digest, and the engine PHOLD twin's
events) must equal what the JAX package's classes and engine give on the
same instances.  The ``slow`` test remakes ``chip_smoke.py``'s
EXPECTED_MODELS from the JAX package at bench.py's full sizes
(``python -m pytest -m slow tests/test_torch_modelbench.py``, about a
minute).  Tolerance: none (exact counts).
"""

import hashlib
import json

import numpy as np
import pytest
import torch

import chip_smoke
from shadow_tpu_torch.tools import modelbench as mb

# the parity counts (bench.py's keys among them)
COUNTS = ("phold_device_hops", "phold_device_digest",
          "saturate_device_delivered_pkts", "saturate_device_dropped_pkts",
          "torcells_device_ticks", "torcells_device_cell_forwards",
          "torcells_device_delivered", "bandwidth_device_admits_digest",
          "bandwidth_device_delayed", "phold_engine_events")
BENCH_KEYS = ("phold_device_hops", "phold_device_hops_per_sec",
              "phold_device_sim_sec_per_wall_sec",
              "saturate_device_interfaces",
              "saturate_device_if_ticks_per_sec",
              "saturate_device_delivered_pkts",
              "saturate_device_dropped_pkts", "torcells_device_circuits",
              "torcells_device_cell_forwards",
              "torcells_device_forwards_per_sec",
              "torcells_device_sim_sec_per_wall_sec", "phold_engine_events",
              "phold_engine_events_per_sec")


def jax_counts(sizes: dict) -> dict:
    """The parity counts from the JAX package's classes and engine on the
    instances modelbench builds at ``sizes``."""
    from shadow_tpu.core import configuration
    from shadow_tpu.core.controller import Controller
    from shadow_tpu.core.logger import SimLogger, set_logger
    from shadow_tpu.core.options import Options
    from shadow_tpu.ops.bandwidth import BandwidthKernel
    from shadow_tpu.ops.phold_device import DevicePhold
    from shadow_tpu.ops.saturate_device import DeviceSaturate
    from shadow_tpu.ops.torcells_device import DeviceTorCells
    out = {}
    p = DevicePhold(sizes["phold_hosts"], sizes["phold_msgs"],
                    seed=sizes["phold_seed"])
    host, tm, hops = p.run_device(sizes["phold_horizon_ns"])
    out["phold_device_hops"] = hops
    out["phold_device_digest"] = mb.phold_digest(host, tm)
    bw, first, npk = mb.saturate_flows(sizes)
    d, dr, _q, _t = DeviceSaturate(bw).run_device(first, npk,
                                                  sizes["sat_ticks"])
    out["saturate_device_delivered_pkts"] = int(d.sum())
    out["saturate_device_dropped_pkts"] = int(dr.sum())
    tc = DeviceTorCells(sizes["tc_relays"], sizes["tc_circuits"],
                        seed=sizes["tc_seed"], relay_bw_kibps=sizes["tc_bw"])
    dl, ticks, fwd = tc.run_device(sizes["tc_cells"], sizes["tc_max_ticks"])
    out["torcells_device_ticks"] = ticks
    out["torcells_device_cell_forwards"] = fwd
    out["torcells_device_delivered"] = int(dl.sum())
    rates, dst, pkt, arrive, tok0 = mb.admission_batch(sizes)
    admits = BandwidthKernel(rates).admit(dst, pkt, arrive, tok0)
    out["bandwidth_device_admits_digest"] = hashlib.sha256(
        np.ascontiguousarray(admits, dtype=np.int64).tobytes()).hexdigest()
    out["bandwidth_device_delayed"] = int((admits > arrive).sum())
    set_logger(SimLogger(level="warning"))
    stop = sizes["engine_stop"]
    cfg = configuration.parse_xml(mb.engine_xml(sizes["engine_hosts"], stop))
    cfg.stop_time_sec = stop
    ctl = Controller(Options(scheduler_policy="global", workers=0,
                             stop_time_sec=stop), cfg)
    assert ctl.run() == 0
    out["phold_engine_events"] = ctl.engine.events_executed
    return out


def test_small_slice_matches_jax():
    port = mb.run("cpu", mb.SMALL)
    assert port["device"] == "cpu"
    assert {k: port[k] for k in COUNTS} == jax_counts(mb.SMALL)
    # every device workload ran (warm-up + timed call) and on the CPU no
    # kernel launched
    assert port["launches"] == {"phold": 0, "saturate": 0,
                                "torcells_run": 0, "admit_sorted": 0}
    assert port["torcells_device_delivered"] == \
        mb.SMALL["tc_circuits"] * mb.SMALL["tc_cells"]


def test_cli_prints_one_json_line_with_bench_keys(capsys):
    assert mb.main(["--device", "cpu", "--small"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    res = json.loads(lines[0])
    for key in BENCH_KEYS + COUNTS:
        assert key in res, key


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        mb.run("cuda", mb.SMALL, engine=False)
    with pytest.raises(RuntimeError, match="cuda"):
        mb.main(["--small"])


def test_sizes_are_bench_py_s():
    assert (mb.FULL["phold_hosts"], mb.FULL["phold_msgs"],
            mb.FULL["phold_horizon_ns"]) == (1024, 16384, 30 * 10 ** 9)
    assert (mb.FULL["sat_ifs"], mb.FULL["sat_ticks"]) == (4096, 30_000)
    assert (mb.FULL["tc_relays"], mb.FULL["tc_circuits"],
            mb.FULL["tc_cells"]) == (200, 2000, 200)
    assert set(chip_smoke.EXPECTED_MODELS) == set(COUNTS)


@pytest.mark.slow
def test_expected_models_from_the_jax_package():
    """chip_smoke.py's EXPECTED_MODELS, remade with the JAX package at
    bench.py's sizes."""
    assert jax_counts(mb.FULL) == chip_smoke.EXPECTED_MODELS
