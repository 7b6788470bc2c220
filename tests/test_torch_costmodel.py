"""The port's cost model (shadow_tpu_torch/prof/) on the CPU, held to the
JAX package's where the two meet.

1. Model mechanics: build/save/load round trip and the query surface
   (equal to the JAX package's CostModel on the same tables), the refusal
   contract (a foreign host, the other platform, a tampered payload, the
   JAX package's own COSTMODEL.json), ``load_for_engine`` never raising,
   and ``check_model``'s drills under the port's fingerprint.
2. The decisions: ``choose_exchange_mode`` under a model, the heuristic
   and a forced mode, and — from one set of measurement tables stamped
   with each package's fingerprint — the same ``TunePlan`` and the same
   exchange mode in both packages.
3. Runs tuned by a model: a device-traffic star in the port (CPU) has the
   JAX package's tuned digest and its own untuned one, on one table and
   on 8 shards (JAX on its 8 virtual CPU devices); launch attribution and
   ``prof.model_stale`` in the port's scrape.
4. ``calibrate --quick --device cpu`` writes a model that loads (the
   whole path of the child process on the plain versions), and ``--device
   cuda`` without a card fails instead of measuring the CPU.
5. The capped mesh flush: ``mesh_span_flush_torch`` with caps against the
   JAX package's ``make_mesh_span_flush(cap_chains=, cap_nodes=)`` and
   ``mesh_flush_extra``, int64, bit for bit (tolerance 0).
"""

import copy
import io
import json
import os
import tempfile

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from shadow_tpu.parallel.mesh import device_mesh as jdevice_mesh
from shadow_tpu.parallel.mesh import exchange as jex
from shadow_tpu.prof import autotune as jautotune
from shadow_tpu.prof import model as jmodel
from shadow_tpu_torch.core.logger import SimLogger, set_logger
from shadow_tpu_torch.ops.torcells_device import flush_len
from shadow_tpu_torch.parallel.mesh import device_mesh
from shadow_tpu_torch.parallel.mesh import exchange as tex
from shadow_tpu_torch.parallel.mesh import partition as tpart
from shadow_tpu_torch.prof import autotune, calibrate
from shadow_tpu_torch.prof import model as prof_model
from shadow_tpu_torch.prof.cli import check_model
from shadow_tpu_torch.tools import workloads
from test_torch_device_plane import PACKAGES, fresh_logger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_MODEL = os.path.join(REPO, "COSTMODEL.json")

# the JAX package's gates' stars (tests/test_simprof.py, test_autotune.py):
# 24 single-table clients (48 chains: the capped flush can shrink), and 6
# on 8 shards (multi-leg cross-shard traffic)
STAR24_XML = workloads.star_bulk(24, stoptime=120,
                                 bulk_bytes=16 * 1024 * 1024,
                                 device_data=True)
STAR6_XML = workloads.star_bulk(6, stoptime=120, bulk_bytes=16 * 1024 * 1024,
                                device_data=True)
_TD = tempfile.mkdtemp(prefix="torch-costmodel-")


def cpu_fp():
    return prof_model.box_fingerprint("cpu")


def _measurements(step_points=None, ppermute_us=300.0, a2a_us=320.0,
                  psum_us=50.0, transfer=60.0, flush_us_per_mb=0.0):
    return {
        "collectives": {
            "ppermute": {"2x24": ppermute_us, "8x24": ppermute_us,
                         "8x960": ppermute_us},
            "all_to_all": {"2x24": a2a_us, "8x24": a2a_us,
                           "8x960": a2a_us},
            "psum": {"2x24": psum_us, "8x24": psum_us},
        },
        "step_kernel": {"points": step_points if step_points is not None
                        else [{"flows": 1, "us_per_step": 5.0},
                              {"flows": 1000, "us_per_step": 50.0}]},
        "transfer": {"dispatch_us": transfer, "flush_us": transfer,
                     "flush_us_per_mb": flush_us_per_mb},
    }


def _write(name, **kw):
    """A port model for the CPU of this box (in a module-stable directory,
    so cached runs share it), and the same tables as a JAX model."""
    p = os.path.join(_TD, name)
    if not os.path.exists(p):
        meas = _measurements(**kw)
        prof_model.save_model(p, prof_model.build_model(
            copy.deepcopy(meas), fingerprint=cpu_fp()))
        jmodel.save_model(p + ".jax", jmodel.build_model(
            copy.deepcopy(meas)))
    return p


# a covering launch-bound model (the JAX gates'): flat cheap steps, a
# large fixed transfer and a steep flush slope — deep K and compaction
LAUNCH_BOUND = dict(step_points=[{"flows": 1, "us_per_step": 30.0},
                                 {"flows": 1_000_000, "us_per_step": 30.0}],
                    transfer=1000.0, flush_us_per_mb=200_000.0)


# -- 1. model mechanics -----------------------------------------------------

def test_model_roundtrip_and_query_surface_equal_jax():
    p = _write("cm.json")
    m = prof_model.load_model(p, device="cpu")
    j = jmodel.load_model(p + ".jax")
    assert m.band == prof_model.DEFAULT_BAND
    assert 5.0 <= m.step_us(500) <= 50.0
    assert m.transfer_us() == 120.0
    assert m.collective_us("ppermute", 8, 24) == 300.0
    assert 0 < m.collective_us("all_to_all", 8, 500) <= 320.0
    assert m.exchange_tick_us(8, "fused", 3, [4, 4, 4]) == pytest.approx(
        320.0 + 50.0)
    assert m.exchange_tick_us(8, "ppermute", 3, [4, 4, 4]) == \
        pytest.approx(3 * 300.0 + 50.0)
    assert m.predict_window_us(10, 1000, 100.0) == pytest.approx(
        10 * (50.0 + 100.0) + 120.0)
    # every query equals the JAX package's on the same tables
    for flows in (0, 1, 500, 1000, 2000, 3000):
        assert m.step_us(flows) == j.step_us(flows)
        assert m.covers(flows) == j.covers(flows)
    for kind in ("ppermute", "all_to_all", "psum"):
        for d, w in ((2, 1), (3, 24), (8, 500), (8, 5000), (5, 100)):
            assert m.collective_us(kind, d, w) == j.collective_us(kind, d, w)
    for mode in ("fused", "ppermute", "none", "single"):
        assert m.exchange_tick_us(8, mode, 3, [4, 40]) == \
            j.exchange_tick_us(8, mode, 3, [4, 40])
    assert (m.transfer_us(), m.flush_us_per_mb(), m.flush_savings_us(4096),
            m.min_flows, m.max_flows) == \
        (j.transfer_us(), j.flush_us_per_mb(), j.flush_savings_us(4096),
         j.min_flows, j.max_flows)


def test_fingerprint_names_the_platform_and_torch():
    fp = cpu_fp()
    assert set(fp) == set(prof_model._FINGERPRINT_KEYS)
    assert fp["platform"] == "cpu" and fp["gpu"] is None
    assert fp["torch"] == torch.__version__
    assert "jax" not in fp
    with pytest.raises(prof_model.CostModelError, match="platform"):
        prof_model.box_fingerprint("tpu")


def test_model_refuses_foreign_box_other_platform_and_tamper(tmp_path):
    p = _write("cm.json")
    data = json.load(open(p))
    # foreign box: digest re-stamped (valid file), host name differs
    foreign = copy.deepcopy(data)
    foreign["fingerprint"]["node"] = str(
        foreign["fingerprint"]["node"]) + "-elsewhere"
    foreign["digest"] = prof_model.payload_digest(foreign)
    p2 = str(tmp_path / "foreign.json")
    prof_model.save_model(p2, foreign)
    with pytest.raises(prof_model.CostModelError, match="fingerprint"):
        prof_model.load_model(p2, device="cpu")
    # a CPU model refuses on the card; a card's model refuses on the CPU
    card = copy.deepcopy(data)
    card["fingerprint"].update(platform="cuda", gpu="NVIDIA H100 80GB HBM3",
                               capability="9.0", cuda="12.8")
    card["digest"] = prof_model.payload_digest(card)
    p3 = str(tmp_path / "card.json")
    prof_model.save_model(p3, card)
    with pytest.raises(prof_model.CostModelError, match="platform"):
        prof_model.load_model(p3, device="cpu")
    with pytest.raises(prof_model.CostModelError, match="platform"):
        prof_model.load_model(p, fingerprint=card["fingerprint"])
    # tampered measurement: digest left stale
    tampered = copy.deepcopy(data)
    tampered["transfer"]["flush_us"] = 1.0
    p4 = str(tmp_path / "tampered.json")
    with open(p4, "w") as f:
        json.dump(tampered, f)
    with pytest.raises(prof_model.CostModelError, match="digest"):
        prof_model.load_model(p4, device="cpu")
    for bad in ({"version": 1}, [1, 2]):
        with open(p4, "w") as f:
            json.dump(bad, f)
        with pytest.raises(prof_model.CostModelError, match="schema"):
            prof_model.load_model(p4, device="cpu")


def test_jax_package_model_refuses_by_schema():
    """The JAX package's checked-in model (fingerprinted to jax on its
    XLA box) never loads in the port, on either platform."""
    for device in ("cpu", "cuda"):
        with pytest.raises(prof_model.CostModelError, match="schema"):
            prof_model.load_model(JAX_MODEL, device=device)
    # ... and a JAX model of this very box's tables refuses as well
    with pytest.raises(prof_model.CostModelError, match="fingerprint"):
        prof_model.load_model(_write("cm.json") + ".jax", device="cpu")


def _load_logged(path, device="cpu"):
    """load_for_engine on ``path`` with the port's logger captured:
    (model, status, the log's lines)."""
    from shadow_tpu_torch.core.options import Options
    stream = io.StringIO()
    log = SimLogger(stream=stream, level="warning")
    set_logger(log)
    m, status = prof_model.load_for_engine(
        Options(cost_model=path, device=device))
    log.flush()
    return m, status, stream.getvalue().splitlines()


def test_load_for_engine_degrades_never_raises(tmp_path):
    m, status, log = _load_logged(str(tmp_path / "missing.json"))
    assert (m, status, log) == (None, "absent", [])
    m, status, log = _load_logged(_write("cm.json"))
    assert status == "loaded" and m.max_flows == 1000 and log == []
    # the JAX package's COSTMODEL.json: one warning line, never a raise
    m, status, log = _load_logged(JAX_MODEL)
    assert (m, status) == (None, "refused")
    assert len(log) == 1 and "cost model refused" in log[0]
    # a CPU model asked for on the card (no card here either): refused
    m, status, log = _load_logged(_write("cm.json"), device="cuda")
    assert (m, status) == (None, "refused") and len(log) == 1
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    assert _load_logged(str(bad))[1] == "refused"


def test_default_path_is_the_ports_own(monkeypatch):
    monkeypatch.delenv(prof_model.ENV_PATH, raising=False)
    path = prof_model.default_model_path()
    assert os.path.basename(path) == "COSTMODEL_TORCH.json"
    assert os.path.dirname(path) == REPO
    monkeypatch.setenv(prof_model.ENV_PATH, "/x/y.json")
    assert prof_model.default_model_path() == "/x/y.json"
    from shadow_tpu_torch.prof import ledger
    assert os.path.basename(ledger.default_history_path()) == \
        "BENCH_HISTORY_TORCH.jsonl"


def test_check_model_drills_refuse_under_the_ports_fingerprint(tmp_path):
    chk = check_model(_write("cm.json"))
    assert chk["ok"], chk["problems"]
    assert chk["device"] == "cpu" and chk["loads_on_this_box"]
    assert chk["stale_fingerprint_refused"]
    assert chk["tampered_digest_refused"]
    # judged for runs on the card, the CPU model would not load here
    chk = check_model(_write("cm.json"), device="cuda")
    assert chk["ok"] and chk["loads_on_this_box"] is False
    # the JAX package's model is not a model of the port
    chk = check_model(JAX_MODEL)
    assert not chk["ok"]
    assert any("fingerprint missing 'torch'" in p for p in chk["problems"])
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    assert not check_model(str(bad))["ok"]


# -- 2. the decisions -------------------------------------------------------

def _toy_schedule(mod, legs, d=8, pair_width=3, width=4):
    z = np.zeros(d * width, dtype=np.int64)
    return mod.ExchangeSchedule(
        d, list(range(1, legs + 1)), [width] * legs, [z] * legs,
        [z] * legs, legs * width, np.zeros((d, d), dtype=np.int64),
        pair_width, np.zeros(d * d * pair_width, dtype=np.int64),
        np.zeros(d * d * pair_width, dtype=np.int64))


def test_choose_exchange_mode_model_heuristic_forced():
    choose = tex.choose_exchange_mode
    assert choose(_toy_schedule(tex, 3)) == ("fused", 0.0, "heuristic")
    assert choose(_toy_schedule(tex, 1)) == ("ppermute", 0.0, "heuristic")
    assert choose(_toy_schedule(tex, 0))[0] == "none"
    a2a_cheap = prof_model.load_model(
        _write("a.json", ppermute_us=500.0, a2a_us=100.0), device="cpu")
    mode, pred, src = choose(_toy_schedule(tex, 3), a2a_cheap)
    assert (mode, src) == ("fused", "model") and pred > 0
    pp_cheap = prof_model.load_model(
        _write("b.json", ppermute_us=10.0, a2a_us=900.0), device="cpu")
    assert choose(_toy_schedule(tex, 3), pp_cheap)[::2] == ("ppermute",
                                                            "model")
    assert choose(_toy_schedule(tex, 1), a2a_cheap)[::2] == ("fused",
                                                             "model")
    assert choose(_toy_schedule(tex, 3), pp_cheap, "fused")[::2] == \
        ("fused", "forced")
    assert choose(_toy_schedule(tex, 0), pp_cheap, "fused")[0] == "none"


class _Opts:
    def __init__(self, k=8, cadence=8, autotune="on"):
        self.superwindow_rounds = k
        self.device_plane_batch_steps = cadence
        self.device_autotune = autotune


PLAN_MODELS = [
    ("cm.json", {}),
    ("launch-bound.json", LAUNCH_BOUND),
    ("compute-bound.json", dict(step_points=[
        {"flows": 1, "us_per_step": 5000.0},
        {"flows": 1_000_000, "us_per_step": 5000.0}])),
    ("far.json", dict(step_points=[
        {"flows": 1_000_000, "us_per_step": 5e6}])),
    ("a.json", dict(ppermute_us=500.0, a2a_us=100.0)),
    ("b.json", dict(ppermute_us=10.0, a2a_us=900.0)),
]


@pytest.mark.parametrize("name,kw", PLAN_MODELS,
                         ids=[n for n, _ in PLAN_MODELS])
def test_same_tables_same_plan_and_mode_in_both_packages(name, kw):
    """One set of measurement tables, stamped with each package's
    fingerprint and loaded by each: the same TunePlan for every flow
    table, options and exchange shape, and the same exchange mode."""
    p = _write(name, **kw)
    m = prof_model.load_model(p, device="cpu")
    j = jmodel.load_model(p + ".jax")
    for opts in (_Opts(), _Opts(k=1), _Opts(autotune="off"),
                 _Opts(cadence=2)):
        for flows, chains, nodes in ((500, 12, 7), (500, 4096, 1024),
                                     (100_000, 20_000, 30_494), (48, 48, 25)):
            for ex_us in (0.0, 37.5):
                a = autotune.plan_dispatch(m, "loaded", opts, flows, chains,
                                           nodes, ex_us)
                b = jautotune.plan_dispatch(j, "loaded", opts, flows, chains,
                                            nodes, ex_us)
                assert {s: getattr(a, s) for s in a.__slots__} == \
                    {s: getattr(b, s) for s in b.__slots__}
                assert a.metrics() == b.metrics()
    for legs in (0, 1, 3):
        for forced in ("auto", "fused", "ppermute"):
            assert tex.choose_exchange_mode(
                _toy_schedule(tex, legs), m, forced) == \
                jex.choose_exchange_mode(_toy_schedule(jex, legs), j, forced)


# -- 3. runs tuned by a model -----------------------------------------------

_RUNS: dict = {}


def _run(pkg, xml_key, model=None, **kw):
    """One run of a star (cached: runs are deterministic).  ``model``
    names a model of :func:`_write` (the package's own stamp), None no
    model at all."""
    key = (pkg, xml_key, model, tuple(sorted(kw.items())))
    if key in _RUNS:
        return _RUNS[key]
    conf, ctl, opt, ckpt = PACKAGES[pkg]
    xml = STAR24_XML if xml_key == "star24" else STAR6_XML
    cfg = conf.parse_xml(xml)
    cfg.stop_time_sec = 120
    path = "/nonexistent-no-model" if model is None else (
        _write(model, **dict(PLAN_MODELS)[model])
        + (".jax" if pkg == "jax" else ""))
    extra = dict(kw)
    if pkg == "torch":
        extra["device"] = "cpu"
    c = ctl.Controller(opt.Options(
        scheduler_policy="global", workers=0, seed=3, stop_time_sec=120,
        log_level="warning", device_plane="device",
        tpu_devices=extra.pop("tpu_devices", 1),
        device_plane_granule_ms=4, cost_model=path, **extra), cfg)
    fresh_logger(pkg)
    assert c.run() == 0
    e = c.engine
    out = {"digest": ckpt.state_digest(e), "events": e.events_executed,
           "rounds": e.rounds_executed, "scrape": e.metrics.scrape(),
           "stats": e.device_plane.stats()}
    _RUNS[key] = out
    return out


def test_tuned_run_equals_jax_and_the_untuned_run():
    """The launch-bound model deepens K to its ceiling and engages the
    capped flush (the port's CPU plane caps, as the JAX package's CPU
    backend does): the port's tuned run has the JAX package's tuned
    digest and events, and its own untuned digest."""
    port = _run("torch", "star24", "launch-bound.json")
    ref = _run("jax", "star24", "launch-bound.json")
    plain = _run("torch", "star24")
    sc = port["scrape"]
    assert sc["prof.autotune_source"] == "model"
    assert sc["prof.autotune_k"] == autotune.MAX_K
    assert sc["prof.autotune_flush_compact"] == 1
    assert sc["prof.flush_bytes_saved"] > 0
    assert plain["scrape"]["prof.autotune_source"] == "defaults"
    for k in ("prof.autotune_source", "prof.autotune_k",
              "prof.autotune_k_would", "prof.autotune_flush_compact",
              "prof.autotune_predicted_us", "prof.flush_bytes_saved"):
        assert sc[k] == ref["scrape"][k], k
    assert (port["digest"], port["events"]) == (ref["digest"],
                                                ref["events"])
    assert port["digest"] == plain["digest"]
    assert port["stats"]["rounds_per_launch"] > 1


def test_tuned_mesh_run_equals_jax_and_the_untuned_run():
    """The same at D = 8 (JAX on its 8 virtual CPU devices), with a
    model whose ppermute is cheap: the mesh reads the model (source
    ``model``, status ``loaded``) and picks ppermute, where the untuned
    run's heuristic takes fused; the digests are one."""
    port = _run("torch", "star6", "b.json", tpu_devices=8)
    ref = _run("jax", "star6", "b.json", tpu_devices=8)
    plain = _run("torch", "star6", tpu_devices=8)
    sc = port["scrape"]
    assert sc["mesh.exchange_source"] == "model"
    assert sc["mesh.cost_model"] == "loaded"
    assert sc["mesh.exchange_mode"] == "ppermute"
    assert sc["mesh.predicted_us"] > 0
    assert plain["scrape"]["mesh.exchange_source"] == "heuristic"
    assert plain["scrape"]["mesh.cost_model"] == "absent"
    assert plain["scrape"]["mesh.exchange_mode"] == "fused"
    for k in ("mesh.exchange_mode", "mesh.exchange_source",
              "mesh.predicted_us", "mesh.cross_shard_cells",
              "prof.autotune_source", "prof.autotune_k"):
        assert sc[k] == ref["scrape"][k], k
    assert (port["digest"], port["events"]) == (ref["digest"],
                                                ref["events"])
    assert port["digest"] == plain["digest"]


def test_attribution_and_stale_counter():
    """An in-range model fills the per-launch gauges; an absurd covering
    one raises prof.model_stale; an out-of-range one judges nothing."""
    sc = _run("torch", "star6", "cm.json")["scrape"]
    checked = sc["prof.launches_checked"]
    assert checked > 0
    assert sc["prof.launch_predicted_us"]["count"] == checked
    assert sc["prof.launch_measured_us"]["count"] >= checked
    absurd = os.path.join(_TD, "absurd.json")
    if not os.path.exists(absurd):
        prof_model.save_model(absurd, prof_model.build_model(
            _measurements(step_points=[{"flows": 1, "us_per_step": 5e6},
                                       {"flows": 1_000_000,
                                        "us_per_step": 5e6}],
                          transfer=5e6), fingerprint=cpu_fp()))
    sc = _run("torch", "star6", "far.json")["scrape"]
    assert sc["prof.launches_checked"] == 0 and sc["prof.model_stale"] == 0
    from shadow_tpu_torch.core import configuration, controller
    from shadow_tpu_torch.core.options import Options
    cfg = configuration.parse_xml(STAR6_XML)
    cfg.stop_time_sec = 120
    c = controller.Controller(Options(
        scheduler_policy="global", workers=0, seed=3, stop_time_sec=120,
        log_level="warning", device_plane="device", device="cpu",
        device_plane_granule_ms=4, cost_model=absurd), cfg)
    fresh_logger("torch")
    assert c.run() == 0
    sc = c.engine.metrics.scrape()
    assert sc["prof.autotune_source"] == "model"
    assert sc["prof.model_stale"] > 0


# -- 4. the calibration -----------------------------------------------------

def test_quick_cpu_calibration_writes_a_model_that_loads(tmp_path,
                                                        monkeypatch):
    # one thread in the child, so that it does not crowd the test workers
    # (the cap is only a bound: the child takes ~5 s alone)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    out = str(tmp_path / "cm.json")
    row = calibrate.run_calibration(out, quick=True, wall_cap_sec=600,
                                    devices=[2, 3], batched=True,
                                    device="cpu")
    assert row["ok"], row
    assert not row["truncated"]
    assert row["fingerprint"]["platform"] == "cpu"
    assert row["step_points"] == len(calibrate.QUICK_FLOW_POINTS)
    assert [p["width"] for p in row["fleet_batched"]["points"]] == \
        [1, 2, 4, 8]
    m = prof_model.load_model(out, device="cpu")
    assert m.covers(1000) and m.covers(10_000)
    # every D measured has its psum, all_to_all and ppermute entries, and
    # the ppermute shares add up to the measured excess
    for d in (2, 3):
        raw = row["measured"]["exchange"][str(d)]
        assert f"{d}x2" in m.data["collectives"]["psum"]
        assert f"{d}x{d * raw['pair_width']}" in \
            m.data["collectives"]["all_to_all"]
        total = m.exchange_tick_us(d, "ppermute", raw["pair_width"],
                                   raw["widths"]) \
            - m.exchange_tick_us(d, "none", raw["pair_width"], raw["widths"])
        assert total == pytest.approx(max(raw["diff_us"]["ppermute"], 0.0),
                                      abs=1e-3 * len(raw["widths"]))
    with pytest.raises(prof_model.CostModelError, match="platform"):
        prof_model.load_model(out, device="cuda")


def test_exchange_tables_from_the_measured_ticks():
    # psum = cross_free - single_cf; the modes' excess over single + psum
    t = calibrate._exchange_tables(
        8, {"single": 7.0, "single_cf": 7.1, "cross_free": 7.6,
            "fused": 7.75, "ppermute": 9.5},
        pair_width=5, widths=[10, 30, 10])
    assert t["psum"] == {"8x2": 0.5}
    assert t["all_to_all"] == {"8x40": 0.25}
    assert t["ppermute"] == {"8x10": 0.4, "8x30": 1.2}
    # noise below zero is 0 in the table
    t = calibrate._exchange_tables(
        2, {"single": 7.0, "single_cf": 7.0, "cross_free": 6.9,
            "fused": 6.8, "ppermute": 6.0},
        pair_width=4, widths=[4])
    assert t == {"psum": {"2x2": 0.0}, "all_to_all": {"2x8": 0.0},
                 "ppermute": {"2x4": 0.0}}


@pytest.mark.parametrize("d", [2, 3, 8])
def test_cross_free_twin_keeps_the_table_and_drops_cross_edges(d):
    """The exchange probe's baseline table: the calibration table's nodes,
    buckets, flow count and stage latencies' range, and at D = d no
    flow whose successor lies on another shard."""
    from shadow_tpu_torch.ops.torcells_device import DeviceTorCells
    from shadow_tpu_torch.parallel.mesh.partition import chain_partition
    n = calibrate.QUICK_COLLECTIVE_CIRCUITS
    ref = DeviceTorCells(n_relays=max(8, n // 10), n_circuits=n,
                         seed=calibrate.CALIB_SEED,
                         relay_bw_kibps=calibrate.CALIB_RELAY_KIBPS,
                         max_latency_ms=calibrate.CALIB_MAX_LATENCY_MS,
                         device="cpu")
    inst, shard_of = calibrate._cross_free_instance(n, d)
    fl, rf = inst.flows, ref.flows
    assert inst.n_flows == ref.n_flows == len(fl["flow_node"])
    assert inst.ring_len == ref.ring_len
    assert np.array_equal(inst.refill, ref.refill)
    assert np.array_equal(inst.capacity, ref.capacity)
    assert np.array_equal(np.sort(fl["flow_stage"]), np.sort(rf["flow_stage"]))
    assert fl["flow_lat"].max() <= rf["flow_lat"].max()
    succ = fl["flow_succ"]
    has = succ >= 0
    assert np.array_equal(shard_of[fl["flow_node"][has]],
                          shard_of[fl["flow_node"][succ[has]]])
    assert sorted(set(shard_of.tolist())) == list(range(d))
    # the calibration table itself has cross edges at this D
    assert chain_partition(rf["flow_node"], rf["flow_succ"], d)[1] > 0


def test_cuda_calibration_without_a_card_fails(tmp_path):
    out = str(tmp_path / "cm.json")
    row = calibrate.run_calibration(out, quick=True, wall_cap_sec=30,
                                    device="cuda")
    assert not row["ok"] and row["rc"] != 0
    assert "is_available" in row["tail"]
    assert not os.path.exists(out)


# -- 5. the capped mesh flush -----------------------------------------------

@pytest.fixture(scope="module")
def toy():
    from shadow_tpu.ops.torcells_device import DeviceTorCells
    return DeviceTorCells(n_relays=6, n_circuits=20, seed=5,
                          relay_bw_kibps=512, max_latency_ms=20)


@pytest.mark.parametrize("n_dev,caps", [(8, (3, 5)), (8, (64, 200)),
                                        (3, (2, 9)), (2, (1, 1))])
def test_capped_mesh_flush_equals_jax(toy, n_dev, caps):
    """The capped flush of the mesh step, bit for bit against the JAX
    package's, at caps below the window's counts (overflow: the TRUE
    header counts exceed the caps) and above them; the trailing slot
    after the capped layout."""
    from shadow_tpu.ops.torcells_device import flush_overflowed
    from shadow_tpu.parallel.mesh.partition import pad_state
    from test_torch_mesh import WINDOWS, _inputs, _mesh_state, _statics
    last_flow, queued0, target0 = _inputs(toy)
    h, c = len(toy.refill), len(last_flow)
    lay = tpart.build_mesh_layout(
        toy.flows["flow_node"], toy.flows["flow_lat"],
        toy.flows["flow_succ"], toy.flows["seg_start"], toy.refill,
        toy.capacity, n_dev)
    kw = dict(cap_chains=caps[0], cap_nodes=caps[1])
    jstep = jex.make_mesh_span_flush(
        jdevice_mesh(n_dev, axis_names=("flows",)), "flows", toy.ring_len,
        lay, lay["inv"][last_flow], lay["node_src"], h, **kw)
    tstep = tex.make_mesh_span_flush(
        device_mesh(n_dev, device="cpu"), "flows", toy.ring_len, lay,
        lay["inv"][last_flow], lay["node_src"], h, **kw)
    fp = len(lay["src"])
    zp = np.zeros(fp, np.int64)
    jout = (np.int64(0),) + tuple(jnp.asarray(a) for a in
                                  _mesh_state(lay, toy.ring_len))
    tout = (0,) + tuple(torch.as_tensor(a) for a in
                        _mesh_state(lay, toy.ring_len))
    overflowed = []
    for (tv, idle), inj in zip(WINDOWS, ((pad_state(lay, queued0),
                                          pad_state(lay, target0)),
                                         (zp, zp))):
        jout = jstep(*jout[:8], *inj, tv, np.int64(idle), *_statics(lay))
        tout = tstep(int(tout[0]), *tout[1:8], *inj, tv, idle,
                     *_statics(lay))
        for i in range(10):
            np.testing.assert_array_equal(np.asarray(tout[i]),
                                          np.asarray(jout[i]),
                                          err_msg=f"output {i}")
        flush = np.asarray(tout[9])
        assert len(flush) == flush_len(c, h, *caps) + 1
        assert tex.mesh_flush_extra(flush, c, h, *caps) == \
            jex.mesh_flush_extra(np.asarray(jout[9]), c, h, *caps)
        overflowed.append(flush_overflowed(flush, *caps))
    # caps below the busy window's counts drop entries; above, none
    assert any(overflowed) == (caps != (64, 200))
