"""simfuzz in the port (shadow_tpu_torch/fuzz/), on the CPU: the oracle
set, the shrinker, the fault harness, the caught -> shrunk -> replayed
drill, the CLI and the corpus, as tests/test_simfuzz.py holds them in the
JAX package; and the three runners held to one another: the bounded
subprocess runner and the batched runner give the in-process runner's
results, and a child past its bound comes back as a timeout with no
process of its group left behind.  Every run is ``--device cpu`` (the
kernels' plain versions)."""

import copy
import json
import os

import pytest

import chip_smoke
from shadow_tpu_torch.fuzz import cli as fuzz_cli
from shadow_tpu_torch.fuzz.gen import draw_spec, spec_digest
from shadow_tpu_torch.fuzz.oracles import check
from shadow_tpu_torch.fuzz.runner import (BatchedRunner, InProcessRunner,
                                          SubprocessRunner, _mode_options,
                                          apply_fault, parse_fault)
from shadow_tpu_torch.fuzz.shrink import shrink

CORPUS = fuzz_cli.CORPUS_DIR
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# oracles over synthetic results
# ---------------------------------------------------------------------------

def _result(**kw):
    r = {"mode": "base", "repeat_of": None, "events_comparable": True,
         "skipped": None, "rc": 0, "digest": "d0", "events": 100,
         "rounds": 10, "supervision": {"recoveries": 0}, "scrape": {},
         "log_tail": "", "wall_sec": 0.1}
    r.update(kw)
    return r


def _oracle_names(viols):
    return sorted({v["oracle"] for v in viols})


NO_FAULT = {"fault_inject": None}
MESH_OK = {"mesh.occupancy_min": 0.5, "mesh.occupancy_mean": 0.6}


@pytest.mark.parametrize("results,want", [
    ([_result(), _result(mode="base-repeat", repeat_of="base"),
      _result(mode="numpy")], []),
    ([_result(rc=1)], ["rc_log"]),
    ([_result(log_tail="...\nTraceback (most recent call last)\n...")],
     ["rc_log"]),
    ([_result(skipped="only 1 device")], []),
    ([_result(), _result(mode="numpy", digest="dY")], ["parity"]),
    ([_result(), _result(mode="k1", events=101)], ["events"]),
    ([_result(), _result(mode="threaded", events=101,
                         events_comparable=False)], []),
    ([_result(supervision={"recoveries": 2, "details": "x"})],
     ["supervision"]),
    ([_result(scrape=dict(MESH_OK, **{"mesh.host_bounces": 3}))], ["mesh"]),
    ([_result(scrape=dict(MESH_OK, **{"mesh.host_bounces": 0,
                                      "mesh.demoted": 1}))], ["mesh"]),
    ([_result(scrape={"plane.circuits": 10, "plane.completed": 10}),
      _result(mode="numpy",
              scrape={"plane.circuits": 10, "plane.completed": 9})],
     ["completion"]),
], ids=["clean", "rc", "traceback", "skipped", "parity", "events",
        "events-not-comparable", "supervision", "mesh-bounces",
        "mesh-demoted", "completion"])
def test_oracle(results, want):
    assert _oracle_names(check(NO_FAULT, results)) == want


def test_oracle_stability_fires_with_parity():
    drift = [_result(),
             _result(mode="base-repeat", repeat_of="base", digest="dX")]
    names = _oracle_names(check(NO_FAULT, drift))
    assert "stability" in names and "parity" in names


def test_oracle_recovery_drill_modes_exempt():
    res = [_result(),
           _result(mode="procs-resurrect",
                   engine_fault="shard-exit-resurrect:1:2",
                   supervision={"recoveries": 2}),
           _result(mode="mesh-lost", engine_fault="device-lost:3",
                   scrape=dict(MESH_OK, **{"mesh.host_bounces": 0,
                                           "mesh.demoted": 1}))]
    assert check(NO_FAULT, res) == []
    res[1]["digest"] = "dX"
    assert _oracle_names(check(NO_FAULT, res)) == ["parity"]


# ---------------------------------------------------------------------------
# fault harness
# ---------------------------------------------------------------------------

def test_parse_fault():
    assert parse_fault("digest-drift:numpy") == \
        {"kind": "digest-drift", "mode": "numpy"}
    assert parse_fault("rc-drift") == {"kind": "rc-drift", "mode": "*"}
    assert parse_fault("engine:native-round:1") == \
        {"kind": "engine", "spec": "native-round:1"}
    with pytest.raises(ValueError):
        parse_fault("nonsense:x")
    with pytest.raises(ValueError):
        parse_fault("engine:not-a-real-kind")


def test_apply_fault_targets_one_mode():
    spec = {"fault_inject": {"kind": "digest-drift", "mode": "numpy"}}
    assert apply_fault(spec, _result())["digest"] == "d0"
    assert apply_fault(spec, _result(mode="numpy"))["digest"].startswith(
        "drift-")
    spec = {"fault_inject": {"kind": "events-drift", "mode": "*"}}
    assert apply_fault(spec, _result())["events"] == 101


def test_engine_fault_passthrough_sets_options():
    spec = _drill_spec()
    spec["fault_inject"] = {"kind": "engine", "spec": "native-round:1"}
    opts = _mode_options(spec, spec["modes"][0], "cpu")
    assert opts.fault_inject == "native-round:1"
    assert opts.device == "cpu"


# ---------------------------------------------------------------------------
# shrinker (stub runner: no engine, pins the algorithm)
# ---------------------------------------------------------------------------

class _StubRunner:
    """Fails the parity oracle iff n_clients >= 4 and the numpy mode is
    still in the matrix."""

    def __init__(self):
        self.runs = 0

    def run(self, spec):
        self.runs += 1
        bad = spec["params"].get("n_clients", 0) >= 4 and any(
            m["name"] == "numpy" for m in spec["modes"])
        return [_result(mode=m["name"], repeat_of=m.get("repeat_of"),
                        digest="dX" if (bad and m["name"] == "numpy")
                        else "d0")
                for m in spec["modes"]]


def _stub_spec(n_clients=40):
    mode = {"device_plane": "device", "workers": 0, "superwindow_rounds": 8}
    return {"version": 1, "seed": 0, "family": "star",
            "params": {"n_clients": n_clients, "down_bytes": 65536},
            "apps": [{"id": "esrv", "quantity": 1, "bw": 1024,
                      "plugin": "echo", "start": 1.0,
                      "args": "udp server 8000"}],
            "topology": {"vertices": 3, "seed": 1,
                         "max_latency_ms": 10.0, "loss_pct": 0.0},
            "stoptime": 24, "engine_seed": 1, "fault_inject": None,
            "modes": [dict(mode, name="base"),
                      dict(mode, name="base-repeat", repeat_of="base"),
                      dict(mode, name="numpy", device_plane="numpy"),
                      dict(mode, name="k1", superwindow_rounds=1)]}


def test_shrink_deterministic_minimal():
    spec = _stub_spec()
    runner = _StubRunner()
    viols = check(spec, runner.run(spec))
    assert viols and viols[0]["oracle"] == "parity"
    small1, final1, runs1 = shrink(spec, viols[0], runner, budget=60)
    small2, _final2, runs2 = shrink(spec, viols[0], _StubRunner(),
                                    budget=60)
    assert small1 == small2 and runs1 == runs2
    assert small1["params"]["n_clients"] == 4
    assert len(small1["modes"]) == 2
    assert any(m["name"] == "numpy" for m in small1["modes"])
    assert small1["apps"] == [] and small1["topology"] is None
    assert small1["stoptime"] == 6
    assert final1["oracle"] == "parity"


def test_shrink_budget_bounds_runs():
    spec = _stub_spec()
    runner = _StubRunner()
    viols = check(spec, runner.run(spec))
    runner.runs = 0
    _small, _final, runs = shrink(spec, viols[0], runner, budget=5)
    assert runs == 5 and runner.runs == 5


# ---------------------------------------------------------------------------
# the real drill: fault-injected violation caught -> shrunk -> replayed
# ---------------------------------------------------------------------------

def _drill_spec():
    """tests/test_simfuzz.py's drill spec: star, 2 modes, numpy mode
    drifted; only n_clients and stoptime can halve."""
    mode = {"policy": "global", "workers": 0, "processes": 0,
            "device_plane": "numpy", "superwindow_rounds": 8,
            "tpu_devices": 1, "host_table": "on", "dataplane": "python",
            "device_plane_sync": False, "events_comparable": True}
    return {"version": 1, "seed": 999, "family": "star",
            "params": {"n_clients": 4, "down_bytes": 1024,
                       "stagger_waves": 1, "stagger_step_sec": 1.0},
            "apps": [], "topology": None, "stoptime": 7,
            "engine_seed": 7,
            "fault_inject": {"kind": "digest-drift", "mode": "numpy"},
            "modes": [dict(mode, name="base"), dict(mode, name="numpy")]}


def test_fault_drill_caught_shrunk_replayed(tmp_path):
    spec = _drill_spec()
    runner = InProcessRunner(device="cpu")
    viols = check(spec, runner.run(spec))
    assert viols and viols[0]["oracle"] == "parity"
    assert "numpy" in viols[0]["modes"]
    small1, final1, _ = shrink(spec, viols[0], runner, budget=8)
    small2, _final2, _ = shrink(spec, viols[0], runner, budget=8)
    assert small1 == small2
    assert small1["params"]["n_clients"] == 2
    assert small1["stoptime"] == 6
    path = str(tmp_path / "repro.json")
    fuzz_cli.write_repro(small1, final1, path)
    assert fuzz_cli.replay_file(path, runner) == 0
    # a repro whose drift is removed does not reproduce: replay re-judges
    with open(path) as f:
        blob = json.load(f)
    blob["spec"]["fault_inject"] = None
    clean_path = str(tmp_path / "norepro.json")
    with open(clean_path, "w") as f:
        json.dump(blob, f)
    assert fuzz_cli.replay_file(clean_path, runner) == 1


# ---------------------------------------------------------------------------
# corpus
# ---------------------------------------------------------------------------

def test_corpus_is_the_ports_own_and_wellformed():
    assert os.path.dirname(CORPUS) == os.path.join(
        REPO, "shadow_tpu_torch", "fuzz")
    files = fuzz_cli.corpus_files(CORPUS)
    assert len(files) == 7
    fams = set()
    for path in files:
        with open(path) as f:
            blob = json.load(f)
        assert blob["expect"] in ("clean", "violation"), path
        assert blob["spec"]["version"] == 1, path
        assert blob["spec_digest"] == spec_digest(blob["spec"]), path
        fams.add(blob["spec"]["family"])
    assert fams >= {"star", "tor", "cdn", "swarm", "phold", "appmix"}


# ---------------------------------------------------------------------------
# CLI surface
# ---------------------------------------------------------------------------

def test_cli_repro_missing_file():
    assert fuzz_cli.main(["--repro", "/nonexistent/x.json", "--in-process",
                          "--device", "cpu"]) == 2


def test_cli_spec_only(capsys):
    assert fuzz_cli.main(["--seeds", "3", "--spec-only",
                          "--device", "cpu"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    specs = [json.loads(ln) for ln in lines[:-1]]   # last line = summary
    assert [s["seed"] for s in specs] == [0, 1, 2]
    assert specs == [draw_spec(s) for s in (0, 1, 2)]


def test_cli_fault_drill_end_to_end(tmp_path, capsys):
    """--spec + --fault-inject writes a shrunk repro and exits 1; --repro
    on it exits 0."""
    spec = _drill_spec()
    spec["fault_inject"] = None       # injected via the flag instead
    spec_path = str(tmp_path / "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    rc = fuzz_cli.main(["--spec", spec_path, "--in-process",
                        "--device", "cpu",
                        "--fault-inject", "digest-drift:numpy",
                        "--repro-dir", str(tmp_path / "repros"),
                        "--shrink-budget", "8"])
    assert rc == 1
    summary = json.loads(capsys.readouterr().out.splitlines()[-1])
    repros = summary["simfuzz"]["repros"]
    assert len(repros) == 1 and summary["simfuzz"]["violations"] >= 1
    assert fuzz_cli.main(["--repro", repros[0], "--in-process",
                          "--device", "cpu"]) == 0


def test_cli_cuda_without_a_card_raises_before_any_run(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert fuzz_cli.build_parser().parse_args([]).device == "cuda"
    for extra in ([], ["--in-process"], ["--batched"]):
        with pytest.raises(RuntimeError, match="cuda"):
            fuzz_cli.main(["--seeds", "1", *extra])


# ---------------------------------------------------------------------------
# the runners held to one another
# ---------------------------------------------------------------------------

KEYS = ("mode", "skipped", "rc", "digest", "events", "rounds", "scrape")


def _same(got, want):
    assert [r["mode"] for r in got] == [r["mode"] for r in want]
    for g, w in zip(got, want):
        assert g["rc"] == 0, g["log_tail"]
        for key in KEYS:
            assert g[key] == w[key], (g["mode"], key)


def test_subprocess_runner_equals_in_process():
    """One drawn spec (seed 1: a cdn scenario, 11 modes with the mesh,
    resume and recovery drills) in one bounded child equals the same
    spec in process."""
    spec = draw_spec(1)
    got = SubprocessRunner(timeout_sec=240, device="cpu").run(spec)
    want = InProcessRunner(device="cpu").run(spec)
    _same(got, want)
    assert check(spec, got) == []


def test_subprocess_runner_overrun_is_a_timeout():
    """A child past its bound is killed with its process group and comes
    back as a timeout result the rc_log oracle fails.  The kill lands
    while the child's ``--processes`` shards run (the smoke's witness waits
    for them before it lets the kill go), and nothing of the group is left
    running after it."""
    over = chip_smoke.FUZZ_OVERRUN
    spec = copy.deepcopy(draw_spec(over["seed"]))   # phold, with procs
    spec["stoptime"] = over["stoptime"]
    spec["modes"] = [m for m in spec["modes"] if m["name"] == over["mode"]]
    assert spec["modes"][0]["processes"] >= 2
    with chip_smoke.group_kill_witness(over["wait_s"]) as group:
        res = SubprocessRunner(timeout_sec=1.0, device="cpu").run(spec)
    assert len(res) == 1 and res[0]["timeout"] is True
    assert res[0]["rc"] is None
    viols = check(spec, res)
    assert [v["oracle"] for v in viols] == ["rc_log"]
    assert "bound" in viols[0]["detail"]
    pid = int(res[0]["log_tail"].split("(pid ")[1].split(")")[0])
    assert pid in group["before"] and len(group["before"]) >= 2
    assert group["after"] == []
    assert chip_smoke.live_group_members(pid) == []


def test_batched_runner_equals_in_process():
    """Seeds 1 and 11 (cdn and star, each with device traffic) as fleet
    lanes of 4, their other modes serially: verdicts and every mode's
    results equal to the in-process runner's."""
    specs = [draw_spec(1), draw_spec(11)]
    runner = BatchedRunner(lanes=4, device="cpu")
    got = runner.run_specs(specs)
    assert runner.batched_modes > 0 and runner.serial_modes > 0
    assert runner.plane_stats()["fleet.launches"] > 0
    ref = InProcessRunner(device="cpu")
    for spec, rows in zip(specs, got):
        want = ref.run(spec)
        _same(rows, want)
        assert check(spec, rows) == check(spec, want) == []
