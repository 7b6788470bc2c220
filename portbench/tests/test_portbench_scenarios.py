"""Scenarios found by name.

The Tor scenario (``portbench/scenarios/tor.py``) gives both cells what
the harness gave them before scenarios existed: the same
``Configuration`` and ``Options`` for every episode (pinned below as the
harness built them then) and, at the tiny size on the CPU, the same
answers, equal to those of the Tor scenario's functions called directly.

A second scenario of another shape (``scenario_star.py`` with its own
numpy reference ``star_reference.py``: genscen's star, 2-hop chains, the
plane on a mesh of two shards) is added to a copy of the benchmark as
files and entries alone: its run is correct with its own kinds of
answer, its control and a planted fault are refused, a configuration
naming no scenario file stops the run, and no file that was there
changes.
"""

import contextlib
import dataclasses
import hashlib
import json
import os
import shutil
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import benchcopy  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))

# as the harness built them before scenarios were found by name: for
# (configuration, mix, --seed, episode) the Configuration's
# genscen.config_digest and the engine's seed in the Options
EPISODES = {
    ("tor10k", "sweep8", 7, 0): (
        "d924941b43f20c2042e4c1e28bca1f085bc98931d5408198c452e08208e6ee39",
        2083679832),
    ("tor10k", "sweep8", 7, 1): (
        "6e14f9c6da3f49a855e3928105d5d8ae0e710d4b1b442dd74d0c447682994d37",
        369571992),
    ("tor10k", "sweep8", 3000000019, 0): (
        "494940a81ab1e2aa991e95df26ac02d8cd2492cc0e6ee2e51d26b9f2f2c98d68",
        2007379581),
    ("tor10k", "sweep8", 3000000019, 1): (
        "fb922fd0c27dfcb6b5c9b596801f719d49032bd46a2ca7fcbc20a7ebd764168c",
        878712576),
    ("tor100k", "serial", 7, 0): (
        "aeb2790343c24656d71fd69259958eaa1d281d3c26df2fbd4f6c7cf10521a1e8",
        2083679832),
    ("tor100k", "serial", 7, 1): (
        "e006beee6c61a542ee92dd83d95d322b70f3444af39096c508bec4472e02fa58",
        369571992),
    ("tor100k", "serial", 3000000019, 0): (
        "ecbec52ec6c58b2fc80e3ae912a22b1fef3acfb98c649a1df3ca364e6654a918",
        2007379581),
    ("tor100k", "serial", 3000000019, 1): (
        "4a965f3466b58130cac1df3acf24babb3d4a31752cd893781068050e2efa083c",
        878712576),
}
# the Options fields the harness set apart from the engine's seed (the
# stoptime, 60 s, and the device, cuda, are the defaults); every other
# field at its default
OPTIONS_SET = {"scheduler_policy": "global", "heartbeat_interval_sec": 0,
               "log_level": "warning", "host_table": "on"}
# at the tiny size, --seed 7: a digest of each episode's answers
# (chain_done, tx, rx, then forwards and completed) by episode index
ANSWERS = {
    1: "1bdee7dc74417efab23d52f3fbc9c925d476346af6064ea7eaac0140f82d4c02",
    2: "660d6e4e72dc34b80a2d4b068cb2e6632f318fdbe58d4a051d8a2162f15e3351",
    3: "fc91162e6a464854ba14bdd0a6f2135cc759ee49091f9348ff5a4f0533954d23",
}


def _tor():
    with contextlib.chdir(benchcopy.REPO):
        from portbench import cell
        return cell.scenario({})


def _files(config: str, mix: str):
    with open(os.path.join(benchcopy.REPO, "portbench", "configs",
                           f"{config}.json")) as f:
        c = json.load(f)
    with open(os.path.join(benchcopy.REPO, "portbench", "traffic",
                           f"{mix}.json")) as f:
        return c, json.load(f)


def _set_fields(opts):
    from shadow_tpu_torch.core.options import Options
    defaults = Options()
    return {f.name: getattr(opts, f.name) for f in dataclasses.fields(opts)
            if getattr(opts, f.name) != getattr(defaults, f.name)}


@pytest.mark.parametrize("key", sorted(EPISODES))
def test_tor_episode_as_before(key):
    from portbench.episodes import Experiments
    from shadow_tpu_torch.scale.genscen import config_digest
    config, mix, seed, index = key
    digest, engine_seed = EPISODES[key]
    exp = Experiments(_tor(), *_files(config, mix), seed, "cuda")
    cfg, opts, got_seed, _draw = exp.episode(index)
    assert config_digest(cfg) == digest
    assert got_seed == engine_seed
    assert _set_fields(opts) == {**OPTIONS_SET, "seed": engine_seed}


def test_tor_control_as_before():
    """The control (--control 1): the plane at a 2 ms tick, as before."""
    from portbench.episodes import Experiments
    exp = Experiments(_tor(), *_files("tor100k", "serial"), 7, "cuda",
                      control=True)
    _cfg, opts, engine_seed, _draw = exp.episode(0)
    assert _set_fields(opts) == {**OPTIONS_SET, "seed": engine_seed,
                                 "device_plane_granule_ms": 2}


def _answers(rec) -> str:
    h = hashlib.sha256()
    for k in ("chain_done", "tx", "rx"):
        h.update(rec[k].tobytes())
    h.update(json.dumps([int(rec["forwards"]), int(rec["completed"])])
             .encode())
    return h.hexdigest()


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The tiny copy, its fleet mix on two lanes (eight tiny episodes in
    lanes take ~25 s of the CPU; an episode's answers do not depend on
    the lanes beside it)."""
    root = benchcopy.tiny_copy(str(tmp_path_factory.mktemp("bench")))
    path = os.path.join(root, "portbench", "traffic", "sweep8.json")
    with open(path) as f:
        mix = json.load(f)
    with open(path, "w") as f:
        json.dump({**mix, "lanes": 2}, f)
    return root


@pytest.mark.parametrize("cell", ["tor100k.web", "tor10k.sweep8"])
def test_tor_answers_as_before(tiny, monkeypatch, cell):
    """The cell's episodes at the tiny size answer as they did, and as the
    Tor scenario's functions called directly answer."""
    from portbench import check
    from portbench.episodes import episode_seeds
    from shadow_tpu_torch.core.controller import Controller
    seen = {}
    check_all = check.check_all

    def spy(records, *args):
        seen["records"] = records
        return check_all(records, *args)

    monkeypatch.setattr(check, "check_all", spy)
    rc, result = benchcopy.run_inprocess(tiny, cell, seed=7)
    assert rc == 0 and result["correct"] is True, result
    records = seen["records"]
    assert records and records[0]["index"] == 1
    if cell == "tor10k.sweep8":
        assert len(records) >= 2
    for rec in records:
        if rec["index"] in ANSWERS:
            assert _answers(rec) == ANSWERS[rec["index"]], rec["index"]

    bench = benchcopy.bench(tiny)
    w = next(w for w in bench["workloads"] if w["name"] == cell)
    with contextlib.chdir(tiny):
        from portbench import cell as cells
        config = cells.config_file(bench, w["config"])
        traffic = cells.traffic_file(w["traffic"])
        tor = cells.scenario(config)
    first = records[0]
    engine_seed, draw_seed = episode_seeds(7, first["index"])
    stop = int(config["stoptime_s"])
    ctl = Controller(tor.options(config, traffic, seed=engine_seed,
                                 stoptime=stop, device="cpu", chips=1,
                                 control=False),
                     tor.configuration(config, traffic, stop, draw_seed))
    assert ctl.run() == 0
    direct = tor.record(ctl)
    for k in ("chain_done", "tx", "rx"):
        assert (direct[k] == first[k]).all(), k
    assert direct["forwards"] == first["forwards"]
    assert direct["completed"] == first["completed"]


STAR_CONFIG = {"name": "star2k", "scenario": "star", "clients": 2000,
               "server_kibps": 102400, "client_down_kibps": 102400,
               "client_up_kibps": 51200, "shards": 2, "stoptime_s": 30}
STAR_MIX = {"name": "bulk", "mode": "serial", "lanes": 1,
            "down_bytes": 65536, "up_bytes": 1024, "start_s": 2,
            "waves": 8, "step_s": 1}
# one chain's completion moved a tick later in the record
MOVED = '''"""The star scenario with a planted fault in its record."""
import importlib.util
import os

_spec = importlib.util.spec_from_file_location(
    "star", os.path.join(os.path.dirname(__file__), "star.py"))
star = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(star)
KERNELS, PARTS = star.KERNELS, star.PARTS
TINY_CONFIG, TINY_TRAFFIC = star.TINY_CONFIG, star.TINY_TRAFFIC
configuration, options = star.configuration, star.options
warm_stoptime, check = star.warm_stoptime, star.check


def record(ctl):
    rec = star.record(ctl)
    done = rec["chain_done"]
    done[(done >= 0).argmax()] += 1
    return rec
'''


@pytest.fixture(scope="module")
def star(tmp_path_factory):
    """A tiny copy with the star scenario, its reference, a configuration
    at a deployment's size and a mix added, and cut again: (root, the
    bytes of every file that was there before)."""
    root = benchcopy.tiny_copy(str(tmp_path_factory.mktemp("star")))
    pb = os.path.join(root, "portbench")
    before = {}
    for d, _sub, files in os.walk(pb):
        for name in files:
            with open(os.path.join(d, name), "rb") as f:
                before[os.path.join(d, name)] = f.read()
    shutil.copy(os.path.join(HERE, "scenario_star.py"),
                os.path.join(pb, "scenarios", "star.py"))
    shutil.copy(os.path.join(HERE, "star_reference.py"),
                os.path.join(pb, "star_reference.py"))
    with open(os.path.join(pb, "scenarios", "star_moved.py"), "w") as f:
        f.write(MOVED)
    with open(os.path.join(pb, "traffic", "bulk.json"), "w") as f:
        json.dump(STAR_MIX, f)
    bench = benchcopy.bench(root)
    for name, scenario in (("star2k", "star"), ("star2k_moved", "star_moved"),
                           ("star2k_none", "nosuch")):
        with open(os.path.join(pb, "configs", f"{name}.json"), "w") as f:
            json.dump({**STAR_CONFIG, "name": name, "scenario": scenario}, f)
        bench["configs"].append({
            "name": name, "source": "https://example.org/star",
            "file": f"portbench/configs/{name}.json", "reduced": [],
            "why": "a test's deployment"})
        bench["workloads"].append({
            "name": f"{name}.bulk", "config": name, "traffic": "bulk",
            "chips": 1, "why": "a test's cell"})
    # the cut asks each cell's scenario for its own; the one that names
    # no scenario file is added after it
    none = bench["workloads"].pop()
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    benchcopy.cut(root)
    bench["workloads"].append(none)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root, before


def test_star_is_cut_by_its_own_scenario(star):
    root, _before = star
    with open(os.path.join(root, "portbench", "configs", "star2k.json")) as f:
        config = json.load(f)
    with open(os.path.join(root, "portbench", "traffic", "bulk.json")) as f:
        mix = json.load(f)
    sys.path.insert(0, HERE)
    import scenario_star
    assert config == {**STAR_CONFIG, **scenario_star.TINY_CONFIG}
    assert mix == {**STAR_MIX, **scenario_star.TINY_TRAFFIC}


def test_star_added_as_files_is_correct(star):
    root, _before = star
    rc, result, err = benchcopy.run_cli(root, "star2k.bulk")
    assert rc == 0, err[-2000:]
    assert result["correct"] is True and result["failed"] == 0, result
    assert set(result["metrics"]) == {m["name"] for m in benchcopy.bench(
        root)["end_to_end"] if "workloads" not in m}
    assert ("portbench: answers off by kind: chains 0, server 0, clients 0, "
            "forwards 0, exit_code 0") in err


def test_star_control_is_refused(star):
    root, _before = star
    rc, result, err = benchcopy.run_cli(root, "star2k.bulk",
                                        extra=["--control", "1"])
    assert rc == 0, err[-2000:]
    assert result["correct"] is False
    assert result["checks"]["answers_off"]["value"] > 0


def test_star_planted_fault_is_refused(star):
    root, _before = star
    rc, result, err = benchcopy.run_cli(root, "star2k_moved.bulk")
    assert rc == 0, err[-2000:]
    assert result["correct"] is False
    assert result["failed"] == result["attempted"] >= 1
    assert result["checks"]["answers_off"]["value"] == result["attempted"]
    assert "answers off by kind: chains " in err


def test_unknown_scenario_stops_the_run(star):
    root, _before = star
    rc, result, err = benchcopy.run_cli(root, "star2k_none.bulk")
    assert rc != 0 and result is None
    assert "no scenario 'nosuch'" in err
    assert "have star, star_moved, tor" in err


def test_no_file_that_was_there_changed(star):
    root, before = star
    for path, data in before.items():
        with open(path, "rb") as f:
            assert f.read() == data, path
