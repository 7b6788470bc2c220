"""BENCHMARK.json against the benchmark's contract: its keys, its names
and units in the allowed characters, every piece a cell names present as
a file of its own, and the length of a full check within its limit."""

import json
import os
import re
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import benchcopy  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return benchcopy.bench(benchcopy.REPO)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(benchcopy.REPO,
                                        "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(bench["command"]) <= 32
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(benchcopy.REPO, p))
    for word in bench["command"]:
        assert 1 <= len(word) <= 200 and "\n" not in word and "\t" not in word
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51


def test_names_and_units(bench):
    names = []
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in bench[key]:
            assert NAME.match(e["name"]), e["name"]
            names.append((key, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
                assert e["source"] in SOURCES
            for word in ("why", "layer", "source"):
                if word in e and key != "end_to_end":
                    assert 1 <= len(e[word]) <= 200
                    assert "\n" not in e[word] and "\t" not in e[word]
    for key in ("configs", "workloads"):
        got = [n for k, n in names if k == key]
        assert len(got) == len(set(got))
    metrics = [n for k, n in names if k in ("end_to_end", "per_layer")]
    assert len(metrics) == len(set(metrics))
    for c in bench["configs"]:
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])


def test_entries_have_only_their_keys(bench):
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source",
                           "workloads"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}}
    for key, allowed in keys.items():
        for e in bench[key]:
            assert set(e) <= allowed, (key, e["name"], set(e) - allowed)


def test_every_piece_is_a_file_found_by_name(bench):
    root = benchcopy.REPO
    files = set()
    for c in bench["configs"]:
        path = os.path.join(root, c["file"])
        assert c["file"].startswith(bench["paths"][0] + "/")
        assert os.path.isfile(path) and path not in files
        files.add(path)
        with open(path) as f:
            data = json.load(f)
        assert sorted(data["reduced"]) == sorted(c["reduced"])
    for w in bench["workloads"]:
        assert w["chips"] == 1
        assert os.path.isfile(os.path.join(
            root, "portbench", "traffic", f"{w['traffic']}.json"))
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert os.path.isfile(os.path.join(root, "portbench", "metrics",
                                           f"{m['name']}.py"))


def test_bounds_and_moves(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in bench["workloads"]}
    reported = {m["name"]: set(m.get("workloads", cells))
                for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        # each cell a per-layer metric lists reports the metric it moves
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= reported[m["moves"]]
    for w in cells:
        assert any(w in m.get("workloads", cells) for m in bench["per_layer"])
        assert sum(w in r for r in reported.values()) >= 2   # setup_s + one


def test_a_full_check_fits(bench):
    """2 + 14 runs a cell, each allowed run_seconds + 60 s, 2 x 90 s a cell
    to compile and 1,200 s spare: within 43,200 s with 24 cells."""
    rs = bench["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200
