"""A cell, a configuration, a traffic mix and a metric added as files and
entries alone, in a temporary copy of the benchmark: the harness finds
each by name, and no file that was there is edited."""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import benchcopy  # noqa: E402


def test_a_cell_added_as_files_runs(tmp_path):
    root = benchcopy.tiny_copy(str(tmp_path))
    pb = os.path.join(root, "portbench")
    before = {}
    for d, _sub, files in os.walk(pb):
        for name in files:
            path = os.path.join(d, name)
            with open(path, "rb") as f:
                before[path] = f.read()
    # a new deployment in a shape no preset of the program derives: 40
    # relays and 5 servers of 300 hosts, slower relays, a shorter loop;
    # a new mix: no upload, bigger downloads in two waves
    with open(os.path.join(pb, "configs", "tor10k.json")) as f:
        cfg = json.load(f)
    cfg.update(name="tor250", hosts=300, relays=40, servers=5, clients=255,
               relay_kibps=51200, server_kibps=204800, vertex_latency_ms=5)
    with open(os.path.join(pb, "configs", "tor250.json"), "w") as f:
        json.dump(cfg, f)
    mix = {"name": "bulk", "mode": "serial", "lanes": 1,
           "down_bytes": 262144, "up_bytes": 0, "start_s": 2, "waves": 2,
           "step_s": 1}
    with open(os.path.join(pb, "traffic", "bulk.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(pb, "metrics", "episodes_done.py"), "w") as f:
        f.write("def read(ctx):\n    return len(ctx['episodes'])\n")
    bench = benchcopy.bench(root)
    bench["configs"].append({
        "name": "tor250", "source": "https://example.org/tor250",
        "file": "portbench/configs/tor250.json", "reduced": ["stoptime_s"],
        "why": "a test's deployment"})
    bench["workloads"].append({
        "name": "tor250.bulk", "config": "tor250", "traffic": "bulk",
        "chips": 1, "why": "a test's cell"})
    bench["end_to_end"].append({
        "name": "episodes_done", "unit": "count", "better": "higher",
        "bound": 0.25, "source": "host_clock",
        "workloads": ["tor250.bulk"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)

    rc, result, err = benchcopy.run_cli(root, "tor250.bulk")
    assert rc == 0, err[-2000:]
    assert result["correct"] is True, result
    assert result["metrics"]["episodes_done"]["value"] == result["attempted"]
    assert "host_peak_gib" in result["metrics"]
    # the cells that were there do not report the new metric
    rc, result, err = benchcopy.run_cli(root, "tor100k.web")
    assert rc == 0 and "episodes_done" not in result["metrics"], err[-2000:]
    for path, data in before.items():
        with open(path, "rb") as f:
            assert f.read() == data, path
