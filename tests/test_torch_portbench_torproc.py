"""The benchmark's Tor-with-processes cell at a tiny size on the CPU.

An episode of ``torproc1k`` cut to the scenario's tiny size (30 relays,
30 clients, 3 servers, a 6-vertex lossy graph, 40 s) runs through the
harness's own episode path (``portbench/episodes.py``) and its scenario
(``portbench/scenarios/torproc.py``), and is held to
``portbench/reference_torproc.py``: every answer agrees, also when a
relay publishes late and the first clients fetch a consensus without
it; a fault planted in the record is counted in its own kind of answer;
the control (no packet ever dropped) is refused in the hops.  The reference imports
nothing of the program or of JAX, and its Threefry, key derivation,
streams and graph equal the program's.
"""

import copy
import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from portbench import cell  # noqa: E402
from portbench import reference_torproc as ref  # noqa: E402
from portbench.episodes import Experiments  # noqa: E402

CELL = "torproc1k.bootstrap"
SEED = 3_000_000_019


def _parts(control: bool):
    """(scenario, tiny configuration, mix) of the cell."""
    bench = cell.load_benchmark(os.path.join(REPO, "BENCHMARK.json"))
    w = cell.workload(bench, CELL)
    entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    with open(os.path.join(REPO, entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(REPO, "portbench", "traffic",
                           f"{w['traffic']}.json")) as f:
        traffic = json.load(f)
    old = os.getcwd()
    os.chdir(REPO)
    try:
        sc = cell.scenario(config)
    finally:
        os.chdir(old)
    config.update(sc.TINY_CONFIG)
    traffic.update(sc.TINY_TRAFFIC)
    return sc, config, traffic


def _episode(control: bool):
    from shadow_tpu_torch.core.logger import SimLogger, set_logger
    sc, config, traffic = _parts(control)
    exp = Experiments(sc, config, traffic, SEED, "cpu", control=control)
    rec = exp.run_one(1)
    set_logger(SimLogger(level="warning"))
    return sc, config, traffic, rec


@pytest.fixture(scope="module")
def sound():
    return _episode(False)


@pytest.fixture(scope="module")
def control():
    return _episode(True)


def _check(ep, rec=None):
    sc, config, traffic, rec0 = ep
    off, _out = sc.check(rec if rec is not None else rec0, config, traffic,
                         "cpu")
    return off


def test_sound_episode_agrees_with_the_reference(sound):
    sc, config, traffic, rec = sound
    off, out = sc.check(rec, config, traffic, "cpu")
    assert off == {k: 0 for k in sc.PARTS}
    # the episode did the work the check holds it to
    assert rec["rc"] == 0 and len(rec["clients"]) == config["clients"]
    assert (rec["chain_done"] >= 0).all()
    assert len(rec["consensus"]) == config["relays"]
    assert rec["lanes_hopped"] == len(rec["hop_uid"]) + rec["hop_pending"]
    assert int((~rec["hop_keep"]).sum()) == rec["packets_dropped"] > 0
    assert out.granule == rec["granule"] >= 1


def _late_lane(rec):
    i = int(np.flatnonzero(rec["hop_keep"])[7])
    rec["hop_deliver"][i] += 1


def _flip_drop(rec):
    rec["hop_keep"][11] = not rec["hop_keep"][11]


def _late_chain(rec):
    c = int(np.flatnonzero(rec["chain_done"] >= 0)[5])
    rec["chain_done"][c] += 1


def _swap_relay(rec):
    app = rec["clients"]["torclient4"]
    used = set(app["path"])
    other = next(n for n, _p, _w in rec["consensus"] if n not in used)
    app["path"][1] = other


def _short_stream(rec):
    rec["clients"]["torclient9"]["streams_ok"] -= 1


def _consensus_weight(rec):
    rec["clients"]["torclient2"]["consensus_weight"] += 1


FAULTS = {"lane_1ns_late": (_late_lane, "hops"),
          "consensus_weight_off": (_consensus_weight, "paths"),
          "drop_flipped": (_flip_drop, "hops"),
          "chain_a_tick_late": (_late_chain, "chains"),
          "relay_swapped": (_swap_relay, "paths"),
          "streams_ok_less_one": (_short_stream, "apps")}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_counted_in_its_own_part(sound, fault):
    plant, part = FAULTS[fault]
    rec = copy.deepcopy(sound[3])
    plant(rec)
    off = _check(sound, rec)
    assert off[part] == 1, off
    assert sum(v for k, v in off.items() if k != part) == 0, off


def test_a_late_relay_is_followed_and_agrees(monkeypatch):
    """A relay whose descriptor reaches the authority at 20 s, after the
    first clients fetched: they draw over the consensus they hold, the
    plane's chains follow their paths, and the reference, which takes
    what each client fetched from the authority's registrations, agrees
    with every answer."""
    sc, config, traffic = _parts(False)
    exp = Experiments(sc, config, traffic, SEED, "cpu", control=False)
    episode = exp.episode

    def late(index, stoptime=None):
        cfg, opts, engine_seed, draw_seed = episode(index, stoptime)
        relay = next(h for h in cfg.hosts if h.id == "relay7")
        relay.processes[0].start_time_sec = 20.0
        return cfg, opts, engine_seed, draw_seed

    monkeypatch.setattr(exp, "episode", late)
    rec = exp.run_one(1)
    from shadow_tpu_torch.core.logger import SimLogger, set_logger
    set_logger(SimLogger(level="warning"))
    off, _out = sc.check(rec, config, traffic, "cpu")
    assert off == {k: 0 for k in sc.PARTS}
    held = [c["consensus_relays"] for c in rec["clients"].values()]
    assert min(held) == config["relays"] - 1 and max(held) == config["relays"]
    assert rec["registered"][-1][0] == "relay7" and rec["reroutes"] > 0


def test_readers_of_the_cell(sound):
    """The per-layer readers the cell is listed on, over the sound
    episode: the policy's wait and host time from the policy's own keys,
    the plane's wait from the plane's, nothing from a trace the CPU run
    does not have."""
    sc, config, traffic, rec = sound
    bench = cell.load_benchmark(os.path.join(REPO, "BENCHMARK.json"))
    listed = sorted(m["name"] for m in bench["per_layer"]
                    if CELL in m.get("workloads", []))
    assert listed == ["episode_setup_s", "hop_flush_ns", "hop_roofline",
                      "hop_wait_us", "idle_share", "plane_wait_ms"]
    ctx = {"episodes": [rec], "traffic": traffic, "trace": None}
    got = {name: cell.reader(name)(ctx) for name in listed}
    assert got["hop_roofline"] is None and got["idle_share"] is None
    assert rec["hop_calls"] > 0 and rec["dispatches"] > 0
    assert got["hop_wait_us"] == rec["hop_device_ns"] / rec["hop_calls"] / 1e3
    assert got["hop_flush_ns"] == rec["host_flush_ns"] / rec["lanes_hopped"]
    assert got["plane_wait_ms"] == rec["device_ns"] / rec["dispatches"] / 1e6
    assert got["episode_setup_s"] == rec["t_loop"] - rec["t_start"] > 0


def test_control_is_refused_in_the_hops(control):
    sc, config, traffic, rec = control
    off = _check(control)
    # no lane dropped under the control, each the reference drops is off
    assert rec["packets_dropped"] == 0
    assert off["hops"] > 0, off


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); "
            "import portbench.reference_torproc; "
            "bad = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'shadow_tpu', 'shadow_tpu_torch'}); "
            "print(','.join(bad))" % REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd="/")
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def test_threefry_equals_the_programs():
    import torch
    from shadow_tpu_torch.core import rng
    g = np.random.default_rng(5)
    k0, k1, c0, c1 = (g.integers(0, 2 ** 32, 1000, dtype=np.uint64)
                      for _ in range(4))
    want0, want1 = rng.threefry2x32_np(k0.astype(np.uint32),
                                       k1.astype(np.uint32),
                                       c0.astype(np.uint32),
                                       c1.astype(np.uint32))
    got = np.array([ref.threefry_int(*map(int, x))
                    for x in zip(k0, k1, c0, c1)], dtype=np.uint64)
    assert (got[:, 0] == want0).all() and (got[:, 1] == want1).all()
    # the lanes' torch version, one key a call as the hop draws it
    for i in range(0, 1000, 97):
        t0, t1 = ref.threefry_torch(
            int(k0[i]), int(k1[i]),
            torch.as_tensor(c0.astype(np.int64)),
            torch.as_tensor(c1.astype(np.int64)))
        w0, w1 = rng.threefry2x32_np(np.uint32(k0[i]), np.uint32(k1[i]),
                                     c0.astype(np.uint32),
                                     c1.astype(np.uint32))
        assert (t0.numpy() == w0).all() and (t1.numpy() == w1).all()


def test_streams_equal_the_programs():
    from shadow_tpu_torch.core import rng
    g = np.random.default_rng(7)
    for seed in g.integers(0, 2 ** 62, 1000, dtype=np.int64).tolist():
        host = seed % 5000 + 1
        key = rng.derive(rng.derive(seed, "root"), "host", host)
        assert ref.derive(ref.derive(seed, "root"), "host", host) == key
        mine = ref.Stream(ref.derive(key, "device-circuit"))
        theirs = rng.RandomSource(key).spawn("device-circuit")
        bound = seed % 1_000_003 + 1
        assert mine.next_int(bound) == theirs.next_int(bound)
        assert mine.next_u64() == theirs.next_u64()


def test_paths_equal_the_programs_draw():
    """The weighted draw over a consensus, against the Tor app's own."""
    from shadow_tpu_torch.apps.tor import pick_weighted
    from shadow_tpu_torch.core.rng import RandomSource
    g = np.random.default_rng(11)
    cons = sorted((f"relay{i}", 9001, int(w))
                  for i, w in enumerate(g.integers(50, 1000, 200)))
    for key in g.integers(0, 2 ** 62, 300, dtype=np.int64).tolist():
        want = [n for n, _p in pick_weighted(RandomSource(key), cons)]
        assert ref.pick(ref.Stream(key), cons) == want


@pytest.mark.parametrize("seed", [7, 3_000_000_019])
def test_graph_equals_the_programs_paths(seed):
    """Latency and reliability between every pair of vertices (a host
    placed on each by its address) as ``routing/topology.py`` computes
    them on the generator's graph."""
    from shadow_tpu_torch.routing.topology import Topology
    from shadow_tpu_torch.tools.synth_topology import lossy_complete_graphml
    n = 9
    topo = Topology.from_graphml(lossy_complete_graphml(n, seed))
    for v in range(n):
        topo.attach_host(v + 1, ip_hint=f"10.{v // 250}.{v % 250}.1")
    topo.finalize()
    got = ref.graph(n, seed)
    order = np.asarray(topo.attached_vertices)
    assert (got.latency_ns[np.ix_(order, order)] == topo.latency_ns).all()
    assert (got.reliability[np.ix_(order, order)]
            == topo.reliability).all()
