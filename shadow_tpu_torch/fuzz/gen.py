"""Seeded scenario generation: one integer seed -> a self-contained spec.

A *spec* is a JSON-able dict — the unit the fuzzer runs, shrinks, and
checks into ``fuzz/corpus/``.  Everything derives from the seed through
``numpy.random.default_rng``, so the same seed always yields the same
spec, and ``build_config(spec)`` rebuilds the identical ``Configuration``
in any process (the scale generators' override fidelity — a rejected
unknown kwarg, scale/genscen.py — is what makes the replay trustworthy).

Spec shape::

    {"version": 1, "seed": 7,
     "family": "star|tor|cdn|swarm|phold|appmix",
     "params": {...},            # genscen builder kwargs (flow families)
     "apps": [{host-group}...],  # plugin app groups (appmix / ride-alongs)
     "topology": null | {"vertices": V, "seed": s,
                          "max_latency_ms": L, "loss_pct": p},
     "stoptime": 24,
     "modes": [{mode}...],       # the CLI matrix this spec runs under
     "fault_inject": null | {...}}   # see runner.apply_fault

The mode matrix is derived from the family, not drawn, so every axis the
acceptance gate names (device-vs-numpy, K=1-vs-K=8, table-on/off, mesh)
is engaged across any handful of seeds.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from . import SPEC_VERSION

FLOW_FAMILIES = ("star", "tor", "cdn", "swarm")
ALL_FAMILIES = FLOW_FAMILIES + ("phold", "appmix")


# ---------------------------------------------------------------------------
# topology
# ---------------------------------------------------------------------------

def make_graphml(topo: Dict) -> str:
    """A complete graph of ``vertices`` vertices (+ self loops) with seeded
    latency/loss draws — small enough to inline as ``topology_text``,
    varied enough that hop latencies and the derived lookahead differ per
    seed.  Deterministic: same dict, byte-identical text."""
    v = int(topo["vertices"])
    rng = np.random.default_rng(int(topo["seed"]))
    max_lat = float(topo.get("max_latency_ms", 60.0))
    loss = float(topo.get("loss_pct", 0.0)) / 100.0
    lines = [
        '<?xml version="1.0" encoding="UTF-8"?>',
        '<graphml xmlns="http://graphml.graphdrawing.org/xmlns">',
        '  <key id="d5" for="edge" attr.name="latency" attr.type="double"/>',
        '  <key id="d6" for="edge" attr.name="packetloss"'
        ' attr.type="double"/>',
        '  <graph edgedefault="undirected">',
    ]
    for i in range(v):
        lines.append(f'    <node id="v{i}" />')
    for i in range(v):
        for j in range(i, v):
            lat = 1.0 if i == j else round(
                float(rng.uniform(2.0, max_lat)), 3)
            pl = 0.0 if i == j else round(float(rng.uniform(0.0, loss)), 5)
            lines.append(
                f'    <edge source="v{i}" target="v{j}">'
                f'<data key="d5">{lat}</data>'
                f'<data key="d6">{pl}</data></edge>')
    lines.append('  </graph>')
    lines.append('</graphml>')
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# mode matrices
# ---------------------------------------------------------------------------

def _mode(name: str, **kw) -> Dict:
    m = {"name": name, "policy": "global", "workers": 0, "processes": 0,
         "device_plane": "device", "superwindow_rounds": 8,
         "tpu_devices": 1, "host_table": "on", "dataplane": "python",
         "device_plane_sync": False, "exchange_mode": "auto",
         "device_autotune": "on", "events_comparable": True}
    m.update(kw)
    return m


def flow_modes(rng) -> List[Dict]:
    """The flow-family matrix: device/numpy twins, K=1-vs-K=8, repeat-run
    stability, and the sharded mesh (skipped gracefully under <2
    devices) — with the ``--exchange-mode`` axis forced each way on the
    SAME drawn mesh size (ISSUE 15), so the cross-mode digest-parity
    oracle covers the cost-model-driven scheduler decision for free:
    whatever auto picks, the fused and multi-leg-ppermute kernels must
    land the identical digest."""
    d = int(rng.integers(2, 5))
    modes = [
        _mode("base"),
        _mode("base-repeat", repeat_of="base"),
        _mode("numpy", device_plane="numpy"),
        _mode("k1", superwindow_rounds=1),
        _mode("mesh", tpu_devices=d),
        _mode("mesh-fused", tpu_devices=d, exchange_mode="fused"),
        _mode("mesh-ppermute", tpu_devices=d, exchange_mode="ppermute"),
    ]
    if rng.integers(0, 2):
        modes.append(_mode("sync", device_plane_sync=True))
    # the auto-tuner axis (ISSUE 16): every mode above runs with the
    # tuner's default-on behavior; this leg forces the hand defaults, so
    # the cross-mode digest oracle pins tuned-vs-untuned parity for free.
    # Appended AFTER all rng draws — the draw stream (and thus every
    # historical seed's scenario) is unchanged.
    modes.append(_mode("autotune-off", device_autotune="off"))
    # recovery axes (ISSUE 17), appended after all draws for the same
    # reason (the mesh-lost leg reuses the d drawn above — no new draw):
    # checkpoint+--resume faces the digest-parity oracle, and the
    # self-healing drills (mid-run device loss re-shard, demote ->
    # probation -> re-promotion) must land the SAME digest as the
    # fault-free base — recovery is a detour, never a different simulation
    modes.append(_mode("resume", resume=True))
    modes.append(_mode("mesh-lost", tpu_devices=d,
                       engine_fault="device-lost:3"))
    modes.append(_mode("demote-repromote",
                       engine_fault="demote-repromote:2",
                       repromote_after=3))
    return modes


def app_modes(rng, n_hosts: int) -> List[Dict]:
    """The plugin-app matrix: HostTable on/off, the native-vs-python data
    plane differential (table off only — the C plane declines while
    unmaterialized rows exist), a threaded scheduler, and ``--processes``
    sharding."""
    modes = [
        _mode("base"),
        _mode("base-repeat", repeat_of="base"),
        _mode("table-off", host_table="off"),
        _mode("native-auto", host_table="off", dataplane="auto"),
        _mode("threaded", host_table="off", policy="host", workers=2,
              events_comparable=False),
    ]
    if n_hosts >= 4 and rng.integers(0, 2):
        modes.append(_mode("procs", processes=2, events_comparable=False))
    # recovery axes (ISSUE 17), appended AFTER all rng draws so every
    # historical seed's scenario replays unchanged: checkpoint+--resume
    # parity, and — when the host count supports sharding — a SIGKILL'd
    # shard resurrected mid-run that must still land the base digest.
    modes.append(_mode("resume", resume=True))
    if n_hosts >= 4:
        modes.append(_mode("procs-resurrect", processes=2,
                           events_comparable=False,
                           engine_fault="shard-exit-resurrect:1:2",
                           max_resurrections=3))
    # the spec-defined CC family (ISSUE 19), appended AFTER all rng draws
    # so every historical seed's scenario replays unchanged.  bbrx takes a
    # legitimately different trajectory from the reno-default legs, so the
    # pair carries its own digest_group: the parity/events oracles compare
    # bbrx-vs-bbrx (the generated logic must land one digest across the
    # table on/off axis), never bbrx-vs-base.
    modes.append(_mode("bbrx", tcpcc="bbrx", digest_group="bbrx"))
    modes.append(_mode("bbrx-table-off", tcpcc="bbrx", host_table="off",
                       digest_group="bbrx"))
    return modes


# ---------------------------------------------------------------------------
# family draws
# ---------------------------------------------------------------------------

def _draw_flow_params(family: str, rng) -> Dict:
    stagger = int(rng.integers(1, 4))
    common = dict(stagger_waves=stagger,
                  stagger_step_sec=float(rng.integers(1, 3)))
    if family == "star":
        return dict(common, n_clients=int(rng.integers(12, 70)),
                    down_bytes=int(rng.integers(8, 65)) * 1024,
                    up_bytes=int(rng.integers(0, 3)) * 1024)
    if family == "tor":
        return dict(common, n_hosts=int(rng.integers(40, 130)),
                    down_bytes=int(rng.integers(8, 49)) * 1024,
                    up_bytes=int(rng.integers(1, 3)) * 1024,
                    seed=int(rng.integers(1, 1 << 30)))
    if family == "cdn":
        return dict(common, n_clients=int(rng.integers(20, 90)),
                    n_origins=int(rng.integers(2, 5)),
                    down_bytes=int(rng.integers(16, 129)) * 1024,
                    up_bytes=int(rng.integers(0, 2)) * 1024,
                    seed=int(rng.integers(1, 1 << 30)))
    if family == "swarm":
        return dict(common, n_peers=int(rng.integers(16, 60)),
                    pieces=int(rng.integers(1, 4)),
                    piece_bytes=int(rng.integers(8, 49)) * 1024,
                    seed=int(rng.integers(1, 1 << 30)))
    raise ValueError(f"not a flow family: {family}")


def _draw_apps(rng, suffix: str = "") -> List[Dict]:
    """A coherent plugin-app set from the registry: an echo pair, a tgen
    star, or a phold group (the classic PDES event stress)."""
    kind = ("echo", "tgen", "phold")[int(rng.integers(0, 3))]
    if kind == "phold" and suffix:
        # the phold app's peer naming hardcodes the bare "phold" group id,
        # so a second phold set can neither rename nor coexist (two groups
        # claiming "phold1" reject at setup — fuzz-found at seed 66);
        # remap ONLY this case so every other seed's draw stream is
        # untouched
        kind = "echo"
    bw = int(rng.integers(10, 101)) * 1024
    if kind == "echo":
        proto = ("udp", "tcp")[int(rng.integers(0, 2))]
        port = 8000 + int(rng.integers(0, 100))
        n_msg = int(rng.integers(3, 9))
        size = int(rng.integers(1, 5)) * 512
        return [
            {"id": f"esrv{suffix}", "quantity": 1, "bw": bw,
             "plugin": "echo", "start": 1.0,
             "args": f"{proto} server {port}"},
            # a quantity-1 host keeps its bare id as its name
            {"id": f"ecli{suffix}", "quantity": int(rng.integers(1, 4)),
             "bw": bw, "plugin": "echo", "start": 2.0,
             "args": f"{proto} client esrv{suffix} {port} {n_msg} {size}"},
        ]
    if kind == "tgen":
        port = 80
        size = int(rng.integers(8, 200)) * 1024
        return [
            {"id": f"tsrv{suffix}", "quantity": 1, "bw": 4 * bw,
             "plugin": "tgen", "start": 1.0, "args": f"server {port}"},
            {"id": f"tcli{suffix}", "quantity": int(rng.integers(1, 5)),
             "bw": bw, "plugin": "tgen", "start": 2.0,
             "args": f"client tsrv{suffix} {port} 1024:{size}"},
        ]
    n = int(rng.integers(4, 13))
    return [
        {"id": "phold", "quantity": n, "bw": bw, "plugin": "phold",
         "start": 1.0,
         "args": f"{n} {int(rng.integers(1, 3))} 9000"},
    ]


# ---------------------------------------------------------------------------
# spec drawing + config build
# ---------------------------------------------------------------------------

def draw_spec(seed: int) -> Dict:
    """One integer seed -> a complete, self-contained scenario spec."""
    rng = np.random.default_rng(seed)
    family = ALL_FAMILIES[int(rng.integers(0, len(ALL_FAMILIES)))]
    stoptime = int(rng.integers(14, 27))
    spec: Dict = {"version": SPEC_VERSION, "seed": int(seed),
                  "family": family, "params": {}, "apps": [],
                  "topology": None, "stoptime": stoptime,
                  "engine_seed": int(rng.integers(1, 1000)),
                  "fault_inject": None}
    if family in FLOW_FAMILIES:
        spec["params"] = _draw_flow_params(family, rng)
        # a ride-along plugin pair exercises mixed table promotion
        # (quiet flow rows + materialized app hosts in one run)
        if rng.integers(0, 100) < 30:
            spec["apps"] = _draw_apps(rng, suffix="x")
        loss = 0.0          # flow chains model lossless bulk transfer
        spec["modes"] = flow_modes(rng)
    elif family == "phold":
        spec["params"] = dict(n_hosts=int(rng.integers(6, 25)),
                              msgs_in_flight=int(rng.integers(1, 3)),
                              bw_kibps=int(rng.integers(10, 101)) * 1024)
        loss = float(rng.integers(0, 3)) / 2.0
        spec["modes"] = app_modes(rng, spec["params"]["n_hosts"])
    else:
        spec["apps"] = _draw_apps(rng)
        if rng.integers(0, 2):
            spec["apps"] += _draw_apps(rng, suffix="b")
        loss = float(rng.integers(0, 3)) / 2.0
        n_hosts = sum(a["quantity"] for a in spec["apps"])
        spec["modes"] = app_modes(rng, n_hosts)
    if rng.integers(0, 2):
        spec["topology"] = {"vertices": int(rng.integers(2, 6)),
                            "seed": int(rng.integers(1, 1 << 30)),
                            "max_latency_ms": float(rng.integers(10, 81)),
                            "loss_pct": loss}
    return spec


def build_config(spec: Dict):
    """Rebuild the spec's ``Configuration`` (deterministic, any
    process)."""
    from ..core.configuration import (Configuration, HostConfig,
                                      ProcessConfig)
    from ..scale import genscen

    fam = spec["family"]
    if fam == "appmix":
        cfg = Configuration(stop_time_sec=spec["stoptime"])
    elif fam == "phold":
        cfg = genscen.build("phold", stoptime=spec["stoptime"],
                            **spec["params"])
    else:
        cfg = genscen.build(fam, stoptime=spec["stoptime"],
                            **spec["params"])
    cfg.stop_time_sec = spec["stoptime"]
    for app in spec.get("apps", []):
        hc = HostConfig(id=app["id"], quantity=int(app["quantity"]),
                        bandwidth_down_kibps=int(app["bw"]),
                        bandwidth_up_kibps=int(app["bw"]))
        hc.processes.append(ProcessConfig(
            plugin=f"python:{app['plugin']}",
            start_time_sec=float(app["start"]),
            arguments=app["args"]))
        cfg.hosts.append(hc)
    topo = spec.get("topology")
    if topo:
        cfg.topology_text = make_graphml(topo)
    return cfg


def spec_digest(spec: Dict) -> str:
    """Content digest of a spec (corpus dedupe key).  Built on the
    CONFIG digest — which covers FlowConfig fields and app argv — plus
    the mode matrix and fault spec, so two specs differing only in flow
    params or modes never collide."""
    import hashlib
    import json

    from ..scale.genscen import config_digest
    blob = json.dumps({"config": config_digest(build_config(spec)),
                       "modes": spec["modes"],
                       "fault": spec.get("fault_inject")},
                      sort_keys=True, separators=(",", ":")).encode()
    return hashlib.sha256(blob).hexdigest()
