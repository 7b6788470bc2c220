#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``shadow_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--out results.json]

Phases, each printed as it runs; any failure exits non-zero and prints no
result line:

1. card: name and power limit (nvidia-smi), torch and CUDA versions;
2. build: the main path's CUDA kernel from ``shadow_tpu_torch/ops/csrc``
   with nvcc for sm_90a;
3. kernel vs plain version: ``packet_hop`` against
   ``packet_hop_packed_reference`` on the card, bit-exact on every lane
   (padding included), and against the numpy cipher on the valid lanes, at
   B in {256, 512, 4096, 65536} with A = 183;
4. times (CUDA events; graph replay for the kernel alone) at B in
   {256, 512, 8192}, beside the least time the card could take;
5. the slice: ``tor_network(1000)`` (2,050 hosts) on a seeded 183-vertex
   complete lossy GraphML, stoptime 20, under the ``tpu`` policy on cuda,
   then under ``global``; state digest, events, rounds and drops must agree
   with each other and with the JAX package's run of the same config;
6. the trace: the ``tpu`` run once more under ``torch.profiler``, for the
   card's busy time (the union of its kernel and copy intervals), its idle
   share and the kernel's time inside real rounds.  The trace must hold one
   ``packet_hop`` kernel per counted launch.

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX or of the JAX
package.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# The tor1k slice: tools/workloads.tor_network(1000, stoptime=20) with
# tools/synth_topology.lossy_complete_graphml(183, 7) as its topology,
# Options(seed=1).  EXPECTED was made with the JAX package on the CPU
# (shadow_tpu's Controller under --scheduler-policy=tpu, dataplane python,
# one XLA CPU device) for this same config; tests/test_torch_tor1k.py
# reproduces it (pytest -m slow) and holds the port's CPU run to it.
TOR1K = {"n_relays": 1000, "stoptime": 20, "graph_vertices": 183,
         "graph_seed": 7, "seed": 1}
EXPECTED = {
    "digest": "3a394aade3923576eeb5eaf75ea0df00"
              "74ed9d44fc77124564fcb3309050807f",
    "events": 763927,
    "rounds": 7081,
    "drops": 817,
    "device_calls": 7006,
}

A = 183
DROP_KEY = 0xC0FFEE123456789A
BOOTSTRAP_END = 5_000_000_000
CHECK_SIZES = (256, 512, 4096, 65536)
TIME_SIZES = (256, 512, 8192)
MAIN_B = 512          # the tor1k run's larger bucket (buckets 256 and 512)

# H100 SXM peaks (NVIDIA's data sheet, at the full 700 W): HBM bytes/s,
# and 32-bit scalar ALU operations/s (the fp32 non-tensor rate: the hop's
# work is 32-bit integer ops outside the tensor cores)
HBM_BYTES_PER_S = 3.35e12
ALU32_OPS_PER_S = 67e12
# 32-bit operations per lane: threefry 20 rounds x (add, 2 shifts, or,
# xor) + 5 key injections x 3 adds + key-schedule xors + input adds
# (~117), unpack, clamps, compares and the max (~15)
OPS_PER_LANE = 132


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", flush=True)
    sys.exit(1)


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def card() -> str:
    import torch
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    line = out.stdout.strip().splitlines()[0]
    print(f"card: {line}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}", flush=True)
    return line


def build() -> None:
    from shadow_tpu_torch.ops import _build
    res = _build.build()
    print(f"built packet_hop in {res['seconds']:.2f} s")
    for ln in res["log"].splitlines():
        if "registers" in ln or "spill" in ln:
            print(f"  {ln.strip()}")


def make_inputs(b: int, seed: int, device):
    """A = 183 matrices (reliability exactly 1.0, 0.0 and in between) and a
    [1+b, 3] batch with padding (n < b), send times on both sides of the
    bootstrap end, uids with the top bit set, and a barrier inside the
    delivery range so some lanes clamp."""
    import numpy as np
    import torch
    from shadow_tpu_torch.ops.round_step import PacketHopKernel
    rng = np.random.default_rng(seed)
    lat = rng.integers(1_000_000, 150_000_000, size=(A, A), dtype=np.int64)
    rel = rng.random((A, A)).astype(np.float32)
    pick = rng.random((A, A))
    rel[pick < 0.3] = np.float32(1.0)
    rel[(pick >= 0.3) & (pick < 0.4)] = np.float32(0.0)
    n = b - b // 8
    src = rng.integers(0, A, size=n, dtype=np.int32)
    dst = rng.integers(0, A, size=n, dtype=np.int32)
    uids = rng.integers(0, 2 ** 64, size=n, dtype=np.uint64)
    times = rng.integers(BOOTSTRAP_END // 2, 2 * BOOTSTRAP_END, size=n,
                         dtype=np.int64)
    barrier = int(np.median(times)) + 50_000_000
    kern = PacketHopKernel.from_arrays(lat, rel, DROP_KEY, BOOTSTRAP_END,
                                       device)
    packed = torch.from_numpy(kern._pack(src, dst, uids, times, b, barrier))
    return kern, packed.to(device), (src, dst, uids, times, barrier)


def check_kernel() -> int:
    """Returns the largest |kernel - plain version| over every output lane
    (deliver ns and keep as 0/1) of every size checked."""
    import numpy as np
    import torch
    from shadow_tpu_torch.ops import round_step as rs
    dev = torch.device("cuda", 0)
    max_err = 0
    for b in CHECK_SIZES:
        kern, packed, cols = make_inputs(b, seed=b, device=dev)
        args = (kern.latency, kern.reliability, packed, kern.key_lo,
                kern.key_hi, kern.bootstrap_end_ns)
        before = rs.packet_hop_packed.launches
        d, k = rs.packet_hop_packed(*args)
        if rs.packet_hop_packed.launches != before + 1:
            fail("packet_hop wrapper did not count its launch")
        rd, rk = rs.packet_hop_packed_reference(*args)
        torch.cuda.synchronize()
        n = len(cols[0])
        d_np, k_np = d.cpu().numpy(), k.cpu().numpy()
        err = max(int(np.abs(d_np - rd.cpu().numpy()).max()),
                  int((k != rk).sum().item() > 0))
        max_err = max(max_err, err)
        if err or not (torch.equal(d, rd) and torch.equal(k, rk)):
            fail(f"packet_hop disagrees with its plain version at B={b} "
                 f"(max |deliver diff| {err}, keep mismatches "
                 f"{int((k != rk).sum())})")
        nd, nk = kern._step_numpy(*cols)
        if not (np.array_equal(d_np[:n], nd) and np.array_equal(k_np[:n], nk)):
            fail(f"packet_hop disagrees with the numpy cipher at B={b}")
        if k_np[n:].any():
            fail(f"packet_hop kept a padding lane at B={b}")
        # the full launch path: pinned upload, own stream, pinned readback
        sd, sk = kern.step(*cols)
        if not (np.array_equal(sd, nd) and np.array_equal(sk, nk)):
            fail(f"PacketHopKernel.step disagrees at B={b}")
        print(f"B={b:6d} n={n:6d}: kernel == plain version bit-exact "
              f"(max_abs_err {err}), kept {int(k_np.sum())}/{n}, clamped "
              f"{int((d_np[:n] == cols[4]).sum())}", flush=True)
    return max_err


def bound(b: int, packed_cpu) -> dict:
    """Least time for one step on this batch: bytes each input read once
    (packed rows, the distinct latency/reliability entries gathered) and
    each output written once, over HBM; 32-bit ops over the ALU peak."""
    import numpy as np
    w0 = packed_cpu[1:, 0].numpy()
    pairs = np.unique(w0).size
    nbytes = (b + 1) * 3 * 8 + pairs * (8 + 4) + b * (8 + 1)
    ops = b * OPS_PER_LANE
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ALU32_OPS_PER_S * 1e3
    return {"bytes": nbytes, "ops": ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def time_kernel() -> dict:
    import torch
    from shadow_tpu_torch.ops import round_step as rs
    dev = torch.device("cuda", 0)
    rows = {}
    for b in TIME_SIZES:
        kern, packed, cols = make_inputs(b, seed=1000 + b, device=dev)
        args = (kern.latency, kern.reliability, packed, kern.key_lo,
                kern.key_hi, kern.bootstrap_end_ns)
        # kernel alone: 20 launches captured in a CUDA graph, replayed, so
        # the host's per-call cost does not hide the device time
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                rs.packet_hop_packed(*args)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        per_graph = 20
        with torch.cuda.graph(graph):
            for _ in range(per_graph):
                rs.packet_hop_packed(*args)
        graph.replay()
        torch.cuda.synchronize()
        reps = 50
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            graph.replay()
        e1.record()
        torch.cuda.synchronize()
        kernel_ms = e0.elapsed_time(e1) / (reps * per_graph)
        # the wrapper launched back to back from Python (host-bound)
        e0.record()
        for _ in range(200):
            rs.packet_hop_packed(*args)
        e1.record()
        torch.cuda.synchronize()
        wrapper_ms = e0.elapsed_time(e1) / 200
        # plain version on the card, same inputs
        for _ in range(3):
            rs.packet_hop_packed_reference(*args)
        e0.record()
        for _ in range(50):
            rs.packet_hop_packed_reference(*args)
        e1.record()
        torch.cuda.synchronize()
        plain_ms = e0.elapsed_time(e1) / 50
        # what a round pays on the main path: pack into pinned memory,
        # upload, kernel, read back, wait (host clock, median of 200)
        for _ in range(10):
            kern.launch(*cols).wait()
        trips = []
        for _ in range(200):
            t0 = time.perf_counter()
            kern.launch(*cols).wait()
            trips.append((time.perf_counter() - t0) * 1e3)
        row = {"B": b, "kernel_ms": kernel_ms, "wrapper_ms": wrapper_ms,
               "roundtrip_ms": statistics.median(trips),
               "plain_ms": plain_ms}
        row.update(bound(b, packed.cpu()))
        rows[b] = row
        print(f"B={b:5d}: kernel {kernel_ms * 1e3:.2f} us (graph replay), "
              f"wrapper {wrapper_ms * 1e3:.2f} us, launch+H2D+D2H "
              f"{row['roundtrip_ms'] * 1e3:.2f} us, plain {plain_ms * 1e3:.2f}"
              f" us, bound {row['bound_ms'] * 1e6:.2f} ns "
              f"({row['bound_by']}, {row['bytes']} B, {row['ops']} ops)",
              flush=True)
    return rows


def tor1k_config():
    from shadow_tpu_torch.core import configuration
    from shadow_tpu_torch.tools.synth_topology import lossy_complete_graphml
    from shadow_tpu_torch.tools.workloads import tor_network
    cfg = configuration.parse_xml(
        tor_network(TOR1K["n_relays"], stoptime=TOR1K["stoptime"]))
    cfg.topology_text = lossy_complete_graphml(TOR1K["graph_vertices"],
                                               TOR1K["graph_seed"])
    return cfg


def busy_intervals(prof) -> dict:
    """The card's time in a profile: every kernel, copy and set interval on
    the device, merged where they overlap, and the packet_hop kernels among
    them."""
    from torch.autograd import DeviceType
    spans, hop_us = [], []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        if "packet_hop" in e.name:
            hop_us.append(e.time_range.end - e.time_range.start)
    spans.sort()
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    return {"device_events": len(spans), "busy_s": busy_us * 1e-6,
            "hop_kernels": len(hop_us), "hop_kernel_s": sum(hop_us) * 1e-6,
            "hop_kernel_mean_us": (statistics.fmean(hop_us) if hop_us
                                   else None)}


def run_slice(policy: str, trace: bool = False) -> dict:
    import contextlib
    import torch
    from shadow_tpu_torch.core.checkpoint import state_digest
    from shadow_tpu_torch.core.controller import Controller
    from shadow_tpu_torch.core.logger import SimLogger, set_logger
    from shadow_tpu_torch.core.options import Options
    from shadow_tpu_torch.ops import round_step as rs
    # 3,000 app log lines per run would bury the phases
    set_logger(SimLogger(level="warning"))
    cfg = tor1k_config()
    opts = Options(scheduler_policy=policy, device="cuda", seed=TOR1K["seed"],
                   stop_time_sec=int(cfg.stop_time_sec), log_level="warning")
    ctl = Controller(opts, cfg)
    prof = (torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA]) if trace
        else contextlib.nullcontext())
    rs.packet_hop_packed.launches = 0
    with prof:
        t0 = time.perf_counter()
        rc = ctl.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = rs.packet_hop_packed.launches
    eng = ctl.engine
    pol = eng.scheduler.policy
    kern = getattr(pol, "_kernel", None)
    out = {"policy": policy, "rc": rc, "hosts": len(eng.hosts),
           "digest": state_digest(eng), "events": eng.events_executed,
           "rounds": eng.rounds_executed,
           "drops": eng.counters._new.get("packet_drop", 0),
           "wall_s": wall, "events_per_s": eng.events_executed / wall,
           "launches": launches}
    if kern is not None:
        out.update(device_calls=kern.device_calls, host_calls=kern.host_calls,
                   packets_batched=pol.packets_batched,
                   buckets=sorted(kern.buckets_seen),
                   device_ns=pol.device_ns, host_flush_ns=pol.host_flush_ns)
    if trace:
        out.update(busy_intervals(prof))
        out["idle_share"] = 1.0 - out["busy_s"] / wall
    print(json.dumps(out), flush=True)
    return out


def check_slice(tpu: dict, glob: dict) -> None:
    if tpu["rc"] != 0 or glob["rc"] != 0:
        fail(f"simulation exit codes {tpu['rc']}, {glob['rc']}")
    if tpu["hosts"] != 2050:
        fail(f"expected 2050 hosts, got {tpu['hosts']}")
    if not tpu["device_calls"] > 0 or tpu["host_calls"] != 0:
        fail(f"device_calls {tpu['device_calls']} host_calls "
             f"{tpu['host_calls']}: the hops did not all go to the card")
    if tpu["launches"] != tpu["device_calls"]:
        fail(f"packet_hop launches {tpu['launches']} != device_calls "
             f"{tpu['device_calls']}")
    if glob["launches"] != 0:
        fail("the global policy launched the hop kernel")
    for key in ("digest", "events", "rounds", "drops"):
        if not tpu[key] == glob[key] == EXPECTED[key]:
            fail(f"{key}: tpu {tpu[key]} global {glob[key]} JAX "
                 f"{EXPECTED[key]}")
    if tpu["device_calls"] != EXPECTED["device_calls"]:
        fail(f"device_calls {tpu['device_calls']} != JAX run's "
             f"{EXPECTED['device_calls']}")
    print(f"slice parity: digest {tpu['digest'][:16]}... events "
          f"{tpu['events']} rounds {tpu['rounds']} drops {tpu['drops']} "
          "== global == JAX", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write every measurement here as JSON")
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(HERE, "shadow_tpu_torch")):
        fail(f"no shadow_tpu_torch package beside {__file__}")
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs a GPU")

    phase("card")
    card_line = card()
    phase("build")
    build()
    phase("kernel vs plain version")
    max_err = check_kernel()
    phase("times")
    times = time_kernel()
    phase("slice: tor1k under --scheduler-policy=tpu on cuda")
    tpu = run_slice("tpu")
    phase("slice: tor1k under --scheduler-policy=global")
    glob = run_slice("global")
    check_slice(tpu, glob)
    print(f"tor1k tpu: wall {tpu['wall_s']:.3f} s, {tpu['events_per_s']:.0f}"
          f" events/s, device_ns {tpu['device_ns']}, host_flush_ns "
          f"{tpu['host_flush_ns']}, launches {tpu['launches']}; global: wall "
          f"{glob['wall_s']:.3f} s, {glob['events_per_s']:.0f} events/s",
          flush=True)
    phase("trace: tor1k under --scheduler-policy=tpu on cuda, profiled")
    traced = run_slice("tpu", trace=True)
    if traced["digest"] != tpu["digest"]:
        fail("the profiled tpu run's digest differs from the unprofiled one")
    if traced["hop_kernels"] != traced["launches"]:
        fail(f"the trace holds {traced['hop_kernels']} packet_hop kernels "
             f"for {traced['launches']} counted launches")
    print(f"tor1k tpu traced: wall {traced['wall_s']:.3f} s, card busy "
          f"{traced['busy_s']:.6f} s over {traced['device_events']} device "
          f"intervals, idle share {traced['idle_share']:.6f}; packet_hop "
          f"{traced['hop_kernels']} kernels, {traced['hop_kernel_s']:.6f} s, "
          f"mean {traced['hop_kernel_mean_us']:.3f} us", flush=True)

    main_row = times[MAIN_B]
    kernels = [{
        "name": "packet_hop", "route": "cuda",
        "source": "shadow_tpu_torch/ops/csrc/packet_hop.cu",
        "replaces": "shadow_tpu/ops/round_step.py:97",
        "launches": tpu["launches"], "max_abs_err": max_err,
        "ms": main_row["kernel_ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": None}]
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card_line, "times": list(times.values()),
                       "tpu": tpu, "global": glob, "traced": traced,
                       "kernels": kernels}, f,
                      indent=1)
    print(json.dumps({"kernels": kernels}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
