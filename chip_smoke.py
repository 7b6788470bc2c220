#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``shadow_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--out results.json] [--phases a,b,...]

Phases, each printed as it runs; any failure exits non-zero and prints no
result line:

1. card: name and power limit (nvidia-smi), torch and CUDA versions;
2. build: every CUDA kernel of the main path from
   ``shadow_tpu_torch/ops/csrc`` with nvcc for sm_90a, one nvcc per source,
   all at once; ptxas's register and spill lines;
3. kernels vs plain versions: ``packet_hop`` against
   ``packet_hop_packed_reference`` on the card, bit-exact on every lane
   (padding included), and against the numpy cipher on the valid lanes, at
   B in {256, 512, 4096, 65536} with A = 183; then ``torcells_span`` +
   ``pack_flush`` against their plain torch versions (and the numpy twin)
   on the tor10k plane's own flow table (F = 100,000, C = 20,000,
   H = 30,494), bit-exact on all ten outputs: a mid-span halt, an idle
   fold, an injection on a boundary, a capped flush with and without
   overflow; and ``pack_flush`` alone, all-empty, all-full and random;
4. times (CUDA events; graph replay for the kernels that are launch-bound)
   beside the least time the card could take for the same work;
5. the tor1k slice: ``tor_network(1000)`` (2,050 hosts) on a seeded
   183-vertex complete lossy GraphML, stoptime 20, under the ``tpu`` policy
   on cuda, then under ``global``; state digest, events, rounds and drops
   must agree with each other and with the JAX package's run;
6. the tor1k trace: the ``tpu`` run once more under ``torch.profiler``: the
   card's busy time (the union of its kernel and copy intervals), its idle
   share and the hop kernel's time inside real rounds.  The trace must hold
   one ``packet_hop`` kernel per counted launch;
7. the tor10k slice: ``tor_network(10000, device_data=True)`` (20,500
   hosts, 10,000 device-mode clients) under ``tpu`` on cuda, stoptime 64:
   every plane dispatch through one ``torcells_span`` and one
   ``pack_flush`` launch, every hop batch through ``packet_hop``; digest,
   events, rounds, completed flows and forwards equal to the JAX package's;
8. the tor10k trace: that run under ``torch.profiler``, with one span and
   one pack kernel in the trace per counted dispatch and the same digest.

``--phases`` runs a subset (with no arguments it runs them all).  The line
before the last is the card; the one before it the kernel table as JSON;
the last line is ``{"ok": true, "device": {...}}``.  Imports nothing of JAX
or of the JAX package.
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
    t0 = time.perf_counter()
    res = _build.build()
    print(f"built {', '.join(res)} in {time.perf_counter() - t0:.2f} s "
          "(one nvcc each, in parallel)")
    for name, r in res.items():
        print(f"{name}: {r['seconds']:.2f} s")
        for ln in r["log"].splitlines():
            if "registers" in ln or "spill" in ln or "Compiling" in ln:
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


# ---------------------------------------------------------------------------
# The device traffic plane's kernels (torcells_span + pack_flush)
# ---------------------------------------------------------------------------

# The tor10k slice: tools/workloads.tor_network(10000, stoptime=64,
# device_data=True) on the workload's built-in topology, Options(seed=1,
# workers=0, tpu_devices=1) under --scheduler-policy=tpu.  EXPECTED10K was
# made with the JAX package on the CPU (its device plane on one XLA CPU
# device, and its --device-plane=numpy twin, which agree);
# tests/test_torch_tor10k.py reproduces it (pytest -m slow) and holds the
# port's CPU run to it.
TOR10K = {"n_relays": 10000, "stoptime": 64, "seed": 1}
EXPECTED10K = {
    "digest": "ebf2a59369e3a0c483db623ace9f1554"
              "070775c57e201fbc4b49b60ba95288ac",
    "events": 979831,
    "rounds": 938,
    "completed": 10000,
    "forwards": 15600000,
    "dispatches": 120,
    "hop_calls": 690,
}
SPAN_TIME_TICKS = (16, 256)     # ticks per timed dispatch: fixed + slope
# 32-bit operations the span kernel does per tick: per flow the arrival
# gather index (int64 sub, floor mod), two adds, the clip (2 compares), the
# queue update, the send (or the delivered add and 3 compares), the
# segment's running sums, ~12 int64 operations = 24 32-bit; per node the
# refill min, the divide by the cell size (~20), the token and node_sent
# updates, ~32 32-bit
SPAN_OPS_PER_FLOW = 24
SPAN_OPS_PER_NODE = 32


def tor10k_config():
    from shadow_tpu_torch.core import configuration
    from shadow_tpu_torch.tools.workloads import tor_network
    return configuration.parse_xml(tor_network(
        TOR10K["n_relays"], stoptime=TOR10K["stoptime"], device_data=True))


def tor10k_options(device: str = "cuda"):
    from shadow_tpu_torch.core.options import Options
    return Options(scheduler_policy="tpu", device=device, workers=0,
                   seed=TOR10K["seed"], tpu_devices=1,
                   stop_time_sec=TOR10K["stoptime"], log_level="warning")


def tor10k_plane():
    """The tor10k device plane as the slice builds it (hosts set up, flow
    table uploaded to the card), without running the simulation: its
    static tables are the span kernel's real inputs."""
    from shadow_tpu_torch.core.controller import Controller
    from shadow_tpu_torch.core.logger import SimLogger, set_logger
    from shadow_tpu_torch.parallel.device_plane import build_plane_from_engine
    set_logger(SimLogger(level="warning"))
    ctl = Controller(tor10k_options(), tor10k_config())
    ctl.setup()
    plane = build_plane_from_engine(ctl.engine)
    plane._flow_args()
    return plane


def busy_state(plane, rng, t0: int):
    """A busy carried state on the plane's table, made with numpy from a
    seed: cells queued and in flight in the int32 ring, buckets part full,
    some cells delivered, targets on every exit flow (some within a few
    cells of done), a few exit flows done already."""
    import numpy as np
    f, h, lr = plane.n_flows, plane.n_nodes, plane.ring_len
    last = plane.flow_succ < 0
    queued = rng.integers(0, 40, size=f).astype(np.int64)
    ring = rng.integers(0, 12, size=(lr, f)).astype(np.int32)
    tokens = (rng.random(h) * plane.capacity_step).astype(np.int64)
    delivered = np.where(last, rng.integers(0, 500, size=f), 0)
    target = np.where(last, delivered + rng.integers(1, 4000, size=f), 0)
    near = last & (rng.random(f) < 0.01)
    target[near] = delivered[near] + rng.integers(1, 3, size=int(near.sum()))
    done_tick = np.full(f, -1, dtype=np.int64)
    done = last & (rng.random(f) < 0.05)
    done_tick[done] = rng.integers(0, t0, size=int(done.sum()))
    node_sent = rng.integers(0, 1 << 40, size=h).astype(np.int64)
    return (t0, queued, ring, tokens, delivered.astype(np.int64),
            target.astype(np.int64), done_tick, node_sent)


def span_cases(plane):
    """(name, numpy state, inject, inject_target, targets, idle, caps)."""
    import numpy as np
    rng = np.random.default_rng(20)
    f = plane.n_flows
    zero = np.zeros(f, dtype=np.int64)
    cases = []
    st = busy_state(plane, rng, 5000)
    cases.append(("halt mid-span, 8 targets", st, zero, zero,
                  5000 + 4 * np.arange(1, 9), 0, None))
    st = busy_state(plane, rng, 7000)
    cases.append(("idle fold (ring cleared)", st, zero, zero,
                  np.array([7000 + 12] * 8), 9, None))
    st = busy_state(plane, rng, 9000)
    inj = np.zeros(f, dtype=np.int64)
    inj_t = np.zeros(f, dtype=np.int64)
    chains = rng.choice(plane.n_chains, size=2000, replace=False)
    cells = rng.integers(1, 300, size=2000)
    inj[plane.first_flow[chains]] = cells
    inj_t[plane.last_flow[chains]] = cells
    # t0 is the previous superwindow's last boundary
    cases.append(("injection on a boundary", st, inj, inj_t,
                  9000 + 6 * np.arange(1, 9), 0, None))
    for name in ("capped flush, no overflow", "capped flush, overflow"):
        st = busy_state(plane, rng, 11000)
        cases.append((name, st, zero, zero, 11000 + 5 * np.arange(1, 9), 0,
                      name))
    return cases


def _span_run(plane, fn, case_state, inject, inject_target, targets, idle,
              caps):
    import torch
    dev = plane.device
    state = plane._to_device(case_state)
    inj = torch.as_tensor(inject, device=dev)
    inj_t = torch.as_tensor(inject_target, device=dev)
    kw = {}
    if fn.__name__ == "torcells_step_window_flush":
        kw["tables"] = plane._span_tables
    out = fn(*state, inj, inj_t, targets, idle, *plane._flow_args(),
             ring_len=plane.ring_len, cap_chains=caps[0] if caps else None,
             cap_nodes=caps[1] if caps else None, **kw)
    torch.cuda.synchronize()
    return [o.cpu().numpy() for o in out]


def check_torcells(plane) -> int:
    """The span + flush kernels against their plain torch versions on the
    card (and the numpy twin on the host), bit-exact on all ten outputs.
    Returns the largest absolute difference seen (0)."""
    import numpy as np
    from shadow_tpu_torch.ops import torcells_device as td
    max_err = 0
    names = ("t_stop", "queued", "ring", "tokens", "delivered", "target",
             "done_tick", "node_sent", "forwards", "flush")
    for name, st, inj, inj_t, targets, idle, capname in span_cases(plane):
        caps = None
        if capname is not None:
            full = _span_run(plane, td.torcells_step_window_flush_reference,
                             st, inj, inj_t, targets, idle, None)[9]
            n_done, n_touch = int(full[2]), int(full[3])
            if n_done < 2 or n_touch < 2:
                fail(f"{name}: the case needs completions and touched "
                     f"nodes, got {n_done}, {n_touch}")
            caps = ((n_done + 3, n_touch + 5) if "no overflow" in capname
                    else (n_done // 2, n_touch // 2))
        s0, p0 = td.torcells_span.launches, td.pack_flush.launches
        kern = _span_run(plane, td.torcells_step_window_flush, st, inj,
                         inj_t, targets, idle, caps)
        if (td.torcells_span.launches, td.pack_flush.launches) != \
                (s0 + 1, p0 + 1):
            fail("the span/pack wrappers did not count one launch each")
        plain = _span_run(plane, td.torcells_step_window_flush_reference,
                          st, inj, inj_t, targets, idle, caps)
        for i, (a, b) in enumerate(zip(kern, plain)):
            if a.shape != b.shape or a.dtype != b.dtype:
                fail(f"{name}: {names[i]} shape/dtype {a.shape} {a.dtype} "
                     f"!= plain {b.shape} {b.dtype}")
            err = int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max()
                      ) if a.size else 0
            max_err = max(max_err, err)
            if err:
                fail(f"{name}: {names[i]} differs from the plain version "
                     f"(max |diff| {err})")
        if caps is None:
            twin = td.torcells_step_window_numpy_flush(
                np.int64(st[0]), *[np.array(a) for a in st[1:]], inj, inj_t,
                targets, idle, plane.flow_node, plane.flow_lat_steps,
                plane.flow_succ, plane.seg_start, plane.refill_step,
                plane.capacity_step, plane.last_flow, plane.ring_len)
            for i, (a, b) in enumerate(zip(kern, twin)):
                if not np.array_equal(a, np.asarray(b)):
                    fail(f"{name}: {names[i]} differs from the numpy twin")
        overflow = caps is not None and td.flush_overflowed(kern[9], *caps)
        if caps is not None and overflow != ("no overflow" not in capname):
            fail(f"{name}: overflow {overflow} with caps {caps}")
        end = int(np.asarray(targets)[-1])
        print(f"{name}: kernel == plain version bit-exact (max_abs_err 0); "
              f"t0 {st[0]} -> t_stop {int(kern[0])} of {end}, forwards "
              f"{int(kern[8])}, chains done {int(kern[9][2])}, nodes "
              f"touched {int(kern[9][3])}, caps {caps}, overflow {overflow}",
              flush=True)
        if name.startswith("halt") and not int(kern[0]) < end:
            fail("the halt case did not halt before its last boundary")
    return max_err


def pack_cases(c: int, h: int):
    import numpy as np
    rng = np.random.default_rng(21)
    yield ("all empty", np.zeros(c, bool), np.full(c, -1),
           np.zeros(h, np.int64), None)
    yield ("all full", np.ones(c, bool), rng.integers(0, 9999, size=c),
           rng.integers(1, 1 << 40, size=h), None)
    newly = rng.random(c) < 0.3
    delta = np.where(rng.random(h) < 0.6, rng.integers(1, 1 << 30, size=h),
                     0)
    done = np.where(newly, rng.integers(0, 9999, size=c), -1)
    yield "random", newly, done, delta, None
    yield ("random, capped (overflow)", newly, done, delta,
           (int(newly.sum()) // 2, int((delta != 0).sum()) // 2))
    yield ("random, capped (fits)", newly, done, delta,
           (int(newly.sum()) + 1, int((delta != 0).sum()) + 1))


def check_pack(c: int, h: int) -> int:
    import numpy as np
    import torch
    from shadow_tpu_torch.ops import torcells_device as td
    dev = torch.device("cuda", 0)
    for name, newly, done, delta, caps in pack_cases(c, h):
        args = (torch.tensor(123456789, device=dev),
                torch.tensor(987654321, device=dev),
                torch.tensor(4242, device=dev),
                torch.as_tensor(newly, device=dev),
                torch.as_tensor(done.astype(np.int64), device=dev),
                torch.as_tensor(delta.astype(np.int64), device=dev))
        kw = dict(cap_chains=caps[0], cap_nodes=caps[1]) if caps else {}
        before = td.pack_flush.launches
        got = td.pack_flush(*args, **kw).cpu().numpy()
        if td.pack_flush.launches != before + 1:
            fail("pack_flush did not count its launch")
        want = td.pack_flush_torch(*args, **kw).cpu().numpy()
        if not np.array_equal(got, want):
            fail(f"pack_flush {name}: kernel differs from the plain version")
        if caps is None and not np.array_equal(got, td.pack_flush_np(
                123456789, 987654321, 4242, newly, done, delta)):
            fail(f"pack_flush {name}: kernel differs from the numpy twin")
        print(f"pack_flush {name}: kernel == plain version bit-exact, "
              f"n_done {got[2]}, n_touched {got[3]}, caps {caps}",
              flush=True)
    return 0


def span_bound(plane, ticks: int, caps=None) -> dict:
    """Least time for one dispatch of ``ticks`` ticks on the plane's table:
    every input read once and every output written once (the state, the
    injections, the tables, the flush inputs) over the card's HBM rate —
    the state (~13 MB at tor10k) would fit in the 50 MB L2, but the bound
    takes HBM's rate — against the ticks' 32-bit operations over the
    scalar peak."""
    f, h, c, lr = plane.n_flows, plane.n_nodes, plane.n_chains, plane.ring_len
    state = 8 * f * 4 + 4 * lr * f + 8 * h * 2
    reads = state + 8 * f * 2 + 8 * f * 4 + 8 * h * 2 + 8 * c
    writes = state + c + 8 * c + 8 * h
    nbytes = reads + writes
    ops = ticks * (f * SPAN_OPS_PER_FLOW + h * SPAN_OPS_PER_NODE)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ALU32_OPS_PER_S * 1e3
    return {"bytes": nbytes, "ops": ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def pack_bound(c: int, h: int) -> dict:
    nbytes = c + 8 * c + 8 * h + 8 * 3 + 8 * (5 + 2 * c + 2 * h)
    ops = 8 * (c + h)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ALU32_OPS_PER_S * 1e3
    return {"bytes": nbytes, "ops": ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def time_torcells(plane) -> dict:
    """Span kernel per dispatch at SPAN_TIME_TICKS ticks (no completion,
    so it runs them all) by CUDA events, the state restored between
    launches outside the timed interval; per tick from the slope.  The
    pack kernel by graph replay.  The plain versions on the same inputs."""
    import numpy as np
    import torch
    from shadow_tpu_torch.ops import torcells_device as td
    rng = np.random.default_rng(22)
    st = list(busy_state(plane, rng, 20000))
    st[5] = np.zeros(plane.n_flows, dtype=np.int64)   # no target: no halt
    dev = plane.device
    zero = torch.zeros(plane.n_flows, dtype=torch.int64, device=dev)
    args = plane._flow_args()
    out = {}
    for ticks in SPAN_TIME_TICKS:
        tv = np.array([20000 + ticks])
        saved = plane._to_device(st)
        live = tuple(a.clone() for a in saved[1:])
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        reps, total = 10, 0.0
        for r in range(reps + 2):
            for a, b in zip(live, saved[1:]):
                a.copy_(b)
            # keep the card busy while the host prepares the launch, so
            # the interval holds the kernel and not the host's call
            torch.cuda._sleep(2_000_000)
            e0.record()
            td.torcells_span(20000, *live, zero, zero, tv, 0, *args,
                             ring_len=plane.ring_len,
                             tables=plane._span_tables)
            e1.record()
            torch.cuda.synchronize()
            if r >= 2:
                total += e0.elapsed_time(e1)
        out[ticks] = {"ticks": ticks, "dispatch_ms": total / reps}
    t_lo, t_hi = SPAN_TIME_TICKS
    per_tick = (out[t_hi]["dispatch_ms"] - out[t_lo]["dispatch_ms"]) \
        / (t_hi - t_lo)
    fixed = out[t_lo]["dispatch_ms"] - per_tick * t_lo
    # the plain versions, same inputs, the long case
    tv = np.array([20000 + t_hi])
    saved = plane._to_device(st)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    td.torcells_step_span_torch(
        20000, *saved[1:], zero, zero, tv, 0, *args[:6],
        ring_len=plane.ring_len, arr_lat=plane._span_tables.arr_lat)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    row = {"ticks": t_hi, "ms": out[t_hi]["dispatch_ms"],
           "ms_short": out[t_lo]["dispatch_ms"], "ms_per_tick": per_tick,
           "fixed_ms": fixed, "plain_ms": plain_ms}
    row.update(span_bound(plane, t_hi))
    print(f"torcells_span dispatch: {row['ms']:.4f} ms at "
          f"{t_hi} ticks, {row['ms_short']:.4f} ms at {t_lo}; "
          f"{per_tick * 1e3:.3f} us/tick + {fixed * 1e3:.2f} us fixed; "
          f"plain {plain_ms:.2f} ms; bound {row['bound_ms'] * 1e3:.3f} us "
          f"({row['bound_by']}, {row['bytes']} B, {row['ops']} ops)",
          flush=True)
    # the pack kernel alone, by graph replay of 20 launches
    c, h = plane.n_chains, plane.n_nodes
    newly = torch.as_tensor(rng.random(c) < 0.05, device=dev)
    done = torch.as_tensor(rng.integers(0, 9999, size=c), device=dev)
    delta = torch.as_tensor(np.where(rng.random(h) < 0.5, 578, 0),
                            device=dev)
    heads = [torch.tensor(v, device=dev) for v in (1, 2, 3)]
    pargs = (*heads, newly, done, delta)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            td.pack_flush(*pargs)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    per_graph = 20
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            td.pack_flush(*pargs)
    graph.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(20):
        graph.replay()
    e1.record()
    torch.cuda.synchronize()
    pack_ms = e0.elapsed_time(e1) / (20 * per_graph)
    for _ in range(3):
        td.pack_flush_torch(*pargs)
    e0.record()
    for _ in range(20):
        td.pack_flush_torch(*pargs)
    e1.record()
    torch.cuda.synchronize()
    pack_plain_ms = e0.elapsed_time(e1) / 20
    prow = {"ms": pack_ms, "plain_ms": pack_plain_ms}
    prow.update(pack_bound(c, h))
    print(f"pack_flush: {pack_ms * 1e3:.3f} us (graph replay), plain "
          f"{pack_plain_ms * 1e3:.1f} us, bound {prow['bound_ms'] * 1e3:.3f}"
          f" us ({prow['bound_by']}, {prow['bytes']} B)", flush=True)
    return {"span": row, "pack": prow}


def tor1k_config():
    from shadow_tpu_torch.core import configuration
    from shadow_tpu_torch.tools.synth_topology import lossy_complete_graphml
    from shadow_tpu_torch.tools.workloads import tor_network
    cfg = configuration.parse_xml(
        tor_network(TOR1K["n_relays"], stoptime=TOR1K["stoptime"]))
    cfg.topology_text = lossy_complete_graphml(TOR1K["graph_vertices"],
                                               TOR1K["graph_seed"])
    return cfg


TRACED_KERNELS = {"hop": "packet_hop", "span": "torcells_span",
                  "pack": "pack_flush"}


def busy_intervals(prof) -> dict:
    """The card's time in a profile: every kernel, copy and set interval on
    the device, merged where they overlap; the port's kernels among them
    (count, total and mean time of each); and the copies' total time."""
    from torch.autograd import DeviceType
    spans = []
    per = {k: [] for k in TRACED_KERNELS}
    copy_us = 0.0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        a, b = e.time_range.start, e.time_range.end
        spans.append((a, b))
        for key, name in TRACED_KERNELS.items():
            if name in e.name:
                per[key].append(b - a)
        if "Memcpy" in e.name or "memcpy" in e.name:
            copy_us += b - a
    spans.sort()
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    out = {"device_events": len(spans), "busy_s": busy_us * 1e-6,
           "copy_s": copy_us * 1e-6}
    for key, us in per.items():
        out[f"{key}_kernels"] = len(us)
        out[f"{key}_kernel_s"] = sum(us) * 1e-6
        out[f"{key}_kernel_mean_us"] = statistics.fmean(us) if us else None
    return out


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


def run_tor10k(trace: bool = False) -> dict:
    """The tor10k slice through Controller.run on cuda, with every kernel
    count set to 0 just before it and read just after."""
    import contextlib
    import torch
    from shadow_tpu_torch.core.checkpoint import state_digest
    from shadow_tpu_torch.core.controller import Controller
    from shadow_tpu_torch.core.logger import SimLogger, set_logger
    from shadow_tpu_torch.ops import round_step as rs
    from shadow_tpu_torch.ops import torcells_device as td
    set_logger(SimLogger(level="warning"))
    ctl = Controller(tor10k_options(), tor10k_config())
    prof = (torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA]) if trace
        else contextlib.nullcontext())
    td.torcells_span.launches = 0
    td.pack_flush.launches = 0
    rs.packet_hop_packed.launches = 0
    with prof:
        t0 = time.perf_counter()
        rc = ctl.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    span_l, pack_l = td.torcells_span.launches, td.pack_flush.launches
    hop_l = rs.packet_hop_packed.launches
    eng = ctl.engine
    plane = eng.device_plane
    st = plane.stats()
    kern = eng.scheduler.policy._kernel
    out = {"slice": "tor10k", "rc": rc, "hosts": len(eng.hosts),
           "digest": state_digest(eng), "events": eng.events_executed,
           "rounds": eng.rounds_executed, "completed": st["completed"],
           "forwards": st["forwards"], "dispatches": st["dispatches"],
           "steps": st["steps"], "superwindows": st["superwindows"],
           "rounds_per_launch": st["rounds_per_launch"],
           "mode": st["mode"], "recoveries": st["recoveries"],
           "demoted": st["demoted"], "span_launches": span_l,
           "pack_launches": pack_l, "hop_launches": hop_l,
           "hop_calls": kern.device_calls, "host_calls": kern.host_calls,
           "flows": plane.n_flows, "chains": plane.n_chains,
           "nodes": plane.n_nodes, "ring_len": plane.ring_len,
           "wall_s": wall, "host_exec_s": eng.host_exec_ns * 1e-9,
           "flush_s": eng.flush_ns * 1e-9,
           "plane_host_s": st["plane_host_sec"],
           "plane_collect_s": st["plane_device_sec"],
           "pipeline_overlap_s": st["pipeline_overlap_sec"],
           "hop_device_ns": eng.scheduler.policy.device_ns,
           "events_per_s": eng.events_executed / wall}
    if trace:
        out.update(busy_intervals(prof))
        out["idle_share"] = 1.0 - out["busy_s"] / wall
    print(json.dumps(out), flush=True)
    return out


def check_tor10k(run: dict) -> None:
    if run["rc"] != 0:
        fail(f"tor10k exit code {run['rc']}")
    if run["mode"] != "device" or run["recoveries"] != 0 or run["demoted"]:
        fail(f"tor10k plane mode {run['mode']}, recoveries "
             f"{run['recoveries']}, demoted {run['demoted']}")
    for key, want in EXPECTED10K.items():
        if run[key] != want:
            fail(f"tor10k {key}: {run[key]} != JAX run's {want}")
    if not run["span_launches"] == run["pack_launches"] == run["dispatches"]:
        fail(f"span launches {run['span_launches']}, pack launches "
             f"{run['pack_launches']}, dispatches {run['dispatches']}")
    if run["hop_launches"] != run["hop_calls"] or run["host_calls"] != 0:
        fail(f"packet_hop launches {run['hop_launches']} != hop calls "
             f"{run['hop_calls']} (host calls {run['host_calls']})")
    print(f"tor10k parity: digest {run['digest'][:16]}... events "
          f"{run['events']} rounds {run['rounds']} completed "
          f"{run['completed']} forwards {run['forwards']} == JAX; "
          f"{run['dispatches']} dispatches = {run['span_launches']} span + "
          f"{run['pack_launches']} pack launches, {run['hop_launches']} hop "
          "launches", flush=True)


PHASES = ("build", "kernels", "times", "tor1k", "tor1k-trace", "tor10k",
          "tor10k-trace")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write every measurement here as JSON")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES)
                    + " (default: all)")
    args = ap.parse_args(argv)
    want = set(args.phases.split(","))
    if not want <= set(PHASES):
        fail(f"unknown phases {sorted(want - set(PHASES))}")
    if not os.path.isdir(os.path.join(HERE, "shadow_tpu_torch")):
        fail(f"no shadow_tpu_torch package beside {__file__}")
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs a GPU")
    t_start = time.perf_counter()
    res = {}

    phase("card")
    card_line = card()
    if "build" in want:
        phase("build")
        build()
    plane = None
    if want & {"kernels", "times"}:
        t0 = time.perf_counter()
        plane = tor10k_plane()
        print(f"tor10k plane table: F {plane.n_flows} C {plane.n_chains} H "
              f"{plane.n_nodes} ring_len {plane.ring_len} granule "
              f"{plane.granule} ms ({time.perf_counter() - t0:.1f} s)",
              flush=True)
    if "kernels" in want:
        phase("kernels vs plain versions")
        res["hop_err"] = check_kernel()
        res["span_err"] = check_torcells(plane)
        res["pack_err"] = check_pack(plane.n_chains, plane.n_nodes)
    if "times" in want:
        phase("times")
        res["hop_times"] = time_kernel()
        res["torcells_times"] = time_torcells(plane)
    plane = None
    if "tor1k" in want:
        phase("slice: tor1k under --scheduler-policy=tpu on cuda")
        tpu = res["tor1k_tpu"] = run_slice("tpu")
        phase("slice: tor1k under --scheduler-policy=global")
        glob = res["tor1k_global"] = run_slice("global")
        check_slice(tpu, glob)
        print(f"tor1k tpu: wall {tpu['wall_s']:.3f} s, "
              f"{tpu['events_per_s']:.0f} events/s, device_ns "
              f"{tpu['device_ns']}, host_flush_ns {tpu['host_flush_ns']}, "
              f"launches {tpu['launches']}; global: wall "
              f"{glob['wall_s']:.3f} s, {glob['events_per_s']:.0f} events/s",
              flush=True)
    if "tor1k-trace" in want:
        phase("trace: tor1k under --scheduler-policy=tpu on cuda, profiled")
        traced = res["tor1k_traced"] = run_slice("tpu", trace=True)
        if "tor1k_tpu" in res and traced["digest"] != res["tor1k_tpu"][
                "digest"]:
            fail("the profiled tpu run's digest differs from the "
                 "unprofiled one")
        if traced["digest"] != EXPECTED["digest"]:
            fail("the profiled tpu run's digest differs from the JAX run's")
        if traced["hop_kernels"] != traced["launches"]:
            fail(f"the trace holds {traced['hop_kernels']} packet_hop "
                 f"kernels for {traced['launches']} counted launches")
        print(f"tor1k tpu traced: wall {traced['wall_s']:.3f} s, card busy "
              f"{traced['busy_s']:.6f} s over {traced['device_events']} "
              f"device intervals, idle share {traced['idle_share']:.6f}; "
              f"packet_hop {traced['hop_kernels']} kernels, "
              f"{traced['hop_kernel_s']:.6f} s, mean "
              f"{traced['hop_kernel_mean_us']:.3f} us", flush=True)
    if "tor10k" in want:
        phase("slice: tor10k, device clients, --scheduler-policy=tpu on "
              "cuda")
        res["tor10k"] = run_tor10k()
        check_tor10k(res["tor10k"])
    if "tor10k-trace" in want:
        phase("trace: tor10k under --scheduler-policy=tpu on cuda, "
              "profiled")
        tr = res["tor10k_traced"] = run_tor10k(trace=True)
        check_tor10k(tr)
        if "tor10k" in res and tr["digest"] != res["tor10k"]["digest"]:
            fail("the profiled tor10k run's digest differs from the "
                 "unprofiled one")
        for key in ("span", "pack"):
            if tr[f"{key}_kernels"] != tr["dispatches"]:
                fail(f"the trace holds {tr[key + '_kernels']} {key} kernels "
                     f"for {tr['dispatches']} counted dispatches")
        if tr["hop_kernels"] != tr["hop_launches"]:
            fail(f"the trace holds {tr['hop_kernels']} packet_hop kernels "
                 f"for {tr['hop_launches']} counted launches")
        print(f"tor10k traced: wall {tr['wall_s']:.3f} s, card busy "
              f"{tr['busy_s']:.6f} s, idle share {tr['idle_share']:.6f}, "
              f"copies {tr['copy_s']:.6f} s; span {tr['span_kernels']} x "
              f"{tr['span_kernel_mean_us']:.1f} us = "
              f"{tr['span_kernel_s']:.6f} s; pack {tr['pack_kernels']} x "
              f"{tr['pack_kernel_mean_us']:.2f} us; hop {tr['hop_kernels']}"
              f" x {tr['hop_kernel_mean_us']:.3f} us", flush=True)

    def get(*keys):
        cur = res
        for k in keys:
            if not isinstance(cur, dict) or k not in cur:
                return None
            cur = cur[k]
        return cur

    hop = get("hop_times", MAIN_B) or {}
    span = get("torcells_times", "span") or {}
    pack = get("torcells_times", "pack") or {}
    kernels = [
        {"name": "packet_hop", "route": "cuda",
         "source": "shadow_tpu_torch/ops/csrc/packet_hop.cu",
         "replaces": "shadow_tpu/ops/round_step.py:97",
         "launches": get("tor1k_tpu", "launches"),
         "max_abs_err": res.get("hop_err"), "ms": hop.get("kernel_ms"),
         "plain_ms": hop.get("plain_ms"), "bound_ms": hop.get("bound_ms"),
         "bound_by": hop.get("bound_by"), "library_ms": None},
        {"name": "torcells_span", "route": "cuda",
         "source": "shadow_tpu_torch/ops/csrc/torcells_span.cu",
         "replaces": "shadow_tpu/ops/torcells_device.py:428",
         "launches": get("tor10k", "span_launches"),
         "max_abs_err": res.get("span_err"), "ms": span.get("ms"),
         "plain_ms": span.get("plain_ms"), "bound_ms": span.get("bound_ms"),
         "bound_by": span.get("bound_by"), "library_ms": None},
        {"name": "pack_flush", "route": "cuda",
         "source": "shadow_tpu_torch/ops/csrc/pack_flush.cu",
         "replaces": "shadow_tpu/ops/torcells_device.py:337",
         "launches": get("tor10k", "pack_launches"),
         "max_abs_err": res.get("pack_err"), "ms": pack.get("ms"),
         "plain_ms": pack.get("plain_ms"), "bound_ms": pack.get("bound_ms"),
         "bound_by": pack.get("bound_by"), "library_ms": None}]
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card_line, "results": res,
                       "kernels": kernels}, f, indent=1, default=str)
    print(json.dumps({"kernels": kernels}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
