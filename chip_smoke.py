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
   B in {256, 512, 4096, 65536} with A = 183, on device operands and
   through ``PacketHopKernel`` (the round in mapped host memory); then
   ``torcells_span`` +
   ``pack_flush`` against their plain torch versions (and the numpy twin)
   on the tor10k plane's own flow table (F = 100,000, C = 20,000,
   H = 30,494), bit-exact on all ten outputs: a mid-span halt, an idle
   fold, an injection on a boundary, a capped flush with and without
   overflow; the same five cases on a table whose nodes run longer than a
   tile and the kernel's 512-flow chunk (``DeviceTorCells``, 800 circuits
   over 4 relays: ~600 flows a relay); and ``pack_flush`` alone,
   all-empty, all-full, random and capped (inside a later tile too), at
   the tor10k width and at C and H on the kernel's tile boundaries (1,
   tile - 1, tile, tile + 1, 7 tiles + 3);
4. times (CUDA events; graph replay for the kernels that are launch-bound)
   beside the least time the card could take for the same work; the hop
   first held bit-exact on all lanes on a host-resident round
   (``packet_hop_mapped``) at each timed B, in fresh and reused buffers,
   then timed alone on device and on host-resident operands, and a round
   as the main path makes it (launch + wait, host clock);
5. the tor1k slice: ``tor_network(1000)`` (2,050 hosts) on a seeded
   183-vertex complete lossy GraphML, stoptime 20, under the ``tpu`` policy
   on cuda, then under ``global``; state digest, events, rounds and drops
   must agree with each other and with the JAX package's run;
6. the tor1k trace: the ``tpu`` run once more under ``torch.profiler``: the
   card's busy time (the union of its kernel and copy intervals), its idle
   share and the hop kernel's time inside real rounds.  The trace must hold
   one ``packet_hop`` kernel per counted launch, and no copy but the
   topology's upload: a round is one kernel on its host-resident buffers;
7. the tor10k slice: ``tor_network(10000, device_data=True)`` (20,500
   hosts, 10,000 device-mode clients) under ``tpu`` on cuda, stoptime 64:
   every plane dispatch through one ``torcells_span`` and one
   ``pack_flush`` launch, every hop batch through ``packet_hop``; digest,
   events, rounds, completed flows and forwards equal to the JAX package's;
8. the tor10k trace: that run under ``torch.profiler``, with one span and
   one pack kernel in the trace per counted dispatch and the same digest;
9. fleet kernels vs plain versions: ``torcells_span_batched`` +
   ``pack_flush_batched`` at the sweep's shape class (W = 8: seven lanes
   of the sweep's flow tables and a filler row), bit-exact on all ten
   outputs against the plain batched version on the card, the numpy twin,
   and a serial ``torcells_span`` + ``pack_flush`` launch on each lane's
   real rows: a halt mid-span while others run on, an idle fold, an
   injection on a boundary, lanes at different t_stops; and the batched
   pack alone against its plain version; then W in {1, 2, 4} on the
   sweep lanes' rows, and two lanes of the long-node table, against the
   plain batched version;
10. fleet times: one batched dispatch at W in {1, 2, 4, 8} against W
    serial dispatches (CUDA events), the batched span kernel alone at each
    W and the pack alone at W = 8 (by graph replay), each beside its
    bound;
11. ``simfleet smoke`` on cuda: 8 fuzz-drawn scenarios run serially and
    as 8 fleet lanes, digest-gated, with batched launches;
12. the sweep: the genscen ``tor10k`` preset (10,000 hosts, every transfer
    a processless device chain) with seeds 1..8, each run serially on cuda
    (every ``torcells_span`` launch bracketed by CUDA events: its card time
    inside the real runs), then as 8 lanes of one fleet: every lane equal
    to its serial run, lane 1 to the JAX package's, one batched span and
    one batched pack launch per fleet launch, no serial kernel launched;
13. the sweep's fleet under ``torch.profiler``: one batched span and one
    batched pack kernel per fleet launch, the card's busy time and idle
    share;
14. model kernels vs plain versions: ``phold`` (1,024 hosts x 16,384
    messages, to 3 s; and 65,536 messages, the device-memory path, to
    1 s), ``saturate`` (4,096 interfaces x 30,000 ticks),
    ``torcells_run`` (200 relays, 2,000 circuits, 200 cells each, to
    completion, in the grid form its size gives; cut at 700 ticks; one
    flow queued below zero, the int64 path; 20,000 circuits to
    completion; ``modelbench --small``'s table, a grid of two blocks; the
    long-node table cut at 1,000 ticks over 8 blocks with chunks of 64
    flows and in the global form; each printing the form and path that
    ran) and
    ``torcells_step_window`` (split windows and an idle fold, through
    ``torcells_span``), ``admit_sorted`` (N in {256, 8,192,
    65,536} over 2,050 hosts, and a batch with invalid lanes inside it):
    each bit-exact against its plain torch version on the card; then
    ``saturate_edge_cases`` (one launch mixing hosts on the kernel's 32-bit
    and int64 paths, ranges at and past the ends, refill 0, capacity
    under a packet, qcap 0 and -1, size 1 and past 2^31) and
    ``admit_edge_cases`` (runs across tiles with invalid lanes at tile
    edges, a whole tile invalid, packets past 2^31 bytes, arrivals past
    2^62) and ``admit_carry_cases`` (invalid lanes of other dsts inside
    runs, where JAX's scan reloads a run's carry, on the tiled and the
    lane kernel), each printing how many
    hosts took saturate's 32-bit path and how many admission runs crossed
    a tile;
15. model times: each of those kernels at the main path's inputs (CUDA
    events; graph replay for ``admit_sorted``) beside its bound and, for
    ``saturate`` and ``admit_sorted``, the serial chain's floor (the
    slowest host's stepped ticks, the longest run's packets, times an
    estimated dependent latency); ``torcells_run`` also at 20,000
    circuits;
16. the model workloads: ``tools/modelbench.py`` on cuda at bench.py's
    sizes, every count equal to the JAX package's (EXPECTED_MODELS), one
    launch of its kernel per device call;
17. the model workloads under ``torch.profiler`` (without the engine twin,
    which launches no kernel): one kernel of each kind per counted launch,
    the card's busy time and idle share.

The native tier (after 8; artifacts built from ``native/`` into
``shadow_tpu_torch/native/`` in the build phase, beside nvcc):

N1. native: tor1k under ``global`` with ``--dataplane=native`` (the C data
    plane, its round executor, the C retransmit tally) and with
    ``--dataplane=python``, each equal to EXPECTED; tor10k under ``global``
    on the C plane (its cells on the card: one ``torcells_span`` and one
    ``pack_flush`` launch per dispatch, the wakes into the C event heap),
    equal to EXPECTED10K in digest, events, completed flows and forwards;
    the walls beside the ``tpu`` runs' (5 and 7 also print which data
    plane the ``auto`` global run took);
N2. procs: tor1k with ``--processes 2`` under ``global`` (C-plane shards)
    and under ``tpu`` on cuda with a shard killed at round
    PROCS_DRILL_ROUND and resurrected (each shard its own CUDA context, its
    hops through ``packet_hop``: the shards' device and launches ride
    their metrics scrape to the parent's summary): each equal to
    EXPECTED;
N3. plugins: tests/native_src/testapp.c compiled with ``cc``; a two-host
    ``exec:`` TCP transfer and six pooled UDP pairs (``pool:``) under
    ``global`` and ``tpu`` on cuda, every binary exiting 0, equal to
    EXPECTED_PLUGINS, the ``tpu`` hops through ``packet_hop``.

The analyzers (right after 2):

A1. analyzers: ``python -m shadow_tpu_torch.analysis.{simlint,simrace,
    simtwin,simjit}`` (``--json``; simtwin with ``native/``), ``simgen
    --check`` and ``simjit --sync-sites`` over this checkout, one process
    each, all at once: each exits 0 with no unsuppressed finding; the
    files and suppressed findings of each are printed.  Then the runtime
    twin of SIM302: a probe (an ``.item()`` and an ``Event.synchronize``
    in a window opened by hand must both be recorded), and the tor10k
    slice of 7 (not traced) under ``torch.cuda.set_sync_debug_mode
    ("warn")``, equal to EXPECTED10K, with every synchronizing call
    recorded at the innermost frame of the port that made it: the implicit
    ones from the debug mode's warnings, the explicit ones
    (``Event.synchronize``, ``Stream.synchronize``,
    ``torch.cuda.synchronize``, which it does not flag) by wrapping them,
    each marked by whether a device-plane dispatch was in flight (from its
    launch to its collect; the windows counted must equal the
    dispatches).  A sync in a window at a site the static pass does not
    know as designed (a SIM302 pragma, a read of an in-flight handle's
    attribute, an explicit ``.synchronize()``) fails the phase.  Each site
    is printed with its count, kind and window, and the run's wall.

The mesh (D shards on one card; run in this order among the phases above:
mesh kernels and times after 4, the tor1k matrix slice after 6, the tor10k
mesh slice and its trace after 8):

M1. mesh kernels vs plain versions: ``mesh_span`` + the mesh entry of
    ``pack_flush`` on the tor10k plane's flow table, partitioned by
    ``chain_partition``, at D in {8, 3, 2} and every exchange mode (fused,
    ppermute, a leg-masked ppermute at D = 8, none), for 3's first three
    span cases: bit-exact on all ten outputs (the trailing cross-shard slot
    included) against the plain mesh version on the card and, read back
    through the layout, against ``torcells_span`` + ``pack_flush`` on the
    unpadded table; the same on the long-node table at D = 2 (fused,
    ppermute, none: nodes of up to 614 flows, longer than a tile and the
    512-flow chunk); the mesh flush with caps (the JAX package's
    ``cap_chains`` / ``cap_nodes``) at D = 8, caps below the counts
    (overflow detected) and above them, against the plain mesh version;
    the sharded hop in both layouts at B in {256, 4096,
    65536} and D in {8, 3, 1, 5} against its plain versions and
    ``packet_hop``, one launch a batch;
M2. mesh times: one 256-tick mesh dispatch at D = 8 in turns with the
    single-table span on the same state (CUDA events), the mesh flush
    (also capped at the tuner's caps) and the sharded hop (D = 8 batch-sharded, D = 4 matrix-sharded) beside
    ``packet_hop`` by graph replay, each beside its bound;
M3. the tor1k matrix slice: tor1k under ``tpu`` with ``--tpu-devices 4
    --tpu-shard-matrix``: EXPECTED, every hop batch one launch of
    ``packet_hop_sharded``, no other kernel;
M4. the tor10k mesh slice: tor10k with ``--tpu-devices 8``: EXPECTED10K,
    ``mesh.host_bounces == 0``, the cross-shard counts EXPECTED_MESH10K,
    one ``mesh_span`` and one mesh flush launch per dispatch, the hop one
    launch of ``packet_hop_sharded`` per batch (its 8 slices on the grid's
    y axis, the matrices whole), no single-table kernel;
M5. the tor10k mesh slice under ``torch.profiler``: one mesh span and one
    mesh flush kernel per counted dispatch, the card's busy time and idle
    share.

simfuzz (after 11):

F1. simfuzz on cuda: (a) the 7 regression specs of ``shadow_tpu_torch/fuzz/corpus`` replayed in
    process on cuda (``replay_file``), every mode of each equal to
    EXPECTED_CORPUS (the JAX package's digest and events), the span,
    pack, ``mesh_span`` and mesh flush launched and no other kernel; (b)
    the fault drill through the CLI (``--spec`` the corpus' cdn spec,
    ``--fault-inject digest-drift:numpy --shrink-budget 8``): rc 1, one
    repro, which ``--repro`` replays with rc 0; (c) ``--seeds 1
    --seed-base 1 --timeout-sec 240`` through the bounded subprocess
    runner at the default device (the kernels built in the parent first),
    rc 0; a child given seed 3's ``procs`` mode, 3,000 s of simulated time
    and a 5 s bound comes back as a timeout that the rc_log oracle fails:
    the group kill lands while the child's shards run (its group holds
    more than the child just before it) and leaves nothing of the group
    running; (d) ``--batched --lanes
    8`` on seed 1: rc 0, batched launches (one batched span and pack
    each), its ``base`` run equal to EXPECTED_FUZZ.  Each part prints its
    wall and modes a second.

The cost model (after M5):

C1. costmodel: ``python -m shadow_tpu_torch.prof calibrate --batched`` on
    cuda into a temporary path (one bounded child, wall cap
    COSTMODEL_WALL_CAP_S): the span + pack step per tick at 1,000 to
    120,000 flows, ``mesh_span`` per exchange mode at D in {2, 3, 4, 8}
    beside ``torcells_span`` on the same flows, the plane's copies, the
    batched step at W in {1, 2, 4, 8}, each the median of 5 launches with
    its spread; ``simprof check`` on it (ok, it loads here, both drills
    refused) and the JAX package's COSTMODEL.json refused; tor10k under
    ``tpu`` with ``--cost-model`` (EXPECTED10K's digest, events, rounds,
    completed flows and forwards; the tuner's K, the launch attribution,
    the wall); a 100-client Tor config at ``--tpu-devices 8`` with the
    model, without it and with each exchange mode forced: one digest, the
    model's run reading its exchange from the model.

When a slice and its trace are both asked for (5 and 6, 7 and 8, M4 and
M5), the slice runs once, under the profiler, and both phases' checks are
made on that run (the profiler costs the host ~3% of the wall).

Each trace (6, 8, 13, 17, M5) runs its slice between two marker kernels;
the profiler at times drops the card's events at the start of its window,
and a trace that lost a marker is taken again, at most three times in all.

``--phases`` runs a subset (with no arguments it runs them all).
``--pairs-against DIR`` (DIR a checkout of another commit, such as a
``git archive`` of the parent) builds DIR's ``csrc/saturate.cu`` and
``csrc/admit_sorted.cu`` beside this tree's and times the two in turns,
PAIRS pairs (``saturate`` by CUDA events at the bench shape,
``admit_sorted`` by graph replay at each ADMIT_SIZES), after the build;
it binds DIR's entry points with this tree's argument lists, so it first
checks that both trees' ``extern "C"`` launch signatures are the same.
The line before the last is the card; the one before it the kernel table as JSON;
the last line is ``{"ok": true, "device": {...}}``.  Imports nothing of JAX
or of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
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
# the copies a tor1k run makes: the latency and reliability matrices,
# uploaded when the first round builds the hop kernel (a round makes none)
TOR1K_SETUP_COPIES = 2

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
    # on both streams: a caller that keeps only the end of one still sees why
    print(f"chip_smoke: FAIL: {msg}", flush=True)
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


_T0 = time.perf_counter()


def phase(name: str) -> None:
    print(f"== {name} (at {time.perf_counter() - _T0:.1f} s)", flush=True)


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
    """The CUDA kernels (one nvcc each, in parallel) and, beside them, the
    native tier's artifacts from native/ (utils/native_build.py)."""
    import threading
    from shadow_tpu_torch.ops import _build
    native = {}
    t0 = time.perf_counter()
    thread = threading.Thread(target=lambda: native.update(build_native()))
    thread.start()
    res = _build.build()
    print(f"built {', '.join(res)} in {time.perf_counter() - t0:.2f} s "
          "(one nvcc each, in parallel)")
    thread.join()
    if "error" in native:
        fail(f"native build: {native['error']}")
    print(f"native tier built in {native['seconds']:.2f} s beside them: "
          f"{', '.join(native['artifacts'])} in {native['dir']}", flush=True)
    for name, r in res.items():
        print(f"{name}: {r['seconds']:.2f} s")
        for ln in r["log"].splitlines():
            if "registers" in ln or "spill" in ln or "Compiling" in ln:
                print(f"  {ln.strip()}")


def build_native() -> dict:
    """Build the C data plane, the retransmit tally, the preload shim and
    the pool helper into shadow_tpu_torch/native/."""
    from shadow_tpu_torch.utils import native_build as nb
    t0 = time.perf_counter()
    names = ("_shadow_dataplane.so", "libshadow_tally.so",
             *nb.PLUGIN_ARTIFACTS)
    try:
        for name in names:
            nb.ensure(name)
    except nb.NativeBuildError as e:
        return {"error": str(e)}
    return {"seconds": time.perf_counter() - t0, "artifacts": names,
            "dir": nb.NATIVE_DIR}


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
        # the full launch path: the round in mapped host memory, own stream
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


def check_mapped(kern, packed, bufs, label: str) -> int:
    """``packet_hop_mapped`` on ``bufs`` (a MappedRound), the batch
    ``packed`` written into it first, against the plain version on every
    lane, padding included; the largest |difference|."""
    import torch
    from shadow_tpu_torch.ops import round_step as rs
    bufs.packed.copy_(packed.cpu())
    before = rs.packet_hop_mapped.launches
    rs.packet_hop_mapped(kern.latency, kern.reliability, bufs, kern.key_lo,
                         kern.key_hi, kern.bootstrap_end_ns)
    if rs.packet_hop_mapped.launches != before + 1:
        fail("packet_hop_mapped did not count its launch")
    torch.cuda.synchronize()
    rd, rk = rs.packet_hop_packed_reference(
        kern.latency, kern.reliability, packed, kern.key_lo, kern.key_hi,
        kern.bootstrap_end_ns)
    rd, rk = rd.cpu(), rk.cpu()
    err = max(int((bufs.deliver - rd).abs().max()),
              int(bool((bufs.keep != rk).any())))
    if err or not (torch.equal(bufs.deliver, rd)
                   and torch.equal(bufs.keep, rk)):
        fail(f"packet_hop on a host-resident round disagrees with its plain "
             f"version at B={bufs.b} ({label}: max |deliver diff| {err}, "
             f"keep mismatches {int((bufs.keep != rk).sum())})")
    return err


def time_kernel() -> dict:
    """Phase 4 at each of TIME_SIZES: the host-resident hop held to the
    plain version on every lane (a fresh round, then the same buffers with
    another batch), then the kernel alone by graph replay on device and on
    host-resident operands, the wrapper back to back, the plain version,
    and a round as the main path makes it (host clock, median of 200)."""
    import torch
    from shadow_tpu_torch.ops import round_step as rs
    dev = torch.device("cuda", 0)
    rows = {}
    for b in TIME_SIZES:
        kern, packed, cols = make_inputs(b, seed=1000 + b, device=dev)
        args = (kern.latency, kern.reliability, packed, kern.key_lo,
                kern.key_hi, kern.bootstrap_end_ns)
        bufs = rs.MappedRound.allocate(b, dev)
        err = check_mapped(kern, packed, bufs, "fresh buffers")
        _k2, other, _c2 = make_inputs(b, seed=2000 + b, device=dev)
        err = max(err, check_mapped(kern, other, bufs, "reused buffers"))
        check_mapped(kern, packed, bufs, "reused again")
        print(f"B={b:5d}: packet_hop on a host-resident round == plain "
              f"version bit-exact on all {b} lanes (max_abs_err {err}), "
              "fresh and reused buffers", flush=True)
        # kernel alone, by graph replay (so the host's per-call cost does
        # not hide the device time): on device operands, and on the main
        # path's, the round in host memory
        kernel_ms = graph_ms(lambda: rs.packet_hop_packed(*args), reps=50)
        mapped_ms = graph_ms(lambda: rs.packet_hop_mapped(
            kern.latency, kern.reliability, bufs, kern.key_lo, kern.key_hi,
            kern.bootstrap_end_ns), reps=50)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
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
        # what a round pays on the main path: pack into the round's host
        # buffers, one launch, wait on its event, copy the results out
        # (host clock, median of 200)
        for _ in range(10):
            kern.launch(*cols).wait()
        trips = []
        for _ in range(200):
            t0 = time.perf_counter()
            kern.launch(*cols).wait()
            trips.append((time.perf_counter() - t0) * 1e3)
        row = {"B": b, "kernel_ms": mapped_ms, "device_operands_ms": kernel_ms,
               "wrapper_ms": wrapper_ms, "err": err,
               "roundtrip_ms": statistics.median(trips),
               "plain_ms": plain_ms}
        row.update(bound(b, packed.cpu()))
        rows[b] = row
        print(f"B={b:5d}: kernel {mapped_ms * 1e3:.2f} us on a host-resident "
              f"round, {kernel_ms * 1e3:.2f} us on device operands (graph "
              f"replay), wrapper {wrapper_ms * 1e3:.2f} us, round trip "
              f"(launch + wait, no copy) {row['roundtrip_ms'] * 1e3:.2f} us, "
              f"plain {plain_ms * 1e3:.2f} us, bound "
              f"{row['bound_ms'] * 1e6:.2f} ns ({row['bound_by']}, "
              f"{row['bytes']} B, {row['ops']} ops)", flush=True)
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


# A table whose nodes run longer than a tile (256 flows) and the span
# kernels' 512-flow chunk: DeviceTorCells with 800 circuits over 4 relays
# (each circuit crosses 3 of them, so every relay paces ~600 flows)
LONG_NODE = {"n_relays": 4, "n_circuits": 800, "seed": 41}


class LongNodeTable:
    """DeviceTorCells(LONG_NODE)'s flow table on ``device`` with the plane
    attributes the span checks read (flow tables, chains, ring_len, the
    span kernel's tables)."""

    def __init__(self, device: str = "cuda"):
        import numpy as np
        import torch
        from shadow_tpu_torch.ops import torcells_device as td
        tc = td.DeviceTorCells(LONG_NODE["n_relays"],
                               LONG_NODE["n_circuits"],
                               seed=LONG_NODE["seed"], device=device)
        fl = tc.flows
        self.device = tc.device
        self.flow_node, self.flow_lat_steps = fl["flow_node"], fl["flow_lat"]
        self.flow_succ, self.seg_start = fl["flow_succ"], fl["seg_start"]
        self.refill_step, self.capacity_step = tc.refill, tc.capacity
        self.ring_len = tc.ring_len
        self.n_flows, self.n_nodes = len(fl["flow_node"]), len(tc.refill)
        self.n_chains = c = LONG_NODE["n_circuits"]
        last, first = fl["flow_succ"] < 0, fl["flow_stage"] == 0
        self.last_flow = np.empty(c, dtype=np.int64)
        self.last_flow[fl["flow_circ"][last]] = np.flatnonzero(last)
        self.first_flow = np.empty(c, dtype=np.int64)
        self.first_flow[fl["flow_circ"][first]] = np.flatnonzero(first)
        self._args = tc.tensors + (torch.as_tensor(self.last_flow,
                                                   device=self.device),)
        self._span_tables = tc.tables
        self.longest = int(np.bincount(self.flow_node).max())

    def _to_device(self, state) -> tuple:
        import numpy as np
        import torch
        return (np.int64(state[0]),) + tuple(
            torch.as_tensor(np.ascontiguousarray(a), device=self.device)
            for a in state[1:])

    def _flow_args(self) -> tuple:
        return self._args


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
    k = min(2000, plane.n_chains // 2)
    chains = rng.choice(plane.n_chains, size=k, replace=False)
    cells = rng.integers(1, 300, size=k)
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
    # caps that fall inside a tile other than the first (tiles of
    # FLUSH_TILE lanes)
    from shadow_tpu_torch.ops.torcells_device import FLUSH_TILE
    yield ("random, capped inside a later tile", newly, done, delta,
           (FLUSH_TILE + FLUSH_TILE // 2 + 7, 2 * FLUSH_TILE + 11))


def pack_tile_sizes():
    """(C, H) pairs at the pack kernel's tile boundaries: C and H each one
    of 1, tile - 1, tile, tile + 1 and 7 tiles + 3."""
    from shadow_tpu_torch.ops.torcells_device import FLUSH_TILE as t
    sizes = (1, t - 1, t, t + 1, 7 * t + 3)
    return list(zip(sizes, reversed(sizes)))


def check_pack(c: int, h: int) -> int:
    """pack_flush against its plain version (and the numpy twin) at the
    tor10k width and at every pack_tile_sizes pair, every case of
    pack_cases at each."""
    for cs, hs in [(c, h)] + pack_tile_sizes():
        _check_pack_at(cs, hs)
    return 0


def _check_pack_at(c: int, h: int) -> None:
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
        print(f"pack_flush C={c} H={h} {name}: kernel == plain version "
              f"bit-exact, n_done {got[2]}, n_touched {got[3]}, caps "
              f"{caps}", flush=True)


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


TRACED_KERNELS = {"hop": "packet_hop_kernel", "span": "torcells_span_kernel",
                  "pack": "pack_flush_kernel",
                  "span_b": "torcells_span_batched_kernel",
                  "pack_b": "pack_flush_batched_kernel",
                  "phold": "phold_kernel", "saturate": "saturate_kernel",
                  "torcells_run": "torcells_run_kernel",
                  "admit_sorted": "admit_sorted_kernel",
                  "mesh_span": "mesh_span_kernel",
                  "mesh_pack": "pack_flush_mesh_kernel",
                  "hop_s": "packet_hop_sharded_kernel"}


# The kernel of torch.cuda._sleep, launched as a marker at each end of a
# trace (no slice launches it), with the card idle for MARKER_GUARD_S
# between the marker and the trace's edge; before the first marker, a
# lead-in of LEAD_IN one-element adds, LEAD_IN_GAP_S apart.
MARKER = "spin"
MARKER_CYCLES = 1000
MARKER_GUARD_S = 0.5
LEAD_IN = 2000
LEAD_IN_GAP_S = 0.0005
TRACE_TAKES = 3


class IncompleteTrace(Exception):
    """A trace that lacks one of its two marker kernels: the profiler
    dropped the card's events at an end of its window."""


@contextlib.contextmanager
def card_trace(trace: bool):
    """The card's activity over the body under torch.profiler (nothing when
    not ``trace``), the profile as the context's value, the body between
    two marker kernels.

    On the H100 machine the profiler drops the first device events of a
    trace, or all of them: of every trace after one with many events (the
    tor1k slice's) and of one trace in a few anyway (tools/trace_probe.py,
    PERF.md).  A lead-in of small kernels takes the first loss; the body's
    events are those from the first marker to the second, and a trace that
    kept both markers kept them all.  busy_intervals refuses one that did
    not (IncompleteTrace), and retake() takes the slice again."""
    if not trace:
        yield None
        return
    import torch
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])
    prof.marker_host_s = []
    with prof:
        t_open = time.perf_counter()
        torch.cuda.synchronize()
        time.sleep(MARKER_GUARD_S)
        lead = torch.zeros(1, device="cuda")
        for _ in range(LEAD_IN):
            lead.add_(1)
            time.sleep(LEAD_IN_GAP_S)
        torch.cuda.synchronize()
        prof.marker_host_s.append(time.perf_counter() - t_open)
        torch.cuda._sleep(MARKER_CYCLES)
        torch.cuda.synchronize()
        yield prof
        torch.cuda.synchronize()
        prof.marker_host_s.append(time.perf_counter() - t_open)
        torch.cuda._sleep(MARKER_CYCLES)
        torch.cuda.synchronize()
        time.sleep(MARKER_GUARD_S)


def retake(run):
    """``run()`` (a traced slice, built anew each time) again while its
    trace is incomplete, at most TRACE_TAKES times in all."""
    for take in range(1, TRACE_TAKES + 1):
        try:
            return run()
        except IncompleteTrace as e:
            print(f"trace: take {take} incomplete ({e}); the slice runs "
                  "again", flush=True)
    fail(f"{TRACE_TAKES} traces in a row dropped the card's events at an "
         "end of their window")


def busy_intervals(prof) -> dict:
    """The card's time in a profile between its two markers: every kernel,
    copy and set interval on the device, merged where they overlap; the
    port's kernels among them (count, total and mean time of each); and the
    copies' total time."""
    from torch.autograd import DeviceType
    events = [(e.time_range.start, e.time_range.end, e.name)
              for e in prof.events() if e.device_type == DeviceType.CUDA]
    markers = sorted(a for a, _b, name in events if MARKER in name)
    if len(markers) != 2:
        rest = sorted(a for a, _b, name in events if MARKER not in name)
        first = f"{rest[0] * 1e-6:.4f}" if rest else "none"
        raise IncompleteTrace(
            f"{len(markers)} of its 2 marker kernels: launched at "
            f"{[round(t, 4) for t in prof.marker_host_s]} s on the host's "
            f"clock, kept at {[round(t * 1e-6, 4) for t in markers]} s on "
            f"the trace's; {len(rest)} other device events, the first at "
            f"{first} s")
    spans = []
    per = {k: [] for k in TRACED_KERNELS}
    copy_us, copies = 0.0, 0
    for a, b, name in events:
        if MARKER in name or not markers[0] < a < markers[1]:
            continue
        spans.append((a, b))
        for key, kname in TRACED_KERNELS.items():
            if kname in name:
                per[key].append(b - a)
        if "Memcpy" in name or "memcpy" in name:
            copy_us += b - a
            copies += 1
    spans.sort()
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    out = {"device_events": len(spans), "busy_s": busy_us * 1e-6,
           "copy_s": copy_us * 1e-6, "copies": copies,
           "markers_host_s": prof.marker_host_s,
           "markers_trace_s": [t * 1e-6 for t in markers]}
    for key, us in per.items():
        out[f"{key}_kernels"] = len(us)
        out[f"{key}_kernel_s"] = sum(us) * 1e-6
        out[f"{key}_kernel_mean_us"] = statistics.fmean(us) if us else None
    return out


def run_slice(policy: str, trace: bool = False,
              dataplane: str = "auto") -> dict:
    import torch
    from shadow_tpu_torch.core.checkpoint import state_digest
    from shadow_tpu_torch.core.controller import Controller
    from shadow_tpu_torch.core.logger import SimLogger, set_logger
    from shadow_tpu_torch.core.options import Options
    from shadow_tpu_torch.descriptor.retransmit_tally import make_tally
    from shadow_tpu_torch.ops import round_step as rs
    # 3,000 app log lines per run would bury the phases
    set_logger(SimLogger(level="warning"))
    cfg = tor1k_config()
    opts = Options(scheduler_policy=policy, device="cuda", seed=TOR1K["seed"],
                   stop_time_sec=int(cfg.stop_time_sec), log_level="warning",
                   dataplane=dataplane)
    ctl = Controller(opts, cfg)
    rs.packet_hop_mapped.launches = rs.packet_hop_packed.launches = 0
    with card_trace(trace) as prof:
        t0 = time.perf_counter()
        rc = ctl.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = rs.packet_hop_mapped.launches
    if rs.packet_hop_packed.launches:
        fail(f"tor1k {policy}: {rs.packet_hop_packed.launches} hops on "
             "device operands: every round must run on its host-resident "
             "buffers")
    eng = ctl.engine
    pol = eng.scheduler.policy
    kern = getattr(pol, "_kernel", None)
    tally = make_tally()
    tally.close()
    out = {"policy": policy, "rc": rc, "hosts": len(eng.hosts),
           "digest": state_digest(eng), "events": eng.events_executed,
           "rounds": eng.rounds_executed,
           "drops": eng.counters._new.get("packet_drop", 0),
           "wall_s": wall, "events_per_s": eng.events_executed / wall,
           "launches": launches, "dataplane": dataplane,
           "plane": "C" if eng.native_plane is not None else "python",
           "scheduler": type(pol).__name__,
           "round_windows": getattr(pol, "round_windows", None),
           "tally": type(tally).__name__}
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


def run_tor10k(trace: bool = False, policy: str = "tpu",
               dataplane: str = "auto", cost_model: str = "") -> dict:
    """The tor10k slice through Controller.run on cuda, with every kernel
    count set to 0 just before it and read just after (``cost_model``:
    the ``--cost-model`` path; the scrape's ``prof.*`` in the result)."""
    import dataclasses
    import torch
    from shadow_tpu_torch.core.checkpoint import state_digest
    from shadow_tpu_torch.core.controller import Controller
    from shadow_tpu_torch.core.logger import SimLogger, set_logger
    from shadow_tpu_torch.ops import round_step as rs
    from shadow_tpu_torch.ops import torcells_device as td
    set_logger(SimLogger(level="warning"))
    ctl = Controller(dataclasses.replace(
        tor10k_options(), scheduler_policy=policy, dataplane=dataplane,
        cost_model=cost_model), tor10k_config())
    td.torcells_span.launches = 0
    td.pack_flush.launches = 0
    rs.packet_hop_mapped.launches = rs.packet_hop_packed.launches = 0
    with card_trace(trace) as prof:
        t0 = time.perf_counter()
        rc = ctl.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    span_l, pack_l = td.torcells_span.launches, td.pack_flush.launches
    hop_l = rs.packet_hop_mapped.launches
    if rs.packet_hop_packed.launches:
        fail(f"tor10k: {rs.packet_hop_packed.launches} hops on device "
             "operands: every round must run on its host-resident buffers")
    eng = ctl.engine
    plane = eng.device_plane
    st = plane.stats()
    kern = getattr(eng.scheduler.policy, "_kernel", None)
    out = {"slice": "tor10k", "policy": policy, "rc": rc,
           "hosts": len(eng.hosts),
           "plane": "C" if eng.native_plane is not None else "python",
           "digest": state_digest(eng), "events": eng.events_executed,
           "rounds": eng.rounds_executed, "completed": st["completed"],
           "forwards": st["forwards"], "dispatches": st["dispatches"],
           "steps": st["steps"], "superwindows": st["superwindows"],
           "rounds_per_launch": st["rounds_per_launch"],
           "mode": st["mode"], "recoveries": st["recoveries"],
           "demoted": st["demoted"], "span_launches": span_l,
           "pack_launches": pack_l, "hop_launches": hop_l,
           "hop_calls": kern.device_calls if kern else 0,
           "host_calls": kern.host_calls if kern else 0,
           "flows": plane.n_flows, "chains": plane.n_chains,
           "nodes": plane.n_nodes, "ring_len": plane.ring_len,
           "wall_s": wall, "host_exec_s": eng.host_exec_ns * 1e-9,
           "flush_s": eng.flush_ns * 1e-9,
           "plane_host_s": st["plane_host_sec"],
           "plane_collect_s": st["plane_device_sec"],
           "pipeline_overlap_s": st["pipeline_overlap_sec"],
           "hop_device_ns": getattr(eng.scheduler.policy, "device_ns", 0),
           "events_per_s": eng.events_executed / wall}
    out.update({k: v for k, v in eng.metrics.scrape().items()
                if k.startswith("prof.")})
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


# ---------------------------------------------------------------------------
# The analyzers: the port's static analysis over this checkout, and the
# runtime twin of SIM302, a sync audit of the tor10k slice
# ---------------------------------------------------------------------------

ANALYZERS = (("simlint", ()), ("simrace", ()),
             ("simtwin", ("shadow_tpu_torch", "native")), ("simjit", ()))
ANALYZER_TIMEOUT_S = 300
SYNC_WARNING = "synchronizing CUDA operation"


def run_static_analyzers() -> dict:
    """python -m shadow_tpu_torch.analysis.{simlint,simrace,simtwin,simjit}
    --json, simgen --check and simjit --sync-sites over this checkout, one
    process each, all started together.  Each must exit 0 with no
    unsuppressed finding.  Returns {tool: report} and the designed sync
    sites."""
    env = dict(os.environ)
    env["PYTHONPATH"] = HERE + os.pathsep + env.get("PYTHONPATH", "")
    mod = "shadow_tpu_torch.analysis."
    cmds = {tool: [sys.executable, "-m", mod + tool, "--json", *paths]
            for tool, paths in ANALYZERS}
    cmds["simgen"] = [sys.executable, "-m", mod + "simgen", "--check"]
    cmds["sync-sites"] = [sys.executable, "-m", mod + "simjit",
                          "--sync-sites"]
    t0 = time.perf_counter()
    procs = {k: subprocess.Popen(c, cwd=HERE, env=env, text=True,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE)
             for k, c in cmds.items()}
    outs = {}
    for k, proc in procs.items():
        try:
            out, err = proc.communicate(timeout=ANALYZER_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs.values():
                q.kill()
                q.communicate()
            fail(f"analyzers: {k} ran past {ANALYZER_TIMEOUT_S} s")
        if proc.returncode != 0:
            fail(f"analyzers: {' '.join(cmds[k][2:])} exited "
                 f"{proc.returncode}:\n{out[-4000:]}{err[-4000:]}")
        outs[k] = out
    reports = {}
    for tool, _paths in ANALYZERS:
        rep = json.loads(outs[tool])
        if rep["findings"]:
            fail(f"analyzers: {tool} has {len(rep['findings'])} "
                 f"unsuppressed findings: {rep['findings'][:3]}")
        reports[tool] = {"files": rep["files"],
                         "suppressed": rep["summary"]["suppressed"],
                         "findings": rep["summary"]["findings"]}
        print(f"{tool}: {rep['files']} files, 0 findings, "
              f"{rep['summary']['suppressed']} suppressed", flush=True)
    gen_line = outs["simgen"].strip().splitlines()[-1]
    reports["simgen"] = {"summary": gen_line}
    print(gen_line, flush=True)
    sites = json.loads(outs["sync-sites"])
    reports["wall_s"] = time.perf_counter() - t0
    print(f"static analyzers: {reports['wall_s']:.2f} s (one process each, "
          f"in parallel); {len(sites)} designed sync sites", flush=True)
    return {"reports": reports, "sites": sites}


class SyncAudit:
    """What :func:`sync_audit` records: ``counts[(path, line, kind,
    in_window)]`` and the dispatch windows it saw open."""

    def __init__(self):
        self.counts: dict = {}
        self.window = False
        self.windows = 0
        self.explicit = 0


@contextlib.contextmanager
def sync_audit():
    """Record the port's synchronizing calls while the block runs: every
    implicit sync torch flags under ``set_sync_debug_mode("warn")`` and
    every explicit one (``Event.synchronize``, ``Stream.synchronize``,
    ``torch.cuda.synchronize``, which the debug mode may not flag), each at
    the innermost frame of shadow_tpu_torch that made it, and whether a
    device-plane dispatch was in flight (from a dispatch's launch to its
    collect).  Yields the :class:`SyncAudit`."""
    import warnings
    import torch
    from shadow_tpu_torch.parallel.device_plane import DeviceTrafficPlane
    if not hasattr(torch.cuda, "set_sync_debug_mode"):
        fail("sync audit: torch.cuda.set_sync_debug_mode is missing")
    port = os.path.join(os.path.realpath(HERE), "shadow_tpu_torch") + os.sep
    skip = os.path.join(port, "analysis") + os.sep
    audit = SyncAudit()
    paths: dict = {}

    def record(kind: str) -> None:
        site = ("(outside the port)", 0)
        frame = sys._getframe(1)
        while frame is not None:
            fn = frame.f_code.co_filename
            rel = paths.get(fn)
            if rel is None:
                real = os.path.realpath(fn)
                rel = paths[fn] = (
                    os.path.relpath(real, os.path.realpath(HERE)).replace(
                        os.sep, "/")
                    if real.startswith(port) and not real.startswith(skip)
                    else "")
            if rel:
                site = (rel, frame.f_lineno)
                break
            frame = frame.f_back
        key = (*site, kind, audit.window)
        audit.counts[key] = audit.counts.get(key, 0) + 1

    shown = warnings.showwarning

    def on_warning(message, category, filename, lineno, file=None,
                   line=None):
        if SYNC_WARNING in str(message):
            if not audit.explicit:
                record("implicit")
            return
        shown(message, category, filename, lineno, file, line)

    def explicit(orig):
        def wrapped(*args, **kwargs):
            record("explicit")
            audit.explicit += 1
            try:
                return orig(*args, **kwargs)
            finally:
                audit.explicit -= 1
        return wrapped

    def launched(orig):
        def wrapped(self, *args, **kwargs):
            out = orig(self, *args, **kwargs)
            audit.window = True
            audit.windows += 1
            return out
        return wrapped

    def collecting(orig):
        def wrapped(self, *args, **kwargs):
            audit.window = False
            return orig(self, *args, **kwargs)
        return wrapped

    patches = [(torch.cuda.Event, "synchronize", explicit),
               (torch.cuda.Stream, "synchronize", explicit),
               (torch.cuda, "synchronize", explicit),
               (DeviceTrafficPlane, "_launch", launched),
               (DeviceTrafficPlane, "consume", collecting)]
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = on_warning
        for obj, name, wrap in patches:
            setattr(obj, name, wrap(getattr(obj, name)))
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield audit
        finally:
            torch.cuda.set_sync_debug_mode("default")
            for obj, name, orig in saved:
                setattr(obj, name, orig)


def audit_probe(audit: SyncAudit) -> None:
    """The audit sees what it must: inside a window opened by hand, an
    implicit sync (``.item()`` of a tensor on the card) and an explicit
    one (``Event.synchronize``) are each recorded, in the window."""
    import torch
    audit.window = True
    x = torch.ones(4, device="cuda").sum()
    x.item()
    ev = torch.cuda.Event()
    ev.record()
    ev.synchronize()
    audit.window = False
    seen = {(k[2], k[3]): n for k, n in audit.counts.items()}
    if set(seen) != {("implicit", True), ("explicit", True)}:
        fail(f"sync audit: the probe's two syncs were recorded as {seen}")
    audit.counts.clear()


def run_analyzers() -> dict:
    """The analyzers phase: the static pass, then tor10k (the tor10k phase's
    config, tpu policy, on the card, not traced) under the sync audit: its
    digest, events and completed flows equal to EXPECTED10K, and every
    sync made while a dispatch was in flight at a site the static pass
    knows as designed (simjit's SIM302 pragmas, reads of an in-flight
    handle's attributes, explicit syncs)."""
    t0 = time.perf_counter()
    static = run_static_analyzers()
    known = static["sites"]
    with sync_audit() as audit:
        audit_probe(audit)
        run = run_tor10k()
    check_tor10k(run)
    counts, windows = audit.counts, audit.windows
    if windows != run["dispatches"]:
        fail(f"sync audit: saw {windows} dispatch windows for "
             f"{run['dispatches']} dispatches")

    def designed(path: str, line: int):
        for s in known:
            if s["path"] == path and s["line"] <= line <= s["end_line"]:
                return s
        return None

    rows, unknown = [], []
    for (path, line, kind, in_window), n in sorted(counts.items(),
                                                   key=lambda kv: -kv[1]):
        site = designed(path, line)
        how = ("unlisted" if site is None else
               "handle" if site["handle"] else "pragma")
        rows.append({"site": f"{path}:{line}", "kind": kind,
                     "in_window": in_window, "count": n, "designed": how})
        if in_window and site is None:
            unknown.append(f"{path}:{line} ({kind}, {n}x)")
    for r in rows:
        print(f"  sync {r['site']} {r['kind']} "
              f"{'in the window' if r['in_window'] else 'outside it'}: "
              f"{r['count']} ({r['designed']})", flush=True)
    if unknown:
        fail("sync audit: syncs inside the dispatch window at sites the "
             f"static SIM302 pass does not know: {', '.join(unknown)}")
    out = {"static": static["reports"], "syncs": rows, "windows": windows,
           "tor10k_wall_s": run["wall_s"], "digest": run["digest"],
           "events": run["events"], "completed": run["completed"],
           "wall_s": time.perf_counter() - t0}
    print(f"sync audit: tor10k under set_sync_debug_mode('warn'): wall "
          f"{run['wall_s']:.3f} s, digest {run['digest'][:16]}... events "
          f"{run['events']} completed {run['completed']} == JAX; "
          f"{sum(r['count'] for r in rows)} syncs at {len(rows)} sites, "
          f"{sum(r['count'] for r in rows if r['in_window'])} in the "
          f"{windows} dispatch windows, all at designed sites; phase wall "
          f"{out['wall_s']:.2f} s",
          flush=True)
    return out


# ---------------------------------------------------------------------------
# The native tier: the C data plane (parallel/native_plane.py), the
# retransmit tally, --processes N shards (parallel/procs.py) and native
# plugins (process/native.py), all over artifacts built from native/ into
# shadow_tpu_torch/native/ (utils/native_build.py)
# ---------------------------------------------------------------------------

# the resurrection drill: shard 1 of 2 hard-exits at this round of the
# tor1k tpu run, is respawned and replayed to the barrier
PROCS_DRILL_ROUND = 400
SLICE_KEYS = ("digest", "events", "rounds", "drops")


def run_native(tpu10k) -> dict:
    """tor1k under global on the C data plane and on the Python plane, and
    tor10k under global on the C plane (its cells still on the card
    through torcells_span + pack_flush, its wakes into the C event heap):
    each held to the JAX package's constants."""
    out = {}
    for plane in ("native", "python"):
        r = out[f"tor1k_{plane}"] = run_slice("global", dataplane=plane)
        for key in SLICE_KEYS:
            if r[key] != EXPECTED[key]:
                fail(f"tor1k global --dataplane={plane}: {key} {r[key]} != "
                     f"JAX run's {EXPECTED[key]}")
        if r["rc"] != 0 or r["launches"] != 0:
            fail(f"tor1k global --dataplane={plane}: rc {r['rc']}, "
                 f"{r['launches']} hop launches")
    c, py = out["tor1k_native"], out["tor1k_python"]
    if c["plane"] != "C" or c["scheduler"] != "NativeGlobalPolicy" \
            or not c["round_windows"]:
        fail(f"--dataplane=native ran the {c['plane']} plane under "
             f"{c['scheduler']} ({c['round_windows']} executor windows)")
    if py["plane"] != "python" or c["tally"] != "NativeTally":
        fail(f"--dataplane=python ran the {py['plane']} plane; the "
             f"retransmit tally is {c['tally']}")
    print(f"tor1k global: C plane wall {c['wall_s']:.3f} s "
          f"({c['events_per_s']:.0f} events/s, {c['round_windows']} "
          f"windows through the C round executor), Python plane wall "
          f"{py['wall_s']:.3f} s ({py['events_per_s']:.0f} events/s); "
          f"both == JAX; retransmit tally {c['tally']}", flush=True)
    r = out["tor10k"] = run_tor10k(policy="global", dataplane="native")
    if r["rc"] != 0 or r["plane"] != "C" or r["mode"] != "device" \
            or r["recoveries"] or r["demoted"]:
        fail(f"tor10k global: rc {r['rc']}, {r['plane']} plane, device "
             f"plane mode {r['mode']}, recoveries {r['recoveries']}")
    for key in ("digest", "events", "completed", "forwards"):
        if r[key] != EXPECTED10K[key]:
            fail(f"tor10k global on the C plane: {key} {r[key]} != JAX "
                 f"run's {EXPECTED10K[key]}")
    if not r["span_launches"] == r["pack_launches"] == r["dispatches"] > 0 \
            or r["hop_launches"]:
        fail(f"tor10k global: span launches {r['span_launches']}, pack "
             f"launches {r['pack_launches']}, dispatches "
             f"{r['dispatches']}, hop launches {r['hop_launches']}")
    tpu_wall = f"{tpu10k['wall_s']:.3f} s" if tpu10k else "not run"
    print(f"tor10k global on the C plane: digest {r['digest'][:16]}... "
          f"events {r['events']} completed {r['completed']} forwards "
          f"{r['forwards']} == JAX; {r['dispatches']} dispatches = "
          f"{r['span_launches']} span + {r['pack_launches']} pack launches; "
          f"wall {r['wall_s']:.3f} s (tpu in this call: {tpu_wall})",
          flush=True)
    return out


def run_procs_slice(policy: str, fault: str = "") -> dict:
    """tor1k with --processes 2 on cuda through the sharded coordinator;
    each shard's scrape (its hop device and launches) read from the
    parent's metrics summary."""
    import tempfile
    from shadow_tpu_torch.core.logger import SimLogger, set_logger
    from shadow_tpu_torch.core.options import Options
    from shadow_tpu_torch.obs.metrics import read_metrics_file
    from shadow_tpu_torch.parallel.procs import ProcsController
    set_logger(SimLogger(level="warning"))
    cfg = tor1k_config()
    with tempfile.TemporaryDirectory(prefix="smoke-procs-") as tmp:
        metrics = os.path.join(tmp, "metrics.jsonl")
        opts = Options(scheduler_policy=policy, device="cuda", processes=2,
                       seed=TOR1K["seed"], log_level="warning",
                       stop_time_sec=int(cfg.stop_time_sec),
                       metrics_path=metrics, fault_inject=fault,
                       data_directory=os.path.join(tmp, "data"))
        pc = ProcsController(opts, cfg)
        t0 = time.perf_counter()
        rc = pc.run()
        wall = time.perf_counter() - t0
        summary = [r for r in read_metrics_file(metrics)
                   if r.get("summary")][-1]
    shards = [{"device": m.get("hop.device"),
               "launches": m.get("hop.launches"),
               "device_calls": m.get("policy.device_calls"),
               "host_calls": m.get("policy.host_calls"),
               "round_windows": m.get("native.round_windows")}
              for m in summary["shards"]]
    out = {"policy": policy, "fault": fault, "rc": rc, "digest": pc.digest,
           "events": pc.events_executed, "rounds": pc.rounds_executed,
           "wall_s": wall, "shards": shards,
           "supervision": pc.supervision.summary()}
    print(json.dumps(out, default=str), flush=True)
    return out


def run_procs() -> dict:
    """tor1k with --processes 2 under global (C-plane shards) and under
    tpu with a shard killed at PROCS_DRILL_ROUND and resurrected: the tpu
    shards' run is the drill's (its checks are the plain tpu run's, and
    one run fewer keeps the smoke inside its time limit)."""
    out = {}
    for key, policy, fault in (
            ("global", "global", ""),
            ("resurrect", "tpu",
             f"shard-exit-resurrect:1:{PROCS_DRILL_ROUND}")):
        r = out[key] = run_procs_slice(policy, fault)
        if r["rc"] != 0:
            fail(f"tor1k {policy} --processes 2 {fault}: rc {r['rc']}")
        for k in ("digest", "events", "rounds"):
            if r[k] != EXPECTED[k]:
                fail(f"tor1k {policy} --processes 2 {fault}: {k} {r[k]} "
                     f"!= JAX run's {EXPECTED[k]}")
        for i, sh in enumerate(r["shards"]):
            if policy == "tpu" and not (
                    str(sh["device"]).startswith("cuda")
                    and sh["launches"] and sh["launches"] > 0
                    and sh["launches"] == sh["device_calls"]
                    and sh["host_calls"] == 0):
                fail(f"tor1k tpu shard {i}: {sh} (the hops must all run "
                     "through packet_hop on the card)")
            if policy == "global" and not sh["round_windows"]:
                fail(f"tor1k global shard {i}: not on the C plane ({sh})")
    sup = out["resurrect"]["supervision"]
    if sup["shard_resurrections"] != 1 or sup["shard_deaths_detected"] != 1:
        fail(f"the resurrection drill: {sup}")
    g, d = out["global"], out["resurrect"]
    print(f"tor1k --processes 2: global (C-plane shards) wall "
          f"{g['wall_s']:.3f} s; tpu with a shard resurrected at round "
          f"{PROCS_DRILL_ROUND}: wall {d['wall_s']:.3f} s, mttr "
          f"{sup['mttr_sec']:.3f} s, shards' packet_hop launches "
          f"{[sh['launches'] for sh in d['shards']]} on "
          f"{[sh['device'] for sh in d['shards']]}; both == JAX", flush=True)
    return out


# A two-host real-binary TCP transfer (exec:) and six pooled UDP pairs
# (pool:), tests/native_src/testapp.c compiled with cc.  EXPECTED_PLUGINS
# was made with the JAX package on the CPU under global;
# tests/test_torch_native_slices.py reproduces it (pytest -m slow) and
# holds the port's CPU runs under global and tpu to it.
PLUGIN_STOP = {"exec": 60, "pool": 30}
EXPECTED_PLUGINS = {
    "exec": {"digest": "596a91254df6a46d3be37974d5cca2ff"
                       "6a97a8064c6110c0a43df3f694248294", "events": 182},
    "pool": {"digest": "844cc188672e76bc02569401591dcf5e"
                       "71bf780ff7b80e8afe66682ce2871eeb", "events": 60},
}


def plugin_binaries(out_dir: str) -> dict:
    """testapp.c as an executable and as a pooled .so linked against the
    port's shim (built first), compiled with cc into ``out_dir``."""
    from shadow_tpu_torch.utils import native_build as nb
    lib_dir = nb.ensure_plugins()
    src = os.path.join(HERE, "tests", "native_src", "testapp.c")
    app, so = os.path.join(out_dir, "testapp"), \
        os.path.join(out_dir, "testapp.so")
    for cmd in (["cc", "-O1", "-o", app, src, "-lpthread"],
                ["cc", "-O1", "-fPIC", "-shared", "-o", so, src, "-L",
                 lib_dir, "-l:libshadow_preload.so", "-lpthread"]):
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if r.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)}: {r.stderr}")
    return {"exec": app, "pool": so}


def plugin_config(kind: str, path: str) -> str:
    """The exec: transfer or the pooled UDP pairs, as XML."""
    def host(name, start, args):
        return (f'<host id="{name}" bandwidthdown="10240" '
                f'bandwidthup="10240"><process plugin="app" '
                f'starttime="{start}" arguments="{args}" /></host>')
    if kind == "exec":
        hosts = [host("server", 1, "tcpserver 8001 100000"),
                 host("client", 2, "tcpclient server 8001 100000")]
    else:
        hosts = [host(f"{r}{i}", 1 + (r == "c"),
                      f"udpserver {8100 + i} 2" if r == "s"
                      else f"udpclient s{i} {8100 + i} 2 300")
                 for i in range(6) for r in "sc"]
    return (f'<shadow stoptime="{PLUGIN_STOP[kind]}"><plugin id="app" '
            f'path="{kind}:{path}" />' + "".join(hosts) + "</shadow>")


def run_plugins() -> dict:
    """The exec: and pool: configs under global and under tpu on cuda:
    every binary exits 0, the digests equal the JAX package's, and under
    tpu the hops go through packet_hop."""
    import tempfile
    from shadow_tpu_torch.core import configuration
    from shadow_tpu_torch.core.checkpoint import state_digest
    from shadow_tpu_torch.core.controller import Controller
    from shadow_tpu_torch.core.logger import SimLogger, set_logger
    from shadow_tpu_torch.core.options import Options
    from shadow_tpu_torch.ops import round_step as rs
    set_logger(SimLogger(level="warning"))
    out = {}
    with tempfile.TemporaryDirectory(prefix="smoke-plugins-") as tmp:
        bins = plugin_binaries(tmp)
        for kind, path in bins.items():
            stop = PLUGIN_STOP[kind]
            for policy in ("global", "tpu"):
                ctl = Controller(Options(
                    scheduler_policy=policy, device="cuda", seed=1,
                    stop_time_sec=stop, log_level="warning",
                    data_directory=os.path.join(tmp, f"{kind}-{policy}")),
                    configuration.parse_xml(plugin_config(kind, path)))
                rs.packet_hop_mapped.launches = 0
                rs.packet_hop_packed.launches = 0
                t0 = time.perf_counter()
                rc = ctl.run()
                wall = time.perf_counter() - t0
                eng = ctl.engine
                kern = getattr(eng.scheduler.policy, "_kernel", None)
                codes = sorted({p.exit_code for h in eng.hosts.values()
                                for p in h.processes}, key=str)
                r = out[f"{kind}_{policy}"] = {
                    "rc": rc, "digest": state_digest(eng),
                    "events": eng.events_executed, "codes": codes,
                    "wall_s": wall, "launches": rs.packet_hop_mapped.launches,
                    "hop_calls": kern.device_calls if kern else 0,
                    "host_calls": kern.host_calls if kern else 0}
                print(json.dumps({"plugins": f"{kind}:{policy}", **r}),
                      flush=True)
                if rc != 0 or codes != [0]:
                    fail(f"{kind}: plugin under {policy}: rc {rc}, exit "
                         f"codes {codes}")
                for key, want in EXPECTED_PLUGINS[kind].items():
                    if r[key] != want:
                        fail(f"{kind}: plugin under {policy}: {key} "
                             f"{r[key]} != JAX run's {want}")
                if policy == "tpu" and not (
                        r["launches"] == r["hop_calls"] > 0
                        and r["host_calls"] == 0):
                    fail(f"{kind}: plugin under tpu: {r['launches']} "
                         f"packet_hop launches for {r['hop_calls']} hop "
                         f"calls ({r['host_calls']} on the host)")
    print("native plugins: exec: and pool: under global and tpu == JAX; "
          + ", ".join(f"{k} {v['wall_s']:.3f} s" for k, v in out.items()),
          flush=True)
    return out


# ---------------------------------------------------------------------------
# The fleet plane: W simulations per launch (torcells_span_batched +
# pack_flush_batched)
# ---------------------------------------------------------------------------

# The sweep: the genscen tor10k preset (10,000 hosts: 1,000 relays, 100
# servers, 8,900 clients on seeded 3-hop circuits, every transfer a
# processless 5-hop device chain, 8 stagger waves, stoptime 300) drawn with
# seeds 1..8, one fleet lane each, Options(seed=s, host_table="on",
# workers=0, heartbeat off) under --scheduler-policy=global.  EXPECTED_SWEEP1
# is lane 1 (seed 1) as the JAX package runs it on the CPU (its device plane
# on one XLA CPU device and its numpy twin agree); tests/test_torch_sweep.py
# reproduces it (pytest -m slow) and holds the port's CPU run to it.
SWEEP = {"preset": "tor10k", "seeds": (1, 2, 3, 4, 5, 6, 7, 8),
         "stoptime": 300}
EXPECTED_SWEEP1 = {
    "digest": "024c44fd1dee9399095514c5727d1e26"
              "452d12640f8f3f723ac39d5fdc98328f",
    "events": 0,
    "rounds": 11,
    "completed": 8900,
    "forwards": 4583500,
    "dispatches": 9,
}
FLEET_WIDTHS = (1, 2, 4, 8)
FLEET_TIME_TICKS = 64          # per timed dispatch: 8 boundaries, 8 apart


def sweep_options(seed: int, device: str = "cuda"):
    from shadow_tpu_torch.core.options import Options
    return Options(scheduler_policy="global", device=device, workers=0,
                   seed=seed, host_table="on", heartbeat_interval_sec=0,
                   stop_time_sec=SWEEP["stoptime"], log_level="warning")


def sweep_config(seed: int):
    from shadow_tpu_torch.scale import genscen
    return genscen.build(SWEEP["preset"], seed=seed,
                         stoptime=SWEEP["stoptime"])


def sweep_plane(seed: int):
    """Lane ``seed``'s device plane as its run builds it (hosts booted as
    table rows, flow table uploaded to the card), without running it."""
    from shadow_tpu_torch.core.controller import Controller
    from shadow_tpu_torch.core.logger import SimLogger, set_logger
    from shadow_tpu_torch.parallel.device_plane import build_plane_from_engine
    set_logger(SimLogger(level="warning"))
    ctl = Controller(sweep_options(seed), sweep_config(seed))
    ctl.setup()
    plane = build_plane_from_engine(ctl.engine)
    plane._flow_args()
    return plane


def plane_state_bytes(f: int, h: int, c: int, lr: int) -> dict:
    """Bytes of a plane's carried state (queued, delivered, target,
    done_tick per flow; tokens, node_sent per node; the int32 ring) and of
    its static tables (flow_node, flow_lat, flow_succ, seg_start, arr_lat
    per flow; refill, capacity, node_off per node; last_flow per chain)."""
    return {"state": 8 * (4 * f + 2 * h) + 4 * lr * f,
            "tables": 8 * (5 * f + 3 * h + c)}


def fleet_lanes(planes):
    """A cuda FleetPlane with one lane attached to each plane; all share
    one shape class (printed with each lane's real shapes)."""
    from shadow_tpu_torch.fleet.plane import FleetPlane
    fp = FleetPlane(device="cuda")
    lanes = []
    for seed, pl in zip(SWEEP["seeds"], planes):
        ln = fp.lane()
        ln.attach_plane(pl)
        lanes.append(ln)
        sb = plane_state_bytes(pl.n_flows, pl.n_nodes, pl.n_chains,
                               pl.ring_len)
        print(f"lane seed {seed}: F {pl.n_flows} C {pl.n_chains} H "
              f"{pl.n_nodes} ring_len {pl.ring_len} (state {sb['state']} "
              f"B, tables {sb['tables']} B)", flush=True)
    if len({ln.cls.key for ln in lanes}) != 1:
        fail(f"the sweep's lanes fall in several shape classes: "
             f"{sorted({ln.cls.key for ln in lanes})}")
    cls = lanes[0].cls
    sb = plane_state_bytes(cls.f2, cls.h2, cls.c2, cls.ring_len)
    print(f"class: F2 {cls.f2} H2 {cls.h2} C2 {cls.c2} P2 {cls.p2} "
          f"ring_len {cls.ring_len} (padded state {sb['state']} B, tables "
          f"{sb['tables']} B per lane)", flush=True)
    return fp, lanes


def _pad_lane_state(cls, plane, st, inj, inj_t, tv, idle):
    """A real-shaped numpy dispatch padded into the class as the fleet
    stages it: zero rows, done_tick -1, targets repeating the last."""
    import numpy as np
    from shadow_tpu_torch.fleet.plane import _pad_vec
    from shadow_tpu_torch.ops.torcells_device import RING_DTYPE
    f, f2, h2 = plane.n_flows, cls.f2, cls.h2
    ring = np.zeros((cls.ring_len, f2), RING_DTYPE)
    ring[:, :f] = st[2]
    return (np.int64(st[0]), _pad_vec(st[1], f2), ring, _pad_vec(st[3], h2),
            _pad_vec(st[4], f2), _pad_vec(st[5], f2),
            _pad_vec(st[6], f2, -1), _pad_vec(st[7], h2), _pad_vec(inj, f2),
            _pad_vec(inj_t, f2), _pad_vec(tv, cls.p2, int(tv[-1])),
            np.int64(idle))


def fleet_batch(fp, lanes, rows, width: int):
    """Numpy [W]-leading operands (state, injections, targets, idle) of
    ``rows`` (one real dispatch per lane) topped up with filler rows, and
    the stacked tables on the card: (numpy 12-tuple, tables, span tables)."""
    import numpy as np
    import torch
    from shadow_tpu_torch.ops.torcells_device import BatchedSpanTables
    cls = lanes[0].cls
    padded = [_pad_lane_state(cls, ln_plane, *row)
              for (ln_plane, row) in rows]
    z = np.zeros(cls.f2, np.int64)
    from shadow_tpu_torch.ops.torcells_device import RING_DTYPE
    filler = (np.int64(0), z, np.zeros((cls.ring_len, cls.f2), RING_DTYPE),
              np.zeros(cls.h2, np.int64), z, z, np.full(cls.f2, -1, np.int64),
              np.zeros(cls.h2, np.int64), z, z, np.zeros(cls.p2, np.int64),
              np.int64(0))
    padded += [filler] * (width - len(padded))
    batch = tuple(np.stack([np.asarray(r[i]) for r in padded])
                  for i in range(12))
    # each lane's seven flow tables and derived node_off, meta, tiles
    trows = [ln._tables for ln in lanes[:len(rows)]]
    trows += [cls.filler_tables(fp.device)] * (width - len(rows))
    stacked = [torch.stack([r[i] for r in trows]) for i in range(10)]
    return batch, tuple(stacked[:7]), BatchedSpanTables(*stacked[7:])


def _on_card(batch):
    """The numpy operands as fresh card tensors (t0, idle stay numpy)."""
    import torch
    dev = torch.device("cuda", 0)
    return (batch[0], *(torch.as_tensor(a.copy(), device=dev)
                        for a in batch[1:10]),
            batch[10], batch[11])


def fleet_cases(planes):
    """One dispatch per lane for the check: seven real lanes at different
    t0s and spans — a halt mid-span, an idle fold (ring cleared), an
    injection on the base boundary, and four lanes with no target that run
    their whole (different) spans — the eighth row the filler."""
    import numpy as np
    rng = np.random.default_rng(30)
    rows = []
    for w, pl in enumerate(planes[:7]):
        f = pl.n_flows
        zero = np.zeros(f, dtype=np.int64)
        t0 = 3000 + 1000 * w
        st = busy_state(pl, rng, t0)
        inj, inj_t, idle = zero, zero, 0
        tv = t0 + 4 * np.arange(1, 9)
        if w == 1:
            tv, idle = np.array([t0 + 12] * 8), 9
        elif w == 2:
            inj = np.zeros(f, dtype=np.int64)
            inj_t = np.zeros(f, dtype=np.int64)
            k = min(2000, pl.n_chains // 2)
            chains = rng.choice(pl.n_chains, size=k, replace=False)
            cells = rng.integers(1, 300, size=k)
            inj[pl.first_flow[chains]] = cells
            inj_t[pl.last_flow[chains]] = cells
            tv = t0 + 6 * np.arange(1, 9)
        elif w >= 3:
            st = list(st)
            st[5] = np.zeros(f, dtype=np.int64)     # no target: no halt
            tv = t0 + (2 + w) * np.arange(1, 9)
        rows.append((pl, (st, inj, inj_t, tv, idle)))
    return rows


def check_fleet_kernels(planes, fp, lanes) -> dict:
    """The batched span + pack kernels at the sweep's class (W = 8) against
    the plain batched version on the card, the numpy twin, and W serial
    torcells_span + pack_flush launches on each lane's real rows: bit-exact
    on all ten outputs.  Then the batched pack alone against its plain
    version.  Returns the largest absolute differences (0)."""
    import numpy as np
    import torch
    from shadow_tpu_torch.fleet.plane import _repack_flush
    from shadow_tpu_torch.ops import torcells_device as td
    names = ("t_stop", "queued", "ring", "tokens", "delivered", "target",
             "done_tick", "node_sent", "forwards", "flush")
    rows = fleet_cases(planes)
    batch, tables, span = fleet_batch(fp, lanes, rows, 8)
    cls = lanes[0].cls
    lr = cls.ring_len
    s0 = td.torcells_span_batched.launches
    p0 = td.pack_flush_batched.launches
    kern = td.torcells_step_span_flush_batched(
        *_on_card(batch)[:10], batch[10], batch[11], *tables, ring_len=lr,
        tables=span)
    torch.cuda.synchronize()
    if (td.torcells_span_batched.launches, td.pack_flush_batched.launches) \
            != (s0 + 1, p0 + 1):
        fail("the batched span/pack wrappers did not count one launch each")
    kern = [o.cpu().numpy() for o in kern]
    plain = td.torcells_step_span_flush_batched_torch(
        *_on_card(batch)[:10], batch[10], batch[11], *tables, ring_len=lr)
    torch.cuda.synchronize()
    plain = [o.cpu().numpy() for o in plain]
    twin = td.torcells_step_span_batched_numpy(
        *(np.array(a) for a in batch), *(t.cpu().numpy() for t in tables),
        ring_len=lr)
    max_err = 0
    for i, name in enumerate(names):
        for label, other in (("plain version", plain), ("numpy twin", twin)):
            a, b = kern[i], np.asarray(other[i])
            if a.shape != b.shape or a.dtype != b.dtype:
                fail(f"fleet kernels: {name} shape/dtype {a.shape} "
                     f"{a.dtype} != {label} {b.shape} {b.dtype}")
            err = int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max())
            max_err = max(max_err, err)
            if err:
                fail(f"fleet kernels: {name} differs from the {label} "
                     f"(max |diff| {err})")
    # W serial launches on each lane's real-shaped rows
    for w, (pl, (st, inj, inj_t, tv, idle)) in enumerate(rows):
        f, h, c = pl.n_flows, pl.n_nodes, pl.n_chains
        state = pl._to_device(st)
        ser = td.torcells_step_window_flush(
            *state, torch.as_tensor(inj, device="cuda"),
            torch.as_tensor(inj_t, device="cuda"), tv, idle,
            *pl._flow_args(), ring_len=lr, tables=pl._span_tables)
        torch.cuda.synchronize()
        ser = [o.cpu().numpy() for o in ser]
        got = (kern[0][w], kern[1][w][:f], kern[2][w][:, :f],
               kern[3][w][:h], kern[4][w][:f], kern[5][w][:f],
               kern[6][w][:f], kern[7][w][:h], kern[8][w],
               _repack_flush(kern[9][w], cls.c2, cls.h2, c, h))
        for i, name in enumerate(names):
            if not np.array_equal(got[i], ser[i]):
                fail(f"fleet kernels: lane {w} {name} differs from its "
                     "serial torcells_span + pack_flush launch")
        print(f"lane {w}: t0 {st[0]} -> t_stop {int(kern[0][w])} of "
              f"{int(tv[-1])}, idle {idle}, forwards {int(kern[8][w])}, "
              f"chains done {int(kern[9][w][2])}, nodes touched "
              f"{int(kern[9][w][3])}: batched == plain == twin == serial "
              "launch, bit-exact", flush=True)
    if not int(kern[0][0]) < int(rows[0][1][3][-1]):
        fail("the halt lane did not halt before its last boundary")
    if int(kern[0][7]) != 0 or int(kern[8][7]) != 0:
        fail("the filler row moved")
    if len({int(x) for x in kern[0][:7]}) < 5:
        fail("the lanes did not stop at different ticks")
    # the batched pack alone, on the span kernel's outputs
    st_t = _on_card(batch)
    args = td.lane_args(batch[0], batch[11], batch[10], "cuda")
    t_stop, done_in, sent_in = td.torcells_span_batched(
        *st_t[1:10], tables[4], tables[5], tables[6], args, lr, span)
    pk = td.pack_flush_batched(t_stop, done_in, st_t[6], tables[6], st_t[4],
                               sent_in, st_t[7])
    pp = td.pack_flush_batched_torch(t_stop, done_in, st_t[6], tables[6],
                                     st_t[4], sent_in, st_t[7])
    torch.cuda.synchronize()
    pack_err = max(int((pk[0] - pp[0]).abs().max()),
                   int((pk[1] - pp[1]).abs().max()))
    if pack_err:
        fail(f"pack_flush_batched differs from its plain version "
             f"(max |diff| {pack_err})")
    print(f"fleet kernels at W = 8 (7 lanes + 1 filler): max_abs_err "
          f"{max_err}; pack_flush_batched alone == plain, max_abs_err "
          f"{pack_err}", flush=True)
    return {"span_b_err": max_err, "pack_b_err": pack_err}


def _held_to_plain(label, kern, plain) -> int:
    """Fail unless the kernels' ten outputs equal the plain version's
    (numpy lists); returns the largest absolute difference (0)."""
    import numpy as np
    names = ("t_stop", "queued", "ring", "tokens", "delivered", "target",
             "done_tick", "node_sent", "forwards", "flush")
    for name, a, b in zip(names, kern, plain):
        if a.shape != b.shape or a.dtype != b.dtype:
            fail(f"{label}: {name} shape/dtype {a.shape} {a.dtype} != plain "
                 f"{b.shape} {b.dtype}")
        err = int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max()) \
            if a.size else 0
        if err:
            fail(f"{label}: {name} differs from the plain version (max "
                 f"|diff| {err})")
    return 0


def check_fleet_widths(planes, fp, lanes) -> int:
    """The batched kernels at W = 1, 2 and 4 on the sweep lanes' first
    rows of fleet_cases (no filler), bit-exact against the plain batched
    version on the card."""
    import torch
    from shadow_tpu_torch.ops import torcells_device as td
    rows = fleet_cases(planes)
    lr = lanes[0].cls.ring_len
    for width in (1, 2, 4):
        batch, tables, span = fleet_batch(fp, lanes, rows[:width], width)
        kern = td.torcells_step_span_flush_batched(
            *_on_card(batch)[:10], batch[10], batch[11], *tables,
            ring_len=lr, tables=span)
        plain = td.torcells_step_span_flush_batched_torch(
            *_on_card(batch)[:10], batch[10], batch[11], *tables,
            ring_len=lr)
        torch.cuda.synchronize()
        _held_to_plain(f"fleet kernels at W = {width}",
                       [o.cpu().numpy() for o in kern],
                       [o.cpu().numpy() for o in plain])
        print(f"fleet kernels at W = {width} (sweep lanes): == plain "
              f"version bit-exact; t_stop {kern[0].tolist()}", flush=True)
    return 0


def check_long_node_batched(table) -> int:
    """The batched kernels on two lanes of the long-node table (nodes of
    ~600 flows, longer than a tile and a chunk), one halting mid-span and
    one idle-folded, bit-exact against the plain batched version."""
    import numpy as np
    import torch
    from shadow_tpu_torch.ops import torcells_device as td
    rng = np.random.default_rng(32)
    f = table.n_flows
    zero = np.zeros(f, dtype=np.int64)
    rows = []
    for t0, idle in ((4000, 0), (6000, 5)):
        st = busy_state(table, rng, t0)
        rows.append((*st, zero, zero, t0 + 4 * np.arange(1, 9),
                     np.int64(idle)))
    batch = tuple(np.stack([np.asarray(r[i]) for r in rows])
                  for i in range(12))
    tables = tuple(torch.stack([a] * 2) for a in table._flow_args())
    lr = table.ring_len

    def run(fn, **kw):
        out = fn(batch[0], *(torch.as_tensor(a.copy(), device="cuda")
                             for a in batch[1:10]), batch[10], batch[11],
                 *tables, ring_len=lr, **kw)
        torch.cuda.synchronize()
        return [o.cpu().numpy() for o in out]
    kern = run(td.torcells_step_span_flush_batched)
    _held_to_plain("batched kernels on the long-node table", kern,
                   run(td.torcells_step_span_flush_batched_torch))
    print(f"fleet kernels on the long-node table (W = 2, longest node "
          f"{table.longest} flows): == plain version bit-exact; t_stop "
          f"{kern[0].tolist()}, forwards {kern[8].tolist()}", flush=True)
    return 0


def time_fleet(planes, fp, lanes) -> dict:
    """One batched dispatch (span + pack) at W lanes against W serial
    dispatches (torcells_span + pack_flush each), FLEET_TIME_TICKS ticks
    with no completion, by CUDA events with the state restored between
    launches outside the timed interval; the span and pack kernels alone at
    W = 8; the plain versions on the same inputs; each beside its bound (W
    lanes' work by span_bound's and pack_bound's rules)."""
    import numpy as np
    import torch
    from shadow_tpu_torch.ops import torcells_device as td
    rng = np.random.default_rng(31)
    cls = lanes[0].cls
    lr = cls.ring_len
    rows = []
    for w, pl in enumerate(planes):
        st = list(busy_state(pl, rng, 20000))
        st[5] = np.zeros(pl.n_flows, dtype=np.int64)
        zero = np.zeros(pl.n_flows, dtype=np.int64)
        rows.append((pl, (st, zero, zero,
                          20000 + (FLEET_TIME_TICKS // 8)
                          * np.arange(1, 9), 0)))
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)

    def timed(run, restore, reps=5):
        total = 0.0
        for r in range(reps + 1):
            restore()
            torch.cuda._sleep(2_000_000)
            e0.record()
            run()
            e1.record()
            torch.cuda.synchronize()
            if r:
                total += e0.elapsed_time(e1)
        return total / reps

    out = {}
    for width in FLEET_WIDTHS:
        batch, tables, span = fleet_batch(fp, lanes, rows[:width], width)
        saved = _on_card(batch)
        live = [a.clone() for a in saved[1:10]]
        args = td.lane_args(batch[0], batch[11], batch[10], "cuda")

        def restore():
            for a, b in zip(live, saved[1:10]):
                a.copy_(b)

        def batched():
            td.torcells_step_span_flush_batched(
                batch[0], *live, batch[10], batch[11], *tables, ring_len=lr,
                tables=span)
        ms = timed(batched, restore)
        # W serial dispatches on the lanes' real rows
        ser_saved = [(pl, pl._to_device(r[0])) for pl, r in rows[:width]]
        ser_live = [(pl, [a.clone() for a in s[1:]]) for pl, s in ser_saved]
        zeros = [torch.zeros(pl.n_flows, dtype=torch.int64, device="cuda")
                 for pl, _ in rows[:width]]
        tv = rows[0][1][3]

        def ser_restore():
            for (_, lv), (_, sv) in zip(ser_live, ser_saved):
                for a, b in zip(lv, sv[1:]):
                    a.copy_(b)

        def serial():
            for (pl, lv), z in zip(ser_live, zeros):
                td.torcells_step_window_flush(
                    20000, *lv, z, z, tv, 0, *pl._flow_args(),
                    ring_len=lr, tables=pl._span_tables)
        serial_ms = timed(serial, ser_restore)
        row = {"W": width, "ticks": FLEET_TIME_TICKS, "batched_ms": ms,
               "serial_ms": serial_ms}
        sb = [span_bound(pl, FLEET_TIME_TICKS) for pl, _ in rows[:width]]
        pb = [pack_bound(pl.n_chains, pl.n_nodes) for pl, _ in rows[:width]]
        nbytes = sum(b["bytes"] for b in sb) + sum(b["bytes"] for b in pb)
        ops = sum(b["ops"] for b in sb) + sum(b["ops"] for b in pb)
        t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, ops / ALU32_OPS_PER_S * 1e3
        row.update(bytes=nbytes, ops=ops, bound_ms=max(t_b, t_o),
                   bound_by="bytes" if t_b >= t_o else "operations")

        # the span kernel alone
        def span_only():
            td.torcells_span_batched(*live, tables[4], tables[5], tables[6],
                                     args, lr, span)
        row["span_ms"] = timed(span_only, restore)
        row["span_us_per_tick"] = row["span_ms"] * 1e3 / FLEET_TIME_TICKS
        row["serial_us_per_tick"] = serial_ms * 1e3 / FLEET_TIME_TICKS
        if width == max(FLEET_WIDTHS):
            # the plain versions and the pack alone, at W = 8
            restore()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            td.torcells_step_span_flush_batched_torch(
                batch[0], *live, batch[10], batch[11], *tables,
                ring_len=lr)
            torch.cuda.synchronize()
            row["plain_ms"] = (time.perf_counter() - t0) * 1e3
            row["span_bound"] = sum(b["bytes"] for b in sb), \
                sum(b["ops"] for b in sb)
            restore()
            t_stop, done_in, sent_in = td.torcells_span_batched(
                *live, tables[4], tables[5], tables[6], args, lr, span)
            pargs = (t_stop, done_in, live[5], tables[6], live[3], sent_in,
                     live[6])
            row["pack_ms"] = graph_ms(lambda: td.pack_flush_batched(*pargs))
            e0.record()
            for _ in range(5):
                td.pack_flush_batched_torch(*pargs)
            e1.record()
            torch.cuda.synchronize()
            row["pack_plain_ms"] = e0.elapsed_time(e1) / 5
            pbytes = sum(b["bytes"] for b in pb)
            pops = sum(b["ops"] for b in pb)
            row["pack_bound_ms"] = max(pbytes / HBM_BYTES_PER_S,
                                       pops / ALU32_OPS_PER_S) * 1e3
            row["pack_bound_by"] = ("bytes" if pbytes / HBM_BYTES_PER_S
                                    >= pops / ALU32_OPS_PER_S
                                    else "operations")
            sbytes, sops = row["span_bound"]
            row["span_bound_ms"] = max(sbytes / HBM_BYTES_PER_S,
                                       sops / ALU32_OPS_PER_S) * 1e3
            row["span_bound_by"] = ("bytes" if sbytes / HBM_BYTES_PER_S
                                    >= sops / ALU32_OPS_PER_S
                                    else "operations")
        out[width] = row
        print(f"W={width}: one batched dispatch {ms:.4f} ms (the span "
              f"kernel alone {row['span_ms']:.4f} ms, "
              f"{row['span_us_per_tick']:.3f} us a tick), {width} serial "
              f"dispatches {serial_ms:.4f} ms ({FLEET_TIME_TICKS} ticks); "
              f"bound {row['bound_ms'] * 1e3:.3f} us ({row['bound_by']}, "
              f"{nbytes} B, {ops} ops)", flush=True)
    top = out[max(FLEET_WIDTHS)]
    print(f"W=8: span kernel alone {top['span_ms']:.4f} ms (bound "
          f"{top['span_bound_ms'] * 1e3:.3f} us, {top['span_bound_by']}); "
          f"pack kernel alone {top['pack_ms'] * 1e3:.3f} us by graph replay "
          f"(bound {top['pack_bound_ms'] * 1e3:.3f} us); plain batched step "
          f"{top['plain_ms']:.1f} ms, plain pack "
          f"{top['pack_plain_ms'] * 1e3:.1f} us", flush=True)
    return out


def graph_ms(fn, per_graph: int = 20, reps: int = 10) -> float:
    """A launch's device time by graph replay: ``per_graph`` calls captured
    in a CUDA graph, replayed ``reps`` times, CUDA events around."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        graph.replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / (reps * per_graph)


def _wrappers() -> dict:
    """Every kernel wrapper of the port, by the key its count goes under."""
    from shadow_tpu_torch.ops import bandwidth as bw
    from shadow_tpu_torch.ops import phold_device as pd
    from shadow_tpu_torch.ops import round_step as rs
    from shadow_tpu_torch.ops import saturate_device as sd
    from shadow_tpu_torch.ops import torcells_device as td
    from shadow_tpu_torch.parallel.mesh import cards as cm
    from shadow_tpu_torch.parallel.mesh import exchange as ex
    return {"span": td.torcells_span, "pack": td.pack_flush,
            "span_b": td.torcells_span_batched,
            "pack_b": td.pack_flush_batched, "hop": rs.packet_hop_mapped,
            "hop_dev": rs.packet_hop_packed,
            "phold": pd.phold_run, "saturate": sd.saturate_run,
            "torcells_run": td.torcells_run,
            "admit_sorted": bw.admit_sorted, "mesh_span": ex.mesh_span,
            "mesh_pack": ex.mesh_pack_flush,
            "hop_s": rs.packet_hop_sharded, "mesh_card": cm.mesh_span_card}


def _reset_counts():
    from shadow_tpu_torch.parallel.mesh import exchange as ex
    for fn in _wrappers().values():
        fn.launches = 0
    ex.mesh_pack_flush.capped_launches = 0


def _counts() -> dict:
    """Each wrapper's launches, and ``mesh_pack_capped``: the mesh flush's
    launches with a cap below its count (counted in mesh_pack as well)."""
    from shadow_tpu_torch.parallel.mesh import exchange as ex
    counts = {key: fn.launches for key, fn in _wrappers().items()}
    counts["mesh_pack_capped"] = ex.mesh_pack_flush.capped_launches
    return counts


def run_fleet_smoke() -> dict:
    """``simfleet smoke`` on cuda: 8 fuzz-drawn scenarios, serial and as 8
    fleet lanes, digest-gated; the counts set to 0 before it."""
    import tempfile
    from shadow_tpu_torch.fleet import cli as fleet_cli
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        _reset_counts()
        t0 = time.perf_counter()
        rc = fleet_cli.main(["smoke", "--seeds", "8", "--lanes", "8",
                             "--out", path])
        wall = time.perf_counter() - t0
        counts = _counts()
        with open(path) as f:
            summary = json.load(f)
    finally:
        os.unlink(path)
    sm = summary["simfleet"]
    out = {"rc": rc, "pass": summary["pass"], "wall_s": wall,
           "digest_match": sm["digest_match"],
           "families": sm["families"], "launches": sm["fleet.launches"],
           "lane_dispatches": sm["fleet.lane_dispatches"],
           "compiles": sm["fleet.compiles"],
           "serial_wall_s": sm["serial_wall_sec"],
           "fleet_wall_s": sm["fleet_wall_sec"], "counts": counts}
    print(json.dumps(out), flush=True)
    if rc != 0 or not summary["pass"] or not sm["digest_match"]:
        fail(f"simfleet smoke on cuda: rc {rc}, pass {summary['pass']}, "
             f"digest_match {sm['digest_match']}")
    if not out["launches"] > 0:
        fail("simfleet smoke: no batched launches")
    if not counts["span_b"] == counts["pack_b"] == out["launches"]:
        fail(f"simfleet smoke: {out['launches']} fleet launches but "
             f"{counts['span_b']} batched span and {counts['pack_b']} "
             "batched pack launches")
    return out


# F1, simfuzz on the card.  EXPECTED_CORPUS: each corpus file's one state
# digest and event count, which every mode of its matrix gives; made with
# the JAX package on the CPU (shadow_tpu.fuzz.runner.run_modes, JAX's 8
# virtual CPU devices).  EXPECTED_FUZZ: the ``base`` mode of fuzz seed 1
# (cdn, device traffic), made the same way; the batched part runs seed 1
# alone, to keep the whole smoke near 1,000 s (seed 2, with its procs
# modes, added ~30 s).
# tests/test_torch_simfuzz_parity.py holds both to the JAX runs and the
# port's CPU runs to them.
EXPECTED_CORPUS = {
    "appmix-seed0": ("8ba2270010f990a37bcd8b4be7e5e67b"
                     "002707c6ae75d66875d3f0ea8084074e", 10029),
    "cdn-seed1": ("4985a60667a038cdc91c68f22aeb0e8b"
                  "43d8d42447ac67a9e08bcd2a9e641905", 0),
    "phold-seed3-resurrect": ("fcedf6e15e6f874fa60304eec44db777"
                              "2174d3a0184953f808e695925aa36864", 10290),
    "phold-seed3": ("3eaf5177103f566df74c4e0d7107186f"
                    "054e20a1d8a2aaf0919fdc8953e7d797", 5140),
    "star-seed11": ("004096ee4f04901f0199f145214c0f1e"
                    "d674fb21d3d4b9125dcd3fe5975d5bc6", 0),
    "swarm-seed12": ("79373a4a51cb38012947130cbfbc985f"
                     "49facd0e5d21a0cdab01456bab2a7c54", 0),
    "tor-seed21": ("ebe90297f6d073b2a7aab90b22beb941"
                   "f17a2ce71b4ba1b8fd1e57a8ccd30ff6", 0),
}
EXPECTED_FUZZ = {
    1: ("9dc4c29a8cbce7427f70d3f8a0b18220"
        "418ef3b152fd1e4cd0c8f873ad27d916", 0),
}
FUZZ_DRILL_FILE = "cdn-seed1.json"
FUZZ_CHILD_SEED = 1
# a child given seed 3's procs mode alone (phold over 2 shard processes)
# at a stoptime of 3,000 s, ~3 min of shard work on the CPU, and a bound it
# cannot meet; the kill waits at most wait_s for the shards to start
FUZZ_OVERRUN = {"seed": 3, "mode": "procs", "stoptime": 3000,
                "bound_s": 5.0, "wait_s": 60.0}


def live_group_members(pgid: int) -> list:
    """Live processes (zombies excluded) of process group ``pgid``."""
    out = []
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[2]) == pgid and fields[0] != "Z":
            out.append(int(name))
    return out


@contextlib.contextmanager
def group_kill_witness(wait_s: float):
    """While open, the subprocess runner's group kill first waits (at most
    ``wait_s``) until the child's process group holds more than the child,
    its ``--processes`` shards, then records the group's live members just
    before the kill and just after it, in the dict it yields."""
    from shadow_tpu_torch.fuzz import runner
    seen = {}
    end_group = runner._end_group

    def witnessed(proc):
        t0 = time.perf_counter()
        seen["before"] = live_group_members(proc.pid)
        while len(seen["before"]) < 2 and \
                time.perf_counter() - t0 < wait_s:
            time.sleep(0.05)
            seen["before"] = live_group_members(proc.pid)
        seen["waited_s"] = time.perf_counter() - t0
        end_group(proc)
        seen["after"] = live_group_members(proc.pid)
    runner._end_group = witnessed
    try:
        yield seen
    finally:
        runner._end_group = end_group


class _Recording:
    """A runner that keeps every result list its inner runner returns."""

    def __init__(self, runner):
        self.runner = runner
        self.results = []

    def run(self, spec):
        res = self.runner.run(spec)
        self.results.append(res)
        return res


def _fuzz_part(label: str, t0: float, modes: int) -> float:
    wall = time.perf_counter() - t0
    print(f"simfuzz {label}: {modes} modes in {wall:.3f} s, "
          f"{modes / wall:.3f} modes a second", flush=True)
    return wall


def run_simfuzz() -> dict:
    """F1: simfuzz on cuda, each runner at its default device: (a) the
    corpus replayed in process, every mode equal to EXPECTED_CORPUS, the
    plane's and the mesh's kernels launched (on cuda a wrapper launches its
    kernel or raises, so no plain version runs on the path); (b) the fault
    drill through the CLI, caught, shrunk, written and replayed; (c) one
    seed through the bounded subprocess runner, and a child past its bound
    reported as a timeout, killed while its shards ran, with nothing of its
    process group left; (d) the CLI's batched path on EXPECTED_FUZZ's
    seeds, the base runs equal to it."""
    import contextlib
    import io
    import tempfile
    from shadow_tpu_torch.fuzz import cli as fuzz_cli
    from shadow_tpu_torch.fuzz.gen import draw_spec
    from shadow_tpu_torch.fuzz.oracles import check
    from shadow_tpu_torch.fuzz.runner import (BatchedRunner,
                                              InProcessRunner,
                                              SubprocessRunner)
    out = {}
    # (a) the corpus
    rec = _Recording(InProcessRunner())
    files = fuzz_cli.corpus_files(fuzz_cli.CORPUS_DIR)
    if sorted(os.path.basename(p)[:-5] for p in files) != \
            sorted(EXPECTED_CORPUS):
        fail(f"simfuzz corpus: files {files} are not EXPECTED_CORPUS's")
    _reset_counts()
    t0 = time.perf_counter()
    rcs, walls = {}, {}
    for path in files:
        name = os.path.basename(path)
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rcs[name] = fuzz_cli.replay_file(path, rec)
        walls[name[:-5]] = round(time.perf_counter() - t1, 3)
    counts = _counts()
    n_modes = sum(len(r) for r in rec.results)
    wall = _fuzz_part("corpus", t0, n_modes)
    for path, res in zip(files, rec.results):
        name = os.path.basename(path)
        want = EXPECTED_CORPUS[name[:-5]]
        got = {r["mode"]: (r["digest"], r["events"]) for r in res}
        bad = {m: g for m, g in got.items() if g != want}
        if rcs[name] != 0 or bad:
            fail(f"simfuzz corpus {name}: rc {rcs[name]}, modes off "
                 f"EXPECTED_CORPUS {bad} "
                 f"{[r['log_tail'][-300:] for r in res if r['rc']]}")
    print(f"simfuzz corpus: {len(files)} files, {n_modes} modes, each "
          f"equal to EXPECTED_CORPUS; walls {walls}; launches {counts}",
          flush=True)
    for key in ("span", "pack", "mesh_span", "mesh_pack"):
        if counts[key] <= 0:
            fail(f"simfuzz corpus: no {key} launch")
    if counts["span"] != counts["pack"] or \
            counts["mesh_span"] != counts["mesh_pack"]:
        fail(f"simfuzz corpus: a dispatch is not one span and one pack "
             f"launch: {counts}")
    off_path = {k: v for k, v in counts.items()
                if v and k not in ("span", "pack", "mesh_span", "mesh_pack")}
    if off_path:
        fail(f"simfuzz corpus: kernels off its path launched: {off_path}")
    out["corpus"] = {"files": len(files), "modes": n_modes, "wall_s": wall,
                     "walls_s": walls, "counts": counts}
    with tempfile.TemporaryDirectory(prefix="simfuzz-smoke-") as td:
        # (b) the fault drill through the CLI's path (its in-process
        # runner recorded): caught, shrunk, written, replayed
        drill = _Recording(InProcessRunner())
        args = fuzz_cli.build_parser().parse_args([
            "--spec", os.path.join(fuzz_cli.CORPUS_DIR, FUZZ_DRILL_FILE),
            "--in-process", "--fault-inject", "digest-drift:numpy",
            "--shrink-budget", "8", "--repro-dir",
            os.path.join(td, "repros")])
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = fuzz_cli.fuzz(args, drill)
            summary = json.loads(buf.getvalue().splitlines()[-1])[
                "simfuzz"]
            repros = summary["repros"]
            rc_repro = fuzz_cli.replay_file(repros[0], drill) \
                if len(repros) == 1 else None
        wall = _fuzz_part("drill", t0, sum(len(r) for r in drill.results))
        print(f"simfuzz drill: rc {rc}, {summary['violations']} "
              f"violation(s), repros {len(repros)}, --repro rc "
              f"{rc_repro}", flush=True)
        if rc != 1 or len(repros) != 1 or rc_repro != 0:
            fail(f"simfuzz drill: rc {rc} (want 1), repros {repros} (want "
                 f"one), --repro rc {rc_repro} (want 0)")
        out["drill"] = {"rc": rc, "repro_rc": rc_repro, "wall_s": wall}
        # (c) the bounded subprocess runner, at the CLI's default device
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = fuzz_cli.main([
                "--seeds", "1", "--seed-base", str(FUZZ_CHILD_SEED),
                "--timeout-sec", "240", "--repro-dir",
                os.path.join(td, "repros-child")])
        summary = json.loads(buf.getvalue().splitlines()[-1])["simfuzz"]
        wall = _fuzz_part("child", t0,
                          len(draw_spec(FUZZ_CHILD_SEED)["modes"]))
        if rc != 0 or summary["violations"]:
            fail(f"simfuzz child: rc {rc}, {summary}")
        spec = draw_spec(FUZZ_OVERRUN["seed"])
        spec["stoptime"] = FUZZ_OVERRUN["stoptime"]
        spec["modes"] = [m for m in spec["modes"]
                         if m["name"] == FUZZ_OVERRUN["mode"]]
        t0 = time.perf_counter()
        with group_kill_witness(FUZZ_OVERRUN["wait_s"]) as group:
            res = SubprocessRunner(
                timeout_sec=FUZZ_OVERRUN["bound_s"]).run(spec)
        over_s = time.perf_counter() - t0
        viols = check(spec, res)
        print(f"simfuzz overrun: bound {FUZZ_OVERRUN['bound_s']} s, back "
              f"in {over_s:.3f} s, timeout {res[0].get('timeout')}, "
              f"oracles {[v['oracle'] for v in viols]}; its group just "
              f"before the kill {group.get('before')} (after waiting "
              f"{group.get('waited_s', 0):.3f} s for its shards), just "
              f"after {group.get('after')}", flush=True)
        if not res[0].get("timeout") or \
                [v["oracle"] for v in viols] != ["rc_log"]:
            fail(f"simfuzz overrun: {res[0]}")
        if len(group["before"]) < 2 or group["after"]:
            fail(f"simfuzz overrun: the kill did not land while the "
                 f"child's shards ran or left some running: {group}")
        out["child"] = {"rc": rc, "wall_s": wall, "overrun_s": over_s}
        # (d) the batched path of the CLI, its base runs recorded
        seeds = sorted(EXPECTED_FUZZ)
        runner = BatchedRunner(lanes=8)
        got = []
        run_specs = runner.run_specs

        def recording(specs):
            rows = run_specs(specs)
            got.extend(rows)
            return rows
        runner.run_specs = recording
        args = fuzz_cli.build_parser().parse_args([
            "--batched", "--lanes", "8", "--seeds", str(len(seeds)),
            "--seed-base", str(seeds[0]), "--repro-dir",
            os.path.join(td, "repros-batched")])
        _reset_counts()
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = fuzz_cli.fuzz(args, runner)
        counts = _counts()
        fleet = json.loads(buf.getvalue().splitlines()[-1])["simfuzz"][
            "fleet"]
        wall = _fuzz_part("batched", t0, sum(len(r) for r in got))
        print(f"simfuzz batched: rc {rc}, seeds {seeds}, fleet.launches "
              f"{fleet['fleet.launches']}, batched_modes "
              f"{fleet['batched_modes']}, serial_modes "
              f"{fleet['serial_modes']}; launches {counts}", flush=True)
        for seed, rows in zip(seeds, got):
            base = rows[0]
            if (base["mode"], base["digest"], base["events"]) != \
                    ("base", *EXPECTED_FUZZ[seed]):
                fail(f"simfuzz batched seed {seed}: base {base['digest']} "
                     f"{base['events']} != EXPECTED_FUZZ "
                     f"{EXPECTED_FUZZ[seed]}")
        if rc != 0 or not fleet["fleet.launches"] > 0 \
                or not fleet["batched_modes"] > 0:
            fail(f"simfuzz batched: rc {rc}, {fleet}")
        if not (counts["span_b"] == counts["pack_b"]
                == fleet["fleet.launches"]):
            fail(f"simfuzz batched: {fleet['fleet.launches']} fleet "
                 f"launches but {counts['span_b']} batched span and "
                 f"{counts['pack_b']} batched pack launches")
        out["batched"] = {"rc": rc, "wall_s": wall, "counts": counts,
                          "fleet": fleet}
    out["wall_s"] = sum(out[k]["wall_s"] for k in
                        ("corpus", "drill", "child", "batched")) \
        + out["child"]["overrun_s"]
    print(json.dumps({"simfuzz": out}), flush=True)
    return out




def run_sweep_lane(seed: int, lane=None) -> dict:
    """One lane of the sweep through Controller.run on cuda (as a fleet
    lane when ``lane`` is given, with a thread-local logger)."""
    from shadow_tpu_torch.core.checkpoint import state_digest
    from shadow_tpu_torch.core.controller import Controller
    from shadow_tpu_torch.core.logger import (SimLogger, set_logger,
                                              set_thread_logger)
    if lane is None:
        set_logger(SimLogger(level="warning"))
    else:
        set_thread_logger(SimLogger(level="warning"))
    try:
        opts = sweep_options(seed)
        if lane is not None:
            opts._fleet_lane = lane
        ctl = Controller(opts, sweep_config(seed))
        t0 = time.perf_counter()
        rc = ctl.run()
        wall = time.perf_counter() - t0
        eng = ctl.engine
        plane = eng.device_plane
        st = plane.stats()
        return {"seed": seed, "rc": rc, "hosts": eng.total_host_count(),
                "digest": state_digest(eng), "events": eng.events_executed,
                "rounds": eng.rounds_executed, "completed": st["completed"],
                "circuits": st["circuits"], "forwards": st["forwards"],
                "dispatches": st["dispatches"], "steps": st["steps"],
                "mode": st["mode"], "recoveries": st["recoveries"],
                "materialized": eng.host_table.materialized_count,
                "flows": plane.n_flows, "chains": plane.n_chains,
                "nodes": plane.n_nodes, "ring_len": plane.ring_len,
                "wall_s": wall}
    finally:
        if lane is not None:
            set_thread_logger(None)


SWEEP_KEYS = ("digest", "events", "rounds", "completed", "forwards")


def run_sweep(serial: dict, trace: bool = False) -> dict:
    """The 8 lanes as one fleet on cuda (FleetDriver, 8 lanes, one
    FleetPlane), with the counts set to 0 just before and read just after;
    under torch.profiler when ``trace``.  Each lane must equal its serial
    cuda run; lane 1 the JAX package's constants."""
    import torch
    from shadow_tpu_torch.fleet import FleetDriver, FleetPlane
    driver = FleetDriver(lanes=len(SWEEP["seeds"]),
                         plane=FleetPlane(device="cuda"))
    jobs = [lambda lane, s=s: run_sweep_lane(s, lane) for s in SWEEP["seeds"]]
    _reset_counts()
    with card_trace(trace) as prof:
        t0 = time.perf_counter()
        lanes = driver.run(jobs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = _counts()
    stats = driver.plane.metrics()
    out = {"wall_s": wall, "counts": counts,
           "lanes": [{k: ln[k] for k in ("seed", "rc", "digest", "events",
                                         "rounds", "completed", "forwards",
                                         "dispatches", "steps")}
                     for ln in lanes], **stats}
    if trace:
        out.update(busy_intervals(prof))
        out["idle_share"] = 1.0 - out["busy_s"] / wall
    print(json.dumps(out), flush=True)
    for ln in lanes:
        ref = serial[ln["seed"]]
        if ln["rc"] != 0:
            fail(f"sweep lane {ln['seed']}: exit code {ln['rc']}")
        for key in SWEEP_KEYS + ("dispatches",):
            if ln[key] != ref[key]:
                fail(f"sweep lane {ln['seed']} {key}: fleet {ln[key]} != "
                     f"serial {ref[key]}")
    lane1 = next(ln for ln in lanes if ln["seed"] == 1)
    for key, want in EXPECTED_SWEEP1.items():
        if lane1[key] != want:
            fail(f"sweep lane 1 {key}: {lane1[key]} != JAX run's {want}")
    if not counts["span_b"] == counts["pack_b"] == stats["fleet.launches"] \
            > 0:
        fail(f"sweep: {stats['fleet.launches']} fleet launches but "
             f"{counts['span_b']} batched span and {counts['pack_b']} "
             "batched pack launches")
    if counts["span"] or counts["pack"] or counts["hop"] \
            or counts["hop_dev"]:
        fail(f"sweep: serial kernels launched on the fleet path: {counts}")
    if trace:
        for key in ("span_b", "pack_b"):
            if out[f"{key}_kernels"] != stats["fleet.launches"]:
                fail(f"the sweep's trace holds {out[key + '_kernels']} "
                     f"{key} kernels for {stats['fleet.launches']} fleet "
                     "launches")
    print(f"sweep parity: {len(lanes)} lanes == their serial cuda runs "
          f"(digest, events, rounds, completed, forwards, dispatches); "
          f"lane 1 == JAX; {stats['fleet.launches']} fleet launches = "
          f"{counts['span_b']} batched span + {counts['pack_b']} batched "
          f"pack; {stats['fleet.lane_dispatches']} lane dispatches, "
          f"occupancy {stats['fleet.lane_occupancy']}; wall {wall:.3f} s",
          flush=True)
    return out


class SpanEvents:
    """While active, ``torcells_device.torcells_span`` is a wrapper that
    brackets each launch with CUDA events on the launching stream, so the
    span kernel's card time inside a real run is measured without a trace.
    A spin kernel first keeps that stream busy while the host prepares the
    launch, so the interval holds the kernel and not the host's call.  The
    launch count stays on the wrapped function."""

    SPIN_CYCLES = 400_000      # ~0.2 ms at the H100's clock

    def __enter__(self):
        import torch
        from shadow_tpu_torch.ops import torcells_device as td
        self.td, self.orig, self.pairs = td, td.torcells_span, []
        orig, pairs = self.orig, self.pairs

        class Timed:
            launches = property(
                lambda _self: orig.launches,
                lambda _self, v: setattr(orig, "launches", v))

            def __call__(self, *args, **kw):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                torch.cuda._sleep(SpanEvents.SPIN_CYCLES)
                e0.record()
                out = orig(*args, **kw)
                e1.record()
                pairs.append((e0, e1))
                return out
        td.torcells_span = Timed()
        return self

    def __exit__(self, *exc):
        self.td.torcells_span = self.orig

    def times_ms(self) -> list:
        import torch
        torch.cuda.synchronize()
        return [e0.elapsed_time(e1) for e0, e1 in self.pairs]


def run_sweep_serial() -> dict:
    """Each sweep lane run serially on cuda, with its span launches timed
    by CUDA events (SpanEvents): the kernel's card time and its mean per
    tick inside the real runs."""
    out = {}
    for s in SWEEP["seeds"]:
        _reset_counts()
        with SpanEvents() as ev:
            r = run_sweep_lane(s)
        r["counts"] = _counts()
        span = ev.times_ms()
        r["span_ms"] = sum(span)
        r["span_mean_ms"] = r["span_ms"] / max(len(span), 1)
        r["span_us_per_tick"] = r["span_ms"] * 1e3 / max(r["steps"], 1)
        if len(span) != r["counts"]["span"]:
            fail(f"sweep serial seed {s}: {len(span)} timed span launches "
                 f"for {r['counts']['span']} counted")
        out[s] = r
        print(json.dumps(r), flush=True)
        if r["rc"] != 0 or r["completed"] != r["circuits"] \
                or r["materialized"] != 0 or r["recoveries"] != 0:
            fail(f"sweep serial seed {s}: rc {r['rc']}, completed "
                 f"{r['completed']} of {r['circuits']}, materialized "
                 f"{r['materialized']}, recoveries {r['recoveries']}")
        if not r["counts"]["span"] == r["counts"]["pack"] \
                == r["dispatches"]:
            fail(f"sweep serial seed {s}: {r['dispatches']} dispatches, "
                 f"counts {r['counts']}")
    return out


# ---------------------------------------------------------------------------
# The device-resident model workloads (phold, saturate, torcells_run,
# admit_sorted)
# ---------------------------------------------------------------------------

# shadow_tpu_torch/tools/modelbench.py at its FULL sizes (bench.py's
# bench_phold: PHOLD 1,024 hosts x 16,384 messages to 30 s, 4,096
# saturated interfaces x 30,000 ticks, DeviceTorCells(200 relays, 2,000
# circuits) with 200 cells each, the 64-host engine PHOLD twin to 30 s;
# and one BandwidthKernel batch of 65,536 packets to 2,050 hosts).
# EXPECTED_MODELS was made with the JAX package on the CPU (phold_run,
# saturate_run, torcells_run and admit_sorted on one XLA CPU device, the
# engine twin under shadow_tpu's Controller, global policy);
# tests/test_torch_modelbench.py reproduces it (pytest -m slow).
EXPECTED_MODELS = {
    "phold_device_hops": 6523464,
    "phold_device_digest": "1b460b703047cc3e250ca88d422d9f01"
                           "7b80b5f3efadc7a4a9b189c318015e0b",
    "saturate_device_delivered_pkts": 76097359,
    "saturate_device_dropped_pkts": 5822641,
    "torcells_device_ticks": 1566,
    "torcells_device_cell_forwards": 2000000,
    "torcells_device_delivered": 400000,
    "bandwidth_device_admits_digest": "a7592175aa1a113be1be2b4422353e77"
                                      "ea44bfc04c0a997e837c5a060fe59eea",
    "bandwidth_device_delayed": 43827,
    "phold_engine_events": 706149,
}
# the kernel-vs-plain check runs PHOLD to 3 s (the plain version pays a few
# hundred launches a window); the JAX package's hops by then
PHOLD_CHECK_NS = 3_000_000_000
PHOLD_CHECK_HOPS = 661533
# the device-memory path (state beyond shared memory) at bench width:
# 1,024 hosts x 65,536 messages to 1 s, held to the plain version
PHOLD_WIDE = {"hosts": 1024, "msgs": 65536, "horizon_ns": 1_000_000_000}
ADMIT_SIZES = (256, 8192, 65536)
ADMIT_HOSTS = 2050
# 32-bit operations: saturate per host and tick (two int64 compares, the
# admission min/max, four adds, two 32-bit divisions, the refill min, the
# drains' min/mul/sub); admit_sorted per lane (two int64 divisions ~40,
# max/min/sub/mul ~20); phold per hop (the cipher ~120, the modulo ~20, the
# gather and updates ~30) and per message and window (the minimum and the
# ripe compare, two int64 compares)
SAT_OPS_PER_TICK = 40
ADMIT_OPS_PER_LANE = 60
PHOLD_OPS_PER_HOP = 170
PHOLD_OPS_PER_MSG_WINDOW = 4
MODEL_KERNELS = ("phold", "saturate", "torcells_run", "admit_sorted")
# the serial chains' floors, estimated from the code (not measured): a
# narrow saturate tick is ~12 dependent 32-bit add, compare and select
# steps (~5 cycles each); an admit_sorted packet ~25 dependent steps (int64
# compare and select, multiply-add, min, the reciprocal's multiply-high
# and shifts); at the H100 SXM's top SM clock (NVIDIA's data sheet)
SAT_TICK_CYCLES = 60
ADMIT_PACKET_CYCLES = 130
SM_CLOCK_HZ = 1.98e9


def _card():
    import torch
    return torch.device("cuda", 0)


def _bound_row(nbytes: int, ops: int) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ALU32_OPS_PER_S * 1e3
    return {"bytes": nbytes, "ops": ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def phold_bound(h: int, m: int, hops: int, windows: int) -> dict:
    """The latency matrix and the message state read once, the state written
    once; the hops' and the windows' 32-bit operations."""
    return _bound_row(8 * h * h + 2 * 12 * m + 16,
                      hops * PHOLD_OPS_PER_HOP
                      + windows * m * PHOLD_OPS_PER_MSG_WINDOW)


def chain_floor_ms(steps: int, cycles: int) -> float:
    """A serial chain's least time: ``steps`` dependent steps of
    ``cycles`` each at the card's top SM clock (an estimate)."""
    return steps * cycles / SM_CLOCK_HZ * 1e3


def saturate_bound(h: int, ticks: int) -> dict:
    return _bound_row(8 * 8 * h, h * ticks * SAT_OPS_PER_TICK)


def torcells_run_bound(f: int, h: int, ticks: int) -> dict:
    """The five flow tables and two node tables read once, delivered and
    two scalars written once; every tick's per-flow and per-node work
    (span_bound's counts)."""
    return _bound_row(8 * (5 * f + 2 * h) + 8 * f + 16,
                      ticks * (f * SPAN_OPS_PER_FLOW + h * SPAN_OPS_PER_NODE))


def admit_bound(n: int, runs: int) -> dict:
    return _bound_row(n * (4 + 8 + 8 + 1) + 3 * 8 * runs + 8 * n,
                      n * ADMIT_OPS_PER_LANE)


def _events_ms(fn, reps: int = 3):
    """Mean device time of ``fn`` by CUDA events, one call per interval,
    the card kept busy while the host issues it; returns (last result,
    ms)."""
    import torch
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    total, out = 0.0, None
    for _ in range(reps):
        torch.cuda._sleep(2_000_000)
        e0.record()
        out = fn()
        e1.record()
        torch.cuda.synchronize()
        total += e0.elapsed_time(e1)
    return out, total / reps


def _host_ms(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _max_err(pairs) -> int:
    import torch
    err = 0
    for a, b in pairs:
        a = torch.as_tensor(a).to(torch.int64).cpu()
        b = torch.as_tensor(b).to(torch.int64).cpu()
        if a.shape != b.shape:
            fail(f"shapes differ: {tuple(a.shape)} vs {tuple(b.shape)}")
        if a.numel():
            err = max(err, int((a - b).abs().max()))
    return err


def admit_case(n: int, seed: int, invalid: float = 0.0):
    """``n`` packets to ADMIT_HOSTS hosts drawn as the JAX package's
    tests/test_bandwidth_ops.py draws a batch, sorted by (dst, arrival,
    order) as BandwidthKernel sorts it; with ``invalid`` > 0 that share of
    lanes inside the batch is marked invalid.  Numpy (dst int32, sizes,
    arrive, valid, tokens0, refill, capacity) and the number of host runs."""
    import numpy as np
    from shadow_tpu_torch.ops.bandwidth import bucket_params
    from shadow_tpu_torch.tools.modelbench import admission_batch
    rates, dst, pkt, arrive, tok0 = admission_batch(
        {"bw_seed": seed, "bw_hosts": ADMIT_HOSTS, "bw_pkts": n})
    refill, cap = bucket_params(rates)
    order = np.lexsort((np.arange(n), arrive, dst))
    valid = np.ones(n, dtype=bool)
    if invalid:
        valid = np.random.default_rng(seed + 1).random(n) >= invalid
    d = dst[order]
    dv = d[valid]
    runs = int(np.count_nonzero(np.r_[True, dv[1:] != dv[:-1]])) \
        if dv.size else 0
    return (d, pkt[order], arrive[order], valid, tok0, refill, cap), runs


# csrc/saturate.cu: the narrow path's bound and the ticks between two
# checks of the quiet exit; the edge cases' sizes
SAT_NARROW = 1 << 31
SAT_UNROLL = 4
SAT_EDGE_HOSTS = 64
ADMIT_EDGE_N = 8192       # past csrc/admit_sorted.cu LANES_MAX: the tiles


def saturate_narrow(size: int, refill, cap, qcap: int, ticks: int):
    """Which hosts csrc/saturate.cu steps on its 32-bit path (bool [H])."""
    import numpy as np
    refill = np.asarray(refill, dtype=np.int64)
    cap = np.asarray(cap, dtype=np.int64)
    ok = (cap >= 0) & (refill >= 0) & (cap < SAT_NARROW) \
        & (refill < SAT_NARROW)
    ok &= np.where(ok, cap + refill, SAT_NARROW) < SAT_NARROW
    return ok & (size < SAT_NARROW) & (-1 <= qcap < SAT_NARROW - 1) \
        & (ticks < SAT_NARROW)


def saturate_steps(first, n_pkts, size: int, refill, cap, qcap: int,
                   ticks: int):
    """The ticks csrc/saturate.cu steps for each host: on the narrow path
    from the clipped first tick a up to the quiet exit (a tick at or past
    the clipped end b that starts with an empty queue, looked for every
    SAT_UNROLL ticks from a, and every tick in the last SAT_UNROLL);
    ``ticks`` on the int64 path.  Vectorised over the hosts; returns
    (narrow bool [H], stepped int64 [H])."""
    import numpy as np
    first = np.asarray(first, dtype=np.int64)
    last = (first.astype(np.uint64)
            + np.asarray(n_pkts, dtype=np.int64).astype(np.uint64)) \
        .astype(np.int64)
    refill = np.asarray(refill, dtype=np.int64)
    cap = np.asarray(cap, dtype=np.int64)
    narrow = saturate_narrow(size, refill, cap, qcap, ticks)
    end = max(int(ticks), 0)
    a = np.clip(first, 0, end)
    b = np.clip(last, a, end)
    # the first tick of the last loop, which looks every tick
    tail = np.where(a <= end - SAT_UNROLL,
                    a + SAT_UNROLL * ((end - SAT_UNROLL - a) // SAT_UNROLL
                                      + 1), a)
    stop = np.full(first.shape, end, dtype=np.int64)
    live = narrow.copy()
    w, r = cap // size, cap % size
    queue = np.zeros_like(first)
    alive = np.zeros(first.shape, dtype=bool)
    for t in range(end):
        if not live.any():
            break
        look = live & (t >= a) & (((t - a) % SAT_UNROLL == 0) | (t >= tail))
        quiet = look & (t >= b) & (queue == 0)
        stop[quiet] = t
        live &= ~quiet
        on = live & (t >= a)
        arr = on & (t < b)
        queue += (arr & (queue < qcap + 1)).astype(np.int64)
        n1 = np.where(on, np.minimum(queue, w), 0)
        queue -= n1
        w -= n1
        tok = np.minimum(cap, w * size + r + refill)
        ref = on & alive
        w = np.where(ref, tok // size, w)
        r = np.where(ref, tok % size, r)
        n2 = np.where(on, np.minimum(queue, w), 0)
        queue -= n2
        w -= n2
        alive = np.where(on, queue > 0, alive)
    return narrow, np.where(narrow, stop - a, int(ticks))


def saturate_edge_cases():
    """Inputs at csrc/saturate.cu's edges, SAT_EDGE_HOSTS hosts each:
    (name, first_tick, n_pkts, size, refill, capacity, qcap, ticks).  The
    first rows are edge hosts (a range before 0, at or past ticks, empty
    or wrapping; refill 0; capacity below size; refill at or above size;
    a refill just under size; five hosts past the narrow bounds), the rest
    drawn as bench.py draws its interfaces; the cases vary the scalars
    (qcap 8, 0 and -1, size 1, size past 2^31, 0 ticks, a long run)."""
    import numpy as np
    from shadow_tpu_torch.ops.bandwidth import bucket_params
    big = SAT_NARROW
    rows = [  # (first, n, refill, capacity); T stands for ticks
        (-50, 120, 700, 3000), (-500, 100, 700, 3000), ("T", 50, 700, 3000),
        ("T+", 50, 700, 3000), (10, 0, 700, 3000), (10, -7, 700, 3000),
        (1 << 62, 1 << 62, 700, 3000),           # first + n wraps
        (0, 200, 0, 5000), (0, 200, 0, 0), (5, 100, 300, 500),
        (5, 100, 0, 999), (0, 150, 1000, 3000), (3, 150, 2500, 8000),
        (0, "2T", 999, 3000), (7, 60, 999, 1000), (0, 10, 700, 0),
        (0, 300, big, 1000), (0, 300, 700, big), (0, 300, 1000, big - 500),
        (0, 300, -5, 3000), (0, 300, 700, -1000)]
    rng = np.random.default_rng(23)
    cases = []
    for name, size, qcap, ticks in (
            ("edges", 1000, 8, 403), ("qcap 0", 1000, 0, 400),
            ("qcap -1", 1000, -1, 400), ("size 1", 1, 8, 401),
            ("size past 2^31", big, 8, 201), ("0 ticks", 1000, 8, 0),
            ("long", 1000, 1024, 2002)):
        first, npk, ref, cap = [], [], [], []
        for f, n, rf, c in rows:
            first.append({"T": ticks, "T+": ticks + 10}.get(f, f))
            npk.append(2 * ticks if n == "2T" else n)
            ref.append(rf)
            cap.append(c)
        m = SAT_EDGE_HOSTS - len(rows)
        r_ref, r_cap = bucket_params(rng.integers(200, 4000, size=m))
        first += list(rng.integers(-20, max(ticks, 1), size=m))
        npk += list(rng.integers(0, max(ticks, 1), size=m))
        ref += list(r_ref)
        cap += list(r_cap)
        cases.append((name, *(np.asarray(x, dtype=np.int64) for x in
                              (first, npk)), size,
                      *(np.asarray(x, dtype=np.int64) for x in (ref, cap)),
                      qcap, ticks))
    return cases


def admit_edge_cases():
    """Batches of ADMIT_EDGE_N lanes at csrc/admit_sorted.cu's edges, over
    64 hosts: (name, (dst int32, sizes, arrive, valid, tokens0, refill,
    capacity)).  Runs cross tiles (of the kernel's ADMIT_TILE lanes and of
    smaller ones), with invalid lanes at every eighth lane's edges (every
    tile's first and last lanes where the tile is a multiple of 8), a whole
    tile invalid inside a run, one run over three tile
    boundaries, an unsorted batch whose dsts come back, refill 0, packets
    past 2^31 bytes, arrivals below 0 and past 2^62, padding at both ends,
    one host, and no valid lane."""
    import numpy as np
    from shadow_tpu_torch.ops import bandwidth as bw
    from shadow_tpu_torch.ops.bandwidth import REFILL_NS, bucket_params
    n, h = ADMIT_EDGE_N, 64
    rng = np.random.default_rng(29)
    refill, cap = bucket_params(rng.integers(80, 2000, size=h))
    tok0 = rng.integers(0, cap + 1).astype(np.int64)

    def batch(dst, valid=None, sizes=None, arrive=None, sort=True,
              ref=refill, capacity=cap):
        dst = np.asarray(dst, dtype=np.int32)
        sizes = rng.integers(60, 1501, size=n) if sizes is None else sizes
        arrive = rng.integers(10 * REFILL_NS, 30 * REFILL_NS, size=n) \
            if arrive is None else arrive
        if sort:
            order = np.lexsort((np.arange(n), arrive, dst))
            dst, sizes, arrive = dst[order], sizes[order], arrive[order]
        valid = np.ones(n, dtype=bool) if valid is None else valid
        return (dst, np.asarray(sizes, dtype=np.int64),
                np.asarray(arrive, dtype=np.int64), valid, tok0,
                np.asarray(ref, dtype=np.int64),
                np.asarray(capacity, dtype=np.int64))

    lane = np.arange(n)
    edges = (lane % 8 == 0) | (lane % 8 == 7)
    cases = [("invalid at every tile's first and last lanes",
              batch(rng.integers(0, 6, size=n),
                    valid=~edges & (rng.random(n) >= 0.1)))]
    whole = np.ones(n, dtype=bool)
    whole[bw.ADMIT_TILE:2 * bw.ADMIT_TILE] = False
    cases.append(("a whole tile invalid inside a run",
                  batch(np.sort(rng.integers(0, 3, size=n)), valid=whole)))
    three = np.where(lane < 1000, 5, np.where(lane < 3100, 9, 40))
    cases.append(("one run over three tile boundaries", batch(three)))
    # every lane valid; an invalid lane of another dst inside a run is
    # admit_carry_case's
    cases.append(("unsorted, dsts that come back",
                  batch(rng.integers(0, 8, size=n), sort=False)))
    cases.append(("refill 0", batch(rng.integers(0, 20, size=n),
                                    ref=np.zeros(h, dtype=np.int64))))
    sizes = rng.integers(60, 1501, size=n)
    sizes[::97] = 5_000_000_000
    sizes[5::89] = 3_000_000_000
    small = cap.copy()
    small[:4] = 100
    cases.append(("packets past 2^31 bytes, caps under a packet",
                  batch(rng.integers(0, 12, size=n), sizes=sizes,
                        capacity=small)))
    arrive = rng.integers(-40 * REFILL_NS, 30 * REFILL_NS, size=n)
    arrive[rng.random(n) < 0.05] = (1 << 62) + rng.integers(0, 10 ** 9)
    cases.append(("arrivals below 0 and past 2^62",
                  batch(rng.integers(0, 16, size=n), arrive=arrive)))
    pad = (lane >= 50) & (lane < n - 1500)
    cases.append(("padding at both ends",
                  batch(rng.integers(0, h, size=n), valid=pad)))
    cases.append(("one host", batch(np.full(n, 7))))
    cases.append(("no valid lane", batch(rng.integers(0, h, size=n),
                                         valid=np.zeros(n, dtype=bool))))
    return cases


def admit_carry_case():
    """An unsorted batch of ADMIT_EDGE_N lanes over 64 hosts whose runs hold
    invalid lanes of other dsts (at every tile's first and last lanes and
    at random inside runs; a fifth of those dsts negative or past H): (name,
    (dst int32, sizes, arrive, valid, tokens0, refill, capacity)).  JAX's
    scan reloads a run's tick, tokens and admit at each such lane (from
    its arrival and its dst's tokens0, the row as JAX indexes it); the
    plain version and both kernels of csrc/admit_sorted.cu do the same.
    A batch sorted by dst over every lane has no such lane."""
    import numpy as np
    from shadow_tpu_torch.ops import bandwidth as bw
    from shadow_tpu_torch.ops.bandwidth import REFILL_NS, bucket_params
    n, h = ADMIT_EDGE_N, 64
    rng = np.random.default_rng(31)
    refill, cap = bucket_params(rng.integers(80, 2000, size=h))
    tok0 = rng.integers(0, cap + 1).astype(np.int64)
    lengths = rng.integers(1, 400, size=n)
    ends = np.cumsum(lengths)
    lengths = lengths[:int(np.searchsorted(ends, n)) + 1]
    # a run's dst differs from the one before it and comes back later
    run_dst = np.zeros(len(lengths), dtype=np.int32)
    for r in range(1, len(lengths)):
        run_dst[r] = (run_dst[r - 1] + rng.integers(1, 8)) % 8
    dst = np.repeat(run_dst, lengths)[:n]
    arrive = np.sort(rng.integers(10 * REFILL_NS, 30 * REFILL_NS, size=n))
    lane = np.arange(n)
    valid = (rng.random(n) >= 0.1) & (lane % bw.ADMIT_TILE != 0) \
        & (lane % bw.ADMIT_TILE != bw.ADMIT_TILE - 1)
    other = (dst + rng.integers(1, h, size=n)) % h
    wild = rng.random(n) < 0.2
    other = np.where(wild, rng.integers(-h - 8, 2 * h, size=n), other)
    dst = np.where(valid, dst, other).astype(np.int32)
    return ("unsorted, invalid lanes of other dsts inside runs",
            (dst, rng.integers(60, 1501, size=n).astype(np.int64),
             arrive.astype(np.int64), valid, tok0,
             refill.astype(np.int64), cap.astype(np.int64)))


def admit_carry_cases():
    """admit_carry_case on each kernel of csrc/admit_sorted.cu: the whole
    batch (the tiled kernel) and its first ADMIT_LANES_MAX lanes (the lane
    kernel)."""
    from shadow_tpu_torch.ops.bandwidth import ADMIT_LANES_MAX
    name, arrays = admit_carry_case()
    return [(name, arrays),
            (name + ", lane kernel",
             tuple(a[:ADMIT_LANES_MAX] if len(a) == len(arrays[0]) else a
                   for a in arrays))]


def admit_form(n: int) -> str:
    """Which kernel of csrc/admit_sorted.cu a batch of ``n`` lanes takes."""
    from shadow_tpu_torch.ops.bandwidth import ADMIT_LANES_MAX
    return "lane kernel" if n <= ADMIT_LANES_MAX else "tiled kernel"


def admit_runs(dst, valid, tile: int):
    """The scan's host runs of a batch: (runs, runs with a valid lane in a
    later tile than their opener's, the longest run's packets)."""
    import numpy as np
    vi = np.flatnonzero(valid)
    if not vi.size:
        return 0, 0, 0
    d = np.asarray(dst)[vi]
    opens = np.r_[True, d[1:] != d[:-1]]
    run = np.cumsum(opens) - 1
    first_tile = (vi[opens] // tile)[run]
    crossed = np.unique(run[vi // tile != first_tile]).size
    return int(opens.sum()), int(crossed), int(np.bincount(run).max())


def check_models() -> dict:
    """Each model kernel against its plain torch version on the card, on the
    same inputs, bit-exact on every output, at bench.py's full widths:
    phold (1,024 x 16,384, to 3 s), saturate (4,096 interfaces x 30,000
    ticks), torcells_run (the bench instance to completion) and the
    windowed step (split windows with an idle fold, through torcells_span),
    admit_sorted (N in ADMIT_SIZES over 2,050 hosts, and one batch with
    invalid lanes inside it).  Returns each one's error, its plain
    version's time and its kernel's time on the checked input, and the
    inputs on the card (for time_models)."""
    import numpy as np
    import torch
    from shadow_tpu_torch.ops import bandwidth as bw
    from shadow_tpu_torch.ops import phold_device as pd
    from shadow_tpu_torch.ops import saturate_device as sd
    from shadow_tpu_torch.ops import torcells_device as td
    from shadow_tpu_torch.tools import modelbench as mb
    dev = _card()
    sizes = mb.FULL
    out, inputs = {}, {}

    p = pd.DevicePhold(sizes["phold_hosts"], sizes["phold_msgs"],
                       seed=sizes["phold_seed"])
    inputs["phold"] = (p.latency, torch.as_tensor(p.msg_host, device=dev),
                       torch.as_tensor(p.msg_time, device=dev),
                       (p.key_lo, p.key_hi))
    args = inputs["phold"] + (PHOLD_CHECK_NS,)
    kern, ms = _events_ms(lambda: pd.phold_run(*args, with_windows=True), 1)
    plain, plain_ms = _host_ms(lambda: pd.phold_run_torch(
        *args, with_windows=True))
    err = _max_err(zip(kern, plain))
    if err or int(kern[2]) != PHOLD_CHECK_HOPS:
        fail(f"phold kernel vs plain version at 3 s: max_abs_err {err}, "
             f"hops {int(kern[2])} (plain {int(plain[2])}, JAX "
             f"{PHOLD_CHECK_HOPS})")
    out["phold"] = {"err": err, "ms_check": ms, "plain_ms": plain_ms,
                    "horizon_s": PHOLD_CHECK_NS / 1e9,
                    "hops": int(kern[2]), "windows": int(kern[3])}
    print(f"phold 1024 x 16384 to 3 s: kernel == plain version bit-exact "
          f"(max_abs_err {err}), hops {int(kern[2])} == JAX, windows "
          f"{int(kern[3])}; kernel {ms:.3f} ms, plain {plain_ms:.1f} ms",
          flush=True)
    w = pd.DevicePhold(PHOLD_WIDE["hosts"], PHOLD_WIDE["msgs"],
                       seed=sizes["phold_seed"])
    wargs = (w.latency, torch.as_tensor(w.msg_host, device=dev),
             torch.as_tensor(w.msg_time, device=dev), (w.key_lo, w.key_hi),
             PHOLD_WIDE["horizon_ns"])
    kern, wms = _events_ms(lambda: pd.phold_run(*wargs, with_windows=True),
                           1)
    plain, wplain_ms = _host_ms(lambda: pd.phold_run_torch(
        *wargs, with_windows=True))
    werr = _max_err(zip(kern, plain))
    if werr:
        fail(f"phold kernel vs plain version at {PHOLD_WIDE['msgs']} "
             f"messages (device memory): max_abs_err {werr}")
    out["phold"]["err"] = max(err, werr)
    out["phold"]["wide"] = {"msgs": PHOLD_WIDE["msgs"], "err": werr,
                            "ms": wms, "plain_ms": wplain_ms,
                            "hops": int(kern[2]), "windows": int(kern[3])}
    print(f"phold {PHOLD_WIDE['hosts']} x {PHOLD_WIDE['msgs']} to "
          f"{PHOLD_WIDE['horizon_ns'] / 1e9:g} s (state in device memory): "
          f"kernel == plain version bit-exact (max_abs_err {werr}), hops "
          f"{int(kern[2])}, windows {int(kern[3])}; kernel {wms:.3f} ms "
          f"({wms * 1e3 / max(int(kern[3]), 1):.3f} us a window), plain "
          f"{wplain_ms:.1f} ms", flush=True)

    bwv, first, npk = mb.saturate_flows(sizes)
    sat = sd.DeviceSaturate(bwv)
    args = inputs["saturate"] = (
        torch.as_tensor(first, device=dev), torch.as_tensor(npk, device=dev),
        sat.size, sat._refill, sat._capacity, sat.qcap_pkts,
        sizes["sat_ticks"])
    kern, ms = _events_ms(lambda: sd.saturate_run(*args), 1)
    plain, plain_ms = _host_ms(lambda: sd.saturate_run_torch(*args))
    err = _max_err(zip(kern, plain))
    sums = (int(kern[0].sum()), int(kern[1].sum()))
    if err or sums != (EXPECTED_MODELS["saturate_device_delivered_pkts"],
                       EXPECTED_MODELS["saturate_device_dropped_pkts"]):
        fail(f"saturate kernel vs plain version: max_abs_err {err}, "
             f"delivered/dropped {sums}")
    narrow = int(saturate_narrow(sat.size, sat.refill, sat.capacity,
                                 sat.qcap_pkts, sizes["sat_ticks"]).sum())
    out["saturate"] = {"err": err, "ms_check": ms, "plain_ms": plain_ms,
                       "narrow_hosts": narrow}
    print(f"saturate 4096 x 30000 ticks: kernel == plain version bit-exact "
          f"on delivered, dropped, queue, tokens (max_abs_err {err}); "
          f"delivered {sums[0]} dropped {sums[1]} == JAX; {narrow} of "
          f"{len(first)} hosts on the 32-bit path; kernel {ms:.3f} ms, "
          f"plain {plain_ms:.1f} ms", flush=True)

    tc = td.DeviceTorCells(sizes["tc_relays"], sizes["tc_circuits"],
                           seed=sizes["tc_seed"],
                           relay_bw_kibps=sizes["tc_bw"])
    q0 = torch.as_tensor(tc._args(sizes["tc_cells"])[0], device=dev)
    inputs["torcells_run"] = (tc, q0)
    (run_delivered, scalars, plan), ms = _events_ms(
        lambda: td._torcells_run_launch(q0, *tc.tensors, tc.ring_len,
                                        sizes["tc_max_ticks"],
                                        tables=tc.tables), 1)
    kern = (run_delivered, scalars[0], scalars[1])
    plain, plain_ms = _host_ms(lambda: td.torcells_run_torch(
        q0, *tc.tensors, tc.ring_len, sizes["tc_max_ticks"],
        arr_lat=tc.tables.arr_lat))
    err = _max_err(zip(kern, plain))
    if err or int(kern[1]) != EXPECTED_MODELS["torcells_device_ticks"]:
        fail(f"torcells_run kernel vs plain version: max_abs_err {err}, "
             f"ticks {int(kern[1])}")
    fn = tc.flows["flow_node"]
    out["torcells_run"] = {"err": err, "ms_check": ms, "plain_ms": plain_ms,
                           "ticks": int(kern[1]), "f": tc.n_flows,
                           "h": len(tc.refill),
                           "longest_node_run": int(np.bincount(fn).max())}
    print(f"torcells_run F {tc.n_flows} H {len(tc.refill)} ring_len "
          f"{tc.ring_len} (longest node run "
          f"{out['torcells_run']['longest_node_run']} flows): kernel == "
          f"plain version bit-exact (max_abs_err {err}), ticks "
          f"{int(kern[1])}, forwards {int(kern[2])}; kernel {ms:.3f} ms, "
          f"plain {plain_ms:.1f} ms", flush=True)
    out["torcells_run"]["plan"] = plan_summary(plan)
    print(f"torcells_run at the bench shape ran the "
          f"{out['torcells_run']['plan']}, {run_path(scalars)} path",
          flush=True)
    _d, run_ticks, run_fwd = kern
    out["torcells_run"]["err"] = max(err, check_run_forms(tc, q0, inputs))
    out["window_err"] = check_windows(tc, q0, sizes["tc_cells"],
                                      run_delivered, run_ticks, run_fwd)

    rows, inputs["admit"] = {}, {}
    for n, invalid in [(n, 0.0) for n in ADMIT_SIZES] + [(8192, 0.25)]:
        arrays, runs = admit_case(n, seed=n + (1 if invalid else 0),
                                  invalid=invalid)
        targs = tuple(torch.as_tensor(a, device=dev) for a in arrays)
        kern = bw.admit_sorted(*targs)
        plain = bw.admit_sorted_torch(*targs)
        err = _max_err([(kern, plain)])
        if err:
            fail(f"admit_sorted N={n} (invalid share {invalid}): kernel "
                 f"vs plain version max_abs_err {err}")
        valid = arrays[3]
        if invalid and bool(kern.cpu().numpy()[~valid].any()):
            fail("admit_sorted wrote an invalid lane")
        key = f"{n}_invalid" if invalid else n
        _r, crossed, longest = admit_runs(arrays[0], valid, bw.ADMIT_TILE)
        rows[key] = {"err": err, "runs": runs, "crossed": crossed,
                     "longest_run": longest}
        inputs["admit"][key] = targs
        print(f"admit_sorted N={n:6d} over {ADMIT_HOSTS} hosts"
              f"{', a quarter of the lanes invalid' if invalid else ''} "
              f"({admit_form(n)}): "
              f"kernel == plain version bit-exact (max_abs_err {err}), "
              f"{runs} host runs ({crossed} cross a tile of "
              f"{bw.ADMIT_TILE}, the longest {longest} packets), "
              f"{int((kern > targs[2]).sum())} packets delayed", flush=True)
    out["admit"] = rows
    sat_err, rows["edges"] = check_model_edges()
    out["saturate"]["err"] = max(out["saturate"]["err"], sat_err)
    return out, inputs


def check_model_edges():
    """saturate_edge_cases and admit_edge_cases on the card: each one
    launch of its kernel, held bit-exact to its plain version.  Returns
    (saturate's max error, admit_sorted's row)."""
    import torch
    from shadow_tpu_torch.ops import bandwidth as bw
    from shadow_tpu_torch.ops import saturate_device as sd
    dev = _card()
    sat_err = 0
    for name, first, npk, size, ref, cap, qcap, ticks in \
            saturate_edge_cases():
        args = (torch.as_tensor(first, device=dev),
                torch.as_tensor(npk, device=dev), size,
                torch.as_tensor(ref, device=dev),
                torch.as_tensor(cap, device=dev), qcap, ticks)
        before = sd.saturate_run.launches
        kern = sd.saturate_run(*args)
        if sd.saturate_run.launches != before + 1:
            fail(f"saturate edge case {name!r}: not one launch")
        err = _max_err(zip(kern, sd.saturate_run_torch(*args)))
        if err:
            fail(f"saturate edge case {name!r}: kernel vs plain version "
                 f"max_abs_err {err}")
        sat_err = max(sat_err, err)
        narrow, stepped = saturate_steps(first, npk, size, ref, cap, qcap,
                                         ticks)
        print(f"saturate edge case {name!r} ({len(first)} hosts, size "
              f"{size}, qcap {qcap}, {ticks} ticks): kernel == plain "
              f"version bit-exact; {int(narrow.sum())} hosts on the 32-bit "
              f"path, {int((~narrow).sum())} on int64; the slowest 32-bit "
              f"host steps {int(stepped[narrow].max(initial=0))} ticks",
              flush=True)
    admit_err = crossed_all = 0
    for name, arrays in [*admit_edge_cases(), *admit_carry_cases()]:
        targs = tuple(torch.as_tensor(a, device=dev) for a in arrays)
        before = bw.admit_sorted.launches
        kern = bw.admit_sorted(*targs)
        if bw.admit_sorted.launches != before + 1:
            fail(f"admit_sorted edge case {name!r}: not one launch")
        err = _max_err([(kern, bw.admit_sorted_torch(*targs))])
        if err or bool(kern.cpu().numpy()[~arrays[3]].any()):
            fail(f"admit_sorted edge case {name!r}: kernel vs plain "
                 f"version max_abs_err {err}, or an invalid lane not 0")
        admit_err = max(admit_err, err)
        runs, crossed, longest = admit_runs(arrays[0], arrays[3],
                                            bw.ADMIT_TILE)
        crossed_all += crossed
        print(f"admit_sorted edge case {name!r} (N {len(arrays[0])}, "
              f"{admit_form(len(arrays[0]))}): "
              f"kernel == plain version bit-exact; {runs} host runs, "
              f"{crossed} cross a tile of {bw.ADMIT_TILE}, the longest "
              f"{longest} packets", flush=True)
    return sat_err, {"err": admit_err, "crossed": crossed_all}


# torcells_run's other cases: ten times the bench's circuits (20 cells
# each, to completion: more blocks than the card has SMs), modelbench
# --small's table (300 flows: two blocks), the long-node table (LONG_NODE,
# nodes of ~600 flows) and max_ticks cuts
RUN_WIDE = {"n_relays": 200, "n_circuits": 20000, "cells": 20}
RUN_CUT_TICKS = 700
# cells a circuit that end the bench instance's run after an odd number of
# ticks (1,559)
RUN_ODD_CELLS = 199
LONG_NODE_RUN = {"cells": 20, "max_ticks": 1000}


def plan_summary(plan) -> str:
    return (f"{plan.form} form: {len(plan.blocks) - 1} blocks of "
            f"{plan.threads} threads, {plan.smem} B of shared memory a "
            f"block, {plan.chunks} chunk(s) a tick, {plan.per_sync} "
            "tick(s) a barrier")


def run_path(scalars) -> str:
    """The path a torcells_run launch took, from its scalars (syncs)."""
    from shadow_tpu_torch.ops import torcells_device as td
    return "int32" if int(scalars[td.RUN_PATH_WORD]) else "int64"


def check_run_forms(tc, q0, inputs) -> int:
    """torcells_run in each of its forms and on both paths against its plain
    version on the card, bit-exact on delivered, ticks and forwards: the
    bench shape cut at RUN_CUT_TICKS, with RUN_ODD_CELLS cells a circuit
    (an odd tick count, so two-tick windows end in a taken-back tick), and
    with one flow queued below zero (the int64 path); RUN_WIDE to
    completion over one block an SM; modelbench's SMALL table to
    completion (a grid of two blocks); the long-node table over 8 blocks
    with chunks of 64 flows (a node's scans carried over ten chunks) and
    in the global form (plans forced), cut at its max_ticks. Returns the
    largest error; keeps RUN_WIDE's instance for the times."""
    import torch
    from shadow_tpu_torch.ops import torcells_device as td
    from shadow_tpu_torch.tools import modelbench as mb
    sizes = mb.FULL
    dev = q0.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    wide = td.DeviceTorCells(RUN_WIDE["n_relays"], RUN_WIDE["n_circuits"],
                             seed=sizes["tc_seed"],
                             relay_bw_kibps=sizes["tc_bw"])
    wq0 = torch.as_tensor(wide._args(RUN_WIDE["cells"])[0], device=dev)
    inputs["torcells_run_wide"] = (wide, wq0)
    long = td.DeviceTorCells(LONG_NODE["n_relays"], LONG_NODE["n_circuits"],
                             seed=LONG_NODE["seed"])
    lq0 = torch.as_tensor(long._args(LONG_NODE_RUN["cells"])[0], device=dev)
    small_sizes = mb.SMALL
    small = td.DeviceTorCells(small_sizes["tc_relays"],
                              small_sizes["tc_circuits"],
                              seed=small_sizes["tc_seed"],
                              relay_bw_kibps=small_sizes["tc_bw"])
    sq0 = torch.as_tensor(small._args(small_sizes["tc_cells"])[0],
                          device=dev)
    neg = q0.clone()
    neg[5] = -1
    odd = torch.as_tensor(tc._args(RUN_ODD_CELLS)[0], device=dev)
    lno, lwin = long.tables.node_off_host, long.tables.window
    full = sizes["tc_max_ticks"]
    cases = (
        (f"bench shape cut at {RUN_CUT_TICKS} ticks", tc, q0, RUN_CUT_TICKS,
         None, "grid", "int32"),
        (f"bench shape, {RUN_ODD_CELLS} cells a circuit (an odd tick "
         "count: the last window's second tick taken back)", tc, odd, full,
         None, "grid", "int32"),
        ("bench shape, one flow queued at -1", tc, neg, full, None, "grid",
         "int64"),
        (f"{RUN_WIDE['n_circuits']} circuits", wide, wq0, full, None, "grid",
         "int32"),
        (f"modelbench --small's {small_sizes['tc_circuits']} circuits",
         small, sq0, full, None, "grid", "int32"),
        ("long-node table, 8 blocks, chunks of 64 flows", long, lq0,
         LONG_NODE_RUN["max_ticks"],
         td._plan_over(lno, 8, lwin, max_threads=64), "grid", "int32"),
        ("long-node table, global form", long, lq0,
         LONG_NODE_RUN["max_ticks"],
         td._plan_over(lno, sms, lwin, smem_max=0), "global", "int32"))
    err = 0
    for label, inst, q, max_ticks, plan, form, path in cases:
        args = (q, *inst.tensors, inst.ring_len, max_ticks)
        delivered, scalars, ran = td._torcells_run_launch(
            *args, tables=inst.tables, plan=plan)
        kern = (delivered, scalars[0], scalars[1])
        plain, plain_ms = _host_ms(lambda: td.torcells_run_torch(
            *args, arr_lat=inst.tables.arr_lat))
        e = _max_err(zip(kern, plain))
        ticks = int(kern[1])
        if e or ran.form != form or run_path(scalars) != path:
            fail(f"torcells_run, {label}: kernel vs plain version "
                 f"max_abs_err {e} in the {ran.form} form on the "
                 f"{run_path(scalars)} path (want {form}, {path})")
        if (ticks == max_ticks) != (max_ticks < full) \
                or (q is odd and ticks % 2 == 0):
            fail(f"torcells_run, {label}: {ticks} ticks of at most "
                 f"{max_ticks}")
        err = max(err, e)
        print(f"torcells_run {label} (F {inst.n_flows}, H "
              f"{len(inst.refill)}): kernel == plain version bit-exact "
              f"(max_abs_err {e}), ticks {ticks}, forwards {int(kern[2])}, "
              f"delivered {int(kern[0].sum())}; the {plan_summary(ran)}, "
              f"{run_path(scalars)} path; plain {plain_ms:.1f} ms", flush=True)
    return err


def check_windows(tc, q0, cells: int, run_delivered, run_ticks,
                  run_fwd) -> int:
    """``torcells_step_window`` on the card (the span kernel with one
    boundary) against its plain version at the bench shape: windows of 7,
    93, 500 and the rest of the run's ticks, then an idle fold with no tick
    (n_ticks 0, 100 idle ticks) and 100 more ticks; each bit-exact on all
    nine outputs.  The split windows must end where torcells_run ends
    (delivered, forwards), and so must one window of the run's length."""
    import torch
    from shadow_tpu_torch.ops import torcells_device as td
    dev = q0.device
    f, h, lr = tc.n_flows, len(tc.refill), tc.ring_len
    last = torch.as_tensor(tc.flows["flow_stage"] == 4, device=dev)
    inj_t = torch.where(last, torch.full_like(q0, cells),
                        torch.zeros_like(q0))
    zero = torch.zeros_like(q0)

    def zero_state():
        return [0, torch.zeros(f, dtype=torch.int64, device=dev),
                torch.zeros((lr, f), dtype=torch.int32, device=dev),
                tc.tensors[5].clone(),
                torch.zeros(f, dtype=torch.int64, device=dev),
                torch.zeros(f, dtype=torch.int64, device=dev),
                torch.full((f,), -1, dtype=torch.int64, device=dev),
                torch.zeros(h, dtype=torch.int64, device=dev)]

    state = zero_state()
    err = 0
    forwards = 0
    rest = int(run_ticks) - 600
    for i, (n, idle) in enumerate(((7, 0), (93, 0), (500, 0), (rest, 0),
                                   (0, 100), (100, 0))):
        inj, it = (q0, inj_t) if i == 0 else (zero, zero)
        plain = td.torcells_step_window_torch(
            state[0], *state[1:], inj, it, n, idle, *tc.tensors, lr,
            arr_lat=tc.tables.arr_lat)
        live = [state[0]] + [a.clone() for a in state[1:]]
        kern = td.torcells_step_window(live[0], *live[1:], inj, it, n, idle,
                                       *tc.tensors, lr, tables=tc.tables)
        e = _max_err(zip(kern, plain))
        if e:
            fail(f"torcells_step_window window {i} ({n} ticks, idle "
                 f"{idle}): kernel vs plain version max_abs_err {e}")
        err = max(err, e)
        forwards += int(kern[8])
        state = [int(kern[0])] + list(kern[1:8])
        if i == 3 and not (torch.equal(state[4], run_delivered)
                           and forwards == int(run_fwd)):
            fail("torcells_step_window split 7 + 93 + 500 + the rest "
                 "differs from torcells_run")
        print(f"torcells_step_window {n} ticks (idle {idle}): kernel == "
              f"plain version bit-exact on all nine outputs, t -> "
              f"{state[0]}, forwards {int(kern[8])}", flush=True)
    one = zero_state()
    whole = td.torcells_step_window(one[0], *one[1:], q0, inj_t,
                                    int(run_ticks), 0, *tc.tensors, lr,
                                    tables=tc.tables)
    if not (torch.equal(whole[4], run_delivered)
            and int(whole[8]) == int(run_fwd)):
        fail("one torcells_step_window of the run's length differs from "
             "torcells_run")
    done = int((whole[6] >= 0).sum())
    print(f"the split windows and one window of {int(run_ticks)} ticks == "
          f"torcells_run (delivered, forwards {int(whole[8])}); {done} "
          "chains done", flush=True)
    return err


def time_models(checked: dict, inputs: dict) -> dict:
    """Each model kernel's device time at the main path's inputs (those of
    check_models) beside its bound: phold to 30 s, saturate and
    torcells_run at bench.py's sizes (CUDA events, one launch per
    interval), admit_sorted at each N by graph replay (launch-bound); the
    plain versions' times from the check."""
    import torch
    from shadow_tpu_torch.ops import bandwidth as bw
    from shadow_tpu_torch.ops import phold_device as pd
    from shadow_tpu_torch.ops import saturate_device as sd
    from shadow_tpu_torch.ops import torcells_device as td
    from shadow_tpu_torch.tools import modelbench as mb
    sizes = mb.FULL
    out = {}

    args = inputs["phold"]
    res, ms = _events_ms(lambda: pd.phold_run(
        *args, sizes["phold_horizon_ns"], with_windows=True), 2)
    _r3, ms3 = _events_ms(lambda: pd.phold_run(*args, PHOLD_CHECK_NS), 2)
    row = {"ms": ms, "ms_3s": ms3, "plain_ms": checked["phold"]["plain_ms"],
           "plain_horizon_s": PHOLD_CHECK_NS / 1e9, "hops": int(res[2]),
           "windows": int(res[3]),
           "us_per_window": ms * 1e3 / max(int(res[3]), 1)}
    row.update(phold_bound(sizes["phold_hosts"], sizes["phold_msgs"],
                           int(res[2]), int(res[3])))
    out["phold"] = row
    print(f"phold to 30 s: {ms:.3f} ms ({int(res[3])} windows, "
          f"{row['us_per_window']:.3f} us a window, {int(res[2])} hops); to "
          f"3 s {ms3:.3f} ms against the plain version's "
          f"{row['plain_ms']:.1f} ms; bound {row['bound_ms'] * 1e3:.3f} us "
          f"({row['bound_by']}, {row['bytes']} B, {row['ops']} ops)",
          flush=True)

    args = inputs["saturate"]
    _res, ms = _events_ms(lambda: sd.saturate_run(*args))
    row = {"ms": ms, "plain_ms": checked["saturate"]["plain_ms"],
           "us_per_tick": ms * 1e3 / sizes["sat_ticks"]}
    row.update(saturate_bound(sizes["sat_ifs"], sizes["sat_ticks"]))
    _narrow, stepped = saturate_steps(*(
        a.cpu().numpy() if isinstance(a, torch.Tensor) else a for a in args))
    row.update(stepped_max=int(stepped.max()),
               stepped_median=float(statistics.median(stepped)),
               chain_floor_ms=chain_floor_ms(int(stepped.max()),
                                             SAT_TICK_CYCLES))
    row["ns_per_stepped_tick"] = ms * 1e6 / row["stepped_max"]
    out["saturate"] = row
    print(f"saturate 4096 x 30000: {ms:.3f} ms ({row['us_per_tick']:.4f} us "
          f"a tick; the slowest host steps {row['stepped_max']} ticks, the "
          f"median {row['stepped_median']:g}: "
          f"{row['ns_per_stepped_tick']:.2f} ns a stepped tick), plain "
          f"{row['plain_ms']:.1f} ms; bound {row['bound_ms'] * 1e3:.3f} us "
          f"({row['bound_by']}); chain floor "
          f"{row['chain_floor_ms'] * 1e3:.1f} us (~{SAT_TICK_CYCLES} "
          "cycles a tick, estimated)", flush=True)

    tc, q0 = inputs["torcells_run"]
    (_d, scalars, plan), ms = _events_ms(lambda: td._torcells_run_launch(
        q0, *tc.tensors, tc.ring_len, sizes["tc_max_ticks"],
        tables=tc.tables))
    ticks = int(scalars[0])
    row = {"ms": ms, "plain_ms": checked["torcells_run"]["plain_ms"],
           "ticks": ticks, "us_per_tick": ms * 1e3 / ticks,
           "plan": plan_summary(plan)}
    row.update(torcells_run_bound(tc.n_flows, len(tc.refill), ticks))
    # ten times the circuits (one block an SM)
    wide, wq0 = inputs["torcells_run_wide"]
    (_d, wscalars, wplan), row["wide_ms"] = _events_ms(
        lambda: td._torcells_run_launch(wq0, *wide.tensors, wide.ring_len,
                                        sizes["tc_max_ticks"],
                                        tables=wide.tables))
    row["wide_ticks"] = int(wscalars[0])
    row["wide_plan"] = plan_summary(wplan)
    out["torcells_run"] = row
    print(f"torcells_run to completion: {ms:.3f} ms ({ticks} ticks, "
          f"{row['us_per_tick']:.3f} us a tick; {row['plan']}); plain "
          f"{row['plain_ms']:.1f} ms; bound {row['bound_ms'] * 1e3:.3f} us "
          f"({row['bound_by']}); {RUN_WIDE['n_circuits']} circuits "
          f"{row['wide_ms']:.3f} ms ({row['wide_ticks']} ticks, "
          f"{row['wide_ms'] * 1e3 / row['wide_ticks']:.3f} us a tick; "
          f"{row['wide_plan']})", flush=True)

    admit = {}
    for n in ADMIT_SIZES:
        case = checked["admit"][n]
        targs = inputs["admit"][n]
        ms = graph_ms(lambda: bw.admit_sorted(*targs))
        _p, plain_ms = _events_ms(lambda: bw.admit_sorted_torch(*targs))
        row = {"N": n, "ms": ms, "plain_ms": plain_ms, "runs": case["runs"],
               "longest_run": case["longest_run"],
               "chain_floor_ms": chain_floor_ms(case["longest_run"],
                                                ADMIT_PACKET_CYCLES)}
        row.update(admit_bound(n, case["runs"]))
        admit[n] = row
        print(f"admit_sorted N={n:6d} ({admit_form(n)}): {ms * 1e3:.2f} us "
              "(graph replay), "
              f"plain {plain_ms:.2f} ms; bound {row['bound_ms'] * 1e3:.3f} "
              f"us ({row['bound_by']}, {row['bytes']} B); chain floor "
              f"{row['chain_floor_ms'] * 1e3:.3f} us (the longest run's "
              f"{row['longest_run']} packets x ~{ADMIT_PACKET_CYCLES} "
              "cycles, estimated)", flush=True)
    out["admit"] = admit
    return out


# --pairs-against: the kernels timed against another checkout's, in turns
PAIRS = 5
PAIR_KERNELS = ("saturate", "admit_sorted")


def launch_signature(src: str, name: str) -> str | None:
    """The parameter list of ``extern "C" int <name>_launch(...)`` in the
    CUDA source text ``src``, whitespace collapsed (None if it has none)."""
    import re
    m = re.search(r'extern\s+"C"\s+int\s+' + name + r'_launch\s*\(([^)]*)\)',
                  src)
    return " ".join(m.group(1).split()) if m else None


def _tree_libs(roots: dict) -> dict:
    """Each PAIR_KERNELS source of each checkout in ``roots`` ({tag: root})
    built with _build's nvcc flags into build/pairs-<tag>/, all at once,
    and loaded: {tag: {name: CDLL}}.  The launchers bind every tree's entry
    points with this tree's argument lists, so each source's launch
    signature must be this tree's, word for word, or the run fails."""
    import ctypes
    from shadow_tpu_torch.ops import _build
    jobs = {}
    for tag, root in roots.items():
        for name in PAIR_KERNELS:
            src = os.path.join(root, "shadow_tpu_torch", "ops", "csrc",
                               f"{name}.cu")
            mine = os.path.join(HERE, "shadow_tpu_torch", "ops", "csrc",
                                f"{name}.cu")
            with open(src) as f, open(mine) as g:
                theirs, ours = (launch_signature(t.read(), name)
                                for t in (f, g))
            if theirs is None or theirs != ours:
                fail(f"pairs: the {tag} tree's {name}_launch signature "
                     f"({theirs}) is not this tree's ({ours})")
            lib = os.path.join(_build.BUILD_DIR, f"pairs-{tag}",
                               f"lib{name}.so")
            os.makedirs(os.path.dirname(lib), exist_ok=True)
            jobs[tag, name] = (lib, subprocess.Popen(
                [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", lib, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {tag: {} for tag in roots}
    for (tag, name), (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            fail(f"nvcc failed for the {tag} tree's {name}.cu:\n{log}")
        regs = [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"{tag} {name}.cu: " + "; ".join(regs), flush=True)
        libs[tag][name] = ctypes.CDLL(lib)
    return libs


def _launchers(libs: dict) -> tuple:
    """(saturate, admit_sorted) callables on a checkout's libraries, with
    the wrappers' argument lists and outputs."""
    import ctypes
    import torch
    from shadow_tpu_torch.ops import bandwidth as bw
    from shadow_tpu_torch.ops import saturate_device as sd
    sat = libs["saturate"].saturate_launch
    sat.argtypes, sat.restype = sd._ARGTYPES, ctypes.c_int
    adm = libs["admit_sorted"].admit_sorted_launch
    adm.argtypes, adm.restype = bw._ARGTYPES, ctypes.c_int

    def saturate(first, npk, size, refill, cap, qcap, ticks):
        outs = [torch.empty_like(first) for _ in range(4)]
        rc = sat(first.data_ptr(), npk.data_ptr(), refill.data_ptr(),
                 cap.data_ptr(), first.shape[0], size, qcap, ticks,
                 *(o.data_ptr() for o in outs),
                 torch.cuda.current_stream().cuda_stream)
        if rc:
            fail(f"saturate launch failed: CUDA error {rc}")
        return outs

    def admit(dst, sizes, arrive, valid, tok0, refill, cap):
        out = torch.empty_like(sizes)
        rc = adm(dst.data_ptr(), sizes.data_ptr(), arrive.data_ptr(),
                 valid.data_ptr(), tok0.data_ptr(), refill.data_ptr(),
                 cap.data_ptr(), sizes.shape[0], refill.shape[0],
                 out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if rc:
            fail(f"admit_sorted launch failed: CUDA error {rc}")
        return out

    return saturate, admit


def run_pairs(other: str) -> dict:
    """This tree's saturate.cu and admit_sorted.cu against ``other``'s (a
    checkout, such as the parent's), in turns: PAIRS pairs, the order
    alternating (other, this, this, other, ...); saturate by CUDA events
    at the bench shape, admit_sorted by graph replay at each ADMIT_SIZES;
    the two trees' outputs first held equal."""
    import torch
    from shadow_tpu_torch.ops import saturate_device as sd
    from shadow_tpu_torch.tools import modelbench as mb
    dev = _card()
    run = {tag: _launchers(libs) for tag, libs in
           _tree_libs({"other": other, "this": HERE}).items()}
    sizes = mb.FULL
    bwv, first, npk = mb.saturate_flows(sizes)
    sat = sd.DeviceSaturate(bwv)
    sargs = (torch.as_tensor(first, device=dev),
             torch.as_tensor(npk, device=dev), sat.size, sat._refill,
             sat._capacity, sat.qcap_pkts, sizes["sat_ticks"])
    aargs = {n: tuple(torch.as_tensor(a, device=dev)
                      for a in admit_case(n, seed=n)[0])
             for n in ADMIT_SIZES}
    err = _max_err(zip(run["other"][0](*sargs), run["this"][0](*sargs)))
    for n, a in aargs.items():
        err = max(err, _max_err([(run["other"][1](*a), run["this"][1](*a))]))
    if err:
        fail(f"pairs: the two trees' kernels differ (max_abs_err {err})")
    times = {tag: {"saturate": []} | {n: [] for n in ADMIT_SIZES}
             for tag in run}
    for i in range(PAIRS):
        for tag in (("other", "this") if i % 2 == 0 else ("this", "other")):
            sat_fn, adm_fn = run[tag]
            times[tag]["saturate"].append(
                _events_ms(lambda: sat_fn(*sargs), 2)[1])
            for n, a in aargs.items():
                times[tag][n].append(graph_ms(lambda: adm_fn(*a)))
    out = {}
    for key in ["saturate", *ADMIT_SIZES]:
        mine = statistics.median(times["this"][key])
        theirs = statistics.median(times["other"][key])
        out[key] = {"this_ms": times["this"][key],
                    "other_ms": times["other"][key], "this_median_ms": mine,
                    "other_median_ms": theirs, "ratio": mine / theirs}
        unit, scale = ("ms", 1) if key == "saturate" else ("us", 1e3)
        label = "saturate 4096 x 30000" if key == "saturate" else \
            f"admit_sorted N={key}"
        print(f"pairs {label}: this " + ", ".join(
            f"{t * scale:.3f}" for t in times["this"][key])
            + f" {unit}; other " + ", ".join(
                f"{t * scale:.3f}" for t in times["other"][key])
            + f" {unit}; medians {mine * scale:.3f} / {theirs * scale:.3f} "
            f"= {mine / theirs:.3f}x", flush=True)
    return out


def run_models(trace: bool = False) -> dict:
    """The model workloads (tools/modelbench.py at FULL sizes) on cuda, with
    every kernel count set to 0 just before and read just after; under
    torch.profiler when ``trace`` (the engine twin, which launches no
    kernel, left out).  Every count must equal EXPECTED_MODELS and every
    device call must have made one launch of its kernel."""
    import torch
    from shadow_tpu_torch.tools import modelbench as mb
    _reset_counts()
    with card_trace(trace) as prof:
        t0 = time.perf_counter()
        out = mb.run("cuda", mb.FULL, engine=not trace)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = _counts()
    out["wall_s"] = wall
    out["counts"] = counts
    if trace:
        out.update(busy_intervals(prof))
        out["idle_share"] = 1.0 - out["busy_s"] / wall
    print(json.dumps(out), flush=True)
    for key, want in EXPECTED_MODELS.items():
        if trace and key.startswith("phold_engine"):
            continue
        if out[key] != want:
            fail(f"models {key}: {out[key]} != JAX run's {want}")
    for key in MODEL_KERNELS:
        # a warm-up call and a timed call per workload, one launch each
        if not counts[key] == out["launches"][key] == 2:
            fail(f"models: {key} launched {counts[key]} times "
                 f"(the workload counted {out['launches'][key]}), not 2")
    others = {k: v for k, v in counts.items() if k not in MODEL_KERNELS}
    if any(others.values()):
        fail(f"models: other kernels launched on the model path: {others}")
    if trace:
        for key in MODEL_KERNELS:
            if out[f"{key}_kernels"] != counts[key]:
                fail(f"the models' trace holds {out[key + '_kernels']} "
                     f"{key} kernels for {counts[key]} counted launches")
    print(f"models parity: phold hops {out['phold_device_hops']} digest "
          f"{out['phold_device_digest'][:16]}..., saturate delivered "
          f"{out['saturate_device_delivered_pkts']} dropped "
          f"{out['saturate_device_dropped_pkts']}, torcells ticks "
          f"{out['torcells_device_ticks']} forwards "
          f"{out['torcells_device_cell_forwards']}, admission digest "
          f"{out['bandwidth_device_admits_digest'][:16]}..."
          + ("" if trace else f", engine events "
             f"{out['phold_engine_events']}")
          + f" == JAX; launches {counts}", flush=True)
    return out


# ---------------------------------------------------------------------------
# The mesh: D shards on one card (mesh_span + the mesh flush; the sharded
# hop in both layouts)
# ---------------------------------------------------------------------------

# The tor10k mesh slice: the tor10k slice with --tpu-devices 8 (the plane
# sharded over 8 shards of the card, the hop batch-sharded over 8).  The
# JAX package holds its sharded run equal to its single-device run, and its
# D = 8 run of this config gives EXPECTED10K; EXPECTED_MESH10K are its
# mesh.* counts (tests/test_torch_mesh_slow.py remakes both, pytest -m
# slow).  The tor1k matrix slice: the tor1k slice with --tpu-devices 4
# --tpu-shard-matrix (A = 183 rows padded to 184); it gives EXPECTED.
MESH10K_SHARDS = 8
EXPECTED_MESH10K = {"mesh.cross_shard_cells": 8244738,
                    "mesh.exchange_legs": 7, "mesh.cross_edges": 56323}
TOR1K_MATRIX_SHARDS = 4
MESH_CHECK = ((8, ("fused", "ppermute", "ppermute-masked", "none")),
              (3, ("fused", "ppermute", "none")),
              (2, ("fused", "ppermute", "none")))
MESH_LONG_NODE_CHECK = ((2, ("fused", "ppermute", "none")),)
HOP_SHARDS = (8, 3, 1, 5)    # 8 and 5 do not divide A = 183
HOP_SHARD_SIZES = (256, 4096, 65536)
MESH_TIME_TICKS = (16, 256)
MESH_KERNELS = ("mesh_span", "mesh_pack", "hop_s")


def mesh_layout(plane, n_shards: int) -> dict:
    """The padded layout attach_mesh builds for ``plane`` (the chain
    partition over ``n_shards``)."""
    from shadow_tpu_torch.parallel.mesh.partition import build_mesh_layout
    return build_mesh_layout(plane.flow_node, plane.flow_lat_steps,
                             plane.flow_succ, plane.seg_start,
                             plane.refill_step, plane.capacity_step,
                             n_shards)


def pad_mesh_state(lay, st) -> tuple:
    """A numpy state in the original layout -> the padded layout (the
    re-shard's translation: flows through pad_state, the ring by columns,
    node arrays through node_src)."""
    import numpy as np
    from shadow_tpu_torch.parallel.mesh.partition import pad_state
    keep, src, nsrc = lay["keep"], lay["src"], lay["node_src"]
    ring = np.zeros((st[2].shape[0], len(src)), dtype=st[2].dtype)
    ring[:, keep] = st[2][:, src[keep]]
    ok = nsrc >= 0
    tok = np.zeros(len(nsrc), dtype=np.int64)
    sent = np.zeros(len(nsrc), dtype=np.int64)
    tok[ok] = st[3][nsrc[ok]]
    sent[ok] = st[7][nsrc[ok]]
    return (int(st[0]), pad_state(lay, st[1]), ring, tok,
            pad_state(lay, st[4]), pad_state(lay, st[5]),
            pad_state(lay, st[6], fill=-1), sent)


def unpad_mesh_state(lay, out, n_nodes: int) -> list:
    """The mesh step's outputs (numpy, padded) in the original layout (a
    node on no shard reads 0)."""
    import numpy as np
    inv, nsrc = lay["inv"], lay["node_src"]
    ok = nsrc >= 0

    def nodes(a):
        g = np.zeros(n_nodes, dtype=np.int64)
        g[nsrc[ok]] = a[ok]
        return g
    return [out[0], out[1][inv], out[2][:, inv], nodes(out[3]), out[4][inv],
            out[5][inv], out[6][inv], nodes(out[7]), out[8], out[9]]


def _mesh_step(plane, lay, n_shards: int, mode: str, caps=(None, None)):
    from shadow_tpu_torch.parallel.mesh import device_mesh
    from shadow_tpu_torch.parallel.mesh import exchange as ex
    masked = mode.endswith("-masked")
    mode = mode.split("-")[0]
    lm = tuple(k % 2 == 0 for k in range(lay["exchange"].legs)) \
        if masked else None
    last = lay["inv"][plane.last_flow]
    step = ex.make_mesh_span_flush(
        device_mesh(n_shards, device=_card()), "flows", plane.ring_len, lay,
        last, lay["node_src"], plane.n_nodes, mode=mode, leg_mask=lm,
        cap_chains=caps[0], cap_nodes=caps[1])

    def plain(*a):
        import torch
        return ex.mesh_span_flush_torch(
            *a, ring_len=plane.ring_len, schedule=lay["exchange"],
            last_flow_pad=torch.as_tensor(last, device=_card()),
            node_src=torch.as_tensor(lay["node_src"], device=_card()),
            n_nodes=plane.n_nodes, mode=mode, leg_mask=lm,
            cap_chains=caps[0], cap_nodes=caps[1])
    return step, plain


def _mesh_statics(lay):
    import torch
    return tuple(torch.as_tensor(lay[k], device=_card()) for k in (
        "flow_node_local", "succ_global", "seg_start_local", "refill",
        "capacity", "arr_lat", "shard_base"))


def _mesh_run(fn, state, inject, inject_target, targets, idle, statics):
    import torch
    dev = _card()
    st = [torch.as_tensor(a, device=dev) for a in state[1:]]
    out = fn(state[0], *st, torch.as_tensor(inject, device=dev),
             torch.as_tensor(inject_target, device=dev), targets, idle,
             *statics)
    torch.cuda.synchronize()
    return [o.cpu().numpy() for o in out]


def check_mesh(plane, checks=MESH_CHECK) -> int:
    """mesh_span + the mesh flush against the plain mesh version on the
    card, bit-exact on all ten outputs (trailing slot included), and, read
    back through the layout, against one torcells_span + pack_flush launch
    on the unpadded table (the exactness argument; in the modes that
    exchange every leg): on ``plane``'s flow table (the tor10k plane's, or
    the long-node table's), partitioned by chain_partition, at every D and
    exchange mode of ``checks``, for the first three span cases (a
    mid-span halt, an idle fold, an injection on a boundary).  Returns the
    largest absolute difference seen (0)."""
    import numpy as np
    from shadow_tpu_torch.ops import torcells_device as td
    from shadow_tpu_torch.ops.torcells_device import flush_len
    from shadow_tpu_torch.parallel.mesh import exchange as ex
    from shadow_tpu_torch.parallel.mesh.partition import pad_state
    cases = [c for c in span_cases(plane) if c[6] is None]
    single = [_span_run(plane, td.torcells_step_window_flush, st, inj,
                        inj_t, tv, idle, None)
              for _n, st, inj, inj_t, tv, idle, _c in cases]
    base = flush_len(plane.n_chains, plane.n_nodes)
    max_err = 0
    for n_shards, modes in checks:
        t0 = time.perf_counter()
        lay = mesh_layout(plane, n_shards)
        statics = _mesh_statics(lay)
        present = np.zeros(plane.n_nodes, dtype=bool)
        present[lay["node_src"][lay["node_src"] >= 0]] = True
        for mode in modes:
            step, plain = _mesh_step(plane, lay, n_shards, mode)
            for (name, st, inj, inj_t, tv, idle, _c), one in zip(cases,
                                                                 single):
                args = (pad_mesh_state(lay, st), pad_state(lay, inj),
                        pad_state(lay, inj_t), tv, idle, statics)
                s0, p0 = ex.mesh_span.launches, ex.mesh_pack_flush.launches
                kern = _mesh_run(step, *args)
                if (ex.mesh_span.launches, ex.mesh_pack_flush.launches) != \
                        (s0 + 1, p0 + 1):
                    fail("the mesh wrappers did not count one launch each")
                ref = _mesh_run(plain, *args)
                err = _max_err(zip(kern, ref))
                max_err = max(max_err, err)
                if err:
                    fail(f"mesh D={n_shards} {mode} {name}: the kernels "
                         f"differ from the plain mesh version (max |diff| "
                         f"{err})")
                cross = int(kern[9][-1])
                if (mode == "none") != (cross == 0):
                    fail(f"mesh D={n_shards} {mode} {name}: {cross} cells "
                         "crossed shards")
                if mode not in ("fused", "ppermute"):
                    # 'none' and a leg mask leave cross-shard cells out:
                    # the same bits as the single table only where those
                    # legs carry none, which a busy state does not give
                    continue
                back = unpad_mesh_state(lay, kern, plane.n_nodes)
                for i in range(9):
                    a, b = back[i], one[i]
                    if i in (3, 7):
                        a, b = a[present], b[present]
                    if not np.array_equal(a, b):
                        fail(f"mesh D={n_shards} {mode} {name}: output {i} "
                             "differs from the single-table kernels'")
                if not np.array_equal(kern[9][:base], one[9]):
                    fail(f"mesh D={n_shards} {mode} {name}: the flush "
                         "differs from the single-table kernels'")
        sched = lay["exchange"]
        tables = ex.MeshTables(lay, plane.ring_len,
                               lay["inv"][plane.last_flow], lay["node_src"],
                               plane.n_nodes)
        runs = np.diff(tables.node_off.cpu().numpy())
        print(f"mesh D={n_shards} (pad {lay['pad']}, h_pad {lay['h_pad']}, "
              f"{len(tables.tiles) - 1} tiles, longest node {runs.max()} "
              f"flows, {sched.legs} legs, {sched.cross_edges} cross edges, "
              f"pair width {sched.pair_width}): {', '.join(modes)} x "
              f"{len(cases)} cases == plain mesh version == single-table "
              f"kernels, bit-exact ({time.perf_counter() - t0:.1f} s)",
              flush=True)
    return max_err


def check_capped_mesh(plane, n_shards: int = MESH10K_SHARDS) -> int:
    """The mesh entry of pack_flush.cu with caps (the JAX package's
    ``cap_chains`` / ``cap_nodes``; no run engages them on the mesh),
    against the plain mesh version on the card, bit-exact on all ten
    outputs, for 3's first three span cases at D = ``n_shards`` (fused):
    caps below each case's counts (its header's TRUE counts exceed them:
    overflow) and caps just above them (nothing dropped, the buffer
    shorter than full); each capped flush read back equals the full one's
    entries.  Returns the largest absolute difference seen (0)."""
    import numpy as np
    from shadow_tpu_torch.ops.torcells_device import (flush_len,
                                                      flush_overflowed,
                                                      parse_flush)
    from shadow_tpu_torch.parallel.mesh import exchange as ex
    from shadow_tpu_torch.parallel.mesh.partition import pad_state
    t0 = time.perf_counter()
    cases = [c for c in span_cases(plane) if c[6] is None]
    lay = mesh_layout(plane, n_shards)
    statics = _mesh_statics(lay)
    c, h = plane.n_chains, plane.n_nodes
    full_step, _ = _mesh_step(plane, lay, n_shards, "fused")
    max_err, seen = 0, []
    for name, st, inj, inj_t, tv, idle, _c in cases:
        args = (pad_mesh_state(lay, st), pad_state(lay, inj),
                pad_state(lay, inj_t), tv, idle, statics)
        full = _mesh_run(full_step, *args)
        n_done, n_touched = int(full[9][2]), int(full[9][3])
        below = (max(n_done // 2, 1), max(n_touched // 3, 1))
        above = (min(n_done + 7, c), min(n_touched + 9, h))
        for label, caps in (("below", below), ("above", above)):
            step, plain = _mesh_step(plane, lay, n_shards, "fused", caps)
            p0 = ex.mesh_pack_flush.launches
            q0 = ex.mesh_pack_flush.capped_launches
            kern = _mesh_run(step, *args)
            if ex.mesh_pack_flush.launches != p0 + 1:
                fail("the capped mesh flush did not count one launch")
            if ex.mesh_pack_flush.capped_launches != q0 + int(
                    caps[0] < c or caps[1] < h):
                fail("the capped mesh flush did not count its caps")
            ref = _mesh_run(plain, *args)
            err = _max_err(zip(kern, ref))
            max_err = max(max_err, err)
            if err:
                fail(f"capped mesh flush D={n_shards} {name} caps {caps} "
                     f"({label}): the kernels differ from the plain mesh "
                     f"version (max |diff| {err})")
            flush = kern[9]
            if len(flush) != flush_len(c, h, *caps) + 1:
                fail(f"capped mesh flush {name}: {len(flush)} words")
            over = flush_overflowed(flush, *caps)
            if over != (label == "below"):
                fail(f"capped mesh flush {name} caps {caps} ({label}): "
                     f"overflow {over}")
            if ex.mesh_flush_extra(flush, c, h, *caps) != int(full[9][-1]):
                fail(f"capped mesh flush {name}: the cross slot differs")
            if not over:
                got = parse_flush(flush, c, h, *caps)
                want = parse_flush(full[9][:-1], c, h)
                if got[:3] != want[:3] or not all(
                        np.array_equal(a, b)
                        for a, b in zip(got[3:], want[3:])):
                    fail(f"capped mesh flush {name}: its entries differ "
                         "from the full flush's")
            seen.append(f"{label} {caps}")
    print(f"capped mesh flush D={n_shards} fused: {len(cases)} cases x "
          f"caps below and above the counts ({'; '.join(seen)}) == plain "
          f"mesh version, bit-exact; overflow detected below, entries equal "
          f"to the full flush above ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    return max_err


def _hop_inputs(n: int, seed: int):
    import numpy as np
    rng = np.random.default_rng(seed)
    lat = rng.integers(1_000_000, 150_000_000, size=(A, A), dtype=np.int64)
    rel = rng.random((A, A)).astype(np.float32)
    pick = rng.random((A, A))
    rel[pick < 0.3] = np.float32(1.0)
    rel[(pick >= 0.3) & (pick < 0.4)] = np.float32(0.0)
    cols = (rng.integers(0, A, size=n, dtype=np.int32),
            rng.integers(0, A, size=n, dtype=np.int32),
            rng.integers(0, 2 ** 64, size=n, dtype=np.uint64),
            rng.integers(BOOTSTRAP_END // 2, 2 * BOOTSTRAP_END, size=n,
                         dtype=np.int64))
    barrier = int(np.median(cols[3])) + 50_000_000
    return lat, rel, cols, barrier


def _sharded_cols(kern, cols, barrier):
    import torch
    b = kern.bucket(len(cols[0]))
    return b, tuple(torch.as_tensor(c, device=_card())
                    for c in kern.padded_batch(*cols, b))


def check_sharded_hop() -> int:
    """The sharded hop in both layouts (one launch of packet_hop_sharded a
    batch: the batch's D slices with the matrices whole, or the whole batch
    with the matrices in D row slices) against its plain version on the
    card over the whole padded bucket, and against packet_hop on the valid
    lanes, at B in HOP_SHARD_SIZES (n = B - B/8 packets) and D in
    HOP_SHARDS.  Returns the largest |difference| (0)."""
    import numpy as np
    from shadow_tpu_torch.ops import round_step as rs
    max_err = 0
    for b in HOP_SHARD_SIZES:
        n = b - b // 8
        lat, rel, cols, barrier = _hop_inputs(n, 500 + b)
        one = rs.PacketHopKernel.from_arrays(lat, rel, DROP_KEY,
                                             BOOTSTRAP_END, _card())
        od, ok = one.step(*cols, barrier)
        buckets = []
        for d in HOP_SHARDS:
            for matrix in (False, True):
                kern = rs.ShardedPacketHopKernel.from_arrays(
                    lat, rel, DROP_KEY, BOOTSTRAP_END, _card(),
                    n_devices=d, shard_matrix=matrix)
                bk, dcols = _sharded_cols(kern, cols, barrier)
                s0 = rs.packet_hop_sharded.launches
                got = kern._run(dcols, barrier)
                launched = rs.packet_hop_sharded.launches - s0
                if launched != 1:
                    fail(f"sharded hop D={d} matrix={matrix}: {launched} "
                         "launches for one batch")
                keys = (kern.key_lo, kern.key_hi, BOOTSTRAP_END, barrier)
                if matrix:
                    want = rs.matrix_sharded_hop_reference(
                        kern.lat_rows, kern.rel_rows, A, dcols, *keys)
                else:
                    want = rs.batch_sharded_hop_reference(
                        kern.latency, kern.reliability, dcols, d, *keys)
                err = _max_err(zip(got, want))
                max_err = max(max_err, err)
                if err:
                    fail(f"sharded hop D={d} matrix={matrix} B={b}: the "
                         f"kernel differs from its plain version ({err})")
                sd, sk = kern.step(*cols, barrier)
                gd = got[0][:n].cpu().numpy()
                gk = got[1][:n].cpu().numpy()
                if not (np.array_equal(gd, od) and np.array_equal(gk, ok)
                        and np.array_equal(sd, od)
                        and np.array_equal(sk, ok)):
                    fail(f"sharded hop D={d} matrix={matrix} B={b}: "
                         "differs from packet_hop")
                buckets.append(bk)
        print(f"sharded hop B={b} n={n}, D in {HOP_SHARDS} (buckets "
              f"{sorted(set(buckets))}): batch and matrix layouts == plain "
              f"versions == packet_hop, bit-exact; kept {int(ok.sum())}/{n}",
              flush=True)
    return max_err


def mesh_flush_bound(c: int, h: int, caps=(None, None)) -> dict:
    """done_tick and delivered read through last_flow, done_in; node_sent
    and sent_in through node_slot; the three scalars; the buffer (capped
    by ``caps``) with its trailing slot written once."""
    cc = c if caps[0] is None else min(caps[0], c)
    hh = h if caps[1] is None else min(caps[1], h)
    return _bound_row(8 * (2 * c + c + c + 3 * h + 3)
                      + 8 * (6 + 2 * cc + 2 * hh), 8 * (c + h))


def sharded_hop_bound(bucket: int, pairs: int) -> dict:
    """The six columns read once (25 B a lane), each distinct (src, dst)
    entry gathered once (12 B), deliver and keep written once; the lanes'
    32-bit operations (the cipher and the hop, OPS_PER_LANE)."""
    return _bound_row(bucket * 25 + pairs * 12 + bucket * 9,
                      bucket * OPS_PER_LANE)


def mesh_bound(plane, lay, ticks: int, tables) -> dict:
    """The single-table span's bound (span_bound) plus the exchange slots'
    bytes, each slot written once and read once (8 + 8 bytes).  As in
    span_bound, traffic that repeats each tick is not counted: the ring is
    counted once, and so are the slots (~0.45 MB at tor10k, in L2)."""
    row = span_bound(plane, ticks)
    slots = tables.n_recv
    row = _bound_row(row["bytes"] + 16 * slots, row["ops"])
    row["slots"] = slots
    return row


def time_mesh(plane) -> dict:
    """One mesh dispatch at D = MESH10K_SHARDS (the heuristic's mode) at
    MESH_TIME_TICKS ticks, no completion, by CUDA events with the state
    restored outside the timed interval, in turns with torcells_span on
    the same state (single, mesh, mesh, single); the mesh flush by graph
    replay; the plain mesh version once; each beside its bound.  Then the
    sharded hop by graph replay in both layouts (D = 8 batch-sharded, the
    tor10k mesh slice's; D = 4 matrix-sharded, the tor1k matrix slice's)
    beside packet_hop at the same n, and its plain versions."""
    import numpy as np
    import torch
    from shadow_tpu_torch.ops import round_step as rs
    from shadow_tpu_torch.ops import torcells_device as td
    from shadow_tpu_torch.parallel.mesh import exchange as ex
    from shadow_tpu_torch.parallel.mesh.partition import pad_state
    rng = np.random.default_rng(23)
    st = list(busy_state(plane, rng, 30000))
    st[5] = np.zeros(plane.n_flows, dtype=np.int64)   # no target: no halt
    lay = mesh_layout(plane, MESH10K_SHARDS)
    mode = ex.choose_exchange_mode(lay["exchange"])[0]
    step, plain = _mesh_step(plane, lay, MESH10K_SHARDS, mode)
    statics = _mesh_statics(lay)
    tables = ex.MeshTables(lay, plane.ring_len, lay["inv"][plane.last_flow],
                           lay["node_src"], plane.n_nodes, mode, None,
                           _card())
    dev = _card()
    mst = pad_mesh_state(lay, st)
    zp = torch.zeros(len(lay["src"]), dtype=torch.int64, device=dev)
    zf = torch.zeros(plane.n_flows, dtype=torch.int64, device=dev)
    args = plane._flow_args()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)

    def timed(launch, saved, reps=6):
        live = tuple(a.clone() for a in saved)
        total = 0.0
        for r in range(reps + 1):
            for a, b in zip(live, saved):
                a.copy_(b)
            torch.cuda._sleep(2_000_000)
            e0.record()
            launch(live)
            e1.record()
            torch.cuda.synchronize()
            if r:
                total += e0.elapsed_time(e1)
        return total / reps

    out = {"mode": mode, "shards": MESH10K_SHARDS}
    for ticks in MESH_TIME_TICKS:
        tv = np.array([30000 + ticks])
        msaved = tuple(torch.as_tensor(a, device=dev) for a in mst[1:])
        ssaved = plane._to_device(st)[1:]

        def mesh_launch(live):
            ex.mesh_span(30000, *live, zp, zp, tv, 0, statics[3],
                         statics[4], tables)

        def single_launch(live):
            td.torcells_span(30000, *live, zf, zf, tv, 0, *args,
                             ring_len=plane.ring_len,
                             tables=plane._span_tables)
        s1 = timed(single_launch, ssaved)
        m1 = timed(mesh_launch, msaved)
        m2 = timed(mesh_launch, msaved)
        s2 = timed(single_launch, ssaved)
        out[ticks] = {"mesh_ms": (m1 + m2) / 2, "single_ms": (s1 + s2) / 2,
                      "mesh_ms_each": [m1, m2], "single_ms_each": [s1, s2]}
    t_lo, t_hi = MESH_TIME_TICKS
    per_tick = (out[t_hi]["mesh_ms"] - out[t_lo]["mesh_ms"]) / (t_hi - t_lo)
    single_tick = (out[t_hi]["single_ms"] - out[t_lo]["single_ms"]) \
        / (t_hi - t_lo)
    tv = np.array([30000 + t_hi])
    msaved = tuple(torch.as_tensor(a, device=dev) for a in mst[1:])
    _, plain_ms = _host_ms(lambda: plain(30000, *msaved, zp, zp, tv, 0,
                                         *statics))
    span = {"ticks": t_hi, "ms": out[t_hi]["mesh_ms"],
            "ms_short": out[t_lo]["mesh_ms"], "ms_per_tick": per_tick,
            "single_ms": out[t_hi]["single_ms"],
            "single_ms_per_tick": single_tick, "plain_ms": plain_ms,
            "turns_ms": out[t_hi]["mesh_ms_each"],
            "single_turns_ms": out[t_hi]["single_ms_each"]}
    span.update(mesh_bound(plane, lay, t_hi, tables))
    print(f"mesh_span D={MESH10K_SHARDS} {mode}: {span['ms']:.4f} ms at "
          f"{t_hi} ticks ({per_tick * 1e3:.3f} us/tick), beside "
          f"torcells_span {span['single_ms']:.4f} ms "
          f"({single_tick * 1e3:.3f} us/tick); plain {plain_ms:.1f} ms; "
          f"bound {span['bound_ms'] * 1e3:.3f} us ({span['bound_by']}, "
          f"{span['bytes']} B with {span['slots']} slots a tick, "
          f"{span['ops']} ops)", flush=True)
    # the mesh flush alone, by graph replay, on a finished dispatch's state
    live = [torch.as_tensor(a, device=dev) for a in mst[1:]]
    sc, (cross, done_in, sent_in) = ex.mesh_span(
        30000, *live, zp, zp, np.array([30000 + t_lo]), 0, statics[3],
        statics[4], tables)
    pargs = (sc[0], sc[8], cross, sc[6], sc[4], sc[7], done_in, sent_in,
             tables)
    pack_ms = graph_ms(lambda: ex.mesh_pack_flush(*pargs))
    last = torch.as_tensor(lay["inv"][plane.last_flow], device=dev)
    nsrc = torch.as_tensor(lay["node_src"], device=dev)

    def pack_plain():
        done_last = sc[6][last]
        newly = (done_last >= 0) & (done_in < 0)
        delta = ex.global_sent_torch(sc[7], nsrc, plane.n_nodes) \
            - ex.global_sent_torch(sent_in, nsrc, plane.n_nodes)
        flush = td.pack_flush_torch(sc[8], sc[4][last].sum(), sc[0], newly,
                                    done_last, delta)
        return torch.cat([flush, cross.reshape(1)])
    got = ex.mesh_pack_flush(*pargs)
    if not torch.equal(got, pack_plain()):
        fail("the mesh flush differs from its plain version")
    _, pack_plain_ms = _events_ms(pack_plain, reps=5)
    pack = {"ms": pack_ms, "plain_ms": pack_plain_ms}
    pack.update(mesh_flush_bound(plane.n_chains, plane.n_nodes))
    print(f"mesh flush: {pack_ms * 1e3:.3f} us (graph replay), plain "
          f"{pack_plain_ms * 1e3:.1f} us, bound {pack['bound_ms'] * 1e3:.3f}"
          f" us ({pack['bound_by']})", flush=True)
    # the capped entry at the tuner's caps for this table (no run engages
    # caps on the mesh; the entry is held to JAX's make_mesh_span_flush)
    from shadow_tpu_torch.prof.autotune import flush_caps
    caps = flush_caps(plane.n_chains, plane.n_nodes)
    capped_ms = graph_ms(lambda: ex.mesh_pack_flush(*pargs, *caps))

    def capped_plain():
        done_last = sc[6][last]
        newly = (done_last >= 0) & (done_in < 0)
        delta = ex.global_sent_torch(sc[7], nsrc, plane.n_nodes) \
            - ex.global_sent_torch(sent_in, nsrc, plane.n_nodes)
        flush = td.pack_flush_torch(sc[8], sc[4][last].sum(), sc[0], newly,
                                    done_last, delta, *caps)
        return torch.cat([flush, cross.reshape(1)])
    if not torch.equal(ex.mesh_pack_flush(*pargs, *caps), capped_plain()):
        fail("the capped mesh flush differs from its plain version")
    _, capped_plain_ms = _events_ms(capped_plain, reps=5)
    capped = {"ms": capped_ms, "plain_ms": capped_plain_ms, "caps": caps}
    capped.update(mesh_flush_bound(plane.n_chains, plane.n_nodes, caps))
    print(f"mesh flush capped at {caps}: {capped_ms * 1e3:.3f} us (graph "
          f"replay), plain {capped_plain_ms * 1e3:.1f} us, bound "
          f"{capped['bound_ms'] * 1e3:.3f} us ({capped['bound_by']})",
          flush=True)
    # the sharded hop beside packet_hop, at the tor1k run's larger bucket
    n = MAIN_B - MAIN_B // 8
    lat, rel, cols, barrier = _hop_inputs(n, 77)
    one = rs.PacketHopKernel.from_arrays(lat, rel, DROP_KEY, BOOTSTRAP_END,
                                         dev)
    packed = torch.from_numpy(one._pack(*cols, MAIN_B, barrier)).to(dev)
    hop_args = (one.latency, one.reliability, packed, one.key_lo,
                one.key_hi, one.bootstrap_end_ns)
    single_hop_ms = graph_ms(lambda: rs.packet_hop_packed(*hop_args))
    hops = {}
    for key, d, matrix in (("batch", MESH10K_SHARDS, False),
                           ("matrix", TOR1K_MATRIX_SHARDS, True)):
        kern = rs.ShardedPacketHopKernel.from_arrays(
            lat, rel, DROP_KEY, BOOTSTRAP_END, dev, n_devices=d,
            shard_matrix=matrix)
        bk, dcols = _sharded_cols(kern, cols, barrier)
        ms = graph_ms(lambda: kern._run(dcols, barrier))
        keys = (kern.key_lo, kern.key_hi, BOOTSTRAP_END, barrier)
        if matrix:
            _, p_ms = _events_ms(lambda: rs.matrix_sharded_hop_reference(
                kern.lat_rows, kern.rel_rows, A, dcols, *keys), reps=5)
        else:
            _, p_ms = _events_ms(lambda: rs.batch_sharded_hop_reference(
                kern.latency, kern.reliability, dcols, d, *keys), reps=5)
        pairs = len(set(zip(cols[0].tolist(), cols[1].tolist())))
        row = {"shards": d, "bucket": bk, "n": n, "ms": ms,
               "single_ms": single_hop_ms, "plain_ms": p_ms}
        row.update(sharded_hop_bound(bk, pairs))
        hops[key] = row
        print(f"sharded hop ({key}, D={d}, n={n} in a bucket of {bk}): "
              f"{ms * 1e3:.2f} us a batch (graph replay; "
              f"1 launch), beside "
              f"packet_hop {single_hop_ms * 1e3:.2f} us at B={MAIN_B}; plain "
              f"{p_ms * 1e3:.1f} us; bound {row['bound_ms'] * 1e6:.2f} ns "
              f"({row['bound_by']})", flush=True)
    return {"span": span, "pack": pack, "pack_capped": capped, "hop": hops}


def run_tor10k_mesh(trace: bool = False) -> dict:
    """The tor10k mesh slice (--tpu-devices MESH10K_SHARDS) through
    Controller.run on cuda, every kernel count set to 0 just before it and
    read just after."""
    import torch
    from shadow_tpu_torch.core.checkpoint import state_digest
    from shadow_tpu_torch.core.controller import Controller
    from shadow_tpu_torch.core.logger import SimLogger, set_logger
    set_logger(SimLogger(level="warning"))
    opts = tor10k_options()
    opts.tpu_devices = MESH10K_SHARDS
    ctl = Controller(opts, tor10k_config())
    _reset_counts()
    with card_trace(trace) as prof:
        t0 = time.perf_counter()
        rc = ctl.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = _counts()
    eng = ctl.engine
    plane = eng.device_plane
    st = plane.stats()
    kern = eng.scheduler.policy._kernel
    out = {"slice": "tor10k mesh", "rc": rc, "digest": state_digest(eng),
           "events": eng.events_executed, "rounds": eng.rounds_executed,
           "completed": st["completed"], "forwards": st["forwards"],
           "dispatches": st["dispatches"], "steps": st["steps"],
           "mode": st["mode"], "recoveries": st["recoveries"],
           "demoted": st["demoted"], "hop_calls": kern.device_calls,
           "host_calls": kern.host_calls, "shards": plane._shard["n_shards"],
           "hop_shards": kern.n_devices, "counts": counts, "wall_s": wall,
           "host_exec_s": eng.host_exec_ns * 1e-9,
           "flush_s": eng.flush_ns * 1e-9,
           "plane_host_s": st["plane_host_sec"],
           "plane_collect_s": st["plane_device_sec"],
           "events_per_s": eng.events_executed / wall}
    out.update({k: v for k, v in eng.metrics.scrape().items()
                if k.startswith("mesh.")})
    if trace:
        out.update(busy_intervals(prof))
        out["idle_share"] = 1.0 - out["busy_s"] / wall
    print(json.dumps(out), flush=True)
    return out


def check_tor10k_mesh(run: dict) -> None:
    if run["rc"] != 0:
        fail(f"tor10k mesh exit code {run['rc']}")
    if run["mode"] != "device" or run["recoveries"] != 0 or run["demoted"]:
        fail(f"tor10k mesh plane mode {run['mode']}, recoveries "
             f"{run['recoveries']}, demoted {run['demoted']}")
    if run["shards"] != MESH10K_SHARDS or run["hop_shards"] != MESH10K_SHARDS:
        fail(f"tor10k mesh: {run['shards']} plane shards, "
             f"{run['hop_shards']} hop shards")
    for key, want in EXPECTED10K.items():
        if run[key] != want:
            fail(f"tor10k mesh {key}: {run[key]} != JAX run's {want}")
    if run["mesh.host_bounces"] != 0:
        fail(f"tor10k mesh: {run['mesh.host_bounces']} host bounces")
    for key, want in EXPECTED_MESH10K.items():
        if run[key] != want:
            fail(f"tor10k mesh {key}: {run[key]} != JAX run's {want}")
    c = run["counts"]
    if not c["mesh_span"] == c["mesh_pack"] == run["dispatches"]:
        fail(f"tor10k mesh: {c['mesh_span']} mesh span and {c['mesh_pack']} "
             f"mesh flush launches for {run['dispatches']} dispatches")
    if c["mesh_pack_capped"]:
        fail(f"tor10k mesh: {c['mesh_pack_capped']} capped mesh flushes "
             "(the plane turns its caps off before it shards)")
    if c["hop_s"] != run["hop_calls"] or run["host_calls"] != 0:
        fail(f"tor10k mesh: {c['hop_s']} sharded hop launches for "
             f"{run['hop_calls']} batches")
    others = {k: v for k, v in c.items()
              if k not in ("mesh_span", "mesh_pack", "hop_s") and v}
    if others:
        fail(f"tor10k mesh: other kernels launched: {others}")
    print(f"tor10k mesh parity: digest {run['digest'][:16]}... events "
          f"{run['events']} rounds {run['rounds']} completed "
          f"{run['completed']} forwards {run['forwards']} == JAX; "
          f"cross-shard cells {run['mesh.cross_shard_cells']}, legs "
          f"{run['mesh.exchange_legs']}, cross edges "
          f"{run['mesh.cross_edges']} == JAX's D = 8; host bounces 0; "
          f"{run['dispatches']} dispatches = {c['mesh_span']} mesh span + "
          f"{c['mesh_pack']} mesh flush launches, {c['hop_s']} sharded hop "
          f"launches (one a batch of {MESH10K_SHARDS} slices)", flush=True)


def run_tor1k_matrix() -> dict:
    """The tor1k slice under tpu with --tpu-devices TOR1K_MATRIX_SHARDS
    --tpu-shard-matrix on cuda, the counts set to 0 just before it."""
    import torch
    from shadow_tpu_torch.core.checkpoint import state_digest
    from shadow_tpu_torch.core.controller import Controller
    from shadow_tpu_torch.core.logger import SimLogger, set_logger
    from shadow_tpu_torch.core.options import Options
    set_logger(SimLogger(level="warning"))
    cfg = tor1k_config()
    opts = Options(scheduler_policy="tpu", device="cuda", seed=TOR1K["seed"],
                   stop_time_sec=int(cfg.stop_time_sec), log_level="warning",
                   tpu_devices=TOR1K_MATRIX_SHARDS, tpu_shard_matrix=True)
    ctl = Controller(opts, cfg)
    _reset_counts()
    t0 = time.perf_counter()
    rc = ctl.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    eng = ctl.engine
    kern = eng.scheduler.policy._kernel
    out = {"slice": "tor1k matrix", "rc": rc, "digest": state_digest(eng),
           "events": eng.events_executed, "rounds": eng.rounds_executed,
           "drops": eng.counters._new.get("packet_drop", 0),
           "device_calls": kern.device_calls, "host_calls": kern.host_calls,
           "rows_per_shard": kern.lat_rows[0].shape[0],
           "shards": kern.n_devices, "counts": counts, "wall_s": wall,
           "events_per_s": eng.events_executed / wall}
    print(json.dumps(out), flush=True)
    if rc != 0:
        fail(f"tor1k matrix exit code {rc}")
    for key, want in EXPECTED.items():
        if out[key] != want:
            fail(f"tor1k matrix {key}: {out[key]} != JAX run's {want}")
    if counts["hop_s"] != kern.device_calls or kern.host_calls:
        fail(f"tor1k matrix: {counts['hop_s']} matrix-sharded launches for "
             f"{kern.device_calls} batches")
    others = {k: v for k, v in counts.items() if k != "hop_s" and v}
    if others:
        fail(f"tor1k matrix: other kernels launched: {others}")
    print(f"tor1k matrix parity: digest {out['digest'][:16]}... events "
          f"{out['events']} rounds {out['rounds']} drops {out['drops']} == "
          f"JAX; {counts['hop_s']} matrix-sharded hop launches over "
          f"{kern.n_devices} row slices of {out['rows_per_shard']}",
          flush=True)
    return out


# ---------------------------------------------------------------------------
# The mesh over cards (parallel/mesh/cards.py): each card runs its own
# group of shards, the card entry of csrc/mesh_span.cu one launch a card a
# lookahead window, the cells that cross cards stored by the sending launch
# straight into the receiving card's inbox (no copy between the windows),
# the windows ordered by CUDA events; the flush packed on the lead card.
# Here the cards are aliases of the one H100 (every allocation, launch,
# window, store and event of the per-card program runs; what aliases
# cannot show is NVLink and two physical cards at once), and distinct cards
# where the machine has them.
# ---------------------------------------------------------------------------

MESH_CARDS = (2, 4)          # aliased cards for the card entry's checks
MESH10K_CARDS = 2            # the tor10k mesh over cards
MATRIX_CARDS = 4             # the row-sharded hop over cards
TOR100_MATRIX = {"n_relays": 100, "stoptime": 64, "seed": 1, "shards": 4}
CARD_HOP_SIZES = (4096, 65536)
PEER_COPY_BYTES = 64 << 20


def mesh_card_sets():
    """(label, cards): the aliased sets, and the host's distinct cards
    (at most 4) where it has two or more."""
    import torch
    sets = [(f"{k} aliased", [torch.device("cuda", 0)] * k)
            for k in MESH_CARDS]
    n = torch.cuda.device_count()
    if n >= 2:
        sets.append((f"{min(n, 4)} distinct",
                     [torch.device("cuda", i) for i in range(min(n, 4))]))
    return sets


def _cards_step(plane, lay, cards, max_window=None):
    from shadow_tpu_torch.parallel.mesh import device_mesh
    from shadow_tpu_torch.parallel.mesh import exchange as ex
    return ex.make_mesh_span_flush(
        device_mesh(MESH10K_SHARDS, device=_card(), cards=cards), "flows",
        plane.ring_len, lay, lay["inv"][plane.last_flow], lay["node_src"],
        plane.n_nodes, max_window=max_window)


def _cards_run(step, state, inject, inject_target, targets, idle,
               plain=False):
    """One dispatch over cards (the card entry, or its plain version);
    returns (the raw 10-tuple, its numpy global arrays)."""
    import numpy as np
    import torch
    from shadow_tpu_torch.parallel.mesh import cards as cm
    if plain:
        out = cm.mesh_span_cards_flush_torch(
            state[0], state[1:8], inject, inject_target, targets, idle,
            np.asarray(step.layout["refill"]),
            np.asarray(step.layout["capacity"]), step.layout, step.cards,
            step.tables)
    else:
        out = step(state[0], *state[1:8], inject, inject_target, targets,
                   idle)
    torch.cuda.synchronize()
    return out, [np.asarray(o.cpu() if torch.is_tensor(o) else o)
                 for o in out]


def check_mesh_cards(plane) -> dict:
    """The card entry against its plain version and against the one-card
    mesh kernels, bit for bit on all ten outputs: the tor10k table at D =
    MESH10K_SHARDS, over each set of mesh_card_sets (and at W = 1 over 2
    aliased cards), for the span cases (a mid-span halt, an idle fold, an
    injection on a boundary), each followed by a second dispatch from the
    state the first left on the cards.  Returns the largest |difference|
    (0) and the sets' shapes."""
    import numpy as np
    from shadow_tpu_torch.parallel.mesh import cards as cm
    from shadow_tpu_torch.parallel.mesh.partition import pad_state
    cases = [c for c in span_cases(plane) if c[6] is None][:3]
    lay = mesh_layout(plane, MESH10K_SHARDS)
    statics = _mesh_statics(lay)
    one_step, _ = _mesh_step(plane, lay, MESH10K_SHARDS, "fused")
    max_err, shapes = 0, []
    runs = [(label, cards, None) for label, cards in mesh_card_sets()]
    runs.insert(1, (runs[0][0] + ", W = 1", runs[0][1], 1))
    for label, cards, max_w in runs:
        t0 = time.perf_counter()
        step = _cards_step(plane, lay, cards, max_w)
        tb = step.tables
        for name, st, inj, inj_t, tv, idle, _c in cases:
            first = (pad_mesh_state(lay, st), pad_state(lay, inj),
                     pad_state(lay, inj_t), tv, idle)
            l0 = cm.mesh_span_card.launches
            kern_raw, kern = _cards_run(step, *first)
            plan = cm.card_launch_plan(first[0][0], tv, tb.window)
            if cm.mesh_span_card.launches - l0 != len(plan) * len(cards):
                fail(f"mesh cards {label} {name}: "
                     f"{cm.mesh_span_card.launches - l0} card launches for "
                     f"{len(plan)} launches a card")
            plain_raw, plain = _cards_run(step, *first, plain=True)
            one = _mesh_run(one_step, *first, statics)
            t_stop = int(kern[0])
            tv2 = t_stop + 6 * np.arange(1, 9)
            zp = np.zeros(len(lay["src"]), dtype=np.int64)
            kern2 = _cards_run(step, (t_stop, *kern_raw[1:8]), zp, zp, tv2,
                               0)[1]
            plain2 = _cards_run(step, (int(plain[0]), *plain_raw[1:8]), zp,
                                zp, tv2, 0, plain=True)[1]
            one2 = _mesh_run(one_step, (t_stop, *kern[1:8]), zp, zp, tv2, 0,
                             statics)
            for tag, a, b in (("plain", kern, plain), ("one card", kern, one),
                              ("plain, 2nd", kern2, plain2),
                              ("one card, 2nd", kern2, one2)):
                err = _max_err(zip(a, b))
                max_err = max(max_err, err)
                if err:
                    bad = [i for i in range(10)
                           if not np.array_equal(a[i], b[i])]
                    fail(f"mesh cards {label} {name}: the card entry differs "
                         f"from the {tag} version in outputs {bad} (max "
                         f"|diff| {err})")
            if int(kern[9][-1]) == 0:
                fail(f"mesh cards {label} {name}: no cell crossed shards")
        shapes.append({"cards": label, "window": tb.window, "pw": tb.pw,
                       "seg": tb.seg, "cross_card_cells_a_tick":
                       tb.cross_card_cells_a_tick,
                       "rows": [hi - lo for lo, hi in step.cards.rows]})
        print(f"mesh over {label} cards ({', '.join(map(str, cards))}): "
              f"window W = {tb.window} ticks, {tb.cross_card_cells_a_tick} "
              f"cross-card edges (pw {tb.pw}); card entry == plain version "
              f"== one-card mesh kernels, bit-exact, in "
              f"{len(cases)} cases and their second dispatches "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return {"err": max_err, "sets": shapes}


def peer_rate(cards) -> float:
    """Bytes a second that card 1's memory takes from card 0: one
    PEER_COPY_BYTES copy from card 0's buffer to card 1's (non-blocking;
    over NVLink between distinct cards, on aliased cards a copy inside the
    one card), by CUDA events, median of 5.  The card entry moves its
    cross-card cells by stores from its kernel, which no PyTorch call
    makes into another card's memory; the copy over the same link stands
    in for their rate."""
    import torch
    n = PEER_COPY_BYTES // 8
    src = torch.ones(n, dtype=torch.int64, device=cards[0])
    dst = torch.empty(n, dtype=torch.int64, device=cards[1])
    times = []
    with torch.cuda.device(cards[0]):
        for _ in range(6):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            dst.copy_(src, non_blocking=True)
            e1.record()
            torch.cuda.synchronize(cards[0])
            torch.cuda.synchronize(cards[1])
            times.append(e0.elapsed_time(e1))
    times = sorted(times[1:])
    return PEER_COPY_BYTES / (times[len(times) // 2] * 1e-3)


def cards_bound(plane, step, ticks: int, rate: float) -> dict:
    """The card entry's least time for a dispatch of ``ticks`` ticks: the
    busiest card's share of the span's bound (span_bound, by its share of
    the rows), plus the window's cross-card cells (8 B each, stored once
    into the receiver's inbox and read once at its landing) over the peer
    rate measured in the same call (peer_rate)."""
    base = span_bound(plane, ticks)
    cl = step.cards
    share = max(hi - lo for lo, hi in cl.rows) / cl.f
    xbytes = ticks * step.tables.cross_card_cells_a_tick * 8
    t_cross = xbytes / rate * 1e3
    row = {"bytes": int(base["bytes"] * share) + xbytes,
           "ops": int(base["ops"] * share), "cross_bytes": xbytes,
           "peer_bytes_per_s": rate,
           "bound_ms": base["bound_ms"] * share + t_cross}
    row["bound_by"] = base["bound_by"] if base["bound_ms"] * share >= \
        t_cross else "bytes"
    return row


def boundary_trace(run, restore, launches: int) -> dict:
    """One card-entry dispatch (``run``, from the state ``restore`` sets)
    under torch.profiler, enqueued while the card sleeps (as
    time_mesh_cards times it), read from the profiler's chrome trace: on
    each card's stream the gap from the end of one card-entry launch to
    the start of the next (what a window boundary costs the card), the
    copies between the first and the last launch, the window launches and
    the LAST launch (the final landing and the tail), and the dispatch's
    span on the card beside the host's enqueue time."""
    import tempfile
    import torch
    for take in range(1, TRACE_TAKES + 1):
        restore()
        torch.cuda.synchronize()
        with card_trace(True) as prof:
            torch.cuda._sleep(50_000_000)
            t0 = time.perf_counter()
            run()
            enqueue_ms = (time.perf_counter() - t0) * 1e3
        with tempfile.TemporaryDirectory(prefix="trace-") as td:
            path = os.path.join(td, "trace.json")
            prof.export_chrome_trace(path)
            with open(path, encoding="utf-8") as f:
                raw = json.load(f)
        evs = raw["traceEvents"] if isinstance(raw, dict) else raw
        dev = [e for e in evs if e.get("ph") == "X" and e.get("cat") in
               ("kernel", "gpu_memcpy", "gpu_memset")]
        spins = sorted(e["ts"] for e in dev if MARKER in e["name"])
        body = [e for e in dev if len(spins) == 3
                and spins[1] < e["ts"] < spins[2] and MARKER not in e["name"]]
        card = [e for e in body if "mesh_span_card_kernel" in e["name"]]
        if len(card) == launches:
            break
        print(f"trace: take {take} of the card entry's dispatch kept "
              f"{len(card)} of its {launches} launches; taken again",
              flush=True)
    else:
        fail(f"{TRACE_TAKES} traces of the card entry's dispatch dropped "
             "launches")
    streams = {}
    for e in card:
        streams.setdefault(e["args"].get("stream"), []).append(e)
    gaps, windows, last, copies = [], [], [], []
    for s, ks in streams.items():
        ks.sort(key=lambda e: e["ts"])
        gaps += [b["ts"] - (a["ts"] + a["dur"]) for a, b in zip(ks, ks[1:])]
        windows += [k["dur"] for k in ks[:-1]]
        last.append(ks[-1]["dur"])
        copies += [e["dur"] for e in body if e["cat"] == "gpu_memcpy"
                   and e["args"].get("stream") == s
                   and ks[0]["ts"] < e["ts"] < ks[-1]["ts"]]
    t_lo = min(e["ts"] for e in body)
    t_hi = max(e["ts"] + e["dur"] for e in body)
    per_card = len(card) // max(len(streams), 1)

    def med(xs):
        return statistics.median(xs) if xs else None
    row = {"streams": len(streams), "launches_a_card": per_card,
           "boundaries_a_card": per_card - 1,
           "gap_us_median": med(gaps), "gap_us_mean":
           statistics.fmean(gaps) if gaps else None,
           "gap_us_max": max(gaps) if gaps else None,
           "window_launch_us_median": med(windows),
           "last_launch_us_median": med(last),
           "copies": len(copies), "copy_us_median": med(copies),
           "copy_us_total": sum(copies), "span_us": t_hi - t_lo,
           "enqueue_ms": enqueue_ms}
    print(f"  trace of one dispatch over {len(streams)} card streams: "
          f"{per_card} launches a card; a boundary (end of one launch to "
          f"the start of the next, same stream) median "
          f"{row['gap_us_median']:.2f} us, mean {row['gap_us_mean']:.2f}, "
          f"max {row['gap_us_max']:.2f}; {len(copies)} copies between "
          f"launches"
          + (f", median {row['copy_us_median']:.2f} us, "
             f"{row['copy_us_total']:.2f} us in all" if copies else "")
          + f"; a window launch median {row['window_launch_us_median']:.2f} "
          f"us, the LAST launch (landing + tail) "
          f"{row['last_launch_us_median']:.2f} us; the dispatch "
          f"{row['span_us']:.2f} us on the card, enqueued in "
          f"{enqueue_ms:.3f} ms on the host", flush=True)
    return row


def time_mesh_cards(plane) -> dict:
    """One dispatch over k aliased cards, k in MESH_CARDS, at D =
    MESH10K_SHARDS, MESH_TIME_TICKS[-1] ticks, no completion: the card
    entry's windows and the lead's flush by CUDA events on the caller's
    stream (which the dispatch joins at both ends; the card kept busy
    while the host enqueues), the state restored outside the timed
    interval, in turns with the one-card mesh dispatch on the same state
    (one card, 2 cards, 4 cards, 4 cards, 2 cards, one card); one dispatch
    over each set traced (boundary_trace: what a window boundary costs
    the card); the plain version once over MESH10K_CARDS (host clock); the
    peer rate; the bound.  Returns MESH10K_CARDS's row, the others under
    "sets"."""
    import numpy as np
    import torch
    from shadow_tpu_torch.parallel.mesh import cards as cm
    rng = np.random.default_rng(23)
    st = list(busy_state(plane, rng, 30000))
    st[5] = np.zeros(plane.n_flows, dtype=np.int64)   # no target: no halt
    lay = mesh_layout(plane, MESH10K_SHARDS)
    one_step, _ = _mesh_step(plane, lay, MESH10K_SHARDS, "fused")
    statics = _mesh_statics(lay)
    mst = pad_mesh_state(lay, st)
    ticks = MESH_TIME_TICKS[-1]
    tv = np.array([30000 + ticks])
    zp = torch.zeros(len(lay["src"]), dtype=torch.int64, device=_card())
    kinds = ("flow", "flow", "node", "flow", "flow", "flow", "node")
    one_saved = [torch.as_tensor(a, device=_card()) for a in mst[1:]]
    one_live = [a.clone() for a in one_saved]
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)

    def timed(launch, restore, reps=5):
        total = 0.0
        for r in range(reps + 1):
            restore()
            torch.cuda.synchronize()
            torch.cuda._sleep(50_000_000)
            e0.record()
            launch()
            e1.record()
            torch.cuda.synchronize()
            if r:
                total += e0.elapsed_time(e1)
        return total / reps

    def over(k):
        """(step, launch, restore) of one dispatch over k aliased cards."""
        step = _cards_step(plane, lay, [torch.device("cuda", 0)] * k)
        cl = step.cards
        saved = [cl.split(a, kd) for a, kd in zip(mst[1:], kinds)]
        live = [cl.split(a, kd) for a, kd in zip(mst[1:], kinds)]
        zsplit = cl.split(np.zeros(len(lay["src"]), dtype=np.int64))

        def restore():
            for a, b in zip(live, saved):
                for x, y in zip(a.parts, b.parts):
                    x.copy_(y)

        def launch():
            step(30000, *live, zsplit, zsplit, tv, 0)
        return step, launch, restore

    def restore_one():
        for a, b in zip(one_live, one_saved):
            a.copy_(b)

    def one_launch():
        one_step(30000, *one_live, zp, zp, tv, 0, *statics)
    sets = {k: over(k) for k in MESH_CARDS}
    o1 = timed(one_launch, restore_one)
    turns = {k: [] for k in MESH_CARDS}
    for k in list(MESH_CARDS) + list(reversed(MESH_CARDS)):
        turns[k].append(timed(sets[k][1], sets[k][2]))
    o2 = timed(one_launch, restore_one)
    one_ms = (o1 + o2) / 2
    rate = peer_rate([torch.device("cuda", 0)] * 2)
    rows = {}
    for k, (step, launch, restore) in sets.items():
        w0 = cm.mesh_span_card.launches
        launch()
        launches = cm.mesh_span_card.launches - w0
        trace = boundary_trace(launch, restore, launches)
        ms = sum(turns[k]) / len(turns[k])
        row = rows[k] = {
            "cards": k, "ticks": ticks, "ms": ms, "turns_ms": turns[k],
            "one_card_ms": one_ms, "one_card_turns_ms": [o1, o2],
            "ratio": ms / one_ms, "window": step.tables.window,
            "launches_a_dispatch": launches, "trace": trace,
            "cross_card_cells_a_tick": step.tables.cross_card_cells_a_tick}
        row.update(cards_bound(plane, step, ticks, rate))
        if k == MESH10K_CARDS:
            _, row["plain_ms"] = _host_ms(lambda: _cards_run(
                step, (30000, *mst[1:]),
                np.zeros(len(lay["src"]), dtype=np.int64),
                np.zeros(len(lay["src"]), dtype=np.int64), tv, 0,
                plain=True))
        print(f"mesh_span card entry over {k} aliased cards, D = "
              f"{MESH10K_SHARDS}: {ms:.4f} ms for {ticks} ticks (turns "
              f"{', '.join(f'{x:.4f}' for x in turns[k])}; W = "
              f"{row['window']}, {launches} launches), beside the one-card "
              f"mesh dispatch {one_ms:.4f} ms (turns {o1:.4f}, {o2:.4f}): "
              f"{row['ratio']:.3f}x"
              + (f"; plain {row['plain_ms']:.1f} ms" if "plain_ms" in row
                 else "")
              + f"; bound {row['bound_ms'] * 1e3:.3f} us ({row['bound_by']}; "
              f"{row['cross_bytes']} B across cards, peer rate "
              f"{rate / 1e9:.1f} GB/s: one card's copy into itself)",
              flush=True)
    out = dict(rows[MESH10K_CARDS])
    out["sets"] = {str(k): r for k, r in rows.items()}
    return out


def check_sharded_hop_cards() -> dict:
    """The sharded hop over cards (MATRIX_CARDS and 2 aliased cards, and
    the distinct cards where present), both layouts, at tor1k's A = 183
    and B in CARD_HOP_SIZES: each card's launch on the round in
    page-locked memory against the plain versions and packet_hop on the
    valid lanes; one launch a card a batch; no card's row slice holds A
    rows.  Times a batch's launches and wait (host clock, median of 30)
    at the largest B over MATRIX_CARDS aliased cards."""
    import numpy as np
    import torch
    from shadow_tpu_torch.ops import round_step as rs
    sets = [(f"{k} aliased", [torch.device("cuda", 0)] * k)
            for k in (MATRIX_CARDS, 2)]
    sets += [s for s in mesh_card_sets() if "distinct" in s[0]]
    max_err, times = 0, {}
    for b in CARD_HOP_SIZES:
        n = b - b // 8
        lat, rel, cols, barrier = _hop_inputs(n, 900 + b)
        one = rs.PacketHopKernel.from_arrays(lat, rel, DROP_KEY,
                                             BOOTSTRAP_END, _card())
        od, ok = one.step(*cols, barrier)
        for label, cards in sets:
            for d, matrix in ((8, False), (4, True), (8, True)):
                if d < len(cards):
                    continue
                kern = rs.ShardedPacketHopKernel.from_arrays(
                    lat, rel, DROP_KEY, BOOTSTRAP_END, _card(), n_devices=d,
                    shard_matrix=matrix, cards=cards)
                if matrix and any(t.shape[0] >= A for t in kern.lat_rows):
                    fail(f"hop over {label}: a card's row slice holds "
                         f"{max(t.shape[0] for t in kern.lat_rows)} of A = "
                         f"{A} rows")
                s0 = rs.packet_hop_sharded.launches
                sd, sk = kern.step(*cols, barrier)
                if rs.packet_hop_sharded.launches - s0 != len(cards):
                    fail(f"hop over {label}: "
                         f"{rs.packet_hop_sharded.launches - s0} launches "
                         f"for a batch over {len(cards)} cards")
                pcols = tuple(torch.as_tensor(c) for c in kern.padded_batch(
                    *cols, kern.bucket(n)))
                keys = (kern.key_lo, kern.key_hi, BOOTSTRAP_END, barrier)
                lt, rt = torch.as_tensor(lat), torch.as_tensor(rel)
                if matrix:
                    per = -(-A // d)
                    lp = torch.nn.functional.pad(lt, (0, 0, 0, per * d - A))
                    rp = torch.nn.functional.pad(rt, (0, 0, 0, per * d - A))
                    want = rs.matrix_sharded_hop_reference(
                        [lp[s * per:(s + 1) * per] for s in range(d)],
                        [rp[s * per:(s + 1) * per] for s in range(d)], A,
                        pcols, *keys)
                else:
                    want = rs.batch_sharded_hop_reference(lt, rt, pcols, d,
                                                          *keys)
                err = _max_err(zip((sd, sk), (want[0][:n], want[1][:n])))
                max_err = max(max_err, err)
                if err or not (np.array_equal(sd, od)
                               and np.array_equal(sk, ok)):
                    fail(f"hop over {label} D={d} matrix={matrix} B={b}: "
                         f"differs from its plain version ({err}) or from "
                         "packet_hop")
                if b == max(CARD_HOP_SIZES) and label.startswith(
                        f"{MATRIX_CARDS} aliased"):
                    walls = []
                    for _ in range(31):
                        t0 = time.perf_counter()
                        kern.step(*cols, barrier)
                        walls.append(time.perf_counter() - t0)
                    walls = sorted(walls[1:])
                    key = "matrix" if matrix else "batch"
                    dev = _card()
                    dcols = tuple(c.to(dev) for c in pcols)
                    if matrix:
                        _, plain_ms = _host_ms(
                            lambda: rs.matrix_sharded_hop_reference(
                                [lp[s * per:(s + 1) * per].to(dev)
                                 for s in range(d)],
                                [rp[s * per:(s + 1) * per].to(dev)
                                 for s in range(d)], A, dcols, *keys))
                    else:
                        _, plain_ms = _host_ms(
                            lambda: rs.batch_sharded_hop_reference(
                                lt.to(dev), rt.to(dev), dcols, d, *keys))
                    times.setdefault(key, {})[d] = {
                        "plain_ms": plain_ms,
                        "ms": walls[len(walls) // 2] * 1e3, "bucket": b,
                        "cards": len(cards),
                        **sharded_hop_bound(kern.bucket(n),
                                            len(set(zip(cols[0].tolist(),
                                                        cols[1].tolist()))))}
        print(f"sharded hop over cards B={b} n={n} ({', '.join(s[0] for s in sets)}): "
              f"batch and row layouts == plain versions == packet_hop, "
              f"bit-exact; one launch a card a batch; no card holds all "
              f"{A} rows", flush=True)
    for key, by_d in times.items():
        for d, row in by_d.items():
            print(f"  hop over {MATRIX_CARDS} aliased cards, {key} D={d}: "
                  f"{row['ms'] * 1e3:.1f} us a batch of {row['bucket']} "
                  f"(launches and wait, host clock); bound "
                  f"{row['bound_ms'] * 1e6:.1f} ns", flush=True)
    return {"err": max_err, "times": times}


def run_tor10k_cards(cards, audit: bool = False) -> dict:
    """The tor10k mesh slice (--tpu-devices MESH10K_SHARDS) over ``cards``
    through Controller.run, the counts set to 0 just before it, under the
    sync audit when asked; the per-card figures beside the run's."""
    import torch
    from shadow_tpu_torch.core.checkpoint import state_digest
    from shadow_tpu_torch.core.controller import Controller
    from shadow_tpu_torch.core.logger import SimLogger, set_logger
    from shadow_tpu_torch.parallel.mesh import cards as cm
    set_logger(SimLogger(level="warning"))
    opts = tor10k_options()
    opts.tpu_devices = MESH10K_SHARDS
    opts.mesh_cards = tuple(cards)
    ctl = Controller(opts, tor10k_config())
    _reset_counts()
    ctx = sync_audit() if audit else contextlib.nullcontext()
    with ctx as aud:
        t0 = time.perf_counter()
        rc = ctl.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = _counts()
    eng = ctl.engine
    plane = eng.device_plane
    st = plane.stats()
    kern = eng.scheduler.policy._kernel
    cl = plane._cards
    out = {"slice": f"tor10k mesh over {len(cards)} cards", "rc": rc,
           "cards": [str(c) for c in cards], "digest": state_digest(eng),
           "events": eng.events_executed, "rounds": eng.rounds_executed,
           "completed": st["completed"], "forwards": st["forwards"],
           "dispatches": st["dispatches"], "steps": st["steps"],
           "mode": st["mode"], "recoveries": st["recoveries"],
           "demoted": st["demoted"], "hop_calls": kern.device_calls,
           "host_calls": kern.host_calls, "shards": plane._shard["n_shards"],
           "hop_shards": kern.n_devices,
           "hop_cards": len(getattr(kern, "cards", ())),
           "plane_cards": cl.n_cards if cl is not None else 1,
           "counts": counts, "card_launches": counts["mesh_card"],
           "window": cl.window if cl is not None else None,
           "windows": cl.windows if cl is not None else 0,
           "cross_card_edges": cl.cross_card_edges if cl else 0,
           "cross_card_cells": int(cl.xcard_cells) if cl is not None
           and cl.xcard_cells is not None else 0,
           "peer_bytes": cl.peer_bytes if cl is not None else 0,
           "wall_s": wall, "events_per_s": eng.events_executed / wall}
    out.update({k: v for k, v in eng.metrics.scrape().items()
                if k.startswith("mesh.")})
    if audit:
        out["syncs_in_window"] = sum(n for k, n in aud.counts.items()
                                     if k[3])
        out["syncs"] = sum(aud.counts.values())
        out["audit_windows"] = aud.windows
        out["in_window_sites"] = sorted({f"{k[0]}:{k[1]}"
                                         for k in aud.counts if k[3]})
    print(json.dumps(out), flush=True)
    return out


def check_tor10k_cards(run: dict) -> None:
    n = len(run["cards"])
    label = run["slice"]
    if run["rc"] != 0:
        fail(f"{label}: exit code {run['rc']}")
    if run["mode"] != "device" or run["recoveries"] != 0 or run["demoted"]:
        fail(f"{label}: plane mode {run['mode']}, recoveries "
             f"{run['recoveries']}, demoted {run['demoted']}")
    if run["plane_cards"] != n or run["hop_cards"] != n:
        fail(f"{label}: the plane over {run['plane_cards']} cards, the hop "
             f"over {run['hop_cards']}")
    for key, want in EXPECTED10K.items():
        if run[key] != want:
            fail(f"{label} {key}: {run[key]} != JAX run's {want}")
    if run["mesh.host_bounces"] != 0:
        fail(f"{label}: {run['mesh.host_bounces']} host bounces")
    for key, want in EXPECTED_MESH10K.items():
        if run[key] != want:
            fail(f"{label} {key}: {run[key]} != JAX run's {want}")
    c = run["counts"]
    if c["mesh_span"] or c["mesh_pack"] != run["dispatches"]:
        fail(f"{label}: {c['mesh_span']} one-card mesh span launches, "
             f"{c['mesh_pack']} mesh flushes for {run['dispatches']} "
             "dispatches")
    if run["card_launches"] != (run["windows"] + run["dispatches"]) * n:
        fail(f"{label}: {run['card_launches']} card entry launches for "
             f"{run['windows']} windows and {run['dispatches']} dispatches "
             f"over {n} cards")
    if c["hop_s"] != run["hop_calls"] * n or run["host_calls"]:
        fail(f"{label}: {c['hop_s']} sharded hop launches for "
             f"{run['hop_calls']} batches over {n} cards")
    others = {k: v for k, v in c.items()
              if k not in ("mesh_card", "mesh_pack", "hop_s") and v}
    if others:
        fail(f"{label}: other kernels launched: {others}")
    if run.get("syncs_in_window"):
        fail(f"{label}: {run['syncs_in_window']} syncs inside the dispatch "
             f"windows, at {run['in_window_sites']}")
    if "audit_windows" in run and run["audit_windows"] != run["dispatches"]:
        fail(f"{label}: the audit saw {run['audit_windows']} dispatch "
             f"windows for {run['dispatches']} dispatches")
    print(f"{label} parity: digest {run['digest'][:16]}... events "
          f"{run['events']} rounds {run['rounds']} completed "
          f"{run['completed']} forwards {run['forwards']} == JAX; "
          f"cross-shard cells {run['mesh.cross_shard_cells']} == JAX's D = "
          f"8; host bounces 0; W = {run['window']} ticks, {run['windows']} "
          f"windows in {run['dispatches']} dispatches, "
          f"{run['card_launches']} card entry launches, "
          f"{run['cross_card_edges']} edges across cards carried "
          f"{run['cross_card_cells']} cells, {run['peer_bytes']} B stored "
          f"into other cards' inboxes; {c['mesh_pack']} flushes on the "
          f"lead card; "
          f"{c['hop_s']} sharded hop launches ({n} a batch); "
          + (f"sync audit: {run['syncs']} syncs, none in the "
             f"{run['audit_windows']} dispatch windows; "
             if "syncs" in run else "")
          + f"wall {run['wall_s']:.3f} s", flush=True)


def tor100_matrix(cards=None) -> dict:
    """tor_network(100, device_data=True) under tpu with --tpu-devices 4
    --tpu-shard-matrix on cuda (the plane sharded as well), over ``cards``
    (None: the host's), the counts set to 0 just before it."""
    import torch
    from shadow_tpu_torch.core import configuration
    from shadow_tpu_torch.core.checkpoint import state_digest
    from shadow_tpu_torch.core.controller import Controller
    from shadow_tpu_torch.core.logger import SimLogger, set_logger
    from shadow_tpu_torch.core.options import Options
    from shadow_tpu_torch.tools import workloads
    set_logger(SimLogger(level="warning"))
    m = TOR100_MATRIX
    xml = workloads.tor_network(m["n_relays"], stoptime=m["stoptime"],
                                device_data=True)
    cfg = configuration.parse_xml(xml)
    cfg.stop_time_sec = m["stoptime"]
    opts = Options(scheduler_policy="tpu", device="cuda", seed=m["seed"],
                   stop_time_sec=m["stoptime"], log_level="warning",
                   tpu_devices=m["shards"], tpu_shard_matrix=True,
                   mesh_cards=tuple(cards) if cards else None)
    ctl = Controller(opts, cfg)
    _reset_counts()
    t0 = time.perf_counter()
    rc = ctl.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    eng = ctl.engine
    kern = eng.scheduler.policy._kernel
    st = eng.device_plane.stats()
    return {"rc": rc, "digest": state_digest(eng),
            "events": eng.events_executed, "rounds": eng.rounds_executed,
            "completed": st["completed"], "counts": _counts(),
            "hop_calls": kern.device_calls,
            "rows": [int(t.shape[0]) for t in kern.lat_rows],
            "cards": len(kern.cards), "wall_s": wall}


def run_mesh_cards(plane_checks: dict) -> dict:
    """The end-to-end part of the phase: tor10k over MESH10K_CARDS aliased
    cards under the sync audit (and over the distinct cards where
    present); the row-sharded tor100 one-card and over MATRIX_CARDS
    aliased cards, equal digests."""
    import torch
    out = {}
    aliased = [torch.device("cuda", 0)] * MESH10K_CARDS
    out["tor10k"] = run_tor10k_cards(aliased, audit=True)
    check_tor10k_cards(out["tor10k"])
    if torch.cuda.device_count() >= 2:
        distinct = [torch.device("cuda", i)
                    for i in range(min(torch.cuda.device_count(), 4))]
        out["tor10k_distinct"] = run_tor10k_cards(distinct)
        check_tor10k_cards(out["tor10k_distinct"])
    one = tor100_matrix()
    over = tor100_matrix([torch.device("cuda", 0)] * MATRIX_CARDS)
    for r in (one, over):
        if r["rc"] != 0:
            fail(f"tor100 matrix exit code {r['rc']}")
    if (one["digest"], one["events"], one["rounds"], one["completed"]) != (
            over["digest"], over["events"], over["rounds"],
            over["completed"]):
        fail(f"tor100 matrix over {MATRIX_CARDS} aliased cards: digest "
             f"{over['digest'][:16]} events {over['events']} != one card's "
             f"{one['digest'][:16]} {one['events']}")
    if over["counts"]["hop_s"] != over["hop_calls"] * MATRIX_CARDS \
            or any(r >= A for r in over["rows"]):
        fail(f"tor100 matrix over cards: {over['counts']['hop_s']} hop "
             f"launches for {over['hop_calls']} batches, rows "
             f"{over['rows']}")
    out["tor100_one"], out["tor100_cards"] = one, over
    print(f"tor100 row-sharded (--tpu-devices 4 --tpu-shard-matrix): one "
          f"card digest {one['digest'][:16]}... events {one['events']} in "
          f"{one['wall_s']:.2f} s; over {MATRIX_CARDS} aliased cards the "
          f"same digest and events in {over['wall_s']:.2f} s, rows a card "
          f"{over['rows']}, {over['counts']['hop_s']} hop launches "
          f"({MATRIX_CARDS} a batch), {over['counts']['mesh_pack']} flushes",
          flush=True)
    return out


# ---------------------------------------------------------------------------
# The cost model (shadow_tpu_torch/prof/): a calibration of this card, its
# check, and the runs that read it
# ---------------------------------------------------------------------------

# the calibration's wall cap (the child is killed 120 s past it)
COSTMODEL_WALL_CAP_S = 200
# the small device-traffic Tor config run at --tpu-devices 8 with the
# model, without it and with each exchange mode forced: 100 device
# clients, 200 chains, F = 1,000 flows (inside the model's 500-240,000)
COSTMODEL_MESH = {"n_relays": 100, "stoptime": 64, "seed": 1, "shards": 8}
# the deeper superwindow on the card: 150 device bulk clients of 256 MiB
# to 60 s (F = 600 flows, inside the model's range) keep the host quiet for
# long stretches, so the model's K merges rounds that K = 8 cannot (on the
# CPU: 322 dispatches at K = 14 against 477 at K = 8, one digest); run at
# D = 1 and D = 8, with the model and without
COSTMODEL_STAR = {"clients": 150, "bulk_mib": 256, "stoptime": 60,
                  "seed": 1}
NO_MODEL = "/nonexistent-no-model"
TUNED_KEYS = ("digest", "events", "rounds", "completed", "forwards")


def run_calibration(path: str) -> dict:
    """``python -m shadow_tpu_torch.prof calibrate --batched`` on cuda into
    ``path`` (one bounded child), its status row printed."""
    from shadow_tpu_torch.prof.calibrate import run_calibration as calib
    t0 = time.perf_counter()
    row = calib(path, wall_cap_sec=COSTMODEL_WALL_CAP_S, batched=True,
                device="cuda")
    wall = time.perf_counter() - t0
    if not row.get("ok"):
        fail(f"calibration failed: {json.dumps(row)[:1500]}")
    meas = row["measured"]
    print(f"calibration: {wall:.1f} s (child {row['child_wall_sec']} s), "
          f"{row['step_points']} step points, {row['collective_points']} "
          f"exchange entries, truncated {row['truncated']}", flush=True)
    for p in meas["step_kernel"]:
        print(f"  step kernel F={p['flows']}: {p['us_per_step']} us a tick "
              f"(min {p['min_us_per_step']}, max {p['max_us_per_step']}, "
              f"{p['steps']} ticks a launch)", flush=True)
    for d, r in sorted(meas["exchange"].items(), key=lambda x: int(x[0])):
        print(f"  exchange D={d} (F {r['flows_padded']} padded, {r['legs']} "
              f"legs, {r['cross_edges']} cross edges, pair width "
              f"{r['pair_width']}): a tick single {r['single_us']} us, "
              f"fused {r['fused_us']}, ppermute {r['ppermute_us']}; the "
              f"cross-free twin ({r['cross_free_flows_padded']} padded): "
              f"single {r['single_cf_us']}, mesh {r['cross_free_us']}; "
              f"differences {r['diff_us']}", flush=True)
    print(f"  exchange tables: {json.dumps(row['collectives'])}", flush=True)
    print(f"  transfer: {row['transfer']} (median, min, max: "
          f"{meas['transfer']})", flush=True)
    for p in (row.get("fleet_batched") or {}).get("points", []):
        print(f"  batched W={p['width']}: {p['us_per_lane_step']} us a lane "
              f"tick (min {p['min_us_per_lane_step']}, max "
              f"{p['max_us_per_lane_step']}), {p['speedup_vs_serial']}x W=1",
              flush=True)
    if row["truncated"]:
        fail("the calibration was truncated by its wall cap")
    if row["step_points"] < 5 or any(
            f"{d}x2" not in row["collectives"]["psum"] for d in (2, 3, 4, 8)):
        fail("the calibration lacks step points or exchange entries")
    row["wall_s"] = wall
    return row


def check_costmodel(path: str) -> dict:
    """``simprof check`` on the calibrated model (ok, loads for cuda runs
    here, both drills refused), and the JAX package's COSTMODEL.json
    refused: by load_model and, as one warning and status ``refused``, by
    load_for_engine."""
    from shadow_tpu_torch.core.logger import SimLogger, set_logger
    from shadow_tpu_torch.core.options import Options
    from shadow_tpu_torch.prof import model as prof_model
    from shadow_tpu_torch.prof.cli import check_model
    chk = check_model(path)
    if not (chk["ok"] and chk.get("loads_on_this_box")
            and chk.get("stale_fingerprint_refused")
            and chk.get("tampered_digest_refused")):
        fail(f"simprof check of the calibrated model: {json.dumps(chk)}")
    jax_model = os.path.join(HERE, "COSTMODEL.json")
    try:
        prof_model.load_model(jax_model, device="cuda")
        fail("the JAX package's COSTMODEL.json loaded in the port")
    except prof_model.CostModelError as e:
        refusal = str(e)
    import io
    stream = io.StringIO()
    log = SimLogger(stream=stream, level="warning")
    set_logger(log)
    got = prof_model.load_for_engine(Options(cost_model=jax_model))
    log.flush()
    warnings = [ln for ln in stream.getvalue().splitlines()
                if "cost model refused" in ln]
    if got != (None, "refused") or len(warnings) != 1:
        fail(f"load_for_engine on COSTMODEL.json: {got}, {len(warnings)} "
             "warnings")
    print(f"simprof check: ok, loads on this card, drills refused "
          f"(fingerprint {json.dumps(chk['fingerprint'])}); the JAX "
          f"package's COSTMODEL.json refused ({refusal[:160]}...)",
          flush=True)
    return chk


def run_tor10k_tuned(path: str, base) -> dict:
    """The tor10k slice under tpu with ``--cost-model path``: the digest,
    events, rounds, completed flows and forwards of EXPECTED10K; the
    tuner's decision, the launch attribution and the wall beside the
    tor10k phase's (one run each)."""
    run = run_tor10k(cost_model=path)
    if run["rc"] != 0 or run["mode"] != "device" or run["demoted"]:
        fail(f"tuned tor10k: rc {run['rc']}, mode {run['mode']}")
    for key in TUNED_KEYS:
        if run[key] != EXPECTED10K[key]:
            fail(f"tuned tor10k {key}: {run[key]} != JAX run's "
                 f"{EXPECTED10K[key]}")
    if not run["span_launches"] == run["pack_launches"] == run["dispatches"]:
        fail(f"tuned tor10k: span {run['span_launches']}, pack "
             f"{run['pack_launches']}, dispatches {run['dispatches']}")
    if run["prof.autotune_source"] != "model":
        fail(f"tuned tor10k: autotune source {run['prof.autotune_source']}")
    if run["prof.autotune_flush_compact"] != 0:
        fail("tuned tor10k: a capped flush on the card")
    if base and run["prof.autotune_k"] == base["prof.autotune_k"] and (
            run["dispatches"], run["superwindows"]) != (
                base["dispatches"], base["superwindows"]):
        fail(f"tuned tor10k: the tor10k phase's K, but {run['dispatches']} "
             f"dispatches and {run['superwindows']} superwindows against "
             f"{base['dispatches']} and {base['superwindows']}")
    pred = run.get("prof.launch_predicted_us") or {}
    meas = run.get("prof.launch_measured_us") or {}

    def mean(h):
        return h["sum"] / h["count"] if h.get("count") else None
    run["predicted_mean_us"], run["measured_mean_us"] = mean(pred), mean(meas)
    base_wall = base["wall_s"] if base else None
    print(f"tuned tor10k: == EXPECTED10K in {', '.join(TUNED_KEYS)}; "
          f"autotune source {run['prof.autotune_source']}, K "
          f"{run['prof.autotune_k']} (would {run['prof.autotune_k_would']}), "
          f"cadence {run['prof.autotune_cadence']}, compaction "
          f"{run['prof.autotune_flush_compact']}, predicted "
          f"{run['prof.autotune_predicted_us']} us a launch; "
          f"{run['dispatches']} dispatches, {run['superwindows']} "
          f"superwindows, {run['rounds_per_launch']:.3f} rounds a launch "
          f"(the tor10k phase: {base and base['dispatches']}, "
          f"{base and base['superwindows']}, "
          f"{base and base['rounds_per_launch']}); attribution: {run['prof.launches_checked']} "
          f"launches checked, predicted window p50 {pred.get('p50')} us "
          f"(mean {run['predicted_mean_us']}), measured p50 "
          f"{meas.get('p50')} us (mean {run['measured_mean_us']}), "
          f"model_stale {run['prof.model_stale']}; wall {run['wall_s']:.3f} "
          f"s beside the tor10k phase's {base_wall} s (one run each)",
          flush=True)
    return run


def run_mesh_modes(path: str) -> dict:
    """The small device-traffic Tor config (COSTMODEL_MESH) at
    --tpu-devices 8 under tpu on cuda, four times: with the model, without
    a model, and with each exchange mode forced (with the model).  The four
    digests are one; the model's run reads ``mesh.exchange_source`` model,
    ``mesh.cost_model`` loaded."""
    import torch
    from shadow_tpu_torch.core import configuration
    from shadow_tpu_torch.core.checkpoint import state_digest
    from shadow_tpu_torch.core.controller import Controller
    from shadow_tpu_torch.core.logger import SimLogger, set_logger
    from shadow_tpu_torch.core.options import Options
    from shadow_tpu_torch.tools.workloads import tor_network
    cm = COSTMODEL_MESH
    xml = tor_network(cm["n_relays"], stoptime=cm["stoptime"],
                      device_data=True)
    runs = {}
    for label, model, mode in (("model", path, "auto"),
                               ("no model", NO_MODEL, "auto"),
                               ("fused", path, "fused"),
                               ("ppermute", path, "ppermute")):
        set_logger(SimLogger(level="warning"))
        ctl = Controller(Options(
            scheduler_policy="tpu", device="cuda", workers=0, seed=cm["seed"],
            tpu_devices=cm["shards"], stop_time_sec=cm["stoptime"],
            log_level="warning", cost_model=model, exchange_mode=mode),
            configuration.parse_xml(xml))
        _reset_counts()
        t0 = time.perf_counter()
        rc = ctl.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        eng = ctl.engine
        st = eng.device_plane.stats()
        sc = eng.metrics.scrape()
        r = {"rc": rc, "digest": state_digest(eng),
             "events": eng.events_executed, "rounds": eng.rounds_executed,
             "completed": st["completed"], "forwards": st["forwards"],
             "dispatches": st["dispatches"], "flows": eng.device_plane.n_flows,
             "superwindows": st["superwindows"],
             "rounds_per_launch": st["rounds_per_launch"],
             "counts": _counts(), "wall_s": wall}
        r.update({k: v for k, v in sc.items()
                  if k.startswith(("mesh.", "prof.autotune"))})
        runs[label] = r
        print(f"mesh modes, {label}: rc {rc}, digest {r['digest'][:16]}..., "
              f"events {r['events']}, F {r['flows']}, exchange "
              f"{r['mesh.exchange_mode']} [{r['mesh.exchange_source']}], "
              f"cost model {r['mesh.cost_model']}, predicted "
              f"{r['mesh.predicted_us']} us a tick, autotune "
              f"{r['prof.autotune_source']} K {r['prof.autotune_k']}, "
              f"{r['dispatches']} dispatches = {r['counts']['mesh_span']} "
              f"mesh span launches, {r['superwindows']} superwindows, "
              f"{r['rounds_per_launch']} rounds a launch, wall {wall:.3f} s",
              flush=True)
        if rc != 0 or r["completed"] == 0:
            fail(f"mesh modes {label}: rc {rc}, {r['completed']} completed")
        if r["counts"]["mesh_span"] != r["dispatches"] or \
                r["counts"]["mesh_pack"] != r["dispatches"]:
            fail(f"mesh modes {label}: {r['counts']} for {r['dispatches']} "
                 "dispatches")
    digests = {k: (r["digest"], r["events"], r["rounds"])
               for k, r in runs.items()}
    if len(set(digests.values())) != 1:
        fail(f"mesh modes: the digests differ: {digests}")
    m = runs["model"]
    if (m["mesh.exchange_source"], m["mesh.cost_model"]) != ("model",
                                                             "loaded"):
        fail(f"mesh modes: the model run's exchange source "
             f"{m['mesh.exchange_source']}, cost model {m['mesh.cost_model']}")
    if runs["no model"]["mesh.exchange_source"] != "heuristic":
        fail("mesh modes: the run without a model did not take the "
             "heuristic")
    for mode in ("fused", "ppermute"):
        if (runs[mode]["mesh.exchange_mode"],
                runs[mode]["mesh.exchange_source"]) != (mode, "forced"):
            fail(f"mesh modes: forced {mode} ran "
                 f"{runs[mode]['mesh.exchange_mode']}")
    u = runs["no model"]
    if m["prof.autotune_k"] == u["prof.autotune_k"] and (
            m["dispatches"], m["superwindows"]) != (u["dispatches"],
                                                    u["superwindows"]):
        fail(f"mesh modes: one K, but {m['dispatches']} and "
             f"{u['dispatches']} dispatches")
    print(f"mesh modes: the four digests are one; the model picked "
          f"{m['mesh.exchange_mode']} at D = {cm['shards']} "
          f"(predicted {m['mesh.predicted_us']} us a tick); its K "
          f"{m['prof.autotune_k']} against {u['prof.autotune_k']} untuned: "
          f"{m['dispatches']} against {u['dispatches']} dispatches, "
          f"{m['rounds_per_launch']} against {u['rounds_per_launch']} "
          f"rounds a launch", flush=True)
    return runs


def run_superwindow(path: str) -> dict:
    """The bulk star (COSTMODEL_STAR) under tpu on cuda at D = 1 and
    D = 8, each with the model and without: one digest, events, rounds and
    completed flows for all four; with the model a K deeper than the
    untuned 8, fewer dispatches and more rounds a launch than the untuned
    run of the same D; each dispatch one launch of its span and flush
    kernels."""
    import torch
    from shadow_tpu_torch.core import configuration
    from shadow_tpu_torch.core.checkpoint import state_digest
    from shadow_tpu_torch.core.controller import Controller
    from shadow_tpu_torch.core.logger import SimLogger, set_logger
    from shadow_tpu_torch.core.options import Options
    from shadow_tpu_torch.tools.workloads import star_bulk
    cs = COSTMODEL_STAR
    xml = star_bulk(cs["clients"], stoptime=cs["stoptime"],
                    bulk_bytes=cs["bulk_mib"] << 20, device_data=True)
    runs = {}
    for d in (1, 8):
        span, pack = ("span", "pack") if d == 1 else ("mesh_span",
                                                      "mesh_pack")
        for tuned in (True, False):
            label = f"D={d} {'model' if tuned else 'no model'}"
            set_logger(SimLogger(level="warning"))
            ctl = Controller(Options(
                scheduler_policy="tpu", device="cuda", workers=0,
                seed=cs["seed"], tpu_devices=d,
                stop_time_sec=cs["stoptime"], log_level="warning",
                cost_model=path if tuned else NO_MODEL),
                configuration.parse_xml(xml))
            _reset_counts()
            t0 = time.perf_counter()
            rc = ctl.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            eng = ctl.engine
            st = eng.device_plane.stats()
            sc = eng.metrics.scrape()
            r = runs[label] = {
                "rc": rc, "digest": state_digest(eng),
                "events": eng.events_executed,
                "rounds": eng.rounds_executed, "completed": st["completed"],
                "flows": eng.device_plane.n_flows,
                "dispatches": st["dispatches"],
                "superwindows": st["superwindows"],
                "rounds_per_launch": st["rounds_per_launch"],
                "source": sc["prof.autotune_source"],
                "k": sc["prof.autotune_k"], "counts": _counts(),
                "wall_s": wall}
            print(f"superwindow, {label}: rc {rc}, digest "
                  f"{r['digest'][:16]}..., events {r['events']}, rounds "
                  f"{r['rounds']}, completed {r['completed']}, F "
                  f"{r['flows']}, autotune {r['source']} K {r['k']}, "
                  f"{r['dispatches']} dispatches, {r['superwindows']} "
                  f"superwindows, {r['rounds_per_launch']} rounds a launch, "
                  f"wall {wall:.3f} s", flush=True)
            c = r["counts"]
            if rc != 0 or r["completed"] != cs["clients"]:
                fail(f"superwindow {label}: rc {rc}, {r['completed']} "
                     "completed")
            if not c[span] == c[pack] == r["dispatches"] > 0:
                fail(f"superwindow {label}: {c[span]} {span} and {c[pack]} "
                     f"{pack} launches for {r['dispatches']} dispatches")
        m, u = runs[f"D={d} model"], runs[f"D={d} no model"]
        if (m["source"], u["source"], u["k"]) != ("model", "defaults", 8):
            fail(f"superwindow D={d}: autotune {m['source']} and "
                 f"{u['source']} K {u['k']}")
        if not (m["k"] > u["k"] and m["dispatches"] < u["dispatches"]
                and m["rounds_per_launch"] > u["rounds_per_launch"]):
            fail(f"superwindow D={d}: the model's K {m['k']} merged no more "
                 f"rounds than K {u['k']}: {m['dispatches']} against "
                 f"{u['dispatches']} dispatches, {m['rounds_per_launch']} "
                 f"against {u['rounds_per_launch']} rounds a launch")
    keys = {k: (r["digest"], r["events"], r["rounds"], r["completed"])
            for k, r in runs.items()}
    if len(set(keys.values())) != 1:
        fail(f"superwindow: the runs differ: {keys}")
    print("superwindow: the four digests are one; the model's K "
          + ", ".join(f"{runs[f'D={d} model']['k']} at D = {d}: "
                      f"{runs[f'D={d} model']['dispatches']} dispatches "
                      f"against {runs[f'D={d} no model']['dispatches']} at "
                      "K 8" for d in (1, 8)), flush=True)
    return runs


PHASES = ("build", "analyzers", "kernels", "times", "mesh-kernels", "mesh-times",
          "mesh-cards-kernels", "tor1k", "tor1k-trace", "tor1k-matrix",
          "tor10k", "tor10k-trace", "native", "procs", "plugins",
          "mesh10k", "mesh10k-trace", "mesh-cards", "costmodel",
          "fleet-kernels",
          "fleet-times",
          "fleet-smoke", "simfuzz", "sweep", "sweep-trace", "model-kernels",
          "model-times", "models", "models-trace")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write every measurement here as JSON")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES)
                    + " (default: all)")
    ap.add_argument("--pairs-against", default=None, metavar="DIR",
                    help="time saturate.cu and admit_sorted.cu against "
                    "those of the checkout at DIR, in turns (after the "
                    "build)")
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
    if "analyzers" in want:
        phase("analyzers: simlint, simrace, simtwin, simjit and simgen "
              "--check over this checkout; tor10k under a sync audit")
        res["analyzers"] = run_analyzers()
    if args.pairs_against:
        phase(f"pairs: saturate and admit_sorted against "
              f"{args.pairs_against}, {PAIRS} pairs in turns")
        res["pairs"] = run_pairs(os.path.abspath(args.pairs_against))
    plane = None
    if want & {"kernels", "times", "mesh-kernels", "mesh-times",
               "mesh-cards-kernels"}:
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
        long_table = LongNodeTable()
        print(f"long-node table: F {long_table.n_flows} C "
              f"{long_table.n_chains} H {long_table.n_nodes}, longest node "
              f"{long_table.longest} flows", flush=True)
        res["span_err"] = max(res["span_err"], check_torcells(long_table))
        res["pack_err"] = check_pack(plane.n_chains, plane.n_nodes)
    if "times" in want:
        phase("times")
        res["hop_times"] = time_kernel()
        res["torcells_times"] = time_torcells(plane)
    if "mesh-kernels" in want:
        phase("mesh kernels vs plain versions (mesh_span + the mesh flush "
              "on the tor10k table at D in 8, 3, 2 and the long-node table "
              "at D = 2; the sharded hop)")
        res["mesh_err"] = check_mesh(plane)
        # nodes longer than a tile and the 512-flow chunk, on 2 shards
        long_table = LongNodeTable()
        print(f"long-node table: F {long_table.n_flows} H "
              f"{long_table.n_nodes}, longest node {long_table.longest} "
              "flows", flush=True)
        res["mesh_err"] = max(res["mesh_err"], check_mesh(
            long_table, MESH_LONG_NODE_CHECK))
        res["mesh_capped_err"] = check_capped_mesh(plane)
        res["hop_sharded_err"] = check_sharded_hop()
    if "mesh-times" in want:
        phase("mesh times: a mesh dispatch beside the single-table span, "
              "the sharded hop beside packet_hop")
        res["mesh_times"] = time_mesh(plane)
    if "mesh-cards-kernels" in want:
        phase("mesh over cards: the card entry of mesh_span against its "
              "plain version and the one-card mesh (tor10k table, D = 8, "
              "over 2 and 4 aliased cards); the sharded hop over cards; "
              "their times")
        t0 = time.perf_counter()
        res["mesh_cards_checked"] = check_mesh_cards(plane)
        res["hop_cards_checked"] = check_sharded_hop_cards()
        res["mesh_cards_times"] = time_mesh_cards(plane)
        print(f"mesh-cards-kernels phase: {time.perf_counter() - t0:.1f} s",
              flush=True)
    plane = None
    # a slice and its trace in one run, traced, when both are asked for
    # (the profiler costs the host ~3%; the checks of both are made on it)
    once = {k for k in ("tor1k", "tor10k", "mesh10k")
            if {k, k + "-trace"} <= want}
    if "tor1k" in want:
        phase("slice: tor1k under --scheduler-policy=tpu on cuda"
              + (", profiled" if "tor1k" in once else ""))
        tpu = res["tor1k_tpu"] = retake(
            lambda: run_slice("tpu", trace=True)) if "tor1k" in once \
            else run_slice("tpu")
        phase("slice: tor1k under --scheduler-policy=global")
        glob = res["tor1k_global"] = run_slice("global")
        check_slice(tpu, glob)
        print(f"tor1k tpu: wall {tpu['wall_s']:.3f} s, "
              f"{tpu['events_per_s']:.0f} events/s, device_ns "
              f"{tpu['device_ns']}, host_flush_ns {tpu['host_flush_ns']}, "
              f"launches {tpu['launches']}, {tpu['plane']} data plane; "
              f"global: wall {glob['wall_s']:.3f} s, "
              f"{glob['events_per_s']:.0f} events/s, --dataplane=auto ran "
              f"the {glob['plane']} data plane ({glob['scheduler']})",
              flush=True)
    if "tor1k-trace" in want:
        phase("trace: tor1k under --scheduler-policy=tpu on cuda, profiled")
        traced = res["tor1k_traced"] = res["tor1k_tpu"] if "tor1k" in once \
            else retake(lambda: run_slice("tpu", trace=True))
        if "tor1k_tpu" in res and traced["digest"] != res["tor1k_tpu"][
                "digest"]:
            fail("the profiled tpu run's digest differs from the "
                 "unprofiled one")
        if traced["digest"] != EXPECTED["digest"]:
            fail("the profiled tpu run's digest differs from the JAX run's")
        if traced["hop_kernels"] != traced["launches"]:
            fail(f"the trace holds {traced['hop_kernels']} packet_hop "
                 f"kernels for {traced['launches']} counted launches")
        # a round is one kernel on its host-resident buffers: the only
        # copies are the topology's two matrices, uploaded once
        if traced["copies"] > TOR1K_SETUP_COPIES:
            fail(f"the tor1k trace holds {traced['copies']} copies for "
                 f"{traced['launches']} rounds (at most "
                 f"{TOR1K_SETUP_COPIES}, the matrices' upload)")
        traced["card_us_per_round"] = \
            traced["busy_s"] * 1e6 / traced["launches"]
        print(f"tor1k tpu traced: wall {traced['wall_s']:.3f} s, card busy "
              f"{traced['busy_s']:.6f} s over {traced['device_events']} "
              f"device intervals, idle share {traced['idle_share']:.6f}; "
              f"packet_hop {traced['hop_kernels']} kernels, "
              f"{traced['hop_kernel_s']:.6f} s, mean "
              f"{traced['hop_kernel_mean_us']:.3f} us; copies "
              f"{traced['copies']} ({traced['copy_s']:.6f} s); card time a "
              f"round {traced['card_us_per_round']:.3f} us", flush=True)
    if "tor1k-matrix" in want:
        phase("slice: tor1k under tpu with --tpu-devices 4 "
              "--tpu-shard-matrix on cuda")
        res["tor1k_matrix"] = run_tor1k_matrix()
    if "tor10k" in want:
        phase("slice: tor10k, device clients, --scheduler-policy=tpu on "
              "cuda" + (", profiled" if "tor10k" in once else ""))
        res["tor10k"] = retake(lambda: run_tor10k(trace=True)) \
            if "tor10k" in once else run_tor10k()
        check_tor10k(res["tor10k"])
    if "tor10k-trace" in want:
        phase("trace: tor10k under --scheduler-policy=tpu on cuda, "
              "profiled")
        tr = res["tor10k_traced"] = res["tor10k"] if "tor10k" in once \
            else retake(lambda: run_tor10k(trace=True))
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
              f"copies {tr['copies']}, {tr['copy_s']:.6f} s "
              f"({tr['copy_s'] / tr['busy_s']:.4f} of busy); span "
              f"{tr['span_kernels']} x "
              f"{tr['span_kernel_mean_us']:.1f} us = "
              f"{tr['span_kernel_s']:.6f} s; pack {tr['pack_kernels']} x "
              f"{tr['pack_kernel_mean_us']:.2f} us; hop {tr['hop_kernels']}"
              f" x {tr['hop_kernel_mean_us']:.3f} us", flush=True)
    if "native" in want:
        phase("native: tor1k under global on the C data plane and the "
              "Python plane; tor10k under global on the C plane, on cuda")
        res["native"] = run_native(res.get("tor10k"))
    if "procs" in want:
        phase("procs: tor1k with --processes 2 under tpu and global on "
              "cuda; a shard resurrected")
        res["procs"] = run_procs()
    if "plugins" in want:
        phase("plugins: exec: and pool: native plugins under global and tpu "
              "on cuda")
        res["plugins"] = run_plugins()
    if "mesh10k" in want:
        phase("slice: tor10k with --tpu-devices 8 on cuda (the plane on 8 "
              "shards of the card, the hop batch-sharded)")
        res["mesh10k"] = retake(lambda: run_tor10k_mesh(trace=True)) \
            if "mesh10k" in once else run_tor10k_mesh()
        check_tor10k_mesh(res["mesh10k"])
    if "mesh10k-trace" in want:
        phase("trace: the tor10k mesh slice under torch.profiler")
        tr = res["mesh10k_traced"] = res["mesh10k"] \
            if "mesh10k" in once else retake(
                lambda: run_tor10k_mesh(trace=True))
        check_tor10k_mesh(tr)
        if "mesh10k" in res and tr["digest"] != res["mesh10k"]["digest"]:
            fail("the profiled tor10k mesh run's digest differs from the "
                 "unprofiled one")
        for key in MESH_KERNELS:
            if tr[f"{key}_kernels"] != tr["counts"][key]:
                fail(f"the mesh trace holds {tr[key + '_kernels']} {key} "
                     f"kernels for {tr['counts'][key]} counted launches")
        for key in ("span", "pack", "hop"):
            if tr[f"{key}_kernels"]:
                fail(f"the mesh trace holds {tr[key + '_kernels']} {key} "
                     "kernels of the single-table path")
        print(f"tor10k mesh traced: wall {tr['wall_s']:.3f} s, card busy "
              f"{tr['busy_s']:.6f} s, idle share {tr['idle_share']:.6f}, "
              f"copies {tr['copy_s']:.6f} s; mesh span "
              f"{tr['mesh_span_kernels']} x "
              f"{tr['mesh_span_kernel_mean_us']:.1f} us = "
              f"{tr['mesh_span_kernel_s']:.6f} s; mesh flush "
              f"{tr['mesh_pack_kernels']} x "
              f"{tr['mesh_pack_kernel_mean_us']:.2f} us; sharded hop "
              f"{tr['hop_s_kernels']} x {tr['hop_s_kernel_mean_us']:.3f} us",
              flush=True)
    if "mesh-cards" in want:
        phase("mesh over cards: tor10k at --tpu-devices 8 over 2 aliased "
              "cards under the sync audit; tor100 row-sharded over 4 aliased "
              "cards against one card")
        t0 = time.perf_counter()
        res["mesh_cards"] = run_mesh_cards(res)
        print(f"mesh-cards phase: {time.perf_counter() - t0:.1f} s",
              flush=True)
    if "costmodel" in want:
        phase("costmodel: calibrate this card, check the model, tor10k "
              "tuned by it, the mesh's exchange from it, its deeper "
              "superwindow")
        import tempfile
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="costmodel-") as td:
            path = os.path.join(td, "COSTMODEL_TORCH.json")
            cm = res["costmodel"] = {"calibration": run_calibration(path)}
            cm["check"] = check_costmodel(path)
            cm["tor10k"] = run_tor10k_tuned(path, res.get("tor10k"))
            cm["mesh_modes"] = run_mesh_modes(path)
            cm["superwindow"] = run_superwindow(path)
        cm["wall_s"] = time.perf_counter() - t0
        print(f"costmodel phase: {cm['wall_s']:.1f} s", flush=True)
    fp = lanes = None
    if want & {"fleet-kernels", "fleet-times"}:
        t0 = time.perf_counter()
        planes = [sweep_plane(s) for s in SWEEP["seeds"]]
        fp, lanes = fleet_lanes(planes)
        print(f"sweep lanes' planes built in {time.perf_counter() - t0:.1f} "
              "s", flush=True)
    if "fleet-kernels" in want:
        phase("fleet kernels vs plain versions (the sweep's class, W = 8)")
        res.update(check_fleet_kernels(planes, fp, lanes))
        res["span_b_err"] = max(res["span_b_err"],
                                check_fleet_widths(planes, fp, lanes),
                                check_long_node_batched(LongNodeTable()))
    if "fleet-times" in want:
        phase("fleet times: one batched dispatch vs W serial dispatches")
        res["fleet_times"] = time_fleet(planes, fp, lanes)
    planes = fp = lanes = None
    if "fleet-smoke" in want:
        phase("simfleet smoke on cuda: 8 fuzz seeds as 8 lanes")
        res["fleet_smoke"] = run_fleet_smoke()
    if "simfuzz" in want:
        phase("F1 simfuzz on cuda: the corpus, the fault drill, the bounded "
              "child and an overrun, a batched seed")
        res["simfuzz"] = run_simfuzz()
    if want & {"sweep", "sweep-trace"}:
        phase("sweep: genscen tor10k seeds 1..8, each run serially on cuda")
        res["sweep_serial"] = run_sweep_serial()
        ser = list(res["sweep_serial"].values())
        n_span = sum(r["counts"]["span"] for r in ser)
        span_ms = sum(r["span_ms"] for r in ser)
        ticks = sum(r["steps"] for r in ser)
        print(f"sweep serial: torcells_span {n_span} launches in the 8 "
              f"lanes, {span_ms:.3f} ms of card time (CUDA events), "
              f"{span_ms / max(n_span, 1):.4f} ms a launch, "
              f"{span_ms * 1e3 / max(ticks, 1):.3f} us a tick over {ticks} "
              "ticks", flush=True)
    if "sweep" in want:
        phase("sweep: the 8 seeds as one fleet of 8 lanes on cuda")
        res["sweep"] = run_sweep(res["sweep_serial"])
    if "sweep-trace" in want:
        phase("trace: the sweep's fleet under torch.profiler")
        tr = res["sweep_traced"] = retake(
            lambda: run_sweep(res["sweep_serial"], trace=True))
        print(f"sweep traced: wall {tr['wall_s']:.3f} s, card busy "
              f"{tr['busy_s']:.6f} s, idle share {tr['idle_share']:.6f}, "
              f"copies {tr['copy_s']:.6f} s; batched span "
              f"{tr['span_b_kernels']} x {tr['span_b_kernel_mean_us']:.1f} "
              f"us = {tr['span_b_kernel_s']:.6f} s; batched pack "
              f"{tr['pack_b_kernels']} x {tr['pack_b_kernel_mean_us']:.2f} "
              "us", flush=True)

    if want & {"model-kernels", "model-times"}:
        phase("model kernels vs plain versions (phold, saturate, "
              "torcells_run and the windowed step, admit_sorted)")
        res["models_checked"], model_inputs = check_models()
    if "model-times" in want:
        phase("model times: each kernel at the main path's inputs")
        res["model_times"] = time_models(res["models_checked"],
                                         model_inputs)
    model_inputs = None
    if "models" in want:
        phase("models: the model workloads (modelbench) on cuda")
        res["models"] = run_models()
    if "models-trace" in want:
        phase("trace: the model workloads under torch.profiler")
        tr = res["models_traced"] = retake(lambda: run_models(trace=True))
        print(f"models traced: wall {tr['wall_s']:.3f} s, card busy "
              f"{tr['busy_s']:.6f} s, idle share {tr['idle_share']:.6f}, "
              f"copies {tr['copy_s']:.6f} s; "
              + "; ".join(f"{k} {tr[k + '_kernels']} x "
                          f"{tr[k + '_kernel_mean_us']:.1f} us"
                          for k in MODEL_KERNELS), flush=True)

    def get(*keys):
        cur = res
        for k in keys:
            if not isinstance(cur, dict) or k not in cur:
                return None
            cur = cur[k]
        return cur

    ser = (res.get("sweep_serial") or {}).values()
    sweep_span = (sum(r["counts"]["span"] for r in ser) or None,
                  sum(r["span_ms"] for r in ser) or None)
    hop = get("hop_times", MAIN_B) or {}
    hop_err = max((e for e in [res.get("hop_err")]
                   + [r["err"] for r in (res.get("hop_times") or {}).values()]
                   if e is not None), default=None)
    span = get("torcells_times", "span") or {}
    pack = get("torcells_times", "pack") or {}
    fleet = get("fleet_times", max(FLEET_WIDTHS)) or {}
    kernels = [
        {"name": "packet_hop", "route": "cuda",
         "source": "shadow_tpu_torch/ops/csrc/packet_hop.cu",
         "replaces": "shadow_tpu/ops/round_step.py:97",
         "launches": get("tor1k_tpu", "launches"),
         "max_abs_err": hop_err,
         "ms": hop.get("kernel_ms"), "plain_ms": hop.get("plain_ms"),
         "bound_ms": hop.get("bound_ms"), "bound_by": hop.get("bound_by"),
         "library_ms": None,
         "ms_device_operands": hop.get("device_operands_ms"),
         "roundtrip_ms": hop.get("roundtrip_ms"),
         "card_us_per_round": get("tor1k_traced", "card_us_per_round")},
        {"name": "torcells_span", "route": "cuda",
         "source": "shadow_tpu_torch/ops/csrc/torcells_span.cu",
         "replaces": "shadow_tpu/ops/torcells_device.py:428",
         "launches": get("tor10k", "span_launches"),
         "max_abs_err": res.get("span_err"), "ms": span.get("ms"),
         "plain_ms": span.get("plain_ms"), "bound_ms": span.get("bound_ms"),
         "bound_by": span.get("bound_by"), "library_ms": None,
         "us_per_tick": (span.get("ms_per_tick") or 0) * 1e3 or None,
         "sweep_serial_launches": sweep_span[0],
         "sweep_serial_ms": sweep_span[1]},
        {"name": "pack_flush", "route": "cuda",
         "source": "shadow_tpu_torch/ops/csrc/pack_flush.cu",
         "replaces": "shadow_tpu/ops/torcells_device.py:337",
         "launches": get("tor10k", "pack_launches"),
         "max_abs_err": res.get("pack_err"), "ms": pack.get("ms"),
         "plain_ms": pack.get("plain_ms"), "bound_ms": pack.get("bound_ms"),
         "bound_by": pack.get("bound_by"), "library_ms": None},
        {"name": "torcells_span_batched", "route": "cuda",
         "source": "shadow_tpu_torch/ops/csrc/torcells_span_batched.cu",
         "replaces": "shadow_tpu/ops/torcells_device.py:586",
         "launches": get("sweep", "counts", "span_b"),
         "max_abs_err": res.get("span_b_err"), "ms": fleet.get("span_ms"),
         "plain_ms": fleet.get("plain_ms"),
         "bound_ms": fleet.get("span_bound_ms"),
         "bound_by": fleet.get("span_bound_by"), "library_ms": None,
         "us_per_tick": fleet.get("span_us_per_tick")},
        {"name": "pack_flush_batched", "route": "cuda",
         "source": "shadow_tpu_torch/ops/csrc/pack_flush.cu",
         "replaces": "shadow_tpu/ops/torcells_device.py:586",
         "launches": get("sweep", "counts", "pack_b"),
         "max_abs_err": res.get("pack_b_err"), "ms": fleet.get("pack_ms"),
         "plain_ms": fleet.get("pack_plain_ms"),
         "bound_ms": fleet.get("pack_bound_ms"),
         "bound_by": fleet.get("pack_bound_by"), "library_ms": None}]
    checked = res.get("models_checked") or {}
    mt = res.get("model_times") or {}
    admit = (mt.get("admit") or {}).get(max(ADMIT_SIZES)) or {}
    model_rows = (
        ("phold", "shadow_tpu/ops/phold_device.py:38", mt.get("phold")),
        ("saturate", "shadow_tpu/ops/saturate_device.py:46",
         mt.get("saturate")),
        ("torcells_run", "shadow_tpu/ops/torcells_device.py:104",
         mt.get("torcells_run")),
        ("admit_sorted", "shadow_tpu/ops/bandwidth.py:67", admit))
    for name, replaces, row in model_rows:
        row = row or {}
        errs = checked.get("admit") if name == "admit_sorted" else None
        err = (max(r["err"] for r in errs.values()) if errs
               else (checked.get(name) or {}).get("err"))
        if name == "torcells_run" and err is not None:
            err = max(err, checked.get("window_err", 0))
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"shadow_tpu_torch/ops/csrc/{name}.cu",
            "replaces": replaces,
            "launches": get("models", "counts", name),
            "max_abs_err": err, "ms": row.get("ms"),
            "plain_ms": row.get("plain_ms"), "bound_ms": row.get("bound_ms"),
            "bound_by": row.get("bound_by"), "library_ms": None})
    run_row = mt.get("torcells_run") or {}
    kernels[-2].update(plan=run_row.get("plan"),
                       wide_ms=run_row.get("wide_ms"),
                       wide_plan=run_row.get("wide_plan"))
    # phold's plain version runs to 3 s (the kernel's ms is to 30 s, the
    # main path's horizon; its time to 3 s is model_times' ms_3s)
    kernels[-4]["plain_horizon_s"] = (mt.get("phold") or {}).get(
        "plain_horizon_s")
    kernels[-4]["ms_at_plain_horizon"] = (mt.get("phold") or {}).get("ms_3s")
    mesh_t = res.get("mesh_times") or {}
    ms_ = mesh_t.get("span") or {}
    mp = mesh_t.get("pack") or {}
    hb = (mesh_t.get("hop") or {}).get("batch") or {}
    hm = (mesh_t.get("hop") or {}).get("matrix") or {}
    for name, source, replaces, launches, err, row in (
            ("mesh_span", "mesh_span.cu",
             "shadow_tpu/parallel/mesh/exchange.py:247",
             get("mesh10k", "counts", "mesh_span"), res.get("mesh_err"), ms_),
            ("pack_flush_mesh", "pack_flush.cu",
             "shadow_tpu/parallel/mesh/exchange.py:473",
             get("mesh10k", "counts", "mesh_pack"), res.get("mesh_err"), mp),
            ("packet_hop_sharded[batch]", "packet_hop_sharded.cu",
             "shadow_tpu/ops/round_step.py:403",
             get("mesh10k", "counts", "hop_s"), res.get("hop_sharded_err"),
             hb),
            ("packet_hop_sharded", "packet_hop_sharded.cu",
             "shadow_tpu/ops/round_step.py:272",
             get("tor1k_matrix", "counts", "hop_s"),
             res.get("hop_sharded_err"), hm)):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"shadow_tpu_torch/ops/csrc/{source}",
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": row.get("ms"), "plain_ms": row.get("plain_ms"),
            "bound_ms": row.get("bound_ms"), "bound_by": row.get("bound_by"),
            "library_ms": None})
    # the batch layout's ms is one batch (the tor10k mesh slice's D = 8
    # slices in one launch), as the main path runs it
    kernels[-2]["ms_is_per"] = "batch of D slices, one launch"
    # the mesh entry with caps: held to its plain version and timed; its
    # launches are the mesh10k run's capped flushes, which must be 0 (the
    # plane turns its caps off before it shards)
    mc = mesh_t.get("pack_capped") or {}
    kernels.append({
        "name": "pack_flush_mesh[capped]", "route": "cuda",
        "source": "shadow_tpu_torch/ops/csrc/pack_flush.cu",
        "replaces": "shadow_tpu/parallel/mesh/exchange.py:473",
        "launches": get("mesh10k", "counts", "mesh_pack_capped"),
        "max_abs_err": res.get("mesh_capped_err"),
        "ms": mc.get("ms"), "plain_ms": mc.get("plain_ms"),
        "bound_ms": mc.get("bound_ms"), "bound_by": mc.get("bound_by"),
        "library_ms": None, "caps": mc.get("caps"),
        "main_path": "none: the plane turns its caps off before it shards "
                     "(launches read from the mesh10k run)"})
    # the mesh over cards: the card entry, and the two kernels it reuses
    # over cards (the mesh flush on the lead card, the sharded hop one
    # launch a card), with their launches in the over-cards runs
    mct = res.get("mesh_cards_times") or {}
    hct = (res.get("hop_cards_checked") or {}).get("times") or {}
    hcb = (hct.get("batch") or {}).get(MESH10K_SHARDS) or {}
    hcm = (hct.get("matrix") or {}).get(TOR100_MATRIX["shards"]) or {}
    c10 = get("mesh_cards", "tor10k", "counts") or {}
    c100 = get("mesh_cards", "tor100_cards", "counts") or {}
    herr = (res.get("hop_cards_checked") or {}).get("err")
    merr = (res.get("mesh_cards_checked") or {}).get("err")
    for name, source, replaces, launches, err, row in (
            ("mesh_span_card", "mesh_span.cu",
             "shadow_tpu/parallel/mesh/exchange.py:247", c10.get("mesh_card"),
             merr, mct),
            ("pack_flush_mesh[cards]", "pack_flush.cu",
             "shadow_tpu/parallel/mesh/exchange.py:473", c10.get("mesh_pack"),
             merr, mp),
            ("packet_hop_sharded[cards, batch]", "packet_hop_sharded.cu",
             "shadow_tpu/ops/round_step.py:403", c10.get("hop_s"), herr, hcb),
            ("packet_hop_sharded[cards, rows]", "packet_hop_sharded.cu",
             "shadow_tpu/ops/round_step.py:272", c100.get("hop_s"), herr,
             hcm)):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"shadow_tpu_torch/ops/csrc/{source}",
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": row.get("ms"), "plain_ms": row.get("plain_ms"),
            "bound_ms": row.get("bound_ms"), "bound_by": row.get("bound_by"),
            "library_ms": None})
    kernels[-4].update(
        cards=MESH10K_CARDS, window=mct.get("window"),
        ms_is_per=f"a {mct.get('ticks')}-tick dispatch over "
        f"{MESH10K_CARDS} aliased cards (CUDA events)",
        one_card_ms=mct.get("one_card_ms"), ratio=mct.get("ratio"),
        boundary_us_median=(mct.get("trace") or {}).get("gap_us_median"),
        ms_by_cards={k: r.get("ms") for k, r in
                     (mct.get("sets") or {}).items()},
        peer_bytes_per_s=mct.get("peer_bytes_per_s"))
    kernels[-3]["ms_is_per"] = ("the mesh flush on the lead card, the same "
                                "kernel and shapes as pack_flush_mesh")
    kernels[-2]["ms_is_per"] = ("a batch over the cards: launches and wait, "
                                "host clock")
    kernels[-1]["ms_is_per"] = kernels[-2]["ms_is_per"]
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
