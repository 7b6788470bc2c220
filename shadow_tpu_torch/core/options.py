"""Simulator options — the CLI flag surface.

Mirrors the reference's Options (core/support/options.c): every knob the
reference exposes has an equivalent here, plus the new ``tpu`` scheduler
policy and device options.  Parsed with argparse; also constructible directly
for tests.

The port keeps the JAX package's flag surface, so a command line moves
between the two unchanged, and adds ``--device {cuda,cpu}`` (default
``cuda``; device.py).  Flags whose paths the port does not run yet are
accepted and refused at run time with NotImplementedError naming the
ROADMAP item (core/controller.py).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import List, Optional, Tuple

SCHEDULER_POLICIES = ("global", "host", "steal", "thread", "threadXthread",
                      "threadXhost", "tpu")
QDISC_KINDS = ("fifo", "rr")
ROUTER_QUEUE_KINDS = ("codel", "single", "static")

_SPEC_PATH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))),
    "spec", "protocol_spec.json")
_FALLBACK_CC_KINDS = ("reno", "aimd", "cubic", "cubicx", "bbrx")


def _cc_kinds_from_spec() -> Tuple[str, ...]:
    """Valid --tcp-congestion-control tokens, in kind-id order, read from
    the authoritative spec.  The JSON is read directly (NOT via
    ops.protocol_tables) so importing options never pulls in jax; an
    installed copy without the spec tree falls back to the baked list."""
    try:
        with open(_SPEC_PATH, encoding="utf-8") as f:
            kinds = json.load(f)["congestion"]["kinds"]
    except (OSError, KeyError, ValueError):
        return _FALLBACK_CC_KINDS
    return tuple(sorted(kinds, key=lambda k: kinds[k]))


TCP_CC_KINDS = _cc_kinds_from_spec()


@dataclasses.dataclass
class Options:
    # Core (reference options.c flags)
    workers: int = 0                     # --workers (0 = serial, nWorkers=0 mode)
    processes: int = 0                   # --processes: shard the simulation
                                         # across N OS processes with a
                                         # conservative round barrier
                                         # (parallel/procs.py) — real
                                         # multicore scaling where the GIL
                                         # caps the threaded policies
    shard_id: int = 0                    # internal: this engine's shard
    shard_count: int = 1                 # internal: total shard engines
    scheduler_policy: str = "steal"      # --scheduler-policy (default steal, options.c:199)
    seed: int = 1                        # --seed
    runahead_ms: int = 0                 # --runahead (0 = derive from topology; floor 10ms)
    bootstrap_end_sec: int = 0           # <shadow bootstraptime>: grace period, no drops
    stop_time_sec: int = 60              # <shadow stoptime>
    stop_time_explicit: bool = False     # --stop-time given on the CLI
    # TCP
    tcp_congestion_control: str = "reno"  # --tcp-congestion-control
    tcp_ssthresh: int = 0                 # --tcp-ssthresh (0 = unset)
    tcp_windows: int = 10                 # --tcp-windows: initial cwnd and
                                          # pre-handshake send-window seed,
                                          # in packets (reference default 10,
                                          # options.c:77; recv window follows
                                          # the buffer size/autotuning)
    # Interface / buffers
    interface_qdisc: str = "fifo"        # --interface-qdisc
    interface_buffer: int = 1024000      # --interface-buffer (bytes)
    interface_batch_ms: int = 1          # --interface-batch: accepted for
                                         # flag parity only — the reference
                                         # parses it and never consumes it
                                         # (options.c:131); refills are
                                         # fixed at 1 ms (defs.py)
    router_queue: str = "codel"          # upstream AQM kind (reference host.c:205 default codel)
    socket_recv_buffer: int = 174760     # --socket-recv-buffer (0 = autotune)
    socket_send_buffer: int = 131072     # --socket-send-buffer (0 = autotune)
    socket_autotune: bool = True
    # CPU model
    cpu_threshold_ns: int = -1           # --cpu-threshold (ns of delay before block; <=0 disables)
    cpu_precision_ns: int = 200          # --cpu-precision
    # Telemetry
    heartbeat_interval_sec: int = 60     # --heartbeat-frequency
    heartbeat_log_level: str = "message"
    log_level: str = "message"           # --log-level
    pcap_dir: Optional[str] = None
    data_directory: str = "shadow.data"
    data_template: Optional[str] = None
    # Device backend
    device: str = "cuda"                 # --device: cuda | cpu (device.py;
                                         # cuda without a card raises)
    tpu_max_inflight: int = 1 << 16      # padded packet-batch capacity
    tpu_devices: int = 0                 # 0 = all local devices
    tpu_shard_matrix: bool = False       # row-shard path matrices over the mesh
    mesh_cards: Optional[tuple] = None   # the mesh's cards (torch devices
                                         # or names, repeats allowed): no
                                         # flag; None = the host's cards
                                         # (parallel/mesh device_mesh)
    tpu_device_threshold: int = 0        # >0: batches below N bypass to numpy
    tpu_chunk: int = 0                   # mid-round async launch size (0=off)
    device_plane: str = "device"         # device | numpy (bit-identical twin)
    dataplane: str = "auto"              # auto | native | python: C data
                                         # plane for eligible serial runs
                                         # (parallel/native_plane.py)
    host_table: str = "auto"             # auto | on | off: struct-of-
                                         # arrays host plane with lazy
                                         # Host materialization
                                         # (scale/hosttable.py); auto = on
                                         # exactly when the config carries
                                         # processless device flows
                                         # (generated scale scenarios)
    device_plane_granule_ms: int = 0     # step size override (0 = auto)
    device_plane_batch_steps: int = 8    # min steps per kernel dispatch
    superwindow_rounds: int = 8          # max lookahead rounds merged into
                                         # one device launch when no host
                                         # event falls inside (1 = off)
    device_plane_sync: bool = False      # block on the dispatch at launch
                                         # (serial oracle; digests identical
                                         # to the pipelined default)
    exchange_mode: str = "auto"          # mesh cross-shard exchange kernel:
                                         # auto = measured cost model when
                                         # calibrated (simprof), else the
                                         # heuristic; fused/ppermute
                                         # force one identical-result
                                         # kernel (digest parity pinned)
    device_autotune: str = "on"          # COSTMODEL-driven dispatch tuner
                                         # (prof/autotune.py): picks the
                                         # effective superwindow depth and
                                         # the delta-compacted flush from
                                         # measured per-box costs; only
                                         # ever chooses between digest-
                                         # identical executions. "off" =
                                         # the hand defaults, untouched
    cost_model: str = ""                 # --cost-model: per-box measured
                                         # cost model path (simprof
                                         # calibrate); "" = $SHADOW_TORCH_
                                         # COSTMODEL or the repo-root
                                         # COSTMODEL_TORCH.json;
                                         # refuses a fingerprint mismatch
                                         # and falls back to heuristics
    # Checkpointing (new capability; absent in the reference — SURVEY.md §5)
    checkpoint_interval_sec: int = 0     # --checkpoint-interval (0 = off)
    checkpoint_every_rounds: int = 0     # --checkpoint-every N rounds (0 = off)
    checkpoint_dir: str = "shadow-checkpoints"  # --checkpoint-dir
    resume_path: Optional[str] = None    # --resume: snapshot file or dir;
                                         # replay-verify to the last good
                                         # snapshot's digest, then continue
    # Supervision / fault recovery (core/supervision.py)
    plugin_watchdog_sec: float = 0.0     # wall-clock silence budget per
                                         # native plugin; 0 = module default
                                         # (SHADOW_TPU_PLUGIN_STALL_TIMEOUT,
                                         # 300 s)
    device_watchdog_sec: float = 300.0   # timeout on collecting an in-flight
                                         # device dispatch (0 = unbounded)
    shard_watchdog_sec: float = 0.0      # parent aborts if a LIVE shard is
                                         # silent this long (0 = only dead-
                                         # shard detection, always on)
    fault_inject: str = ""               # deterministic fault harness
                                         # (supervision.parse_fault_inject)
    max_resurrections: int = 3           # --max-resurrections: dead-shard
                                         # respawn budget per run;
                                         # exceeded = abort loudly with a
                                         # diagnostic, 0 = never
                                         # resurrect (abort on first death)
    repromote_after: int = 0             # --repromote-after R: after a
                                         # demotion, re-attempt the faster
                                         # rung ONCE after R clean rounds
                                         # with the replay guard armed
                                         # (0 = demotions stay permanent)
    # Observability (shadow_tpu/obs/): flight-recorder tracing + metrics
    trace_path: Optional[str] = None     # --trace: Chrome trace-event JSON
                                         # (Perfetto-loadable) written at
                                         # end of run; enables the
                                         # flight-recorder span ring
    trace_ring: int = 0                  # --trace-ring: events kept per
                                         # track (0 = obs.trace.DEFAULT_RING)
    metrics_path: Optional[str] = None   # --metrics: JSONL scrape stream +
                                         # final summary record
    metrics_every_rounds: int = 0        # --metrics-every N rounds cadence
                                         # (0 = MetricsWriter.DEFAULT_EVERY)
    # Misc
    config_path: Optional[str] = None
    test_mode: bool = False              # --test builtin example


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="shadow-tpu-torch",
        description="Discrete-event network simulator (capabilities of "
                    "Shadow 1.14.0) with its per-round packet hop as a "
                    "CUDA kernel: the PyTorch/CUDA port of shadow-tpu.")
    p.add_argument("config_path", nargs="?", help="simulation config (.xml, .yaml, .json)")
    p.add_argument("--workers", type=int, default=0)
    p.add_argument("--processes", type=int, default=0,
                   help="shard hosts across N OS processes exchanging "
                        "packets at round barriers (0 = single process)")
    p.add_argument("--scheduler-policy", choices=SCHEDULER_POLICIES, default="steal",
                   dest="scheduler_policy")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--runahead", type=int, default=0, dest="runahead_ms",
                   help="minimum allowed lookahead window (ms)")
    p.add_argument("--stop-time", type=int, default=None, dest="stop_time_sec")
    p.add_argument("--bootstrap-end", type=int, default=None, dest="bootstrap_end_sec")
    p.add_argument("--tcp-congestion-control", choices=TCP_CC_KINDS, default="reno",
                   dest="tcp_congestion_control")
    p.add_argument("--tcp-ssthresh", type=int, default=0, dest="tcp_ssthresh")
    p.add_argument("--tcp-windows", type=int, default=10, dest="tcp_windows",
                   help="initial TCP windows in packets (reference options.c:138)")
    p.add_argument("--interface-qdisc", choices=QDISC_KINDS, default="fifo",
                   dest="interface_qdisc")
    p.add_argument("--interface-buffer", type=int, default=1024000, dest="interface_buffer")
    p.add_argument("--checkpoint-interval", type=int, default=0,
                   dest="checkpoint_interval_sec",
                   help="write a state snapshot every N virtual seconds")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   dest="checkpoint_every_rounds",
                   help="write a state snapshot every N engine rounds "
                        "(composes with --checkpoint-interval; 0 = off)")
    p.add_argument("--checkpoint-dir", default="shadow-checkpoints",
                   dest="checkpoint_dir")
    p.add_argument("--resume", default=None, dest="resume_path",
                   help="resume from a snapshot file (or the newest good "
                        "snapshot in a checkpoint dir): deterministic "
                        "replay to the snapshot's virtual time, digest-"
                        "verified there, then the run continues")
    p.add_argument("--plugin-watchdog-sec", type=float, default=0.0,
                   dest="plugin_watchdog_sec",
                   help="kill a native plugin silent on its RPC socketpair "
                        "for this many wall seconds; its simulated process "
                        "is marked exited and the run continues (0 = the "
                        "SHADOW_TPU_PLUGIN_STALL_TIMEOUT default, 300 s)")
    p.add_argument("--device-watchdog-sec", type=float, default=300.0,
                   dest="device_watchdog_sec",
                   help="abandon an in-flight device-plane dispatch that "
                        "has not completed after this many wall seconds; "
                        "the window replays on the numpy twin and the "
                        "backend is demoted (0 = wait forever)")
    p.add_argument("--shard-watchdog-sec", type=float, default=0.0,
                   dest="shard_watchdog_sec",
                   help="abort with a diagnostic if a live shard is silent "
                        "this long at a round barrier (0 = no wall limit; "
                        "dead-shard detection is always on)")
    p.add_argument("--fault-inject", default="", dest="fault_inject",
                   help="deterministic fault-injection harness (tests): "
                        "device-dispatch:N | device-dispatch-hang:N | "
                        "plugin-stall:NAME:NREQ | shard-exit:SID:ROUND | "
                        "native-round:N | continuation-batch:N | "
                        "shard-exit-resurrect:SID:ROUND | device-lost:ROUND "
                        "| demote-repromote:N")
    p.add_argument("--max-resurrections", type=int, default=3,
                   dest="max_resurrections",
                   help="respawn a dead shard from the newest verifying "
                        "snapshot (round-zero replay when none exists) up "
                        "to N times per run, with exponential backoff "
                        "between attempts; the budget exhausted aborts "
                        "loudly (0 = never resurrect, abort on first death)")
    p.add_argument("--repromote-after", type=int, default=0,
                   dest="repromote_after",
                   help="recovery-ladder probation: after a demotion "
                        "(device plane -> numpy twin, native executor -> "
                        "per-event), re-attempt the faster rung ONCE after "
                        "R clean rounds with the window-replay guard armed; "
                        "a repeat fault re-demotes permanently (0 = "
                        "demotions stay permanent)")
    p.add_argument("--interface-batch", type=int, default=1, dest="interface_batch_ms")
    p.add_argument("--router-queue", choices=ROUTER_QUEUE_KINDS, default="codel",
                   dest="router_queue")
    p.add_argument("--socket-recv-buffer", type=int, default=174760, dest="socket_recv_buffer")
    p.add_argument("--socket-send-buffer", type=int, default=131072, dest="socket_send_buffer")
    p.add_argument("--cpu-threshold", type=int, default=-1, dest="cpu_threshold_ns")
    p.add_argument("--cpu-precision", type=int, default=200, dest="cpu_precision_ns")
    p.add_argument("--heartbeat-frequency", type=int, default=60, dest="heartbeat_interval_sec")
    p.add_argument("--log-level", choices=("error", "critical", "warning", "message",
                                           "info", "debug", "trace"), default="message",
                   dest="log_level")
    p.add_argument("--pcap-dir", default=None, dest="pcap_dir")
    p.add_argument("--data-directory", default="shadow.data", dest="data_directory")
    p.add_argument("--data-template", default=None, dest="data_template")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   dest="device",
                   help="where the packet-hop step runs: 'cuda' launches "
                        "the CUDA kernel and fails without a card; 'cpu' "
                        "runs its plain torch version")
    p.add_argument("--tpu-max-inflight", type=int, default=1 << 16, dest="tpu_max_inflight")
    p.add_argument("--tpu-devices", type=int, default=0, dest="tpu_devices")
    p.add_argument("--tpu-shard-matrix", action="store_true",
                   dest="tpu_shard_matrix",
                   help="row-shard the path matrices across the device mesh "
                        "(for graphs whose tensors exceed one chip's HBM)")
    p.add_argument("--tpu-device-threshold", type=int, default=0,
                   dest="tpu_device_threshold",
                   help="route round batches smaller than N to the "
                        "bit-identical numpy path instead of the device "
                        "(0 = always dispatch to the device)")
    p.add_argument("--dataplane", choices=("auto", "native", "python"),
                   default="auto", dest="dataplane",
                   help="C data plane for the per-event hot path (auto: "
                        "engage when the run is serial/global-policy "
                        "without pcap/CPU-model/debug; native: require it; "
                        "python: pure-Python plane)")
    p.add_argument("--host-table", choices=("auto", "on", "off"),
                   default="auto", dest="host_table",
                   help="boot hosts as struct-of-arrays table rows with "
                        "lazy Host materialization (scale tier; digest-"
                        "identical to eager boot).  auto: on exactly when "
                        "the config has processless device flows")
    p.add_argument("--device-plane", choices=("device", "numpy"),
                   default="device", dest="device_plane",
                   help="execution mode for device-registered bulk flows: "
                        "'device' runs them in HBM, 'numpy' runs the "
                        "bit-identical host twin (parity/debug)")
    p.add_argument("--device-plane-granule-ms", type=int, default=0,
                   dest="device_plane_granule_ms",
                   help="device-plane step size in ms (0 = auto-sized from "
                        "the topology's max latency; bandwidth stays exact, "
                        "per-hop latency rounds up to the step)")
    p.add_argument("--device-plane-sync", action="store_true",
                   dest="device_plane_sync",
                   help="block on each device-plane dispatch at launch "
                        "instead of overlapping it with the round's host "
                        "work (the serial oracle: digests are identical to "
                        "the pipelined default, only wall time differs)")
    p.add_argument("--exchange-mode", choices=("auto", "fused", "ppermute"),
                   default="auto", dest="exchange_mode",
                   help="mesh cross-shard exchange kernel: 'auto' decides "
                        "from the measured cost model (simprof calibrate; "
                        "heuristic when uncalibrated), 'fused'/'ppermute' "
                        "force one of the identical-result kernels "
                        "(scheduling only — digests never change)")
    p.add_argument("--device-autotune", choices=("on", "off"),
                   default="on", dest="device_autotune",
                   help="COSTMODEL-driven dispatch auto-tuner: pick the "
                        "effective superwindow depth and the delta-"
                        "compacted flush from this box's measured costs "
                        "(prof/autotune.py; engages only with a loaded, "
                        "covering model and only moves knobs still at "
                        "their hand defaults — digests never change); "
                        "'off' restores the hand defaults exactly")
    p.add_argument("--cost-model", default="", dest="cost_model",
                   help="path to the per-box measured cost model "
                        "(python -m shadow_tpu_torch.prof calibrate); "
                        "default: $SHADOW_TORCH_COSTMODEL or the repo-root "
                        "COSTMODEL_TORCH.json; a fingerprint mismatch "
                        "refuses loudly and heuristics run")
    p.add_argument("--device-plane-batch-steps", type=int, default=8,
                   dest="device_plane_batch_steps",
                   help="accumulate at least N plane steps per kernel "
                        "dispatch (amortizes the per-dispatch state copy "
                        "on backends where the carried state cannot alias)")
    p.add_argument("--superwindow-rounds", type=int, default=8,
                   dest="superwindow_rounds",
                   help="merge up to N consecutive lookahead rounds into "
                        "ONE device-plane kernel launch whenever no "
                        "host-side event falls inside them (digest-"
                        "identical to per-round dispatch; 1 = disable)")
    p.add_argument("--tpu-chunk", type=int, default=0, dest="tpu_chunk",
                   help="launch a device step as soon as N packet hops "
                        "accumulate mid-round, overlapping device compute "
                        "with the rest of the round (0 = launch at the "
                        "barrier only)")
    p.add_argument("--trace", default=None, dest="trace_path",
                   help="record sim+wall-time spans into the flight "
                        "recorder and write Chrome trace-event JSON here "
                        "at end of run (load in Perfetto / "
                        "chrome://tracing)")
    p.add_argument("--trace-ring", type=int, default=0, dest="trace_ring",
                   help="flight-recorder depth: events kept per track "
                        "(bounded ring; 0 = default 65536)")
    p.add_argument("--metrics", default=None, dest="metrics_path",
                   help="scrape the metrics registry to this JSONL file on "
                        "a round cadence, plus a final summary record")
    p.add_argument("--metrics-every", type=int, default=0,
                   dest="metrics_every_rounds",
                   help="rounds between metrics scrapes (0 = default 50)")
    p.add_argument("--test", action="store_true", dest="test_mode",
                   help="run the built-in example simulation")
    return p


def parse_args(argv: Optional[List[str]] = None) -> Options:
    ns = build_parser().parse_args(argv)
    opts = Options()
    for f in dataclasses.fields(Options):
        v = getattr(ns, f.name, None)
        if v is not None:
            setattr(opts, f.name, v)
    opts.stop_time_explicit = ns.stop_time_sec is not None
    return opts
