"""One run of one cell of the port's benchmark.

    python3 -m portbench --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout (where ``BENCHMARK.json`` is).  The cell
names a configuration (``portbench/configs/<name>.json``), which names
its scenario (``portbench/scenarios/<name>.py``), a traffic mix
(``portbench/traffic/<name>.json``) and, through the metrics' entries,
the readers (``portbench/metrics/<name>.py``): all found by name, so a
cell, a configuration, a deployment of a new shape or a metric is added
by adding files and entries.

A run: set-up (import torch, the CUDA context, the scenario's kernels
from the checkout's compile cache, one episode cut to the scenario's
warm-up stoptime), then the window (episodes from a seeded queue until
``--seconds`` have passed, the ones in flight finishing), then the
readings (peak memory, the trace), the check that no module of JAX or of
the JAX package was loaded, the check of every episode against the
scenario's plain reference and the metrics' readers.  The look for JAX
is made again after the readers, just before the result is printed, so
nothing that the reference or a reader loads goes unseen.  The last line
of standard output is the result.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import resource
import sys
import time
from typing import Dict, List

from . import cell as cells
from . import check

FORBIDDEN = ("jax", "jaxlib", "flax", "shadow_tpu")
# a traced window is taken again only while another take of the same
# length still leaves the reference its time inside the run's 360 s
RUN_LIMIT_S = 280.0


def parse(argv: List[str]) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python3 -m portbench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (the benchmark); cpu runs the program's "
                        "plain versions for the CPU tests")
    p.add_argument("--control", type=int, choices=(0, 1), default=0,
                   help="1 runs the scenario's control: the program on a "
                        "path the check must refuse")
    return p.parse_args(argv)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (the port's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def loaded_forbidden(when: str) -> bool:
    """Whether a forbidden module is loaded; names it on standard error."""
    bad = forbidden_modules()
    if bad:
        print(f"portbench: {', '.join(bad)} loaded {when}", file=sys.stderr)
    return bool(bad)


class GcClock:
    """Seconds the interpreter spends in its garbage collector, read by the
    run to tell the host's own work from its stalls (standard error)."""

    def __init__(self):
        self.seconds = 0.0
        self.collections = 0
        self._t = 0.0

    def __call__(self, phase: str, _info) -> None:
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.seconds += time.perf_counter() - self._t
            self.collections += 1


def label_for(records: List[Dict], fleet: bool):
    """What the host was doing at a monotonic time: an episode's set-up
    or its engine loop (counted over lanes in a fleet cell)."""
    def label(t: float) -> str:
        setup = sum(r["t_start"] <= t < r["t_loop"] for r in records)
        loop = sum(r["t_loop"] <= t < r["t_end"] for r in records)
        if not fleet:
            return "episode_setup" if setup else (
                "engine_loop" if loop else "between_episodes")
        return f"lanes_setup_{setup}_loop_{loop}"
    return label


def main(argv: List[str], t0: float) -> int:
    args = parse(argv)
    bench = cells.load_benchmark()
    cell = cells.workload(bench, args.workload)
    config = cells.config_file(bench, cell["config"])
    traffic = cells.traffic_file(cell["traffic"])
    scenario = cells.scenario(config)
    import torch
    if args.device == "cuda":
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < int(cell["chips"]):
            print(f"portbench: {args.workload} needs {cell['chips']} CUDA "
                  f"card(s); found {torch.cuda.device_count()}",
                  file=sys.stderr)
            return 3
        torch.cuda.init()
    # a cost model from the environment would retune the program's
    # dispatch depth; the benchmark runs it as the checkout configures it
    os.environ.pop("SHADOW_TORCH_COSTMODEL", None)
    from .episodes import Experiments, ensure_kernels
    exp = Experiments(scenario, config, traffic, args.seed, args.device,
                      chips=int(cell["chips"]), control=bool(args.control))
    if args.device == "cuda":
        ensure_kernels(scenario.KERNELS[traffic["mode"]])
    exp.warm_up()
    if args.device == "cuda":
        torch.cuda.synchronize()
    setup_s = time.monotonic() - t0

    trace_on = bool(args.trace) and args.device == "cuda"
    from .trace import busy_intervals, card_trace, retake

    def take():
        if args.device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        with card_trace(trace_on) as prof:
            t_win = time.monotonic()
            records = exp.window(args.seconds)
        t_last = max(r["t_end"] for r in records)
        return records, t_win, t_last, (busy_intervals(prof) if trace_on
                                        else None)

    t_run = time.monotonic()
    gc_clock = GcClock()
    gc.callbacks.append(gc_clock)
    cpu0 = resource.getrusage(resource.RUSAGE_SELF)
    records, t_win, t_last, tr = retake(
        take, lambda: (time.monotonic() - t0) + (time.monotonic() - t_run)
        < RUN_LIMIT_S)
    device_peak = (torch.cuda.max_memory_allocated()
                   if args.device == "cuda" else 0)
    usage = resource.getrusage(resource.RUSAGE_SELF)
    gc.callbacks.remove(gc_clock)
    host_peak = usage.ru_maxrss * 1024
    cpu_s = (usage.ru_utime - cpu0.ru_utime) + (usage.ru_stime - cpu0.ru_stime)
    preempted = usage.ru_nivcsw - cpu0.ru_nivcsw
    if loaded_forbidden("by the end of the window"):
        return 4

    print("portbench: experiments (start, loop start, end) in s from the "
          "window's start: " + json.dumps(
              [[round(r[k] - t_win, 3) for k in ("t_start", "t_loop", "t_end")]
               for r in records]), file=sys.stderr)
    t_ref = time.monotonic()
    result = check.check_all(records, scenario, config, traffic,
                             torch.device(args.device))
    print(f"portbench: set-up {setup_s:.3f} s, window "
          f"{t_last - t_win:.3f} s ({cpu_s:.3f} s of the process's CPU "
          f"time, {gc_clock.seconds:.3f} s in {gc_clock.collections} "
          f"garbage collections, {preempted} times preempted), "
          f"{len(records)} experiments, reference "
          f"{time.monotonic() - t_ref:.3f} s", file=sys.stderr)
    ctx = {"cell": cell, "config": config, "traffic": traffic,
           "setup_s": setup_s, "window_s": t_last - t_win,
           "episodes": records, "host_peak_bytes": host_peak,
           "device_peak_bytes": device_peak, "trace": tr}
    kind = "per_layer" if args.trace else "end_to_end"
    metrics = {}
    for m in cells.metrics_for(bench, cell, kind):
        value = cells.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    if args.device == "cuda":
        props = torch.cuda.get_device_properties(0)
        device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                  "count": int(cell["chips"]),
                  "memory_peak_bytes": int(device_peak),
                  "memory_total_bytes": int(props.total_memory)}
    else:
        device = {"platform": "cpu", "kind": "cpu", "count": 1,
                  "memory_peak_bytes": 0}
    out = {"correct": result["correct"], "attempted": len(records),
           "failed": result["failed"], "metrics": metrics, "device": device}
    if tr is not None:
        from .trace import idle_gaps, top_ops
        device["busy_s"] = tr["busy_s"]
        device["window_s"] = tr["window_s"]
        out["breakdown"] = {
            "device_ops": top_ops(tr),
            "idle_gaps": idle_gaps(tr, label_for(records, exp.fleet))}
    out["checks"] = {k: {"value": v, "limit": check.LIMITS[k]}
                     for k, v in result["numbers"].items()}
    if loaded_forbidden("by the check or the metrics' readers"):
        return 4
    print(json.dumps(out), flush=True)
    print("portbench: answers off by kind: " + ", ".join(
        f"{k} {v}" for k, v in result["parts"].items()), file=sys.stderr)
    for k, v in result["numbers"].items():
        print(f"check {k} {v} limit {check.LIMITS[k]}", file=sys.stderr)
    sys.stderr.flush()
    return 0
