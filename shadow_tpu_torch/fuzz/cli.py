"""simfuzz CLI: seeded scenario fuzzing, repro replay, corpus regression.

Usage::

    simfuzz --seeds 25 [--seed-base 0] [--timeout-sec 240]
            [--wall-cap-sec 0] [--fault-inject KIND[:MODE]]
            [--repro-dir DIR] [--no-shrink] [--shrink-budget 40]
            [--in-process] [--out results.json]
    simfuzz --spec PATH           # fuzz one pinned spec/repro file
    simfuzz --repro PATH          # replay a repro file
    simfuzz --corpus [DIR]        # replay the checked-in regression set
    simfuzz --spec-only --seeds N # print the drawn specs, run nothing

Exit codes: 0 = every gate held (for ``--repro``: the file's expectation
was met), 1 = violations found (or expectation missed), 2 = usage/file
errors.  Prints ONE summary JSON line last, like bench.py.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time as _walltime
from typing import Dict, List, Optional

from . import SPEC_VERSION
from .gen import draw_spec, spec_digest
from .oracles import check
from .runner import (InProcessRunner, SubprocessRunner, child_main,
                     parse_fault)
from .shrink import shrink

CORPUS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "corpus")


def _say(msg: str) -> None:
    print(f"simfuzz: {msg}", file=sys.stderr, flush=True)


def write_repro(spec: Dict, violation: Dict, path: str) -> None:
    """A self-contained repro file: the minimal spec, the violation it
    reproduces, and the expectation ``--repro`` judges against."""
    blob = {"version": SPEC_VERSION, "tool": "simfuzz",
            "expect": "violation", "violation": violation, "spec": spec,
            "spec_digest": spec_digest(spec)}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(blob, f, indent=1, sort_keys=True)
        f.write("\n")


def replay_file(path: str, runner) -> int:
    """Replay one repro/corpus file; rc 0 iff its expectation holds."""
    try:
        with open(path, "r") as f:
            blob = json.load(f)
    except (OSError, ValueError) as e:
        _say(f"cannot read repro {path}: {e}")
        return 2
    spec = blob.get("spec")
    if not isinstance(spec, dict):
        _say(f"{path}: no spec")
        return 2
    expect = blob.get("expect", "clean")
    viols = check(spec, runner.run(spec))
    if expect == "violation":
        want = (blob.get("violation") or {}).get("oracle")
        hit = [v for v in viols if v["oracle"] == want]
        print(json.dumps({"repro": path, "expect": expect,
                          "oracle": want, "reproduced": bool(hit),
                          "violations": viols}))
        if hit:
            _say(f"{path}: reproduced {want}: {hit[0]['detail'][:200]}")
            return 0
        _say(f"{path}: expected {want} violation did NOT reproduce")
        return 1
    print(json.dumps({"repro": path, "expect": expect,
                      "violations": viols}))
    if viols:
        _say(f"{path}: {len(viols)} violation(s) on a spec expected "
             "clean (regression!)")
        return 1
    return 0


def corpus_files(directory: str) -> List[str]:
    if not os.path.isdir(directory):
        return []
    return sorted(os.path.join(directory, n)
                  for n in os.listdir(directory) if n.endswith(".json"))


def fuzz(args, runner) -> int:
    t0 = _walltime.monotonic()
    fault = parse_fault(args.fault_inject) if args.fault_inject else None
    seeds_run = 0
    all_violations: List[Dict] = []
    repros: List[str] = []
    wall_capped = False
    if args.spec:
        with open(args.spec, "r") as f:
            pinned = json.load(f)
        if "spec" in pinned and "family" not in pinned:
            pinned = pinned["spec"]       # accept repro files too
        targets = [(int(pinned.get("seed", 0)), pinned)]
    else:
        targets = [(args.seed_base + i, None) for i in range(args.seeds)]
    prefetched = None
    if hasattr(runner, "run_specs") and not args.spec_only:
        # --batched (ISSUE 18): draw the WHOLE seed list up front and
        # fleet-run every spec's mode matrix in one two-phase pass (the
        # batchable modes as concurrent vmapped lanes, the rest warm and
        # serial); the judge/shrink loop below then reads the prefetched
        # results instead of running per seed.  Verdicts are
        # digest-identical to the subprocess path — same specs, same
        # run_one_mode, same oracles.
        drawn = []
        for seed, pinned in targets:
            spec = pinned if pinned is not None else draw_spec(seed)
            if fault:
                spec["fault_inject"] = fault
            drawn.append(spec)
        _say(f"batched: {len(drawn)} specs over the fleet plane")
        prefetched = runner.run_specs(drawn)
        targets = [(seed, spec)
                   for (seed, _), spec in zip(targets, drawn)]
    for idx, (seed, pinned) in enumerate(targets):
        if args.wall_cap_sec and \
                _walltime.monotonic() - t0 > args.wall_cap_sec:
            wall_capped = True
            _say(f"wall cap {args.wall_cap_sec}s reached after "
                 f"{seeds_run} seeds; stopping early (honestly reported)")
            break
        spec = pinned if pinned is not None else draw_spec(seed)
        if fault and prefetched is None:
            spec["fault_inject"] = fault
        if args.spec_only:
            print(json.dumps(spec))
            seeds_run += 1
            continue
        results = prefetched[idx] if prefetched is not None \
            else runner.run(spec)
        viols = check(spec, results)
        seeds_run += 1
        modes_run = sum(1 for r in results if not r.get("skipped"))
        _say(f"seed {seed} [{spec['family']}]: {modes_run} modes, "
             f"{len(viols)} violation(s)")
        if not viols:
            continue
        all_violations.extend(
            dict(v, seed=seed, family=spec["family"]) for v in viols)
        target = viols[0]
        if args.no_shrink:
            small, final = spec, target
        else:
            _say(f"seed {seed}: shrinking {target['oracle']} violation "
                 f"({target['detail'][:120]})")
            # a wall-capped run bounds the shrink too (best-so-far repro
            # beats losing the violation to the caller's outer kill)
            deadline = (t0 + args.wall_cap_sec) if args.wall_cap_sec \
                else None
            small, final, runs = shrink(spec, target, runner,
                                        budget=args.shrink_budget,
                                        log=_say, deadline=deadline)
            _say(f"seed {seed}: shrunk in {runs} runs -> "
                 f"{len(small['modes'])} modes, params {small['params']}")
        path = os.path.join(args.repro_dir,
                            f"seed{seed}-{final['oracle']}.json")
        write_repro(small, final, path)
        repros.append(path)
        _say(f"seed {seed}: repro written to {path} "
             f"(replay: simfuzz --repro {path})")
        if args.stop_on_violation:
            break
    wall = _walltime.monotonic() - t0
    summary = {"simfuzz": {"seeds": seeds_run,
                           "requested_seeds": len(targets),
                           "wall_capped": wall_capped,
                           "violations": len(all_violations),
                           "repros": repros,
                           "fault_inject": args.fault_inject or None,
                           "wall_sec": round(wall, 1)},
               "pass": not all_violations}
    if prefetched is not None:
        # fleet attribution (ISSUE 18): N-up plane throughput plus the
        # plane's own launch-amortization/occupancy/compile counters
        summary["simfuzz"]["fleet"] = dict(
            runner.plane_stats(),
            lanes_requested=getattr(args, "lanes", 0),
            batched_modes=runner.batched_modes,
            serial_modes=runner.serial_modes,
            seeds_per_sec=round(seeds_run / wall, 3) if wall else 0.0)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(summary, violations=all_violations), f,
                      indent=1, sort_keys=True)
            f.write("\n")
    print(json.dumps(summary), flush=True)
    return 1 if all_violations else 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="simfuzz",
        description="seeded scenario fuzzing over the shadow-tpu engine "
                    "(digest stability/parity, event conservation, "
                    "supervision cleanliness, mesh invariants, rc/log "
                    "hygiene)")
    p.add_argument("--seeds", type=int, default=10,
                   help="number of seeded scenarios to run")
    p.add_argument("--seed-base", type=int, default=0, dest="seed_base")
    p.add_argument("--timeout-sec", type=float, default=240.0,
                   dest="timeout_sec",
                   help="wall bound per scenario child (killed + "
                        "reported on overrun, never a hang)")
    p.add_argument("--wall-cap-sec", type=float, default=0.0,
                   dest="wall_cap_sec",
                   help="stop drawing new seeds past this total wall "
                        "(0 = run all; the cap is reported, not hidden)")
    p.add_argument("--fault-inject", default="", dest="fault_inject",
                   help="drift one mode's reported oracle inputs "
                        "(digest-drift:MODE | events-drift:MODE | "
                        "supervision-drift:MODE | rc-drift:MODE) or "
                        "drive the engine harness (engine:TOKEN) — the "
                        "caught-shrunk-replayed drill")
    p.add_argument("--repro-dir", default="simfuzz-repros",
                   dest="repro_dir")
    p.add_argument("--no-shrink", action="store_true", dest="no_shrink")
    p.add_argument("--shrink-budget", type=int, default=40,
                   dest="shrink_budget")
    p.add_argument("--stop-on-violation", action="store_true",
                   dest="stop_on_violation")
    p.add_argument("--in-process", action="store_true", dest="in_process",
                   help="run scenarios in this process (tests/corpus; "
                        "production fuzzing uses bounded children)")
    p.add_argument("--batched", action="store_true",
                   help="run the whole seed list in-process over the "
                        "fleet plane: batchable modes as concurrent lanes "
                        "of batched launches, the rest serially in the "
                        "same process — digest-identical to the "
                        "subprocess path")
    p.add_argument("--lanes", type=int, default=8,
                   help="concurrent fleet lanes with --batched")
    p.add_argument("--spec-only", action="store_true", dest="spec_only",
                   help="print the drawn specs as JSON, run nothing")
    p.add_argument("--out", default=None,
                   help="write the full result record here as JSON")
    p.add_argument("--spec", default=None, metavar="PATH",
                   help="fuzz ONE pinned spec file (or a repro file's "
                        "spec) instead of drawing seeds — the "
                        "debug-a-scenario entry")
    p.add_argument("--repro", default=None, metavar="PATH",
                   help="replay one repro file and judge its expectation")
    p.add_argument("--corpus", nargs="?", const=CORPUS_DIR, default=None,
                   metavar="DIR",
                   help="replay every corpus file (default: the "
                        "checked-in fuzz/corpus/ regression set)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the runs' device work goes: 'cuda' launches "
                        "the kernels and fails without a card; 'cpu' runs "
                        "their plain torch versions")
    p.add_argument("--child", nargs=2, metavar=("IN", "OUT"),
                   default=None, help=argparse.SUPPRESS)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    # --device cuda without a card raises here, before any run (a child
    # that raises comes back to its parent as an rc_log violation)
    from ..device import resolve_device
    resolve_device(args.device)
    if args.child:
        return child_main(args.child[0], args.child[1], args.device)
    if args.batched:
        from .runner import BatchedRunner
        runner = BatchedRunner(lanes=args.lanes, device=args.device)
    elif args.in_process:
        runner = InProcessRunner(device=args.device)
    else:
        runner = SubprocessRunner(timeout_sec=args.timeout_sec,
                                  device=args.device)
    if args.repro:
        return replay_file(args.repro, runner)
    if args.corpus is not None:
        files = corpus_files(args.corpus)
        if not files:
            _say(f"no corpus files under {args.corpus}")
            return 2
        rcs = [replay_file(f, runner) for f in files]
        bad = sum(1 for rc in rcs if rc)
        print(json.dumps({"corpus": args.corpus, "files": len(files),
                          "failed": bad, "pass": not bad}), flush=True)
        return 1 if bad else 0
    return fuzz(args, runner)


if __name__ == "__main__":
    sys.exit(main())
