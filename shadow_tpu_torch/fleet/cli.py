"""simfleet CLI: drive the batched many-scenarios-per-card fleet plane.

Usage::

    python -m shadow_tpu_torch.fleet smoke [--lanes 8] [--seeds 8]
        [--seed-base 0] [--device {cuda,cpu}] [--numpy] [--out PATH]

``smoke`` is the fleet's gate: draw a bounded mixed scenario set from the
fuzz generator, run each scenario's base mode twice — serially (the
reference) and as fleet lanes over ONE shared batched plane — and require
bit-identical digests plus a real batched launch count.  Runs on
``--device`` (cuda unless the caller asks for the CPU, where the batched
kernels' plain version runs).  Prints ONE summary JSON line last; exit 0 =
digest-gated pass, 1 = mismatch or no launches, 2 = usage errors.

The port's copy of the JAX package's ``simfleet``, with its compile-budget
cross-check: the measured ``fleet.compiles`` (launch shapes) and the
process's ``device_plane.sharded_variants`` high-water mark (the mesh's
quiet-tick variant cache) against the runtime entries of the repository's
``pyproject.toml`` ``[tool.simjit.budget]`` (read here with ``tomllib``).
Growth past a budget fails, and so does a budgeted key the run no longer
reports; ``--numpy`` launches no kernel and checks neither.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time as _walltime
from typing import Dict, List, Optional, Tuple


def _say(msg: str) -> None:
    print(f"simfleet: {msg}", file=sys.stderr, flush=True)


def load_runtime_budget() -> Dict[str, int]:
    """The runtime entries (dotted keys that name no ``.py`` file) of
    ``[tool.simjit.budget]`` in the repository's pyproject.toml (beside
    the package); empty where there is none."""
    import tomllib
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    path = os.path.join(root, "pyproject.toml")
    if not os.path.exists(path):
        return {}
    with open(path, "rb") as f:
        cfg = tomllib.load(f)
    budget = cfg.get("tool", {}).get("simjit", {}).get("budget", {})
    return {k: int(v) for k, v in budget.items() if not k.endswith(".py")}


def crosscheck_budget(measured: Dict[str, int], budget: Dict[str, int],
                      require_nonzero: Tuple[str, ...] = ()) -> List[str]:
    """Measured runtime counts against the budget, failing on either
    direction of drift: a count above its budget, a budgeted key that was
    not measured, or a measured key with no budget.  A measured 0 is fine
    for a cache the run need not use (the mesh's variants) but fails for
    the keys in ``require_nonzero``.  Returns the problems; empty means
    consistent."""
    problems: List[str] = []
    for key, declared in sorted(budget.items()):
        got = measured.get(key)
        if got is None:
            problems.append(
                f"budgeted runtime cache `{key}` (= {declared}) was not "
                "measured: stale budget entry or dropped metric")
        elif got > declared:
            problems.append(
                f"measured `{key}` = {got} exceeds its "
                f"[tool.simjit.budget] = {declared}")
        elif got == 0 and key in require_nonzero:
            problems.append(
                f"measured `{key}` = 0 against a budget of {declared}: "
                "the run never exercised it")
    for key in sorted(measured):
        if key not in budget:
            problems.append(
                f"runtime cache `{key}` = {measured[key]} has no "
                "[tool.simjit.budget] entry")
    return problems


def cmd_smoke(args) -> int:
    from ..fuzz.gen import draw_spec
    from ..fuzz.runner import mode_batchable, run_one_mode
    from .driver import FleetDriver
    from .plane import FleetPlane

    t0 = _walltime.monotonic()
    picks = []
    for i in range(args.seeds):
        seed = args.seed_base + i
        spec = draw_spec(seed)
        mode = next((m for m in spec["modes"]
                     if mode_batchable(spec, m) and not m.get("resume")),
                    None)
        if mode is None:
            _say(f"seed {seed} [{spec['family']}]: no batchable mode, "
                 "skipped")
            continue
        picks.append((seed, spec, mode))
    if not picks:
        _say("no batchable scenarios drawn; widen --seeds")
        return 2
    _say(f"{len(picks)} scenarios "
         f"({', '.join(sorted({s['family'] for _, s, _ in picks}))}): "
         "serial reference pass")
    serial = [run_one_mode(spec, mode, device=args.device)
              for _, spec, mode in picks]
    t1 = _walltime.monotonic()
    _say(f"fleet pass: {args.lanes} lanes on {args.device}"
         + (" (numpy twin)" if args.numpy else ""))
    driver = FleetDriver(lanes=args.lanes, plane=FleetPlane(
        use_numpy=args.numpy, device=args.device))
    jobs = [lambda lane, s=spec, m=mode: run_one_mode(s, m, lane=lane,
                                                      device=args.device)
            for _, spec, mode in picks]
    fleet = driver.run(jobs)
    t2 = _walltime.monotonic()
    rows = []
    matched = True
    for (seed, spec, mode), ref, got in zip(picks, serial, fleet):
        ok = (ref["digest"] == got["digest"] and ref["rc"] == got["rc"]
              and ref["events"] == got["events"])
        matched = matched and ok
        rows.append({"seed": seed, "family": spec["family"],
                     "mode": mode["name"], "rc": got["rc"],
                     "digest_match": ok})
        if not ok:
            _say(f"seed {seed} [{spec['family']}] DIGEST MISMATCH: "
                 f"serial rc={ref['rc']} digest={ref['digest']} vs "
                 f"fleet rc={got['rc']} digest={got['digest']}")
    stats = driver.plane.metrics()
    launched = stats["fleet.launches"] > 0
    if not launched:
        _say("no batched launches fired — the fleet plane was never "
             "exercised (gate fails closed)")
    from ..parallel.device_plane import DeviceTrafficPlane
    measured = {
        "fleet.compiles": int(stats.get("fleet.compiles", 0)),
        "device_plane.sharded_variants":
            int(DeviceTrafficPlane.sharded_variants_high_water),
    }
    budget = load_runtime_budget()
    problems: List[str] = []
    if args.numpy:
        pass    # the numpy twin launches nothing: no budget to hold
    elif not budget:
        _say("no [tool.simjit.budget] runtime entries found; "
             "compile-budget check skipped")
    else:
        problems = crosscheck_budget(measured, budget,
                                     require_nonzero=("fleet.compiles",))
        for p in problems:
            _say(f"compile-budget drift: {p}")
    ok = matched and launched and not problems
    summary = {"simfleet": {
        "lanes": args.lanes,
        "scenarios": len(picks),
        "families": sorted({s["family"] for _, s, _ in picks}),
        "digest_match": matched,
        "serial_wall_sec": round(t1 - t0, 2),
        "fleet_wall_sec": round(t2 - t1, 2),
        "numpy": bool(args.numpy),
        "rows": rows,
        "budget_measured": measured,
        "budget_problems": problems,
        **stats},
        "pass": ok}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1, sort_keys=True)
            f.write("\n")
    print(json.dumps(summary), flush=True)
    return 0 if ok else 1


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="simfleet",
        description="many simulations per card: N scenarios advanced by "
                    "one batched device launch")
    sub = p.add_subparsers(dest="cmd", required=True)
    sm = sub.add_parser(
        "smoke", help="bounded mixed fleet, digest-gated against serial")
    sm.add_argument("--lanes", type=int, default=8,
                    help="concurrent fleet lanes")
    sm.add_argument("--seeds", type=int, default=8,
                    help="scenarios to draw (fuzz generator seeds)")
    sm.add_argument("--seed-base", type=int, default=0, dest="seed_base")
    sm.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the device plane runs: 'cuda' launches the "
                         "batched kernels and fails without a card; 'cpu' "
                         "runs their plain torch version")
    sm.add_argument("--numpy", action="store_true",
                    help="drive the batched numpy twin instead of the "
                         "batched kernels (kernel-parity debugging)")
    sm.add_argument("--out", default=None,
                    help="also write the summary JSON here")
    sm.set_defaults(fn=cmd_smoke)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
