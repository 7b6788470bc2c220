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

The port's copy of the JAX package's ``simfleet``.  It has no device mesh
yet, so of the JAX smoke's compile-budget cross-check it keeps the
``fleet.compiles`` half: the measured count must be nonzero and within the
``[tool.simjit.budget]`` entry of the repository's ``pyproject.toml``
(read here with ``tomllib``).  The mesh's ``device_plane.sharded_variants``
half waits for the mesh (ROADMAP A10).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time as _walltime
from typing import List, Optional

_BUDGET_KEY = "fleet.compiles"


def _say(msg: str) -> None:
    print(f"simfleet: {msg}", file=sys.stderr, flush=True)


def load_fleet_budget() -> Optional[int]:
    """``[tool.simjit.budget]."fleet.compiles"`` from the repository's
    pyproject.toml (beside the package), or None where there is none."""
    import tomllib
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    path = os.path.join(root, "pyproject.toml")
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        cfg = tomllib.load(f)
    value = cfg.get("tool", {}).get("simjit", {}).get("budget", {}).get(
        _BUDGET_KEY)
    return None if value is None else int(value)


def budget_problems(measured: int, budget: Optional[int]) -> List[str]:
    """The fleet's compile-budget check: a smoke that launched must have
    counted at least one launch shape, and no more than the budget."""
    if budget is None:
        return []
    if measured == 0:
        return [f"measured `{_BUDGET_KEY}` = 0 against a budget of "
                f"{budget}: the fleet never launched a shape"]
    if measured > budget:
        return [f"measured `{_BUDGET_KEY}` = {measured} exceeds its "
                f"[tool.simjit.budget] = {budget}"]
    return []


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
    measured = {_BUDGET_KEY: int(stats.get(_BUDGET_KEY, 0))}
    budget = load_fleet_budget()
    if budget is None:
        _say("no [tool.simjit.budget] fleet.compiles entry found; "
             "compile-budget check skipped")
    problems = budget_problems(measured[_BUDGET_KEY], budget)
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
