"""``simprof`` — the device cost observatory CLI of the port
(``python -m shadow_tpu_torch.prof``).

Subcommands:

* ``calibrate [--out PATH] [--quick] [--wall-cap-sec N]
  [--devices 2,3,4,8] [--batched] [--device cuda|cpu]`` — time the
  port's kernels on the card (``cuda``, the default; no card is an error)
  or their plain versions on the CPU into a stamped
  ``COSTMODEL_TORCH.json`` (bounded subprocess; see calibrate.py).
  ``--batched`` additionally sweeps the batched fleet kernel at widths
  1/2/4/8, reported in the status row only.  The hidden ``--child``
  form is the in-subprocess half.
* ``check [PATH]`` — validate a model: schema, digest currency, and the
  REFUSAL drills (a fingerprint-mutated and a measurement-tampered copy
  must both refuse to load); ``loads_on_this_box`` says whether a run on
  the platform the model names would load it here.
* ``show [PATH]`` — human summary: fingerprint,
  measurement table shape, the exchange-cost matrix, and what the
  exchange scheduler would pick at a few example schedule shapes.

Every subcommand prints ONE JSON object (CI-parseable) and exits 0/1.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import tempfile
from typing import List, Optional

from . import COSTMODEL_BASENAME
from . import model as _model


def _default_path() -> str:
    return _model.default_model_path()


def cmd_calibrate(args) -> int:
    from .calibrate import calibrate_child, run_calibration

    if args.child:
        return calibrate_child(args.child, args.quick, args.wall_cap_sec,
                               _parse_devices(args.devices),
                               batched=args.batched, device=args.device)
    out = args.out or _default_path()
    row = run_calibration(out, quick=args.quick,
                          wall_cap_sec=args.wall_cap_sec,
                          devices=_parse_devices(args.devices),
                          batched=args.batched, device=args.device)
    print(json.dumps({"simprof_calibrate": row}), flush=True)
    return 0 if row.get("ok") else 1


def _parse_devices(spec: Optional[str]) -> Optional[List[int]]:
    if not spec:
        return None
    return [int(x) for x in spec.split(",") if x.strip()]


def _platform(data: dict, device: Optional[str] = None) -> str:
    """The platform to judge a model on: ``device`` when given, else the
    one the model names (``cuda`` when it names neither)."""
    if device:
        return device
    fp = data.get("fingerprint") if isinstance(data, dict) else None
    plat = fp.get("platform") if isinstance(fp, dict) else None
    return plat if plat in _model.PLATFORMS else "cuda"


def check_model(path: str, device: Optional[str] = None) -> dict:
    """The ``simprof check`` core, importable by tests and the smoke:
    schema + digest validation of the model at ``path``, whether a run on
    ``device`` (default: the model's own platform) would load it on this
    box, plus the two refusal drills run against mutated copies in a temp
    dir."""
    row: dict = {"path": path, "ok": False, "problems": []}
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        row["problems"].append(f"unreadable: {e}")
        return row
    if not isinstance(data, dict):
        row["problems"].append("not a JSON object")
        return row
    problems = _model.validate_schema(data)
    if not problems and _model.payload_digest(data) != data.get("digest"):
        problems.append("digest mismatch (payload edited after stamping)")
    row["problems"] = problems
    if problems:
        return row
    # informational: would THIS box load it?  (a foreign model correctly
    # refusing here is still a PASSING check — refusal is the contract)
    row["device"] = _platform(data, device)
    try:
        _model.load_model(path, device=row["device"])
        row["loads_on_this_box"] = True
    except _model.CostModelError as e:
        row["loads_on_this_box"] = False
        row["refusal"] = str(e)[:200]
    # refusal drills: a fingerprint-mutated copy and a tampered
    # measurement copy must BOTH refuse to load
    with tempfile.TemporaryDirectory(prefix="simprof-check-") as td:
        drifted = copy.deepcopy(data)
        drifted["fingerprint"] = dict(
            drifted["fingerprint"],
            node=str(drifted["fingerprint"].get("node")) + "-elsewhere")
        drifted["digest"] = _model.payload_digest(drifted)
        p1 = os.path.join(td, "drifted.json")
        _model.save_model(p1, drifted)
        try:
            # the drill pins the drifted model against THIS box's
            # fingerprint... unless this box's node already mismatches
            # (foreign model), in which case pin against the model's own
            # pre-drift fingerprint so the drill tests the right edge
            _model.load_model(p1, fingerprint=data["fingerprint"])
            row["problems"].append(
                "stale-fingerprint model LOADED (refusal path broken)")
        except _model.CostModelError:
            row["stale_fingerprint_refused"] = True
        tampered = copy.deepcopy(data)
        tampered["collectives"].setdefault("ppermute", {})["2x8"] = 1e-9
        p2 = os.path.join(td, "tampered.json")
        with open(p2, "w") as f:
            json.dump(tampered, f)       # digest left stale on purpose
        try:
            _model.load_model(p2, fingerprint=data["fingerprint"])
            row["problems"].append(
                "digest-tampered model LOADED (digest path broken)")
        except _model.CostModelError:
            row["tampered_digest_refused"] = True
    row["fingerprint"] = data["fingerprint"]
    row["git_sha"] = data.get("git_sha")
    row["truncated"] = data.get("truncated")
    row["collective_points"] = sum(
        len(t) for t in data["collectives"].values())
    row["step_points"] = len(data["step_kernel"].get("points", []))
    row["ok"] = not row["problems"]
    return row


def cmd_check(args) -> int:
    path = args.path or _default_path()
    row = check_model(path)
    print(json.dumps({"simprof_check": row}), flush=True)
    return 0 if row["ok"] else 1


def cmd_show(args) -> int:
    path = args.path or _default_path()
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        print(json.dumps({"simprof_show": {
            "path": path, "error": f"unreadable: {e}"}}), flush=True)
        return 1
    try:
        model = _model.load_model(path, device=_platform(data))
        loaded = True
        refusal = None
    except _model.CostModelError as e:
        loaded = False
        refusal = str(e)
        try:
            model = _model.CostModel(data, path=path)
        except (AttributeError, KeyError, TypeError, ValueError):
            print(json.dumps({"simprof_show": {
                "path": path, "error": refusal}}), flush=True)
            return 1
    # what the data-driven scheduler would pick at a few shapes
    choices = {}
    for d, legs, pair_w, leg_w in ((8, 4, 16, 16), (8, 1, 64, 64),
                                   (4, 3, 8, 8), (2, 1, 128, 128)):
        fused = model.exchange_tick_us(d, "fused", pair_w, [leg_w] * legs)
        pperm = model.exchange_tick_us(d, "ppermute", pair_w,
                                       [leg_w] * legs)
        choices[f"D={d},legs={legs}"] = {
            "fused_us": round(fused, 3), "ppermute_us": round(pperm, 3),
            "pick": "fused" if fused <= pperm else "ppermute"}
    row = {
        "path": path,
        "loads_on_this_box": loaded,
        **({"refusal": refusal} if refusal else {}),
        "fingerprint": model.fingerprint,
        "git_sha": model.git_sha,
        "band": model.band,
        "collectives": model.data["collectives"],
        "step_us_at_1k_flows": round(model.step_us(1000), 3),
        "transfer_us": round(model.transfer_us(), 2),
        "example_choices": choices,
    }
    print(json.dumps({"simprof_show": row}, indent=2), flush=True)
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m shadow_tpu_torch.prof",
        description="the port's device cost observatory: calibrate / "
                    "check / show the per-box measured cost model "
                    f"({COSTMODEL_BASENAME})")
    sub = p.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("calibrate",
                       help="time this box's kernels into a stamped "
                            "cost model (bounded subprocess)")
    c.add_argument("--out", default=None,
                   help=f"output path (default: the repo-root "
                        f"{COSTMODEL_BASENAME} / "
                        f"${_model.ENV_PATH})")
    c.add_argument("--quick", action="store_true",
                   help="endpoint probe grid only (the CI smoke)")
    c.add_argument("--wall-cap-sec", type=float, default=600.0,
                   dest="wall_cap_sec")
    c.add_argument("--devices", default=None,
                   help="comma-separated mesh sizes (default 2,3,4,8)")
    c.add_argument("--batched", action="store_true",
                   help="also sweep the batched fleet kernel at widths "
                        "1/2/4/8 — reported in the status row only, "
                        "never stamped into the model")
    c.add_argument("--device", choices=_model.PLATFORMS, default="cuda",
                   help="time the kernels on the card (default; no card "
                        "is an error) or their plain versions on the CPU")
    c.add_argument("--child", default=None, metavar="OUT",
                   help=argparse.SUPPRESS)   # in-subprocess half
    c.set_defaults(fn=cmd_calibrate)
    k = sub.add_parser("check",
                       help="validate a model: schema + digest + the "
                            "stale-fingerprint/tamper refusal drills")
    k.add_argument("path", nargs="?", default=None)
    k.set_defaults(fn=cmd_check)
    s = sub.add_parser("show", help="human summary of a model")
    s.add_argument("path", nargs="?", default=None)
    s.set_defaults(fn=cmd_show)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
