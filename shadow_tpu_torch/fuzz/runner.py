"""Execute a spec's mode matrix and report per-mode results.

The port's copy holds what the fleet plane needs (ROADMAP A8):
:func:`run_one_mode` (one spec under one mode, in process), the resume leg,
:func:`mode_batchable`, the fuzz-level fault harness (:func:`apply_fault`,
:func:`parse_fault`) and :func:`run_modes`.  The JAX package's bounded
subprocess runner, oracles, shrinker and ``simfuzz`` CLI are ROADMAP A12.

Changes from the JAX package's runner: :func:`run_one_mode` takes the
``device`` the run's device work goes to (``--device``, cuda unless the
caller asks for the CPU); mesh modes (``tpu_devices > 1``) run their D
shards on that one device (``parallel/mesh``), so none is skipped; and a
``processes >= 2`` mode raises NotImplementedError naming ROADMAP A9 inside
the run's guard, so it is reported as rc -1 and never run another way.

``apply_fault`` implements the fuzz-level fault harness: a deliberately
drifted oracle INPUT — perturbing the reported digest/events/supervision/rc
of one named mode — that the oracle set must catch.  ``engine:*`` faults
pass through to ``Options.fault_inject`` instead, driving REAL supervised
recoveries.
"""

from __future__ import annotations

import io
import os
import time as _walltime
import traceback
from typing import Dict, List, Optional

from .gen import build_config

# metrics keys copied into each mode result (oracle surfaces)
_SCRAPE_KEYS_PREFIX = ("mesh.",)
_SCRAPE_KEYS = ("plane.circuits", "plane.completed", "plane.forwards",
                "scale.materialized_hosts", "scale.table_rows")


def _mode_options(spec: Dict, mode: Dict, device: str = "cuda"):
    from ..core.options import Options
    opts = Options(
        device=device,
        scheduler_policy=mode.get("policy", "global"),
        workers=int(mode.get("workers", 0)),
        processes=int(mode.get("processes", 0)),
        stop_time_sec=int(spec["stoptime"]),
        seed=int(spec.get("engine_seed", 1)),
        host_table=mode.get("host_table", "on"),
        dataplane=mode.get("dataplane", "python"),
        tcp_congestion_control=mode.get("tcpcc", "reno"),
        device_plane=mode.get("device_plane", "device"),
        superwindow_rounds=int(mode.get("superwindow_rounds", 8)),
        device_plane_sync=bool(mode.get("device_plane_sync", False)),
        exchange_mode=mode.get("exchange_mode", "auto"),
        device_autotune=mode.get("device_autotune", "on"),
        tpu_devices=int(mode.get("tpu_devices", 1)),
        heartbeat_interval_sec=0,
        log_level="warning")
    fault = spec.get("fault_inject") or {}
    if fault.get("kind") == "engine":
        opts.fault_inject = fault["spec"]
    # per-MODE recovery drills: the mode itself carries an
    # engine fault (device-lost, demote-repromote, shard-exit-resurrect)
    # plus the healing knobs — the run must self-heal back to rc 0 and
    # the base digest, which the ordinary parity oracle then pins.
    if mode.get("engine_fault"):
        opts.fault_inject = mode["engine_fault"]
    if mode.get("max_resurrections") is not None:
        opts.max_resurrections = int(mode["max_resurrections"])
    if mode.get("repromote_after"):
        opts.repromote_after = int(mode["repromote_after"])
    return opts


def _run_resume_mode(spec: Dict, opts, out: Dict) -> None:
    """The checkpoint+``--resume`` leg: a writer pass
    snapshots every few rounds into a scratch dir, then a FRESH
    controller resumes from the newest good snapshot.  Resume is
    replay-based and digest-verified at the snapshot boundary, so the
    resumed run's digest/events face the ordinary parity oracles — no
    special-casing.  If the run is too short to land a snapshot the
    second pass simply replays plain (still a valid parity sample)."""
    import glob
    import tempfile

    from ..core.checkpoint import state_digest
    from ..core.controller import Controller

    with tempfile.TemporaryDirectory(prefix="simfuzz-ck-") as ckdir:
        opts.checkpoint_every_rounds = 4
        opts.checkpoint_dir = ckdir
        writer = Controller(opts, build_config(spec))
        rc = writer.run()
        if rc != 0:
            out["rc"] = rc
            return
        opts.checkpoint_every_rounds = 0
        if glob.glob(os.path.join(ckdir, "checkpoint_r*.ckpt")):
            opts.resume_path = ckdir
        ctrl = Controller(opts, build_config(spec))
        out["rc"] = ctrl.run()
        eng = ctrl.engine
        out["digest"] = state_digest(eng)
        out["events"] = eng.events_executed
        out["rounds"] = eng.rounds_executed
        out["supervision"] = eng.supervision.summary()


def run_one_mode(spec: Dict, mode: Dict, lane=None,
                 device: str = "cuda") -> Dict:
    """Run the spec under one mode.  Never raises: harness errors land in
    the result as rc=-1 + traceback (the rc/log oracle fails them).

    With ``lane`` (a :class:`shadow_tpu_torch.fleet.FleetLane`) the
    mode runs as a fleet batch lane: the engine's device dispatches ride
    the shared batched plane and the log capture moves to a THREAD-local
    logger so concurrent lanes keep separate tails.  Everything else —
    digest, events, supervision, scrape — is the identical code path,
    which is what makes batched verdicts digest-identical to the
    subprocess path."""
    from ..core.checkpoint import state_digest
    from ..core.controller import Controller
    from ..core.logger import SimLogger, set_logger, set_thread_logger

    out: Dict = {"mode": mode["name"],
                 "repeat_of": mode.get("repeat_of"),
                 "events_comparable": bool(
                     mode.get("events_comparable", True)),
                 "digest_group": mode.get("digest_group", "base"),
                 "engine_fault": mode.get("engine_fault"),
                 "skipped": None, "rc": None, "digest": None,
                 "events": None, "rounds": None, "supervision": None,
                 "scrape": {}, "log_tail": "", "wall_sec": None}
    buf = io.StringIO()
    if lane is not None:
        set_thread_logger(SimLogger(stream=buf, level="warning"))
    else:
        set_logger(SimLogger(stream=buf, level="warning"))
    t0 = _walltime.perf_counter()
    try:
        cfg = build_config(spec)
        opts = _mode_options(spec, mode, device)
        if lane is not None:
            opts._fleet_lane = lane
        if mode.get("resume"):
            _run_resume_mode(spec, opts, out)
        elif opts.processes >= 2:
            raise NotImplementedError(
                "--processes >= 2 (sharded multi-process runs) is not "
                "ported yet: ROADMAP A9")
        else:
            ctrl = Controller(opts, cfg)
            out["rc"] = ctrl.run()
            eng = ctrl.engine
            out["digest"] = state_digest(eng)
            out["events"] = eng.events_executed
            out["rounds"] = eng.rounds_executed
            out["supervision"] = eng.supervision.summary()
            scrape = eng.metrics.scrape()
            out["scrape"] = {
                k: v for k, v in sorted(scrape.items())
                if k in _SCRAPE_KEYS
                or k.startswith(_SCRAPE_KEYS_PREFIX)}
    except Exception:
        out["rc"] = -1
        buf.write("\n" + traceback.format_exc())
    finally:
        if lane is not None:
            set_thread_logger(None)
    out["wall_sec"] = round(_walltime.perf_counter() - t0, 3)
    out["log_tail"] = buf.getvalue()[-2000:]
    return out


def apply_fault(spec: Dict, result: Dict) -> Dict:
    """The fuzz-level fault harness: deterministically drift ONE named
    mode's reported oracle inputs so the pipeline (catch -> shrink ->
    repro) is drilled end to end.  ``engine:*`` faults are applied at
    options build instead; everything else matches on the mode name."""
    fault = spec.get("fault_inject") or {}
    kind = fault.get("kind")
    if not kind or kind == "engine":
        return result
    if fault.get("mode") not in (result["mode"], "*"):
        return result
    if result["skipped"]:
        return result
    if kind == "digest-drift" and result["digest"]:
        result["digest"] = "drift-" + result["digest"][:56]
    elif kind == "events-drift" and result["events"] is not None:
        result["events"] += 1
    elif kind == "supervision-drift" and result["supervision"] is not None:
        result["supervision"] = dict(result["supervision"])
        result["supervision"]["recoveries"] += 1
        result["supervision"]["dispatch_recoveries"] += 1
    elif kind == "rc-drift":
        result["rc"] = 7
    return result


def parse_fault(spec_str: str) -> Dict:
    """``digest-drift:MODE | events-drift:MODE | supervision-drift:MODE |
    rc-drift:MODE | engine:ENGINE-FAULT`` (MODE is a mode name or ``*``;
    ENGINE-FAULT is a core/supervision.py --fault-inject token)."""
    kind, _, rest = spec_str.partition(":")
    if kind == "engine":
        if not rest:
            raise ValueError("fault engine: needs an engine fault token")
        from ..core.supervision import parse_fault_inject
        parse_fault_inject(rest)      # validate eagerly
        return {"kind": "engine", "spec": rest}
    if kind in ("digest-drift", "events-drift", "supervision-drift",
                "rc-drift"):
        return {"kind": kind, "mode": rest or "*"}
    raise ValueError(f"unknown fuzz fault kind {kind!r}")


def run_modes(spec: Dict, modes: Optional[List[Dict]] = None) -> List[Dict]:
    """Run every mode of the spec in this process, fault drift applied."""
    results = []
    for mode in (modes if modes is not None else spec["modes"]):
        results.append(apply_fault(spec, run_one_mode(spec, mode)))
    return results


def mode_batchable(spec: Dict, mode: Dict) -> bool:
    """Modes the fleet plane can carry as a batch lane:
    single-process, single-threaded, single-device python-dataplane runs
    with no engine fault — the shapes whose device dispatches are plain
    span/flush steps the batched launch reproduces bit-exactly.
    Everything else (mesh, procs, threaded, native, engine-fault drills)
    runs serially.  ``resume`` modes ARE batchable: both controller
    passes ride the same lane back to back."""
    fault = spec.get("fault_inject") or {}
    if fault.get("kind") == "engine" or mode.get("engine_fault"):
        return False
    return (int(mode.get("workers", 0)) == 0
            and int(mode.get("processes", 0)) == 0
            and int(mode.get("tpu_devices", 1)) == 1
            and mode.get("device_plane", "device") == "device"
            and mode.get("dataplane", "python") == "python"
            and mode.get("policy", "global") == "global")
