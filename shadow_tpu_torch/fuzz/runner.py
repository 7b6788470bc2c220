"""Execute a spec's mode matrix and report per-mode results.

Three execution surfaces over ONE code path (:func:`run_one_mode`):

* :func:`run_modes` / :class:`InProcessRunner` — in-process: build the
  spec's ``Configuration`` fresh per mode, run it, capture digest/events/
  supervision/metrics and the log tail.  Used by the tests, corpus replay
  and the subprocess child.
* :class:`SubprocessRunner` — production fuzzing: each spec runs in a
  BOUNDED child (``python -m shadow_tpu_torch.fuzz --child IN OUT --device
  D``: killed with its whole process group and reported on overrun, never
  a hang).
* :class:`BatchedRunner` — ``simfuzz --batched``: the batchable modes of
  a whole seed list as fleet lanes, the rest serially in the same process.

Changes from the JAX package's runner: every surface takes the ``device``
the run's device work goes to (``--device``, cuda unless the caller asks
for the CPU); mesh modes (``tpu_devices > 1``) run their D shards on that
one device (``parallel/mesh``), so none is skipped; a ``processes >= 2``
mode builds the retransmit tally in this process before its shards spawn
(utils/native_build.py); and the child's environment pins no backend and
no compile cache: the subprocess runner builds the CUDA kernels in the
parent before the first child instead (ops/_build.py), so no child spends
its bound in nvcc.

``apply_fault`` implements the fuzz-level fault harness: a deliberately
drifted oracle INPUT — perturbing the reported digest/events/supervision/rc
of one named mode — that the oracle set must catch, the shrinker minimize,
and ``--repro`` replay.  ``engine:*`` faults pass through to
``Options.fault_inject`` instead, driving REAL supervised recoveries.
"""

from __future__ import annotations

import io
import json
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
            from ..parallel.procs import ProcsController
            from ..utils.native_build import ensure_tally
            ensure_tally()      # built once here, before the shards spawn
            pc = ProcsController(opts, cfg)
            out["rc"] = pc.run()
            out["digest"] = pc.digest
            out["events"] = pc.events_executed
            out["supervision"] = pc.supervision.summary()
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


def run_modes(spec: Dict, modes: Optional[List[Dict]] = None,
              device: str = "cuda") -> List[Dict]:
    """Run every mode of the spec in this process, fault drift applied."""
    results = []
    for mode in (modes if modes is not None else spec["modes"]):
        results.append(apply_fault(spec, run_one_mode(spec, mode,
                                                      device=device)))
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


# ---------------------------------------------------------------------------
# bounded subprocess execution
# ---------------------------------------------------------------------------

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def child_env() -> Dict[str, str]:
    """The child's environment: this process's, unchanged.  Nothing is
    pinned: mesh modes run their D shards on the one device, so no virtual
    device mesh is needed, and the kernels are built before the child
    starts, so no compile cache is shared; ``CUDA_VISIBLE_DEVICES`` is
    left as the caller set it."""
    return os.environ.copy()


def child_main(in_path: str, out_path: str, device: str = "cuda") -> int:
    """``python -m shadow_tpu_torch.fuzz --child IN OUT --device D``: run
    the spec file's modes on ``device``, write the result list as JSON.
    rc 0 even on violations — the PARENT judges; a nonzero rc means the
    harness itself broke."""
    with open(in_path, "r") as f:
        spec = json.load(f)
    results = run_modes(spec, device=device)
    tmp = out_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"spec_seed": spec.get("seed"), "results": results}, f)
    os.replace(tmp, out_path)
    return 0


def _child_result(rc, log_tail: str, wall_sec, timeout: bool = False
                  ) -> List[Dict]:
    """The one-row result of a child that returned no results."""
    row = {"mode": "<child>", "repeat_of": None, "events_comparable": False,
           "skipped": None, "rc": rc, "digest": None, "events": None,
           "rounds": None, "supervision": None, "scrape": {},
           "log_tail": log_tail, "wall_sec": wall_sec}
    if timeout:
        row["timeout"] = True
    return [row]


def _end_group(proc) -> None:
    """Kill the child's whole process group (it leads its own session, so
    the group holds the ``--processes`` shards it spawned too) and reap
    it.  A descendant that left the group could keep the pipes open, so
    the drain is bounded as well."""
    import signal
    import subprocess

    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    try:
        proc.communicate(timeout=30)
    except subprocess.TimeoutExpired:
        for pipe in (proc.stdout, proc.stderr):
            pipe.close()
        proc.wait()


class SubprocessRunner:
    """Run each spec's whole mode matrix in ONE bounded child process; a
    wedged scenario is killed at ``timeout_sec`` with its process group
    and reported as a timeout result, never a hang.  On cuda the kernels
    are built here, before the first child, so a child's bound is spent
    on its runs."""

    def __init__(self, timeout_sec: float = 240.0, device: str = "cuda"):
        self.timeout_sec = float(timeout_sec)
        self.device = device
        self._built = False

    def _build_kernels(self) -> None:
        if self._built or self.device != "cuda":
            return
        from ..ops import _build
        missing = [n for n in _build.KERNELS
                   if not os.path.exists(_build.library_path(n))]
        if missing:
            _build.build(missing)
        self._built = True

    def run(self, spec: Dict) -> List[Dict]:
        import subprocess
        import sys
        import tempfile

        self._build_kernels()
        with tempfile.TemporaryDirectory(prefix="simfuzz-") as td:
            in_path = os.path.join(td, "spec.json")
            out_path = os.path.join(td, "results.json")
            with open(in_path, "w") as f:
                json.dump(spec, f)
            cmd = [sys.executable, "-m", "shadow_tpu_torch.fuzz", "--child",
                   in_path, out_path, "--device", self.device]
            proc = subprocess.Popen(cmd, env=child_env(), cwd=_REPO,
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True,
                                    start_new_session=True)
            try:
                out, err = proc.communicate(timeout=self.timeout_sec)
            except subprocess.TimeoutExpired:
                _end_group(proc)
                return _child_result(
                    None, f"child (pid {proc.pid}) exceeded the "
                          f"{self.timeout_sec:.0f}s bound and was killed "
                          "with its process group",
                    self.timeout_sec, timeout=True)
            if proc.returncode != 0 or not os.path.exists(out_path):
                return _child_result(proc.returncode, (out + err)[-2000:],
                                     None)
            with open(out_path, "r") as f:
                return json.load(f)["results"]


class InProcessRunner:
    """Same contract as SubprocessRunner, no child (tests/corpus)."""

    def __init__(self, device: str = "cuda"):
        self.device = device

    def run(self, spec: Dict) -> List[Dict]:
        return run_modes(spec, device=self.device)


class BatchedRunner:
    """``simfuzz --batched``: the whole seed list's mode matrices in ONE
    process over the fleet plane.

    Two phases.  Phase 1 fans every spec's *batchable* modes (see
    :func:`mode_batchable`) out as fleet lanes — N concurrent engines
    whose device dispatches merge into batched launches on ``device``.
    Phase 2 runs the remaining modes (mesh/procs/threaded/native/fault
    drills) sequentially in this process, each with the process-wide
    logger (a lane's thread-local logger ends with its lane).  Per-spec
    result lists come back in mode order with fault drift applied — the
    shape SubprocessRunner returns, so the oracle set and the shrinker are
    reused unchanged."""

    def __init__(self, lanes: int = 8, use_numpy: bool = False,
                 device: str = "cuda"):
        from ..fleet.driver import FleetDriver
        from ..fleet.plane import FleetPlane
        self.device = device
        self.driver = FleetDriver(lanes=lanes, plane=FleetPlane(
            use_numpy=use_numpy, device=device))
        self.batched_modes = 0
        self.serial_modes = 0

    def plane_stats(self) -> Dict:
        return self.driver.plane.metrics()

    def run_specs(self, specs: List[Dict]) -> List[List[Dict]]:
        jobs = []
        slots = []
        table: List[List[Optional[Dict]]] = [
            [None] * len(spec["modes"]) for spec in specs]
        for si, spec in enumerate(specs):
            for mi, mode in enumerate(spec["modes"]):
                if mode_batchable(spec, mode):
                    jobs.append(lambda lane, s=spec, m=mode:
                                run_one_mode(s, m, lane=lane,
                                             device=self.device))
                    slots.append((si, mi))
        for (si, mi), result in zip(slots, self.driver.run(jobs)):
            table[si][mi] = result
        self.batched_modes += len(jobs)
        for si, spec in enumerate(specs):
            for mi, mode in enumerate(spec["modes"]):
                if table[si][mi] is None:
                    table[si][mi] = run_one_mode(spec, mode,
                                                 device=self.device)
                    self.serial_modes += 1
        return [[apply_fault(spec, r) for r in rows]
                for spec, rows in zip(specs, table)]

    def run(self, spec: Dict) -> List[Dict]:
        """Single-spec entry (shrink candidates, --repro, --corpus):
        the same two-phase path at fleet width 1."""
        return self.run_specs([spec])[0]
