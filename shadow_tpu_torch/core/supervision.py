"""Supervision & fault-recovery accounting (ISSUE 2).

The simulator runs *real* OS processes (plugin binaries, shard engines) and
asynchronous device dispatches, so it inherits every way a real process can
wedge: a plugin that stops responding, an in-flight kernel dispatch that
fails or never completes, a shard process that dies mid-protocol.  Each of
those seams now carries a watchdog; this module is the shared ledger they
report into, plus the parser for the deterministic fault-injection harness
the recovery tests drive.

Recovery accounting is deliberately separate from ``engine.plugin_errors``:
a *supervised* kill (watchdog fired, simulation continued by design) is a
counted recovery, not a failure — the run's exit code reflects unsupervised
faults only, and bench.py exports ``recoveries``/``watchdog_overhead_sec``
so the steady-state cost of the supervision layer stays pinned at ~0.
"""

from __future__ import annotations

from typing import Dict, Optional

from .logger import get_logger


class SupervisionStats:
    """Per-run ledger of watchdog fires, degradations, and their cost.

    ``overhead_ns`` accumulates ONLY the bookkeeping the supervision layer
    adds on the healthy path (guard-thread spawn, liveness polls) — never
    the time legitimately spent waiting on results — so it is an honest
    measure of what supervision costs when nothing goes wrong.
    """

    __slots__ = ("plugin_watchdog_kills", "dispatch_recoveries",
                 "shard_deaths_detected", "native_round_demotions",
                 "shard_resurrections", "reshards", "repromotions",
                 "mttr_ns", "overhead_ns", "resume_path", "resume_verified")

    def __init__(self) -> None:
        self.plugin_watchdog_kills = 0
        self.dispatch_recoveries = 0
        self.shard_deaths_detected = 0
        self.native_round_demotions = 0
        self.shard_resurrections = 0
        self.reshards = 0
        self.repromotions = 0
        self.mttr_ns = 0
        self.overhead_ns = 0
        self.resume_path: Optional[str] = None
        self.resume_verified = False

    @property
    def recoveries(self) -> int:
        return (self.plugin_watchdog_kills + self.dispatch_recoveries
                + self.shard_deaths_detected + self.native_round_demotions
                + self.shard_resurrections + self.reshards
                + self.repromotions)

    @staticmethod
    def _dump_flight_recorder(reason: str) -> None:
        """Every recovery arrives with its timeline attached: the flight
        recorder's recent spans are logged alongside the watchdog report
        (ISSUE 3).  A no-op note when the run wasn't traced."""
        from ..obs.trace import get_tracer
        get_tracer().dump_recent("supervision", reason)

    def count_plugin_kill(self, name: str, reason: str) -> None:
        self.plugin_watchdog_kills += 1
        get_logger().warning(
            "supervision",
            f"plugin {name} killed by watchdog ({reason}); its simulated "
            "process is marked exited — the host and round loop continue")
        self._dump_flight_recorder(f"plugin watchdog: {name}")

    def count_dispatch_recovery(self, reason: str) -> None:
        self.dispatch_recoveries += 1
        get_logger().warning("supervision", reason)
        self._dump_flight_recorder("device dispatch recovery")

    def count_native_round_demotion(self, reason: str) -> None:
        """The C round executor failed mid-window; the per-event pop path
        finished the window (both paths execute the identical total order,
        so resuming per-event after K executed events is exact) and takes
        over permanently — same graceful-degradation contract as the
        device dispatch guard (ISSUE 10)."""
        self.native_round_demotions += 1
        get_logger().warning(
            "supervision",
            f"native round executor failed ({reason}); window completed on "
            "the per-event path — executor permanently demoted")
        self._dump_flight_recorder("native round executor demotion")

    def count_shard_resurrection(self, sid: int, attempt: int,
                                 mttr_ns: int) -> None:
        """A dead shard was respawned, deterministically replayed to the
        round barrier, digest-verified at the join boundary, and the run
        CONTINUED (ISSUE 17) — a bounded, measured detour rather than an
        abort.  ``mttr_ns`` is detection → rejoin wall time."""
        self.shard_resurrections += 1
        self.mttr_ns += mttr_ns
        get_logger().warning(
            "supervision",
            f"shard {sid} resurrected (attempt {attempt}) and rejoined the "
            f"round barrier after {mttr_ns / 1e9:.2f}s — run continues")
        self._dump_flight_recorder(f"shard resurrection: {sid}")

    def count_reshard(self, n_before: int, n_after: int,
                      mttr_ns: int = 0) -> None:
        """The sharded mesh lost a device mid-run and re-partitioned onto
        the survivors at a quiesced boundary, with the state translation
        digest-pinned before == after (ROADMAP 4(b))."""
        self.reshards += 1
        self.mttr_ns += mttr_ns
        get_logger().warning(
            "supervision",
            f"mesh re-sharded {n_before} -> {n_after} devices at a "
            "quiesced boundary; re-layout digest verified — run continues")
        self._dump_flight_recorder(f"mesh re-shard: {n_before}->{n_after}")

    def count_repromotion(self, rung: str, after_rounds: int) -> None:
        """A demoted rung climbed back after its probation: ``after_rounds``
        clean rounds passed, the faster path was re-attempted with the
        replay guard armed, and it held.  One shot only — a second fault on
        the same rung re-demotes permanently (ISSUE 17)."""
        self.repromotions += 1
        get_logger().warning(
            "supervision",
            f"{rung} re-promoted after {after_rounds} clean probation "
            "rounds — replay guard stays armed; next fault is permanent")
        self._dump_flight_recorder(f"re-promotion: {rung}")

    def summary(self) -> Dict:
        return {
            "recoveries": self.recoveries,
            "plugin_watchdog_kills": self.plugin_watchdog_kills,
            "dispatch_recoveries": self.dispatch_recoveries,
            "shard_deaths_detected": self.shard_deaths_detected,
            "native_round_demotions": self.native_round_demotions,
            "shard_resurrections": self.shard_resurrections,
            "reshards": self.reshards,
            "repromotions": self.repromotions,
            "mttr_sec": round(self.mttr_ns / 1e9, 4),
            "watchdog_overhead_sec": round(self.overhead_ns / 1e9, 4),
        }


def parse_fault_inject(spec: str) -> Optional[Dict]:
    """Parse a ``--fault-inject`` token (the deterministic fault harness the
    recovery tests drive; a no-op in production runs).  Formats:

    * ``device-dispatch:N``      — poison the Nth device-plane dispatch so
      its collect raises (exercises the numpy-replay degradation path);
    * ``device-dispatch-hang:N`` — the Nth dispatch's collect hangs instead
      (exercises the dispatch watchdog timeout);
    * ``plugin-stall:NAME:NREQ`` — SIGSTOP the native plugin whose process
      name contains NAME after serving its NREQth request (a plugin frozen
      mid-syscall-stream; exercises the plugin watchdog);
    * ``shard-exit:SID:ROUND``   — shard SID hard-exits (``os._exit``, no
      error report — simulating SIGKILL/OOM) at the start of round ROUND
      (exercises dead-shard detection);
    * ``native-round:N``         — the Nth C round-executor window raises,
      exercising permanent demotion to the per-event dispatch path with
      digest parity (ISSUE 10);
    * ``continuation-batch:N``   — the Nth batched-continuation delivery
      (py_exec_batch) raises mid-window, exercising demotion to the
      per-event pop loop where continuations deliver one callback each
      (ISSUE 12);
    * ``shard-exit-resurrect:SID:ROUND`` — shard SID hard-exits at round
      ROUND exactly like ``shard-exit``, but the parent is expected to
      RESURRECT it (respawn + deterministic replay to the barrier) rather
      than abort — the self-healing drill (ISSUE 17);
    * ``device-lost:ROUND``      — the sharded mesh "loses" a device at
      round ROUND: the plane re-partitions onto D-1 survivors at the next
      quiesced boundary with the re-layout digest pinned (ISSUE 17);
    * ``demote-repromote:N``     — the Nth device dispatch is poisoned like
      ``device-dispatch:N`` but the demotion is expected to heal: after
      ``--repromote-after`` clean rounds the plane re-attempts the device
      rung once (ISSUE 17).
    """
    if not spec:
        return None
    parts = spec.split(":")
    kind = parts[0]
    if kind in ("device-dispatch", "device-dispatch-hang"):
        if len(parts) != 2:
            raise ValueError(f"--fault-inject {spec!r}: expected {kind}:N")
        return {"kind": kind, "dispatch": int(parts[1])}
    if kind == "plugin-stall":
        if len(parts) != 3:
            raise ValueError(
                f"--fault-inject {spec!r}: expected plugin-stall:NAME:NREQ")
        return {"kind": kind, "name": parts[1], "nreq": int(parts[2])}
    if kind in ("shard-exit", "shard-exit-resurrect"):
        if len(parts) != 3:
            raise ValueError(
                f"--fault-inject {spec!r}: expected {kind}:SID:ROUND")
        return {"kind": kind, "shard": int(parts[1]), "round": int(parts[2])}
    if kind == "device-lost":
        if len(parts) != 2:
            raise ValueError(f"--fault-inject {spec!r}: expected "
                             "device-lost:ROUND")
        return {"kind": kind, "round": int(parts[1])}
    if kind == "demote-repromote":
        if len(parts) != 2:
            raise ValueError(f"--fault-inject {spec!r}: expected "
                             "demote-repromote:N")
        return {"kind": kind, "dispatch": int(parts[1])}
    if kind == "native-round":
        if len(parts) != 2:
            raise ValueError(f"--fault-inject {spec!r}: expected "
                             "native-round:N")
        return {"kind": kind, "window": int(parts[1])}
    if kind == "continuation-batch":
        if len(parts) != 2:
            raise ValueError(f"--fault-inject {spec!r}: expected "
                             "continuation-batch:N")
        return {"kind": kind, "batch": int(parts[1])}
    raise ValueError(f"--fault-inject {spec!r}: unknown fault kind {kind!r}")
