"""Round-boundary state snapshots, state digests, and replay-based resume.

The reference has no checkpointing (SURVEY.md §5: "Checkpoint/resume:
absent").  This module adds the capability the TPU rebuild can offer
cheaply, in three pieces:

* :func:`state_digest` — a deterministic hash over the complete observable
  simulation state (clock, per-host protocol/interface/tracker state,
  pending event queue shape, RNG draw counts).  Two runs are in the same
  state iff their digests match; this is the machine-checkable form of the
  event-order parity metric (BASELINE.json) and is what the cross-policy
  parity tests assert.

* :func:`save_snapshot` / :func:`load_snapshot` — pickle the digestible
  state to disk at round boundaries (``--checkpoint-interval N`` writes
  ``checkpoint_<simsec>.ckpt`` into ``--checkpoint-dir``).  Snapshots are
  for failure diagnosis and cross-run comparison; they deliberately exclude
  live app coroutines and native plugin processes (OS state that cannot be
  serialized — the same reason the reference never checkpointed).

* :func:`resume_digest` — recovery leans on the determinism kernel: re-run
  the same config+seed to the snapshot's time and verify the digest
  matches, then continue.  Deterministic replay makes restart-after-crash
  exact rather than approximate.
"""

from __future__ import annotations

import hashlib
import json
import os
import pickle
from typing import Dict, Optional

from . import stime


def _socket_state(sock) -> tuple:
    state = (sock.kind, getattr(sock, "state", None),
             sock.bound_ip, sock.bound_port,
             getattr(sock, "peer_ip", None), getattr(sock, "peer_port", None),
             sock.in_bytes, sock.out_bytes)
    if sock.kind == "tcp":
        state += (sock.snd_una, sock.snd_nxt, sock.rcv_nxt, sock.snd_wnd,
                  len(sock.unacked), len(sock.reorder),
                  sock.send_pending_bytes, sock.read_bytes,
                  sock.cong.cwnd if sock.cong is not None else 0)
    return state


def _host_state(host) -> Dict:
    descriptors = {}
    for handle, desc in sorted(host._descriptors.items()):
        if hasattr(desc, "digest_tuple"):  # native-plane sockets: the C
            descriptors[handle] = desc.digest_tuple()  # state IS the state
        elif hasattr(desc, "in_bytes"):  # sockets (tcp/udp/pipe ends)
            descriptors[handle] = _socket_state(desc)
        else:
            descriptors[handle] = (desc.kind, desc.status, desc.closed)
    t = host.tracker
    plane = getattr(host, "native_plane", None)
    if plane is not None:
        plane.sync_tracker(host.id, t)
    # the digest is an observation point: fold the device plane's pending
    # per-node byte deltas (lazily accumulated by its collects) so the
    # snapshot carries the true totals at this boundary
    t.pull_device()
    return {
        "name": host.name,
        "descriptors": descriptors,
        "tracker": (t.in_remote.bytes_total, t.out_remote.bytes_total,
                    t.in_remote.packets_total, t.out_remote.packets_total,
                    t.out_remote.packets_retrans, t.drops),
        "processes": [(p.name, p.running, p.exited, p.exit_code)
                      for p in host.processes],
        "ifaces": plane.iface_digest(host.id) if plane is not None else
                  {ip: (i.send_bucket.bytes_remaining,
                        i.receive_bucket.bytes_remaining)
                   for ip, i in sorted(host.interfaces.items())},
    }


def assemble_state(sim_time_ns: int, rounds: int, host_states: Dict,
                   pending_events) -> Dict:
    """Build the canonical digestible state dict.  Single construction point
    so a sharded run (parallel/procs.py) that gathers ``_host_state`` maps
    from its shard engines produces byte-identical pickles — and therefore
    identical digests — to a single-process run."""
    return {
        "sim_time_ns": sim_time_ns,
        "rounds": rounds,
        "hosts": {hid: host_states[hid] for hid in sorted(host_states)},
        "pending_events": pending_events,
    }


def collect_host_states(engine) -> Dict:
    """Per-host digest states for every host this engine owns: live Host
    objects plus still-quiet table rows (scale/hosttable.py synthesizes
    the identical dict from columns).  Shared by the serial collector
    below and the sharded one (parallel/procs.py)."""
    states = {hid: _host_state(h) for hid, h in engine.hosts.items()
              if engine.owns_host(h)}
    table = getattr(engine, "host_table", None)
    if table is not None:
        states.update(table.host_states())
    return states


def collect_state(engine) -> Dict:
    """The digestible snapshot of everything the simulation has computed."""
    return assemble_state(
        engine.scheduler.window_start,
        engine.rounds_executed,
        collect_host_states(engine),
        engine.scheduler.pending_count()
        if hasattr(engine.scheduler.policy, "pending_count") else None,
    )


def digest_of_state(state: Dict) -> str:
    """Digest over a canonical JSON rendering, NOT the pickle bytes: pickle
    memoizes repeated objects by identity, so two structurally equal states
    can pickle differently depending on which strings happen to be shared
    in-process (a sharded run's states cross a pipe and lose sharing).
    JSON with sorted keys is identity-blind; tuples/lists and int/str dict
    keys normalize uniformly.  No ``default=`` fallback on purpose: a
    non-canonical value (set, object) in a future state field would hash by
    repr — i.e. by address/hash order — and silently reintroduce the
    problem, so it raises instead."""
    blob = json.dumps(state, sort_keys=True,
                      separators=(",", ":")).encode()
    return hashlib.sha256(blob).hexdigest()


def state_digest(engine) -> str:
    """Deterministic hex digest of the current simulation state."""
    return digest_of_state(collect_state(engine))


def save_state(state: Dict, path: str, options_info: Dict) -> str:
    """Stamp ``state`` with its digest + run options and pickle it to disk
    (shared by the engine-side writer and the procs parent).

    The write is atomic (tmp + fsync + rename + DIRECTORY fsync): a run
    SIGKILLed mid-write can never leave a truncated file under the snapshot
    name, and the rename itself is made crash-durable — on ext4 and
    friends, tmp+fsync+rename alone persists the bytes but not necessarily
    the new NAME, so a power cut could forget the snapshot existed.  Every
    file a resume scan sees is therefore complete, named, and durable —
    the property crash recovery leans on."""
    state["digest"] = digest_of_state(state)
    state["options"] = options_info
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(state, f, protocol=4)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    dirfd = os.open(os.path.dirname(os.path.abspath(path)), os.O_RDONLY)
    try:
        os.fsync(dirfd)
    finally:
        os.close(dirfd)
    return state["digest"]


def save_snapshot(engine, path: str) -> str:
    return save_state(collect_state(engine), path, {
        "seed": engine.options.seed,
        "scheduler_policy": engine.options.scheduler_policy,
        "workers": engine.options.workers,
        "stop_time_sec": engine.options.stop_time_sec,
    })


def load_snapshot(path: str, verify: bool = False) -> Dict:
    """Load a snapshot; ``verify=True`` additionally recomputes the digest
    over the carried state and raises ``ValueError`` on mismatch — the
    defense against a corrupt/tampered file silently seeding a resume.

    Trailing garbage past the pickled payload is TOLERATED with a warning
    (the BENCH_HISTORY.jsonl torn-final-entry pattern): a crash during an
    append-style rewrite can leave a complete snapshot followed by a torn
    partial write, and 'resume from the last GOOD state' means reading the
    complete prefix, not refusing the file.  The digest verification below
    still judges what was actually loaded, so a torn PREFIX (truncated
    pickle) keeps failing loudly."""
    with open(path, "rb") as f:
        snap = pickle.load(f)
        trailing = len(f.read())
    if trailing:
        from .logger import get_logger
        get_logger().warning(
            "checkpoint",
            f"snapshot {path!r}: skipping {trailing} bytes of trailing "
            "garbage after the payload (torn final write tolerated)")
    if not isinstance(snap, dict):
        raise ValueError(f"snapshot {path!r} is corrupt: payload is "
                         f"{type(snap).__name__}, not a state dict")
    if verify:
        core = {k: v for k, v in snap.items()
                if k not in ("digest", "options")}
        if digest_of_state(core) != snap.get("digest"):
            raise ValueError(f"snapshot {path!r} is corrupt: stored digest "
                             "does not match its state")
    return snap


def find_last_good_snapshot(path: str):
    """Resolve ``--resume PATH``: a snapshot file loads (digest-verified);
    a directory yields the newest snapshot that verifies, skipping corrupt
    ones with a logged warning (a crash can outrun fsync on a shared fs;
    'resume from the last GOOD snapshot' is the contract).  Returns
    ``(snapshot, resolved_path)``."""
    from .logger import get_logger
    if os.path.isdir(path):
        # every candidate is loaded + digest-verified (no early exit on
        # name order: the interval- and round-triggered naming schemes
        # interleave, so only the carried sim_time orders them — and a
        # resume happens once per crash, so the full scan is cheap where
        # it matters)
        candidates = [p for p in os.listdir(path) if p.endswith(".ckpt")]
        best = None
        for name in candidates:
            full = os.path.join(path, name)
            try:
                snap = load_snapshot(full, verify=True)
            except (ValueError, OSError, pickle.UnpicklingError, EOFError) as e:
                get_logger().warning(
                    "checkpoint", f"skipping bad snapshot {full}: {e}")
                continue
            if best is None or snap["sim_time_ns"] > best[0]["sim_time_ns"]:
                best = (snap, full)
        if best is None:
            raise FileNotFoundError(
                f"--resume {path!r}: no loadable snapshot found")
        return best
    return load_snapshot(path, verify=True), path


def verify_resume_boundary(snap: Dict, window_start_ns: int, digest: str,
                           domain: str) -> None:
    """The --resume gate, shared by the serial engine and the sharded
    parent: the replay must land on the EXACT round boundary the snapshot
    was written at, in the EXACT state.  A time overshoot or digest
    mismatch means the config/seed diverged from the snapshotted run —
    continuing would silently simulate something else, so abort loudly."""
    if window_start_ns != snap["sim_time_ns"]:
        raise RuntimeError(
            f"--resume verification failed: the replay reached round "
            f"boundary t={window_start_ns / 1e9:.6f}s but the snapshot was "
            f"written at t={snap['sim_time_ns'] / 1e9:.6f}s — the "
            "config/seed does not match the snapshotted run")
    if digest != snap["digest"]:
        raise RuntimeError(
            f"--resume verification failed at "
            f"t={window_start_ns / 1e9:.3f}s: replayed state digest "
            f"{digest[:16]}… != snapshot digest {snap['digest'][:16]}… — "
            "the config/seed does not match the snapshotted run")
    from .logger import get_logger
    get_logger().message(
        domain,
        f"resume verified at t={window_start_ns / 1e9:.3f}s (digest "
        f"{digest[:16]}…): continuing past the snapshot boundary")


def warn_resume_unreached(snap: Dict, domain: str) -> None:
    """Logged at end of run when the snapshot boundary was never reached
    (snapshot time past the run's last round)."""
    from .logger import get_logger
    get_logger().warning(
        domain,
        "--resume snapshot boundary was never reached (snapshot "
        f"t={snap['sim_time_ns'] / 1e9:.3f}s is past this run's last "
        "round) — resume NOT verified")


def resume_digest(snapshot: Dict, engine) -> bool:
    """True iff a replayed engine has reached exactly the snapshot's state
    (call after running the same config+seed to snapshot['sim_time_ns'])."""
    return digest_of_state(collect_state(engine)) == snapshot["digest"]


class CheckpointWriter:
    """Round-boundary snapshot cadence: every ``interval_sec`` of virtual
    time and/or every ``every_rounds`` engine rounds (either may be 0 =
    off).  Engine-agnostic on purpose — the serial engine and the sharded
    parent (parallel/procs.py) share one instance shape, so their write
    boundaries (and therefore snapshot digests) line up exactly.

    ``rounds_done`` everywhere below is the number of COMPLETED rounds at
    the round-boundary hook, i.e. the engine's counter before it increments
    for the current round — the same value the state digest carries."""

    def __init__(self, interval_sec: int, out_dir: str,
                 every_rounds: int = 0):
        self.interval_ns = interval_sec * stime.SIM_TIME_SEC
        self.every_rounds = int(every_rounds)
        self.out_dir = out_dir
        self.next_at = self.interval_ns if interval_sec > 0 else None
        self.next_round = self.every_rounds if self.every_rounds > 0 else None
        self.written = []

    def due(self, window_start_ns: int, rounds_done: int) -> bool:
        """True iff this round boundary writes — checked by the engine
        BEFORE forcing an early flush consume, so a checkpointing run keeps
        the async launch/consume overlap on all the rounds that don't
        actually write."""
        if self.next_at is not None and window_start_ns >= self.next_at:
            return True
        return (self.next_round is not None
                and rounds_done + 1 >= self.next_round)

    def path_for(self, window_start_ns: int, rounds_done: int) -> str:
        """Zero-padded so lexicographic and chronological order agree.
        Round-triggered writes are stamped with the round number (several
        rounds can share one sim-second); interval writes keep the
        sim-second name."""
        if self.next_round is not None and rounds_done + 1 >= self.next_round:
            return os.path.join(self.out_dir,
                                f"checkpoint_r{rounds_done + 1:08d}.ckpt")
        sim_sec = window_start_ns // stime.SIM_TIME_SEC
        return os.path.join(self.out_dir, f"checkpoint_{sim_sec:08d}.ckpt")

    def mark_written(self, window_start_ns: int, rounds_done: int,
                     path: str) -> None:
        self.written.append(path)
        while self.next_at is not None and self.next_at <= window_start_ns:
            self.next_at += self.interval_ns
        while self.next_round is not None \
                and self.next_round <= rounds_done + 1:
            self.next_round += self.every_rounds

    def maybe_write(self, engine) -> Optional[str]:
        """Engine-side convenience: write if due, return the path."""
        now = engine.scheduler.window_start
        rounds = engine.rounds_executed
        if not self.due(now, rounds):
            return None
        os.makedirs(self.out_dir, exist_ok=True)
        path = self.path_for(now, rounds)
        save_snapshot(engine, path)
        self.mark_written(now, rounds, path)
        return path
