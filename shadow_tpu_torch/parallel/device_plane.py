"""Device-resident traffic plane: bulk flows advance in HBM, Python keeps
only the control plane.

This is the execution-plane promotion of ops/torcells_device.py: instead
of every DATA cell crossing the Python TCP stack as discrete events, a Tor
client in device mode builds its circuit through the REAL engine (TCP
connects, CREATE/EXTEND cells through real relays — the control plane
stays fully simulated), then registers the bulk transfer as a device
flow.  From that point the cells live in device tensors:

* one [F] flow table (circuit stage -> paced node, onward latency ticks,
  successor), sorted by paced node so the per-tick bandwidth allocation is
  the torcells segment-cumsum (exact greedy in circuit order, no sorting on
  device);
* per-node token buckets (1 ms refill, byte capacities from the SAME
  bucket parameters the engine's NetworkInterfaces use — ops/bandwidth.py);
* a [ring_len, F] arrival ring indexed by tick (the device analog of the
  delivery event queue).

The device plane is a two-stage pipeline over the engine's round loop
(stage -> launch -> collect):

* **stage** — client activations buffer injections host-side
  (``activate``) during a round;
* **launch** — at the TOP of the next dispatching round (right after the
  engine computes the window), ONE windowed dispatch advances the plane
  to the round barrier (ops/torcells_device.torcells_step_window_flush;
  state donated, so it never leaves HBM).  The dispatch is asynchronous:
  it computes while the host drains the round's arrivals (plugin
  execution + the native C plane);
* **collect** — at the next loop iteration, before the next window is
  computed, the engine materializes the dispatch's ONE packed flush
  buffer (forwards + delivered cursor + newly-completed chains +
  per-node byte deltas, delta-compacted on device) and wakes completed
  flows.

Completed flows wake their client process through an ordinary scheduled
event, so determinism is exact: completion ticks are device-computed, wake
times are their tick times clamped to the launching round's barrier, and
digests are identical across scheduler policies, across the device/numpy
execution modes (--device-plane=numpy runs the bit-identical host twin;
tests/test_device_plane.py pins both), and across pipelined vs serial
(--device-plane-sync) execution — the engine commits round N's plane
state before round N+1's staged injections are folded in, so overlap
never reorders anything (tests/test_device_pipeline.py).

What is and is NOT modeled (honesty contract, same spirit as
ops/bandwidth.py's docstring): the plane models BOTH directions of each
stream as independent cell chains (download server->exit->middle->guard->
client and upload client->guard->middle->exit->server), store-and-forward
at relay granularity with per-direction bucket contention (each host
contributes an egress node on its up bucket for sending hops and an
ingress node on its down bucket for the delivering hop — the same
send/receive TokenBucket split the engine's interfaces use), and fixed
512B+header wire cells.  It does not model per-cell TCP control (windows,
retransmits) for the bulk phase — circuit setup DOES exercise the full
TCP stack.  Reference analog: the traffic pattern shadow-plugin-tor
measures (worker.c:243-304 + network_interface.c:421-579 per-cell work,
executed here as dense tensor ticks).

The port's copy.  In device mode the plane lives on ``--device`` (default
cuda): its state and static tables are torch tensors there, uploaded once,
and every dispatch is one launch of the span kernel and one of the flush
kernel (ops/torcells_device.torcells_step_window_flush) on the plane's own
CUDA stream, with the carried state updated in place (the JAX package
donated it instead).  The flush comes back through a pinned host buffer
and an event (:class:`_FlushHandle`).  ``--device cpu`` runs the plain
torch versions.  As a fleet lane (fleet/plane.py) the plane's dispatches
ride the fleet's batched launch instead, synchronously.  With
``--tpu-devices D`` (D >= 2) the flow table is sharded over a mesh of D
shards on that one device (parallel/mesh/): each dispatch is one launch of
the mesh span kernel and one of the mesh flush kernel, the state in the
padded layout.  There is no hidden fallback: the numpy-twin recovery
ladder runs only for the injected ``--fault-inject
device-dispatch[-hang]:N`` / ``demote-repromote:N`` drills, and the
``device-lost:ROUND`` drill re-shards onto D-1 shards; a real dispatch
failure (a kernel that does not build, a launch or CUDA error, a watchdog
timeout) ends the run.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import stime
from ..core.event import Event
from ..core.task import Task
from ..core.logger import get_logger

TICK_NS = 1_000_000          # 1 ms, = the interface refill interval


class _PoisonedFlush:
    """Fault-harness stand-in for an in-flight flush handle: materializing
    it raises (``device-dispatch:N``) or stalls (``device-dispatch-hang:N``,
    bounded so the abandoned guard thread cannot linger forever) — the
    deterministic stand-ins for a dispatch that failed or wedged."""

    def __init__(self, handle, hang: bool = False):
        self._handle = handle
        self._hang = hang

    def __array__(self, dtype=None, copy=None):
        if self._hang:
            import time as _wt
            # simlint: disable=SIM005 -- fault harness: a deliberate stall
            _wt.sleep(30.0)
        raise RuntimeError("fault injection: poisoned device dispatch")


class _FlushHandle:
    """One in-flight dispatch's packed flush on the card: a pinned host
    buffer filled by a non-blocking copy on the plane's stream, and the
    event recorded after it.  Materializing it (``np.asarray``, as the
    collect does) waits on the event; only then do the pinned buffers this
    dispatch holds (the flush, and its injection upload) go back to the
    pool, so none is overwritten while the card may still use it."""

    __slots__ = ("_buf", "_event", "_held", "_pool", "_result")

    def __init__(self, buf, event, held, pool):
        self._buf = buf
        self._event = event
        self._held = held
        self._pool = pool
        self._result = None

    def synchronize(self) -> None:
        """Block until the dispatch and its copy back have finished."""
        self._event.synchronize()

    def wait(self) -> np.ndarray:
        if self._result is None:
            self._event.synchronize()
            self._result = self._buf.numpy().copy()
            for b in self._held:
                self._pool.release(b)
            self._held = ()
        return self._result

    def __array__(self, dtype=None, copy=None):
        out = self.wait()
        return out if dtype is None else out.astype(dtype)


class _PinnedPool:
    """Free lists of pinned int64 host buffers by length."""

    def __init__(self):
        self._free: Dict[tuple, List[torch.Tensor]] = {}

    def acquire(self, shape: tuple) -> torch.Tensor:
        free = self._free.get(shape)
        if free:
            return free.pop()
        return torch.empty(shape, dtype=torch.int64, pin_memory=True)

    def release(self, buf: torch.Tensor) -> None:
        self._free.setdefault(tuple(buf.shape), []).append(buf)


class _SuperPlan:
    """One negotiated superwindow: the K=1 round recurrence replayed
    host-side (negotiate_superwindow), executed as ONE kernel launch.

    ``bounds`` is every merged virtual round's (window_start, window_end);
    ``targets`` the absolute step boundary each dispatching round's window
    maps to (ascending); ``round_of`` the bounds index that launched each
    target.  consume() maps the kernel's reached boundary (flush t_stop)
    back through ``round_of`` to learn which virtual round the plane — and
    therefore the engine's round counter and window bookkeeping — actually
    advanced to."""

    __slots__ = ("base", "targets", "bounds", "round_of")

    def __init__(self, base, targets, bounds, round_of):
        self.base = base
        self.targets = targets
        self.bounds = bounds
        self.round_of = round_of


class _FlowSpec:
    """One device-mode client = TWO independent cell chains, e.g. a tor
    download (server -> exit -> middle -> guard -> client) and upload
    (client -> guard -> middle -> exit -> server), or a star-bulk pair
    (server -> client / client -> server).  Chains may have different hop
    counts per spec — the flow table is built from the actual routes.  The
    client's flow is complete when BOTH chains have delivered.

    ``route_down`` may be None for an auto: consensus client; the plane
    resolves it at startup by replaying the client's derived path draw over
    the config-predicted consensus (resolve_auto_routes)."""

    __slots__ = ("client_name", "route_down", "route_up", "cells_down",
                 "cells_up", "circuit", "dirspec", "dest", "auto_start_ns")

    def __init__(self, client_name: str, route_down: Optional[List[str]],
                 route_up: Optional[List[str]], cells_down: int,
                 cells_up: int, dirspec: Optional[str] = None,
                 dest: Optional[str] = None):
        self.client_name = client_name
        self.route_down = route_down
        self.route_up = route_up
        self.cells_down = cells_down
        self.cells_up = cells_up
        self.circuit = -1
        self.dirspec = dirspec
        self.dest = dest
        # processless flow (scale tier): the plane self-activates it at
        # this sim time and completion needs no wake event — no plugin
        # ever joins, so the quiet client host stays a table row
        self.auto_start_ns: Optional[int] = None


def _cells_for(nstreams: int, specs: List[str]):
    from ..apps.tor import PAYLOAD_MAX
    cells_down = cells_up = 0
    for i in range(nstreams):
        up, down = (int(x) for x in specs[i % len(specs)].split(":"))
        cells_down += max(1, math.ceil(down / PAYLOAD_MAX))
        cells_up += max(1, math.ceil(up / PAYLOAD_MAX))
    return cells_down, cells_up


def parse_device_client(host_name: str, args: List[str]) -> Optional[_FlowSpec]:
    """Recognize a tor client process configured for device-plane data
    ('device' flag in its args).  args layout (apps/tor.py client role):
    client <socksport> <path> <dest> <destport> <nstreams> <spec...> device
    <path> is a static 3-hop list or 'auto:<dirhost>[:<dirport>]' (the
    consensus route is predicted at startup — resolve_auto_routes)."""
    if not args or args[0] != "client" or "device" not in args:
        return None
    # strip the mode token BEFORE positional parsing (client_main does the
    # same), so "client 9050 <path> dest 80 device" with nstreams omitted
    # falls back to the defaults instead of int("device") crashing
    args = [a for a in args if a != "device"]
    path_s = args[2]
    dest = args[3]
    nstreams = int(args[5]) if len(args) > 5 else 1
    specs = args[6:] or ["100:10000"]
    cells_down, cells_up = _cells_for(nstreams, specs)
    if path_s.startswith("auto:"):
        return _FlowSpec(host_name, None, None, cells_down, cells_up,
                         dirspec=path_s[len("auto:"):], dest=dest)
    path = [h.partition(":")[0] for h in path_s.split(",")]
    if len(path) != 3:
        raise ValueError(f"{host_name}: device-plane needs a 3-hop path")
    guard, middle, exit_ = path[0], path[1], path[2]
    return _FlowSpec(host_name,
                     [dest, exit_, middle, guard, host_name],
                     [host_name, guard, middle, exit_, dest],
                     cells_down, cells_up, dest=dest)


def parse_device_tgen(host_name: str, args: List[str]) -> Optional[_FlowSpec]:
    """Recognize a tgen client configured for device-plane data (workload
    #2, star bulk): client <server> <port> <spec...> device.  The flow is a
    2-hop pair: server->client download and client->server upload, paced by
    the two hosts' own up/down buckets."""
    if not args or args[0] != "client" or "device" not in args:
        return None
    args = [a for a in args if a != "device"]
    server = args[1]
    specs = args[3:] if len(args) > 3 else ["1024:65536"]
    cells_down, cells_up = _cells_for(len(specs), specs)
    return _FlowSpec(host_name, [server, host_name], [host_name, server],
                     cells_down, cells_up, dest=server)


def resolve_auto_routes(engine, specs: List[_FlowSpec]) -> None:
    """Fill in auto: specs' routes at startup by replaying each client's
    path draw: the consensus is config-determined (every relay publishes
    its name/orport/bw from its own args, and the authority serves them
    sorted by name), and device-mode clients draw from the DERIVED
    per-host stream host.random.spawn('device-circuit') — independent of
    execution order, so the replay here is exact.  The runtime cross-check
    (DeviceTrafficPlane.check_route via api.device_flow_start) fails
    loudly if the fetched consensus ever diverges from this prediction."""
    autos = [s for s in specs if s.route_down is None]
    if not autos:
        return
    from ..apps.tor import pick_weighted
    from ..core.rng import RandomSource, derive
    relays = {}
    for _hid, host_name, app, a in engine.iter_process_specs():
        if not app.endswith("tor"):
            continue
        # relay <orport> <dirauth_host:port> <bw>: publishes into the
        # consensus (apps/tor.py relay role)
        if a and a[0] == "relay" and len(a) > 2 and a[2]:
            orport = int(a[1]) if len(a) > 1 else 9001
            bw = int(a[3]) if len(a) > 3 else 100
            relays[host_name] = (orport, bw)
    consensus = [(n, p, w) for n, (p, w) in sorted(relays.items())]
    if not consensus:
        raise ValueError(
            "device plane: auto: clients configured but no publishing "
            "relays found (no dirauth-registered relay processes)")
    for s in autos:
        # the client's derived path stream, computed arithmetically so a
        # table-resident client needs no Host object to predict its route
        key = engine.host_stream_key(s.client_name)
        if key is None:
            raise ValueError(f"device plane: unknown host "
                             f"{s.client_name!r}")
        rng = RandomSource(derive(key, "device-circuit"))
        path = [name for name, _port in pick_weighted(rng, consensus)]
        if len(path) != 3:
            raise ValueError(
                f"{s.client_name}: consensus has only {len(path)} usable "
                "relays; device-plane circuits need 3 hops")
        guard, middle, exit_ = path[0], path[1], path[2]
        s.route_down = [s.dest, exit_, middle, guard, s.client_name]
        s.route_up = [s.client_name, guard, middle, exit_, s.dest]


class DeviceTrafficPlane:
    """Owns the device-resident state for all registered bulk flows and the
    engine-side activation/wake bookkeeping."""

    # process-wide high-water mark of the quiet-tick sharded-variant
    # cache, reported by `simfleet smoke` against the checked-in
    # [tool.simjit.budget] "device_plane.sharded_variants" entry (the cap
    # in _pick_sharded_step is the same value)
    sharded_variants_high_water = 0

    def __init__(self, engine, specs: List[_FlowSpec], mode: str = "device"):
        if engine.shard_count > 1:
            raise RuntimeError(
                "--device-plane is global state; it does not compose with "
                "--processes sharding (run the device plane single-process)")
        assert mode in ("device", "numpy")
        self.engine = engine
        self.mode = mode
        # device mode runs on --device (cuda unless the caller asks for
        # the CPU, where the kernels' plain versions run); numpy mode and
        # the recovery drill's replay never touch it
        self.device = None
        self._stream = None
        if mode == "device":
            from ..device import resolve_device
            self.device = resolve_device(
                getattr(engine.options, "device", "cuda"))
            if self.device.type == "cuda":
                self._stream = torch.cuda.Stream(self.device)
                self._pinned = _PinnedPool()
        # dispatch cadence: accumulate at least this many steps before
        # launching a kernel dispatch (injections wait with them).  One
        # dispatch per engine round would pay a full state round trip per
        # round on backends without buffer donation (jax CPU copies the
        # donated state every call — measured ~7 ms at 50k flows); batching
        # K rounds' ticks into one dispatch amortizes it K-fold.  Wake
        # times are observed at the consuming barrier either way, and both
        # execution modes follow the identical cadence, so digests stay
        # parity-comparable.
        self.min_dispatch_steps = max(
            1, int(getattr(engine.options, "device_plane_batch_steps", 8)))
        # superwindow depth: how many consecutive lookahead rounds one
        # kernel launch may cover when no host-side event falls inside
        # them (engine._advance_window negotiates per round).
        # Also the static pad length of the kernel's targets vector.
        self.superwindow_rounds = max(
            1, int(getattr(engine.options, "superwindow_rounds", 8)))
        self._pending_plan: Optional[_SuperPlan] = None
        self._active_plan: Optional[_SuperPlan] = None
        self.superwindows = 0
        self._rounds_launched = 0    # virtual rounds covered by launches
        self._mesh = None
        self._shard = None           # layout dict when sharded
        self._sharded_step = None
        self._mesh_make_step = None
        self.specs = specs
        for i, s in enumerate(specs):
            s.circuit = i
        # activate/check_route/join are keyed by host name, so the
        # one-flow-per-host rule holds for PLUGIN-driven specs only; auto
        # (processless) flows self-stage and wake by circuit index, never
        # through this dict — a swarm peer may carry many chains
        plugin_specs = [s for s in specs if s.auto_start_ns is None]
        self._by_client = {s.client_name: s for s in plugin_specs}
        if len(self._by_client) != len(plugin_specs):
            # two device-mode clients on one host would silently share a
            # circuit (the second spec wins) and one client's
            # activate/join would target the wrong flow, blocking until
            # end_time with no error
            seen: set = set()
            dup = next(s.client_name for s in plugin_specs
                       if s.client_name in seen or seen.add(s.client_name))
            raise ValueError(
                f"device plane: host {dup!r} has multiple device-mode tor "
                "clients; run at most one per host (flows are keyed by "
                "host name)")
        # the measured per-box cost model (prof/model.py): consulted by
        # advance() for per-launch predicted cost and by the tuner below
        if mode == "device":
            from ..prof.model import load_for_engine
            self._costmodel, self._costmodel_status = load_for_engine(
                engine.options)
        else:
            self._costmodel, self._costmodel_status = None, "off"
        self._meshinfo = None        # set by attach_mesh when sharded
        self._build_layout(engine)
        # COSTMODEL auto-tuner (prof/autotune.py): with a
        # loaded model covering this flow table, pick the effective
        # superwindow depth and the delta-compacted flush from measured
        # costs.  Digest-NEUTRAL by construction: K only merges rounds
        # the halt rule maps back exactly, and the capped flush is a
        # transport encoding (overflow re-reads full-length).  Cadence
        # and granule are digest-BEARING and stay at contract values.
        from ..prof.autotune import plan_dispatch
        self._tune_plan = plan_dispatch(
            self._costmodel, self._costmodel_status, engine.options,
            self.n_flows, self.n_chains, self.n_nodes)
        self._flush_caps = None      # (cap_chains, cap_nodes) when engaged
        self._inflight_caps = None   # caps the IN-FLIGHT dispatch packed with
        self._inflight_args = None   # its inputs (overflow re-run, nodonate)
        self.flush_bytes_saved = 0
        self.flush_overflows = 0
        if self._tune_plan.source == "model":
            self.superwindow_rounds = self._tune_plan.superwindow_rounds
            if self.superwindow_rounds > getattr(engine, "_superwindow", 1):
                engine._superwindow = self.superwindow_rounds
            if self._tune_plan.flush_compact and mode == "device":
                if self.device.type == "cpu":
                    # overflow recovery re-runs the SAME inputs through
                    # the full-length kernel, which needs them alive
                    # after the launch — the CPU path's plain versions
                    # are pure.  On the card (in-place state) the flush
                    # stays full; the capped launch would run on a clone
                    # of the state (advance) if it ever engaged there.
                    self._flush_caps = (self._tune_plan.flush_cap_chains,
                                        self._tune_plan.flush_cap_nodes)
        engine.metrics.source("autotune", self._autotune_metrics)
        # quiet-tick exchange-leg fusion: set by attach_mesh — per-chain
        # leg bitmasks; dispatch picks a variant step with the quiet legs
        # left out (superset masks are bit-identical)
        self._chain_leg_bits = None
        self._full_leg_bits = 0
        self._active_leg_bits = 0
        self._sharded_variants: Dict[int, object] = {}
        # the mesh: shard the flow table over D shards (the same
        # --tpu-devices axis the scheduler policy shards its hop on), all
        # on the plane's one device.  Exact — see parallel/mesh/ (partition
        # + BvN exchange); state/API stay in the ORIGINAL flow space,
        # translated at the dispatch boundary.  --tpu-devices 0 (all
        # devices in the JAX package) means one device, no mesh, here.
        if mode == "device":
            n_dev = int(getattr(engine.options, "tpu_devices", 1) or 0) or 1
            if n_dev > 1:
                # the mesh path's launch cut is the exchange-leg mask;
                # flush compaction stays single-table
                self._flush_caps = None
                self._setup_sharding(n_dev)
        self._state = None           # lazy: built at first activation
        # processless flows (scale tier): (start_ns, circuit) ascending;
        # the plane self-activates each at its start time — next_time()
        # keeps the engine's windows coming until the last one is staged
        self._auto = sorted(
            (s.auto_start_ns, i) for i, s in enumerate(specs)
            if s.auto_start_ns is not None)
        self._auto_pos = 0
        self._inflight = False
        self._flush_handle = None    # in-flight packed flush (1-deep slot)
        self._span_tables = None     # SpanTables of the flow table (lazy)
        self._ticks_synced = 0
        self._inject_buf: List[Tuple[int, int]] = []   # (circuit, cells)
        self._waiters: Dict[int, Tuple[object, object]] = {}
        self._done: Dict[int, int] = {}   # circuit -> wake sim time ns
        self._woken: set = set()
        self._chain_done: Optional[np.ndarray] = None  # [C] step or -1
        self._flow_args_cached = None
        self._zero_inject_cached = None   # device-resident, reused when the
                                          # staged inject buffer is empty
        self.total_forwards = 0
        self.total_injected_cells = 0
        self.dispatches = 0
        self.steps = 0               # ticks advanced, over all dispatches
        self.device_ns = 0
        self.host_ns = 0
        # pipeline introspection: actual host<->device interactions (kernel
        # dispatch + inject upload + flush read) and the wall the in-flight
        # dispatch had to compute behind host round work
        self.device_calls = 0
        self.pipeline_overlap_ns = 0
        self._launch_wall = 0
        self._launch_pred = None     # (per_step_us, fixed_us) model
        self._launch_base = 0        # kernel t at launch (steps = t_stop-)
        # --device-plane-sync: block on the dispatch at launch time (the
        # serial oracle the pipelined run is digest-compared against)
        self._sync = bool(getattr(engine.options, "device_plane_sync",
                                  False))
        # idle fast path: when the plane provably has no cells anywhere
        # (every dispatched cell delivered, nothing buffered), rounds only
        # bank refill ticks instead of spinning the kernel; the next real
        # dispatch folds them in exactly (capped refill is idempotent)
        self._cells_dispatched = 0
        self._cells_delivered_seen = 0
        self._idle_ticks_banked = 0
        self.idle_rounds_skipped = 0
        # Dispatch supervision: every dispatch window is logged as
        # (base_ticks, inject pairs, n, idle) — a few ints per window — so
        # that a FAILED in-flight dispatch (exception at materialization, or
        # collect timeout via --device-watchdog-sec) can be recovered by
        # replaying the whole window history on the bit-identical numpy
        # twin.  Full-history replay rather than one-window replay because
        # the carried device state is donated on accelerators: after the
        # failed dispatch there is no pre-state buffer left to restart from.
        # On recovery the backend is PERMANENTLY demoted to the numpy twin
        # (graceful degradation: digest parity preserved, device speed
        # forfeited), counted in engine.supervision.
        self._dispatch_log: List[tuple] = []
        # observability hooks (shadow_tpu/obs/): dispatch/collect latency
        # histograms, bytes per flush, pipeline-overlap efficiency — all
        # no-ops (one attribute check) when tracing/metrics are off
        from ..obs.profiler import DeviceProfiler
        self._profiler = DeviceProfiler()
        self._watchdog_sec = float(
            getattr(engine.options, "device_watchdog_sec", 0) or 0)
        self.demoted = False
        self.recoveries = 0
        from ..core.supervision import parse_fault_inject
        fault = parse_fault_inject(
            getattr(engine.options, "fault_inject", "") or "")
        self._fault_dispatch = 0
        self._fault_hang = False
        if fault and fault["kind"] in ("device-dispatch",
                                       "device-dispatch-hang"):
            self._fault_dispatch = fault["dispatch"]
            self._fault_hang = fault["kind"] == "device-dispatch-hang"
        # self-healing: an injected device loss re-shards the mesh onto
        # D-1 shards at the next quiesced round boundary; a
        # demote-repromote poison fails like device-dispatch:N but the
        # demotion serves a probation (--repromote-after clean collects)
        # and then climbs back to the device rung once, replay guard armed
        self._fault_device_lost = 0
        if fault and fault["kind"] == "device-lost":
            self._fault_device_lost = fault["round"]
        if fault and fault["kind"] == "demote-repromote":
            self._fault_dispatch = fault["dispatch"]
        self._repromote_after = int(
            getattr(engine.options, "repromote_after", 0) or 0)
        self._probation_clean = 0
        self._repromoted = False
        self._replay_base = None   # state stash at re-promotion: a second
                                   # failure replays base + log, then the
                                   # numpy demotion is permanent
        # fleet lane: an engine run as a fleet batch lane carries a
        # FleetLane on its options; this plane's device dispatches then
        # ride the shared batched launch (lane.dispatch pads to the shape
        # class, the batched kernels advance every parked lane at once,
        # the lane hands back this plane's row).  The lane path is
        # synchronous (the digest-pinned --device-plane-sync shape) and
        # single-table only — a sharded mesh keeps its own step.  Flush
        # caps stay off: the lane's flush section is always full-length
        # (repacked host-side), so the capped variant would only add an
        # overflow path the batch cannot re-run.
        self._lane = None
        lane = getattr(engine.options, "_fleet_lane", None)
        if lane is not None and mode == "device" and self._shard is None:
            self._flush_caps = None
            self._lane = lane
            lane.attach_plane(self)
            from ..obs.metrics import fleet_source
            engine.metrics.source("fleet", fleet_source(lane.plane))

    # -- static layout ----------------------------------------------------
    def _build_layout(self, engine) -> None:
        """Flow table from the static specs: the torcells layout (sorted by
        paced node, segment cumsum offsets) with per-flow onward latencies
        gathered from the engine's real topology rows — no [H, H] local
        matrix is ever materialized (10k-host graphs would not fit)."""
        topo = engine.topology
        # Every host contributes up to TWO plane nodes: its EGRESS node
        # (up-bandwidth bucket — paces stages 0..3, the sending hops) and
        # its INGRESS node (down-bandwidth bucket — paces stage 4, the
        # delivering hop).  Distinct buckets per direction mirror the
        # engine's send/receive TokenBuckets; a client uploading and
        # downloading concurrently contends on the right one each way.
        names: List[Tuple[str, str]] = []      # (host, "tx"|"rx")
        name_idx: Dict[Tuple[str, str], int] = {}

        def node_of(nm: str, kind: str) -> int:
            key = (nm, kind)
            if key not in name_idx:
                name_idx[key] = len(names)
                names.append(key)
            return name_idx[key]

        # chains: 2 per spec (download then upload), VARIABLE hop counts —
        # a tor circuit is 5 stages, a star-bulk pair is 2 (the flow table
        # is built from the actual routes, not a fixed grid)
        chains: List[List[int]] = []
        for s in self.specs:
            for rt in (s.route_down, s.route_up):
                chains.append([node_of(nm, "tx") for nm in rt[:-1]] +
                              [node_of(rt[-1], "rx")])
        self.node_names = names
        self.node_hosts = []
        self.node_kind = [k for (_nm, k) in names]
        self._has_upload = np.array([s.cells_up > 0 for s in self.specs],
                                    dtype=bool)
        rows = np.empty(len(names), dtype=np.int64)
        rates = np.empty(len(names), dtype=np.int64)
        table = getattr(engine, "host_table", None)
        for i, (nm, kind) in enumerate(names):
            # deliberately NOT engine.host_by_name: that would materialize
            # every table row the flow table references — the whole point
            # is that quiet hosts contribute array rows, so read the
            # table's columns instead
            host = engine.hosts_by_name.get(nm)
            if host is not None:
                self.node_hosts.append(host)
                rows[i] = host.topo_row
                rates[i] = (host.params.bw_up_kibps if kind == "tx"
                            else host.params.bw_down_kibps)
                continue
            info = table.plane_host_info(nm) if table is not None else None
            if info is None:
                raise ValueError(f"device plane: unknown host {nm!r}")
            self.node_hosts.append(None)
            topo_row, bw_up, bw_down = info
            rows[i] = topo_row
            rates[i] = bw_up if kind == "tx" else bw_down
        from ..ops.bandwidth import bucket_params
        refill, capacity = bucket_params(rates)
        self.refill = refill.astype(np.int64)
        self.capacity = capacity.astype(np.int64)
        # flatten chains into pre-sort flow arrays (chain-contiguous)
        c = len(chains)
        chain_len = np.array([len(rt) for rt in chains], dtype=np.int64)
        n_flows = int(chain_len.sum())
        flow_chain = np.repeat(np.arange(c, dtype=np.int64), chain_len)
        flow_stage = np.concatenate(
            [np.arange(m, dtype=np.int64) for m in chain_len])
        flow_node = np.concatenate(
            [np.asarray(rt, dtype=np.int64) for rt in chains])
        is_last_pre = flow_stage == chain_len[flow_chain] - 1
        nxt = np.where(is_last_pre, flow_node,
                       np.roll(flow_node, -1))       # next stage, same chain
        pre_succ = np.where(is_last_pre, -1,
                            np.arange(n_flows, dtype=np.int64) + 1)
        lat_ns = np.asarray(topo.latency_ns)[rows[flow_node], rows[nxt]]
        lat_pre = np.where(is_last_pre, 0,
                           np.maximum(lat_ns // TICK_NS, 1))
        # sort by (paced node, chain, stage): the per-tick allocation is a
        # segment cumsum in this order (exact greedy per node)
        order = np.lexsort((flow_stage, flow_chain, flow_node))
        pos_of = np.empty(n_flows, dtype=np.int64)
        pos_of[order] = np.arange(n_flows)
        flow_node = flow_node[order]
        lat = lat_pre[order]
        succ = np.where(pre_succ[order] >= 0,
                        pos_of[np.maximum(pre_succ[order], 0)], -1)
        starts = np.flatnonzero(np.r_[True, flow_node[1:] != flow_node[:-1]])
        seg_id = np.cumsum(np.r_[0, (flow_node[1:] != flow_node[:-1])
                                 .astype(np.int64)])
        self.flow_node = flow_node
        self.flow_lat = lat.astype(np.int64)
        self.flow_succ = succ
        self.seg_start = starts[seg_id]
        self.flow_circ = flow_chain[order]
        self.flow_stage = flow_stage[order]
        # per-chain entry (stage 0) and exit (last stage) flow positions
        chain_base = np.r_[0, np.cumsum(chain_len)[:-1]]
        self.first_flow = pos_of[chain_base]
        self.last_flow = pos_of[chain_base + chain_len - 1]
        self.n_chains = len(chains)
        # Step granulation: the kernel's loop iteration covers ``granule``
        # milliseconds.  Chosen so the arrival ring stays <= ~64 slots even
        # on multi-second-latency topologies (the reference GraphML has
        # 2.3 s paths; a 1 ms-exact ring would be [2300, F] ~ 1 GB at 10k
        # circuits) AND the sequential step count stays low (state bytes x
        # steps is the device cost).  Bandwidth is exact at every granule
        # (refill and burst capacity scale with the step); per-hop latency
        # rounds UP to the next granule multiple — <= granule-1 ms late per
        # hop, never early — identically in both execution modes.
        max_lat = int(self.flow_lat.max()) if len(lat) else 1
        g = max(1, -(-(max_lat + 1) // 64))
        override = getattr(engine.options, "device_plane_granule_ms", 0)
        if override:
            g = int(override)
        self.granule = g
        lat_steps = -(-self.flow_lat // g)
        self.flow_lat_steps = np.where(self.flow_lat > 0,
                                       np.maximum(lat_steps, 1),
                                       0).astype(np.int64)
        self.ring_len = int(self.flow_lat_steps.max()) + 2
        self.refill_step = self.refill * g
        # rate preservation: a backlogged node must be able to spend a full
        # step's refill; burst capacity otherwise keeps the 1 ms bucket's
        self.capacity_step = np.maximum(self.capacity, self.refill_step)
        from ..ops.torcells_device import CELL_WIRE_BYTES
        if int(self.capacity_step.max()) // CELL_WIRE_BYTES >= 2 ** 31:
            # the int32 arrival ring (ops/torcells_device.RING_DTYPE) holds
            # per-step cell counts bounded by capacity/cell-size; a config
            # that could overflow it must fail loudly, not wrap
            raise ValueError(
                "device plane: a node's per-step burst capacity exceeds "
                "2**31 cells — the int32 arrival ring would overflow "
                "(lower --device-plane-granule-ms or the host bandwidth)")
        self.n_flows = n_flows
        self.n_nodes = len(names)
        # Vectorized tracker feed (the control-plane cut): collects
        # fold each flush's per-node byte deltas into ONE numpy
        # scatter-add here; the per-host split into Tracker counter
        # objects happens lazily, only when something actually reads a
        # tracker (heartbeat, digest, teardown) — Tracker.pull_device().
        # 10k quiet hosts pay one np.add.at per collect instead of a
        # Python loop over every touched node.
        self._node_pending = np.zeros(self.n_nodes, dtype=np.int64)
        self._table = table
        name_nodes: Dict[str, List[int]] = {}
        for i, (nm, _kind) in enumerate(names):
            name_nodes.setdefault(nm, []).append(i)
        for nm, nodes in name_nodes.items():
            host = engine.hosts_by_name.get(nm)
            if host is not None:
                host.tracker._device_feed = (self, nodes)
            else:
                # table row: the table folds these nodes' deltas into its
                # tracker columns, and wires the feed at materialization
                table.set_device_nodes(nm, nodes, self)

    # -- state ------------------------------------------------------------
    def _init_state(self):
        if self._shard is not None:
            f = len(self._shard["src"])
            h = len(self._shard["refill"])
            tokens0 = self._shard["capacity"]
        else:
            f, h = self.n_flows, self.n_nodes
            tokens0 = self.capacity_step
        from ..ops.torcells_device import RING_DTYPE
        zeros_f = np.zeros(f, dtype=np.int64)
        state = (np.int64(self._ticks_synced),
                 zeros_f.copy(),                                   # queued
                 np.zeros((self.ring_len, f), dtype=RING_DTYPE),   # ring
                 tokens0.copy(),                                   # tokens
                 zeros_f.copy(),                                   # delivered
                 zeros_f.copy(),                                   # target
                 np.full(f, -1, dtype=np.int64),                   # done_tick
                 np.zeros(h, dtype=np.int64))                      # node_sent
        if self.mode == "device":
            state = self._to_device(state)
        self._state = state
        self._flow_args_cached = None
        self._zero_inject_cached = None
        self._chain_done = np.full(self.n_chains, -1, dtype=np.int64)

    def _to_device(self, state) -> tuple:
        """A numpy state tuple as the plane's tensors: t stays a host
        int64, the arrays go to the plane's device (uploaded on the
        current stream, which the plane's stream then waits for)."""
        out = (np.int64(state[0]),) + tuple(
            torch.as_tensor(np.ascontiguousarray(a), device=self.device)
            for a in state[1:])
        if self._stream is not None:
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
        return out

    def _host(self, a) -> np.ndarray:
        """A plane array on the host; a device tensor is read after the
        plane's stream has finished with it (an explicit sync)."""
        if torch.is_tensor(a):
            if self._stream is not None:
                self._stream.synchronize()
            return a.cpu().numpy()
        return np.asarray(a)

    def _setup_sharding(self, n_dev: int) -> None:
        """The ONE sharding entry point: the mesh plane (parallel/mesh/)
        owns partition, exchange schedule, step, and metrics."""
        from .mesh.meshplane import attach_mesh
        attach_mesh(self, n_dev)

    def _unshard_state(self, lay) -> tuple:
        """Translate the live padded state back to the ORIGINAL flow/node
        space under layout ``lay`` — the inverse of the pad_state
        translation: flow arrays gather through ``inv``, node arrays
        scatter through ``node_src`` (each global node lives on exactly
        one shard, so the scatter is an assignment).  Numpy out."""
        t, queued, ring, tokens, delivered, target, done_tick, node_sent = \
            (self._host(a) for a in self._state)
        inv = lay["inv"]
        node_src = lay["node_src"]
        valid = node_src >= 0
        tok = np.zeros(self.n_nodes, dtype=np.int64)
        sent = np.zeros(self.n_nodes, dtype=np.int64)
        tok[node_src[valid]] = tokens[valid]
        sent[node_src[valid]] = node_sent[valid]
        return (np.int64(t), queued[inv], np.ascontiguousarray(ring[:, inv]),
                tok, delivered[inv], target[inv], done_tick[inv], sent)

    @staticmethod
    def _state_digest(state) -> str:
        """Canonical digest of an original-space state tuple (dtype, shape,
        bytes per array) — the re-layout pin: translating state between
        device layouts must be the identity in the original space."""
        import hashlib
        h = hashlib.sha256()
        for a in state:
            arr = np.asarray(a)
            h.update(str(arr.dtype).encode())
            h.update(str(arr.shape).encode())
            h.update(np.ascontiguousarray(arr).tobytes())
        return h.hexdigest()

    def _reshard(self, engine) -> None:
        """Mid-run shard loss on the mesh (``--fault-inject
        device-lost:ROUND``): at a quiesced round boundary (no dispatch in
        flight), translate the live padded state back to the original flow
        space, re-run the chain partitioner and BvN exchange schedule for
        the surviving D-1 shards, translate the state into the new layout,
        and PIN the round trip — the original-space digest before the
        re-layout must equal the digest read back through the new layout,
        or the run aborts loudly.  The plane's mode, pipeline, superwindow
        and checkpoint contracts are untouched; only the layout moved.
        D=2 loses the mesh entirely and continues on the single-table
        kernels (same digest pin, identity translation)."""
        import time as _wt
        t0 = _wt.perf_counter_ns()
        old = self._shard
        n_old = int(old["n_shards"])
        n_new = n_old - 1
        old_info = self._meshinfo
        orig = self._unshard_state(old)
        digest_before = self._state_digest(orig)
        # old-layout steps and caches die with the lost shard
        self._sharded_variants.clear()
        self._flow_args_cached = None
        self._zero_inject_cached = None
        if n_new < 2:
            self._mesh = None
            self._shard = None
            self._sharded_step = None
            self._mesh_make_step = None
            self._chain_leg_bits = None
            self._full_leg_bits = 0
            self._active_leg_bits = 0
            state = orig
            if old_info is not None:
                old_info.n_devices = 1
                old_info.exchange_mode = "single"
            digest_after = self._state_digest(state)
        else:
            self._setup_sharding(n_new)
            # the new schedule's leg numbering shares nothing with the old
            # mask bookkeeping: run the always-correct full step from here
            # on (-1 is the full-step sentinel; future activations OR into
            # it harmlessly)
            self._active_leg_bits = -1
            lay = self._shard
            from .mesh.partition import pad_state
            keep, src = lay["keep"], lay["src"]
            ring_o = orig[2]
            ring_p = np.zeros((self.ring_len, len(src)), dtype=ring_o.dtype)
            ring_p[:, keep] = ring_o[:, src[keep]]
            node_src = lay["node_src"]
            valid = node_src >= 0
            tok_p = np.zeros(len(node_src), dtype=np.int64)
            sent_p = np.zeros(len(node_src), dtype=np.int64)
            tok_p[valid] = orig[3][node_src[valid]]
            sent_p[valid] = orig[7][node_src[valid]]
            state = (orig[0], pad_state(lay, orig[1]), ring_p, tok_p,
                     pad_state(lay, orig[4]), pad_state(lay, orig[5]),
                     pad_state(lay, orig[6], fill=-1), sent_p)
            self._state = state
            digest_after = self._state_digest(self._unshard_state(lay))
            # runtime counters survive the re-layout (the schedule-shape
            # fields are the NEW mesh's, by design)
            self._meshinfo.cross_shard_cells += old_info.cross_shard_cells
            self._meshinfo.host_bounces += old_info.host_bounces
        if digest_after != digest_before:
            raise RuntimeError(
                f"device plane re-shard {n_old}->{n_new}: state digest "
                f"changed across the re-layout ({digest_before[:12]} != "
                f"{digest_after[:12]}) — the translation is not the "
                "identity; aborting rather than continuing on corrupt "
                "state")
        if self.mode == "device":
            state = self._to_device(state)
        self._state = state
        engine.supervision.count_reshard(
            n_old, n_new, mttr_ns=_wt.perf_counter_ns() - t0)

    def _read_summaries(self):
        """(delivered, done_tick, node_sent) in the ORIGINAL flow/node
        space, whatever the execution layout.  Final-state reader for
        tests/tooling (e.g. the conservation gate) — the engine hot path
        never calls this; consume() reads the packed flush buffer, and
        materializing full state tensors here would forfeit the pipeline
        if it ever crept into a per-round path."""
        delivered = self._host(self._state[4])
        done_tick = self._host(self._state[6])
        node_sent = self._host(self._state[7])
        if self._shard is None:
            return delivered, done_tick, node_sent
        inv = self._shard["inv"]
        node_src = self._shard["node_src"]
        global_sent = np.zeros(self.n_nodes, dtype=np.int64)
        valid = node_src >= 0
        np.add.at(global_sent, node_src[valid], node_sent[valid])
        return delivered[inv], done_tick[inv], global_sent

    def _flow_args(self):
        """The static flow tables, resident where the kernel runs: device
        tensors in device mode (uploaded ONCE — re-sending ~2 MB of
        int64 tables per dispatch at 10k circuits would waste host link
        bandwidth every round, with the kernel's derived tables — arrival
        latencies, node segments — computed once beside them), plain numpy
        for the twin.  On the mesh: the padded layout's statics (the
        sharded step's argument list), on the plane's device."""
        if self._flow_args_cached is None and self._shard is not None:
            lay = self._shard
            args = tuple(lay[k] for k in (
                "flow_node_local", "succ_global", "seg_start_local",
                "refill", "capacity", "arr_lat", "shard_base"))
            if self.mode == "device":
                args = self._to_device((0,) + args)[1:]
            self._flow_args_cached = args
        if self._flow_args_cached is None:
            args = (self.flow_node, self.flow_lat_steps, self.flow_succ,
                    self.seg_start, self.refill_step, self.capacity_step,
                    self.last_flow)
            if self.mode == "device":
                from ..ops.torcells_device import SpanTables
                args = self._to_device((0,) + args)[1:]
                self._span_tables = SpanTables(
                    args[0], args[1], args[2], args[3], self.n_nodes,
                    self.ring_len)
            self._flow_args_cached = args
        return self._flow_args_cached

    def _zero_inject(self):
        """A reusable (device-resident in device mode) zero inject vector in
        the execution layout — most dispatches carry no injections, and
        re-uploading two [F] int64 zero vectors per dispatch is exactly the
        per-round transfer chatter the pipeline exists to cut."""
        if self._zero_inject_cached is None:
            f = len(self._shard["src"]) if self._shard is not None \
                else self.n_flows
            z = np.zeros(f, dtype=np.int64)
            if self.mode == "device":
                z = self._to_device((0, z))[1]
            self._zero_inject_cached = z
        return self._zero_inject_cached

    # -- app-facing -------------------------------------------------------
    def activate(self, client_name: str, cells: Optional[int] = None) -> int:
        """Called by the client app once its circuit is built: inject both
        directions' cells (download at the server's chain head, upload at
        the client's) on the next dispatch."""
        spec = self._by_client.get(client_name)
        if spec is None:
            raise ValueError(f"{client_name} has no device flow spec")
        if cells is not None and cells < 1:
            # a zero-cell chain's completion (target > 0) can never fire, so
            # the joining client would block until end_time — reject loudly
            raise ValueError(
                f"{client_name}: activate(cells={cells}) — device flows "
                "need at least 1 cell")
        return self._activate_spec(spec, cells)

    def _activate_spec(self, spec, cells: Optional[int] = None) -> int:
        """Inject a spec's cells (shared by name-keyed plugin activation
        and circuit-indexed auto staging — auto flows are not in
        ``_by_client``, a host may carry many of them)."""
        # an explicit cells argument overrides the DOWNLOAD size; the
        # configured upload still runs (completion requires both chains)
        down = spec.cells_down if cells is None else cells
        up = spec.cells_up
        self._inject_buf.append((2 * spec.circuit, down))
        if up:
            self._inject_buf.append((2 * spec.circuit + 1, up))
        self.total_injected_cells += down + up
        if self._chain_leg_bits is not None:
            # quiet-tick fusion bookkeeping: the chains this injection
            # activates may now carry cells over their exchange legs —
            # the active-leg superset only ever GROWS (in-flight cells
            # never migrate legs), which is what keeps every cached
            # masked variant digest-identical to the full step
            self._active_leg_bits |= int(self._chain_leg_bits[
                2 * spec.circuit])
            if up:
                self._active_leg_bits |= int(self._chain_leg_bits[
                    2 * spec.circuit + 1])
        return spec.circuit

    def check_route(self, client_name: str, hops: List[str]) -> None:
        """Cross-check the client's RUNTIME route (hop host names in
        client-side order, e.g. [guard, middle, exit] for tor or [server]
        for star bulk) against the spec the flow table was built from.  A
        mismatch means an auto: client's fetched consensus diverged from
        the startup prediction — the flows would silently ride the wrong
        links, so fail loudly instead."""
        spec = self._by_client.get(client_name)
        if spec is None:
            raise ValueError(f"{client_name} has no device flow spec")
        expect = spec.route_up[1:-1] if len(spec.route_up) > 2 \
            else [spec.route_up[-1]]
        if list(hops) != expect:
            raise RuntimeError(
                f"device plane: {client_name}'s runtime route {hops} != "
                f"predicted route {expect} (the consensus diverged from "
                "the startup prediction — e.g. a relay published late)")

    def is_done(self, circuit: int) -> bool:
        return circuit in self._done

    def result(self, circuit: int) -> int:
        return self._done[circuit]

    def register_waiter(self, circuit: int, process, thread) -> None:
        self._waiters[circuit] = (process, thread)

    def warmup(self) -> None:
        """Build the span and flush kernels and make one launch of each on
        throwaway zero state of this plane's exact shapes, so the first
        dispatch pays no nvcc build.  No plane state is touched."""
        if self.mode != "device":
            return
        if self._lane is not None:
            # fleet lanes share the batched launch; a per-lane warmup would
            # launch the unbatched kernels nobody calls
            return
        from ..ops.torcells_device import (RING_DTYPE,
                                           torcells_step_window_flush)
        if self._shard is not None:
            lay = self._shard
            fp, hp = len(lay["src"]), len(lay["refill"])
            zp = np.zeros(fp, dtype=np.int64)
            state = self._to_device(
                (0, zp, np.zeros((self.ring_len, fp), dtype=RING_DTYPE),
                 lay["capacity"], zp, zp, np.full(fp, -1, dtype=np.int64),
                 np.zeros(hp, dtype=np.int64)))
            zero = self._to_device((0, zp))[1]
            args = self._flow_args()
            with self._on_stream():
                out = self._sharded_step(*state, zero, zero,
                                         self._pad_targets([1]),
                                         np.int64(0), *args)
            self._host(out[9])
            return
        f, h = self.n_flows, self.n_nodes
        z = np.zeros(f, dtype=np.int64)
        state = self._to_device(
            (0, z, np.zeros((self.ring_len, f), dtype=RING_DTYPE),
             self.capacity_step, z, z, np.full(f, -1, dtype=np.int64),
             np.zeros(h, dtype=np.int64)))
        zero = self._to_device((0, z))[1]
        args = self._flow_args()
        with self._on_stream():
            out = torcells_step_window_flush(
                *state, zero, zero, self._pad_targets([1]), 0, *args,
                ring_len=self.ring_len, tables=self._span_tables)
        self._host(out[9])

    def _on_stream(self):
        """The context a launch runs in: the plane's device and its own
        stream on the card, nothing on the CPU."""
        import contextlib
        ctx = contextlib.ExitStack()
        if self._stream is not None:
            ctx.enter_context(torch.cuda.device(self.device))
            ctx.enter_context(torch.cuda.stream(self._stream))
        return ctx

    def _launch(self, state, inject, inject_target, tvec, idle):
        """One dispatch on the plane's device: upload this window's
        injections (numpy) from a pinned buffer, run the span and flush
        kernels on the plane's stream (the plain versions on the CPU), and
        start the flush's copy back.  Returns (the 10-tuple, the flush
        handle): a :class:`_FlushHandle` on the card, the finished numpy
        buffer on the CPU.  On the mesh the launch is the sharded step's
        (the state and injections in the padded layout)."""
        from ..ops.torcells_device import torcells_step_window_flush
        args = self._flow_args()
        caps = self._flush_caps
        held = []
        with self._on_stream():
            if isinstance(inject, np.ndarray):
                if self._stream is not None:
                    up = self._pinned.acquire((2, len(inject)))
                    up[0].numpy()[:] = inject
                    up[1].numpy()[:] = inject_target
                    held.append(up)
                    dev = up.to(self.device, non_blocking=True)
                    inject, inject_target = dev[0], dev[1]
                else:
                    inject = torch.from_numpy(inject)
                    inject_target = torch.from_numpy(inject_target)
            launch_state = state
            if caps is not None:
                # delta-compacted flush (tuner decision): stash the
                # inputs so an overflowing window (true counts in the
                # header exceed the caps) can re-run full-length at
                # consume; the kernels update state in place, so the
                # capped launch runs on a clone and the stash keeps the
                # pre-launch state alive
                launch_state = (state[0],) + tuple(a.clone()
                                                   for a in state[1:])
                self._inflight_caps = caps
                self._inflight_args = (state, inject, inject_target, tvec,
                                       np.int64(idle))
            if self._shard is not None:
                out = self._pick_sharded_step()(
                    *launch_state, inject, inject_target, tvec,
                    np.int64(idle), *args)
            else:
                out = torcells_step_window_flush(
                    *launch_state, inject, inject_target, tvec,
                    np.int64(idle), *args, ring_len=self.ring_len,
                    cap_chains=caps[0] if caps else None,
                    cap_nodes=caps[1] if caps else None,
                    tables=self._span_tables)
            if self._stream is None:
                # simjit: disable=SIM302 -- the CPU plane (no stream): out lies on the host, nothing is in flight; on the card the copy back is the _FlushHandle's
                return out, out[9].numpy()
            pin = self._pinned.acquire((out[9].shape[0],))
            pin.copy_(out[9], non_blocking=True)
            held.append(pin)
            event = torch.cuda.Event()
            event.record(self._stream)
        return out, _FlushHandle(pin, event, held, self._pinned)

    def _pad_targets(self, targets: List[int]) -> np.ndarray:
        """Pad a superwindow's boundary list to the static kernel shape by
        repeating the final boundary (repeats are never reached: the loop
        ends at targets[-1])."""
        pad = self.superwindow_rounds
        out = np.full(pad, int(targets[-1]), dtype=np.int64)
        out[:len(targets)] = np.asarray(targets, dtype=np.int64)
        return out

    # -- engine-facing ----------------------------------------------------
    def negotiate_superwindow(self, nxt: int, lookahead: int, host_next: int,
                              end_time: int, cap_time: Optional[int],
                              max_rounds: int) -> Optional[int]:
        """Replay the K=1 round recurrence forward from the window the
        engine just computed ([nxt, nxt+lookahead)) and merge up to
        ``max_rounds`` consecutive rounds into ONE superwindow, stopping
        before the first round that would contain a host-side event
        (``host_next``: the earliest Python-queue or native-C-heap event) —
        or a checkpoint/resume boundary (``cap_time``).  Returns the merged
        span's end (the engine's new window_end) and stages a _SuperPlan
        for advance(), or None when no extension applies.

        The plan replicates advance()'s own cadence decisions exactly, so
        a K-round launch produces the same dispatch bases/targets — and,
        with the kernel's halt-at-completion rule, the same wake barriers —
        as K separate rounds: digest parity K=1-vs-K is by construction
        (tests/test_superwindow.py pins it).  That construction is why the
        auto-tuner (prof/autotune.py) may deepen K freely from measured
        launch costs: quiet rounds — including the quiet ticks between
        cross-shard exchange activity on a masked mesh variant — merge
        into one span launch with bit-identical results at any depth."""
        if (max_rounds <= 1 or self._state is None or self._inflight
                or self.superwindow_rounds <= 1):
            return None
        if (not self._inject_buf
                and self._cells_delivered_seen >= self._cells_dispatched):
            # empty plane: not driving windows; nothing to merge
            return None
        grid = TICK_NS * self.granule
        q = self.min_dispatch_steps
        synced = self._ticks_synced
        bounds: List[tuple] = []
        targets: List[int] = []
        round_of: List[int] = []
        ws = nxt
        for i in range(min(max_rounds, self.superwindow_rounds)):
            we = min(ws + lookahead, end_time)
            if i > 0 and cap_time is not None \
                    and (ws >= cap_time or we > cap_time):
                # a checkpoint/resume boundary at cap_time: the round
                # containing (or starting at) it must run K=1 so the
                # snapshot digest lands on an exact visited round boundary
                break
            if host_next < we:
                break               # a host event falls inside this round
            t_i = we // grid
            if t_i - synced >= q:   # advance()'s cadence rule, replayed
                targets.append(int(t_i))
                round_of.append(i)
                synced = t_i
            bounds.append((ws, we))
            nxt_dev = (synced + q) * grid
            if nxt_dev >= host_next or nxt_dev >= end_time:
                break               # next round would be host-driven
            ws = nxt_dev
        if len(bounds) < 2 or not targets:
            return None
        self._pending_plan = _SuperPlan(int(self._ticks_synced), targets,
                                        bounds, round_of)
        return bounds[-1][1]

    def advance(self, engine) -> None:
        """LAUNCH: dispatch the window step advancing the plane to the
        current round's barrier — or, when a superwindow was negotiated,
        through the whole merged span in ONE kernel launch.  Called at the
        TOP of the round (right after the engine computes the window), so
        the dispatch computes while the host drains the round's arrivals;
        consume() collects at the next loop iteration, always before the
        next window.  Staged injections (activations from earlier rounds)
        are folded in at the dispatch's base step — the engine has already
        committed the previous dispatch, so the one-deep in-flight slot is
        free here."""
        import time as _wt
        t0 = _wt.perf_counter_ns()
        assert not self._inflight, \
            "device plane: launch with an uncollected dispatch in flight"
        if self._fault_device_lost and self._shard is not None \
                and self._state is not None \
                and engine.rounds_executed + 1 >= self._fault_device_lost:
            # injected shard loss: the plane is quiesced here (no dispatch
            # in flight — the assert above IS the boundary condition), so
            # re-partition onto the survivors before this round's launch
            self._fault_device_lost = 0
            self._reshard(engine)
        if self._auto_pos < len(self._auto):
            ws = engine.scheduler.window_start
            if self._state is None and not self._inject_buf \
                    and self.total_injected_cells == 0:
                # nothing has ever dispatched: re-base the step counter to
                # the window so the first dispatch does not grind through
                # the pre-traffic idle gap tick by tick
                self._ticks_synced = max(self._ticks_synced,
                                         ws // (TICK_NS * self.granule))
            self._stage_autos(ws)
        plan, self._pending_plan = self._pending_plan, None
        if plan is None:
            target_ticks = engine.scheduler.window_end // (TICK_NS
                                                           * self.granule)
            n = target_ticks - self._ticks_synced
            if n <= 0 and not self._inject_buf:
                return
            n = max(n, 0)
            if self._state is None:
                if not self._inject_buf and self.total_injected_cells == 0:
                    # nothing has ever activated: don't spin the kernel
                    self._ticks_synced = target_ticks
                    return
                self._init_state()
            elif (not self._inject_buf
                  and self._cells_delivered_seen >= self._cells_dispatched):
                # plane is empty: bank the ticks, skip the dispatch
                self._idle_ticks_banked += n
                self._ticks_synced = target_ticks
                self.idle_rounds_skipped += 1
                return
            if n < self.min_dispatch_steps:
                # cadence batching: let ticks (and injections) accumulate a
                # few rounds before paying a dispatch; next_time() keeps the
                # engine window loop coming back even when the Python plane
                # idles
                return
            targets = [int(target_ticks)]
        else:
            # superwindow: the plan's targets ARE the K=1 dispatch targets;
            # ticks_synced advances at consume, from the flush's t_stop
            # (the kernel may halt at an earlier boundary on a completion)
            targets = plan.targets
            n = targets[-1] - self._ticks_synced
        inject_pairs = list(self._inject_buf)
        if self._inject_buf:
            f = self.n_flows
            inject = np.zeros(f, dtype=np.int64)
            inject_target = np.zeros(f, dtype=np.int64)
            for circ, cells in self._inject_buf:
                inject[self.first_flow[circ]] += cells
                inject_target[self.last_flow[circ]] += cells
                self._cells_dispatched += cells
            self._inject_buf.clear()
            if self._shard is not None:
                from .mesh.partition import pad_state
                inject = pad_state(self._shard, inject)
                inject_target = pad_state(self._shard, inject_target)
            if self.mode == "device":
                self.device_calls += 1          # inject upload
        else:
            inject = inject_target = self._zero_inject()
        idle = self._idle_ticks_banked
        self._idle_ticks_banked = 0
        # Step continuity: the kernel's carried t equals the last dispatch's
        # end step; _ticks_synced (pre-update here) additionally counts any
        # banked idle steps, so re-basing to it jumps t exactly over the
        # idle gap — legal because idle banking requires an empty ring — and
        # is the identity when nothing was banked.  (Re-basing to anything
        # else desynchronizes the arrival ring's absolute slots: cells would
        # be skipped or re-read — pinned by the JAX package's
        # test_varying_dispatch_sizes_preserve_arrivals.)
        if self.mode == "device":
            # the log exists solely to recover a FAILED device dispatch;
            # the numpy twin executes synchronously and cannot leave a
            # failed in-flight slot, so logging there (or after demotion)
            # would only accumulate memory it can never use
            self._dispatch_log.append((int(self._ticks_synced),
                                       inject_pairs, list(targets),
                                       int(idle)))
        state = (np.int64(self._ticks_synced), *self._state[1:])
        tvec = self._pad_targets(targets)
        if self.mode == "device" and self._lane is not None:
            # fleet lane: the dispatch parks at the shared plane's barrier
            # and returns this lane's row of the batched launch — the state
            # as tensors on the plane's device and an already-materialized
            # numpy flush, so consume() runs unchanged (the collect is a
            # no-op np.asarray).  Synchronous by construction: the
            # digest-pinned --device-plane-sync shape.
            out = self._lane.dispatch(state, inject, inject_target, tvec,
                                      int(idle))
            handle = out[9]
        elif self.mode == "device":
            out, handle = self._launch(state, inject, inject_target, tvec,
                                       idle)
        else:
            from ..ops.torcells_device import torcells_step_window_numpy_flush
            out = torcells_step_window_numpy_flush(*state, inject,
                                                   inject_target, tvec, idle,
                                                   *self._flow_args(),
                                                   self.ring_len)
            handle = out[9]
        self._state = out[:8]
        self._flush_handle = handle
        if plan is None:
            # single-target dispatch: the kernel cannot halt before its one
            # boundary, so the reached step is known without the flush
            self._ticks_synced = targets[-1]
        else:
            self._active_plan = plan
        self._inflight = True
        self.dispatches += 1
        if self.mode == "device":
            self.device_calls += 1              # the dispatch itself
            if self._sync:
                # serial oracle: idle through the kernel instead of
                # overlapping — everything else is identical, so digests
                # must match the pipelined run bit for bit
                if isinstance(self._flush_handle, _FlushHandle):
                    self._flush_handle.synchronize()
        if self._fault_dispatch and self.dispatches == self._fault_dispatch \
                and self.mode == "device":
            # fault harness: this dispatch's collect raises (or hangs) —
            # consume() must recover via the numpy-twin replay (device-only:
            # the twin has no asynchronous slot to poison)
            self._flush_handle = _PoisonedFlush(self._flush_handle,
                                                hang=self._fault_hang)
            self._fault_dispatch = 0
        # per-launch predicted device cost: per-tick step
        # kernel + exchange collectives, plus the fixed transfer, from
        # the measured model.  Stored as (per-step, fixed) — a
        # superwindow kernel may HALT at an earlier negotiated boundary
        # on a completion, so consume() scales the per-step half by the
        # steps actually reached (flush t_stop) before judging the
        # band; predicting the full plan span would flag early-halted
        # windows as model-stale on a perfectly calibrated model.
        self._launch_pred = None       # (per_step_us, fixed_us)
        # the kernel's carried t runs from this base to the reached
        # boundary: steps executed = t_stop - base (idle-banked ticks
        # are a re-base jump, not loop iterations, so they don't count)
        self._launch_base = int(targets[-1]) - int(n)
        if self._costmodel is not None and self.mode == "device":
            if self._shard is not None:
                kernel_flows = len(self._shard["src"])
                ex_us = self._meshinfo.predicted_us
            else:
                kernel_flows = self.n_flows
                ex_us = 0.0
            # only predict INSIDE the model's measured range (the
            # two-sided CostModel.covers guard): a table far below the
            # smallest — or above the largest — calibrated flow count
            # would be judged by pure extrapolation and flood
            # prof.model_stale with false positives
            if self._costmodel.covers(kernel_flows):
                self._launch_pred = (
                    self._costmodel.step_us(kernel_flows)
                    + max(ex_us, 0.0),
                    self._costmodel.transfer_us())
        self._launch_wall = _wt.perf_counter_ns()
        self.host_ns += self._launch_wall - t0
        self._profiler.on_dispatch(t0, self._launch_wall, int(n),
                                   len(inject_pairs), self.dispatches,
                                   engine.scheduler.window_end)

    def consume(self, engine) -> None:
        """COLLECT: materialize the in-flight dispatch's packed flush
        buffer (ONE device->host transfer), wake completed flows, and feed
        the per-node byte deltas to the trackers.  Runs before the engine
        computes the next window (same contract as the tpu policy's
        consume_flush).  An exception raised inside the in-flight dispatch
        surfaces HERE, at materialization — nothing is caught."""
        if not self._inflight:
            return
        import time as _wt
        t0 = _wt.perf_counter_ns()
        self.pipeline_overlap_ns += t0 - self._launch_wall
        # the slot is released up front so state stays consistent whether
        # the collect succeeds, raises, or is recovered
        handle, self._flush_handle = self._flush_handle, None
        self._inflight = False
        with self._profiler.tracer.span(
                "device.collect", "device",
                sim_ns=engine.scheduler.window_start,
                args={"dispatch": self.dispatches}):
            try:
                # blocks iff still computing; a failure inside the
                # in-flight dispatch RAISES here (guarded by
                # --device-watchdog-sec)
                flush = self._collect_flush(engine, handle)
            except Exception as e:  # noqa: BLE001 - any dispatch failure
                if not isinstance(handle, _PoisonedFlush):
                    # no hidden fallback: a real failure (CUDA error,
                    # watchdog timeout) ends the run; only the injected
                    # drill exercises the numpy-twin recovery ladder
                    raise
                flush = self._recover_dispatch(engine, e)
        t1 = _wt.perf_counter_ns()
        self.device_ns += t1 - t0
        self._profiler.on_collect(self._launch_wall, t0, t1 - t0,
                                  int(getattr(flush, "nbytes", 0)),
                                  self.dispatches,
                                  engine.scheduler.window_start)
        if self.mode == "device":
            self.device_calls += 1              # the flush read
        from ..ops.torcells_device import (flush_len, flush_overflowed,
                                           parse_flush)
        caps, self._inflight_caps = self._inflight_caps, None
        args, self._inflight_args = self._inflight_args, None
        if caps is not None and self.mode != "device":
            caps = None     # recovered on the twin: flush is full-length
        if caps is not None:
            if flush_overflowed(flush, *caps):
                # a busy window outran the tuned caps: re-run the SAME
                # inputs through the full-length kernel (bit-identical
                # state math — only the flush encoding differs) and read
                # the complete buffer.  Persistent overflow means the
                # caps are mis-sized for this phase: stop paying the
                # re-runs and revert to full flushes for the rest of
                # the run.
                flush = self._rerun_full_flush(args)
                self.flush_overflows += 1
                caps = None
                if self.flush_overflows >= 8:
                    self._flush_caps = None
            else:
                self.flush_bytes_saved += 8 * (
                    flush_len(self.n_chains, self.n_nodes)
                    - flush_len(self.n_chains, self.n_nodes, *caps))
        (forwards, delivered_sum, t_stop, done_chains, done_steps, node_idx,
         node_delta) = parse_flush(flush, self.n_chains, self.n_nodes,
                                   *(caps or (None, None)))
        # launch attribution: predicted-vs-measured per-launch
        # gauges, the model-stale band check, and the sim-correlated
        # device track span — one call per collect, ~free when no model
        # is loaded and observability is off.  Placed AFTER parse_flush
        # so the prediction covers the steps the kernel actually REACHED
        # (t_stop): a superwindow halting early on a completion is
        # judged on its real span, never flagged stale for not running
        # the merged rounds it skipped.  Device mode only — the numpy
        # twin's host-side walls must not pollute the launch gauges.
        steps_done = max(int(t_stop) - self._launch_base, 0)
        self.steps += steps_done
        if self.mode == "device":
            pred_us = None
            if self._launch_pred is not None:
                per_step, fixed = self._launch_pred
                pred_us = steps_done * per_step + fixed
            self._profiler.on_window(
                self._launch_wall, t1, t1 - t0, steps_done,
                self.granule, pred_us,
                self._costmodel.band if self._costmodel is not None
                else 0.0,
                engine.scheduler.window_start,
                self._meshinfo.exchange_mode if self._meshinfo is not None
                else "single")
        if self._meshinfo is not None:
            # mesh flush: ONE trailing slot carries the window's
            # cross-shard cell count (zero extra device reads; a
            # standard-length buffer — the numpy twin after a demotion —
            # contributes 0)
            from .mesh.exchange import mesh_flush_extra
            self._meshinfo.cross_shard_cells += mesh_flush_extra(
                flush, self.n_chains, self.n_nodes)
            if self.mode == "numpy" and forwards > 0 \
                    and self._meshinfo.cross_edges > 0:
                # demoted sharded plane: this window's cross-shard
                # forwards executed HOST-side on the twin — counted so
                # the mesh.host_bounces == 0 steady-state gate is
                # falsifiable, not a tautology (the fault drill pins it
                # going nonzero after a demotion)
                self._meshinfo.host_bounces += 1
        self.total_forwards += forwards
        self._cells_delivered_seen = delivered_sum
        plan, self._active_plan = self._active_plan, None
        if plan is not None:
            # superwindow collect: the kernel reached t_stop — the plan's
            # final boundary, or an earlier one when a completion halted
            # it.  Rewind the engine's bookkeeping to the virtual round
            # that launched the reached span: the window bounds become that
            # round's (so completion wakes clamp to ITS barrier, exactly
            # as K=1 would), and the round counter advances by the merged
            # rounds actually covered (state digests carry it).
            try:
                j = plan.targets.index(t_stop)
            except ValueError:
                raise AssertionError(
                    f"device plane: superwindow stopped at step {t_stop}, "
                    f"not one of its negotiated boundaries {plan.targets}")
            r = plan.round_of[j]
            ws, we = plan.bounds[r]
            engine.scheduler.set_window(ws, we)
            engine.rounds_executed += r
            self._ticks_synced = t_stop
            self.superwindows += 1
            self._rounds_launched += r + 1
        else:
            self._rounds_launched += 1

        # trackers: per-node spent-byte deltas, delta-compacted on device,
        # folded with ONE numpy scatter-add; the per-host split into
        # Tracker counters happens on read (Tracker.pull_device) — the
        # vectorized control-plane cut
        if len(node_idx):
            np.add.at(self._node_pending, node_idx, node_delta)

        # wake completed clients: BOTH chains (download 2c, upload 2c+1)
        # must have delivered; wake at the later completion step
        # (deterministic: ticks from the kernel, clamped to the barrier —
        # under a superwindow the halt rule guarantees every completion
        # here belongs to the span whose barrier the window now carries).
        # Only the chains that newly completed THIS dispatch arrive in the
        # flush buffer — O(completions), not O(circuits), per collect.
        # The batched wake fold: wake times are computed in one
        # vectorized pass and the events land in the scheduler through ONE
        # push_batch call instead of a per-circuit push chain; the wake
        # event itself then resumes the client directly (the wake IS the
        # continue — _device_wake_task), so a completed flow costs one
        # scheduler round-trip, not two.
        if len(done_chains):
            barrier = engine.scheduler.window_end
            self._chain_done[done_chains] = done_steps
            circs = np.unique(np.asarray(done_chains) >> 1)
            d = self._chain_done[2 * circs]
            u = self._chain_done[2 * circs + 1]
            ready = (d >= 0) & ((u >= 0) | ~self._has_upload[circs])
            steps = np.maximum(d, u)
            wakes = np.maximum((steps + 1) * TICK_NS * self.granule,
                               barrier)
            # ONE fold loop for both delivery sinks, so the done-guard /
            # decline rules can never desync between the planes: under the
            # native plane the wakes land as C-heap continuation events in
            # ONE push_cont_batch extension call (same per-host
            # sequence claims, same wake times, no Python Task/Event per
            # flow); otherwise as Events through one push_batch call
            native = getattr(engine, "native_plane", None)
            make = self._make_wake_item if native is not None \
                else self._make_wake_event
            items = []
            for circ, wake in zip(circs[ready].tolist(),
                                  wakes[ready].tolist()):
                if circ in self._done:
                    continue
                self._done[circ] = wake
                item = make(engine, circ, wake)
                if item is not None:
                    items.append(item)
            if items:
                if native is not None:
                    native.push_device_wakes(items)
                else:
                    engine.counters.count_new("event", len(items))
                    engine.scheduler.policy.push_batch(
                        items, 0, engine.scheduler.window_end)
        # probation clock: each clean collect on the demoted
        # twin counts toward re-promotion; the threshold re-attempts the
        # device rung once (permanent-on-repeat preserved via _repromoted)
        if (self.demoted and self.mode == "numpy"
                and self._repromote_after > 0 and not self._repromoted):
            self._probation_clean += 1
            if self._probation_clean >= self._repromote_after:
                self._repromote(engine)
        self.host_ns += _wt.perf_counter_ns() - t1

    def _collect_flush(self, engine, handle) -> np.ndarray:
        """Materialize the in-flight dispatch's flush buffer, bounded by
        ``--device-watchdog-sec`` in device mode: the blocking read runs on
        a helper thread so a dispatch that never completes (wedged runtime,
        dead device tunnel) raises TimeoutError here instead of freezing
        the round loop forever.  Only the guard's bookkeeping (thread spawn
        + join return) is charged to supervision overhead — the wait for
        the result is the dispatch's own cost, watchdog or not."""
        if self.mode != "device" or self._watchdog_sec <= 0:
            return np.asarray(handle)
        import threading
        import time as _wt
        t_g = _wt.perf_counter_ns()
        # the result box is written by the helper thread and read by the
        # dispatcher: one lock covers both sides (simrace SIM102 — a
        # timed-out join() returning does NOT order the abandoned
        # helper's late write against the dispatcher's read, so the
        # dict-sharing idiom was a real, if narrow, race window)
        box: Dict[str, object] = {}
        box_lock = threading.Lock()

        def _work() -> None:
            try:
                out = np.asarray(handle)
            except BaseException as e:  # noqa: BLE001 - forwarded below
                with box_lock:
                    box["err"] = e
            else:
                with box_lock:
                    box["out"] = out

        th = threading.Thread(target=_work, daemon=True,
                              name="device-dispatch-collect")
        th.start()
        engine.supervision.overhead_ns += _wt.perf_counter_ns() - t_g
        th.join(self._watchdog_sec)
        if th.is_alive():
            # the helper thread is abandoned with the handle (it cannot be
            # interrupted mid-XLA-call); the numpy replay takes over
            raise TimeoutError(
                f"device dispatch did not complete within "
                f"{self._watchdog_sec:.0f}s (--device-watchdog-sec)")
        t_g = _wt.perf_counter_ns()
        with box_lock:
            err = box.get("err")
            out = box.get("out")
        if err is not None:
            raise err
        engine.supervision.overhead_ns += _wt.perf_counter_ns() - t_g
        return out

    def _rerun_full_flush(self, args) -> np.ndarray:
        """Overflow recovery for the delta-compacted flush: the capped
        buffer's TRUE header counts exceeded its caps, so some
        completions/node deltas were dropped from the ENCODING (never from
        the state — the capped and full kernels run byte-identical tick
        math).  Re-run the stashed inputs through the full-length kernel
        and read its complete flush.  Only reachable on the non-donating
        path, where the inputs survived the capped launch."""
        assert args is not None, "flush overflow with no stashed inputs"
        state, inject, inject_target, tvec, idle = args
        from ..ops.torcells_device import torcells_step_window_flush
        with self._on_stream():
            out = torcells_step_window_flush(
                *state, inject, inject_target, tvec, idle,
                *self._flow_args(), ring_len=self.ring_len,
                tables=self._span_tables)
        self.device_calls += 1          # the recovery dispatch + read
        return self._host(out[9])

    def _autotune_metrics(self) -> Dict[str, object]:
        """The ``prof.autotune_*`` registry source: the tuner's decision
        plus its runtime outcomes.  flush_compact reports the caps
        actually ENGAGED (the plan's choice can be overridden by the
        device gate or the persistent-overflow revert)."""
        m = self._tune_plan.metrics()
        m["prof.autotune_flush_compact"] = int(self._flush_caps is not None)
        m["prof.flush_bytes_saved"] = self.flush_bytes_saved
        m["prof.flush_overflows"] = self.flush_overflows
        return m

    def _pick_sharded_step(self):
        """The sharded step variant for this dispatch (quiet-tick
        exchange-leg fusion): when the active chains touch only a subset
        of the schedule's legs, run a variant with the quiet legs left out
        — each masked ppermute leg is one exchange fewer per tick, and an
        all-masked span exchanges nothing.  The active-leg set only grows,
        every variant is a superset of the cells actually in flight, and a
        full variant cache falls back to the always-correct full step."""
        if self._chain_leg_bits is None or self._full_leg_bits == 0:
            return self._sharded_step
        bits = self._active_leg_bits
        full = self._full_leg_bits
        if bits < 0 or full < 0 or bits == full:
            if self._meshinfo is not None:
                self._meshinfo.legs_active = full.bit_length() \
                    if full >= 0 else self._meshinfo.legs
            return self._sharded_step
        step = self._sharded_variants.get(bits)
        if step is None:
            if len(self._sharded_variants) >= 4:
                # variant budget spent: the full step is always right
                if self._meshinfo is not None:
                    self._meshinfo.legs_active = full.bit_length()
                return self._sharded_step
            n_legs = full.bit_length()
            mask = tuple(bool(bits >> k & 1) for k in range(n_legs))
            step = self._mesh_make_step(mask)
            self._sharded_variants[bits] = step
            DeviceTrafficPlane.sharded_variants_high_water = max(
                DeviceTrafficPlane.sharded_variants_high_water,
                len(self._sharded_variants))
        if self._meshinfo is not None:
            self._meshinfo.legs_active = bin(bits).count("1")
        return step

    def _recover_dispatch(self, engine, exc: BaseException) -> np.ndarray:
        """Graceful device-plane degradation: the in-flight dispatch failed
        (exception or watchdog timeout), so rebuild the plane's state by
        replaying the FULL logged window history on the bit-identical numpy
        twin — the carried device state is donated on accelerators, so
        there is no pre-state buffer to restart from — and PERMANENTLY
        demote the backend to the twin.  Digest parity is preserved (the
        twin is the parity oracle the tests pin); device speed is
        forfeited.  Returns the failed window's flush buffer, which the
        caller consumes exactly as if the device had produced it."""
        get_logger().warning(
            "device-plane",
            f"in-flight dispatch failed ({exc!r}); replaying "
            f"{len(self._dispatch_log)} windows on the numpy twin and "
            "permanently demoting the backend to numpy")
        self.mode = "numpy"
        self.demoted = True
        self.recoveries += 1
        engine.supervision.count_dispatch_recovery(
            f"device dispatch recovered on the numpy twin ({exc!r}); "
            "backend demoted for the rest of the run")
        self._mesh = None
        self._shard = None
        self._sharded_step = None
        self._sharded_variants.clear()
        self._chain_leg_bits = None
        # the twin packs full-length flushes only; drop the capped-path
        # bookkeeping with the device backend
        self._flush_caps = None
        self._inflight_caps = None
        self._inflight_args = None
        # predictions are calibrated for the DEVICE kernels; the numpy
        # twin must not be judged (or scheduled) by them
        self._costmodel = None
        self._costmodel_status = "demoted"
        self._launch_pred = None
        self._flow_args_cached = None
        self._zero_inject_cached = None
        from ..ops.torcells_device import (RING_DTYPE,
                                           torcells_step_window_numpy_flush)
        f, h = self.n_flows, self.n_nodes
        if self._replay_base is not None:
            # the window-replay guard armed at re-promotion: this is the
            # re-promoted rung failing AGAIN — replay from the stashed
            # probation-exit state plus the log since, then the demotion
            # is permanent (self._repromoted blocks another probation)
            state = tuple(np.asarray(a).copy() for a in self._replay_base[1])
        else:
            state = (np.int64(0), np.zeros(f, dtype=np.int64),
                     np.zeros((self.ring_len, f), dtype=RING_DTYPE),
                     self.capacity_step.copy(),
                     np.zeros(f, dtype=np.int64), np.zeros(f, dtype=np.int64),
                     np.full(f, -1, dtype=np.int64),
                     np.zeros(h, dtype=np.int64))
        args = self._flow_args()        # plain numpy now that mode flipped
        flush = None
        for base, pairs, targets, idle in self._dispatch_log:
            inject = np.zeros(f, dtype=np.int64)
            inject_target = np.zeros(f, dtype=np.int64)
            for circ, cells in pairs:
                inject[self.first_flow[circ]] += cells
                inject_target[self.last_flow[circ]] += cells
            out = torcells_step_window_numpy_flush(
                np.int64(base), *state[1:], inject, inject_target,
                self._pad_targets(targets), np.int64(idle), *args,
                self.ring_len)
            state = out[:8]
            flush = out[9]
        self._state = state
        assert flush is not None, "recovery with an empty dispatch log"
        self._dispatch_log.clear()      # demoted: the log has no future use
        self._replay_base = None
        # arm the probation clock: after --repromote-after
        # clean collects on the twin, consume() re-attempts the device
        # rung once.  A rung that already climbed back stays down for good.
        self._probation_clean = 0
        return flush

    def _repromote(self, engine) -> None:
        """Climb back up the recovery ladder: the numpy
        demotion served its probation, so re-attempt the device rung ONCE
        with the window-replay guard re-armed — the current twin state is
        stashed as the replay base, so a second dispatch failure rebuilds
        from it (base + log replay) and re-demotes permanently.  Single-
        table rung only: a demotion drops the mesh, and a lost shard
        re-enters through the re-shard path, not here."""
        self._replay_base = (int(self._ticks_synced),
                             tuple(np.asarray(a).copy()
                                   for a in self._state))
        self._dispatch_log.clear()
        self.mode = "device"
        self.demoted = False
        self._repromoted = True
        self._flow_args_cached = None
        self._zero_inject_cached = None
        self._state = self._to_device(self._state)
        engine.supervision.count_repromotion("device plane backend",
                                             self._probation_clean)

    def _make_wake_event(self, engine, circuit: int,
                         when: int) -> Optional[Event]:
        """Build (not push) one completion-wake event; consume() lands the
        whole collect's wakes in one push_batch call."""
        if when >= engine.end_time:
            return None
        if self.specs[circuit].auto_start_ns is not None:
            # processless flow: no client will ever join — a wake event
            # would only materialize a quiet table row for nothing
            return None
        waiter = self._waiters.pop(circuit, None)
        host = self.engine.host_by_name(self.specs[circuit].client_name)
        task = Task(_device_wake_task, (self, circuit, waiter), None,
                    name="device_flow_done")
        return Event(task, when, host, host, host.next_event_sequence())

    def _make_wake_item(self, engine, circuit: int, when: int):
        """The _make_wake_event twin for the native continuation plane:
        (when, host, plane, circuit, waiter) for push_device_wakes —
        identical decline rules, the sequence claim deferred to the ONE
        push_cont_batch extension call (same per-host counter, same
        order)."""
        if when >= engine.end_time:
            return None
        if self.specs[circuit].auto_start_ns is not None:
            return None
        waiter = self._waiters.pop(circuit, None)
        host = self.engine.host_by_name(self.specs[circuit].client_name)
        return (when, host, self, circuit, waiter)

    def _stage_autos(self, now_ns: int) -> None:
        """Activate every processless flow whose start time has been
        reached (injections enter at the next dispatch base, like an app
        activation staged last round)."""
        while self._auto_pos < len(self._auto) \
                and self._auto[self._auto_pos][0] <= now_ns:
            _t, circ = self._auto[self._auto_pos]
            self._auto_pos += 1
            self._activate_spec(self.specs[circ])

    def busy(self) -> bool:
        """True while the plane still has work the engine must keep
        windows advancing for (undelivered cells, buffered injections, an
        unconsumed dispatch, or un-started processless flows)."""
        return (bool(self._inject_buf) or self._inflight
                or self._cells_delivered_seen < self._cells_dispatched
                or self._auto_pos < len(self._auto))

    def next_time(self) -> int:
        """The next sim time the plane needs a window at — its dispatch
        cadence point, or the next processless flow's start.  Folded into
        the engine's next-window computation so a quiet Python plane
        cannot strand in-flight device traffic (the plane's flows would
        otherwise only progress while unrelated Python events kept the
        round loop alive)."""
        t = stime.SIM_TIME_MAX
        if self._auto_pos < len(self._auto):
            t = self._auto[self._auto_pos][0]
        if (bool(self._inject_buf) or self._inflight
                or self._cells_delivered_seen < self._cells_dispatched):
            t = min(t, (self._ticks_synced + self.min_dispatch_steps)
                    * self.granule * TICK_NS)
        return t

    def take_node_delta(self, i: int) -> Tuple[int, int]:
        """Consume node ``i``'s pending byte delta as (cells, bytes) —
        shared by the Tracker fold below and the host table's column fold
        (scale/hosttable.py), so both account identically."""
        from ..ops.torcells_device import CELL_WIRE_BYTES
        nbytes = int(self._node_pending[i])
        if not nbytes:
            return 0, 0
        self._node_pending[i] = 0
        return nbytes // CELL_WIRE_BYTES, nbytes

    def pull_tracker_nodes(self, tracker, nodes: List[int]) -> None:
        """Fold a host's pending device-plane byte deltas (accumulated by
        consume()'s single scatter-add) into its Tracker counters: an
        egress node's spend is the host's tx, an ingress (delivering hop)
        node's spend is its rx.  Called from Tracker.pull_device at
        observation points (heartbeat, digest, teardown) only — never on
        the round path."""
        for i in nodes:
            ncells, nbytes = self.take_node_delta(i)
            if not nbytes:
                continue
            c = tracker.out_remote if self.node_kind[i] == "tx" \
                else tracker.in_remote
            c.packets_total += ncells
            c.bytes_total += nbytes
            c.packets_data += ncells
            c.bytes_data += nbytes

    def flush_all_trackers(self) -> None:
        """Teardown sweep: fold every pending node delta so post-run
        readers (tests, digests, tools) see final tracker totals.  Table
        rows fold into the table's columns (or through their materialized
        Host's tracker) via the table's own sweep."""
        for host in dict.fromkeys(h for h in self.node_hosts
                                  if h is not None):
            host.tracker.pull_device()
        if self._table is not None:
            self._table.flush_device_nodes(self)

    def stats(self) -> Dict[str, int]:
        return {
            "circuits": len(self.specs),
            "injected_cells": self.total_injected_cells,
            "forwards": self.total_forwards,
            "completed": len(self._done),
            "dispatches": self.dispatches,
            # ticks the kernel (or the twin) advanced, summed over the
            # dispatches: what the span kernel's time scales with
            "steps": self.steps,
            "idle_rounds_skipped": self.idle_rounds_skipped,
            # superwindow introspection: merged multi-round
            # launches, and how many virtual engine rounds each kernel
            # launch covered on average — the dispatch-amortization number
            # the tor10k host wall is attacked with
            "superwindows": self.superwindows,
            "rounds_per_launch": round(
                self._rounds_launched / max(self.dispatches, 1), 2),
            # delta-compacted flush outcomes: readback bytes
            # the capped encoding saved, and windows that outran the
            # caps (each paid one full-length re-run; persistent
            # overflow reverts the caps entirely)
            "flush_bytes_saved": self.flush_bytes_saved,
            "flush_overflows": self.flush_overflows,
            "mode": self.mode,
            # dispatch-guard outcomes: >0 recoveries means a dispatch
            # failed, the window history replayed on the numpy twin, and
            # the backend was demoted for the rest of the run
            "recoveries": self.recoveries,
            "demoted": self.demoted,
            # recovery-ladder introspection: whether the rung
            # climbed back after its probation (one shot; a repeat fault
            # re-demotes for good)
            "repromoted": self._repromoted,
            # the plane's own wall split:
            # host_sec = advance() dispatch prep + wake bookkeeping;
            # device_sec = blocking materialization of dispatch summaries
            "plane_host_sec": round(self.host_ns / 1e9, 3),
            "plane_device_sec": round(self.device_ns / 1e9, 3),
            # pipeline introspection: host<->device interactions (dispatch +
            # inject upload + flush read; <= 3 per dispatch) and the wall
            # the in-flight dispatch computed behind host round work
            "device_calls": self.device_calls,
            "pipeline_overlap_sec": round(self.pipeline_overlap_ns / 1e9, 3),
            # fraction of device compute hidden behind host round work:
            # overlap / (overlap + blocked collect); 1.0 = the collect
            # never blocked (obs/profiler.py reads the same definition)
            "overlap_efficiency": round(
                self.pipeline_overlap_ns
                / max(self.pipeline_overlap_ns + self.device_ns, 1), 4),
        }


def _device_wake_task(args, _unused) -> None:
    plane, circuit, waiter = args
    if waiter is None:
        waiter = plane._waiters.pop(circuit, None)
    if waiter is None:
        return                       # client not waiting yet; wait() will
    process, thread = waiter         # see _done and return immediately
    if circuit in plane._woken:
        return
    plane._woken.add(circuit)
    thread.wake_value = plane._done[circuit]
    # the wake IS the continue (the fold _thread_wake_task already uses
    # for sleep wakes): this event executes in the client host's context
    # at the wake time — exactly where the continue event it used to
    # schedule would run — so resuming directly saves one scheduler
    # round-trip per completed flow (the batched wake path)
    from ..process.process import BLOCKED, RUNNABLE
    if thread.state == BLOCKED:
        thread.state = RUNNABLE
        thread._unblock_cb = None
        # the wake IS the continue: resume directly; any separately
        # scheduled continue event keeps its own (no-op) delivery and
        # clears the coalescing flag itself
        process.continue_()


def build_plane_from_engine(engine, mode: str = "device"):
    """Scan the engine's processes for device-mode clients (tor circuits
    AND tgen star-bulk flows) plus the host table's processless flow
    configs (scale tier); returns a DeviceTrafficPlane or None if the
    workload has none.  The scan goes through engine.iter_process_specs so
    deferred table rows contribute identical specs to live Hosts."""
    specs = []
    for _hid, host_name, app, args in engine.iter_process_specs():
        spec = None
        if app.endswith("tor"):
            spec = parse_device_client(host_name, args)
        elif app.endswith("tgen"):
            spec = parse_device_tgen(host_name, args)
        if spec is not None:
            specs.append(spec)
    table = getattr(engine, "host_table", None)
    if table is not None and table.flows:
        from ..apps.tor import PAYLOAD_MAX
        for (_row, route_down, route_up, down_bytes, up_bytes,
             start_ns) in table.flows:
            client = route_down[-1]
            s = _FlowSpec(client, list(route_down), list(route_up),
                          max(1, math.ceil(down_bytes / PAYLOAD_MAX)),
                          math.ceil(up_bytes / PAYLOAD_MAX) if up_bytes
                          else 0, dest=route_down[0])
            s.auto_start_ns = int(start_ns)
            specs.append(s)
    if not specs:
        return None
    resolve_auto_routes(engine, specs)
    plane = DeviceTrafficPlane(engine, specs, mode=mode)
    get_logger().message(
        "device-plane",
        f"device traffic plane: {len(specs)} circuits, "
        f"{plane.n_flows} flows, {plane.n_nodes} nodes, "
        f"ring_len={plane.ring_len}, granule={plane.granule} ms, "
        f"mode={mode}")
    return plane
