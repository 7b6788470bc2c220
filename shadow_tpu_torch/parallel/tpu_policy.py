"""The ``tpu`` scheduler policy: per-host event queues + device-batched hops.

This is the seventh scheduler policy (SURVEY.md §2.2; the reference's six
live in core/scheduler.py).  Event storage and popping are identical to the
``host`` policy; what changes is the inter-host packet hop
(worker.c:243-304): instead of a per-packet reliability draw + latency
lookup on the CPU, packets sent during a round are appended to a batch, and
at the round barrier ONE kernel launch (ops/round_step.py, the CUDA kernel
ops/csrc/packet_hop.cu) computes every drop decision and delivery time at
once.  CPU<->device exchange happens
only at round boundaries — the conservative lookahead window guarantees no
intra-round causality violation, the same argument the reference's
host-steal policy uses for its cross-host barrier clamp
(scheduler_policy_host_steal.c:229-242).

Capture is one tuple append per packet (row indices come from the per-host
cached topology row, so there is no per-packet dict lookup); flush_round
unzips the rows into numpy columns, packs them into ONE [1+B, 3] int64
device upload (header row = batch count + barrier, so no per-call scalar
transfers), and LAUNCHES the kernel without waiting for it.  The engine
consumes the results at the top of the next loop iteration — always before
the next window is computed, so causality and determinism are exact — which
overlaps device compute with the barrier bookkeeping and hides the
device round trip behind host-side work.

Parity: drops are keyed by packet uid through the same threefry cipher the
CPU policies use, so a simulation under ``tpu`` delivers/drops exactly the
same packets at exactly the same times as under ``global``/``steal``
(asserted by tests/test_torch_tpu_policy*.py, which also hold the port to
the JAX package's ``tpu`` runs).

With ``--tpu-devices N`` (N > 1) the hop runs sharded over a mesh of N
shards on the one device (ops/round_step.ShardedPacketHopKernel: the batch
split into N slices, or with ``--tpu-shard-matrix`` the path matrices split
into N row slices), bit-identical to the unsharded hop.
"""

from __future__ import annotations

import threading
import time as _walltime
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..core.scheduler import GlobalSinglePolicy, HostQueuesPolicy
from ..core.event import Event
from ..core.task import Task
from ..core.logger import get_logger
from ..core.worker import _deliver_packet_task
from ..device import resolve_device


def _hop_source(device):
    """The hop's scrape: the device its kernel runs on and the hop kernel
    launches this process made (a ``--processes`` shard's scrape rides its
    final message to the parent's metrics summary)."""
    def scrape():
        from ..ops import round_step as rs
        return {"hop.device": str(device),
                "hop.launches": rs.packet_hop_mapped.launches
                + rs.packet_hop_packed.launches
                + rs.packet_hop_sharded.launches}
    return scrape


@dataclass(eq=False)
class HopLaunch:
    """One launch of the hop kernel as ``Options.hop_record`` keeps it:
    its lanes' source and destination rows, uids and send times and the
    round's barrier, then the delivery times and keep flags once
    ``consume_flush`` has waited on it (None until then)."""
    src: np.ndarray
    dst: np.ndarray
    uid: np.ndarray
    send: np.ndarray
    barrier: int
    deliver: Optional[np.ndarray] = None
    keep: Optional[np.ndarray] = None


class _TPUBatchMixin:
    """The device-batching behavior (offer/launch/consume/warmup), layered
    over an event-storage policy.  Two concrete layouts:

    * TPUSerialPolicy — over the single global queue (workers == 0).  The
      per-host-queue layout costs a min-scan across every host's queue per
      pop where the global queue pops once, and batching never needed it.
    * TPUPolicy — over the per-host locked queues (threaded runs, where
      per-host ownership is what makes parallel pops safe).
    """

    def _init_batch(self):
        self._batch_lock = threading.Lock()
        # pending batch: one row tuple per offered packet (pkt, src_host,
        # dst_host, seq, src_row, dst_row, uid, time); a single append per
        # offer keeps the capture hot path minimal — the flush unzips into
        # SoA columns with one zip(*) pass
        self._p_rows: List[Tuple] = []
        self._kernel = None
        self.packets_batched = 0
        self.packets_dropped = 0
        # launched-but-unconsumed chunks: (pkts, src_hosts, dst_hosts, seqs,
        # src_rows, dst_rows, handle, barrier, the chunk's HopLaunch or
        # None) where the handle's results
        # may still be computing on the device.  consume_flush materializes
        # them at the NEXT round boundary, so device compute overlaps host
        # round work.
        self._pending: List[Tuple] = []
        # mid-round chunk size: once this many offers accumulate, a chunk is
        # launched immediately so the device works while the round is still
        # executing (0 = launch only at the barrier; None = read the option
        # on first offer — lazily, because the engine isn't known yet)
        self._chunk: Optional[int] = None
        # serializes _launch (worker threads may chunk-launch concurrently;
        # distinct from _batch_lock, which _drain_batch takes)
        self._launch_lock = threading.Lock()
        self._sync = False          # --processes shards need same-round results
        # per-round introspection (read by the engine heartbeat)
        self.last_batch = 0
        self.device_ns = 0          # cumulative wall ns blocked on the device
        self.host_flush_ns = 0      # cumulative wall ns in flush outside step
        self.lanes_hopped = 0       # packets the hop kernel was launched on
        # Options.hop_record: a HopLaunch a kernel launch; None while the
        # option is off
        self.hop_record: Optional[List[HopLaunch]] = None

    @property
    def kernel_calls(self) -> int:
        """Launches of the hop kernel on the device so far."""
        return self._kernel.device_calls if self._kernel is not None else 0

    # -- worker-facing batching -------------------------------------------
    def offer_packet(self, packet, worker) -> bool:
        """Append a packet hop to the round batch (called from
        Worker.send_packet in place of the scalar CPU path).  The source-host
        event sequence id is claimed NOW so the deterministic order tuple
        (time, dst, src, seq) reflects send order, as on the CPU path."""
        engine = worker.engine
        dst_host = engine.host_by_ip(packet.dst_ip)
        if dst_host is None:
            packet.add_status("INET_DROPPED")
            return True
        src_host = worker.active_host
        seq_owner = src_host if src_host is not None else dst_host
        seq = seq_owner.next_event_sequence()
        row = (packet, src_host, dst_host, seq,
               src_host.topo_row if src_host is not None
               else dst_host.topo_row,
               dst_host.topo_row, packet.uid, worker.now)
        if self.serial:
            # workers == 0: the lock is pure overhead on the hottest
            # capture path (the CPU-time gate's margin lives here)
            self._p_rows.append(row)
            n = len(self._p_rows)
        else:
            with self._batch_lock:
                self._p_rows.append(row)
                n = len(self._p_rows)
        self.packets_batched += 1
        if self._chunk is None:
            self._chunk = getattr(engine.options, "tpu_chunk", 0)
        if self._chunk and n >= self._chunk:
            # mid-round launch: ship the accumulated chunk now so the device
            # computes while the host executes the rest of the round
            self._launch(engine, self._drain_batch())
        return True

    def _drain_batch(self) -> Optional[Tuple]:
        with self._batch_lock:
            if not self._p_rows:
                return None
            rows = self._p_rows
            self._p_rows = []
        return tuple(zip(*rows))

    # -- round-boundary flush ---------------------------------------------
    def _ensure_kernel(self, engine):
        if self._kernel is None:
            from ..ops.round_step import (PacketHopKernel,
                                          ShardedPacketHopKernel)
            topo = engine.topology
            opts = engine.options
            n_dev = getattr(opts, "tpu_devices", 0)
            device = resolve_device(getattr(opts, "device", "cuda"))
            cards = getattr(opts, "mesh_cards", None)
            if n_dev == 0:
                # 0 = all local devices, as in the JAX package: every card
                # of the host (the cards given, on the CPU one device)
                import torch
                n_dev = len(cards) if cards else (
                    torch.cuda.device_count() if device.type == "cuda"
                    else 1)
                get_logger().message(
                    "tpu", f"--tpu-devices 0: the packet hop on {n_dev} "
                    f"device{'s' if n_dev > 1 else ''}")
            threshold = getattr(opts, "tpu_device_threshold", 0)
            if n_dev > 1:
                # the round batch (or, with --tpu-shard-matrix, the path
                # matrices) sharded over a mesh of n_dev shards, over the
                # host's cards (parallel/mesh device_mesh)
                self._kernel = ShardedPacketHopKernel(
                    topo, engine._drop_key, engine.bootstrap_end, n_dev,
                    shard_matrix=getattr(opts, "tpu_shard_matrix", False),
                    device=device, device_threshold=threshold, cards=cards)
            else:
                self._kernel = PacketHopKernel(
                    topo, engine._drop_key, engine.bootstrap_end, device,
                    device_threshold=threshold)
            if threshold > 0:
                # the bypass the user asked for by name, said once a run;
                # the scrape's policy.host_calls and policy.device_calls
                # count its batches
                get_logger().message(
                    "tpu", f"--tpu-device-threshold {threshold}: hop batches "
                    f"of fewer than {threshold} packets go through the "
                    f"host's numpy hop, the rest through the kernel on "
                    f"{device}")
            engine.metrics.source("hop", _hop_source(device))
            if self._chunk is None:
                self._chunk = getattr(opts, "tpu_chunk", 0)
            # --processes shards hand cross-shard hops to their owner at the
            # SAME round's barrier (procs.py outbox drain), so they cannot
            # defer materialization; checkpointing snapshots round state, so
            # it needs everything pushed too (the engine consumes before
            # writing regardless — this just keeps flush's return count
            # meaningful there).
            self._sync = engine.shard_count > 1
            if getattr(opts, "hop_record", False):
                self.hop_record = []
        return self._kernel

    def _launch(self, engine, cols) -> None:
        """Dispatch one chunk's device step asynchronously and queue it for
        consume_flush.  (pkts, ..., times) columns -> pending tuple.
        Serialized: worker threads may chunk-launch concurrently and the
        kernel/perf counters are shared state."""
        if cols is None:
            return
        with self._launch_lock:
            self._launch_locked(engine, cols)

    def _launch_locked(self, engine, cols) -> None:
        t0 = _walltime.perf_counter_ns()
        (pkts, src_hosts, dst_hosts, seqs, src_rows, dst_rows,
         uids, times) = cols
        n = len(pkts)
        self.last_batch = n
        self.lanes_hopped += n
        with engine.tracer.span("hop.launch", "tpu", args={"lanes": n}):
            kernel = self._ensure_kernel(engine)
            src_arr = np.array(src_rows, dtype=np.int32)
            dst_arr = np.array(dst_rows, dtype=np.int32)
            uid_arr = np.array(uids, dtype=np.uint64)
            time_arr = np.array(times, dtype=np.int64)
            barrier = engine.scheduler.window_end
            record = self.hop_record
            # --tpu-max-inflight bounds one device step's padded batch (HBM
            # safety valve for enormous rounds); lanes are independent, so
            # chunked steps are exact
            cap = max(1, getattr(engine.options, "tpu_max_inflight", 0) or n)
            for i in range(0, n, cap):
                j = min(i + cap, n)
                handle = kernel.launch(src_arr[i:j], dst_arr[i:j],
                                       uid_arr[i:j], time_arr[i:j], barrier)
                entry = None
                if record is not None:
                    entry = HopLaunch(src_arr[i:j], dst_arr[i:j],
                                      uid_arr[i:j], time_arr[i:j], barrier)
                    record.append(entry)
                self._pending.append((pkts[i:j], src_hosts[i:j],
                                      dst_hosts[i:j], seqs[i:j],
                                      src_arr[i:j], dst_arr[i:j], handle,
                                      barrier, entry))
        self.host_flush_ns += _walltime.perf_counter_ns() - t0

    def warmup(self, engine, max_batch: int = 8192) -> None:
        """Build and load the hop kernel's library and launch it once per
        bucket size up to ``max_batch``.  The CUDA kernel compiles nothing
        per shape (one nvcc build serves every batch size); the launches
        allocate each bucket's pinned buffers and the device's first-use
        state, so benches and long runs keep that out of the measured
        loop.  A bucket that lies wholly below --tpu-device-threshold never
        reaches the card and is skipped, as in the JAX package."""
        from ..ops.round_step import MIN_BUCKET, bucket_size
        kernel = self._ensure_kernel(engine)
        if kernel.DEVICE_THRESHOLD and max_batch < kernel.DEVICE_THRESHOLD:
            return
        b = MIN_BUCKET
        while b <= bucket_size(max_batch):
            # the smallest batch of bucket b that clears the bypass
            n = max(b // 2 + 1, kernel.DEVICE_THRESHOLD)
            if n > b:
                b <<= 1
                continue
            dummy_rows = np.zeros(n, dtype=np.int32)
            kernel.launch(dummy_rows, dummy_rows,
                          np.zeros(n, dtype=np.uint64),
                          np.zeros(n, dtype=np.int64), 0).wait()
            b <<= 1
        kernel.device_calls = 0
        kernel.host_calls = 0
        kernel.buckets_seen.clear()

    def flush_round(self, engine) -> int:
        """Launch the device step for the round's remaining batch.  Called by
        the engine once per round after workers drain.  In async mode (the
        default) the results are NOT materialized here — the engine calls
        consume_flush at the top of the next iteration, before the next
        window is computed, so the device works through the barrier
        bookkeeping.  Sharded runs consume immediately (same-round outbox
        contract).

        Quiet rounds (no offers — every superwindow-merged span, and most
        rounds of a device-plane run whose traffic lives in HBM) return
        after the one empty-batch check: the kernel is built lazily by the
        first real launch (_launch_locked), and consume_flush with nothing
        pending is the _sync path's own no-op."""
        cols = self._drain_batch()
        if cols is None:
            self.last_batch = 0
        else:
            self._launch(engine, cols)
        if self._sync:
            return self.consume_flush(engine) or (cols is not None)
        # truthy iff a launch happened: the engine's quiet-round
        # dirty-tracking counts rounds whose flush did nothing
        return cols is not None

    def consume_flush(self, engine) -> int:
        """Materialize every launched chunk and push the surviving delivery
        events.  MUST run before the engine computes the next window (the
        engine loop guarantees it); the time blocked here is the exposed
        device wait the async split is minimizing."""
        if not self._pending:
            return 0
        t0 = _walltime.perf_counter_ns()
        pending = self._pending
        self._pending = []
        topo = engine.topology
        delivered = 0
        dropped = 0
        end_time = engine.end_time
        count_drop = engine.count_packet_drop
        push = super().push
        counters = engine.counters
        sharded = engine.shard_count > 1
        owns = engine.owns_host
        outboxes = engine.shard_outboxes
        shard_of = engine.shard_of
        tracer = engine.tracer
        t_dev = 0
        with tracer.span("hop.consume", "tpu"):
            for (pkts, src_hosts, dst_hosts, seqs, src_arr, dst_arr,
                 handle, barrier, entry) in pending:
                td0 = _walltime.perf_counter_ns()
                # blocks iff the device isn't done; exact-length host arrays
                with tracer.span("hop.wait", "tpu"):
                    deliver, keep = handle.wait()
                t_dev += _walltime.perf_counter_ns() - td0
                if entry is not None:
                    entry.deliver = deliver
                    entry.keep = keep
                # per-path packet accounting for the kept lanes, vectorized
                # (the CPU latency lookup path counts per call)
                np.add.at(topo.path_packet_counts,
                          (src_arr[keep], dst_arr[keep]), 1)
                deliver_list = deliver.tolist()
                keep_list = keep.tolist()
                for i in range(len(pkts)):
                    pkt = pkts[i]
                    if not keep_list[i]:
                        pkt.add_status("INET_DROPPED")
                        count_drop(pkt)
                        dropped += 1
                        continue
                    t = deliver_list[i]
                    if t >= end_time:
                        continue
                    pkt.add_status("INET_SENT")
                    dst = dst_hosts[i]
                    if sharded and not owns(dst):
                        # --processes: hand the finished hop to the owner
                        # shard (the seq was claimed at offer time, so the
                        # event tuple matches)
                        outboxes[shard_of(dst)].append(
                            (t, dst.id, src_hosts[i].id, seqs[i],
                             pkt.to_wire()))
                        delivered += 1
                        continue
                    task = Task(_deliver_packet_task, dst, pkt,
                                name="deliver_packet")
                    ev = Event(task, t, dst, src_hosts[i], seqs[i])
                    push(ev, 0, barrier)
                    delivered += 1
        counters.count_new("event", delivered)
        self.packets_dropped += dropped
        t1 = _walltime.perf_counter_ns()
        self.device_ns += t_dev
        self.host_flush_ns += (t1 - t0) - t_dev
        return delivered

    def pending_count(self) -> int:
        return (super().pending_count() + len(self._p_rows)
                + sum(len(p[0]) for p in self._pending))

    def next_time(self) -> int:
        # Unlaunched offers or unconsumed chunks here would mean the engine
        # computed a window while deliveries were still in flight; the loop
        # contract (consume_flush -> next_time -> run -> flush_round) makes
        # that impossible — assert it.
        assert not self._p_rows and not self._pending, \
            "consume_flush must run before next_time"
        return super().next_time()


class TPUSerialPolicy(_TPUBatchMixin, GlobalSinglePolicy):
    """tpu policy over the single global event queue (workers == 0)."""

    def __init__(self):
        GlobalSinglePolicy.__init__(self)
        self._init_batch()


class TPUPolicy(_TPUBatchMixin, HostQueuesPolicy):
    """tpu policy over per-host locked queues (threaded runs)."""

    def __init__(self):
        HostQueuesPolicy.__init__(self)
        self._init_batch()
