// mesh_span: one superwindow of the sharded (mesh) traffic plane, all D
// shards in one persistent cooperative launch, for Hopper (sm_90a).
//
// Replaces the JAX package's mesh step shadow_tpu/parallel/mesh/exchange.py
// :247 (make_mesh_span_raw -> shard_body, a shard_map over D devices with
// one all_to_all, or one ppermute per leg, and one psum a tick), the span
// half of make_mesh_span_flush :473.  The plain torch version of the same
// function is shadow_tpu_torch/parallel/mesh/exchange.py:mesh_span_torch;
// the two agree bit for bit.  The flush packing is the mesh entry of
// csrc/pack_flush.cu; this kernel leaves its inputs behind (the entry
// snapshots done_in = done_tick[last_flow_pad] and sent_in = node_sent, and
// the scalars t_stop, forwards, cross).
//
// Layout (the JAX package's global view of the sharded arrays): shard s
// owns flow rows s*pad .. s*pad+pad-1 of every [D*pad] array, node slots
// s*h_pad .. of every [D*h_pad] array, and ring columns s*pad .. of the
// [L, D*pad] int32 ring (P(None, axis)).  Blocks are dealt to shards in
// equal groups; a shard's blocks touch only that shard's rows, node slots
// and ring columns, and its slots of the exchange buffer.  Cross-shard
// cells go only through that buffer, never straight into another shard's
// ring: the shard boundary stays real.
//
// Per tick t, for each shard (the shard-local body of exchange.py:380-435):
//   phase A, every node n of the shard (a thread per node, its flows
//   node_off[n] .. node_off[n+1] walked serially — the segmented cumsum):
//     tokens = min(capacity, tokens + refill); cap_cells = tokens / CELL
//     q = queued[j] + ring[(t - arr_lat[j]) mod L, j]
//     served = clip(cap_cells - before, 0, q); before += q; queued[j] = q-s
//     last stage: delivered += served, done_tick = t on reaching target
//     intra-shard successor: ring[t mod L, succ] = served
//     cross-shard successor: xbuf[slot] = served (its sender slot:
//       a2a_src in fused mode, the leg's send_src in ppermute mode)
//     a column no row of its own shard feeds: set to 0 by its own walker
//   grid sync
//   phase B, every slot the shard receives (a2a_dst / recv_dst):
//     ring[t mod L, col] = xbuf[slot]; cross += that
//   and every thread reads the tick's completion word (the psum of newly)
//   grid sync
// The ring row t mod L is thus set whole, as the JAX ring.at[t].set(v)
// does: every column by exactly one writer (circuits are chains: a row has
// one successor, a column one predecessor), so no atomics.  A masked leg's
// slots are not exchanged (their columns stay 0), as in JAX.  The reads of
// a tick are rows (t - arr_lat) mod L with arr_lat in [1, L) (checked by
// MeshTables), never the row it writes; the second sync orders phase B's
// writes before the next tick's reads.  The psum of [served, newly]: each
// thread keeps its served total (reduced once at the end — the sum is
// exact in any order), and a newly-done chain sets this tick's completion
// word; three words rotate (t mod 3) so thread 0 clears the next one while
// others may still read this one.  The halt is decided on the card at each
// targets boundary, by every thread alike.
//
// Bound.  The single-table span's work (csrc/torcells_span.cu: every flow
// and node once a tick) plus the exchange slots: one 8-byte write and one
// read per cross-shard edge a tick.  On one card the D shards buy no
// parallelism the single-table kernel lacks and add a grid sync a tick.

#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_TARGETS = 64;
constexpr int THREADS = 256;
// 512 B cell + the TCP/IP/Ethernet header (core/defs.py)
constexpr int64_t CELL_WIRE_BYTES = 512 + 66;

struct MeshParams {
  // carried state (global padded layout), updated in place
  int64_t* queued;       // [D*pad]
  int32_t* ring;         // [L, D*pad]
  int64_t* tokens;       // [D*h_pad]
  int64_t* delivered;    // [D*pad]
  int64_t* target;       // [D*pad]
  int64_t* done_tick;    // [D*pad]
  int64_t* node_sent;    // [D*h_pad]
  // this dispatch's injections
  const int64_t* inject;         // [D*pad]
  const int64_t* inject_target;  // [D*pad]
  // static tables (MeshTables)
  const int64_t* node_off;   // [D*(h_pad+1)] local row offsets
  const int64_t* arr_lat;    // [D*pad]
  const int64_t* succ;       // [D*pad] global successor row, -1 = last
  const int64_t* send_to;    // [D*pad] -1 last, <D*pad column, else slot
  const uint8_t* zero_col;   // [D*pad]
  const int64_t* refill;     // [D*h_pad]
  const int64_t* capacity;   // [D*h_pad]
  const int64_t* recv_off;   // [D+1]
  const int64_t* recv_slot;  // [R]
  const int64_t* recv_col;   // [R]
  const int64_t* last_flow;  // [C] padded rows of the chains' last stages
  // outputs: scalars [0] t_stop, [1] forwards, [2] cross, [3..5] the
  // per-tick completion words; the flush's entry snapshots
  int64_t* scalars;
  int64_t* done_in;   // [C]
  int64_t* sent_in;   // [D*h_pad]
  int64_t* xbuf;      // [X] the exchange buffer
  int64_t d, pad, h_pad, c, ring_len, t0, idle_ticks, xbuf_len;
  int n_targets;
  int64_t targets[MAX_TARGETS];
};

__device__ __forceinline__ int64_t floor_mod(int64_t x, int64_t m) {
  const int64_t r = x % m;
  return r < 0 ? r + m : r;
}

__device__ __forceinline__ int64_t block_sum(int64_t v) {
  __shared__ int64_t warp_part[THREADS / 32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_part[warp] = v;
  __syncthreads();
  v = 0;
  if (warp == 0) {
    v = lane < THREADS / 32 ? warp_part[lane] : 0;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;  // valid in thread 0
}

__global__ void __launch_bounds__(THREADS)
mesh_span_kernel(const MeshParams p) {
  cg::grid_group grid = cg::this_grid();
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t nthreads = (int64_t)gridDim.x * blockDim.x;
  // this block's shard, and the thread's place among the shard's threads
  const int64_t per_shard = gridDim.x / p.d;
  const int64_t shard = blockIdx.x / per_shard;
  const int64_t stid = (blockIdx.x % per_shard) * blockDim.x + threadIdx.x;
  const int64_t sthreads = per_shard * blockDim.x;
  const int64_t fp = p.d * p.pad, L = p.ring_len;
  const int64_t row0 = shard * p.pad, node0 = shard * p.h_pad;
  const int64_t* off = p.node_off + shard * (p.h_pad + 1);

  // -- entry folds on the shard's own slice: injections, the idle-tick
  //    refill, the ring clear, the flush's snapshot of node_sent
  for (int64_t j = row0 + stid; j < row0 + p.pad; j += sthreads) {
    p.queued[j] += p.inject[j];
    p.target[j] += p.inject_target[j];
  }
  for (int64_t n = node0 + stid; n < node0 + p.h_pad; n += sthreads) {
    const int64_t tk = p.tokens[n] + p.refill[n] * p.idle_ticks;
    p.tokens[n] = tk < p.capacity[n] ? tk : p.capacity[n];
    p.sent_in[n] = p.node_sent[n];
  }
  if (p.idle_ticks > 0)
    for (int64_t k = stid; k < L * p.pad; k += sthreads)
      p.ring[(k / p.pad) * fp + row0 + k % p.pad] = 0;
  // global snapshots: the chains' entry done_tick, the exchange buffer
  for (int64_t c = tid; c < p.c; c += nthreads)
    p.done_in[c] = p.done_tick[p.last_flow[c]];
  for (int64_t k = tid; k < p.xbuf_len; k += nthreads) p.xbuf[k] = 0;
  if (tid == 0)
    for (int k = 0; k < 6; ++k) p.scalars[k] = 0;
  grid.sync();

  // -- the tick loop; every thread runs the same iterations
  int64_t t = p.t0;
  const int64_t end = p.targets[p.n_targets - 1];
  int idx = 0;
  bool span_done = false, halt = false;
  int64_t forwards = 0, cross = 0;
  const int64_t r0 = p.recv_off[shard], r1 = p.recv_off[shard + 1];
  while (t < end && !halt) {
    const int64_t k3 = (t - p.t0) % 3;
    if (tid == 0) p.scalars[3 + (k3 + 1) % 3] = 0;
    const int64_t row = floor_mod(t, L) * fp;
    bool any_new = false;
    // phase A: the shard's nodes
    for (int64_t n = stid; n < p.h_pad; n += sthreads) {
      const int64_t g = node0 + n;
      const int64_t cap = p.capacity[g];
      int64_t tok = p.tokens[g] + p.refill[g];
      tok = tok < cap ? tok : cap;
      const int64_t cap_cells = tok / CELL_WIRE_BYTES;
      int64_t before = 0, spent = 0;
      const int64_t j1 = row0 + off[n + 1];
      for (int64_t j = row0 + off[n]; j < j1; ++j) {
        const int64_t al = p.arr_lat[j];
        const int64_t q =
            p.queued[j] + (int64_t)p.ring[floor_mod(t - al, L) * fp + j];
        int64_t s = cap_cells - before;
        s = s < 0 ? 0 : (s > q ? q : s);
        before += q;
        p.queued[j] = q - s;
        spent += s;
        if (p.zero_col[j]) p.ring[row + j] = 0;
        const int64_t to = p.send_to[j];
        if (p.succ[j] < 0) {
          const int64_t dv = p.delivered[j] + s;
          p.delivered[j] = dv;
          const int64_t tg = p.target[j];
          if (tg > 0 && p.done_tick[j] < 0 && dv >= tg) {
            p.done_tick[j] = t;
            any_new = true;
          }
        } else if (to >= fp) {
          p.xbuf[to - fp] = s;          // a cross-shard forward: its slot
        } else if (to >= 0) {
          p.ring[row + to] = (int32_t)s;  // an intra-shard forward
        }                                 // -2: a leg not exchanged
      }
      p.tokens[g] = tok - spent * CELL_WIRE_BYTES;
      p.node_sent[g] += spent * CELL_WIRE_BYTES;
      forwards += spent;
    }
    if (any_new) p.scalars[3 + k3] = 1;
    grid.sync();
    // phase B: the slots the shard receives, into its own ring columns
    for (int64_t k = r0 + stid; k < r1; k += sthreads) {
      const int64_t v = p.xbuf[p.recv_slot[k]];
      p.ring[row + p.recv_col[k]] = (int32_t)v;
      cross += v;
    }
    const bool any = *(volatile int64_t*)&p.scalars[3 + k3] != 0;
    span_done = span_done || any;
    const bool boundary =
        (t + 1) == p.targets[idx < p.n_targets - 1 ? idx : p.n_targets - 1];
    halt = boundary && span_done;
    if (boundary) {
      ++idx;
      span_done = false;
    }
    ++t;
    grid.sync();
  }

  forwards = block_sum(forwards);
  __syncthreads();
  cross = block_sum(cross);
  if (threadIdx.x == 0) {
    atomicAdd((unsigned long long*)&p.scalars[1], (unsigned long long)forwards);
    atomicAdd((unsigned long long*)&p.scalars[2], (unsigned long long)cross);
    if (blockIdx.x == 0) p.scalars[0] = t;
  }
}

}  // namespace

// Launch on `stream` (a cudaStream_t passed as a pointer).  Does not
// synchronise.  Returns 0 when the launch was accepted, else the CUDA error.
extern "C" int mesh_span_launch(
    void* queued, void* ring, void* tokens, void* delivered, void* target,
    void* done_tick, void* node_sent, const void* inject,
    const void* inject_target, const void* node_off, const void* arr_lat,
    const void* succ, const void* send_to, const void* zero_col,
    const void* refill, const void* capacity, const void* recv_off,
    const void* recv_slot, const void* recv_col, const void* last_flow,
    void* scalars, void* done_in, void* sent_in, void* xbuf, int64_t d,
    int64_t pad, int64_t h_pad, int64_t c, int64_t ring_len, int64_t t0,
    int64_t idle_ticks, int64_t xbuf_len, int n_targets,
    const int64_t* targets, void* stream) {
  if (n_targets < 1 || n_targets > MAX_TARGETS || ring_len < 1 || d < 1 ||
      pad < 1 || h_pad < 1)
    return (int)cudaErrorInvalidValue;
  MeshParams p;
  p.queued = (int64_t*)queued;
  p.ring = (int32_t*)ring;
  p.tokens = (int64_t*)tokens;
  p.delivered = (int64_t*)delivered;
  p.target = (int64_t*)target;
  p.done_tick = (int64_t*)done_tick;
  p.node_sent = (int64_t*)node_sent;
  p.inject = (const int64_t*)inject;
  p.inject_target = (const int64_t*)inject_target;
  p.node_off = (const int64_t*)node_off;
  p.arr_lat = (const int64_t*)arr_lat;
  p.succ = (const int64_t*)succ;
  p.send_to = (const int64_t*)send_to;
  p.zero_col = (const uint8_t*)zero_col;
  p.refill = (const int64_t*)refill;
  p.capacity = (const int64_t*)capacity;
  p.recv_off = (const int64_t*)recv_off;
  p.recv_slot = (const int64_t*)recv_slot;
  p.recv_col = (const int64_t*)recv_col;
  p.last_flow = (const int64_t*)last_flow;
  p.scalars = (int64_t*)scalars;
  p.done_in = (int64_t*)done_in;
  p.sent_in = (int64_t*)sent_in;
  p.xbuf = (int64_t*)xbuf;
  p.d = d;
  p.pad = pad;
  p.h_pad = h_pad;
  p.c = c;
  p.ring_len = ring_len;
  p.t0 = t0;
  p.idle_ticks = idle_ticks;
  p.xbuf_len = xbuf_len;
  p.n_targets = n_targets;
  for (int i = 0; i < MAX_TARGETS; ++i)
    p.targets[i] = targets[i < n_targets ? i : n_targets - 1];

  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, mesh_span_kernel, THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  // the same number of blocks for every shard: enough for one node per
  // thread, but never more than can all be resident at once (a
  // cooperative launch needs every block resident)
  const int64_t cap = (int64_t)per_sm * sms;
  int64_t per_shard = (h_pad + THREADS - 1) / THREADS;
  if (per_shard * d > cap) per_shard = cap / d;
  if (per_shard < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel((const void*)mesh_span_kernel,
                                    dim3((unsigned)(per_shard * d)),
                                    dim3(THREADS), args, 0,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
