// torcells_span: one superwindow of the device traffic plane, the whole tick
// loop in one persistent cooperative launch, a thread per flow, for Hopper
// (sm_90a).
//
// Replaces the JAX package's span step shadow_tpu/ops/torcells_device.py:428
// (_step_span_impl, run through _step_span_flush_impl :512 and jitted as
// torcells_step_window_flush / _nodonate / _capped at :546-561).  The plain
// torch version of the same function is
// shadow_tpu_torch/ops/torcells_device.py:torcells_step_span_torch; the two
// agree bit for bit (int64 throughout, the ring int32).  The flush packing
// is the separate kernel csrc/pack_flush.cu; this kernel leaves its inputs
// (newly-done chains, their completion steps, per-node byte deltas, the
// delivered sum) behind.
//
// The model.  F flows, sorted by paced node; node n paces flows
// node_off[n] .. node_off[n+1], which form one seg_start segment.  Per tick
// t every node refills its bucket and serves its flows greedily in order
// (the JAX package's segmented cumsum), a served cell arrives at the
// successor flow after the edge latency through the int32 [L, F] ring, and
// the ring row t mod L is set whole (a column no flow feeds gets 0): the
// tick body is span_tile.cuh's, which states it in full.  At each boundary
// targets[idx] the loop halts iff a chain completed in the span just ended;
// otherwise the next span starts clean.
//
// Design.  The halt depends on the data, and the host must not sync per
// tick, so the loop lives on the card: a cooperative launch, sized by the
// occupancy API to every block that can be resident (never more blocks than
// tiles), ONE grid sync per tick.  The flow table is cut, once per table on
// the host, into tiles of whole nodes (~256 flows each); blocks take tiles
// grid-strided, the same tiles every tick, and a tile's flows are a thread
// each: a block-wide segmented scan gives each flow the cells queued ahead
// of it in its node, where the earlier kernel gave each node one thread that
// walked its flows one after another (a tick lasted the longest node's walk,
// 37 flows at tor10k, 116 on a sweep lane, each step a chain of dependent
// memory round trips).  The successor scatter is conflict-free (flow_succ
// is injective) and every arrival latency is in [1, L) (checked by the
// wrapper, SpanTables), so a tick needs no sync inside it.  The tick's "any
// chain newly done" flag is a device word; three of them rotate so thread
// 0 can clear the next tick's flag while others still read this one.  t,
// the boundary index, span_done and the halt are replicated in every
// thread's registers and evolve identically from what each reads after the
// sync.  The superwindow boundaries come in by value in the parameter block
// (at most MAX_TARGETS).
//
// Bound.  Per tick the work touches every flow once (~12 int64 operations,
// a ring gather and scatter) and every node once: about 3.4 M 32-bit
// operations at tor10k width (F = 100,000, H = 30,494), against ~13 MB of
// state that stays in the 50 MB L2.  A tick is each block's tiles one
// after another, each a wave of loads once the flows' meta words are in,
// two block scans and the stores, then the grid sync: that latency chain
// bounds it, not the bytes or the operations.  At tor10k the 391 tiles
// fall on 264 blocks (two an SM at 112 registers), ~7 us a tick on an
// H100 (PERF.md section 6, row 3).

#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "span_tile.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_TARGETS = 64;
constexpr int THREADS = span::THREADS;

struct SpanParams {
  // carried state, updated in place
  int64_t* queued;       // [F]
  int32_t* ring;         // [L, F]
  int64_t* tokens;       // [H]
  int64_t* delivered;    // [F]
  int64_t* target;       // [F]
  int64_t* done_tick;    // [F]
  int64_t* node_sent;    // [H]
  // this dispatch's injections
  const int64_t* inject;         // [F]
  const int64_t* inject_target;  // [F]
  // static tables (SpanTables)
  const int4* meta;          // [F]: node, succ, arrival latency, flags
  const int4* tiles;         // [T + 1]: first node, first flow, empty nodes
  const int64_t* node_off;   // [H + 1]
  const int64_t* refill;     // [H]
  const int64_t* capacity;   // [H]
  const int64_t* last_flow;  // [C]
  // outputs: scalars [0] t_stop, [1] forwards, [2] delivered sum,
  // [3..5] per-tick completion flags; then the flush inputs
  int64_t* scalars;
  uint8_t* newly;        // [C] bool
  int64_t* done_last;    // [C] (holds the entry snapshot during the loop)
  int64_t* sent_delta;   // [H] (holds the entry snapshot during the loop)
  int64_t f, h, c, n_tiles, ring_len, t0, idle_ticks;
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
torcells_span_kernel(const SpanParams p) {
  cg::grid_group grid = cg::this_grid();
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t nthreads = (int64_t)gridDim.x * blockDim.x;
  const int64_t f = p.f, L = p.ring_len;

  // -- entry folds: injections, the idle-tick refill, the ring clear, and
  //    the flush's snapshots of done_tick[last_flow] and node_sent
  for (int64_t j = tid; j < f; j += nthreads) {
    p.queued[j] += p.inject[j];
    p.target[j] += p.inject_target[j];
  }
  for (int64_t n = tid; n < p.h; n += nthreads) {
    const int64_t tk = p.tokens[n] + p.refill[n] * p.idle_ticks;
    p.tokens[n] = tk < p.capacity[n] ? tk : p.capacity[n];
    p.sent_delta[n] = p.node_sent[n];
  }
  for (int64_t c = tid; c < p.c; c += nthreads)
    p.done_last[c] = p.done_tick[p.last_flow[c]];
  if (p.idle_ticks > 0)
    for (int64_t k = tid; k < L * f; k += nthreads) p.ring[k] = 0;
  if (tid == 0)
    for (int k = 0; k < 6; ++k) p.scalars[k] = 0;
  grid.sync();

  // -- the tick loop; every thread runs the same iterations
  __shared__ span::Shared sh;
  const span::Table tb{p.queued,   p.ring,      p.tokens,    p.delivered,
                       p.target,   p.done_tick, p.node_sent, p.meta,
                       p.tiles,    p.node_off,  p.refill,    p.capacity,
                       f,          p.h,         p.n_tiles,   (int)L};
  int64_t t = p.t0;
  int row_t = (int)floor_mod(t, L), k3 = 0;
  const int64_t end = p.targets[p.n_targets - 1];
  int idx = 0;
  bool span_done = false, halt = false;
  int64_t forwards = 0;
  while (t < end && !halt) {
    if (tid == 0) p.scalars[3 + (k3 + 1) % 3] = 0;
    bool any_new = false;
    for (int64_t ti = blockIdx.x; ti < p.n_tiles; ti += gridDim.x)
      span::span_tile(tb, 0, (int)ti, t, row_t, &forwards, &any_new, sh);
    if (any_new) p.scalars[3 + k3] = 1;
    grid.sync();
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
    if (++row_t == L) row_t = 0;
    if (++k3 == 3) k3 = 0;
  }

  // -- epilogue: the flush kernel's inputs (each thread finishes the
  //    snapshot entries it took at entry, so no sync is needed)
  int64_t dsum = 0;
  for (int64_t c = tid; c < p.c; c += nthreads) {
    const int64_t lf = p.last_flow[c];
    const int64_t dl = p.done_tick[lf];
    p.newly[c] = (dl >= 0 && p.done_last[c] < 0) ? 1 : 0;
    p.done_last[c] = dl;
    dsum += p.delivered[lf];
  }
  for (int64_t n = tid; n < p.h; n += nthreads)
    p.sent_delta[n] = p.node_sent[n] - p.sent_delta[n];
  forwards = block_sum(forwards);
  __syncthreads();
  dsum = block_sum(dsum);
  if (threadIdx.x == 0) {
    atomicAdd((unsigned long long*)&p.scalars[1], (unsigned long long)forwards);
    atomicAdd((unsigned long long*)&p.scalars[2], (unsigned long long)dsum);
    if (blockIdx.x == 0) p.scalars[0] = t;
  }
}

}  // namespace

// Launch on `stream` (a cudaStream_t passed as a pointer).  Does not
// synchronise.  Returns 0 when the launch was accepted, else the CUDA error.
extern "C" int torcells_span_launch(
    void* queued, void* ring, void* tokens, void* delivered, void* target,
    void* done_tick, void* node_sent, const void* inject,
    const void* inject_target, const void* meta, const void* tiles,
    const void* node_off, const void* refill, const void* capacity,
    const void* last_flow, void* scalars, void* newly, void* done_last,
    void* sent_delta, int64_t f, int64_t h, int64_t c, int64_t n_tiles,
    int64_t ring_len, int64_t t0, int64_t idle_ticks, int n_targets,
    const int64_t* targets, void* stream) {
  // the tile body indexes the ring and the tables with 32-bit offsets
  if (n_targets < 1 || n_targets > MAX_TARGETS || ring_len < 1 ||
      n_tiles < 1 || ring_len * f >= ((int64_t)1 << 31) ||
      h >= ((int64_t)1 << 31))
    return (int)cudaErrorInvalidValue;
  SpanParams p;
  p.queued = (int64_t*)queued;
  p.ring = (int32_t*)ring;
  p.tokens = (int64_t*)tokens;
  p.delivered = (int64_t*)delivered;
  p.target = (int64_t*)target;
  p.done_tick = (int64_t*)done_tick;
  p.node_sent = (int64_t*)node_sent;
  p.inject = (const int64_t*)inject;
  p.inject_target = (const int64_t*)inject_target;
  p.meta = (const int4*)meta;
  p.tiles = (const int4*)tiles;
  p.node_off = (const int64_t*)node_off;
  p.refill = (const int64_t*)refill;
  p.capacity = (const int64_t*)capacity;
  p.last_flow = (const int64_t*)last_flow;
  p.scalars = (int64_t*)scalars;
  p.newly = (uint8_t*)newly;
  p.done_last = (int64_t*)done_last;
  p.sent_delta = (int64_t*)sent_delta;
  p.f = f;
  p.h = h;
  p.c = c;
  p.n_tiles = n_tiles;
  p.ring_len = ring_len;
  p.t0 = t0;
  p.idle_ticks = idle_ticks;
  p.n_targets = n_targets;
  for (int i = 0; i < MAX_TARGETS; ++i)
    p.targets[i] = targets[i < n_targets ? i : n_targets - 1];

  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, torcells_span_kernel, THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  // every block that can be resident (a cooperative launch needs every
  // block resident), but no more than there are tiles
  int64_t want = n_tiles;
  const int64_t cap = (int64_t)per_sm * sms;
  if (want < 1) want = 1;
  if (want > cap) want = cap;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel((const void*)torcells_span_kernel,
                                    dim3((unsigned)want), dim3(THREADS), args,
                                    0, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
