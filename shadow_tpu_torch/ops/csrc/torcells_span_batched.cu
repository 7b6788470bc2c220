// torcells_span_batched: the fleet plane's span step, W independent lanes
// (simulations) in one persistent cooperative launch, for Hopper (sm_90a).
//
// Replaces the span half of the JAX package's
// shadow_tpu/ops/torcells_device.py:586 torcells_step_span_flush_batched
// (jax.vmap of _step_span_flush_impl :512 over a leading lane axis); the
// flush half is the batched entry of csrc/pack_flush.cu.  The plain torch
// version of the pair is shadow_tpu_torch/ops/torcells_device.py:
// torcells_step_span_flush_batched_torch, a loop over lanes of the serial
// plain step; every lane agrees with it, and with the serial kernel
// csrc/torcells_span.cu on its own row, bit for bit (int64, the ring int32).
//
// The model is the serial kernel's (see csrc/torcells_span.cu and the tick
// body csrc/span_tile.cuh), per lane: every operand carries its lane's row
// ([W, F] flows, [W, H] nodes, [W, L, F] rings, [W, C] chains, [W, 2 + P]
// launch words: t0, idle ticks and the P superwindow boundaries).  Under
// vmap the while loop runs while any lane is live; a lane that reached its
// halt or its last boundary is frozen (its t, ring, state and forwards no
// longer change), and a lane whose boundaries equal its t0 (the fleet's
// filler rows) never starts.  Unlike the serial kernel's tables, a node's
// run may hold several seg_start segments (the fleet pads a lane with inert
// flows, each its own segment): the greedy allocation restarts at every
// segment head while a node's spent still sums its whole run, which the
// tile body keeps apart (two scans, two kinds of head).
//
// Design.  One cooperative launch for the whole batch, sized by the
// occupancy API to every block that can be resident (never more blocks than
// work items); a launch needing more blocks than can be resident is
// refused, never split.  Work items are (lane, tile) pairs, lane-major and
// grid-strided, the same items for a block every tick; every lane of a
// shape class has the same tile count (BatchedSpanTables), so one launch
// shape serves the fleet.  A tile is whole nodes, its flows a thread each,
// advanced by span_tile.cuh's block-wide segmented scans: a tick no longer
// lasts the longest node's serial walk (116 flows on a sweep lane).  One
// grid sync per tick serves every lane.  Each lane's loop control (t, its
// ring row, boundary index, span-done, live) is replicated in every
// block's shared memory and updated after the sync from the lane's "newly
// done" flag word, three of which rotate per lane (iteration mod 3) so one
// sync per tick suffices.  Frozen and filler lanes do no work and write
// nothing; the loop ends when no lane is live.  No host sync per tick.
//
// Bound.  Per tick the work is the serial kernel's per live lane: every
// flow touched once (~12 int64 operations, a ring gather and scatter) and
// every node once.  A block takes W x T / grid items a tick, one after
// another, each a wave of loads, two block scans and the stores; that
// chain and the grid sync bound a tick, not the bytes or the operations.
// At W = 8 lanes of the sweep's class (512 tiles a lane, 264 blocks) a
// tick is ~71 us on an H100, the lanes' 176 MB missing the 50 MB L2
// (PERF.md section 6, row 5).

#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "span_tile.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_LANES = 256;
constexpr int THREADS = span::THREADS;

struct BatchParams {
  // carried state, updated in place
  int64_t* queued;       // [W, F]
  int32_t* ring;         // [W, L, F]
  int64_t* tokens;       // [W, H]
  int64_t* delivered;    // [W, F]
  int64_t* target;       // [W, F]
  int64_t* done_tick;    // [W, F]
  int64_t* node_sent;    // [W, H]
  // this dispatch's injections
  const int64_t* inject;         // [W, F]
  const int64_t* inject_target;  // [W, F]
  // static tables (BatchedSpanTables)
  const int4* meta;          // [W, F]: node, succ, arrival latency, flags
  const int4* tiles;         // [W, T + 1]: first node, first flow, empties
  const int64_t* node_off;   // [W, H + 1]
  const int64_t* refill;     // [W, H]
  const int64_t* capacity;   // [W, H]
  const int64_t* last_flow;  // [W, C]
  const int64_t* args;       // [W, 2 + P]: t0, idle ticks, targets
  // outputs
  int64_t* t_stop;   // [W]
  int64_t* flags;    // [3, W] per-iteration "a chain newly done" words
  int64_t* done_in;  // [W, C] done_tick[last_flow] at entry (for the pack)
  int64_t* sent_in;  // [W, H] node_sent at entry (for the pack)
  int64_t w, f, h, c, n_tiles, ring_len, p;
};

__device__ __forceinline__ int64_t floor_mod(int64_t x, int64_t m) {
  const int64_t r = x % m;
  return r < 0 ? r + m : r;
}

__global__ void __launch_bounds__(THREADS)
torcells_span_batched_kernel(const BatchParams p) {
  __shared__ int64_t s_t[MAX_LANES];
  __shared__ int32_t s_row[MAX_LANES];   // s_t mod L
  __shared__ int32_t s_idx[MAX_LANES];
  __shared__ span::Shared sh;
  __shared__ uint8_t s_done[MAX_LANES];  // span_done
  __shared__ uint8_t s_live[MAX_LANES];
  cg::grid_group grid = cg::this_grid();
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t nthreads = (int64_t)gridDim.x * blockDim.x;
  const int64_t W = p.w, F = p.f, H = p.h, C = p.c, L = p.ring_len;
  const int64_t A = p.p + 2;  // launch words per lane

  // -- entry folds, on every lane (vmap applies them to frozen and filler
  //    lanes too): injections, the idle-tick refill, the ring clear, and
  //    the pack's snapshots of done_tick[last_flow] and node_sent
  for (int64_t k = tid; k < W * F; k += nthreads) {
    p.queued[k] += p.inject[k];
    p.target[k] += p.inject_target[k];
  }
  for (int64_t k = tid; k < W * H; k += nthreads) {
    const int64_t idle = p.args[(k / H) * A + 1];
    const int64_t tk = p.tokens[k] + p.refill[k] * idle;
    p.tokens[k] = tk < p.capacity[k] ? tk : p.capacity[k];
    p.sent_in[k] = p.node_sent[k];
  }
  for (int64_t k = tid; k < W * C; k += nthreads)
    p.done_in[k] = p.done_tick[(k / C) * F + p.last_flow[k]];
  for (int64_t w = 0; w < W; ++w)
    if (p.args[w * A + 1] > 0)
      for (int64_t k = tid; k < L * F; k += nthreads) p.ring[w * L * F + k] = 0;
  for (int64_t k = tid; k < 3 * W; k += nthreads) p.flags[k] = 0;
  int any_live = 0;
  for (int64_t w = threadIdx.x; w < W; w += blockDim.x) {
    const int64_t t0 = p.args[w * A];
    s_t[w] = t0;
    s_row[w] = (int32_t)floor_mod(t0, L);
    s_idx[w] = 0;
    s_done[w] = 0;
    s_live[w] = t0 < p.args[w * A + A - 1];
    any_live |= s_live[w];
  }
  any_live = __syncthreads_or(any_live);
  grid.sync();

  // -- the tick loop: one iteration advances every live lane one tick
  const span::Table tb{p.queued,   p.ring,      p.tokens,    p.delivered,
                       p.target,   p.done_tick, p.node_sent, p.meta,
                       p.tiles,    p.node_off,  p.refill,    p.capacity,
                       F,          H,           p.n_tiles,   (int)L};
  const int64_t items = W * p.n_tiles;
  int64_t unused_forwards = 0;   // the batched pack counts them
  for (int64_t it = 0; any_live; ++it) {
    const int64_t k3 = it % 3;
    if (tid == 0)
      for (int64_t w = 0; w < W; ++w) p.flags[((it + 1) % 3) * W + w] = 0;
    for (int64_t item = blockIdx.x; item < items; item += gridDim.x) {
      const int64_t w = item / p.n_tiles;
      if (!s_live[w]) continue;
      bool any_new = false;
      span::span_tile(tb, w, (int)(item - w * p.n_tiles), s_t[w], s_row[w],
                      &unused_forwards, &any_new, sh);
      if (any_new) p.flags[k3 * W + w] = 1;
    }
    grid.sync();
    // every block advances its copy of each live lane's control alike
    int live = 0;
    for (int64_t w = threadIdx.x; w < W; w += blockDim.x) {
      if (s_live[w]) {
        const bool any = *(volatile int64_t*)&p.flags[k3 * W + w] != 0;
        bool done = s_done[w] || any;
        int idx = s_idx[w];
        const int64_t t = s_t[w];
        const int64_t bnd = p.args[w * A + 2 + (idx < p.p - 1 ? idx : p.p - 1)];
        const bool boundary = (t + 1) == bnd;
        const bool halt = boundary && done;
        if (boundary) {
          ++idx;
          done = false;
        }
        s_t[w] = t + 1;
        s_row[w] = s_row[w] + 1 == L ? 0 : s_row[w] + 1;
        s_idx[w] = idx;
        s_done[w] = done;
        s_live[w] = !halt && (t + 1) < p.args[w * A + A - 1];
      }
      live |= s_live[w];
    }
    any_live = __syncthreads_or(live);
  }

  if (blockIdx.x == 0)
    for (int64_t w = threadIdx.x; w < W; w += blockDim.x) p.t_stop[w] = s_t[w];
}

}  // namespace

// Launch on `stream` (a cudaStream_t passed as a pointer).  Does not
// synchronise.  Returns 0 when the launch was accepted, else the CUDA error
// (cudaErrorCooperativeLaunchTooLarge when the card cannot hold one block).
extern "C" int torcells_span_batched_launch(
    void* queued, void* ring, void* tokens, void* delivered, void* target,
    void* done_tick, void* node_sent, const void* inject,
    const void* inject_target, const void* meta, const void* tiles,
    const void* node_off, const void* refill, const void* capacity,
    const void* last_flow, const void* args, void* t_stop, void* flags,
    void* done_in, void* sent_in, int64_t w, int64_t f, int64_t h, int64_t c,
    int64_t n_tiles, int64_t ring_len, int64_t p, void* stream) {
  // the tile body indexes a lane's ring and tables with 32-bit offsets
  if (w < 1 || w > MAX_LANES || p < 1 || ring_len < 1 || n_tiles < 1 ||
      ring_len * f >= ((int64_t)1 << 31) || h >= ((int64_t)1 << 31))
    return (int)cudaErrorInvalidValue;
  BatchParams bp;
  bp.queued = (int64_t*)queued;
  bp.ring = (int32_t*)ring;
  bp.tokens = (int64_t*)tokens;
  bp.delivered = (int64_t*)delivered;
  bp.target = (int64_t*)target;
  bp.done_tick = (int64_t*)done_tick;
  bp.node_sent = (int64_t*)node_sent;
  bp.inject = (const int64_t*)inject;
  bp.inject_target = (const int64_t*)inject_target;
  bp.meta = (const int4*)meta;
  bp.tiles = (const int4*)tiles;
  bp.node_off = (const int64_t*)node_off;
  bp.refill = (const int64_t*)refill;
  bp.capacity = (const int64_t*)capacity;
  bp.last_flow = (const int64_t*)last_flow;
  bp.args = (const int64_t*)args;
  bp.t_stop = (int64_t*)t_stop;
  bp.flags = (int64_t*)flags;
  bp.done_in = (int64_t*)done_in;
  bp.sent_in = (int64_t*)sent_in;
  bp.w = w;
  bp.f = f;
  bp.h = h;
  bp.c = c;
  bp.n_tiles = n_tiles;
  bp.ring_len = ring_len;
  bp.p = p;

  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, torcells_span_batched_kernel, THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  // every block that can be resident (grid-stride covers the rest), but
  // no more than there are (lane, tile) items
  int64_t want = w * n_tiles;
  const int64_t cap = (int64_t)per_sm * sms;
  if (want < 1) want = 1;
  if (want > cap) want = cap;
  void* kargs[] = {&bp};
  err = cudaLaunchCooperativeKernel((const void*)torcells_span_batched_kernel,
                                    dim3((unsigned)want), dim3(THREADS), kargs,
                                    0, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
