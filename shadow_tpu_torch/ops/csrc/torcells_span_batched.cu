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
// The model is the serial kernel's (see csrc/torcells_span.cu), per lane:
// every operand carries its lane's row ([W, F] flows, [W, H] nodes,
// [W, L, F] rings, [W, C] chains, [W, 2 + P] launch words: t0, idle ticks
// and the P superwindow boundaries).  Under vmap the while loop runs while
// any lane is live; a lane that reached its halt or its last boundary is
// frozen (its t, ring, state and forwards no longer change), and a lane
// whose boundaries equal its t0 (the fleet's filler rows) never starts.
//
// Design.  One cooperative launch for the whole batch, sized by the
// occupancy API so every block is resident; a launch needing more blocks
// than can be resident is refused, never split.  Work items are (lane,
// node) pairs, grid-strided, so W x H larger than one resident grid still
// fits.  A thread owning a node walks that node's flows serially (flows
// are sorted by node): no scan, no atomics, and it owns the node's tokens
// and node_sent.  Unlike the serial kernel, a node's run may hold several
// seg_start segments (the fleet pads a lane with inert flows, each its own
// segment): the greedy allocation restarts at each segment's first flow,
// which is the JAX segmented cumsum exactly (the wrapper checks that every
// segment is a contiguous run of one node's flows, and every arrival
// latency is in [1, L)).  One grid sync per tick serves every lane.  Each
// lane's loop control (t, boundary index, span-done, live) is replicated
// in every block's shared memory and updated after the sync from the
// lane's "newly done" flag word, three of which rotate per lane (iteration
// mod 3) so one sync per tick suffices.  Frozen lanes do no work and write
// nothing; the loop ends when no lane is live.  No host sync per tick.
//
// Bound.  Per tick the work is the serial kernel's per live lane: every
// flow touched once (~12 int64 operations, a ring gather and scatter) and
// every node once.  It is latency-bound like the serial kernel: a tick
// lasts as long as the longest node walk, plus one grid sync.

#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_LANES = 256;
constexpr int THREADS = 256;
// 512 B cell + the TCP/IP/Ethernet header (core/defs.py)
constexpr int64_t CELL_WIRE_BYTES = 512 + 66;

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
  // static tables
  const int64_t* node_off;   // [W, H + 1]
  const int64_t* arr_lat;    // [W, F]
  const int64_t* seg_start;  // [W, F]
  const int64_t* flow_succ;  // [W, F]
  const int64_t* refill;     // [W, H]
  const int64_t* capacity;   // [W, H]
  const int64_t* last_flow;  // [W, C]
  const int64_t* args;       // [W, 2 + P]: t0, idle ticks, targets
  // outputs
  int64_t* t_stop;   // [W]
  int64_t* flags;    // [3, W] per-iteration "a chain newly done" words
  int64_t* done_in;  // [W, C] done_tick[last_flow] at entry (for the pack)
  int64_t* sent_in;  // [W, H] node_sent at entry (for the pack)
  int64_t w, f, h, c, ring_len, p;
};

__device__ __forceinline__ int64_t floor_mod(int64_t x, int64_t m) {
  const int64_t r = x % m;
  return r < 0 ? r + m : r;
}

__global__ void __launch_bounds__(THREADS)
torcells_span_batched_kernel(const BatchParams p) {
  __shared__ int64_t s_t[MAX_LANES];
  __shared__ int32_t s_idx[MAX_LANES];
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
    s_idx[w] = 0;
    s_done[w] = 0;
    s_live[w] = t0 < p.args[w * A + A - 1];
    any_live |= s_live[w];
  }
  any_live = __syncthreads_or(any_live);
  grid.sync();

  // -- the tick loop: one iteration advances every live lane one tick
  for (int64_t it = 0; any_live; ++it) {
    const int64_t k3 = it % 3;
    if (tid == 0)
      for (int64_t w = 0; w < W; ++w) p.flags[((it + 1) % 3) * W + w] = 0;
    for (int64_t item = tid; item < W * H; item += nthreads) {
      const int64_t w = item / H;
      if (!s_live[w]) continue;
      const int64_t n = item - w * H;
      const int64_t t = s_t[w];
      const int64_t fo = w * F;               // lane's flow offset
      const int64_t ro = w * L * F;           // lane's ring offset
      const int64_t row = ro + floor_mod(t, L) * F;
      const int64_t cap = p.capacity[item];
      int64_t tok = p.tokens[item] + p.refill[item];
      tok = tok < cap ? tok : cap;
      const int64_t cap_cells = tok / CELL_WIRE_BYTES;
      int64_t before = 0, spent = 0;
      bool any_new = false;
      const int64_t* off = p.node_off + w * (H + 1);
      const int64_t j1 = off[n + 1];
      for (int64_t j = off[n]; j < j1; ++j) {
        const int64_t g = fo + j;
        if (p.seg_start[g] == j) before = 0;   // a new segment
        const int64_t al = p.arr_lat[g];
        const int64_t q = p.queued[g] + (int64_t)p.ring[ro + floor_mod(t - al, L) * F + j];
        int64_t s = cap_cells - before;
        s = s < 0 ? 0 : (s > q ? q : s);
        before += q;
        p.queued[g] = q - s;
        spent += s;
        const int64_t succ = p.flow_succ[g];
        if (succ < 0) {
          const int64_t d = p.delivered[g] + s;
          p.delivered[g] = d;
          const int64_t tg = p.target[g];
          if (tg > 0 && p.done_tick[g] < 0 && d >= tg) {
            p.done_tick[g] = t;
            any_new = true;
          }
        } else {
          p.ring[row + succ] = (int32_t)s;
        }
        // a column no flow feeds: its own thread sets it (after its read)
        if (al == 0) p.ring[row + j] = 0;
      }
      p.tokens[item] = tok - spent * CELL_WIRE_BYTES;
      p.node_sent[item] += spent * CELL_WIRE_BYTES;
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
    const void* inject_target, const void* node_off, const void* arr_lat,
    const void* seg_start, const void* flow_succ, const void* refill,
    const void* capacity, const void* last_flow, const void* args,
    void* t_stop, void* flags, void* done_in, void* sent_in, int64_t w,
    int64_t f, int64_t h, int64_t c, int64_t ring_len, int64_t p,
    void* stream) {
  if (w < 1 || w > MAX_LANES || p < 1 || ring_len < 1)
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
  bp.node_off = (const int64_t*)node_off;
  bp.arr_lat = (const int64_t*)arr_lat;
  bp.seg_start = (const int64_t*)seg_start;
  bp.flow_succ = (const int64_t*)flow_succ;
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
  // enough blocks for one (lane, node) item per thread, but never more
  // than can all be resident at once (grid-stride covers the rest)
  int64_t want = (w * h + THREADS - 1) / THREADS;
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
