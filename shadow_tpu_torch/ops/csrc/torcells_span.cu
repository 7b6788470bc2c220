// torcells_span: one superwindow of the device traffic plane, the whole tick
// loop in one persistent cooperative launch, for Hopper (sm_90a).
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
// node_off[n] .. node_off[n+1].  Per tick t, for every node:
//   tokens    = min(capacity, tokens + refill)
//   cap_cells = tokens / CELL                       (tokens >= 0: a floor)
//   for each of its flows j in order (the segmented cumsum, serially):
//     q        = queued[j] + ring[(t - arr_lat[j]) mod L, j]
//     served   = clip(cap_cells - before, 0, q);  before += q
//     queued[j] = q - served
//     last stage: delivered += served, done_tick = t on reaching target
//     else      : ring[t mod L, succ[j]] = served   (int32)
//   tokens -= spent * CELL; node_sent += spent * CELL
// and the ring row t mod L is set whole: a column no flow feeds gets 0.
// At each boundary targets[idx] the loop halts iff a chain completed in
// the span just ended; otherwise the next span starts clean.
//
// Design.  The halt depends on the data, and the host must not sync per
// tick, so the loop lives on the card: a cooperative launch, sized by the
// occupancy API so every block is resident, with grid-stride loops and ONE
// grid sync per tick.  One thread per node walks its node's flows serially
// (flows are sorted by node, so each node's segment is contiguous and the
// greedy allocation needs no scan and no atomics: the node's thread owns
// its tokens, node_sent and the flows it paces).  The successor scatter is
// conflict-free (flow_succ is injective), and since every arrival latency
// is in [1, L) (checked by the wrapper, SpanTables) the row a tick writes is
// never a row any flow reads in that tick, so a tick needs no sync inside
// it.  The tick's "any chain newly done" flag is a device word; three of
// them rotate (t mod 3) so thread 0 can clear the next tick's flag while
// others still read this one.  t, the boundary index, span_done and the
// halt are replicated in every thread's registers and evolve identically
// from what each reads after the sync.  The superwindow boundaries come in
// by value in the parameter block (at most MAX_TARGETS).
//
// Bound.  Per tick the work touches every flow once (~10 int64 ops and a
// ring gather + scatter) and every node once: about 3.3 M 32-bit
// operations at tor10k width (F = 100,000, H = 30,494), ~50 us at the
// card's scalar peak, against ~13 MB of state that stays in the 50 MB L2.
// One grid sync per tick costs a few microseconds and is paid T times.
// Each arrival and send is a scattered 4-byte access; the loop is latency-
// bound, not bandwidth-bound.  Making it fast is later work.

#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_TARGETS = 64;
constexpr int THREADS = 256;
// 512 B cell + the TCP/IP/Ethernet header (core/defs.py)
constexpr int64_t CELL_WIRE_BYTES = 512 + 66;

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
  // static tables
  const int64_t* node_off;   // [H + 1]
  const int64_t* arr_lat;    // [F]
  const int64_t* flow_succ;  // [F]
  const int64_t* refill;     // [H]
  const int64_t* capacity;   // [H]
  const int64_t* last_flow;  // [C]
  // outputs: scalars [0] t_stop, [1] forwards, [2] delivered sum,
  // [3..5] per-tick completion flags; then the flush inputs
  int64_t* scalars;
  uint8_t* newly;        // [C] bool
  int64_t* done_last;    // [C] (holds the entry snapshot during the loop)
  int64_t* sent_delta;   // [H] (holds the entry snapshot during the loop)
  int64_t f, h, c, ring_len, t0, idle_ticks;
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
  int64_t t = p.t0;
  const int64_t end = p.targets[p.n_targets - 1];
  int idx = 0;
  bool span_done = false, halt = false;
  int64_t forwards = 0;
  while (t < end && !halt) {
    const int64_t k3 = (t - p.t0) % 3;
    if (tid == 0) p.scalars[3 + (k3 + 1) % 3] = 0;
    const int64_t row = floor_mod(t, L) * f;
    bool any_new = false;
    for (int64_t n = tid; n < p.h; n += nthreads) {
      const int64_t cap = p.capacity[n];
      int64_t tok = p.tokens[n] + p.refill[n];
      tok = tok < cap ? tok : cap;
      const int64_t cap_cells = tok / CELL_WIRE_BYTES;
      int64_t before = 0, spent = 0;
      const int64_t j1 = p.node_off[n + 1];
      for (int64_t j = p.node_off[n]; j < j1; ++j) {
        const int64_t al = p.arr_lat[j];
        const int64_t q = p.queued[j] + (int64_t)p.ring[floor_mod(t - al, L) * f + j];
        int64_t s = cap_cells - before;
        s = s < 0 ? 0 : (s > q ? q : s);
        before += q;
        p.queued[j] = q - s;
        spent += s;
        const int64_t succ = p.flow_succ[j];
        if (succ < 0) {
          const int64_t d = p.delivered[j] + s;
          p.delivered[j] = d;
          const int64_t tg = p.target[j];
          if (tg > 0 && p.done_tick[j] < 0 && d >= tg) {
            p.done_tick[j] = t;
            any_new = true;
          }
        } else {
          p.ring[row + succ] = (int32_t)s;
        }
        // a column no flow feeds: its own thread sets it (after its read)
        if (al == 0) p.ring[row + j] = 0;
      }
      p.tokens[n] = tok - spent * CELL_WIRE_BYTES;
      p.node_sent[n] += spent * CELL_WIRE_BYTES;
      forwards += spent;
    }
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
    const void* inject_target, const void* node_off, const void* arr_lat,
    const void* flow_succ, const void* refill, const void* capacity,
    const void* last_flow, void* scalars, void* newly, void* done_last,
    void* sent_delta, int64_t f, int64_t h, int64_t c, int64_t ring_len,
    int64_t t0, int64_t idle_ticks, int n_targets, const int64_t* targets,
    void* stream) {
  if (n_targets < 1 || n_targets > MAX_TARGETS || ring_len < 1)
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
  p.node_off = (const int64_t*)node_off;
  p.arr_lat = (const int64_t*)arr_lat;
  p.flow_succ = (const int64_t*)flow_succ;
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
  // enough blocks for one node per thread, but never more than can all be
  // resident at once (a cooperative launch needs every block resident)
  int64_t want = (h + THREADS - 1) / THREADS;
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
