// torcells_run: the device-resident onion-relay cell model run to
// completion, in one persistent cooperative launch, one warp per node, for
// Hopper (sm_90a).
//
// Replaces the JAX package's shadow_tpu/ops/torcells_device.py:104
// (torcells_run, a lax.while_loop over 1 ms ticks).  The plain torch version
// of the same function is
// shadow_tpu_torch/ops/torcells_device.py:torcells_run_torch; the two agree
// bit for bit (int64 throughout, the ring too).  Its windowed form
// (torcells_step_window, :284) runs through csrc/torcells_span.cu.
//
// The model.  F flows sorted by paced node; node n paces flows
// node_off[n] .. node_off[n+1].  From queued = queued0, tokens = capacity,
// an all-zero [L, F] send ring and t = 0, while sum(delivered) <
// sum(queued0) and t < max_ticks, tick t does for every node:
//   tokens    = min(capacity, tokens + refill);  cap_cells = tokens / CELL
//   for its flows j in order (the segmented cumsum):
//     q        = queued[j] + ring[(t - arr_lat[j]) mod L, j]
//     served   = clip(cap_cells - (q of the node's earlier flows), 0, q)
//     queued[j] = q - served
//     last stage: delivered[j] += served
//     else:       ring[t mod L, succ[j]] = served
//   tokens -= served cells * CELL
// and the ring row t mod L is set whole (a column no flow feeds gets 0).
// Returns delivered [F], the ticks run and the cells forwarded.
//
// Design.  The halt depends on the data, so the loop lives on the card: a
// cooperative launch sized so that every block is resident, ONE grid sync
// per tick.  Each tick's delivered cells are summed into one of three
// rotating device words (warp sums, then one atomic add per warp that
// delivered), and after the sync every thread adds the word to its own
// copy of the running total, so all threads decide the halt alike.  A node
// is a warp: its flows are contiguous, so a warp loads 32 of them at once
// (coalesced), an inclusive warp scan of q gives each flow the cells queued
// ahead of it, and the chunk's total carries into the next 32.  The
// longest node run (65 flows at the bench shape) costs three chunks, where
// a thread per node walks 65 flows one after another.  One block with
// __syncthreads per tick would be cheaper per barrier but would give each
// of its 32 warps ~70 of the bench's 2,240 nodes to walk per tick; the
// grid gives each node its own warp.  The successor scatter is conflict-
// free (flow_succ is injective) and every arrival latency is in [1, L)
// (checked by the wrapper), so no flow reads a ring row the tick writes.
// The ring stays int64, as in JAX: 9.8 MB at the bench shape, inside L2.
//
// Bound.  Inputs and outputs once: ~0.6 MB of tables and delivered at the
// bench shape (F = 10,000, H = 2,240), ~0.2 us at HBM rate; ~24 32-bit
// operations per flow and ~32 per node a tick, ~0.49 G over 1,566 ticks,
// ~7 us at the scalar peak.  What bounds it is the tick chain: per tick the
// longest node's three dependent chunks (each a ring gather and a warp
// scan) and one grid sync.

#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;
// 512 B cell + the TCP/IP/Ethernet header (core/defs.py)
constexpr int64_t CELL_WIRE_BYTES = 512 + 66;

struct RunParams {
  const int64_t* queued0;    // [F]
  const int64_t* node_off;   // [H + 1]
  const int64_t* arr_lat;    // [F]
  const int64_t* flow_succ;  // [F]
  const int64_t* refill;     // [H]
  const int64_t* capacity;   // [H]
  int64_t* queued;           // [F] carried state
  int64_t* ring;             // [L, F] carried state
  int64_t* tokens;           // [H] carried state
  int64_t* delivered;        // [F] output
  // zeroed by the caller: [0] ticks, [1] forwards, [2] sum(queued0),
  // [3..5] the rotating per-tick delivered sums
  int64_t* scalars;
  int64_t f, h, ring_len, max_ticks;
};

__device__ __forceinline__ int64_t floor_mod(int64_t x, int64_t m) {
  const int64_t r = x % m;
  return r < 0 ? r + m : r;
}

__device__ __forceinline__ int64_t floor_div(int64_t a, int64_t b) {
  const int64_t q = a / b;
  return (q * b != a && ((a < 0) != (b < 0))) ? q - 1 : q;
}

__device__ __forceinline__ int64_t warp_sum(int64_t v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;  // in every lane
}

__device__ __forceinline__ int64_t block_sum(int64_t v) {
  __shared__ int64_t warp_part[THREADS / 32];
  v = warp_sum(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_part[warp] = v;
  __syncthreads();
  v = 0;
  if (warp == 0) {
    v = lane < THREADS / 32 ? warp_part[lane] : 0;
    v = warp_sum(v);
  }
  __syncthreads();
  return v;  // valid in warp 0
}

__global__ void __launch_bounds__(THREADS)
torcells_run_kernel(const RunParams p) {
  cg::grid_group grid = cg::this_grid();
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t nthreads = (int64_t)gridDim.x * blockDim.x;
  const int lane = threadIdx.x & 31;
  const int64_t warp_id = tid >> 5, nwarps = nthreads >> 5;
  const int64_t f = p.f, L = p.ring_len;

  // -- entry: the state, and sum(queued0) into scalars[2]
  int64_t total = 0;
  for (int64_t j = tid; j < f; j += nthreads) {
    const int64_t q = p.queued0[j];
    p.queued[j] = q;
    p.delivered[j] = 0;
    total += q;
  }
  for (int64_t n = tid; n < p.h; n += nthreads) p.tokens[n] = p.capacity[n];
  for (int64_t k = tid; k < L * f; k += nthreads) p.ring[k] = 0;
  total = block_sum(total);
  if (threadIdx.x == 0)
    atomicAdd((unsigned long long*)&p.scalars[2], (unsigned long long)total);
  grid.sync();
  total = *(volatile int64_t*)&p.scalars[2];

  // -- the tick loop; every thread runs the same iterations
  int64_t t = 0, dsum = 0, forwards = 0;
  while (dsum < total && t < p.max_ticks) {
    const int64_t k3 = t % 3;
    if (tid == 0) p.scalars[3 + (k3 + 1) % 3] = 0;
    const int64_t row = floor_mod(t, L) * f;
    int64_t dlane = 0;  // cells this lane delivered this tick
    for (int64_t n = warp_id; n < p.h; n += nwarps) {
      const int64_t cap = p.capacity[n];
      int64_t tok = p.tokens[n] + p.refill[n];
      tok = tok < cap ? tok : cap;
      const int64_t cap_cells = floor_div(tok, CELL_WIRE_BYTES);
      const int64_t j0 = p.node_off[n], j1 = p.node_off[n + 1];
      int64_t base = 0, spent = 0;
      for (int64_t jb = j0; jb < j1; jb += 32) {
        const int64_t j = jb + lane;
        const bool active = j < j1;
        int64_t q = 0, al = 0, succ = -1;
        if (active) {
          al = p.arr_lat[j];
          succ = p.flow_succ[j];
          q = p.queued[j] + p.ring[floor_mod(t - al, L) * f + j];
        }
        int64_t incl = q;
        for (int o = 1; o < 32; o <<= 1) {
          const int64_t y = __shfl_up_sync(FULL, incl, o);
          if (lane >= o) incl += y;
        }
        int64_t s = cap_cells - (base + incl - q);
        s = s < 0 ? 0 : (s > q ? q : s);
        if (active) {
          p.queued[j] = q - s;
          if (succ < 0) {
            p.delivered[j] += s;
            dlane += s;
          } else {
            p.ring[row + succ] = s;
          }
          // a column no flow feeds: its own lane sets it (after its read)
          if (al == 0) p.ring[row + j] = 0;
        }
        spent += s;
        base += __shfl_sync(FULL, incl, 31);
      }
      spent = warp_sum(spent);
      if (lane == 0) {
        p.tokens[n] = tok - spent * CELL_WIRE_BYTES;
        forwards += spent;
      }
    }
    const int64_t dwarp = warp_sum(dlane);
    if (lane == 0 && dwarp != 0)
      atomicAdd((unsigned long long*)&p.scalars[3 + k3],
                (unsigned long long)dwarp);
    grid.sync();
    dsum += *(volatile int64_t*)&p.scalars[3 + k3];
    ++t;
  }

  // -- epilogue: ticks and forwards
  forwards = block_sum(forwards);
  if (threadIdx.x == 0) {
    atomicAdd((unsigned long long*)&p.scalars[1], (unsigned long long)forwards);
    if (blockIdx.x == 0) p.scalars[0] = t;
  }
}

}  // namespace

// Launch on `stream` (a cudaStream_t passed as a pointer).  Does not
// synchronise.  Returns 0 when the launch was accepted, else the CUDA error.
extern "C" int torcells_run_launch(
    const void* queued0, const void* node_off, const void* arr_lat,
    const void* flow_succ, const void* refill, const void* capacity,
    void* queued, void* ring, void* tokens, void* delivered, void* scalars,
    int64_t f, int64_t h, int64_t ring_len, int64_t max_ticks, void* stream) {
  if (f < 1 || h < 1 || ring_len < 1) return (int)cudaErrorInvalidValue;
  RunParams p;
  p.queued0 = (const int64_t*)queued0;
  p.node_off = (const int64_t*)node_off;
  p.arr_lat = (const int64_t*)arr_lat;
  p.flow_succ = (const int64_t*)flow_succ;
  p.refill = (const int64_t*)refill;
  p.capacity = (const int64_t*)capacity;
  p.queued = (int64_t*)queued;
  p.ring = (int64_t*)ring;
  p.tokens = (int64_t*)tokens;
  p.delivered = (int64_t*)delivered;
  p.scalars = (int64_t*)scalars;
  p.f = f;
  p.h = h;
  p.ring_len = ring_len;
  p.max_ticks = max_ticks;

  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, torcells_run_kernel, THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  // a warp per node, but never more blocks than can all be resident at once
  // (a cooperative launch needs every block resident)
  int64_t want = (h * 32 + THREADS - 1) / THREADS;
  const int64_t cap = (int64_t)per_sm * sms;
  if (want < 1) want = 1;
  if (want > cap) want = cap;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel((const void*)torcells_run_kernel,
                                    dim3((unsigned)want), dim3(THREADS), args,
                                    0, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
