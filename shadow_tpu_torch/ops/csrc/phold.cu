// phold: device-resident PHOLD, the whole run in one launch of one block,
// for Hopper (sm_90a).
//
// Replaces the JAX package's shadow_tpu/ops/phold_device.py:38 (phold_run,
// a lax.while_loop over lookahead windows).  The plain torch version of the
// same function is shadow_tpu_torch/ops/phold_device.py:phold_run_torch;
// the two agree bit for bit.
//
// The model.  M messages, message m at host[m] (int32) with ripeness time
// time[m] (int64 ns), H hosts with an int64 [H, H] latency matrix:
//   lookahead = min(latency > 0) (2^62 if there is none)
//   while min(time) < horizon:                       (window `counter`)
//     end   = min(time) + lookahead
//     for every m with time[m] < end (ripe):
//       x0  = threefry2x32(key, (m, counter)).x0
//       k   = x0 % (H - 1);  dst = k >= host[m] ? k + 1 : k   (never self)
//       time[m] += latency[host[m], dst];  host[m] = dst;  hops += 1
//     counter += 1
// Returns the final host and time arrays, the hops and (for the bound) the
// windows run.  The JAX program draws the cipher for every message and
// discards the unripe ones' draws; here only ripe messages draw, which gives
// the same result.
//
// Design.  A window's only coupling between messages is the minimum that
// opens it, and after the first window (every message ripe, since the runs
// start at time 0) the bench's 16,384 messages are ~220 ripe hops a window
// (at most ~320): too little work to spread over the card.  So one block of
// 1,024 threads runs every window with no host round trip and no grid
// sync.  The message state sits in shared memory (12 B a message; the whole
// state up to 18,773 messages, else it stays in the output arrays in device
// memory, through the same generic pointers).  Thread tid owns messages
// tid + 1024 i, and a window is
//   1. one pass over the thread's messages (i < 32 a pass: a mask word of
//      its ripe ones), the unripe times into a running minimum;
//   2. a warp-wide exclusive scan of the mask words' popcounts, which places
//      each lane's ripe messages in its warp's list (compaction, in lane
//      order; ~7 a warp after the first window);
//   3. the warp hops its list 32 entries a round, one entry a lane (the
//      cipher and the latency gather once per ripe message, every warp's
//      wave at once), the new times into the same minimum;
//   4. a block-wide minimum (one barrier): the next window's start.
// A warp hops only its own lanes' messages, so the list needs no block
// barrier and never overflows (a round takes 32, the first window takes 16
// rounds).  Messages beyond 32 a thread (M > 32,768, the device-memory
// path) go through 1-3 as passes of 32,768.  A block-wide list (a block
// scan and a list barrier more a window) measured slower on an H100, and
// the design before both (each thread walking its 16 messages serially for
// the hops: ~5-6 cipher runs a warp, each masked down to one or two lanes)
// slower still (PERF.md section 6, row 9).
//
// Bound.  Inputs and outputs once (8 MB of latency at H = 1,024, 196 KB of
// message state): ~2.6 us at HBM rate; each hop ~170 32-bit operations (the
// cipher ~120) and each message ~4 a window (its minimum and its ripe
// test): 6.5 M hops and ~30,000 windows by 30 s, ~3.1 G operations, ~46 us
// at the scalar peak.  What bounds it is the serial window chain: ~30,000
// windows, each a dependent chain of the pass over the state (16 shared
// loads a thread, about half the window), one cipher and L2 gather, and a
// block-wide minimum, in one SM.

#include <cstdint>
#include <cuda_runtime.h>

#include "threefry.cuh"

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int BITS = 32;  // messages a thread tests in a pass: a mask word
constexpr int64_t PASS = (int64_t)THREADS * BITS;
constexpr unsigned FULL = 0xffffffffu;
constexpr int64_t NO_LOOKAHEAD = 1LL << 62;
// shared memory for the message state (dynamic, 12 B a message)
constexpr int64_t SMEM_LIMIT = 220 * 1024;

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

// block-wide minimum of v, returned to every thread: one barrier, the warp
// minima in `part` (a caller alternates two, so the next call's writes
// come after this call's barrier has been passed by every reader)
__device__ __forceinline__ int64_t block_min(int64_t v, int64_t* part) {
  for (int o = 16; o > 0; o >>= 1) v = min64(v, __shfl_xor_sync(FULL, v, o));
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  v = part[threadIdx.x & 31];  // WARPS == 32
  for (int o = 16; o > 0; o >>= 1) v = min64(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ int64_t wrap_add(int64_t a, int64_t b) {
  return (int64_t)((uint64_t)a + (uint64_t)b);  // int64 wraps, as in XLA
}

__global__ void __launch_bounds__(THREADS)
phold_kernel(const int64_t* __restrict__ latency, int64_t h,
             const int32_t* __restrict__ host_in,
             const int64_t* __restrict__ time_in, int64_t m, uint32_t key0,
             uint32_t key1, int64_t horizon, bool in_smem,
             int32_t* host_out, int64_t* time_out, int64_t* stats_out) {
  extern __shared__ int64_t smem[];
  __shared__ int64_t part[2][WARPS];
  __shared__ int32_t wlist[WARPS][32];  // a warp's list, one round of it
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int64_t* time = in_smem ? smem : time_out;
  int32_t* host = in_smem ? (int32_t*)(smem + m) : host_out;

  int64_t lo = NO_LOOKAHEAD;
  for (int64_t k = tid; k < h * h; k += THREADS) {
    const int64_t v = latency[k];
    if (v > 0) lo = min64(lo, v);
  }
  const int64_t lookahead = block_min(lo, part[0]);
  lo = INT64_MAX;
  for (int64_t k = tid; k < m; k += THREADS) {
    const int64_t t = time_in[k];
    time[k] = t;
    host[k] = host_in[k];
    lo = min64(lo, t);
  }
  int64_t start = block_min(lo, part[1]);

  const uint32_t mod = (uint32_t)(h - 1);
  int64_t hops = 0;  // this warp's (every lane holds it)
  uint32_t counter = 0;
  int par = 0;
  while (start < horizon) {
    const int64_t end = wrap_add(start, lookahead);
    lo = INT64_MAX;
    for (int64_t base = 0; base < m; base += PASS) {
      // 1. the ripe test: `full` words every thread owns, then one more
      //    for the threads below the remainder
      const int64_t rem = m - base;
      const int full = rem >= PASS ? BITS : (int)(rem / THREADS);
      uint32_t mask = 0;
#pragma unroll
      for (int i = 0; i < BITS; ++i) {
        if (i >= full) break;
        const int64_t t = time[base + (int64_t)i * THREADS + tid];
        if (t < end)
          mask |= 1u << i;
        else
          lo = min64(lo, t);
      }
      if (full < BITS && tid < rem - (int64_t)full * THREADS) {
        const int64_t t = time[base + (int64_t)full * THREADS + tid];
        if (t < end)
          mask |= 1u << full;
        else
          lo = min64(lo, t);
      }
      // 2. the warp's exclusive scan of the ripe counts
      const int cnt = __popc(mask);
      int incl = cnt;
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += v;
      }
      const int total = __shfl_sync(FULL, incl, 31);
      const int pos = incl - cnt;
      // 3. the warp's list, 32 entries a round, one a lane
      for (int r0 = 0; r0 < total; r0 += 32) {
        uint32_t mm = mask;
        for (int p = pos; mm != 0 && p < r0 + 32; ++p) {
          const int i = __ffs(mm) - 1;
          mm &= mm - 1;
          if (p >= r0)
            wlist[warp][p - r0] = (int32_t)(base + (int64_t)i * THREADS + tid);
        }
        __syncwarp();
        if (r0 + lane < total) {
          const int64_t k = wlist[warp][lane];
          const int64_t t = time[k];
          const int32_t src = host[k];
          const int32_t srcc =
              src < 0 ? 0 : (src >= h ? (int32_t)(h - 1) : src);
          const uint32_t x0 =
              threefry::threefry2x32_x0(key0, key1, (uint32_t)k, counter);
          const int32_t kq = (int32_t)(x0 % mod);
          const int32_t dst = kq >= src ? kq + 1 : kq;
          const int32_t dcl = dst >= h ? (int32_t)(h - 1) : dst;
          const int64_t nt =
              wrap_add(t, __ldg(&latency[(int64_t)srcc * h + dcl]));
          time[k] = nt;
          host[k] = dst;
          lo = min64(lo, nt);
        }
        __syncwarp();
      }
      hops += total;
    }
    // 4. the next window's start (its barrier orders this window's hops
    //    before the copy out)
    start = block_min(lo, part[par]);
    par ^= 1;
    ++counter;
  }
  if (in_smem) {
    for (int64_t k = tid; k < m; k += THREADS) {
      time_out[k] = time[k];
      host_out[k] = host[k];
    }
  }
  if (lane == 0) part[par][warp] = hops;
  __syncthreads();
  if (tid == 0) {
    int64_t sum = 0;
    for (int w = 0; w < WARPS; ++w) sum += part[par][w];
    stats_out[0] = sum;
    stats_out[1] = counter;
  }
}

}  // namespace

// Launch on `stream` (a cudaStream_t passed as a pointer).  Does not
// synchronise.  Returns 0 when the launch was accepted, else the CUDA error.
extern "C" int phold_launch(const void* latency, int64_t h,
                            const void* host_in, const void* time_in,
                            int64_t m, uint32_t key0, uint32_t key1,
                            int64_t horizon, void* host_out, void* time_out,
                            void* stats_out, void* stream) {
  if (h < 2 || m < 1 || m >= ((int64_t)1 << 31))
    return (int)cudaErrorInvalidValue;
  const int64_t need = m * (int64_t)(sizeof(int64_t) + sizeof(int32_t));
  const bool in_smem = need <= SMEM_LIMIT;
  const int smem = in_smem ? (int)need : 0;
  cudaError_t err = cudaFuncSetAttribute(
      phold_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_LIMIT);
  if (err != cudaSuccess) return (int)err;
  phold_kernel<<<1, THREADS, smem, (cudaStream_t)stream>>>(
      (const int64_t*)latency, h, (const int32_t*)host_in,
      (const int64_t*)time_in, m, key0, key1, horizon, in_smem,
      (int32_t*)host_out, (int64_t*)time_out, (int64_t*)stats_out);
  return (int)cudaGetLastError();
}
