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
// opens it, and the bench's 16,384 messages are ~220 ripe hops a window, too
// little work to spread over the card.  So one block of 1,024 threads runs
// every window with no host round trip and no grid sync: the message state
// sits in shared memory (12 B a message; the whole state up to 18,773
// messages, else it stays in the output arrays in device memory, through
// the same generic pointers), each thread owns messages tid, tid + 1024, ...,
// and a window costs one block-wide minimum (warp shuffles and two
// __syncthreads) plus the thread's own messages.  A cooperative grid would
// pay a grid sync per window (~1,000 windows a simulated second) for
// nothing, since the per-window work is a few hundred hops.  The lookahead
// is a block-wide minimum over the latency matrix at entry.
//
// Bound.  Inputs and outputs once (8 MB of latency at H = 1,024, 196 KB of
// message state): ~2.6 us at HBM rate; each hop ~170 32-bit operations (the
// cipher ~120) and each message ~4 a window (its minimum and its ripe
// test): 6.5 M hops and ~30,000 windows by 30 s, ~3.1 G operations, ~46 us
// at the scalar peak.  What bounds it is the serial window chain: ~30,000
// windows, each a block-wide minimum, in one SM.

#include <cstdint>
#include <cuda_runtime.h>

#include "threefry.cuh"

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int64_t NO_LOOKAHEAD = 1LL << 62;
// shared memory for the message state (dynamic, 12 B a message)
constexpr int64_t SMEM_LIMIT = 220 * 1024;

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

// block-wide minimum of v, returned to every thread
__device__ __forceinline__ int64_t block_min(int64_t v, int64_t* part,
                                             int64_t* bcast) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1)
    v = min64(v, __shfl_down_sync(0xffffffffu, v, o));
  if (lane == 0) part[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < WARPS ? part[lane] : INT64_MAX;
    for (int o = 16; o > 0; o >>= 1)
      v = min64(v, __shfl_down_sync(0xffffffffu, v, o));
    if (lane == 0) *bcast = v;
  }
  __syncthreads();
  return *bcast;
}

__device__ __forceinline__ int64_t block_sum(int64_t v, int64_t* part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if (lane == 0) part[warp] = v;
  __syncthreads();
  v = 0;
  if (warp == 0) {
    v = lane < WARPS ? part[lane] : 0;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;  // valid in thread 0
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
  __shared__ int64_t part[WARPS];
  __shared__ int64_t bcast;
  const int tid = threadIdx.x;
  int64_t* time = in_smem ? smem : time_out;
  int32_t* host = in_smem ? (int32_t*)(smem + m) : host_out;

  int64_t lo = NO_LOOKAHEAD;
  for (int64_t k = tid; k < h * h; k += THREADS) {
    const int64_t v = latency[k];
    if (v > 0) lo = min64(lo, v);
  }
  const int64_t lookahead = block_min(lo, part, &bcast);
  for (int64_t k = tid; k < m; k += THREADS) {
    time[k] = time_in[k];
    host[k] = host_in[k];
  }
  // each thread reads back only its own messages, so no barrier is needed
  // between the copy, a window's updates and the next window's minimum

  const uint32_t mod = (uint32_t)(h - 1);
  int64_t hops = 0;
  uint32_t counter = 0;
  for (;;) {
    int64_t lo_t = INT64_MAX;
    for (int64_t k = tid; k < m; k += THREADS) lo_t = min64(lo_t, time[k]);
    const int64_t start = block_min(lo_t, part, &bcast);
    if (start >= horizon) break;
    const int64_t end = wrap_add(start, lookahead);
    for (int64_t k = tid; k < m; k += THREADS) {
      const int64_t t = time[k];
      if (t >= end) continue;
      int32_t src = host[k];
      src = src < 0 ? 0 : (src >= h ? (int32_t)(h - 1) : src);
      const uint32_t x0 =
          threefry::threefry2x32_x0(key0, key1, (uint32_t)k, counter);
      const int32_t kq = (int32_t)(x0 % mod);
      const int32_t dst = kq >= host[k] ? kq + 1 : kq;
      const int32_t dcl = dst >= h ? (int32_t)(h - 1) : dst;
      time[k] = wrap_add(t, latency[(int64_t)src * h + dcl]);
      host[k] = dst;
      ++hops;
    }
    ++counter;
  }
  if (in_smem) {
    for (int64_t k = tid; k < m; k += THREADS) {
      time_out[k] = time[k];
      host_out[k] = host[k];
    }
  }
  hops = block_sum(hops, part);
  if (tid == 0) {
    stats_out[0] = hops;
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
  if (h < 2 || m < 1) return (int)cudaErrorInvalidValue;
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
