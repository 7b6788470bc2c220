// saturate: the device-resident bandwidth saturation model, one thread per
// receiving interface, for Hopper (sm_90a).
//
// Replaces the JAX package's shadow_tpu/ops/saturate_device.py:46
// (saturate_run, a lax.fori_loop over 1 ms ticks).  The plain torch version
// of the same function is
// shadow_tpu_torch/ops/saturate_device.py:saturate_run_torch; the two agree
// bit for bit (int64 throughout).
//
// Per tick t and host i (all int64):
//   arr      = first_tick[i] <= t < first_tick[i] + n_pkts[i]     (0 or 1)
//   admit    = min(arr, max(qcap + 1 - queue, 0));  dropped += arr - admit
//   queue   += admit
//   n1       = min(queue, tokens / size)     (the pre-refill drain)
//   if alive: tokens = min(capacity, tokens + refill)
//             n2 = min(queue, tokens / size) (the post-refill drain)
//   queue -= n1 + n2;  tokens -= (n1 + n2) * size;  delivered += n1 + n2
//   alive    = queue > 0
// with tokens = capacity, queue = 0, alive = false at t = 0.
//
// Design.  Hosts are independent and a host's ticks are a dependent chain,
// so one thread carries one host's five state words in registers through
// every tick and writes them once at the end: no memory traffic in the
// loop, no synchronisation.  The divisions are floor divisions; tokens and
// size stay in [0, 2^32) in every real configuration, so they take a
// 32-bit unsigned division, with the int64 floor division as the exact
// path for anything else.
//
// Bound.  The kernel reads 4 x 8 B and writes 4 x 8 B per host (256 KB at
// 4,096 hosts: ~0.1 us at HBM rate) and does ~40 32-bit operations per host
// per tick (4,096 x 30,000 ticks: ~5 G, ~73 us at the card's scalar peak).
// What bounds it is neither: each thread's ticks are a serial chain of a
// few dozen dependent instructions, 30,000 long, and 4,096 threads are 128
// warps, one per SM on about 128 of the 132 SMs, so the card runs at the
// speed of one warp's chain.  Splitting the ticks needs the state at the
// split, which is the chain itself; making it fast is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 32;

__device__ __forceinline__ int64_t floor_div(int64_t a, int64_t b) {
  if (a >= 0 && b > 0 && a <= 0xFFFFFFFFLL && b <= 0xFFFFFFFFLL)
    return (int64_t)((uint32_t)a / (uint32_t)b);
  const int64_t q = a / b;
  return (q * b != a && ((a < 0) != (b < 0))) ? q - 1 : q;
}

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__global__ void __launch_bounds__(THREADS)
saturate_kernel(const int64_t* __restrict__ first_tick,
                const int64_t* __restrict__ n_pkts,
                const int64_t* __restrict__ refill,
                const int64_t* __restrict__ capacity, int64_t h,
                int64_t size, int64_t qcap, int64_t ticks,
                int64_t* __restrict__ delivered_out,
                int64_t* __restrict__ dropped_out,
                int64_t* __restrict__ queue_out,
                int64_t* __restrict__ tokens_out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= h) return;
  const int64_t f0 = first_tick[i];
  const int64_t f1 = f0 + n_pkts[i];
  const int64_t ref = refill[i];
  const int64_t cap = capacity[i];
  int64_t tokens = cap, queue = 0, delivered = 0, dropped = 0;
  bool alive = false;
  for (int64_t t = 0; t < ticks; ++t) {
    const int64_t arr = (t >= f0 && t < f1) ? 1 : 0;
    int64_t space = qcap + 1 - queue;
    space = space > 0 ? space : 0;
    const int64_t admit = min64(arr, space);
    dropped += arr - admit;
    queue += admit;
    const int64_t n1 = min64(queue, floor_div(tokens, size));
    queue -= n1;
    tokens -= n1 * size;
    delivered += n1;
    if (alive) {
      tokens = min64(cap, tokens + ref);
      const int64_t n2 = min64(queue, floor_div(tokens, size));
      queue -= n2;
      tokens -= n2 * size;
      delivered += n2;
    }
    alive = queue > 0;
  }
  delivered_out[i] = delivered;
  dropped_out[i] = dropped;
  queue_out[i] = queue;
  tokens_out[i] = tokens;
}

}  // namespace

// Launch on `stream` (a cudaStream_t passed as a pointer).  Does not
// synchronise.  Returns 0 when the launch was accepted, else the CUDA error.
extern "C" int saturate_launch(const void* first_tick, const void* n_pkts,
                               const void* refill, const void* capacity,
                               int64_t h, int64_t size, int64_t qcap,
                               int64_t ticks, void* delivered, void* dropped,
                               void* queue, void* tokens, void* stream) {
  if (h < 1 || size < 1) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (h + THREADS - 1) / THREADS;
  saturate_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const int64_t*)first_tick, (const int64_t*)n_pkts,
      (const int64_t*)refill, (const int64_t*)capacity, h, size, qcap, ticks,
      (int64_t*)delivered, (int64_t*)dropped, (int64_t*)queue,
      (int64_t*)tokens);
  return (int)cudaGetLastError();
}
