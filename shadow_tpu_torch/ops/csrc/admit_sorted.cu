// admit_sorted: FIFO token-bucket admission times of a dst-sorted packet
// batch, one thread per host run, for Hopper (sm_90a).
//
// Replaces the JAX package's shadow_tpu/ops/bandwidth.py:67 (admit_sorted,
// a lax.scan over the batch).  The plain torch version of the same function
// is shadow_tpu_torch/ops/bandwidth.py:admit_sorted_torch; the two agree bit
// for bit (int64 throughout).
//
// The scan carries (dst, tick, tokens, admit).  At a valid lane whose dst
// differs from the carried dst (a host's run begins) the carry resets to
// (dst, arrive / REFILL, tokens0[dst], 0); then, with ref = max(refill, 1),
//   start = max(arrive, admit);  stick = start / REFILL
//   avail = min(cap, tokens + ref * (stick - tick))
//   k     = ceil(max(size - avail, 0) / ref)
//   admit = k > 0 ? (stick + k) * REFILL : start
//   tokens = min(cap, avail + k * ref) - size;  tick = stick + k
// and the lane's output is admit.  An invalid lane outputs 0 and leaves the
// carry untouched.
//
// Design.  The carry resets completely where a run begins, so runs are
// independent and one thread walking one run in order computes exactly
// what the scan computes.  Because invalid lanes do not touch the carry, a
// run begins at a valid lane whose dst differs from the previous VALID
// lane's dst (not the previous lane's): each valid lane's thread looks back
// past invalid lanes to the previous valid one and, if it opens a run,
// walks forward over the run, skipping invalid lanes, up to the next valid
// lane of another dst.  Every invalid lane's own thread writes its 0.  The
// batch need not be sorted for this to be the scan: a dst that comes back
// later opens a new run, as the scan resets there too.
//
// Bound.  Per lane it reads 4 + 8 + 8 + 1 bytes and writes 8, and per run
// three int64 words of tables: ~1.9 MB at N = 65,536, ~0.6 us at HBM rate;
// ~60 32-bit operations per lane (two int64 divisions).  A run is a serial
// chain (a host's packets one after another), so the longest run sets the
// time; at N <= 8,192 over 2,050 hosts runs are a few packets long and one
// launch costs what any launch costs.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int64_t REFILL_NS = 1000000;  // 1 ms refill tick

__device__ __forceinline__ int64_t floor_div(int64_t a, int64_t b) {
  const int64_t q = a / b;
  return (q * b != a && ((a < 0) != (b < 0))) ? q - 1 : q;
}

__device__ __forceinline__ int64_t clamp_row(int64_t r, int64_t h) {
  return r < 0 ? 0 : (r >= h ? h - 1 : r);
}

__global__ void __launch_bounds__(THREADS)
admit_sorted_kernel(const int32_t* __restrict__ dst,
                    const int64_t* __restrict__ sizes,
                    const int64_t* __restrict__ arrive,
                    const uint8_t* __restrict__ valid,
                    const int64_t* __restrict__ tokens0,
                    const int64_t* __restrict__ refill,
                    const int64_t* __restrict__ capacity, int64_t n,
                    int64_t h, int64_t* __restrict__ admits) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (!valid[i]) {
    admits[i] = 0;
    return;
  }
  const int32_t d = dst[i];
  int64_t j = i - 1;
  while (j >= 0 && !valid[j]) --j;
  if (j >= 0 && dst[j] == d) return;  // inside a run another thread walks
  // the run's host (clamped so that a bad row never reads outside the
  // tables; the plain version clamps the same way)
  const int64_t r = clamp_row(d, h);
  const int64_t ref0 = refill[r];
  const int64_t ref = ref0 > 1 ? ref0 : 1;
  const int64_t cap = capacity[r];
  int64_t tick = floor_div(arrive[i], REFILL_NS);
  int64_t tok = tokens0[r];
  int64_t prev = 0;
  for (int64_t k = i; k < n; ++k) {
    if (!valid[k]) continue;
    if (dst[k] != d) break;
    const int64_t size = sizes[k];
    const int64_t arr = arrive[k];
    const int64_t start = arr > prev ? arr : prev;
    const int64_t stick = floor_div(start, REFILL_NS);
    int64_t avail = tok + ref * (stick - tick);
    avail = avail < cap ? avail : cap;
    int64_t kneed = size - avail;
    kneed = kneed > 0 ? kneed : 0;
    const int64_t kk = floor_div(kneed + ref - 1, ref);
    const int64_t admit = kneed > 0 ? (stick + kk) * REFILL_NS : start;
    const int64_t refilled = avail + kk * ref;
    tok = (refilled < cap ? refilled : cap) - size;
    tick = kneed > 0 ? stick + kk : stick;
    prev = admit;
    admits[k] = admit;
  }
}

}  // namespace

// Launch on `stream` (a cudaStream_t passed as a pointer).  Does not
// synchronise.  Returns 0 when the launch was accepted, else the CUDA error.
extern "C" int admit_sorted_launch(const void* dst, const void* sizes,
                                   const void* arrive, const void* valid,
                                   const void* tokens0, const void* refill,
                                   const void* capacity, int64_t n, int64_t h,
                                   void* admits, void* stream) {
  if (n < 1 || h < 1) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (n + THREADS - 1) / THREADS;
  admit_sorted_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)dst, (const int64_t*)sizes, (const int64_t*)arrive,
      (const uint8_t*)valid, (const int64_t*)tokens0, (const int64_t*)refill,
      (const int64_t*)capacity, n, h, (int64_t*)admits);
  return (int)cudaGetLastError();
}
