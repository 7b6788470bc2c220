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
// so one thread carries one host's state in registers through its ticks
// and writes it once at the end.  What bounds the kernel is that chain:
// 4,096 hosts are 128 warps, about one an SM, so the card runs at the
// speed of one warp's ticks.  The design shortens the chain and steps only
// the ticks that can change the state.  A host whose own values allow it
// (0 <= capacity, 0 <= refill, capacity + refill < 2^31, size < 2^31,
// 0 <= qcap + 1 < 2^31, ticks < 2^31; chosen per thread on the card) takes
// the narrow path:
//   * the active range [first_tick, first_tick + n_pkts) is clipped to
//     [0, ticks] in int64 (exactly where arr is 1) as [a, b);
//   * before a nothing happens (tokens = capacity >= 0, queue 0, not
//     alive), so the loop starts at a;
//   * tokens are carried as a pair (w, r), tokens = w * size + r with
//     0 <= r < size: tokens / size is w, spending n packets is w -= n, a
//     refill adds the pair (refill / size, refill % size) with one carry,
//     and the cap is a lexicographic compare against (capacity / size,
//     capacity % size); the four are computed once, so no division is
//     left in the loop, and every word is 32 bits (queue <= qcap + 1,
//     dropped <= ticks, tokens <= capacity);
//   * delivered = admitted - queue at the end, admitted = (b - a) -
//     dropped, so the loop does not count it;
//   * from b on (arr = 0), a tick that starts with an empty queue (so not
//     alive) changes nothing, and neither does any later one: the loop
//     stops there (checked every four ticks, never past ticks).
// After the pre-refill drain min(queue, w) is 0, so the post-refill drain
// needs no alive test of its own: without a refill it drains nothing.
// Every other host runs the int64 loop over every tick.
//
// Bound.  The kernel reads 4 x 8 B and writes 4 x 8 B per host (256 KB at
// 4,096 hosts: ~0.1 us at HBM rate) and the JAX function does ~40 32-bit
// operations per host per tick (4,096 x 30,000 ticks: ~5 G, ~73 us at the
// card's scalar peak).  Neither binds: the floor is the slowest warp's
// stepped ticks times a tick's dependent latency (a dozen 32-bit add,
// compare and select steps).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 32;
constexpr int64_t NARROW = int64_t(1) << 31;  // the narrow path's bound
constexpr int UNROLL = 4;                     // ticks between stop checks

__device__ __forceinline__ int64_t floor_div(int64_t a, int64_t b) {
  if (a >= 0 && b > 0 && a <= 0xFFFFFFFFLL && b <= 0xFFFFFFFFLL)
    return (int64_t)((uint32_t)a / (uint32_t)b);
  const int64_t q = a / b;
  return (q * b != a && ((a < 0) != (b < 0))) ? q - 1 : q;
}

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ int64_t clamp64(int64_t x, int64_t lo,
                                           int64_t hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

struct Out {
  int64_t delivered, dropped, queue, tokens;
};

// Every tick in int64, for a host outside the narrow bounds.
__device__ Out saturate_wide(int64_t f0, int64_t f1, int64_t ref,
                             int64_t cap, int64_t size, int64_t qcap,
                             int64_t ticks) {
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
  return {delivered, dropped, queue, tokens};
}

// One tick of the narrow path, ``arr`` the tick's arrival.
struct Narrow {
  int32_t w, queue, dropped;
  uint32_t r;
  bool alive;
  // per host, fixed
  int32_t cw, rw, q1;
  uint32_t cr, rr, size;

  __device__ __forceinline__ void tick(bool arr) {
    const bool admit = arr && queue < q1;
    // simtwin: disable=SIM204 -- admit is the tick's 0/1 admission flag, not a time; dropped <= ticks < 2^31 on this path (guard: saturate.cu:201-203)
    dropped += (int32_t)(arr && !admit);
    // simtwin: disable=SIM204 -- admit is the tick's 0/1 admission flag, not a time; queue <= qcap + 1 < 2^31 on this path (guard: saturate.cu:201-203)
    queue += (int32_t)admit;
    const int32_t n1 = min(queue, w);
    queue -= n1;
    w -= n1;
    // the refill, if alive: (w, r) + (rw, rr), capped at (cw, cr)
    uint32_t r2 = r + rr;
    const bool carry = r2 >= size;
    r2 = carry ? r2 - size : r2;
    const int32_t w2 = w + rw + (int32_t)carry;
    const bool over = w2 > cw || (w2 == cw && r2 > cr);
    w = alive ? (over ? cw : w2) : w;
    r = alive ? (over ? cr : r2) : r;
    // min(queue, w) was 0 after the first drain: no refill, no drain
    const int32_t n2 = min(queue, w);
    queue -= n2;
    w -= n2;
    alive = queue > 0;
  }
};

__device__ Out saturate_narrow(int64_t f0, int64_t f1, int64_t ref,
                               int64_t cap, int64_t size, int64_t qcap,
                               int64_t ticks) {
  const int32_t end = (int32_t)(ticks > 0 ? ticks : 0);
  const int32_t a = (int32_t)clamp64(f0, 0, end);
  const int32_t b = (int32_t)clamp64(f1, a, end);
  Narrow s;
  s.size = (uint32_t)size;
  s.cw = (int32_t)(cap / size);
  s.cr = (uint32_t)(cap % size);
  s.rw = (int32_t)(ref / size);
  s.rr = (uint32_t)(ref % size);
  s.q1 = (int32_t)(qcap + 1);
  s.w = s.cw;
  s.r = s.cr;
  s.queue = 0;
  s.dropped = 0;
  s.alive = false;
  int32_t t = a;
  // a tick that starts at or past b with an empty queue changes nothing,
  // nor does any later one
  for (; t <= end - UNROLL; t += UNROLL) {
    if (t >= b && s.queue == 0) break;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) s.tick(t + u < b);
  }
  for (; t < end; ++t) {
    if (t >= b && s.queue == 0) break;
    s.tick(t < b);
  }
  const int64_t admitted = (int64_t)(b - a) - s.dropped;
  return {admitted - s.queue, s.dropped, s.queue,
          (int64_t)s.w * size + s.r};
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
  // first_tick + n_pkts wraps as the JAX function's int64 sum does
  const int64_t f1 = (int64_t)((uint64_t)f0 + (uint64_t)n_pkts[i]);
  const int64_t ref = refill[i];
  const int64_t cap = capacity[i];
  const bool narrow = cap >= 0 && ref >= 0 && cap < NARROW &&
                      ref < NARROW && cap + ref < NARROW && size < NARROW &&
                      qcap >= -1 && qcap < NARROW - 1 && ticks < NARROW;
  const Out o = narrow ? saturate_narrow(f0, f1, ref, cap, size, qcap, ticks)
                       : saturate_wide(f0, f1, ref, cap, size, qcap, ticks);
  delivered_out[i] = o.delivered;
  dropped_out[i] = o.dropped;
  queue_out[i] = o.queue;
  tokens_out[i] = o.tokens;
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
