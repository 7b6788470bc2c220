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
// The batch is sorted by dst over every lane, invalid lanes included (the
// JAX function's contract), so an invalid lane inside a run has the run's
// dst.  Off that contract this rule (the plain version's) and JAX's scan
// part: JAX resets tick, tokens and admit at an invalid lane of another
// dst, and this keeps them (ROADMAP C4).
//
// Design.  The carry resets completely where a run begins, so runs are
// independent and one thread walking one run in order computes exactly
// what the scan computes.  Because invalid lanes do not touch the carry, a
// run begins at a valid lane whose dst differs from the previous VALID
// lane's dst (a dst that comes back later in an unsorted batch opens a new
// run, as the scan resets there too).
// A run is a serial chain, so the longest run sets the time.  Two kernels,
// one launch a call, chosen by N:
//
// admit_sorted_kernel (N > LANES_MAX), a block a tile:
//   * a block of THREADS threads loads a span of LANES contiguous lanes a
//     thread (its tile and a halo of HALO lanes after it; 16-byte loads
//     where the operands are aligned) and, in warp 0, the 32 lanes before
//     the tile, in one round trip; it writes the 0 of each invalid lane of
//     its own tile;
//   * a block sum-scan compacts the span's valid lanes in order (the
//     tile's first), each with floor(arrive / 10^6); if the 32 lanes before
//     the tile are all invalid, warp 0 looks on back (32 lanes a step);
//   * a valid tile lane opens a run when its dst differs from the previous
//     valid lane's (or there is none); a second sum-scan lists the
//     openers, so a run's packets are a known range of compacted
//     positions, the tile's last run's reaching into the halo up to its
//     first lane of another dst; thread p walks runs p, p + THREADS, ...,
//     their tables loaded at once, each packet's loads ahead of the step
//     before it; a run longer than the halo goes on over windows of HALO
//     lanes that the block stages;
//   * no division on the chain: floor(x / 10^6) is a multiply-high, the
//     stick of the previous admit is the tick the step leaves (admit is
//     start, or (stick + k) * REFILL), and k = ceil(kneed / ref) is a
//     multiply-high and two shifts by a reciprocal of ref made once per run
//     (Granlund and Montgomery's exact 32-bit division) where ref < 2^31,
//     kneed + ref - 1 < 2^32 and |start| < 2^62 (so that (stick + k) *
//     REFILL cannot wrap); any other packet takes the int64 division, and
//     the stick of its admit by division.
// admit_sorted_kernel_lanes (N <= LANES_MAX), a thread a lane: a valid
// lane looks back past invalid lanes to the previous valid one and, if it
// opens a run, walks it in device memory.  A small batch is
// launch-bound, and the tiled kernel's fixed work (a round trip and two
// block scans before the first step) costs more there than it saves.
//
// Bound.  Per lane it reads 4 + 8 + 8 + 1 bytes and writes 8, and per run
// three int64 words of tables: ~1.9 MB at N = 65,536, ~0.6 us at HBM rate;
// the JAX function does ~60 32-bit operations per lane.  Neither binds:
// the floor is the longest run's packets times a packet's dependent
// latency (int64 compare, select, multiply-add and min, the reciprocal's
// multiply-high and shifts).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int LANES = 4;                 // contiguous lanes a thread loads
constexpr int SPAN = THREADS * LANES;    // lanes a block stages
constexpr int HALO = THREADS;            // of them past its tile
constexpr int TILE = SPAN - HALO;        // lanes a block owns
constexpr int WARPS = THREADS / 32;
constexpr int RUNS = TILE / THREADS;     // runs a thread walks at most
constexpr int64_t LANES_MAX = 4096;      // the largest N of the lane kernel
constexpr int LANE_THREADS = 256;
constexpr int64_t NARROW_REF = int64_t(1) << 31;
constexpr int64_t WIDE_START = int64_t(1) << 62;
constexpr unsigned FULL = 0xffffffffu;
constexpr int64_t REFILL_NS = 1000000;   // the 1 ms refill tick
// floor(x / 10^6) = umulhi(x, REFILL_MAGIC) >> 18 for every x < 2^64:
// REFILL_MAGIC = ceil(2^82 / 10^6), and REFILL_MAGIC * 10^6 - 2^82 <= 2^18
// (Granlund and Montgomery, theorem 4.2)
constexpr uint64_t REFILL_MAGIC = 0x431BDE82D7B634DBull;
constexpr int REFILL_SHIFT = 18;

// floor(a / 10^6) for any int64 a (a < 0 through ~a = -a - 1)
__device__ __forceinline__ int64_t floor_refill(int64_t a) {
  const uint64_t s = (uint64_t)(a >> 63);
  const uint64_t x = (uint64_t)a ^ s;
  return (int64_t)((__umul64hi(x, REFILL_MAGIC) >> REFILL_SHIFT) ^ s);
}

__device__ __forceinline__ int64_t floor_div(int64_t a, int64_t b) {
  const int64_t q = a / b;
  return (q * b != a && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// the same out of line: a tiled step's packet off the 32-bit path
__device__ __noinline__ int64_t floor_div_wide(int64_t a, int64_t b) {
  return floor_div(a, b);
}

__device__ __forceinline__ int64_t clamp_row(int64_t r, int64_t h) {
  return r < 0 ? 0 : (r >= h ? h - 1 : r);
}

// Exact unsigned 32-bit division by an invariant d in [1, 2^31)
// (Granlund and Montgomery, PLDI 1994, figure 4.1).
struct Recip {
  uint32_t m;
  int s1, s2;

  __device__ void init(uint32_t d) {
    const int l = d > 1 ? 32 - __clz(d - 1) : 0;  // ceil(log2 d)
    // m = floor(2^32 (2^l - d) / d) + 1: the quotient num / d < 2^32 by a
    // double reciprocal (num, d exact; the product within 2^-20 of it), so
    // its truncation is the floor or one off either way, then fixed
    const uint64_t num = (uint64_t)((1ull << l) - d) << 32;
    uint64_t q = (uint64_t)((double)num * __drcp_rn((double)d));
    if (q * d > num) --q;
    else if ((q + 1) * d <= num) ++q;
    m = (uint32_t)(q + 1);
    s1 = l < 1 ? l : 1;
    s2 = l > 1 ? l - 1 : 0;
  }

  __device__ __forceinline__ uint32_t div(uint32_t u) const {
    const uint32_t t = __umulhi(m, u);
    return (t + ((u - t) >> s1)) >> s2;
  }
};

// One host run's carry and its fixed values.
struct Run {
  int64_t ref, cap, klim, tok, tick, prev, pstick;
  bool narrow;
  Recip rc;

  __device__ void init(int64_t ref0, int64_t cap0, int64_t tok0,
                       int64_t arr0) {
    ref = ref0 > 1 ? ref0 : 1;
    cap = cap0;
    tok = tok0;
    tick = floor_refill(arr0);
    prev = 0;
    pstick = 0;  // the stick of prev
    narrow = ref < NARROW_REF;
    klim = (int64_t(1) << 32) - ref;  // kneed + ref - 1 < 2^32
    rc.init(narrow ? (uint32_t)ref : 1u);
  }

  __device__ __forceinline__ int64_t finish(int64_t start, int64_t stick,
                                            int64_t avail, int64_t kneed,
                                            int64_t size, int64_t k) {
    const int64_t admit = kneed > 0 ? (stick + k) * REFILL_NS : start;
    const int64_t refilled = avail + k * ref;
    tok = (refilled < cap ? refilled : cap) - size;
    tick = kneed > 0 ? stick + k : stick;
    prev = admit;
    return admit;
  }

  // one valid packet; astick = floor(arr / 10^6), computed off the chain
  __device__ __forceinline__ int64_t step(int64_t size, int64_t arr,
                                          int64_t astick) {
    const bool later = arr >= prev;
    const int64_t start = later ? arr : prev;
    const int64_t stick = later ? astick : pstick;
    int64_t avail = tok + ref * (stick - tick);
    avail = avail < cap ? avail : cap;
    int64_t kneed = size - avail;
    kneed = kneed > 0 ? kneed : 0;
    if (narrow && kneed <= klim && start > -WIDE_START &&
        start < WIDE_START) {
      const int64_t k = rc.div((uint32_t)(kneed + ref - 1));
      const int64_t admit = finish(start, stick, avail, kneed, size, k);
      pstick = tick;
      return admit;
    }
    const int64_t k = floor_div_wide(kneed + ref - 1, ref);
    const int64_t admit = finish(start, stick, avail, kneed, size, k);
    pstick = floor_refill(admit);
    return admit;
  }
};

// ``run`` (host ``d``) over a staged window of ``e`` lanes, lane k of the
// window being lane g0 + k of the batch: skips invalid lanes, stops at a
// valid lane of another dst (returns true).
__device__ __forceinline__ bool walk(Run& run, int32_t d, int e, int64_t g0,
                                     const int64_t* __restrict__ s_size,
                                     const int64_t* __restrict__ s_arr,
                                     const int32_t* __restrict__ s_dst,
                                     const uint8_t* __restrict__ s_valid,
                                     int64_t* __restrict__ admits) {
  for (int k = 0; k < e; ++k) {
    if (!s_valid[k]) continue;
    if (s_dst[k] != d) return true;
    admits[g0 + k] = run.step(s_size[k], s_arr[k], floor_refill(s_arr[k]));
  }
  return false;
}

// Exclusive block sum-scan of one int a thread; ``total`` gets the
// block's sum.  Ends with a barrier, so it can be called again.
__device__ int block_sum(int x, int* total) {
  __shared__ int s_warp[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    if (w < warp) before += s_warp[w];
    all += s_warp[w];
  }
  *total = all;
  __syncthreads();
  return before + inc - x;
}

__global__ void __launch_bounds__(THREADS)
admit_sorted_kernel(const int32_t* __restrict__ dst,
                    const int64_t* __restrict__ sizes,
                    const int64_t* __restrict__ arrive,
                    const uint8_t* __restrict__ valid,
                    const int64_t* __restrict__ tokens0,
                    const int64_t* __restrict__ refill,
                    const int64_t* __restrict__ capacity, int64_t n,
                    int64_t h, bool aligned, int64_t* __restrict__ admits) {
  // the span's valid lanes, compacted in order: the tile's, then the
  // halo's; each one's floor(arrive / 10^6) and its lane in the span
  __shared__ __align__(16) int64_t c_size[SPAN];
  __shared__ __align__(16) int64_t c_arr[SPAN];
  __shared__ __align__(16) int64_t c_astick[SPAN];
  __shared__ int32_t c_dst[SPAN];
  __shared__ int16_t c_lane[SPAN];
  __shared__ int16_t s_open[TILE];  // the runs' first positions
  // past the span: windows of HALO lanes, as they are
  __shared__ __align__(16) int64_t w_size[HALO];
  __shared__ __align__(16) int64_t w_arr[HALO];
  __shared__ int32_t w_dst[HALO];
  __shared__ uint8_t w_valid[HALO];
  __shared__ int s_has_prev, s_look, s_more, s_end;
  __shared__ int32_t s_prev_dst;

  const int tid = threadIdx.x, lane = tid & 31;
  const int64_t t0 = (int64_t)blockIdx.x * TILE;
  const int64_t left = n - t0;
  const int count = (int)(left < TILE ? left : TILE);      // the tile
  const int span = (int)(left < SPAN ? left : SPAN);       // and its halo
  const int base = tid * LANES;

  // One round trip: the thread's LANES lanes of the span and, for warp 0,
  // the 32 lanes before the tile, all loaded before any is used.
  int64_t sz[LANES], ar[LANES];
  int32_t dd[LANES];
  bool vv[LANES];
  const int64_t g0 = t0 + base;
  if (aligned && base + LANES <= span) {
    const longlong2 s01 = *reinterpret_cast<const longlong2*>(sizes + g0);
    const longlong2 s23 = *reinterpret_cast<const longlong2*>(sizes + g0 + 2);
    const longlong2 a01 = *reinterpret_cast<const longlong2*>(arrive + g0);
    const longlong2 a23 =
        *reinterpret_cast<const longlong2*>(arrive + g0 + 2);
    const int4 d4 = *reinterpret_cast<const int4*>(dst + g0);
    const uint32_t v4 = *reinterpret_cast<const uint32_t*>(valid + g0);
    sz[0] = s01.x, sz[1] = s01.y, sz[2] = s23.x, sz[3] = s23.y;
    ar[0] = a01.x, ar[1] = a01.y, ar[2] = a23.x, ar[3] = a23.y;
    dd[0] = d4.x, dd[1] = d4.y, dd[2] = d4.z, dd[3] = d4.w;
#pragma unroll
    for (int u = 0; u < LANES; ++u) vv[u] = (v4 >> (8 * u)) & 0xff;
  } else {
#pragma unroll
    for (int u = 0; u < LANES; ++u) {
      const bool in = base + u < span;
      vv[u] = in && valid[g0 + u];
      dd[u] = in ? dst[g0 + u] : 0;
      sz[u] = in ? sizes[g0 + u] : 0;
      ar[u] = in ? arrive[g0 + u] : 0;
    }
  }
  const int64_t gb = t0 - 32 + lane;
  const bool bv = tid < 32 && gb >= 0 && valid[gb];
  const int32_t bd = bv ? dst[gb] : 0;

  int n_valid = 0, n_own = 0;
#pragma unroll
  for (int u = 0; u < LANES; ++u) {
    vv[u] = vv[u] && base + u < span;
    const bool own = base + u < count;
    n_valid += vv[u];
    n_own += vv[u] && own;
    if (own && !vv[u]) admits[g0 + u] = 0;  // invalid: 0, from its tile
  }
  // the last valid lane before the tile, if among those 32
  if (tid < 32) {
    const unsigned m = __ballot_sync(FULL, bv);
    const int32_t pd = __shfl_sync(FULL, bd, m ? 31 - __clz(m) : 0);
    if (lane == 0) {
      s_has_prev = m != 0;
      s_prev_dst = pd;
      s_look = m == 0 && t0 > 32;
      s_more = 0;
    }
  }

  // compact the span's valid lanes: one block sum-scan of the two counts
  // (the tile's in the high half) gives each its position and the tile's
  // valid lanes the first positions
  int totals;
  const int first = block_sum(n_valid + (n_own << 16), &totals) & 0xffff;
  const int n_span = totals & 0xffff, n_tile = totals >> 16;
  if (n_tile == 0) return;  // no valid lane of its own: only zeros
  if (tid == 0) s_end = n_span;
  int pos = first;
#pragma unroll
  for (int u = 0; u < LANES; ++u) {
    if (!vv[u]) continue;
    c_size[pos] = sz[u];
    c_arr[pos] = ar[u];
    c_astick[pos] = floor_refill(ar[u]);
    c_dst[pos] = dd[u];
    c_lane[pos] = (int16_t)(base + u);
    ++pos;
  }
  if (s_look && tid < 32) {
    // all 32 lanes before the tile are invalid: look on, 32 a step
    int64_t found = -1;
    for (int64_t top = t0 - 32; top > 0; top -= 32) {
      const int64_t k = top - 32 + lane;
      const unsigned m = __ballot_sync(FULL, k >= 0 && valid[k]);
      if (m) {
        found = top - 32 + (31 - __clz(m));
        break;
      }
    }
    if (lane == 0) {
      s_has_prev = found >= 0;
      s_prev_dst = found >= 0 ? dst[found] : 0;
    }
  }
  __syncthreads();

  // the runs: a valid tile lane opens one when its dst differs from the
  // previous valid lane's (or there is none); a second sum-scan lists
  // them, so each run's packets are [its opener, the next) in compacted
  // order, the last run's up to the first halo lane of another dst
  bool opens[LANES];
  int n_open = 0;
  pos = first;
#pragma unroll
  for (int u = 0; u < LANES; ++u) {
    opens[u] = vv[u] && pos < n_tile &&
               !(pos > 0 ? c_dst[pos - 1] == dd[u]
                         : s_has_prev && s_prev_dst == dd[u]);
    n_open += opens[u];
    pos += vv[u];
  }
  // the last run's end: the first halo position of another dst
  for (int p = n_tile + tid; p < n_span; p += THREADS)
    if (c_dst[p] != c_dst[p - 1]) atomicMin(&s_end, p);
  int runs;
  const int q0 = block_sum(n_open, &runs);
  pos = first;
  int q = q0;
#pragma unroll
  for (int u = 0; u < LANES; ++u) {
    if (opens[u]) s_open[q++] = (int16_t)pos;
    pos += vv[u];
  }
  __syncthreads();

  // Thread p walks runs p, p + THREADS, ...: a known count of compacted
  // packets each, every packet's loads ahead of the step before it.  The
  // tables of all of a thread's runs are loaded at once, one round trip.
  int64_t t_ref[RUNS], t_cap[RUNS], t_tok[RUNS];
#pragma unroll
  for (int i = 0; i < RUNS; ++i) {
    const int p = tid + i * THREADS;
    const int64_t r = p < runs ? clamp_row(c_dst[s_open[p]], h) : 0;
    t_ref[i] = p < runs ? refill[r] : 1;
    t_cap[i] = p < runs ? capacity[r] : 0;
    t_tok[i] = p < runs ? tokens0[r] : 0;
  }
  Run run;
  int32_t d = 0;
  bool more = false;  // this thread's run goes on past the span
#pragma unroll
  for (int i = 0; i < RUNS; ++i) {
    const int p = tid + i * THREADS;
    if (p >= runs) break;
    const int j = s_open[p];
    const int e = p + 1 < runs ? s_open[p + 1] : s_end;
    d = c_dst[j];
    run.init(t_ref[i], t_cap[i], t_tok[i], c_arr[j]);
    int64_t nsz = c_size[j], nar = c_arr[j], nst = c_astick[j];
    int nl = c_lane[j];
    for (int k = j; k < e; ++k) {
      const int64_t ksz = nsz, kar = nar, kst = nst;
      const int kl = nl;
      if (k + 1 < e) {
        nsz = c_size[k + 1];
        nar = c_arr[k + 1];
        nst = c_astick[k + 1];
        nl = c_lane[k + 1];
      }
      admits[t0 + kl] = run.step(ksz, kar, kst);
    }
    more = e == n_span && left > SPAN;
  }
  // past the span (the last run reaches its end): windows of HALO lanes
  // that the block stages, walked by the run's thread
  if (more) s_more = 1;
  __syncthreads();
  for (int64_t w0 = t0 + SPAN; s_more; w0 += HALO) {
    const int wn = (int)(n - w0 < HALO ? n - w0 : HALO);
    if (tid < wn) {
      w_size[tid] = sizes[w0 + tid];
      w_arr[tid] = arrive[w0 + tid];
      w_dst[tid] = dst[w0 + tid];
      w_valid[tid] = valid[w0 + tid];
    }
    __syncthreads();
    if (more) {
      more = !walk(run, d, wn, w0, w_size, w_arr, w_dst, w_valid, admits) &&
             w0 + wn < n;
      s_more = more;
    }
    __syncthreads();
  }
}

// A thread a lane, for a batch of at most LANES_MAX.
__global__ void __launch_bounds__(LANE_THREADS)
admit_sorted_kernel_lanes(const int32_t* __restrict__ dst,
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
  const cudaStream_t s = (cudaStream_t)stream;
  if (n <= LANES_MAX) {
    const int64_t blocks = (n + LANE_THREADS - 1) / LANE_THREADS;
    admit_sorted_kernel_lanes<<<(unsigned)blocks, LANE_THREADS, 0, s>>>(
        (const int32_t*)dst, (const int64_t*)sizes, (const int64_t*)arrive,
        (const uint8_t*)valid, (const int64_t*)tokens0,
        (const int64_t*)refill, (const int64_t*)capacity, n, h,
        (int64_t*)admits);
    return (int)cudaGetLastError();
  }
  const int64_t blocks = (n + TILE - 1) / TILE;
  // the vector loads need 16-byte sizes, arrive and dst and 4-byte valid
  const bool aligned = ((uintptr_t)sizes % 16 | (uintptr_t)arrive % 16 |
                        (uintptr_t)dst % 16 | (uintptr_t)valid % 4) == 0;
  admit_sorted_kernel<<<(unsigned)blocks, THREADS, 0, s>>>(
      (const int32_t*)dst, (const int64_t*)sizes, (const int64_t*)arrive,
      (const uint8_t*)valid, (const int64_t*)tokens0, (const int64_t*)refill,
      (const int64_t*)capacity, n, h, aligned, (int64_t*)admits);
  return (int)cudaGetLastError();
}
