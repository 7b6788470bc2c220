// pack_flush: the device traffic plane's packed flush buffer, one tiled
// compaction spread over the card, for Hopper (sm_90a).  Three entries
// share one device body:
//
// * serial: replaces the JAX package's shadow_tpu/ops/torcells_device.py
//   :337 (_pack_flush_jnp), called by _step_span_flush_impl :512 after the
//   span step.  Plain torch version: shadow_tpu_torch/ops/torcells_device.py
//   :pack_flush_torch.
// * batched: the flush half of torcells_device.py:586
//   torcells_step_span_flush_batched (_pack_flush_jnp under jax.vmap),
//   after csrc/torcells_span_batched.cu.  Plain torch version:
//   torcells_device.py:pack_flush_batched_torch.
// * mesh: the flush half of shadow_tpu/parallel/mesh/exchange.py:473
//   make_mesh_span_flush (its step_flush :502-518: the gathers through
//   last_flow_pad, global_sent through node_src, _pack_flush_jnp with its
//   caps, and the trailing slot), after csrc/mesh_span.cu.  Plain torch
//   version: shadow_tpu_torch/parallel/mesh/exchange.py:mesh_span_flush_torch
//   (its flush half: global_sent_torch, pack_flush_torch, the cross slot).
// Each agrees with its plain version bit for bit.
//
// Output row, int64 [5 + 2cc + 2hh] (cc = min(cap_chains, C), hh likewise;
// no caps means cc = C, hh = H; the mesh row has one more slot):
//   [0] forwards, [1] delivered sum, [2] n_done, [3] n_touched, [4] t_stop
//   [5        : 5+n]        chains c with newly[c], ascending
//   [5+cc     : 5+cc+n]     their done_last[c]
//   [5+2cc    : 5+2cc+m]    nodes h with sent_delta[h] != 0, ascending
//   [5+2cc+hh : 5+2cc+hh+m] their sent_delta[h]
//   (mesh) [5+2cc+2hh]      cross
// and zeros elsewhere.  The header counts are the TRUE counts; entries
// whose position is past a cap are not written (the JAX scatter's "drop"
// mode), so the host can tell a capped buffer lost entries.  How a lane is
// read differs by entry:
//   serial  newly[c], done_last[c]; delta[n] = sent_delta[n]
//   batched newly[c] = done_tick[last_flow[c]] >= 0 && done_in[c] < 0,
//           delta[n] = node_sent[n] - sent_in[n], per lane w of W;
//           [0] = sum(delta) / CELL (each served cell added one CELL to its
//           node's node_sent), [1] = sum of delivered[last_flow], and
//           forwards[w] = [0]
//   mesh    newly as batched; delta[n] = node_sent[slot] - sent_in[slot],
//           slot = node_slot[n] (0 for a node on no shard; each node lives
//           on one shard, so the JAX scatter-add through node_src is this
//           gather); [1] = sum of delivered[last_flow]
//
// Design.  Ascending order needs each selected lane's rank among the
// selected lanes: an exclusive scan, not atomics (whose order would vary).
// The C chain lanes and the H node lanes of each flush are cut into tiles
// of TILE = 1,024 lanes (256 threads x 4 contiguous lanes), and the W
// flushes' tiles into one list that the blocks of ONE cooperative launch
// take grid-strided (at tor10k width 20 + 30 = 50 tiles, 50 SMs issuing
// their loads at once; at the sweep's class, W = 8, 512).
//   1. Per tile: load the lanes, compute the selection and value, one block
//      scan of the threads' counts; the tile's count and partial sum
//      (delivered or sent bytes, int64, exact in any order) go to a small
//      per-tile array.  A block keeps its first tile's lanes and ranks in
//      registers; a later tile of the same block (only when the tiles
//      outnumber the co-resident blocks) is read again in pass 2.
//   2. One grid sync.  Each block reads its flush's per-tile counts in a
//      fixed order: its tile's base (the counts of the earlier tiles of its
//      own array) and the totals.  No atomics decide a position, so the
//      buffer is the same on every run.
//   3. Each selected lane writes its index and value at base + rank when
//      that is below the cap; each position p of a tile's own lane range
//      with total <= p < cap gets its zeros.  Every position is written
//      exactly once, so the buffer needs no zero fill first.  Thread 0 of
//      a flush's tile 0 writes the header.
// Each entry is its own kernel around the one body (pack_body), held to
// 64 registers so that four blocks fit an SM: 528 co-resident blocks, a
// block a tile at the sweep's class.
// The grid sync was chosen over a single-pass decoupled look-back: the
// zero tail and the header need each array's TOTAL, which a look-back
// gives only to the last tile, and a look-back's status words would need a
// reset before every launch.  The grid is at most the co-resident blocks,
// as a cooperative launch requires.
//
// Bound.  Serial: C bools + 8C + 8H bytes read and 8 (5 + 2C + 2H)
// written, ~1.2 MB at tor10k width (C = 20,000, H = 30,494), well under a
// microsecond at HBM rate.  What is left is one launch, two or three
// exposed load latencies (two deep through last_flow and node_slot), the
// block scans and the grid sync.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

namespace cg = cooperative_groups;

constexpr int THREADS = 256;
constexpr int LANES = 4;  // contiguous lanes a thread
constexpr int64_t TILE = THREADS * LANES;
constexpr int WARPS = THREADS / 32;
constexpr int HEADER = 5;
constexpr int64_t PACK_CELL_WIRE_BYTES = 512 + 66;  // core/defs.py

struct Dims {
  int64_t c, h;     // chain and node lanes of one flush
  int64_t cc, hh;   // the caps (cc <= c, hh <= h)
  int64_t row;      // one flush's row stride in buf
  int64_t tc, th;   // chain and node tiles of one flush
  int64_t nt;       // tiles of one flush: max(1, tc + th)
  int64_t n_tiles;  // W * nt
  int64_t* counts;  // [n_tiles] selected lanes of each tile
  int64_t* sums;    // [n_tiles] each tile's partial sum
};

// ---- how a lane is read: one struct per entry -----------------------------
// chain()/node() return the lane's selection and set its value; they add
// the lane's share of the tile's partial sum to `sum` (delivered for a
// chain, sent bytes for a node) where the entry's header needs it.

struct SerialSrc {
  const int64_t* forwards;
  const int64_t* delivered_sum;
  const int64_t* t_stop;
  const uint8_t* newly;
  const int64_t* done_last;
  const int64_t* sent_delta;

  __device__ bool chain(const Dims&, int64_t, int64_t i, int64_t& v,
                        int64_t&) const {
    v = done_last[i];
    return newly[i] != 0;
  }
  __device__ bool node(const Dims&, int64_t, int64_t i, int64_t& v,
                       int64_t&) const {
    v = sent_delta[i];
    return v != 0;
  }
  __device__ void header(const Dims&, int64_t, int64_t* out, int64_t n_done,
                         int64_t n_touched, int64_t, int64_t) const {
    out[0] = *forwards;
    out[1] = *delivered_sum;
    out[2] = n_done;
    out[3] = n_touched;
    out[4] = *t_stop;
  }
};

struct BatchedSrc {
  const int64_t* t_stop;     // [W]
  const int64_t* done_in;    // [W, C]
  const int64_t* done_tick;  // [W, F]
  const int64_t* last_flow;  // [W, C]
  const int64_t* delivered;  // [W, F]
  const int64_t* sent_in;    // [W, H]
  const int64_t* node_sent;  // [W, H]
  int64_t* forwards;         // [W]
  int64_t f;

  __device__ bool chain(const Dims& d, int64_t w, int64_t i, int64_t& v,
                        int64_t& sum) const {
    const int64_t k = w * f + last_flow[w * d.c + i];
    v = done_tick[k];
    sum += delivered[k];
    return v >= 0 && done_in[w * d.c + i] < 0;
  }
  __device__ bool node(const Dims& d, int64_t w, int64_t i, int64_t& v,
                       int64_t& sum) const {
    v = node_sent[w * d.h + i] - sent_in[w * d.h + i];
    sum += v;
    return v != 0;
  }
  __device__ void header(const Dims&, int64_t w, int64_t* out,
                         int64_t n_done, int64_t n_touched, int64_t dsum,
                         int64_t bytes) const {
    const int64_t fwd = bytes / PACK_CELL_WIRE_BYTES;
    out[0] = fwd;
    out[1] = dsum;
    out[2] = n_done;
    out[3] = n_touched;
    out[4] = t_stop[w];
    forwards[w] = fwd;
  }
};

struct MeshSrc {
  const int64_t* t_stop;
  const int64_t* forwards;
  const int64_t* cross;
  const int64_t* done_tick;  // [D * pad]
  const int64_t* delivered;  // [D * pad]
  const int64_t* node_sent;  // [D * h_pad]
  const int64_t* done_in;    // [C]
  const int64_t* sent_in;    // [D * h_pad]
  const int64_t* last_flow;  // [C]
  const int64_t* node_slot;  // [H], -1 for a node on no shard

  __device__ bool chain(const Dims&, int64_t, int64_t i, int64_t& v,
                        int64_t& sum) const {
    const int64_t k = last_flow[i];
    v = done_tick[k];
    sum += delivered[k];
    return v >= 0 && done_in[i] < 0;
  }
  __device__ bool node(const Dims&, int64_t, int64_t i, int64_t& v,
                       int64_t&) const {
    const int64_t s = node_slot[i];
    v = s >= 0 ? node_sent[s] - sent_in[s] : 0;
    return v != 0;
  }
  __device__ void header(const Dims& d, int64_t, int64_t* out,
                         int64_t n_done, int64_t n_touched, int64_t dsum,
                         int64_t) const {
    out[0] = *forwards;
    out[1] = dsum;
    out[2] = n_done;
    out[3] = n_touched;
    out[4] = *t_stop;
    out[HEADER + 2 * d.cc + 2 * d.hh] = *cross;
  }
};

// ---- the tiled compaction ---------------------------------------------------

// tile ti of the W flushes' list: flush w, chains (k < tc) or nodes
struct Where {
  int64_t w, k;     // flush, tile within the flush
  bool chains;
  int64_t lo, n;    // first lane, lanes of the array
};

__device__ __forceinline__ Where where(const Dims& d, int64_t ti) {
  Where p;
  p.w = ti / d.nt;
  p.k = ti - p.w * d.nt;
  p.chains = p.k < d.tc;
  p.lo = (p.chains ? p.k : p.k - d.tc) * TILE;
  p.n = p.chains ? d.c : d.h;
  return p;
}

struct Tile {
  int64_t v[LANES];
  unsigned sel;  // bit j: lane j of this thread is selected
  int rank;      // selected lanes of the tile before this thread's
};

// a thread's lanes of tile p, its count, its share of the partial sum
template <class Src>
__device__ __forceinline__ int load(const Src& src, const Dims& d,
                                    const Where& p, Tile& t, int64_t& sum) {
  const int64_t i0 = p.lo + (int64_t)threadIdx.x * LANES;
  t.sel = 0;
  sum = 0;
#pragma unroll
  for (int j = 0; j < LANES; ++j) {
    t.v[j] = 0;
    const int64_t i = i0 + j;
    if (i < p.n) {
      const bool s = p.chains ? src.chain(d, p.w, i, t.v[j], sum)
                              : src.node(d, p.w, i, t.v[j], sum);
      t.sel |= (unsigned)s << j;
    }
  }
  return __popc(t.sel);
}

// exclusive scan of the threads' counts over the block, and the block's
// sum of the threads' partial sums; *count and *sum_total get the totals
__device__ __forceinline__ int scan_count(int v, int64_t s, int* count,
                                          int64_t* sum_total) {
  __shared__ int warp_n[WARPS];
  __shared__ int64_t warp_s[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
  if (lane == 31) warp_n[warp] = x;
  if (lane == 0) warp_s[warp] = s;
  __syncthreads();
  int base = 0, tot = 0;
  int64_t st = 0;
#pragma unroll
  for (int k = 0; k < WARPS; ++k) {
    const int n = warp_n[k];
    base += k < warp ? n : 0;
    tot += n;
    st += warp_s[k];
  }
  *count = tot;
  *sum_total = st;
  __syncthreads();  // the shared words are reused by the next call
  return base + x - v;
}

// after the grid sync: from flush w's per-tile counts and sums, read in a
// fixed order, the tile's base (the counts of the earlier tiles of its own
// array) and the flush's totals
struct Totals {
  int64_t base;
  int64_t n_chains, n_nodes;      // selected lanes
  int64_t sum_chains, sum_nodes;  // the partial sums
};

// each warp's sum of v into part[warp]
__device__ __forceinline__ void warp_sums(int64_t v, int64_t* part) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
}

__device__ __forceinline__ Totals flush_totals(const Dims& d, const Where& p) {
  __shared__ int64_t part[5][WARPS];
  int64_t base = 0, nc = 0, nn = 0, sc = 0, sn = 0;
  const int64_t row0 = p.w * d.nt;
  for (int64_t j = threadIdx.x; j < d.tc + d.th; j += THREADS) {
    // written by other blocks before the grid sync: read past L1
    const int64_t n = __ldcg((const long long*)d.counts + row0 + j);
    const int64_t s = __ldcg((const long long*)d.sums + row0 + j);
    const bool ch = j < d.tc;
    if (ch == p.chains && j < p.k) base += n;
    if (ch) {
      nc += n;
      sc += s;
    } else {
      nn += n;
      sn += s;
    }
  }
  warp_sums(base, part[0]);
  warp_sums(nc, part[1]);
  warp_sums(nn, part[2]);
  warp_sums(sc, part[3]);
  warp_sums(sn, part[4]);
  __syncthreads();
  Totals t = {0, 0, 0, 0, 0};
#pragma unroll
  for (int k = 0; k < WARPS; ++k) {
    t.base += part[0][k];
    t.n_chains += part[1][k];
    t.n_nodes += part[2][k];
    t.sum_chains += part[3][k];
    t.sum_nodes += part[4][k];
  }
  __syncthreads();
  return t;
}

// the one device body of the three entries
template <class Src>
__device__ __forceinline__ void pack_body(const Src& src, const Dims& d,
                                          int64_t* buf) {
  cg::grid_group grid = cg::this_grid();

  // 1. every tile's count and partial sum; the block's first tile stays in
  //    registers
  Tile first;
  first.sel = 0;
  for (int64_t ti = blockIdx.x; ti < d.n_tiles; ti += gridDim.x) {
    const Where p = where(d, ti);
    Tile t;
    int64_t s;
    const int n = load(src, d, p, t, s);
    int count;
    int64_t sum;
    t.rank = scan_count(n, s, &count, &sum);
    if (threadIdx.x == 0) {
      d.counts[ti] = count;
      d.sums[ti] = sum;
    }
    if (ti == blockIdx.x) first = t;
  }

  // 2. the one grid-wide dependency
  grid.sync();

  // 3. the scatter under the caps, the zero tail, the header
  for (int64_t ti = blockIdx.x; ti < d.n_tiles; ti += gridDim.x) {
    const Where p = where(d, ti);
    Tile t;
    if (ti == blockIdx.x) {
      t = first;
    } else {
      int64_t s;
      const int n = load(src, d, p, t, s);
      int count;
      int64_t sum;
      t.rank = scan_count(n, s, &count, &sum);
    }
    const Totals tot = flush_totals(d, p);
    int64_t* out = buf + p.w * d.row;
    const int64_t cap = p.chains ? d.cc : d.hh;
    const int64_t total = p.chains ? tot.n_chains : tot.n_nodes;
    int64_t* idx = out + HEADER + (p.chains ? 0 : 2 * d.cc);
    int64_t* val = idx + cap;
    const int64_t i0 = p.lo + (int64_t)threadIdx.x * LANES;
    int64_t pos = tot.base + t.rank;
#pragma unroll
    for (int j = 0; j < LANES; ++j) {
      const int64_t i = i0 + j;
      if ((t.sel >> j) & 1u) {
        if (pos < cap) {
          idx[pos] = i;
          val[pos] = t.v[j];
        }
        ++pos;
      }
      // position i (the lane's own number) is zero past the true count
      if (i >= total && i < cap) {
        idx[i] = 0;
        val[i] = 0;
      }
    }
    if (p.k == 0 && threadIdx.x == 0)
      src.header(d, p.w, out, tot.n_chains, tot.n_nodes, tot.sum_chains,
                 tot.sum_nodes);
  }
}

// one kernel an entry, each named as the traces know it; four blocks an SM
// (at most 64 registers), so that 528 blocks are co-resident and the
// sweep's 512 tiles get a block each
__global__ void __launch_bounds__(THREADS, 4)
pack_flush_kernel(const SerialSrc src, const Dims d, int64_t* buf) {
  pack_body(src, d, buf);
}

__global__ void __launch_bounds__(THREADS, 4)
pack_flush_batched_kernel(const BatchedSrc src, const Dims d, int64_t* buf) {
  pack_body(src, d, buf);
}

__global__ void __launch_bounds__(THREADS, 4)
pack_flush_mesh_kernel(const MeshSrc src, const Dims d, int64_t* buf) {
  pack_body(src, d, buf);
}

// fills the shape words of `d`; false when the scratch does not hold
// n_tiles counts and sums
bool make_dims(Dims& d, int64_t w, int64_t c, int64_t h, int64_t cc,
               int64_t hh, int64_t row, void* scratch, int64_t n_scratch) {
  if (w < 1 || c < 0 || h < 0 || cc < 0 || cc > c || hh < 0 || hh > h)
    return false;
  d.c = c;
  d.h = h;
  d.cc = cc;
  d.hh = hh;
  d.row = row;
  d.tc = (c + TILE - 1) / TILE;
  d.th = (h + TILE - 1) / TILE;
  d.nt = d.tc + d.th > 0 ? d.tc + d.th : 1;
  d.n_tiles = w * d.nt;
  if (n_scratch != d.n_tiles) return false;
  d.counts = (int64_t*)scratch;
  d.sums = d.counts + d.n_tiles;
  return true;
}

// one cooperative launch: every tile's block if they are co-resident, else
// as many blocks as are
template <class Src>
int launch(void (*kernel)(Src, Dims, int64_t*), const Src& src,
           const Dims& d, void* buf, void* stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  int64_t grid = d.n_tiles;
  const int64_t cap = (int64_t)per_sm * sms;
  if (grid > cap) grid = cap;
  Src s = src;
  Dims dd = d;
  int64_t* b = (int64_t*)buf;
  void* args[] = {&s, &dd, &b};
  err = cudaLaunchCooperativeKernel((const void*)kernel,
                                    dim3((unsigned)grid), dim3(THREADS),
                                    args, 0, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// Each entry launches on `stream` (a cudaStream_t passed as a pointer) and
// does not synchronise.  `scratch` is int64 [2 * n_tiles] (the per-tile
// counts, then sums; n_tiles = W * max(1, ceil(C / 1024) + ceil(H / 1024)),
// the wrapper's flush_tiles); the kernel writes every word of it before
// reading any.  Returns 0 when the launch was accepted, else the CUDA
// error.

extern "C" int pack_flush_launch(const void* forwards,
                                 const void* delivered_sum,
                                 const void* t_stop, const void* newly,
                                 const void* done_last,
                                 const void* sent_delta, void* buf,
                                 int64_t c, int64_t h, int64_t cc,
                                 int64_t hh, void* scratch,
                                 int64_t n_scratch, void* stream) {
  Dims d;
  if (!make_dims(d, 1, c, h, cc, hh, HEADER + 2 * cc + 2 * hh, scratch,
                 n_scratch))
    return (int)cudaErrorInvalidValue;
  SerialSrc src;
  src.forwards = (const int64_t*)forwards;
  src.delivered_sum = (const int64_t*)delivered_sum;
  src.t_stop = (const int64_t*)t_stop;
  src.newly = (const uint8_t*)newly;
  src.done_last = (const int64_t*)done_last;
  src.sent_delta = (const int64_t*)sent_delta;
  return launch(pack_flush_kernel, src, d, buf, stream);
}

// One row of buf [W, 5 + 2C + 2H] and one forwards[w] per lane w, no caps.
extern "C" int pack_flush_batched_launch(
    const void* t_stop, const void* done_in, const void* done_tick,
    const void* last_flow, const void* delivered, const void* sent_in,
    const void* node_sent, void* buf, void* forwards, int64_t w, int64_t f,
    int64_t c, int64_t h, void* scratch, int64_t n_scratch, void* stream) {
  Dims d;
  if (!make_dims(d, w, c, h, c, h, HEADER + 2 * c + 2 * h, scratch,
                 n_scratch))
    return (int)cudaErrorInvalidValue;
  BatchedSrc src;
  src.t_stop = (const int64_t*)t_stop;
  src.done_in = (const int64_t*)done_in;
  src.done_tick = (const int64_t*)done_tick;
  src.last_flow = (const int64_t*)last_flow;
  src.delivered = (const int64_t*)delivered;
  src.sent_in = (const int64_t*)sent_in;
  src.node_sent = (const int64_t*)node_sent;
  src.forwards = (int64_t*)forwards;
  src.f = f;
  return launch(pack_flush_batched_kernel, src, d, buf, stream);
}

// buf [5 + 2cc + 2hh + 1]: the caps as in the serial entry (cc = c and
// hh = h for none), the cross slot last.
extern "C" int pack_flush_mesh_launch(
    const void* t_stop, const void* forwards, const void* cross,
    const void* done_tick, const void* delivered, const void* node_sent,
    const void* done_in, const void* sent_in, void* buf,
    const void* last_flow, const void* node_slot, int64_t c, int64_t h,
    int64_t cc, int64_t hh, void* scratch, int64_t n_scratch,
    void* stream) {
  Dims d;
  if (!make_dims(d, 1, c, h, cc, hh, HEADER + 2 * cc + 2 * hh + 1, scratch,
                 n_scratch))
    return (int)cudaErrorInvalidValue;
  MeshSrc src;
  src.t_stop = (const int64_t*)t_stop;
  src.forwards = (const int64_t*)forwards;
  src.cross = (const int64_t*)cross;
  src.done_tick = (const int64_t*)done_tick;
  src.delivered = (const int64_t*)delivered;
  src.node_sent = (const int64_t*)node_sent;
  src.done_in = (const int64_t*)done_in;
  src.sent_in = (const int64_t*)sent_in;
  src.last_flow = (const int64_t*)last_flow;
  src.node_slot = (const int64_t*)node_slot;
  return launch(pack_flush_mesh_kernel, src, d, buf, stream);
}
