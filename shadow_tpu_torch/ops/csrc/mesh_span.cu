// mesh_span: one superwindow of the sharded (mesh) traffic plane, all D
// shards in one persistent cooperative launch, a thread per flow, for
// Hopper (sm_90a).
//
// Replaces the JAX package's mesh step shadow_tpu/parallel/mesh/exchange.py
// :247 (make_mesh_span_raw -> shard_body, a shard_map over D devices with
// one all_to_all, or one ppermute per leg, and one psum a tick), the span
// half of make_mesh_span_flush :473.  The plain torch version of the same
// function is shadow_tpu_torch/parallel/mesh/exchange.py:mesh_span_torch;
// the two agree bit for bit.  The flush packing is the mesh entry of
// csrc/pack_flush.cu; this kernel leaves its inputs behind (the entry
// snapshots done_in = done_tick[last_flow_pad] and sent_in = node_sent, and
// the scalars t_stop, forwards, cross).
//
// Layout (the JAX package's global view of the sharded arrays): shard s
// owns flow rows s*pad .. s*pad+pad-1 of every [F = D*pad] array, node
// slots s*h_pad .. of every [H = D*h_pad] array, and ring columns s*pad ..
// of the [L, F] int32 ring (P(None, axis)).  Cross-shard cells go only
// through the exchange buffer, never straight into another shard's ring:
// the shard boundary stays real.
//
// Per tick t, for each shard (the shard-local body of exchange.py:380-435):
// every node refills its bucket and serves its flows greedily in order (the
// segmented cumsum), a served cell goes to its successor's ring column
// t mod L (an intra-shard successor), to its exchange slot (a cross-shard
// one: a2a_src in fused mode, the leg's send_src in ppermute mode), or
// nowhere (a leg this variant does not exchange, whose columns stay 0, as in
// JAX); the receiving shard writes each slot into its column's row t mod L
// (a2a_dst / recv_dst) and adds it to `cross`; the psum of [served, newly].
// The ring row t mod L is thus set whole, as the JAX ring.at[t].set(v) does:
// every column by exactly one writer.
//
// Design.  The tick body is csrc/span_tile.cuh's with its mesh cases
// (MESH = true): the padded table is cut, once per MeshTables, into tiles
// of whole nodes shard by shard (parallel/mesh/exchange.py
// mesh_tile_tables), so a tile never crosses a shard; blocks take tiles
// grid-strided, as csrc/torcells_span.cu does, a thread per flow and two
// block scans a chunk, where the earlier kernel gave each node a thread that
// walked its flows (blocks sized by h_pad, which chain_partition does not
// balance) and ran two grid syncs a tick.  ONE grid sync a tick: the
// exchange buffer is double-buffered by tick parity, and a receiving flow's
// own thread writes the cell sent at tick t - 1 into its ring column at the
// start of tick t, before its read (a ring column is read only by its own
// flow's thread), so the receive needs no phase of its own.  After the loop
// one pass lands the last tick's receives, so the state at t_stop is the
// plain version's.  A column whose predecessor sits on an unexchanged leg,
// or that has none, is set to 0 each tick by its own thread.  The padding
// node slots (h_pad less a shard's nodes: 51,715 of 82,216 at tor10k, D =
// 8) pace no flow and lie in each shard's last tile; refilled there a tick,
// they made that tile the tick's longest, so they are refilled after the
// loop instead, once for every tick run, spread over the grid.  The halt is
// decided on the card at each targets boundary, by every thread alike, from
// three rotating completion words.
//
// Bound.  The single-table span's work (csrc/torcells_span.cu: every flow
// and node once a tick) plus the exchange slots: one 8-byte write and one
// read per cross-shard edge a tick.  On one card the D shards buy no
// parallelism the single-table kernel lacks; a tick is each block's tiles
// one after another, then the grid sync, as there.

#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "span_tile.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_TARGETS = 64;
constexpr int THREADS = span::THREADS;

struct MeshParams {
  // carried state (global padded layout), updated in place
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
  // static tables (MeshTables)
  const int4* meta;          // [F]: global node, destination, arr_lat, flags
  const int4* tiles;         // [T + 1]: first node, first flow, empty nodes
  const int64_t* node_off;   // [H + 1] global row offsets
  const int32_t* xin;        // [F]: receive slot, -1, or -2 (leg masked)
  const int64_t* refill;     // [H]
  const int64_t* capacity;   // [H]
  const int64_t* last_flow;  // [C] padded rows of the chains' last stages
  // outputs: scalars [0] t_stop, [1] forwards, [2] cross, [3..5] the
  // per-tick completion words; the flush's entry snapshots
  int64_t* scalars;
  int64_t* done_in;   // [C]
  int64_t* sent_in;   // [H]
  int64_t* xbuf;      // [2, X] the exchange buffer, a half a tick parity
  int64_t f, h, c, n_tiles, ring_len, t0, idle_ticks, xbuf_len;
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

// two blocks an SM (at most 128 registers), as the span kernels have
__global__ void __launch_bounds__(THREADS, 2)
mesh_span_kernel(const MeshParams p) {
  cg::grid_group grid = cg::this_grid();
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t nthreads = (int64_t)gridDim.x * blockDim.x;
  const int64_t f = p.f, L = p.ring_len, x = p.xbuf_len;

  // -- entry folds (elementwise, so each shard's own rows stay its own):
  //    injections, the idle-tick refill, the ring clear, the flush's
  //    snapshots, the exchange buffer's two halves
  for (int64_t j = tid; j < f; j += nthreads) {
    p.queued[j] += p.inject[j];
    p.target[j] += p.inject_target[j];
  }
  for (int64_t n = tid; n < p.h; n += nthreads) {
    const int64_t tk = p.tokens[n] + p.refill[n] * p.idle_ticks;
    p.tokens[n] = tk < p.capacity[n] ? tk : p.capacity[n];
    p.sent_in[n] = p.node_sent[n];
  }
  if (p.idle_ticks > 0)
    for (int64_t k = tid; k < L * f; k += nthreads) p.ring[k] = 0;
  for (int64_t c = tid; c < p.c; c += nthreads)
    p.done_in[c] = p.done_tick[p.last_flow[c]];
  for (int64_t k = tid; k < 2 * x; k += nthreads) p.xbuf[k] = 0;
  if (tid == 0)
    for (int k = 0; k < 6; ++k) p.scalars[k] = 0;
  grid.sync();

  // -- the tick loop; every thread runs the same iterations
  __shared__ span::Shared sh;
  const span::Table tb{p.queued,   p.ring,      p.tokens,    p.delivered,
                       p.target,   p.done_tick, p.node_sent, p.meta,
                       p.tiles,    p.node_off,  p.refill,    p.capacity,
                       f,          p.h,         p.n_tiles,   (int)L};
  span::Exchange ex{p.xin, p.xbuf, 0, 0, -1};
  int64_t t = p.t0;
  int row_t = (int)floor_mod(t, L), k3 = 0;
  const int64_t end = p.targets[p.n_targets - 1];
  int idx = 0;
  bool span_done = false, halt = false;
  int64_t forwards = 0, cross = 0;
  while (t < end && !halt) {
    if (tid == 0) p.scalars[3 + (k3 + 1) % 3] = 0;
    ex.send_half = (t & 1) * x;
    ex.recv_half = x - ex.send_half;
    bool any_new = false;
    for (int64_t ti = blockIdx.x; ti < p.n_tiles; ti += gridDim.x)
      span::span_tile<true>(tb, 0, (int)ti, t, row_t, &forwards, &any_new,
                            sh, &ex, &cross);
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
    ex.prev_row = row_t;
    ++t;
    if (++row_t == L) row_t = 0;
    if (++k3 == 3) k3 = 0;
  }
  // -- the last tick's receives (its sends are in before the loop's last
  //    sync), so the ring and cross at t_stop are the plain version's; and
  //    the refills of the nodes that pace no flow (the padding node slots),
  //    one a tick run, which no flow read in the meantime
  if (t > p.t0) {
    const int64_t half = ((t - 1) & 1) * x;
    const int64_t row = (int64_t)ex.prev_row * f;
    for (int64_t j = tid; j < f; j += nthreads) {
      const int32_t k = __ldg(&p.xin[j]);
      if (k >= 0) {
        const int64_t v =
            (int64_t)__ldcg((const long long*)&p.xbuf[half + k]);
        p.ring[row + j] = (int32_t)v;
        cross += v;
      }
    }
    for (int64_t n = tid; n < p.h; n += nthreads) {
      if (__ldg(&p.node_off[n]) != __ldg(&p.node_off[n + 1])) continue;
      const int64_t rf = p.refill[n], cp = p.capacity[n];
      int64_t tk = p.tokens[n];
      for (int64_t k = p.t0; k < t; ++k) {
        tk = (int64_t)((uint64_t)tk + (uint64_t)rf);
        tk = tk < cp ? tk : cp;
      }
      p.tokens[n] = tk;
    }
  }

  forwards = block_sum(forwards);
  __syncthreads();
  cross = block_sum(cross);
  if (threadIdx.x == 0) {
    atomicAdd((unsigned long long*)&p.scalars[1], (unsigned long long)forwards);
    atomicAdd((unsigned long long*)&p.scalars[2], (unsigned long long)cross);
    if (blockIdx.x == 0) p.scalars[0] = t;
  }
}

}  // namespace

// Launch on `stream` (a cudaStream_t passed as a pointer).  Does not
// synchronise.  Returns 0 when the launch was accepted, else the CUDA error.
extern "C" int mesh_span_launch(
    void* queued, void* ring, void* tokens, void* delivered, void* target,
    void* done_tick, void* node_sent, const void* inject,
    const void* inject_target, const void* meta, const void* tiles,
    const void* node_off, const void* xin, const void* refill,
    const void* capacity, const void* last_flow, void* scalars,
    void* done_in, void* sent_in, void* xbuf, int64_t f, int64_t h,
    int64_t c, int64_t n_tiles, int64_t ring_len, int64_t t0,
    int64_t idle_ticks, int64_t xbuf_len, int n_targets,
    const int64_t* targets, void* stream) {
  // the tile body indexes the ring, the tables and the slots with 32-bit
  // offsets
  if (n_targets < 1 || n_targets > MAX_TARGETS || ring_len < 1 ||
      n_tiles < 1 || xbuf_len < 1 || ring_len * f >= ((int64_t)1 << 31) ||
      f + xbuf_len >= ((int64_t)1 << 31) || h >= ((int64_t)1 << 31))
    return (int)cudaErrorInvalidValue;
  MeshParams p;
  p.queued = (int64_t*)queued;
  p.ring = (int32_t*)ring;
  p.tokens = (int64_t*)tokens;
  p.delivered = (int64_t*)delivered;
  p.target = (int64_t*)target;
  p.done_tick = (int64_t*)done_tick;
  p.node_sent = (int64_t*)node_sent;
  p.inject = (const int64_t*)inject;
  p.inject_target = (const int64_t*)inject_target;
  p.meta = (const int4*)meta;
  p.tiles = (const int4*)tiles;
  p.node_off = (const int64_t*)node_off;
  p.xin = (const int32_t*)xin;
  p.refill = (const int64_t*)refill;
  p.capacity = (const int64_t*)capacity;
  p.last_flow = (const int64_t*)last_flow;
  p.scalars = (int64_t*)scalars;
  p.done_in = (int64_t*)done_in;
  p.sent_in = (int64_t*)sent_in;
  p.xbuf = (int64_t*)xbuf;
  p.f = f;
  p.h = h;
  p.c = c;
  p.n_tiles = n_tiles;
  p.ring_len = ring_len;
  p.t0 = t0;
  p.idle_ticks = idle_ticks;
  p.xbuf_len = xbuf_len;
  p.n_targets = n_targets;
  for (int i = 0; i < MAX_TARGETS; ++i)
    p.targets[i] = targets[i < n_targets ? i : n_targets - 1];

  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, mesh_span_kernel, THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  // every block that can be resident (a cooperative launch needs every
  // block resident), but no more than there are tiles
  int64_t want = n_tiles;
  const int64_t cap = (int64_t)per_sm * sms;
  if (want > cap) want = cap;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel((const void*)mesh_span_kernel,
                                    dim3((unsigned)want), dim3(THREADS), args,
                                    0, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The card entry: the mesh spread over several cards (one process, each card
// its own contiguous group of shards), in lookahead windows.
//
// Replaces the same JAX step (exchange.py:247 make_mesh_span_raw, the span
// half of :473 make_mesh_span_flush) where the JAX package runs its D shards
// on D devices.  Plain torch version: shadow_tpu_torch/parallel/mesh/
// cards.py:mesh_span_cards_torch; the two agree bit for bit, and with the
// one-card entry above.
//
// One cooperative launch a card a window, over that card's tiles only (the
// tables of parallel/mesh/cards.py CardTables, numbered from the card's
// first row and node slot).  A window is [w0, w1): at most W ticks, W the
// least arrival latency over the columns whose predecessor is on another
// card, and cut at every targets boundary.  Inside it the ticks run as in
// the one-card kernel (span_tile.cuh with MESH, one grid sync a tick, the
// card's own cross-shard cells through its double-buffered exchange
// buffer, landed after the loop), and a cell for another card b is stored
// straight into b's inbox: the half of the window's parity, this card's
// segment, row (t - w0) of the window (span_tile.cuh with CARDS; on
// distinct cards a peer-mapped store over NVLink, on aliased cards the same
// memory).  No copy runs between launches.  The host orders launch i of
// every card after launch i - 1 of every other card (CUDA events), and
// that launch is the last reader of inbox half i & 1, so the stores never
// overwrite cells not yet landed.  The next launch lands its inbox's other
// half first: cell (k, i) from card a into column cin[a, i], ring row
// (prev_w0 + k) mod L, counted into `cross`.  Every cell the landing reads
// was stored in the window before (a cross-card route's sender writes its
// cell every tick, zero or not).  Its first read is at tick prev_w0 + k +
// arr_lat >= w0, and no tick in between reads that row of that column (L >
// arr_lat).
//
// The halt, as the JAX package reduces it (psum'd at the sub-window
// boundaries): a window that ends at a boundary writes the card's "a
// completion since the last boundary" word into the header of its segment
// in every other card's inbox; the next launch (flag DECIDE) ORs its own word with the other
// cards' and, if set, stops the card: t_stop is the boundary, and every
// later launch of the dispatch returns at once, so the host enqueues all
// the windows up front.  The launch with LAST lands the final window and
// ends the dispatch: the padding node slots' refills for the ticks run
// (as the one-card kernel's) and t_stop.  FIRST carries the entry folds.
//
// Scalars (a card's, kept across the dispatch's launches): [0] t_stop, [1]
// forwards, [2] cross, [3] a completion since the last boundary, [4]
// stopped, [5] the cells landed from other cards.  The flush is the mesh
// entry of csrc/pack_flush.cu, run on the lead card over every card's
// state copied there.
//
// Bound.  The card's share of the span (its flows and nodes once a tick)
// plus the window's cross-card cells: 8 bytes each, stored once into the
// receiver's inbox, read once at landing.  Aliased cards (several card
// slots on one physical card) each take their share of its SMs
// (mesh_span_card_grid's grid_share), so their grids can be resident
// together; the grid is sized once per card, not per launch.
// ---------------------------------------------------------------------------

namespace {

constexpr int HDR = 2;  // segment header: ticks run, completion flag
constexpr int MAX_CARDS = 64;
enum { FIRST = 1, LAND = 2, DECIDE = 4, LAST = 8 };
enum { S_TSTOP = 0, S_FWD = 1, S_CROSS = 2, S_DONE = 3, S_STOP = 4,
       S_XCARD = 5 };
constexpr int N_SCALARS = 8;

struct CardParams {
  // the card's carried state (its rows and node slots), updated in place
  int64_t* queued;       // [F]
  int32_t* ring;         // [L, F]
  int64_t* tokens;       // [H]
  int64_t* delivered;    // [F]
  int64_t* target;       // [F]
  int64_t* done_tick;    // [F]
  int64_t* node_sent;    // [H]
  const int64_t* inject;         // [F]
  const int64_t* inject_target;  // [F]
  // the card's static tables (CardTables)
  const int4* meta;          // [F]
  const int4* tiles;         // [T + 1]
  const int64_t* node_off;   // [H + 1]
  const int32_t* xin;        // [F]: its own exchange slot, -1, -2
  const int64_t* refill;     // [H]
  const int64_t* capacity;   // [H]
  int64_t* scalars;          // [N_SCALARS], kept across the launches
  int64_t* done_snap;        // [F] done_tick at the dispatch's entry
  int64_t* sent_in;          // [H] node_sent at the dispatch's entry
  int64_t* xbuf;             // [2, X]
  // per card b, b's inbox half of this window's parity at this card's
  // segment (a device pointer; unused at b == card)
  int64_t* const* peer;      // [n_cards]
  const int64_t* inbox;      // [n_cards, seg]: the previous window's
  const int32_t* cin;        // [n_cards, pw]: landing columns, -1
  int64_t f, h, n_tiles, ring_len, t0, idle_ticks, xbuf_len, pw, seg, w0, w1,
      prev_w0, prev_len;
  int n_cards, card, flags, shift;  // shift: dest's card field (Exchange)
};

// the padding node slots' refills for the ticks t0 .. t_stop - 1 (no flow
// reads their tokens), and t_stop
__device__ void card_tail(const CardParams& p, int64_t t_stop, int64_t tid,
                          int64_t nthreads) {
  for (int64_t n = tid; n < p.h; n += nthreads) {
    if (__ldg(&p.node_off[n]) != __ldg(&p.node_off[n + 1])) continue;
    const int64_t rf = p.refill[n], cp = p.capacity[n];
    int64_t tk = p.tokens[n];
    for (int64_t k = p.t0; k < t_stop; ++k) {
      tk = (int64_t)((uint64_t)tk + (uint64_t)rf);
      tk = tk < cp ? tk : cp;
    }
    p.tokens[n] = tk;
  }
  if (tid == 0) p.scalars[S_TSTOP] = t_stop;
}

__global__ void __launch_bounds__(THREADS, 2)
mesh_span_card_kernel(const CardParams p) {
  cg::grid_group grid = cg::this_grid();
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t nthreads = (int64_t)gridDim.x * blockDim.x;
  const int64_t f = p.f, L = p.ring_len, x = p.xbuf_len;
  const bool first = p.flags & FIRST, last = p.flags & LAST;

  // a stopped card: nothing more this dispatch but its end
  if (!first && *(volatile int64_t*)&p.scalars[S_STOP] != 0) {
    if (last) card_tail(p, *(volatile int64_t*)&p.scalars[S_TSTOP], tid,
                        nthreads);
    return;
  }
  if (first) {
    // the entry folds, as the one-card kernel's, on the card's own rows
    for (int64_t j = tid; j < f; j += nthreads) {
      p.queued[j] += p.inject[j];
      p.target[j] += p.inject_target[j];
      p.done_snap[j] = p.done_tick[j];
    }
    for (int64_t n = tid; n < p.h; n += nthreads) {
      const int64_t tk = p.tokens[n] + p.refill[n] * p.idle_ticks;
      p.tokens[n] = tk < p.capacity[n] ? tk : p.capacity[n];
      p.sent_in[n] = p.node_sent[n];
    }
    if (p.idle_ticks > 0)
      for (int64_t k = tid; k < L * f; k += nthreads) p.ring[k] = 0;
    for (int64_t k = tid; k < 2 * x; k += nthreads) p.xbuf[k] = 0;
    if (tid == 0)
      for (int k = 0; k < N_SCALARS; ++k) p.scalars[k] = 0;
  }
  int64_t forwards = 0, cross = 0, xcard = 0;
  // the previous window's cells from the other cards, into their rows
  if (p.flags & LAND) {
    for (int64_t e = tid; e < (int64_t)p.n_cards * p.pw; e += nthreads) {
      const int64_t a = e / p.pw, i = e - a * p.pw;
      const int32_t col = __ldg(&p.cin[e]);
      if (a == p.card || col < 0) continue;
      const int64_t* src = p.inbox + a * p.seg + HDR + i;
      int64_t row = floor_mod(p.prev_w0, L);
      for (int64_t k = 0; k < p.prev_len; ++k) {
        const int64_t v = src[k * p.pw];
        p.ring[row * f + col] = (int32_t)v;
        xcard += v;
        if (++row == L) row = 0;
      }
    }
  }
  // the other cards' inbox segment bases, where the ticks store: in shared
  // memory (the grid sync below orders them before their first use)
  __shared__ int64_t* peer[MAX_CARDS];
  if (threadIdx.x < p.n_cards) peer[threadIdx.x] = p.peer[threadIdx.x];
  // the halt at the boundary the previous window ended on: the OR over
  // the cards of a completion since the boundary before
  bool halt = false;
  if (p.flags & DECIDE) {
    halt = *(volatile int64_t*)&p.scalars[S_DONE] != 0;
    for (int a = 0; a < p.n_cards; ++a)
      if (a != p.card && p.inbox[(int64_t)a * p.seg + 1] != 0) halt = true;
  }
  grid.sync();  // the folds and the landing are in; every thread read S_DONE
  if (p.flags & DECIDE) {
    if (tid == 0) p.scalars[S_DONE] = 0;
    grid.sync();
  }
  if (halt && tid == 0) {
    p.scalars[S_STOP] = 1;
    p.scalars[S_TSTOP] = p.w0;
  }
  if (!halt && !last) {
    __shared__ span::Shared sh;
    const span::Table tb{p.queued,   p.ring,      p.tokens,    p.delivered,
                         p.target,   p.done_tick, p.node_sent, p.meta,
                         p.tiles,    p.node_off,  p.refill,    p.capacity,
                         f,          p.h,         p.n_tiles,   (int)L};
    span::Exchange ex{p.xin, p.xbuf, 0, 0, -1, peer, 0, x, p.shift};
    int64_t t = p.w0;
    int row_t = (int)floor_mod(t, L);
    for (; t < p.w1; ++t) {
      ex.send_half = (t & 1) * x;
      ex.recv_half = x - ex.send_half;
      ex.out_base = HDR + (t - p.w0) * p.pw;
      bool any_new = false;
      for (int64_t ti = blockIdx.x; ti < p.n_tiles; ti += gridDim.x)
        span::span_tile<true, true>(tb, 0, (int)ti, t, row_t, &forwards,
                                    &any_new, sh, &ex, &cross);
      if (any_new) p.scalars[S_DONE] = 1;
      grid.sync();
      ex.prev_row = row_t;
      if (++row_t == L) row_t = 0;
    }
    // the last tick's receives through the card's own exchange buffer
    const int64_t half = ((t - 1) & 1) * x;
    const int64_t row = (int64_t)ex.prev_row * f;
    for (int64_t j = tid; j < f; j += nthreads) {
      const int32_t k = __ldg(&p.xin[j]);
      if (k >= 0) {
        const int64_t v =
            (int64_t)__ldcg((const long long*)&p.xbuf[half + k]);
        p.ring[row + j] = (int32_t)v;
        cross += v;
      }
    }
    // this card's segment headers in the other cards' inboxes (every
    // completion of the window is in)
    if (tid == 0) {
      const int64_t done = *(volatile int64_t*)&p.scalars[S_DONE];
      for (int b = 0; b < p.n_cards; ++b)
        if (b != p.card) {
          p.peer[b][0] = p.w1 - p.w0;
          p.peer[b][1] = done;
        }
    }
  }
  if (last) card_tail(p, p.w0, tid, nthreads);

  forwards = block_sum(forwards);
  __syncthreads();
  cross = block_sum(cross);
  __syncthreads();
  xcard = block_sum(xcard);
  if (threadIdx.x == 0) {
    atomicAdd((unsigned long long*)&p.scalars[S_FWD],
              (unsigned long long)forwards);
    atomicAdd((unsigned long long*)&p.scalars[S_CROSS],
              (unsigned long long)(cross + xcard));
    atomicAdd((unsigned long long*)&p.scalars[S_XCARD],
              (unsigned long long)xcard);
  }
}

}  // namespace

// The card entry's grid on the current card: every block that can be
// resident, divided among the `grid_share` card slots that alias this
// physical card, and no more than `n_tiles`.  Returns the block count (>=
// 1), or minus the CUDA error.  Called once per card, when its tables are
// uploaded.
extern "C" int mesh_span_card_grid(int64_t n_tiles, int grid_share) {
  if (n_tiles < 1 || grid_share < 1) return -(int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, mesh_span_card_kernel, THREADS, 0);
  if (err != cudaSuccess) return -(int)err;
  if (per_sm < 1) return -(int)cudaErrorCooperativeLaunchTooLarge;
  int64_t want = n_tiles;
  const int64_t cap = (int64_t)per_sm * sms / grid_share;
  if (want > cap) want = cap;
  return want < 1 ? 1 : (int)want;
}

// Let card `dev` store into card `peer`'s memory (the inboxes): 0 when
// access is enabled (or was already), -1 when the pair has no peer access
// (cudaDeviceCanAccessPeer), else the CUDA error.  Restores the current
// device.
extern "C" int mesh_span_enable_peer(int dev, int peer) {
  int can = 0, cur = 0;
  cudaError_t err = cudaDeviceCanAccessPeer(&can, dev, peer);
  if (err != cudaSuccess) return (int)err;
  if (!can) return -1;  // no CUDA error is negative
  err = cudaGetDevice(&cur);
  if (err == cudaSuccess) err = cudaSetDevice(dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();  // clear it: access is on, as asked
    err = cudaSuccess;
  }
  const cudaError_t back = cudaSetDevice(cur);
  return (int)(err != cudaSuccess ? err : back);
}

// One launch of the card entry on `stream` (the card must be the current
// device), `grid` blocks (mesh_span_card_grid).  `peers` is the card's
// device table [2, n_cards] of the other cards' inbox segment bases, a row
// per window parity; the launch stores into row `parity`.  `shift` splits
// a cross-card destination into its card and cell (span_tile.cuh
// Exchange).  Does not
// synchronise.  Returns 0 when the launch was accepted, else the CUDA
// error.
extern "C" int mesh_span_card_launch(
    void* queued, void* ring, void* tokens, void* delivered, void* target,
    void* done_tick, void* node_sent, const void* inject,
    const void* inject_target, const void* meta, const void* tiles,
    const void* node_off, const void* xin, const void* refill,
    const void* capacity, void* scalars, void* done_snap, void* sent_in,
    void* xbuf, const void* peers, const void* inbox, const void* cin,
    int64_t f, int64_t h, int64_t n_tiles, int64_t ring_len, int64_t t0,
    int64_t idle_ticks, int64_t xbuf_len, int64_t pw, int64_t seg,
    int64_t w0, int64_t w1, int64_t prev_w0, int64_t prev_len, int n_cards,
    int card, int flags, int parity, int shift, int grid, void* stream) {
  if (ring_len < 1 || n_tiles < 1 || xbuf_len < 1 || n_cards < 1 ||
      n_cards > MAX_CARDS || card < 0 || card >= n_cards || grid < 1 ||
      parity < 0 || parity > 1 || pw < 0 || seg < HDR || w1 < w0 ||
      prev_len < 0 || (pw > 0 && prev_len >= ring_len) || shift < 0 ||
      shift > 30 || (pw > 0 && pw > ((int64_t)1 << shift)) ||
      ring_len * f >= ((int64_t)1 << 31) ||
      f + xbuf_len + ((int64_t)n_cards << shift) >= ((int64_t)1 << 31) ||
      h >= ((int64_t)1 << 31) ||
      (pw > 0 && (w1 - w0) * pw > seg - HDR))
    return (int)cudaErrorInvalidValue;
  CardParams p;
  p.queued = (int64_t*)queued;
  p.ring = (int32_t*)ring;
  p.tokens = (int64_t*)tokens;
  p.delivered = (int64_t*)delivered;
  p.target = (int64_t*)target;
  p.done_tick = (int64_t*)done_tick;
  p.node_sent = (int64_t*)node_sent;
  p.inject = (const int64_t*)inject;
  p.inject_target = (const int64_t*)inject_target;
  p.meta = (const int4*)meta;
  p.tiles = (const int4*)tiles;
  p.node_off = (const int64_t*)node_off;
  p.xin = (const int32_t*)xin;
  p.refill = (const int64_t*)refill;
  p.capacity = (const int64_t*)capacity;
  p.scalars = (int64_t*)scalars;
  p.done_snap = (int64_t*)done_snap;
  p.sent_in = (int64_t*)sent_in;
  p.xbuf = (int64_t*)xbuf;
  p.peer = (int64_t* const*)peers + (int64_t)parity * n_cards;
  p.inbox = (const int64_t*)inbox;
  p.cin = (const int32_t*)cin;
  p.f = f;
  p.h = h;
  p.n_tiles = n_tiles;
  p.ring_len = ring_len;
  p.t0 = t0;
  p.idle_ticks = idle_ticks;
  p.xbuf_len = xbuf_len;
  p.pw = pw;
  p.seg = seg;
  p.w0 = w0;
  p.w1 = w1;
  p.prev_w0 = prev_w0;
  p.prev_len = prev_len;
  p.n_cards = n_cards;
  p.card = card;
  p.flags = flags;
  p.shift = shift;
  void* args[] = {&p};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)mesh_span_card_kernel, dim3((unsigned)grid), dim3(THREADS),
      args, 0, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
