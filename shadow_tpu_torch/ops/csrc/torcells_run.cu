// torcells_run: the device-resident onion-relay cell model run to
// completion in one persistent launch, a thread per flow over runs of nodes
// that stay resident in their blocks, for Hopper (sm_90a).
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
// Design.  The halt depends on the data, so the loop lives on the card, and
// what bounds it is the chain of one tick: its loads, its scans and the
// barrier that ends it.  So the launch is persistent and each block owns a
// fixed run of whole nodes for the whole run (ops/torcells_device.py
// torcells_run_plan cuts them from node_off): a thread per flow, and a
// block-wide segmented scan of q gives each flow the cells queued ahead of
// it in its node (the span kernels' scans, csrc/span_tile.cuh, over one
// flow a thread and without the plane's targets, injections, done ticks
// and node counters, with an int64 ring and a block size set per table; so
// this file has a body of its own).  A run longer than the block walks it in chunks,
// the scans' sums carried from one to the next.  Before the first tick a
// block copies into shared memory its flows' static table (one int4 a
// flow: node, successor, arrival latency, noff << 2 | flags, as
// span_tile_tables makes it) and queued and delivered, and its nodes'
// tokens, refill and capacity; they stay there, and delivered goes out once
// at the end.  Only the ring crosses blocks (a successor may lie in another
// block's run): per tick a flow gathers its arrival, whose address it knows
// from its own table word, and stores one cell.  A tick's first reads go
// out right after the previous barrier, together with the read of the halt
// word.  The ring is never zeroed: a row a flow reads is one its
// predecessor wrote in this run (every flow with a successor stores its
// cell every tick, and a read at tick t < arr_lat is of a row not written
// yet, which the JAX ring holds at 0, so it is skipped); a column no flow
// feeds (arr_lat 0) is never read.  flow_succ is injective and every
// arrival latency of a flow with a predecessor is in [1, L) (checked by the
// wrapper), so no flow reads a row the tick writes.
//
// Two paths, chosen on the card before the first tick: when no flow starts
// below zero and the cells in all fit in int32 (the bench's 400,000), every
// q, served and sum of them does too, and served and each node's spent
// follow from the one scan of q (tick_flow); otherwise the arithmetic is
// int64 and a second scan of served gives each node's spent at its last
// flow.  Either is exact.
//
// Two forms of the one body, the place of the state a template parameter,
// chosen on the host from the table's size alone (torcells_run_plan); both
// are one cooperative launch of at most one block an SM, each tick (or
// window) ended by one grid sync, the delivered sums in device memory:
//   GRID     each block's run resident in its shared memory (the bench's
//            10,000 flows run as 63 blocks of ~160 flows);
//   GLOBAL   a table whose runs exceed what a block's shared memory holds:
//            queued, delivered and the node state stay in device memory.
// Where every arrival latency lies in [2, L - 2] and each block's run is
// one chunk (the bench's table), two ticks run between two barriers
// (tick_loop): a tick then reads only rows written before the last
// barrier, and the second tick of a window is taken back when the first
// ends the run.  Each tick's delivered cells go into its word of one of
// three rotating pairs, and every thread adds the words to its own running
// total after the barrier, so all threads decide the halt alike; the pair
// a window will use next is reset during the window before it, after every
// read of its previous use.
//
// Bound.  Inputs and outputs once: ~0.6 MB of tables and delivered at the
// bench shape (F = 10,000, H = 2,240), ~0.2 us at HBM rate; ~24 32-bit
// operations per flow and ~32 per node a tick, ~0.49 G over 1,566 ticks,
// ~7 us at the scalar peak.  What bounds it is the tick chain: a shared
// load of the flow's word, one ring gather from L2, the block scan, and a
// barrier and the read of the halt words every window.

#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_THREADS = 1024;
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
// 512 B cell + the TCP/IP/Ethernet header (core/defs.py)
constexpr int64_t CELL_WIRE_BYTES = 512 + 66;
// meta.w flag bits; meta.w >> 2 is the flow's offset in its node's run
constexpr int SEG_HEAD = 1;
constexpr int NODE_TAIL = 2;
// the forms (ops/torcells_device.py RUN_FORMS)
constexpr int GRID = 0;
constexpr int GLOBAL = 1;

struct RunParams {
  const int64_t* queued0;    // [F]
  const int4* meta;          // [F] static: node, succ, arr_lat, flags
  const int4* blocks;        // [G + 1]: each block's first node, first flow
  const int64_t* refill;     // [H]
  const int64_t* capacity;   // [H]
  int64_t* ring;             // [L, F], not initialised
  int64_t* delivered;        // [F] output
  int64_t* queued;           // [F] GLOBAL only
  int64_t* tokens;           // [H] GLOBAL only
  int64_t* cap_cells;        // [H] GLOBAL only
  // zeroed by the caller: [0] ticks, [1] forwards, [2] sum(queued0), [3]
  // the flows that start below zero, [4..9] the rotating pairs of per-tick
  // delivered sums; [10] 1 when the run took the int32 path
  int64_t* scalars;
  int64_t f, max_ticks;
  int ring_len;
  int per_sync;  // ticks between two barriers (1, or 2: see tick_loop)
};

// A block's run of flows and nodes, indexed from its first flow and node:
// shared memory in the resident forms, device memory in GLOBAL.
struct Run {
  const int4* meta;
  int64_t* queued;
  int64_t* delivered;
  int64_t* tokens;
  int64_t* cap_cells;
  const int64_t* refill;
  const int64_t* capacity;
  int f0, n0, nf, nn;
};

// the scans' per-warp totals: two sets used in turn (the int64 path's two
// scans of a chunk; FAST's one scan of consecutive chunks), so each scan
// needs one block barrier: a set is rewritten only after the other set's
// barrier, which every reader of it has passed
struct ScanSlots {
  int64_t v[2][MAX_WARPS];
  int f[2][MAX_WARPS];
};

__device__ __forceinline__ int64_t floor_div(int64_t a, int64_t b) {
  const int64_t q = a / b;
  return (q * b != a && ((a < 0) != (b < 0))) ? q - 1 : q;
}

template <typename V>
__device__ __forceinline__ V warp_sum(V v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;  // in every lane
}

// The inclusive segmented scan of (v, f) across a warp's lanes.
template <typename V>
__device__ __forceinline__ void warp_seg_scan(V& v, int& f) {
  const int lane = threadIdx.x & 31;
  for (int o = 1; o < 32; o <<= 1) {
    const V pv = __shfl_up_sync(FULL, v, o);
    const int pf = __shfl_up_sync(FULL, f, o);
    if (lane >= o) {
      if (!f) v += pv;
      f |= pf;
    }
  }
}

// The block-wide segmented scan of the threads' aggregates (v: the sum of
// the thread's flows after its last head, or of all of them; f: it holds a
// head), in thread order, starting from `carry`.  Returns the running sum
// just before this thread's first flow and sets *total to the one after
// the block's last flow.  One block barrier: each warp then scans the
// warps' totals itself.
template <typename V>
__device__ __forceinline__ V seg_scan(V v, bool f, V carry, V* total,
                                      ScanSlots& sl, int set) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  V iv = v;
  int ifl = f;
  warp_seg_scan(iv, ifl);
  if (lane == 31) {
    sl.v[set][warp] = iv;
    sl.f[set][warp] = ifl;
  }
  __syncthreads();
  V wv = lane < nw ? (V)sl.v[set][lane] : 0;
  int wf = lane < nw ? sl.f[set][lane] : 0;
  warp_seg_scan(wv, wf);
  const V after = wf ? wv : carry + wv;  // the sum after warp `lane`
  V pre = __shfl_sync(FULL, after, (warp + 31) & 31);
  if (warp == 0) pre = carry;
  *total = __shfl_sync(FULL, after, nw - 1);
  V ev = __shfl_up_sync(FULL, iv, 1);
  int ef = __shfl_up_sync(FULL, ifl, 1);
  if (lane == 0) {
    ev = 0;
    ef = 0;
  }
  return ef ? ev : pre + ev;
}

// What a thread reads for its flow j (local; past the run's end: nothing)
// before the tick's work: the flow's table word, its queue and the cells
// arriving now (from the ring row its own word names), and at a node's
// first flow the node's tokens, refill and capacity.  Issued together, and
// for a tick's first chunk before the previous tick's halt word is read.
template <typename V>
struct FlowIn {
  int4 m;
  V q, arr;
  int64_t tok, refill, capacity;
};

template <typename V>
__device__ __forceinline__ FlowIn<V> load_flow(const Run& r,
                                               const RunParams& p, int j,
                                               int64_t t, int row_t) {
  FlowIn<V> in;
  const bool act = j < r.nf;
  in.m = act ? r.meta[j] : make_int4(0, -1, 0, 0);
  const bool first = act && (in.m.w >> 2) == 0;
  const int nl = in.m.x - r.n0;
  int rr = row_t - in.m.z;
  if (rr < 0) rr += p.ring_len;
  in.arr = act && in.m.z > 0 && t >= in.m.z
               ? (V)__ldcg((const long long*)&p.ring[
                     (int64_t)rr * p.f + r.f0 + j])
               : 0;
  in.q = act ? (V)r.queued[j] : 0;
  in.tok = first ? r.tokens[nl] : 0;
  in.refill = first ? r.refill[nl] : 0;
  in.capacity = first ? r.capacity[nl] : 0;
  return in;
}

// One tick of flow j (local), the thread's flow in a chunk of the block's
// run.  Every thread of the block calls it.  FAST (every q >= 0 and the
// cells in all below 2^31, so every q, served, arrival and sum of them fits
// in V = int32): served[j] = c(incl[j]) - c(incl[j] - q[j]) with c(x) =
// max(0, min(cap, x)), which is clip(cap - before, 0, q) for q >= 0, and a
// node's spent is c(incl) at its last flow, so one scan does.  Otherwise
// (V = int64) served is the clip and a second scan sums it over the node.
// cap_cells is kept as min(cap_cells, cells in all) on the FAST path, which
// changes no min against a sum of cells.
template <typename V, bool FAST>
__device__ __forceinline__ V tick_flow(const Run& r, const RunParams& p,
                                         const FlowIn<V>& in, int j,
                                         int set, int row_t,
                                         int64_t all_cells,
                                         V& carry_q, V& carry_s, V& dlane,
                                         int64_t& forwards, ScanSlots& sl) {
  const int4 m = in.m;
  const bool act = j < r.nf;
  const bool node_head = act && (m.w >> 2) == 0;
  const int nl = m.x - r.n0;
  const V q = in.q + in.arr;
  if (node_head) {
    const int64_t sum = in.tok + in.refill;
    const int64_t tok = sum < in.capacity ? sum : in.capacity;
    int64_t cap = floor_div(tok, CELL_WIRE_BYTES);
    if (FAST && cap > all_cells) cap = all_cells;
    r.tokens[nl] = tok;
    r.cap_cells[nl] = cap;
  }
  V total;
  // q's running sum in the node's segment, through this flow
  const bool seg_head = (m.w & SEG_HEAD) != 0;
  const V before_q = seg_scan(q, seg_head, carry_q, &total, sl, set);
  const V incl = seg_head ? q : before_q + q;
  carry_q = total;
  V s = 0;
  if (act) {
    const int64_t cap = r.cap_cells[nl];
    if constexpr (FAST) {
      const V c = (V)cap;
      const V before = incl - q;
      const V a = incl < c ? (incl < 0 ? 0 : incl) : (c < 0 ? 0 : c);
      const V b = before < c ? (before < 0 ? 0 : before) : (c < 0 ? 0 : c);
      s = a - b;
      if (m.w & NODE_TAIL) r.tokens[nl] -= (int64_t)a * CELL_WIRE_BYTES;
    } else {
      // clip as JAX takes it: max(x, 0), then min(., q), q < 0 too
      int64_t x = cap - (incl - q);
      x = x < 0 ? 0 : x;
      s = x > q ? q : x;
    }
    r.queued[j] = q - s;
    forwards += s;
    if (m.y < 0) {
      r.delivered[j] += s;
      dlane += s;
    } else {
      p.ring[(int64_t)row_t * p.f + m.y] = s;
    }
  }
  if constexpr (!FAST) {
    const V before_s = seg_scan(s, node_head, carry_s, &total, sl, 1);
    const V spent = node_head ? s : before_s + s;
    carry_s = total;
    if (act && (m.w & NODE_TAIL))
      r.tokens[nl] -= spent * CELL_WIRE_BYTES;
  }
  return s;
}

// The tick loop; every thread runs the same iterations, `per_sync` ticks
// (1 or 2) between two barriers.  Two need every arrival latency in
// [2, L - 2], so a tick reads only rows written before the last barrier and
// none the two ticks write, and one chunk a block, so a thread's one flow
// is all it must undo: when the cells delivered by the first of the two
// ticks already end the run, the second's deliveries and forwards are taken
// back and the run ends one tick earlier, as the JAX loop does.  `word`
// points at three rotating pairs of halt words in device memory that every
// block adds into and reads, and block 0 resets.  Returns the ticks run;
// adds the cells served to *forwards.
template <typename V, bool FAST>
__device__ __forceinline__ int64_t tick_loop(const Run& r, const RunParams& p,
                                             int64_t all_cells, int64_t* word,
                                             ScanSlots& sl,
                                             int64_t* forwards) {
  const int lane = threadIdx.x & 31;
  const int L = p.ring_len;
  int64_t t = 0, dsum = 0, w = 0;
  int row_t = 0;
  FlowIn<V> next = load_flow<V>(r, p, threadIdx.x, 0, 0);
  while (dsum < all_cells && t < p.max_ticks) {
    const int k3 = (int)(w % 3);
    // the pair window w + 1 adds into: its last reads were before this
    // window's start
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      word[2 * ((k3 + 1) % 3)] = 0;
      word[2 * ((k3 + 1) % 3) + 1] = 0;
    }
    const int ticks = p.per_sync == 2 && t + 1 < p.max_ticks ? 2 : 1;
    V undo_d = 0;
    int64_t undo_f = 0;
    for (int k = 0; k < ticks; ++k) {
      if (k) {
        // the block's own state of the first tick, then the second's reads
        __syncthreads();
        row_t = row_t + 1 == L ? 0 : row_t + 1;
        next = load_flow<V>(r, p, threadIdx.x, t + 1, row_t);
      }
      V dlane = 0, carry_q = 0, carry_s = 0;
      int64_t fw = 0;
      for (int cb = 0; cb < r.nf; cb += blockDim.x) {
        const int j = cb + threadIdx.x;
        const FlowIn<V> in =
            cb == 0 ? next : load_flow<V>(r, p, j, t + k, row_t);
        // FAST's one scan a chunk takes the slot sets in turn
        const int set = FAST ? (cb / blockDim.x) & 1 : 0;
        const V s = tick_flow<V, FAST>(r, p, in, j, set, row_t, all_cells,
                                       carry_q, carry_s, dlane, fw, sl);
        if (k == 1 && j < r.nf && in.m.y < 0) undo_d = s;
      }
      *forwards += fw;
      if (k == 1) undo_f = fw;
      const V dwarp = warp_sum(dlane);
      if (lane == 0 && dwarp != 0)
        atomicAdd((unsigned long long*)&word[2 * k3 + k],
                  (unsigned long long)dwarp);
    }
    cg::this_grid().sync();
    const int64_t d0 = *(volatile int64_t*)&word[2 * k3];
    const int64_t d1 = *(volatile int64_t*)&word[2 * k3 + 1];
    row_t = row_t + 1 == L ? 0 : row_t + 1;
    // the next window's reads go out with the halt words', not after them
    next = load_flow<V>(r, p, threadIdx.x, t + ticks, row_t);
    ++w;
    if (ticks == 2 && dsum + d0 >= all_cells) {
      // the run ended after the first tick: take the second back
      if (undo_d != 0) r.delivered[threadIdx.x] -= undo_d;
      *forwards -= undo_f;
      return t + 1;
    }
    dsum += d0 + d1;
    t += ticks;
  }
  return t;
}

template <int FORM>
__global__ void __launch_bounds__(MAX_THREADS)
torcells_run_kernel(const RunParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ ScanSlots slots;
  const int lane = threadIdx.x & 31;

  const int4 lo = p.blocks[blockIdx.x], hi = p.blocks[blockIdx.x + 1];
  Run r;
  r.n0 = lo.x;
  r.f0 = lo.y;
  r.nn = hi.x - lo.x;
  r.nf = hi.y - lo.y;
  if constexpr (FORM == GLOBAL) {
    r.meta = p.meta + r.f0;
    r.queued = p.queued + r.f0;
    r.delivered = p.delivered + r.f0;
    r.tokens = p.tokens + r.n0;
    r.cap_cells = p.cap_cells + r.n0;
    r.refill = p.refill + r.n0;
    r.capacity = p.capacity + r.n0;
  } else {
    int4* meta = (int4*)smem;
    int64_t* words = (int64_t*)(meta + r.nf);
    r.meta = meta;
    r.queued = words;
    r.delivered = words + r.nf;
    r.tokens = words + 2 * r.nf;
    r.cap_cells = r.tokens + r.nn;
    int64_t* refill = r.cap_cells + r.nn;
    int64_t* capacity = refill + r.nn;
    r.refill = refill;
    r.capacity = capacity;
    for (int j = threadIdx.x; j < r.nf; j += blockDim.x)
      meta[j] = p.meta[r.f0 + j];
    for (int n = threadIdx.x; n < r.nn; n += blockDim.x) {
      refill[n] = p.refill[r.n0 + n];
      capacity[n] = p.capacity[r.n0 + n];
    }
  }
  // -- entry: the state; the cells queued in all, and how many flows start
  // below zero
  int64_t part = 0, neg = 0;
  for (int j = threadIdx.x; j < r.nf; j += blockDim.x) {
    const int64_t q = p.queued0[r.f0 + j];
    r.queued[j] = q;
    r.delivered[j] = 0;
    part += q;
    neg += q < 0;
  }
  for (int n = threadIdx.x; n < r.nn; n += blockDim.x)
    r.tokens[n] = p.capacity[r.n0 + n];
  part = warp_sum(part);
  neg = warp_sum(neg);

  // [0] cells, [1] negatives, [2..7] the rotating sums
  int64_t* word = p.scalars + 2;
  if (lane == 0 && part != 0)
    atomicAdd((unsigned long long*)&word[0], (unsigned long long)part);
  if (lane == 0 && neg != 0)
    atomicAdd((unsigned long long*)&word[1], (unsigned long long)neg);
  cg::this_grid().sync();
  const int64_t all_cells = *(volatile int64_t*)&word[0];
  const bool fast = *(volatile int64_t*)&word[1] == 0 &&
                    all_cells < ((int64_t)1 << 31);
  int64_t forwards = 0;
  const int64_t t =
      fast ? tick_loop<int32_t, true>(r, p, all_cells, word + 2, slots,
                                      &forwards)
           : tick_loop<int64_t, false>(r, p, all_cells, word + 2, slots,
                                       &forwards);

  // -- exit: delivered, ticks and forwards
  if constexpr (FORM != GLOBAL)
    for (int j = threadIdx.x; j < r.nf; j += blockDim.x)
      p.delivered[r.f0 + j] = r.delivered[j];
  forwards = warp_sum(forwards);
  if (lane == 0 && forwards != 0)
    atomicAdd((unsigned long long*)&p.scalars[1],
              (unsigned long long)forwards);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    p.scalars[0] = t;
    p.scalars[10] = fast;
  }
}

}  // namespace

// Launch on `stream` (a cudaStream_t passed as a pointer) in `form` over
// `n_blocks` blocks (`blocks`: their first nodes and flows) of `threads`
// threads and `smem` bytes of dynamic shared memory.  Does not
// synchronise.  Returns 0 when the launch was accepted, else the CUDA error
// (a refused cooperative launch is one: nothing retries).
extern "C" int torcells_run_launch(
    const void* queued0, const void* meta, const void* blocks,
    const void* refill, const void* capacity, void* ring, void* delivered,
    void* queued, void* tokens, void* cap_cells, void* scalars, int64_t f,
    int64_t max_ticks, int ring_len, int form, int n_blocks, int threads,
    int smem, int per_sync, void* stream) {
  if (f < 1 || ring_len < 1 || n_blocks < 1 || threads < 32 ||
      per_sync < 1 || per_sync > 2 ||
      threads > MAX_THREADS || threads % 32 || smem < 0 ||
      (form != GRID && form != GLOBAL))
    return (int)cudaErrorInvalidValue;
  RunParams p;
  p.queued0 = (const int64_t*)queued0;
  p.meta = (const int4*)meta;
  p.blocks = (const int4*)blocks;
  p.refill = (const int64_t*)refill;
  p.capacity = (const int64_t*)capacity;
  p.ring = (int64_t*)ring;
  p.delivered = (int64_t*)delivered;
  p.queued = (int64_t*)queued;
  p.tokens = (int64_t*)tokens;
  p.cap_cells = (int64_t*)cap_cells;
  p.scalars = (int64_t*)scalars;
  p.f = f;
  p.max_ticks = max_ticks;
  p.ring_len = ring_len;
  p.per_sync = per_sync;

  const void* fn = form == GRID ? (const void*)torcells_run_kernel<GRID>
                                : (const void*)torcells_run_kernel<GLOBAL>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(fn, dim3((unsigned)n_blocks),
                                    dim3((unsigned)threads), args,
                                    (size_t)smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
