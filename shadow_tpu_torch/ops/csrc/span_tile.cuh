// span_tile.cuh: one tick of the device traffic plane's span step over one
// tile of a flow table, a thread per flow, for Hopper (sm_90a).  Included by
// csrc/torcells_span.cu (one table) and csrc/torcells_span_batched.cu (W
// tables, one per lane); both kernels are one persistent cooperative launch
// with one grid sync per tick, and call span_tile() for every tile a block
// owns.
//
// The function (per tick t, per node n, with flows sorted by node):
//   tokens    = min(capacity, tokens + refill);   cap_cells = tokens / CELL
//   q[j]      = queued[j] + ring[(t - arr_lat[j]) mod L, j]
//   before[j] = the q of j's seg_start segment ahead of j (the JAX
//               package's segmented cumsum)
//   served[j] = clip(cap_cells[node(j)] - before[j], 0, q[j])
//   queued[j] = q[j] - served[j];  last stage: delivered += served and
//               done_tick = t on reaching target;  else ring[t mod L,
//               succ[j]] = served (int32)
//   tokens -= spent * CELL, node_sent += spent * CELL, spent = the served
//               cells summed over the node's whole run node_off[n]:[n+1]
// Segments (seg_start) and nodes are two different boundaries: a node's run
// may hold several segments (the fleet's padding flows are each their own),
// so `before` restarts at every segment head and `spent` at every node head.
//
// A tile is a contiguous run of whole nodes (built once per table on the
// host: ops/torcells_device.py span_tile_tables), so a tile's scans need
// nothing from another block.  Its flows go through in chunks of CHUNK =
// THREADS x FPT: thread k holds the chunk's flows FPT*k .. FPT*k + FPT-1.
// Per chunk, a block-wide segmented scan of q (heads: seg_start) gives
// `before`; a second of served (heads: node starts) gives each node's spent
// at its last flow.  A node longer than a chunk carries both running sums,
// and its cap_cells and tokens, into the next chunk, as torcells_run.cu
// carries a warp's sum across its 32-flow chunks.  A node's cap_cells and
// tokens are computed once a tick, by the thread holding its first flow,
// and read by its other flows from shared memory.
//
// Per flow the static table is one 16-byte int4 (`meta`): node, successor
// (-1 at a chain's last stage), arrival latency in [0, L) (0: no
// predecessor), and noff << 2 | NODE_TAIL | SEG_HEAD, noff being the
// flow's offset in its node's run.  The row a flow reads is row_t - al,
// plus L when negative: no 64-bit modulo per flow.  Two invariants let one
// grid sync a tick suffice: flow_succ is injective, so every ring column
// has one writer; and every arrival latency of a flow with a predecessor
// is in [1, L), so the row a tick writes is never one a flow reads in that
// tick (a column with no predecessor, al == 0, is read and then zeroed by
// its own thread).
//
// The mesh (csrc/mesh_span.cu) runs the same body with MESH = true over the
// padded global layout of D shards (tiles cut shard by shard, so a tile
// never crosses one), where a successor may be a third kind of destination:
// a slot of the exchange buffer.  Its meta successor reads -1 a chain's
// last stage, -2 a cross-shard successor on a leg the variant does not
// exchange (no send), [0, F) a ring column of the same shard, F + k slot k
// of this tick's half of the double-buffered exchange buffer.  A flow whose
// cells arrive through a slot (xin[j] = k >= 0) takes tick t - 1's cell
// from the other half at the start of tick t, writes it into its own ring
// cell of row t - 1 and adds it to `cross`, before it reads its arrival (and
// uses it directly when that read is row t - 1); a flow whose predecessor's
// leg is not exchanged (xin[j] = -2) has its column set to 0 each tick.
// One grid sync a tick keeps the exchange right: the half a tick reads was
// written before the last sync, and the next write to it comes after the
// next one.  Nodes that pace no flow are left to the mesh kernel (no flow
// reads their tokens, so their refills can wait for the end of the
// launch).  With MESH = false the body is the single-table one, unchanged.
// The card entry of csrc/mesh_span.cu (CARDS = true) adds a fourth kind of
// destination, a cell for another card (F + X and past), stored straight
// into that card's inbox; with CARDS = false that branch is compiled out.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace span {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int FPT = 2;                  // flows per thread in a chunk
constexpr int CHUNK = THREADS * FPT;
constexpr unsigned FULL = 0xffffffffu;
// 512 B cell + the TCP/IP/Ethernet header (core/defs.py)
// >>> simgen:begin region=cuda-cell-header spec=293c930bb679 body=25753cd8da65
constexpr int64_t HDR_TCP = 66;  // a cell's TCP+IP+ETH header bytes
// <<< simgen:end region=cuda-cell-header
constexpr int64_t CELL_WIRE_BYTES = 512 + HDR_TCP;
// meta.w flag bits; meta.w >> 2 is the flow's offset in its node's run
constexpr int SEG_HEAD = 1;
constexpr int NODE_TAIL = 2;

// The tensors of one table, or of W tables side by side (the batched
// kernel's [W, ...] operands; span_tile() takes a lane index and offsets
// every access to that lane's rows).  Only the tables no thread writes
// during the launch are read through the read-only path; `target` is
// written by the entry fold, so it is no __restrict__ const.
struct Table {
  int64_t* __restrict__ queued;        // [W, F]
  int32_t* __restrict__ ring;          // [W, L, F]
  int64_t* __restrict__ tokens;        // [W, H]
  int64_t* __restrict__ delivered;     // [W, F]
  const int64_t* target;               // [W, F] (set by the entry fold)
  int64_t* __restrict__ done_tick;     // [W, F]
  int64_t* __restrict__ node_sent;     // [W, H]
  const int4* __restrict__ meta;       // [W, F] static
  const int4* __restrict__ tiles;      // [W, T + 1] static: n0, f0, n_empty
  const int64_t* __restrict__ node_off;  // [W, H + 1] static
  const int64_t* __restrict__ refill;    // [W, H] static
  const int64_t* __restrict__ capacity;  // [W, H] static
  int64_t f, h, n_tiles;               // a lane's F, H and T
  int ring_len;                        // L (L * F < 2^31)
};

// The mesh's exchange, for one tick (MESH = true only).  Over several
// cards (CARDS = true, csrc/mesh_span.cu's card entry) a destination at or
// past F + X is cell i for card b, dest = F + X + (b << shift) + i (2^shift
// >= pw, so a shift and a mask decode it): it is stored into card b's
// inbox, this card's segment of the window's parity, at peer[b][i +
// out_base], out_base = HDR + (the tick's index in the window) * pw (a
// peer-mapped store where b is another physical card; `peer` is in shared
// memory).
struct Exchange {
  const int32_t* __restrict__ xin;  // [F] static: receive slot, -1, -2
  int64_t* xbuf;                    // [2, X]: a half a tick parity
  int64_t send_half, recv_half;     // (t & 1) * X, ((t - 1) & 1) * X
  int prev_row;                     // (t - 1) mod L, -1: nothing to receive
  int64_t* const* peer;             // CARDS: [n_cards] segment bases
  int64_t out_base;                 // CARDS: as above
  int64_t xlen;                     // CARDS: X
  int shift;                        // CARDS: as above
};

struct Shared {
  int64_t cap[CHUNK];    // cap_cells of the node whose first flow is here
  int64_t tok[CHUNK];    // its refilled tokens
  int64_t wv[WARPS];     // scan: each warp's segmented total
  int wf[WARPS];         //        and whether it holds a head
  int64_t carry[2];      // cap_cells, tokens of the node running past a chunk
};

// The block-wide segmented scan of the threads' aggregates (v: the sum of
// the thread's flows after its last head, or of all of them; f: it holds a
// head), in thread order, starting from `carry`.  Returns the exclusive
// prefix of this thread (the running sum just before its first flow) and
// sets *total to the running sum after the chunk's last flow.
__device__ __forceinline__ int64_t seg_scan(int64_t v, bool f, int64_t carry,
                                            int64_t* total, Shared& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int64_t iv = v;
  int ifl = f;
  for (int o = 1; o < 32; o <<= 1) {
    const int64_t pv = __shfl_up_sync(FULL, iv, o);
    const int pf = __shfl_up_sync(FULL, ifl, o);
    if (lane >= o) {
      if (!ifl) iv += pv;
      ifl |= pf;
    }
  }
  if (lane == 31) {
    sh.wv[warp] = iv;
    sh.wf[warp] = ifl;
  }
  __syncthreads();
  int64_t pre = carry, tot = carry;
  for (int w = 0; w < WARPS; ++w) {
    if (w == warp) pre = tot;
    tot = sh.wf[w] ? sh.wv[w] : tot + sh.wv[w];
  }
  __syncthreads();
  int64_t ev = __shfl_up_sync(FULL, iv, 1);
  int ef = __shfl_up_sync(FULL, ifl, 1);
  if (lane == 0) {
    ev = 0;
    ef = 0;
  }
  *total = tot;
  return ef ? ev : pre + ev;
}

// One tick over tile `ti` of lane `w` of `tb`: t the tick, row_t = t mod
// L.  Adds the served cells to *forwards; sets *any_new when a chain's last
// stage reached its target.  Every thread of the block calls it.  Each
// flow's loads are issued together once its meta word is in, so a chunk
// costs two dependent memory round trips before its scans, not a chain.
// With MESH, `ex` is the tick's exchange and *cross sums the cells
// received (neither is read otherwise); with CARDS too, a successor on
// another card is stored into that card's inbox.
template <bool MESH = false, bool CARDS = false>
__device__ __forceinline__ void span_tile(const Table& tb, int64_t w, int ti,
                                          int64_t t, int row_t,
                                          int64_t* forwards, bool* any_new,
                                          Shared& sh,
                                          const Exchange* ex = nullptr,
                                          int64_t* cross = nullptr) {
  const int L = tb.ring_len;
  const int f = (int)tb.f;
  // lane w's rows
  int64_t* __restrict__ queued = tb.queued + w * tb.f;
  int64_t* __restrict__ delivered = tb.delivered + w * tb.f;
  const int64_t* target = tb.target + w * tb.f;
  int64_t* __restrict__ done_tick = tb.done_tick + w * tb.f;
  const int4* __restrict__ meta = tb.meta + w * tb.f;
  int32_t* __restrict__ ring = tb.ring + w * L * tb.f;
  int64_t* __restrict__ tokens = tb.tokens + w * tb.h;
  int64_t* __restrict__ node_sent = tb.node_sent + w * tb.h;
  const int64_t* __restrict__ refill = tb.refill + w * tb.h;
  const int64_t* __restrict__ capacity = tb.capacity + w * tb.h;
  const int64_t* __restrict__ node_off = tb.node_off + w * (tb.h + 1);
  const int4* __restrict__ tiles = tb.tiles + w * (tb.n_tiles + 1);

  const int4 lo = __ldg(&tiles[ti]);
  const int4 hi = __ldg(&tiles[ti + 1]);
  const int n0 = lo.x, n1 = hi.x, f0 = lo.y, f1 = hi.y;
  // nodes that pace no flow: only the refill (the mesh's are its padding
  // node slots, thousands in a shard's last tile: its kernel refills them
  // once, after the loop, for every tick run)
  if (!MESH && lo.z > 0)
    for (int n = n0 + threadIdx.x; n < n1; n += THREADS)
      if (__ldg(&node_off[n]) == __ldg(&node_off[n + 1])) {
        const int64_t tk = tokens[n] + __ldg(&refill[n]);
        const int64_t cp = __ldg(&capacity[n]);
        tokens[n] = tk < cp ? tk : cp;
      }
  int32_t* __restrict__ wrow = ring + row_t * f;
  int64_t carry_q = 0, carry_s = 0;
  for (int cb = f0; cb < f1; cb += CHUNK) {
    const int p0 = threadIdx.x * FPT;
    int4 m[FPT];
    int xi[FPT];
#pragma unroll
    for (int k = 0; k < FPT; ++k) {
      m[k] = cb + p0 + k < f1 ? __ldg(&meta[cb + p0 + k])
                              : make_int4(0, -1, 0, 0);
      if constexpr (MESH)
        xi[k] = cb + p0 + k < f1 ? __ldg(&ex->xin[cb + p0 + k]) : -1;
    }
    // every load this chunk needs, issued together
    int64_t q[FPT], nd[FPT], ntg[FPT], ndt[FPT], ntk[FPT], nrf[FPT],
        ncp[FPT], nsent[FPT], xv[FPT];
    int32_t arr[FPT];
#pragma unroll
    for (int k = 0; k < FPT; ++k) {
      const int j = cb + p0 + k;
      const bool act = j < f1;
      const bool first = act && (m[k].w >> 2) == 0;
      const bool last = act && (MESH ? m[k].y == -1 : m[k].y < 0);
      int rr = row_t - m[k].z;
      if (rr < 0) rr += L;
      q[k] = act ? queued[j] : 0;
      arr[k] = act ? __ldcg(&ring[rr * f + j]) : 0;
      if constexpr (MESH) {
        // tick t - 1's cell through the exchange, due in row t - 1
        const bool recv = xi[k] >= 0 && ex->prev_row >= 0;
        xv[k] = recv ? (int64_t)__ldcg((const long long*)&ex->xbuf[
                           ex->recv_half + xi[k]])
                     : 0;
        if (recv && rr == ex->prev_row) arr[k] = (int32_t)xv[k];
      }
      ntk[k] = first ? tokens[m[k].x] : 0;
      nrf[k] = first ? __ldg(&refill[m[k].x]) : 0;
      ncp[k] = first ? __ldg(&capacity[m[k].x]) : 0;
      nd[k] = last ? delivered[j] : 0;
      ntg[k] = last ? target[j] : 0;
      ndt[k] = last ? done_tick[j] : 0;
      nsent[k] = act && (m[k].w & NODE_TAIL) ? node_sent[m[k].x] : 0;
    }
    int64_t agg = 0;
    bool head = false;
#pragma unroll
    for (int k = 0; k < FPT; ++k) {
      const int j = cb + p0 + k;
      q[k] += arr[k];
      // a column no flow feeds: its own thread sets it (after its read)
      if (j < f1 && m[k].z == 0) wrow[j] = 0;
      if constexpr (MESH) {
        if (j < f1 && xi[k] == -2) wrow[j] = 0;  // its leg not exchanged
        if (j < f1 && xi[k] >= 0 && ex->prev_row >= 0) {
          ring[ex->prev_row * f + j] = (int32_t)xv[k];
          *cross += xv[k];
        }
      }
      if (j < f1 && (m[k].w >> 2) == 0) {       // the node's first flow
        const int64_t tok = ntk[k] + nrf[k] < ncp[k] ? ntk[k] + nrf[k]
                                                     : ncp[k];
        sh.tok[p0 + k] = tok;
        sh.cap[p0 + k] = tok / CELL_WIRE_BYTES;
      }
      if (m[k].w & SEG_HEAD) {
        agg = q[k];
        head = true;
      } else {
        agg += q[k];
      }
    }
    int64_t total;
    int64_t run = seg_scan(agg, head, carry_q, &total, sh);
    carry_q = total;
    // served, the queue and the sends; the node's spent scan's inputs
    int64_t s[FPT], tok[FPT], cap_last = 0, tok_last = 0;
    agg = 0;
    head = false;
#pragma unroll
    for (int k = 0; k < FPT; ++k) {
      const int j = cb + p0 + k;
      run = (m[k].w & SEG_HEAD) ? q[k] : run + q[k];
      s[k] = 0;
      tok[k] = 0;
      if (j < f1) {
        const int hp = p0 + k - (m[k].w >> 2);   // the node's first flow
        const int64_t cap = hp >= 0 ? sh.cap[hp] : sh.carry[0];
        tok[k] = hp >= 0 ? sh.tok[hp] : sh.carry[1];
        if (k == FPT - 1) {
          cap_last = cap;
          tok_last = tok[k];
        }
        // clip as JAX takes it: max(x, 0), then min(., q), q < 0 too
        int64_t v = cap - (run - q[k]);
        v = v < 0 ? 0 : v;
        v = v > q[k] ? q[k] : v;
        s[k] = v;
        queued[j] = q[k] - v;
        *forwards += v;
        if (MESH ? m[k].y == -1 : m[k].y < 0) {
          const int64_t d = nd[k] + v;
          delivered[j] = d;
          if (ntg[k] > 0 && ndt[k] < 0 && d >= ntg[k]) {
            done_tick[j] = t;
            *any_new = true;
          }
        } else if constexpr (MESH) {
          if (CARDS && m[k].y >= f + ex->xlen) {  // one on another card
            const int o = m[k].y - f - (int)ex->xlen;
            ex->peer[o >> ex->shift]
                    [(o & ((1 << ex->shift) - 1)) + ex->out_base] = v;
          } else if (m[k].y >= f)                 // a cross-shard successor
            ex->xbuf[ex->send_half + m[k].y - f] = v;
          else if (m[k].y >= 0)                 // one on the same shard
            wrow[m[k].y] = (int32_t)v;
        } else {
          wrow[m[k].y] = (int32_t)v;
        }
      }
      if ((m[k].w >> 2) == 0 && j < f1) {
        agg = s[k];
        head = true;
      } else {
        agg += s[k];
      }
    }
    run = seg_scan(agg, head, carry_s, &total, sh);
    carry_s = total;
#pragma unroll
    for (int k = 0; k < FPT; ++k) {
      const int j = cb + p0 + k;
      run = ((m[k].w >> 2) == 0 && j < f1) ? s[k] : run + s[k];
      if (j < f1 && (m[k].w & NODE_TAIL)) {
        tokens[m[k].x] = tok[k] - run * CELL_WIRE_BYTES;
        node_sent[m[k].x] = nsent[k] + run * CELL_WIRE_BYTES;
      }
    }
    // the node running past this chunk (if any) is the last flow's; its
    // scan carries are above.  Every thread read sh.cap/sh.tok/sh.carry
    // before the second scan's barriers, so the next chunk may overwrite.
    if (threadIdx.x == THREADS - 1) {
      sh.carry[0] = cap_last;
      sh.carry[1] = tok_last;
    }
  }
}

}  // namespace span
