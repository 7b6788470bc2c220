// pack_flush: the device traffic plane's packed flush buffer, one block, for
// Hopper (sm_90a).
//
// Replaces the JAX package's shadow_tpu/ops/torcells_device.py:337
// (_pack_flush_jnp), called by _step_span_flush_impl :512 after the span
// step.  The plain torch version of the same function is
// shadow_tpu_torch/ops/torcells_device.py:pack_flush_torch; the two agree bit
// for bit.
//
// Output, int64 [5 + 2cc + 2hh] (cc = min(cap_chains, C), hh likewise; no
// caps means cc = C, hh = H):
//   [0] forwards, [1] delivered sum, [2] n_done, [3] n_touched, [4] t_stop
//   [5        : 5+n]        chains c with newly[c], ascending
//   [5+cc     : 5+cc+n]     their done_last[c]
//   [5+2cc    : 5+2cc+m]    nodes h with sent_delta[h] != 0, ascending
//   [5+2cc+hh : 5+2cc+hh+m] their sent_delta[h]
// and zeros elsewhere.  The header counts are the TRUE counts; entries
// whose cursor is past a cap are not written (the JAX scatter's "drop"
// mode), so the host can tell a capped buffer lost entries.
//
// Design.  Ascending order needs each selected lane's rank among the
// selected lanes: an exclusive scan, not atomics (whose order would vary).
// One block of 1024 threads walks C and then H in chunks of 1024, a
// block-wide scan per chunk (warp shuffles, then a scan of the 32 warp
// totals), carrying the running count between chunks.  The scalars come
// from device memory (the span kernel's outputs), so the launch needs no
// host read.
//
// Bound.  It reads C bools + 8C + 8H bytes and writes 8 (5 + 2C + 2H):
// ~1.2 MB at tor10k width (C = 20,000, H = 30,494), under a microsecond at
// HBM rate.  One block walking 50 chunks with ~10 block barriers each is
// latency-bound, tens of microseconds; spreading it over the card is later
// work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 1024;
constexpr int HEADER = 5;

// exclusive scan of v over the block; *total gets the block's sum
__device__ __forceinline__ int64_t block_exclusive_scan(int64_t v,
                                                        int64_t* total) {
  __shared__ int64_t warp_tot[THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int64_t x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int64_t y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int64_t w = warp_tot[lane];
    for (int o = 1; o < 32; o <<= 1) {
      const int64_t y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    warp_tot[lane] = w;  // inclusive scan of warp totals
  }
  __syncthreads();
  const int64_t warp_base = warp > 0 ? warp_tot[warp - 1] : 0;
  *total = warp_tot[THREADS / 32 - 1];
  __syncthreads();  // warp_tot is reused by the next call
  return warp_base + x - v;
}

__global__ void __launch_bounds__(THREADS)
pack_flush_kernel(const int64_t* forwards, const int64_t* delivered_sum,
                  const int64_t* t_stop, const uint8_t* newly,
                  const int64_t* done_last, const int64_t* sent_delta,
                  int64_t* buf, int64_t c, int64_t h, int64_t cc,
                  int64_t hh) {
  const int64_t len = HEADER + 2 * cc + 2 * hh;
  for (int64_t i = HEADER + threadIdx.x; i < len; i += THREADS) buf[i] = 0;
  __syncthreads();

  int64_t carry = 0;
  for (int64_t base = 0; base < c; base += THREADS) {
    const int64_t i = base + threadIdx.x;
    const int64_t sel = (i < c && newly[i]) ? 1 : 0;
    int64_t chunk;
    const int64_t pos = carry + block_exclusive_scan(sel, &chunk);
    if (sel && pos < cc) {
      buf[HEADER + pos] = i;
      buf[HEADER + cc + pos] = done_last[i];
    }
    carry += chunk;
  }
  const int64_t n_done = carry;

  carry = 0;
  for (int64_t base = 0; base < h; base += THREADS) {
    const int64_t i = base + threadIdx.x;
    const int64_t d = i < h ? sent_delta[i] : 0;
    const int64_t sel = d != 0 ? 1 : 0;
    int64_t chunk;
    const int64_t pos = carry + block_exclusive_scan(sel, &chunk);
    if (sel && pos < hh) {
      buf[HEADER + 2 * cc + pos] = i;
      buf[HEADER + 2 * cc + hh + pos] = d;
    }
    carry += chunk;
  }

  if (threadIdx.x == 0) {
    buf[0] = *forwards;
    buf[1] = *delivered_sum;
    buf[2] = n_done;
    buf[3] = carry;
    buf[4] = *t_stop;
  }
}

}  // namespace

// Launch on `stream` (a cudaStream_t passed as a pointer).  Does not
// synchronise.  Returns cudaGetLastError(): 0 when the launch was accepted.
extern "C" int pack_flush_launch(const void* forwards,
                                 const void* delivered_sum,
                                 const void* t_stop, const void* newly,
                                 const void* done_last,
                                 const void* sent_delta, void* buf,
                                 int64_t c, int64_t h, int64_t cc,
                                 int64_t hh, void* stream) {
  pack_flush_kernel<<<1, THREADS, 0, (cudaStream_t)stream>>>(
      (const int64_t*)forwards, (const int64_t*)delivered_sum,
      (const int64_t*)t_stop, (const uint8_t*)newly,
      (const int64_t*)done_last, (const int64_t*)sent_delta, (int64_t*)buf,
      c, h, cc, hh);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// pack_flush_batched: the fleet plane's packed flushes, one block per lane.
//
// Replaces the flush half of the JAX package's
// shadow_tpu/ops/torcells_device.py:586 torcells_step_span_flush_batched
// (_pack_flush_jnp :337 under jax.vmap), after the span half
// csrc/torcells_span_batched.cu.  The plain torch version is
// shadow_tpu_torch/ops/torcells_device.py:pack_flush_batched_torch.
//
// Block w packs lane w, in the serial layout above with no caps, into row
// w of buf [W, 5 + 2C + 2H], from the lane's state after the span and its
// entry snapshots (done_in = done_tick[last_flow], sent_in = node_sent):
//   newly[c]   = done_tick[last_flow[c]] >= 0 && done_in[c] < 0
//   delta[n]   = node_sent[n] - sent_in[n]
//   [0] forwards = sum(delta) / CELL (each served cell added one CELL to
//       its node's node_sent), [1] sum of delivered[last_flow], [2] n_done,
//   [3] n_touched, [4] t_stop[w]
// and forwards[w] = [0].  The chunked block scans are the serial kernel's;
// the two sums come from the same scan's totals, so every number is exact
// and in a fixed order.  Latency-bound like the serial pack: W blocks of
// one SM each walk C and H in chunks of 1024.
// ---------------------------------------------------------------------------

namespace {

constexpr int64_t PACK_CELL_WIRE_BYTES = 512 + 66;  // core/defs.py

__global__ void __launch_bounds__(THREADS)
pack_flush_batched_kernel(const int64_t* t_stop, const int64_t* done_in,
                          const int64_t* done_tick, const int64_t* last_flow,
                          const int64_t* delivered, const int64_t* sent_in,
                          const int64_t* node_sent, int64_t* buf,
                          int64_t* forwards, int64_t f, int64_t c,
                          int64_t h) {
  const int64_t w = blockIdx.x;
  const int64_t len = HEADER + 2 * c + 2 * h;
  int64_t* out = buf + w * len;
  const int64_t* dt = done_tick + w * f;
  const int64_t* dv = delivered + w * f;
  const int64_t* lf = last_flow + w * c;
  const int64_t* din = done_in + w * c;
  const int64_t* sin = sent_in + w * h;
  const int64_t* sent = node_sent + w * h;
  for (int64_t i = HEADER + threadIdx.x; i < len; i += THREADS) out[i] = 0;
  __syncthreads();

  int64_t carry = 0, dsum = 0;
  for (int64_t base = 0; base < c; base += THREADS) {
    const int64_t i = base + threadIdx.x;
    int64_t sel = 0, dl = -1, dv_i = 0;
    if (i < c) {
      const int64_t k = lf[i];
      dl = dt[k];
      dv_i = dv[k];
      sel = (dl >= 0 && din[i] < 0) ? 1 : 0;
    }
    int64_t chunk, chunk_dv;
    const int64_t pos = carry + block_exclusive_scan(sel, &chunk);
    block_exclusive_scan(dv_i, &chunk_dv);
    if (sel) {
      out[HEADER + pos] = i;
      out[HEADER + c + pos] = dl;
    }
    carry += chunk;
    dsum += chunk_dv;
  }
  const int64_t n_done = carry;

  carry = 0;
  int64_t bytes = 0;
  for (int64_t base = 0; base < h; base += THREADS) {
    const int64_t i = base + threadIdx.x;
    const int64_t d = i < h ? sent[i] - sin[i] : 0;
    const int64_t sel = d != 0 ? 1 : 0;
    int64_t chunk, chunk_d;
    const int64_t pos = carry + block_exclusive_scan(sel, &chunk);
    block_exclusive_scan(d, &chunk_d);
    if (sel) {
      out[HEADER + 2 * c + pos] = i;
      out[HEADER + 2 * c + h + pos] = d;
    }
    carry += chunk;
    bytes += chunk_d;
  }

  if (threadIdx.x == 0) {
    const int64_t fwd = bytes / PACK_CELL_WIRE_BYTES;
    out[0] = fwd;
    out[1] = dsum;
    out[2] = n_done;
    out[3] = carry;
    out[4] = t_stop[w];
    forwards[w] = fwd;
  }
}

}  // namespace

// Launch on `stream` (a cudaStream_t passed as a pointer), one block per
// lane.  Does not synchronise.  Returns cudaGetLastError(): 0 when the
// launch was accepted.
extern "C" int pack_flush_batched_launch(
    const void* t_stop, const void* done_in, const void* done_tick,
    const void* last_flow, const void* delivered, const void* sent_in,
    const void* node_sent, void* buf, void* forwards, int64_t w, int64_t f,
    int64_t c, int64_t h, void* stream) {
  if (w < 1 || w > 65535) return (int)cudaErrorInvalidValue;
  pack_flush_batched_kernel<<<(unsigned)w, THREADS, 0,
                              (cudaStream_t)stream>>>(
      (const int64_t*)t_stop, (const int64_t*)done_in,
      (const int64_t*)done_tick, (const int64_t*)last_flow,
      (const int64_t*)delivered, (const int64_t*)sent_in,
      (const int64_t*)node_sent, (int64_t*)buf, (int64_t*)forwards, f, c, h);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// pack_flush_mesh: the sharded (mesh) traffic plane's packed flush, one
// block, with the trailing cross-shard slot.
//
// Replaces the flush half of the JAX package's
// shadow_tpu/parallel/mesh/exchange.py:473 make_mesh_span_flush (its
// step_flush :502-518: the gathers through last_flow_pad, global_sent
// through node_src, _pack_flush_jnp with no caps, and the trailing slot),
// after the span half csrc/mesh_span.cu.  The plain torch version is
// shadow_tpu_torch/parallel/mesh/exchange.py:mesh_span_flush_torch.
//
// From the global padded state after the span and its entry snapshots
// (done_in = done_tick[last_flow_pad], sent_in = node_sent), in the serial
// layout above with no caps, plus one slot:
//   newly[c] = done_tick[last_flow[c]] >= 0 && done_in[c] < 0
//   delta[n] = node_sent[slot] - sent_in[slot], slot = node_slot[n]
//              (0 for a node on no shard; each node lives on one shard,
//              so the JAX scatter-add through node_src is this gather)
//   [0] forwards, [1] sum of delivered[last_flow], [2] n_done,
//   [3] n_touched, [4] t_stop, ..., [5 + 2C + 2H] cross
// The chunked block scans are the serial kernel's.
// ---------------------------------------------------------------------------

namespace {

__global__ void __launch_bounds__(THREADS)
pack_flush_mesh_kernel(const int64_t* t_stop, const int64_t* forwards,
                       const int64_t* cross, const int64_t* done_tick,
                       const int64_t* delivered, const int64_t* node_sent,
                       const int64_t* done_in, const int64_t* sent_in,
                       int64_t* buf, const int64_t* last_flow,
                       const int64_t* node_slot, int64_t c, int64_t h) {
  const int64_t len = HEADER + 2 * c + 2 * h;
  for (int64_t i = HEADER + threadIdx.x; i < len; i += THREADS) buf[i] = 0;
  __syncthreads();

  int64_t carry = 0, dsum = 0;
  for (int64_t base = 0; base < c; base += THREADS) {
    const int64_t i = base + threadIdx.x;
    int64_t sel = 0, dl = -1, dv_i = 0;
    if (i < c) {
      const int64_t k = last_flow[i];
      dl = done_tick[k];
      dv_i = delivered[k];
      sel = (dl >= 0 && done_in[i] < 0) ? 1 : 0;
    }
    int64_t chunk, chunk_dv;
    const int64_t pos = carry + block_exclusive_scan(sel, &chunk);
    block_exclusive_scan(dv_i, &chunk_dv);
    if (sel) {
      buf[HEADER + pos] = i;
      buf[HEADER + c + pos] = dl;
    }
    carry += chunk;
    dsum += chunk_dv;
  }
  const int64_t n_done = carry;

  carry = 0;
  for (int64_t base = 0; base < h; base += THREADS) {
    const int64_t i = base + threadIdx.x;
    int64_t d = 0;
    if (i < h) {
      const int64_t s = node_slot[i];
      d = s >= 0 ? node_sent[s] - sent_in[s] : 0;
    }
    const int64_t sel = d != 0 ? 1 : 0;
    int64_t chunk;
    const int64_t pos = carry + block_exclusive_scan(sel, &chunk);
    if (sel) {
      buf[HEADER + 2 * c + pos] = i;
      buf[HEADER + 2 * c + h + pos] = d;
    }
    carry += chunk;
  }

  if (threadIdx.x == 0) {
    buf[0] = *forwards;
    buf[1] = dsum;
    buf[2] = n_done;
    buf[3] = carry;
    buf[4] = *t_stop;
    buf[len] = *cross;
  }
}

}  // namespace

// Launch on `stream` (a cudaStream_t passed as a pointer).  Does not
// synchronise.  Returns cudaGetLastError(): 0 when the launch was accepted.
extern "C" int pack_flush_mesh_launch(
    const void* t_stop, const void* forwards, const void* cross,
    const void* done_tick, const void* delivered, const void* node_sent,
    const void* done_in, const void* sent_in, void* buf,
    const void* last_flow, const void* node_slot, int64_t c, int64_t h,
    void* stream) {
  pack_flush_mesh_kernel<<<1, THREADS, 0, (cudaStream_t)stream>>>(
      (const int64_t*)t_stop, (const int64_t*)forwards,
      (const int64_t*)cross, (const int64_t*)done_tick,
      (const int64_t*)delivered, (const int64_t*)node_sent,
      (const int64_t*)done_in, (const int64_t*)sent_in, (int64_t*)buf,
      (const int64_t*)last_flow, (const int64_t*)node_slot, c, h);
  return (int)cudaGetLastError();
}
