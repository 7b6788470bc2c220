// packet_hop_sharded: the packet hop of the sharded round step, both
// layouts in one launch a batch, one thread per packet, for Hopper
// (sm_90a).
//
// Replaces the JAX package's shadow_tpu/ops/round_step.py:272
// (_make_matrix_sharded_hop_step -> shard_body, :287-311, with _finish_hop
// :85): the [A_pad, A] latency (int64) and reliability (f32) matrices are
// split into D row slices, each its own allocation (a shard's rows: A_pad =
// A rounded up to a multiple of D, rows_per = A_pad / D); the padded batch
// is replicated.  Plain torch version:
// shadow_tpu_torch/ops/round_step.py:matrix_sharded_hop_reference.
//
// It also replaces round_step.py:403 (_make_batch_sharded_2out: the padded
// batch split into D slices, the matrices replicated, packet_hop_step :59
// on each): the matrices whole are the one row slice (d = 1, rows_per = A)
// and the D batch slices are the grid's y axis, so one launch covers every
// slice, as csrc/mesh_span.cu covers its D shards.  Plain torch version:
// round_step.py:batch_sharded_hop_reference.  Both agree with this kernel
// bit for bit in deliver and keep.
//
// Per lane i = slice * w + x (slice = blockIdx.y, w lanes a slice; one
// slice of the whole batch in the matrix layout):
//   s = src / rows_per (the shard that owns the src row), local = src -
//   s * rows_per; lat, rel = lat_s[local, dst], rel_s[local, dst]
//   then _finish_hop: keep = (send < bootstrap_end | rel >= 1 | u <= rel)
//   & valid, deliver = max(send + lat, barrier), u from the Threefry draw.
// The JAX step gathers on every shard with a mask and sums over the shards
// (the psum); every other shard's term is an exact zero (int64 0, f32
// +0.0), so the sum is the owner's entry — except a -0.0 entry, which the
// sum turns into +0.0.  Neither `rel >= 1` nor `u <= rel` (u >= 0) can tell
// the two zeros apart, so deliver and keep are the psum's bit for bit.
//
// The D slices' pointers live in a device table (int64 [2D]: the latency
// rows' addresses, then the reliability rows'), built once per kernel
// object by the wrapper, so a launch carries no pointer block.  A block
// copies the table into shared memory while its column loads are in
// flight.
//
// Over several cards (ops/round_step.py ShardedPacketHopKernel with a
// mesh that spans cards) each card holds its own shards' row slices only:
// `shard_lo` is the first of them, the table lists the card's d slices, and
// a lane whose src row another card owns is left to that card (no write).
// Every lane has one owner, so the cards' writes into the round's
// page-locked buffers (read and written in place through the card's
// mapping, one launch a card) never overlap, and no reduction is needed.
// The batch layout over cards gives each card its own slices of the lanes.
// On one card shard_lo is 0 and every lane's owner is in the table.
//
// Bound: per lane 25 B of columns plus one 12 B gather and 9 B of output;
// the cipher is ~100 integer operations.  Launch-bound at the batch sizes
// of a round, like csrc/packet_hop.cu.

#include <cstdint>
#include <cuda_runtime.h>

#include "threefry.cuh"

namespace {

using threefry::threefry2x32_x0;

constexpr int THREADS = 256;
constexpr int MAX_SHARDS = 64;

__device__ __forceinline__ int clamp_row(int r, int a) {
  return r < 0 ? 0 : (r >= a ? a - 1 : r);
}

__global__ void __launch_bounds__(THREADS) packet_hop_sharded_kernel(
    const int64_t* __restrict__ table, int d, int rows_per, int a,
    int shard_lo, const int32_t* __restrict__ src_rows,
    const int32_t* __restrict__ dst_rows,
    const uint32_t* __restrict__ uid_lo, const uint32_t* __restrict__ uid_hi,
    const int64_t* __restrict__ send, const uint8_t* __restrict__ valid,
    int w, uint32_t key_lo, uint32_t key_hi, int64_t bootstrap_end,
    int64_t barrier, int64_t* __restrict__ deliver,
    uint8_t* __restrict__ keep) {
  __shared__ int64_t rows[2 * MAX_SHARDS];
  if (threadIdx.x < 2 * d) rows[threadIdx.x] = table[threadIdx.x];
  const int x = blockIdx.x * THREADS + threadIdx.x;
  const bool live = x < w;
  const int64_t i = (int64_t)blockIdx.y * w + x;
  int src = 0, dst = 0;
  uint32_t lo = 0, hi = 0;
  int64_t s = 0;
  bool ok = false;
  if (live) {
    src = clamp_row(src_rows[i], a);
    dst = clamp_row(dst_rows[i], a);
    lo = uid_lo[i];
    hi = uid_hi[i];
    s = send[i];
    ok = valid[i] != 0;
  }
  __syncthreads();
  if (!live) return;
  const int owner = src / rows_per - shard_lo;  // this card's slice
  if (owner < 0 || owner >= d) return;           // another card's lane
  const int64_t at =
      (int64_t)(src - (owner + shard_lo) * rows_per) * a + dst;
  const int64_t lat = ((const int64_t*)rows[owner])[at];
  const float rel = ((const float*)rows[d + owner])[at];
  const uint32_t x0 = threefry2x32_x0(key_lo, key_hi, lo, hi);
  const float u = __uint2float_rn(x0 >> 8) * 0x1p-24f;
  const bool kept = (s < bootstrap_end) || (rel >= 1.0f) || (u <= rel);
  keep[i] = (kept && ok) ? 1 : 0;
  const int64_t t = s + lat;
  deliver[i] = t > barrier ? t : barrier;
}

}  // namespace

// Launch on `stream` (a cudaStream_t passed as a pointer): the b = slices
// * w lanes of the six columns, `table` the device table of the d row
// slices' pointers, the first of them shard shard_lo of the mesh (the
// wrapper, ops/round_step.py ShardRows, checks that the slices of a whole
// mesh cover A).  Does not synchronise.  Returns cudaGetLastError(): 0
// when the launch was accepted.
extern "C" int packet_hop_sharded_launch(
    const void* table, int d, int rows_per, int a, int shard_lo,
    const void* src, const void* dst, const void* uid_lo, const void* uid_hi,
    const void* send, const void* valid, int slices, int w, uint32_t key_lo,
    uint32_t key_hi, int64_t bootstrap_end, int64_t barrier, void* deliver,
    void* keep, void* stream) {
  if (d < 1 || d > MAX_SHARDS || rows_per < 1 || a < 1 || w < 1 ||
      slices < 1 || slices > 65535 || shard_lo < 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((w + THREADS - 1) / THREADS), (unsigned)slices);
  packet_hop_sharded_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int64_t*)table, d, rows_per, a, shard_lo, (const int32_t*)src,
      (const int32_t*)dst, (const uint32_t*)uid_lo, (const uint32_t*)uid_hi,
      (const int64_t*)send, (const uint8_t*)valid, w, key_lo, key_hi,
      bootstrap_end, barrier, (int64_t*)deliver, (uint8_t*)keep);
  return (int)cudaGetLastError();
}
