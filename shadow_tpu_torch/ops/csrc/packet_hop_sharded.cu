// packet_hop_sharded: the packet hop with row-sharded path matrices, one
// thread per packet, for Hopper (sm_90a).
//
// Replaces the JAX package's shadow_tpu/ops/round_step.py:272
// (_make_matrix_sharded_hop_step -> shard_body, :287-311, with _finish_hop
// :85): the [A_pad, A] latency (int64) and reliability (f32) matrices are
// split into D row slices, each its own allocation (a shard's rows: A_pad =
// A rounded up to a multiple of D, rows_per = A_pad / D); the padded batch
// is replicated.  The plain torch version is
// shadow_tpu_torch/ops/round_step.py:matrix_sharded_hop_reference; the two
// agree bit for bit.
//
// It also replaces round_step.py:403 (_make_batch_sharded_2out: the padded
// batch split into D slices, the matrices replicated, packet_hop_step :59
// on each): the wrapper launches this entry once per batch slice with
// d = 1 and the whole [A, A] matrices as the one row slice, which is the
// plain hop on that slice (plain version: batch_sharded_hop_reference).
//
// Per lane i (the columns of round_step._padded_batch):
//   for each shard s (the shard_map body, then the psum over the mesh):
//     local = src - s*rows_per; mine = 0 <= local < rows_per
//     lat  += mine ? lat_s[local, dst] : 0
//     rel  += mine ? rel_s[local, dst] : 0.0f
//   then _finish_hop: keep = (send < bootstrap_end | rel >= 1 | u <= rel)
//   & valid, deliver = max(send + lat, barrier), u from the Threefry draw.
// Only the shard whose rows hold the packet's src gives a non-zero entry.
// Adding f32 zeros is exact for rel >= 0 (x + 0.0f == x; the reliabilities
// are probabilities), so the sum over the shards, in any order, is the
// entry itself — the psum's result bit for bit.
//
// Bound: per lane 24 B of columns plus one 12 B gather from one shard (the
// other shards' entries are not read: their `mine` is false) and 9 B of
// output; the cipher is ~100 integer operations.  Launch-bound at the
// batch sizes of a round, like csrc/packet_hop.cu.

#include <cstdint>
#include <cuda_runtime.h>

#include "threefry.cuh"

namespace {

using threefry::threefry2x32_x0;

constexpr int MAX_SHARDS = 64;

struct ShardRows {
  const int64_t* lat[MAX_SHARDS];  // shard s's [rows_per, A] latency rows
  const float* rel[MAX_SHARDS];    // and reliability rows
};

__device__ __forceinline__ int clamp_row(int r, int a) {
  return r < 0 ? 0 : (r >= a ? a - 1 : r);
}

__global__ void packet_hop_sharded_kernel(
    const ShardRows rows, int d, int rows_per, int a,
    const int32_t* __restrict__ src_rows, const int32_t* __restrict__ dst_rows,
    const uint32_t* __restrict__ uid_lo, const uint32_t* __restrict__ uid_hi,
    const int64_t* __restrict__ send, const uint8_t* __restrict__ valid,
    int b, uint32_t key_lo, uint32_t key_hi, int64_t bootstrap_end,
    int64_t barrier, int64_t* __restrict__ deliver,
    uint8_t* __restrict__ keep) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= b) return;
  const int src = clamp_row(src_rows[i], a);
  const int dst = clamp_row(dst_rows[i], a);
  int64_t lat = 0;
  float rel = 0.0f;
  // the masked gather on every shard, summed over the shards in shard
  // order: the shard_map body and its psum
  for (int s = 0; s < d; ++s) {
    const int local = src - s * rows_per;
    const bool mine = local >= 0 && local < rows_per;
    const int64_t at = (int64_t)(mine ? local : 0) * a + dst;
    lat += mine ? rows.lat[s][at] : (int64_t)0;
    rel += mine ? rows.rel[s][at] : 0.0f;
  }
  const uint32_t x0 = threefry2x32_x0(key_lo, key_hi, uid_lo[i], uid_hi[i]);
  const float u = __uint2float_rn(x0 >> 8) * 0x1p-24f;
  const int64_t s = send[i];
  const bool kept = (s < bootstrap_end) || (rel >= 1.0f) || (u <= rel);
  keep[i] = (kept && valid[i]) ? 1 : 0;
  const int64_t t = s + lat;
  deliver[i] = t > barrier ? t : barrier;
}

}  // namespace

// Launch on `stream` (a cudaStream_t passed as a pointer).  `lat_rows` and
// `rel_rows` are host arrays of the D slices' device pointers.  Does not
// synchronise.  Returns cudaGetLastError(): 0 when the launch was accepted.
extern "C" int packet_hop_sharded_launch(
    const void* const* lat_rows, const void* const* rel_rows, int d,
    int rows_per, int a, const void* src, const void* dst,
    const void* uid_lo, const void* uid_hi, const void* send,
    const void* valid, int b, uint32_t key_lo, uint32_t key_hi,
    int64_t bootstrap_end, int64_t barrier, void* deliver, void* keep,
    void* stream) {
  if (d < 1 || d > MAX_SHARDS || rows_per < 1 || b < 1 ||
      (int64_t)d * rows_per < a)
    return (int)cudaErrorInvalidValue;
  ShardRows rows;
  for (int s = 0; s < MAX_SHARDS; ++s) {
    rows.lat[s] = s < d ? (const int64_t*)lat_rows[s] : nullptr;
    rows.rel[s] = s < d ? (const float*)rel_rows[s] : nullptr;
  }
  const int threads = 256;
  const int blocks = (b + threads - 1) / threads;
  packet_hop_sharded_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      rows, d, rows_per, a, (const int32_t*)src, (const int32_t*)dst,
      (const uint32_t*)uid_lo, (const uint32_t*)uid_hi, (const int64_t*)send,
      (const uint8_t*)valid, b, key_lo, key_hi, bootstrap_end, barrier,
      (int64_t*)deliver, (uint8_t*)keep);
  return (int)cudaGetLastError();
}
