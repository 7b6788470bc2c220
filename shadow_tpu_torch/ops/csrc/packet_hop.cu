// packet_hop: every inter-host packet hop of one scheduler round, one thread
// per packet, for Hopper (sm_90a).
//
// Replaces the JAX package's device step shadow_tpu/ops/round_step.py:97
// (packet_hop_step_packed + _finish_hop :85) with its drop draw
// shadow_tpu/core/rng.py:63 (threefry2x32_jnp) fused in as a __device__
// function (csrc/threefry.cuh).  The plain torch version of the same
// function is shadow_tpu_torch/ops/round_step.py:packet_hop_packed_reference;
// the two agree bit for bit on every lane, padding included.
//
// Input `packed` is int64 [1+B, 3], row-major.  Row 0 is a header
// (n = valid rows, round barrier ns, 0); data row i+1 holds
//   word0 = (src_row << 32) | dst_row
//   word1 = the packet uid (uint64 bit pattern)
//   word2 = send time ns.
// Per lane i < B:
//   lat, rel = latency[src, dst], reliability[src, dst]
//   u        = (threefry2x32(key, uid).x0 >> 8) * 2^-24          (f32, exact)
//   keep     = (send < bootstrap_end | rel >= 1 | u <= rel) & (i < n)
//   deliver  = max(send + lat, barrier)
// Padding lanes (i >= n) hold zeros, so they gather lat[0,0] and compute
// deliver exactly as the JAX step does; keep is false there.  Time stays
// int64 ns throughout: no float touches it.
//
// Bound: per lane the kernel reads 24 B of packed input and gathers 12 B
// (int64 latency + f32 reliability) and writes 9 B (int64 deliver + one
// keep byte), so a B = 512 batch moves ~23 KB: a few nanoseconds of HBM
// time at 3.35 TB/s, and the 20-round cipher is ~100 integer operations a
// lane.  What bounds a round on this card is one kernel launch plus one
// host-to-device and one device-to-host copy; the design keeps each round
// to exactly those three operations (one packed upload, no per-call
// scalars, outputs copied back into pinned host memory on the kernel's own
// stream).  Fusing rounds or capturing copy + kernel + copy as a CUDA graph
// is later work.
//
// Gather indices come from the host's topology rows and are always in
// [0, A); they are clamped to that range anyway so that a bad batch can
// never read outside the matrices (the plain version clamps the same way).

#include <cstdint>
#include <cuda_runtime.h>

#include "threefry.cuh"

namespace {

using threefry::threefry2x32_x0;

__device__ __forceinline__ int clamp_row(int r, int a) {
  return r < 0 ? 0 : (r >= a ? a - 1 : r);
}

__global__ void packet_hop_kernel(const int64_t* __restrict__ latency,
                                  const float* __restrict__ reliability,
                                  int a,
                                  const int64_t* __restrict__ packed,
                                  int b,
                                  uint32_t key_lo, uint32_t key_hi,
                                  int64_t bootstrap_end,
                                  int64_t* __restrict__ deliver,
                                  uint8_t* __restrict__ keep) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= b) return;
  const int64_t n = packed[0];
  const int64_t barrier = packed[1];
  const int64_t* row = packed + 3 * ((int64_t)i + 1);
  const int64_t w0 = row[0];
  const int64_t w1 = row[1];
  const int64_t send = row[2];

  const int src = clamp_row((int)(w0 >> 32), a);
  const int dst = clamp_row((int)(w0 & 0xFFFFFFFFLL), a);
  const int64_t at = (int64_t)src * a + dst;
  const int64_t lat = latency[at];
  const float rel = reliability[at];

  const uint64_t uid = (uint64_t)w1;
  const uint32_t x0 = threefry2x32_x0(key_lo, key_hi, (uint32_t)uid,
                                      (uint32_t)(uid >> 32));
  const float u = __uint2float_rn(x0 >> 8) * 0x1p-24f;

  const bool kept = (send < bootstrap_end) || (rel >= 1.0f) || (u <= rel);
  keep[i] = (kept && (int64_t)i < n) ? 1 : 0;
  const int64_t t = send + lat;
  deliver[i] = t > barrier ? t : barrier;
}

}  // namespace

// Launch on `stream` (a cudaStream_t passed as a pointer).  Does not
// synchronise.  Returns cudaGetLastError(): 0 when the launch was accepted.
extern "C" int packet_hop_launch(const void* latency, const void* reliability,
                                 int a, const void* packed, int b,
                                 uint32_t key_lo, uint32_t key_hi,
                                 int64_t bootstrap_end, void* deliver,
                                 void* keep, void* stream) {
  const int threads = 256;
  const int blocks = (b + threads - 1) / threads;
  packet_hop_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)latency, (const float*)reliability, a,
      (const int64_t*)packed, b, key_lo, key_hi, bootstrap_end,
      (int64_t*)deliver, (uint8_t*)keep);
  return (int)cudaGetLastError();
}
