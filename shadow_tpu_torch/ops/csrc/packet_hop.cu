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
// Where the operands live.  On the main path (ops/round_step.py
// packet_hop_mapped) `packed`, `deliver` and `keep` are the round's own
// page-locked host buffers, mapped into the card's address space: the
// kernel reads the batch and writes its results over the host link, so a
// round is one launch and one event, with no copy before or after it.  The
// topology matrices stay in device memory.  The same kernel takes device
// buffers (packet_hop_packed on CUDA tensors).
//
// Bound.  Per lane the kernel reads 24 B of packed input and gathers 12 B
// (int64 latency + f32 reliability) and writes 9 B (int64 deliver + one
// keep byte), so a B = 512 batch moves ~23 KB: a few nanoseconds of HBM
// time at 3.35 TB/s, and the 20-round cipher is ~100 integer operations a
// lane.  What bounds a round is latency: the launch, one read of the batch
// across the host link (about a microsecond), the dependent gather, and the
// writes back.  So every host read is issued at once, before any work that
// depends on one: thread 0 of a block reads the header, and each warp reads
// its 32 rows (768 contiguous bytes) as 16-byte loads into shared memory,
// two loads a lane at most; one barrier, then each lane takes its row from
// shared memory.  The writes are whole words: `deliver` as one 8-byte store
// a lane (256 contiguous bytes a warp), `keep` as the warp's 32 bytes from
// one ballot, 8 bytes by each of four lanes (a byte store to host memory
// is a transaction of its own).
//
// Gather indices come from the host's topology rows and are always in
// [0, A); they are clamped to that range anyway so that a bad batch can
// never read outside the matrices (the plain version clamps the same way).

#include <cstdint>
#include <cuda_runtime.h>

#include "threefry.cuh"

namespace {

using threefry::threefry2x32_x0;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
// a warp's 32 rows (96 words) and one word of slack at each end, for the
// 16-byte alignment of the loads
constexpr int STAGE = 32 * 3 + 2;

__device__ __forceinline__ int clamp_row(int r, int a) {
  return r < 0 ? 0 : (r >= a ? a - 1 : r);
}

__global__ void __launch_bounds__(THREADS)
packet_hop_kernel(const int64_t* __restrict__ latency,
                  const float* __restrict__ reliability, int a,
                  const int64_t* __restrict__ packed, int b,
                  uint32_t key_lo, uint32_t key_hi, int64_t bootstrap_end,
                  int64_t* __restrict__ deliver, uint8_t* __restrict__ keep) {
  __shared__ __align__(16) int64_t stage[WARPS][STAGE];
  __shared__ int64_t header[2];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t first = (int64_t)blockIdx.x * THREADS + warp * 32;
  const int64_t i = first + lane;

  // -- every host read of the block, issued together (`packed` is 16-byte
  // aligned: the wrappers refuse it otherwise)
  if (threadIdx.x == 0) {
    const int4 h = *(const int4*)packed;
    header[0] = ((int64_t)(uint32_t)h.y << 32) | (uint32_t)h.x;
    header[1] = ((int64_t)(uint32_t)h.w << 32) | (uint32_t)h.z;
  }
  // the warp's rows are words [lo, hi) of the 3 + 3B
  const int64_t words = 3 + 3 * (int64_t)b;
  const int64_t lo = 3 + 3 * first;
  const int64_t last = first + 32 < b ? first + 32 : b;
  const int64_t hi = 3 + 3 * last;
  // 16-byte pairs of words from the even word at or below lo; the
  // buffer's last word (3 + 3B is odd) is read alone
  const int64_t base = lo & ~(int64_t)1;
  if (first < b) {
    const int64_t pairs = (hi - base + 1) >> 1;
    for (int64_t p = lane; p < pairs; p += 32) {
      const int64_t w = base + 2 * p;
      int64_t* dst = &stage[warp][2 * p];
      if (w + 1 < words) {
        const int4 v = *(const int4*)(packed + w);
        dst[0] = ((int64_t)(uint32_t)v.y << 32) | (uint32_t)v.x;
        dst[1] = ((int64_t)(uint32_t)v.w << 32) | (uint32_t)v.z;
      } else {
        dst[0] = packed[w];
      }
    }
  }
  __syncthreads();

  bool kept = false;
  if (i < b) {
    const int64_t* row = &stage[warp][lo + 3 * lane - base];
    const int64_t w0 = row[0];
    const uint64_t uid = (uint64_t)row[1];
    const int64_t send = row[2];
    const int src = clamp_row((int)(w0 >> 32), a);
    const int dst = clamp_row((int)(w0 & 0xFFFFFFFFLL), a);
    const int64_t at = (int64_t)src * a + dst;
    const int64_t lat = latency[at];
    const float rel = reliability[at];
    const uint32_t x0 = threefry2x32_x0(key_lo, key_hi, (uint32_t)uid,
                                        (uint32_t)(uid >> 32));
    const float u = __uint2float_rn(x0 >> 8) * 0x1p-24f;
    kept = ((send < bootstrap_end) || (rel >= 1.0f) || (u <= rel)) &&
           i < header[0];
    const int64_t t = send + lat;
    deliver[i] = t > header[1] ? t : header[1];
  }
  // keep: the warp's 32 bytes from one ballot, 8 a lane on lanes 0-3
  const unsigned bits = __ballot_sync(FULL, kept);
  if (lane < 4) {
    const int64_t at = first + 8 * lane;
    const unsigned byte = (bits >> (8 * lane)) & 0xFFu;
    if (at + 8 <= b && ((uintptr_t)(keep + at) & 7) == 0) {
      uint64_t v = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) v |= (uint64_t)((byte >> j) & 1u) << (8 * j);
      *(uint64_t*)(keep + at) = v;
    } else {
      for (int j = 0; j < 8 && at + j < b; ++j)
        keep[at + j] = (uint8_t)((byte >> j) & 1u);
    }
  }
}

}  // namespace

// Launch on `stream` (a cudaStream_t passed as a pointer).  Does not
// synchronise.  Returns cudaGetLastError(): 0 when the launch was accepted.
// The buffers may be device memory or mapped page-locked host memory (their
// device pointers); `packed` must be 16-byte aligned.
extern "C" int packet_hop_launch(const void* latency, const void* reliability,
                                 int a, const void* packed, int b,
                                 uint32_t key_lo, uint32_t key_hi,
                                 int64_t bootstrap_end, void* deliver,
                                 void* keep, void* stream) {
  const int blocks = (b + THREADS - 1) / THREADS;
  packet_hop_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const int64_t*)latency, (const float*)reliability, a,
      (const int64_t*)packed, b, key_lo, key_hi, bootstrap_end,
      (int64_t*)deliver, (uint8_t*)keep);
  return (int)cudaGetLastError();
}

// The device pointer of host memory `host` on the current device: *type is
// the cudaMemoryType cudaPointerGetAttributes reports (1 = page-locked
// host memory), *device_ptr its device address or null when it has none.
// Returns 0, or the CUDA error of the query.
extern "C" int packet_hop_map_host(const void* host, int* type,
                                   void** device_ptr) {
  cudaPointerAttributes attr;
  const cudaError_t err = cudaPointerGetAttributes(&attr, host);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  *type = (int)attr.type;
  *device_ptr = attr.type == cudaMemoryTypeHost ? attr.devicePointer : nullptr;
  return 0;
}
