// Threefry-2x32 with 20 rounds (Salmon et al., SC'11) as a device function,
// shared by the kernels that draw from it (packet_hop.cu, phold.cu).
//
// The x0 lane only, which is all that the hop's uniform and PHOLD's peer
// draw use.  Same schedule as core/rng.py threefry2x32_np and the plain
// torch version threefry2x32_torch: uint32 lanes, the rotations TF_ROT, a
// key injection after every four rounds.  TF_PARITY and TF_ROT are a
// region generated from spec/protocol_spec.json (python -m
// shadow_tpu_torch.analysis.simgen --write); simtwin holds them to
// core/rng.py's and native/dataplane.cc's.  ops/_build.py hashes this
// header into the name of every library whose source includes it, so an
// edit rebuilds them.

#pragma once

#include <cstdint>

namespace threefry {

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int d) {
  return (x << d) | (x >> (32 - d));
}

__device__ __forceinline__ uint32_t threefry2x32_x0(uint32_t k0, uint32_t k1,
                                                    uint32_t c0, uint32_t c1) {
  // >>> simgen:begin region=cuda-threefry spec=293c930bb679 body=1749cc6cab89
  // Threefry-2x32 key-schedule parity and rotations (Salmon et al., Table 2)
  constexpr uint32_t TF_PARITY = 0x1BD11BDAu;  // SKEIN_KS_PARITY32
  constexpr int TF_ROT[8] = {13, 15, 26, 6, 17, 29, 16, 24};
  // <<< simgen:end region=cuda-threefry
  const uint32_t ks[3] = {k0, k1, TF_PARITY ^ k0 ^ k1};
  uint32_t x0 = c0 + ks[0];
  uint32_t x1 = c1 + ks[1];
#pragma unroll
  for (int block = 0; block < 5; ++block) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl32(x1, TF_ROT[(block & 1) * 4 + j]);
      x1 ^= x0;
    }
    x0 += ks[(block + 1) % 3];
    x1 += ks[(block + 2) % 3] + (uint32_t)(block + 1);
  }
  return x0;
}

}  // namespace threefry
