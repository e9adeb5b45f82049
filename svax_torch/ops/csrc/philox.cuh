// Counter-based Philox4x32-10 (Salmon et al., SC'11) and the Box–Muller
// normal that the svax_torch kernels draw their noise from.
//
// A normal is addressed by (seed, stream, index): seed is the 64-bit key,
// stream and index/2 form the counter, and the two halves of one Philox
// output feed normals 2i and 2i+1. Uniforms come from the top 24 bits of
// the UNSIGNED words; u1 = (b + 0.5)·2⁻²⁴ lies strictly inside (0, 1), so
// log(u1) is finite and no clamp is needed. (Masking signed words with an
// arithmetic shift folds half the stream negative — the bug documented in
// svax/ops/combine_pallas.py's _tile_prng_normals.)
#pragma once

#include <cstdint>

namespace svax {

__device__ __forceinline__ uint4 philox4x32_10(uint4 ctr, uint2 key) {
  constexpr uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  constexpr uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const uint32_t lo0 = M0 * ctr.x, hi0 = __umulhi(M0, ctr.x);
    const uint32_t lo1 = M1 * ctr.z, hi1 = __umulhi(M1, ctr.z);
    ctr = make_uint4(hi1 ^ ctr.y ^ key.x, lo1, hi0 ^ ctr.w ^ key.y, lo0);
    key.x += W0;
    key.y += W1;
  }
  return ctr;
}

// Standard normal number `index` of stream `stream` under key `seed`.
__device__ __forceinline__ float philox_normal(unsigned long long seed,
                                               uint32_t stream,
                                               uint32_t index) {
  const uint4 r = philox4x32_10(
      make_uint4(index >> 1, stream, 0u, 0u),
      make_uint2(static_cast<uint32_t>(seed), static_cast<uint32_t>(seed >> 32)));
  const uint32_t b1 = (index & 1u) ? r.z : r.x;
  const uint32_t b2 = (index & 1u) ? r.w : r.y;
  const float u1 = (static_cast<float>(b1 >> 8) + 0.5f) * (1.0f / 16777216.0f);
  const float u2 = static_cast<float>(b2 >> 8) * (1.0f / 16777216.0f);
  return sqrtf(-2.0f * logf(u1)) * cosf(6.283185307179586f * u2);
}

}  // namespace svax
