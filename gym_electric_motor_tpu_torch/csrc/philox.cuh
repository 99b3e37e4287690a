// The counter-based bit source of every fused kernel: Philox4x32-10 and
// the 24-bit uniform map, shared by pmsm_step.cuh (the PMSM and policy
// kernels) and sync_step.cuh (the synchronous-family kernels).
//
// Replaces the TPU's on-core PRNG (pltpu.prng_random_bits, and the
// interpret-mode xorshift of _make_rng in
// gym_electric_motor_tpu/ops/pallas_common.py:863-903) and
// _uniform_from_bits (:25-31).  The bits of one call are a pure function of
// (key, counter), so a kernel and its plain PyTorch version
// (gym_electric_motor_tpu_torch/ops/fused_common.py) draw the same bits
// whatever the launch geometry.
#pragma once

#include <cstdint>

// Philox4x32-10 (Salmon et al., SC'11; the constants of Random123).
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k.x += 0x9E3779B9u;
      k.y += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
    const uint32_t lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

// Top 24 bits -> [0, 1) (pallas_common._uniform_from_bits).
__device__ __forceinline__ float uniform24(uint32_t b) {
  return (float)(int)(b >> 8) * (1.0f / 16777216.0f);
}
