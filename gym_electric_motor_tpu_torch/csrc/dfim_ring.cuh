// The DFIM family's ring: what the producer warps of the warp-specialised
// random kernels draw (fused_dfim.cu's random rollout,
// fused_dfim_record.cu's random recorder) and what their consumer warps
// take from it, over the roles and barriers of ring_pipe.cuh and the
// candidates of draw_ring.cuh.  Every value a DFIM random step draws
// depends on the constants alone: the action (both bridges' bits in one
// word, or six duties with the ACTION_C call) and per reference row the
// Box-Muller draw, the candidate length and sigma and the candidate reset
// value.  The consumer keeps the state, the constant-speed rotation and the
// reference rows; the same functions on the same operands make both kernels
// equal to their one-thread kernels and plain versions bit for bit.
#pragma once

#include <cstdint>

#include "dfim_step.cuh"
#include "draw_ring.cuh"

// Ring words a step: the action (both bridges' bits in one word, or six
// duties), then kRefWords per reference row.
template <bool FINITE, int NREF>
__host__ __device__ constexpr int dfim_ring_words() {
  return (FINITE ? 1 : 6) + kRefWords * NREF;
}

// What step t draws, whatever the state: the action and the reference
// rows' candidates, in dfim_random_step's operand order.
template <int NREF>
struct DfimDraws {
  DfimAction a;
  RefCandidates<NREF> c;
};

template <bool FINITE, int NREF>
__device__ __forceinline__ DfimDraws<NREF> dfim_draws(const DfimConst& k, uint2 key, uint32_t env,
                                                     uint32_t t, bool odd, float& zb) {
  DfimDraws<NREF> d;
  const uint4 w = drive_draw(key, env, t, DRIVE_SLOT_STEP);
  d.a = dfim_random_action<FINITE>(key, env, t, w);
  d.c = ref_candidates<NREF>(k.ref, key, env, t, w, odd, zb);
  return d;
}

template <bool FINITE, int NREF>
__device__ __forceinline__ RingWords<dfim_ring_words<FINITE, NREF>()> dfim_draws_pack(
    const DfimDraws<NREF>& d) {
  RingWords<dfim_ring_words<FINITE, NREF>()> x;
  if constexpr (FINITE) {
    x.w[0] = (uint32_t)(d.a.s.bits | (d.a.r.bits << 3));
  } else {
    pack_b6<false>(d.a.s, 0, x);
    pack_b6<false>(d.a.r, 3, x);
  }
  pack_refs<NREF>(d.c, FINITE ? 1 : 6, x);
  return x;
}

template <bool FINITE, int NREF>
__device__ __forceinline__ DfimDraws<NREF> dfim_draws_unpack(
    const RingWords<dfim_ring_words<FINITE, NREF>()>& x) {
  DfimDraws<NREF> d;
  if constexpr (FINITE) {
    d.a.s.bits = (int)(x.w[0] & 7u);
    d.a.r.bits = (int)(x.w[0] >> 3);
    d.a.s.a = d.a.s.b = d.a.s.c = d.a.r.a = d.a.r.b = d.a.r.c = 0.0f;
  } else {
    d.a.s = unpack_b6<false>(x, 0);
    d.a.r = unpack_b6<false>(x, 3);
  }
  d.c = unpack_refs<NREF>(x, FINITE ? 1 : 6);
  return d;
}

// The recorder's consumer step: dfim_random_step with the step's draws
// given (the flux direction where a row refers to the dq currents, cos and
// sin of the angle under the speed ODE, dfim_action_step, the reference
// advance by the candidates); returns what the recorder stores.  The
// reducing rollout keeps its own step (fused_dfim.cu's dfim_draw_step),
// whose sums are taken before the reference advance.
template <bool FINITE, bool MECH, int NREF>
__device__ __forceinline__ DfimStepOut dfim_ring_step(const DfimConst& k, const DfimDraws<NREF>& d,
                                                      DfimState& x, float& c, float& s,
                                                      RefRows<NREF>& refs) {
  float fc = 1.0f, fs = 0.0f;
  if (k.flag[DF_NEEDS_DQ]) dfim_flux_dir(k, x, fc, fs);
  if (MECH) {
    c = cosf(x.eps);
    s = sinf(x.eps);
  }
  const DfimStepOut o = dfim_action_step<FINITE, MECH, NREF>(k, d.a, x, c, s, fc, fs, refs);
  ref_advance_candidates<NREF>(k.ref, d.c, o.done != 0.0f, refs);
  return o;
}
