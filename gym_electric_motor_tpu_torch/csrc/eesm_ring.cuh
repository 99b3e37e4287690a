// The EESM family's ring: what the producer warps of the warp-specialised
// random kernels draw (fused_eesm.cu's random rollout, fused_eesm_record.cu's
// random recorder) and what their consumer warps take from it, over the
// roles and barriers of ring_pipe.cuh and the candidates of draw_ring.cuh.
// Every value an EESM random step draws depends on the constants alone: the
// sampled action (finite: the B6 bits and the 4QC action; continuous: the
// four duties, with the ACTION_C call) and per reference row the
// Box-Muller draw (with three rows the ROW2 call and its second pair), the
// candidate length and sigma and the candidate reset value.  The consumer
// keeps the state, the rotation and the reference rows; the same functions
// on the same operands make both kernels equal to their one-thread kernels
// and plain versions bit for bit.  fused_eesm.cu's constant-reference loop
// draws through the same functions, one step ahead.
#pragma once

#include <cstdint>

#include "draw_ring.cuh"
#include "eesm_step.cuh"

// The random rollout's ring: K = 4 steps a slot; at constant speed two
// producer warps per consumer warp, each drawing two steps of a slot, under
// the speed ODE, where the consumer's step is the longer, one (PERF.md).
template <bool MECH>
using EesmRing = RingShape<4, MECH ? 1 : 2>;

// Ring words a step: the action (finite: the B6 bits and the 4QC action;
// continuous: the three B6 duties and the excitation duty), then kRefWords
// per reference row (draw_ring.cuh).
template <bool FINITE, int NREF>
__host__ __device__ constexpr int eesm_ring_words() {
  return (FINITE ? 2 : 4) + kRefWords * NREF;
}

// What step t draws, whatever the state: the action and (WIENER) the
// reference rows' candidates.
template <int NREF>
struct EesmDraws {
  EesmAction a;
  RefCandidates<NREF> c;
};

template <bool FINITE, int NREF, bool WIENER>
__device__ __forceinline__ EesmDraws<NREF> eesm_draws(const EesmConst& k, uint2 key, uint32_t env,
                                                     uint32_t t, bool odd, float& zb) {
  EesmDraws<NREF> d;
  const uint4 w = drive_draw(key, env, t, DRIVE_SLOT_STEP);
  d.a = eesm_random_action<FINITE>(key, env, t, w);
  if constexpr (WIENER) d.c = ref_candidates<NREF>(k.ref, key, env, t, w, odd, zb);
  return d;
}

template <bool FINITE, int NREF>
__device__ __forceinline__ RingWords<eesm_ring_words<FINITE, NREF>()> eesm_pack(
    const EesmDraws<NREF>& d) {
  RingWords<eesm_ring_words<FINITE, NREF>()> x;
  if constexpr (FINITE) {
    x.w[0] = (uint32_t)d.a.b6.bits;
    x.w[1] = (uint32_t)d.a.e_bits;
  } else {
    x.w[0] = __float_as_uint(d.a.b6.a);
    x.w[1] = __float_as_uint(d.a.b6.b);
    x.w[2] = __float_as_uint(d.a.b6.c);
    x.w[3] = __float_as_uint(d.a.e);
  }
  pack_refs<NREF>(d.c, FINITE ? 2 : 4, x);
  return x;
}

template <bool FINITE, int NREF>
__device__ __forceinline__ EesmDraws<NREF> eesm_unpack(
    const RingWords<eesm_ring_words<FINITE, NREF>()>& x) {
  EesmDraws<NREF> d;
  if constexpr (FINITE) {
    d.a.b6.bits = (int)x.w[0];
    d.a.b6.a = d.a.b6.b = d.a.b6.c = 0.0f;
    d.a.e_bits = (int)x.w[1];
    d.a.e = 0.0f;
  } else {
    d.a.b6.bits = 0;
    d.a.b6.a = __uint_as_float(x.w[0]);
    d.a.b6.b = __uint_as_float(x.w[1]);
    d.a.b6.c = __uint_as_float(x.w[2]);
    d.a.e_bits = 0;
    d.a.e = __uint_as_float(x.w[3]);
  }
  d.c = unpack_refs<NREF>(x, FINITE ? 2 : 4);
  return d;
}

// What depends on the state: eesm_random_step with the step's draws given
// ((cos, sin) of the angle under the speed ODE, the carried rotation at
// constant speed); returns what the recorder stores.
template <bool FINITE, bool MECH, int NREF, bool WIENER>
__device__ __forceinline__ EesmStepOut eesm_ring_step(const EesmConst& k, const EesmDraws<NREF>& d,
                                                      EesmState& x, float& c, float& s,
                                                      RefRows<NREF>& refs) {
  if (MECH) {
    c = cosf(x.eps);
    s = sinf(x.eps);
  }
  const EesmStepOut o = eesm_action_step<FINITE, MECH, NREF>(k, d.a, x, c, s, refs);
  if constexpr (WIENER) ref_advance_candidates<NREF>(k.ref, d.c, o.done != 0.0f, refs);
  return o;
}

// eesm_ring_step reduced to the rollout's sums (the sums before the
// reference advance, the order the rollout's SASS was counted in).
template <bool FINITE, bool MECH, int NREF, bool WIENER>
__device__ __forceinline__ void eesm_draw_step(const EesmConst& k, const EesmDraws<NREF>& d,
                                               EesmState& x, float& c, float& s,
                                               RefRows<NREF>& refs, float& reward, float& terms) {
  if (MECH) {
    c = cosf(x.eps);
    s = sinf(x.eps);
  }
  const EesmStepOut o = eesm_action_step<FINITE, MECH, NREF>(k, d.a, x, c, s, refs);
  reward += o.reward;
  terms += o.done;
  if constexpr (WIENER) ref_advance_candidates<NREF>(k.ref, d.c, o.done != 0.0f, refs);
}
