// The DC family's ring: what the producer warps of the warp-specialised
// random kernels draw (fused_dc.cu's random rollout, fused_dc_record.cu's
// random recorder) and what their consumer warps take from it, over the
// roles and barriers of ring_pipe.cuh and the candidates of draw_ring.cuh.
// Every value a DC random step draws depends on the constants alone: the
// sampled action (one word per converter channel) and per reference row
// the Box-Muller draw, the candidate length and sigma (PARAMS) and the
// candidate reset value (RESET).  The consumer runs dc_action_step on the
// state and takes the candidates by selects; the same functions on the
// same operands make both kernels equal to their one-thread kernels and
// plain versions bit for bit.
#pragma once

#include <cstdint>

#include "dc_step.cuh"
#include "draw_ring.cuh"

// The random rollout's ring: K = 4 steps a slot, two producer warps per
// consumer warp, each drawing two steps of a slot (PERF.md: one producer
// warp per consumer warp left the consumers waiting on the producers).
using DcRing = RingShape<4, 2>;

// Ring words a step: the action (one word per converter channel: a finite
// action or a continuous one's bits), then kRefWords per reference row
// (draw_ring.cuh).
template <int MC, int NREF>
__host__ __device__ constexpr int dc_ring_words() {
  return (MC == MC_EXTEX ? 2 : 1) + kRefWords * NREF;
}

// What step t draws, whatever the state: the action and the reference
// rows' candidates.
template <int NREF>
struct DcDraws {
  DcAction a;
  RefCandidates<NREF> c;
};

template <bool FINITE, int MC, int NREF>
__device__ __forceinline__ DcDraws<NREF> dc_draws(const DcConst& k, uint2 key, uint32_t env,
                                                 uint32_t t, bool odd, float& zb) {
  DcDraws<NREF> d;
  const uint4 w = drive_draw(key, env, t, DRIVE_SLOT_STEP);
  d.a = dc_sample<FINITE, MC>(k, w);
  d.c = ref_candidates<NREF>(k.ref, key, env, t, w, odd, zb);
  return d;
}

template <bool FINITE, int MC, int NREF>
__device__ __forceinline__ RingWords<dc_ring_words<MC, NREF>()> dc_pack(const DcDraws<NREF>& d) {
  RingWords<dc_ring_words<MC, NREF>()> x;
  x.w[0] = FINITE ? (uint32_t)d.a.a0 : __float_as_uint(d.a.f0);
  if (MC == MC_EXTEX) x.w[1] = FINITE ? (uint32_t)d.a.a1 : __float_as_uint(d.a.f1);
  pack_refs<NREF>(d.c, MC == MC_EXTEX ? 2 : 1, x);
  return x;
}

template <bool FINITE, int MC, int NREF>
__device__ __forceinline__ DcDraws<NREF> dc_unpack(const RingWords<dc_ring_words<MC, NREF>()>& x) {
  DcDraws<NREF> d;
  d.a.a0 = d.a.a1 = 0;
  d.a.f0 = d.a.f1 = 0.0f;
  if (FINITE) {
    d.a.a0 = (int)x.w[0];
    if (MC == MC_EXTEX) d.a.a1 = (int)x.w[1];
  } else {
    d.a.f0 = __uint_as_float(x.w[0]);
    if (MC == MC_EXTEX) d.a.f1 = __uint_as_float(x.w[1]);
  }
  d.c = unpack_refs<NREF>(x, MC == MC_EXTEX ? 2 : 1);
  return d;
}

// What depends on the state: dc_random_step with the step's draws given;
// returns what the recorder stores.
template <bool FINITE, bool MECH, int MC, int NREF>
__device__ __forceinline__ DcStepOut dc_ring_step(const DcConst& k, const DcDraws<NREF>& d,
                                                  DcState& x, RefRows<NREF>& refs) {
  const DcStepOut o = dc_action_step<FINITE, MECH, MC, NREF>(k, d.a, x, refs);
  ref_advance_candidates<NREF>(k.ref, d.c, o.done != 0.0f, refs);
  return o;
}

// dc_ring_step reduced to the rollout's sums (the sums before the reference
// advance, the order the rollout's SASS was counted in).
template <bool FINITE, bool MECH, int MC, int NREF>
__device__ __forceinline__ void dc_draw_step(const DcConst& k, const DcDraws<NREF>& d,
                                             DcState& x, RefRows<NREF>& refs, float& reward,
                                             float& terms) {
  const DcStepOut o = dc_action_step<FINITE, MECH, MC, NREF>(k, d.a, x, refs);
  reward += o.reward;
  terms += o.done;
  ref_advance_candidates<NREF>(k.ref, d.c, o.done != 0.0f, refs);
}
