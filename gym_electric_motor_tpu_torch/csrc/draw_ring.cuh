// The warp-specialised random rollouts of the DC, SCIM, EESM and synchronous
// families (fused_dc.cu, fused_induction.cu, fused_eesm.cu, fused_sync.cu)
// and the DC, EESM, SRM, synchronous and SCIM random recorders
// (fused_dc_record.cu, fused_eesm_record.cu, fused_srm_record.cu,
// fused_sync.cu, fused_induction_record.cu; the DC and EESM draws in
// dc_ring.cuh and eesm_ring.cuh, the SCIM's consumer step in
// induction_ring.cuh): producer warps compute every value of a
// step that does not depend on the state into a shared-memory ring, and
// consumer warps run the step, one thread per env, reading those values.
//
// The split.  Everything a random step draws comes from drive_draw(key,
// env, t, slot), and every value made of those words depends on the
// constants alone: the sampled action, each reference row's Box-Muller
// draw (with one row the sine half of an even step's pair, carried to the
// odd step after it), and the values a row would take if it regenerated
// (sub-episode length and sigma, ref_params) or if the env reset
// (ref_uniform_value).  The producer computes all of them at every step, in
// the operand order of ref_wiener_advance (common_step.cuh); the consumer
// keeps what depends on the state: the physics, the violation, the reward,
// the regeneration test rk >= rl || violated, the rk and rv update and the
// reset to zero, and takes the candidates by selects.  The same functions
// on the same operands, built with -fmad=false, make the two designs and
// the plain PyTorch version equal bit for bit.
//
// The roles, the layout and the barriers are ring_pipe.cuh's; this header
// holds what the universal families' producers draw, through
// common_step.cuh's drive_draw and DRIVE_SLOT_* slots, and what their
// consumers take by selects.
#pragma once

#include <cstdint>

#include "common_step.cuh"
#include "ring_pipe.cuh"

// Producer side: the candidates of step t from its SLOT_STEP words w, in
// the operand order of ref_wiener_advance.  With one row an even step
// (odd false) draws the pair and leaves its sine half in zb for the odd
// step after it.  The PARAMS and RESET slots are drawn at every step.
template <int NREF, class RC>
__device__ __forceinline__ RefCandidates<NREF> ref_candidates(const RC& k, uint2 key, uint32_t env,
                                                              uint32_t t, uint4 w, bool odd,
                                                              float& zb) {
  RefCandidates<NREF> c;
  uint4 x = make_uint4(0u, 0u, 0u, 0u);  // three rows: the ROW2 slot's words
  if constexpr (NREF == 3) {
    x = drive_draw(key, env, t, DRIVE_SLOT_ROW2);
    const float rad = sqrtf(-2.0f * logf(fmaxf(uniform24(w.y), k.u_min)));
    const float theta = k.two_pi * uniform24(w.z);
    c.draw[0] = rad * cosf(theta);
    c.draw[1] = rad * sinf(theta);
    const float rad2 = sqrtf(-2.0f * logf(fmaxf(uniform24(x.x), k.u_min)));
    c.draw[2] = rad2 * cosf(k.two_pi * uniform24(x.y));
  } else if (NREF == 2 || !odd) {
    const float rad = sqrtf(-2.0f * logf(fmaxf(uniform24(w.y), k.u_min)));
    const float theta = k.two_pi * uniform24(w.z);
    c.draw[0] = rad * cosf(theta);
    if (NREF == 2) {
      c.draw[NREF - 1] = rad * sinf(theta);
    } else {
      zb = rad * sinf(theta);
    }
  } else {
    c.draw[0] = zb;
  }
  const uint4 p = drive_draw(key, env, t, DRIVE_SLOT_PARAMS);
#pragma unroll
  for (int r = 0; r < NREF; ++r) {
    ref_params(k, r, r == 2 ? x.z : (r ? p.y : p.x), r == 2 ? x.w : (r ? p.w : p.z), c.rl[r],
               c.rs[r]);
  }
  const uint4 q = drive_draw(key, env, t, DRIVE_SLOT_RESET);
#pragma unroll
  for (int r = 0; r < NREF; ++r) c.rv[r] = ref_uniform_value(k, r, r == 2 ? q.z : (r ? q.y : q.x));
  return c;
}


// A B6 bridge's action in the ring (the SCIM's and the synchronous
// family's random rollouts): the 3 bits in one word (finite), or the three
// duty commands' float bits (continuous).
template <bool FINITE>
__host__ __device__ constexpr int b6_ring_words() {
  return FINITE ? 1 : 3;
}

template <bool FINITE, int W>
__device__ __forceinline__ void pack_b6(const B6Action& a, int j0, RingWords<W>& x) {
  if constexpr (FINITE) {
    x.w[j0] = (uint32_t)a.bits;
  } else {
    x.w[j0] = __float_as_uint(a.a);
    x.w[j0 + 1] = __float_as_uint(a.b);
    x.w[j0 + 2] = __float_as_uint(a.c);
  }
}

template <bool FINITE, int W>
__device__ __forceinline__ B6Action unpack_b6(const RingWords<W>& x, int j0) {
  B6Action a;
  if constexpr (FINITE) {
    a.bits = (int)x.w[j0];
    a.a = a.b = a.c = 0.0f;
  } else {
    a.bits = 0;
    a.a = __uint_as_float(x.w[j0]);
    a.b = __uint_as_float(x.w[j0 + 1]);
    a.c = __uint_as_float(x.w[j0 + 2]);
  }
  return a;
}

// What step t of a B6 bridge's random rollout draws, whatever the state
// (the SCIM's and the synchronous family's): the action and (WIENER) the
// reference rows' candidates, in the one-thread step's operand order; in
// the ring the action's b6_ring_words, then kRefWords per row.
template <int NREF>
struct B6Draws {
  B6Action a;
  RefCandidates<NREF> c;
};

template <bool FINITE, int NREF>
__host__ __device__ constexpr int b6_draw_words() {
  return b6_ring_words<FINITE>() + kRefWords * NREF;
}

template <bool FINITE, int NREF, bool WIENER, class RC>
__device__ __forceinline__ B6Draws<NREF> b6_draws(const RC& k, uint2 key, uint32_t env,
                                                  uint32_t t, bool odd, float& zb) {
  B6Draws<NREF> d;
  const uint4 w = drive_draw(key, env, t, DRIVE_SLOT_STEP);
  d.a = b6_random_action<FINITE>(key, env, t, w);
  if constexpr (WIENER) d.c = ref_candidates<NREF>(k, key, env, t, w, odd, zb);
  return d;
}

template <bool FINITE, int NREF>
__device__ __forceinline__ RingWords<b6_draw_words<FINITE, NREF>()> b6_draws_pack(
    const B6Draws<NREF>& d) {
  RingWords<b6_draw_words<FINITE, NREF>()> x;
  pack_b6<FINITE>(d.a, 0, x);
  pack_refs<NREF>(d.c, b6_ring_words<FINITE>(), x);
  return x;
}

template <bool FINITE, int NREF>
__device__ __forceinline__ B6Draws<NREF> b6_draws_unpack(
    const RingWords<b6_draw_words<FINITE, NREF>()>& x) {
  B6Draws<NREF> d;
  d.a = unpack_b6<FINITE>(x, 0);
  d.c = unpack_refs<NREF>(x, b6_ring_words<FINITE>());
  return d;
}

// Consumer side: ref_wiener_advance with the draws and candidates of the
// step given, taken by selects: a regenerating row takes the candidate
// length and sigma, every row advances by its sigma times its draw within
// the margins, and a violating env's rows take the candidate reset values.
template <int NREF, class RC>
__device__ __forceinline__ void ref_advance_candidates(const RC& k, const RefCandidates<NREF>& c,
                                                       bool violated, RefRows<NREF>& refs) {
#pragma unroll
  for (int r = 0; r < NREF; ++r) {
    const bool regen = (refs.rk[r] >= refs.rl[r]) || violated;
    refs.rl[r] = regen ? c.rl[r] : refs.rl[r];
    refs.rs[r] = regen ? c.rs[r] : refs.rs[r];
    refs.rk[r] = (regen ? 0.0f : refs.rk[r]) + 1.0f;
    refs.rv[r] = fminf(fmaxf(refs.rv[r] + refs.rs[r] * c.draw[r], k.row[r][R_MLO]), k.row[r][R_MHI]);
    refs.rv[r] = violated ? c.rv[r] : refs.rv[r];
  }
}
