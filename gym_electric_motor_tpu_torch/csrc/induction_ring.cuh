// The SCIM's ring consumer: what the consumer warps of the warp-specialised
// random kernels (fused_induction.cu's random rollout,
// fused_induction_record.cu's random recorder) run on the draws of
// draw_ring.cuh's b6_draws, over the roles and barriers of ring_pipe.cuh.
// Every value a SCIM random step draws depends on the constants alone (the
// B6 action and per reference row the Box-Muller draw, the candidate length
// and sigma and the candidate reset value); the consumer keeps the state
// and the reference rows: the flux direction where a row refers to the dq
// currents, ind_action_step and the reference advance by the candidates.
// The same functions on the same operands make both kernels equal to their
// one-thread kernels and plain versions bit for bit.
#pragma once

#include <cstdint>

#include "draw_ring.cuh"
#include "induction_step.cuh"

// What depends on the state: ind_random_step with the step's draws given;
// returns what the recorder stores.
template <bool FINITE, bool MECH, int NREF>
__device__ __forceinline__ InductionStepOut ind_ring_step(const InductionConst& k,
                                                          const B6Draws<NREF>& d,
                                                          InductionState& x, RefRows<NREF>& refs) {
  float c = 1.0f, s = 0.0f;
  if (k.flag[IF_NEEDS_DQ]) ind_flux_dir(k, x, c, s);
  const InductionStepOut o = ind_action_step<FINITE, MECH, NREF>(k, d.a, x, c, s, refs);
  ref_advance_candidates<NREF>(k.ref, d.c, o.done != 0.0f, refs);
  return o;
}

// The reducing rollout's step: ind_ring_step reduced to its sums (taken
// before the reference advance, the order the rollout's SASS was counted
// in), and (WIENER false) without the advance, for the one-thread
// constant-reference loop.
template <bool FINITE, bool MECH, int NREF, bool WIENER>
__device__ __forceinline__ void ind_draw_step(const InductionConst& k, const B6Draws<NREF>& d,
                                              InductionState& x, RefRows<NREF>& refs,
                                              float& reward, float& terms) {
  float c = 1.0f, s = 0.0f;
  if (k.flag[IF_NEEDS_DQ]) ind_flux_dir(k, x, c, s);
  const InductionStepOut o = ind_action_step<FINITE, MECH, NREF>(k, d.a, x, c, s, refs);
  reward += o.reward;
  terms += o.done;
  if constexpr (WIENER) ref_advance_candidates<NREF>(k.ref, d.c, o.done != 0.0f, refs);
}
