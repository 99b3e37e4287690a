// The PMSM step's draws on the shared-memory ring of ring_pipe.cuh: what
// producer warps draw for a step of the Finite-CC-PMSM random step
// (pmsm_step.cuh) whatever the state, and what the consumer warps take by
// selects.  Four loops run on it with Wiener references: the policy
// evaluation rollout (fused_policy.cu; with the action uniform where it
// samples, without it where it is greedy), the FOC closed loop
// (fused_foc.cu, without it: the controller gives the voltages), and the
// main path's random rollout pmsm_rollout_random and random recorder
// pmsm_record_random (fused_pmsm.cu, with the action code in its place).
//
// The split.  A step draws through pmsm_draw(key, env, t, slot) alone:
// SLOT_STEP gives the action word (w.x: its uniform for a policy, its low
// three bits for the random action) and the Box-Muller pair (w.y, w.z) that
// feeds both references, SLOT_PARAMS the sub-episode length and sigma a
// regenerating reference takes, SLOT_RESET the value a reference takes
// where the env reset.  None of it depends on the state, so the producer
// computes all of it at every step, in the operand order of
// wiener_advance_pair and wiener_advance: the action uniform or code, both
// draws (rad cos theta, rad sin theta), each reference's candidate length
// and sigma (wiener_params) and its candidate reset value, 9 words a step
// (8 where the action is greedy and draws nothing).  The consumer keeps
// what depends on the state: the regeneration test rk >= rl || violated,
// the rk update, the clipped random walk and the reset, with the
// candidates taken by selects.  The same functions on the same operands,
// built with -fmad=false, make the ring and the one-thread step equal bit
// for bit.
#pragma once

#include "pmsm_step.cuh"
#include "ring_pipe.cuh"

// The words of a step: the action uniform (where the action samples one),
// then kRefWords per reference (d, then q).
template <bool kUniform>
__host__ __device__ constexpr int pmsm_ring_words() {
  return (kUniform ? 1 : 0) + 2 * kRefWords;
}

// The words of the random rollout's step: the action code, then the
// references' words, as pmsm_ring_words<true> with the code in place of
// the uniform.
constexpr int kPmsmActionWords = 1 + 2 * kRefWords;

struct PmsmDraws {
  float u;                  // the action uniform, uniform24(w.x)
  uint32_t action;          // the random action code, w.x & 7 (pmsm_random_step)
  RefCandidates<2> c;       // draw, candidate length, sigma and reset value of d and q
};

// Producer side: what step t draws, whatever the state.
__device__ __forceinline__ PmsmDraws pmsm_draws(const PmsmConst& k, uint2 key, uint32_t env,
                                                uint32_t t) {
  PmsmDraws d;
  const uint4 w = pmsm_draw(key, env, t, SLOT_STEP);
  d.u = uniform24(w.x);
  d.action = w.x & 7u;
  const float u1 = uniform24(w.y);
  const float u2 = uniform24(w.z);
  const float rad = sqrtf(-2.0f * logf(fmaxf(u1, k.v[C_U_MIN])));
  const float theta = k.v[C_TWO_PI] * u2;
  d.c.draw[0] = rad * cosf(theta);
  d.c.draw[1] = rad * sinf(theta);
  const uint4 p = pmsm_draw(key, env, t, SLOT_PARAMS);
  wiener_params(k, p.x, p.z, d.c.rl[0], d.c.rs[0]);
  wiener_params(k, p.y, p.w, d.c.rl[1], d.c.rs[1]);
  const uint4 r = pmsm_draw(key, env, t, SLOT_RESET);
  const float m = k.v[C_MARGIN];
  d.c.rv[0] = (2.0f * uniform24(r.x) - 1.0f) * m;
  d.c.rv[1] = (2.0f * uniform24(r.y) - 1.0f) * m;
  return d;
}

template <bool kUniform>
__device__ __forceinline__ RingWords<pmsm_ring_words<kUniform>()> pmsm_draws_pack(
    const PmsmDraws& d) {
  RingWords<pmsm_ring_words<kUniform>()> x;
  if (kUniform) x.w[0] = __float_as_uint(d.u);
  pack_refs<2>(d.c, kUniform ? 1 : 0, x);
  return x;
}

template <bool kUniform>
__device__ __forceinline__ PmsmDraws pmsm_draws_unpack(
    const RingWords<pmsm_ring_words<kUniform>()>& x) {
  PmsmDraws d;
  d.u = kUniform ? __uint_as_float(x.w[0]) : 0.0f;
  d.c = unpack_refs<2>(x, kUniform ? 1 : 0);
  return d;
}

// The random rollout's words: the action code as an integer word.
__device__ __forceinline__ RingWords<kPmsmActionWords> pmsm_action_draws_pack(const PmsmDraws& d) {
  RingWords<kPmsmActionWords> x;
  x.w[0] = d.action;
  pack_refs<2>(d.c, 1, x);
  return x;
}

__device__ __forceinline__ PmsmDraws pmsm_action_draws_unpack(
    const RingWords<kPmsmActionWords>& x) {
  PmsmDraws d;
  d.u = 0.0f;
  d.action = x.w[0];
  d.c = unpack_refs<2>(x, 1);
  return d;
}

// Consumer side: wiener_advance with the step's draws and candidates given,
// taken by selects.
__device__ __forceinline__ void pmsm_advance_candidates(const PmsmConst& k,
                                                        const RefCandidates<2>& c, bool violated,
                                                        PmsmEnv& st) {
  const bool regen_d = (st.rk_d >= st.rl_d) || violated;
  const bool regen_q = (st.rk_q >= st.rl_q) || violated;
  st.rl_d = regen_d ? c.rl[0] : st.rl_d;
  st.rs_d = regen_d ? c.rs[0] : st.rs_d;
  st.rl_q = regen_q ? c.rl[1] : st.rl_q;
  st.rs_q = regen_q ? c.rs[1] : st.rs_q;
  st.rk_d = (regen_d ? 0.0f : st.rk_d) + 1.0f;
  st.rk_q = (regen_q ? 0.0f : st.rk_q) + 1.0f;
  const float m = k.v[C_MARGIN];
  const float v_d = fminf(fmaxf(st.rv_d + st.rs_d * c.draw[0], -m), m);
  const float v_q = fminf(fmaxf(st.rv_q + st.rs_q * c.draw[1], -m), m);
  st.rv_d = violated ? c.rv[0] : v_d;
  st.rv_q = violated ? c.rv[1] : v_q;
}
