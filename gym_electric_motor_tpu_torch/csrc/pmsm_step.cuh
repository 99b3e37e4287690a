// One env-step of the Finite-CC-PMSM / SynRM fused rollouts, shared by the
// four kernels of fused_pmsm.cu, the policy kernels of fused_policy.cu and
// the FOC closed loop of fused_foc.cu so that their semantics cannot
// diverge.
//
// Replaces the per-step closures of _PmsmCtx in
// gym_electric_motor_tpu/ops/pallas_sync.py (physics_step_cs, :108-120) and
// the step bodies of make_fused_pmsm_rollout (:191-242) and
// make_fused_pmsm_record_rollout (:440-491); _policy_pmsm_ctx in
// ops/pallas_policy.py (:32-87) computes the same physics.  The plain
// PyTorch version of the same arithmetic, in the same order, is
// gym_electric_motor_tpu_torch/ops/fused_sync.py.
//
// Every float constant (the baked motor, converter, reward and Wiener
// constants, and the literals 2/3, 1/sqrt(3), 2*pi, ...) arrives from the
// host as float32 in PmsmConst, so host and device round them identically.
#pragma once

#include <cstdint>

#include "philox.cuh"

enum PmsmConstIndex {
  C_U_SUP = 0,        // supply voltage
  C_K_A,              // -r_s
  C_K_B,              // l_q * p * omega
  C_K_C,              // 1 / l_d
  C_K_D,              // -psi_p * p * omega
  C_K_E,              // r_s
  C_K_F,              // l_d * p * omega
  C_K_G,              // 1 / l_q
  C_HALF_TAU,         // 0.5 * tau
  C_TAU,              // tau
  C_SIXTH,            // tau / 6
  C_D_EPS,            // tau * p * omega: the angle advance per cycle
  C_TWO_THIRDS,       // Clarke gain
  C_INV_SQRT3,        // Clarke beta gain
  C_TWO_PI,
  C_INV_TWO_PI,
  C_COS_D,            // cos / sin of the angle advance (incremental Park)
  C_SIN_D,
  C_INV_I_LIM,        // 1 / current limit
  C_W_OVER_SPAN,      // WSE weight over the state span
  C_VIOLATION_REWARD,
  C_MARGIN,           // Wiener limit margin (nominal / limit)
  C_LN10,
  C_U_MIN,            // guard before the Box-Muller log
  N_PMSM_CONST
};

struct PmsmConst {
  float v[N_PMSM_CONST];
};

// Draw slots: the Philox counter of one call is (env, step, slot, 0).
enum PmsmSlot {
  SLOT_STEP = 0,    // (action, box-muller u1, box-muller u2, -)
  SLOT_PARAMS = 1,  // (length d, length q, sigma d, sigma q)
  SLOT_RESET = 2,   // (reset value d, reset value q, -, -)
  SLOT_INIT_A = 3,  // at step 0: (value d, value q, length d, length q)
  SLOT_INIT_B = 4   // at step 0: (sigma d, sigma q, -, -)
};

__device__ __forceinline__ uint4 pmsm_draw(uint2 key, uint32_t env, uint32_t t, uint32_t slot) {
  return philox4x32_10(make_uint4(env, t, slot, 0u), key);
}

__device__ __forceinline__ void pmsm_rhs(const PmsmConst& k, float i_sd, float i_sq,
                                         float u_d, float u_q, float& d_sd, float& d_sq) {
  d_sd = (k.v[C_K_A] * i_sd + k.v[C_K_B] * i_sq + u_d) * k.v[C_K_C];
  d_sq = (k.v[C_K_D] - k.v[C_K_E] * i_sq - k.v[C_K_F] * i_sd + u_q) * k.v[C_K_G];
}

// The phase voltages (ua, ub, uc) -> Clarke -> Park at the cycle-start
// angle (c, s) -> RK4 on (i_sd, i_sq) at constant speed -> angle advance
// and wrap to [0, 2*pi).  The finite bridge's pmsm_physics and the FOC
// kernel's continuous output (fused_foc.cu) share it.
__device__ __forceinline__ void pmsm_physics_abc(const PmsmConst& k, float ua, float ub, float uc,
                                                 float c, float s, float& i_sd, float& i_sq,
                                                 float& eps) {
  const float u_alpha = k.v[C_TWO_THIRDS] * (ua - 0.5f * (ub + uc));
  const float u_beta = k.v[C_INV_SQRT3] * (ub - uc);
  const float u_d = c * u_alpha + s * u_beta;
  const float u_q = -s * u_alpha + c * u_beta;

  const float h = k.v[C_HALF_TAU];
  float k1d, k1q, k2d, k2q, k3d, k3q, k4d, k4q;
  pmsm_rhs(k, i_sd, i_sq, u_d, u_q, k1d, k1q);
  pmsm_rhs(k, i_sd + h * k1d, i_sq + h * k1q, u_d, u_q, k2d, k2q);
  pmsm_rhs(k, i_sd + h * k2d, i_sq + h * k2q, u_d, u_q, k3d, k3q);
  pmsm_rhs(k, i_sd + k.v[C_TAU] * k3d, i_sq + k.v[C_TAU] * k3q, u_d, u_q, k4d, k4q);
  i_sd = i_sd + k.v[C_SIXTH] * (k1d + 2.0f * (k2d + k3d) + k4d);
  i_sq = i_sq + k.v[C_SIXTH] * (k1q + 2.0f * (k2q + k3q) + k4q);

  eps = eps + k.v[C_D_EPS];
  eps = eps - k.v[C_TWO_PI] * floorf(eps * k.v[C_INV_TWO_PI]);
}

// B6 bridge -> pmsm_physics_abc.
__device__ __forceinline__ void pmsm_physics(const PmsmConst& k, int action, float c, float s,
                                             float& i_sd, float& i_sq, float& eps) {
  const float ua = ((float)((action >> 2) & 1) - 0.5f) * k.v[C_U_SUP];
  const float ub = ((float)((action >> 1) & 1) - 0.5f) * k.v[C_U_SUP];
  const float uc = ((float)(action & 1) - 0.5f) * k.v[C_U_SUP];
  pmsm_physics_abc(k, ua, ub, uc, c, s, i_sd, i_sq, eps);
}

// Random mode: the drive state and both Wiener references of one env.
struct PmsmEnv {
  float i_sd, i_sq, eps, c, s;
  float rv_d, rk_d, rl_d, rs_d;  // value, step counter, length, sigma
  float rv_q, rk_q, rl_q, rs_q;
};

struct PmsmStepOut {
  int action;
  float reward, done, ref_d, ref_q;
};

// Sub-episode length ~ floor(U[500, 2000)), sigma ~ log-uniform [1e-3, 1e-1].
__device__ __forceinline__ void wiener_params(const PmsmConst& k, uint32_t b_len, uint32_t b_sig,
                                              float& rl, float& rs) {
  rl = floorf(500.0f + 1500.0f * uniform24(b_len));
  rs = expf(k.v[C_LN10] * (-3.0f + 2.0f * uniform24(b_sig)));
}

// Both Wiener references at step 0 (value, sub-episode length, sigma).
__device__ __forceinline__ void wiener_init(const PmsmConst& k, uint2 key, uint32_t env, PmsmEnv& st) {
  const uint4 a = pmsm_draw(key, env, 0u, SLOT_INIT_A);
  const uint4 b = pmsm_draw(key, env, 0u, SLOT_INIT_B);
  const float m = k.v[C_MARGIN];
  st.rv_d = (2.0f * uniform24(a.x) - 1.0f) * m;
  st.rv_q = (2.0f * uniform24(a.y) - 1.0f) * m;
  st.rk_d = 0.0f;
  st.rk_q = 0.0f;
  wiener_params(k, a.z, b.x, st.rl_d, st.rs_d);
  wiener_params(k, a.w, b.y, st.rl_q, st.rs_q);
}

__device__ __forceinline__ void pmsm_init(const PmsmConst& k, uint2 key, uint32_t env, PmsmEnv& st) {
  st.c = cosf(st.eps);
  st.s = sinf(st.eps);
  wiener_init(k, key, env, st);
}

// One step under the phase voltages (ua, ub, uc): physics, incremental Park
// rotation with rsqrt renormalisation, squared-current constraint, WSE
// reward against the references, in-kernel reset of the drive state.  The
// references are left to the caller (wiener_advance, or constant).
__device__ __forceinline__ PmsmStepOut pmsm_voltage_step(const PmsmConst& k, float ua, float ub,
                                                         float uc, PmsmEnv& st) {
  PmsmStepOut out;
  out.action = 0;
  const float c = st.c, s = st.s;
  float i_sd = st.i_sd, i_sq = st.i_sq, eps = st.eps;
  pmsm_physics_abc(k, ua, ub, uc, c, s, i_sd, i_sq, eps);
  float c_new = c * k.v[C_COS_D] - s * k.v[C_SIN_D];
  float s_new = s * k.v[C_COS_D] + c * k.v[C_SIN_D];
  const float inv = rsqrtf(c_new * c_new + s_new * s_new);
  c_new = c_new * inv;
  s_new = s_new * inv;

  const float i_sd_n = i_sd * k.v[C_INV_I_LIM];
  const float i_sq_n = i_sq * k.v[C_INV_I_LIM];
  const bool violated = (i_sd_n * i_sd_n + i_sq_n * i_sq_n) > 1.0f;
  const float wse = -(k.v[C_W_OVER_SPAN] * fabsf(i_sd_n - st.rv_d)
                      + k.v[C_W_OVER_SPAN] * fabsf(i_sq_n - st.rv_q));
  out.reward = violated ? k.v[C_VIOLATION_REWARD] : wse;
  out.done = violated ? 1.0f : 0.0f;
  out.ref_d = st.rv_d;
  out.ref_q = st.rv_q;

  st.i_sd = violated ? 0.0f : i_sd;
  st.i_sq = violated ? 0.0f : i_sq;
  st.eps = violated ? 0.0f : eps;
  st.c = violated ? 1.0f : c_new;
  st.s = violated ? 0.0f : s_new;
  return out;
}

// pmsm_voltage_step under a B6 action.
__device__ __forceinline__ PmsmStepOut pmsm_action_step(const PmsmConst& k, int action,
                                                        PmsmEnv& st) {
  const float ua = ((float)((action >> 2) & 1) - 0.5f) * k.v[C_U_SUP];
  const float ub = ((float)((action >> 1) & 1) - 0.5f) * k.v[C_U_SUP];
  const float uc = ((float)(action & 1) - 0.5f) * k.v[C_U_SUP];
  PmsmStepOut out = pmsm_voltage_step(k, ua, ub, uc, st);
  out.action = action;
  return out;
}

// Wiener advance of both references from one normal draw each, with
// sub-episode regeneration and a fresh value where the env reset.  Slot 1
// and slot 2 are drawn only where their words are used.
__device__ __forceinline__ void wiener_advance(const PmsmConst& k, uint2 key, uint32_t env,
                                               uint32_t t, float draw_d, float draw_q,
                                               bool violated, PmsmEnv& st) {
  const bool regen_d = (st.rk_d >= st.rl_d) || violated;
  const bool regen_q = (st.rk_q >= st.rl_q) || violated;
  if (regen_d || regen_q) {
    const uint4 p = pmsm_draw(key, env, t, SLOT_PARAMS);
    if (regen_d) wiener_params(k, p.x, p.z, st.rl_d, st.rs_d);
    if (regen_q) wiener_params(k, p.y, p.w, st.rl_q, st.rs_q);
  }
  st.rk_d = (regen_d ? 0.0f : st.rk_d) + 1.0f;
  st.rk_q = (regen_q ? 0.0f : st.rk_q) + 1.0f;
  const float m = k.v[C_MARGIN];
  const float v_d = fminf(fmaxf(st.rv_d + st.rs_d * draw_d, -m), m);
  const float v_q = fminf(fmaxf(st.rv_q + st.rs_q * draw_q, -m), m);
  if (violated) {
    const uint4 r = pmsm_draw(key, env, t, SLOT_RESET);
    st.rv_d = (2.0f * uniform24(r.x) - 1.0f) * m;
    st.rv_q = (2.0f * uniform24(r.y) - 1.0f) * m;
  } else {
    st.rv_d = v_d;
    st.rv_q = v_q;
  }
}

// The Wiener advance of the random step: one Box-Muller pair from the
// step's words (w.y, w.z) feeds both references.
__device__ __forceinline__ void wiener_advance_pair(const PmsmConst& k, uint2 key, uint32_t env,
                                                    uint32_t t, uint4 w, bool violated,
                                                    PmsmEnv& st) {
  const float u1 = uniform24(w.y);
  const float u2 = uniform24(w.z);
  const float rad = sqrtf(-2.0f * logf(fmaxf(u1, k.v[C_U_MIN])));
  const float theta = k.v[C_TWO_PI] * u2;
  wiener_advance(k, key, env, t, rad * cosf(theta), rad * sinf(theta), violated, st);
}

// One random-mode step: a random action (the low 3 bits of the step's
// first word), pmsm_action_step, then the Wiener advance.
__device__ __forceinline__ PmsmStepOut pmsm_random_step(const PmsmConst& k, uint2 key,
                                                        uint32_t env, uint32_t t, PmsmEnv& st) {
  const uint4 w = pmsm_draw(key, env, t, SLOT_STEP);
  const PmsmStepOut out = pmsm_action_step(k, (int)(w.x & 7u), st);
  wiener_advance_pair(k, key, env, t, w, out.done != 0.0f, st);
  return out;
}
