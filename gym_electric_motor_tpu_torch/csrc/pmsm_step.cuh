// One env-step of the Finite-CC-PMSM / SynRM fused rollouts, shared by all
// four kernels of fused_pmsm.cu so that their semantics cannot diverge.
//
// Replaces the per-step closures of _PmsmCtx in
// gym_electric_motor_tpu/ops/pallas_sync.py (physics_step_cs, :108-120) and
// the step bodies of make_fused_pmsm_rollout (:191-242) and
// make_fused_pmsm_record_rollout (:440-491).  The plain PyTorch version of
// the same arithmetic, in the same order, is
// gym_electric_motor_tpu_torch/ops/fused_sync.py.
//
// Every float constant (the baked motor, converter, reward and Wiener
// constants, and the literals 2/3, 1/sqrt(3), 2*pi, ...) arrives from the
// host as float32 in PmsmConst, so host and device round them identically.
#pragma once

#include <cstdint>

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

__device__ __forceinline__ uint4 pmsm_draw(uint2 key, uint32_t env, uint32_t t, uint32_t slot) {
  return philox4x32_10(make_uint4(env, t, slot, 0u), key);
}

// Top 24 bits -> [0, 1) (pallas_common._uniform_from_bits).
__device__ __forceinline__ float uniform24(uint32_t b) {
  return (float)(int)(b >> 8) * (1.0f / 16777216.0f);
}

__device__ __forceinline__ void pmsm_rhs(const PmsmConst& k, float i_sd, float i_sq,
                                         float u_d, float u_q, float& d_sd, float& d_sq) {
  d_sd = (k.v[C_K_A] * i_sd + k.v[C_K_B] * i_sq + u_d) * k.v[C_K_C];
  d_sq = (k.v[C_K_D] - k.v[C_K_E] * i_sq - k.v[C_K_F] * i_sd + u_q) * k.v[C_K_G];
}

// B6 bridge -> Clarke -> Park at the cycle-start angle (c, s) -> RK4 on
// (i_sd, i_sq) at constant speed -> angle advance and wrap to [0, 2*pi).
__device__ __forceinline__ void pmsm_physics(const PmsmConst& k, int action, float c, float s,
                                             float& i_sd, float& i_sq, float& eps) {
  const float ua = ((float)((action >> 2) & 1) - 0.5f) * k.v[C_U_SUP];
  const float ub = ((float)((action >> 1) & 1) - 0.5f) * k.v[C_U_SUP];
  const float uc = ((float)(action & 1) - 0.5f) * k.v[C_U_SUP];
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

__device__ __forceinline__ void pmsm_init(const PmsmConst& k, uint2 key, uint32_t env, PmsmEnv& st) {
  st.c = cosf(st.eps);
  st.s = sinf(st.eps);
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

// One random-mode step: random action, physics, incremental Park rotation
// with rsqrt renormalisation, squared-current constraint, WSE reward
// against the references, in-kernel reset, then the Wiener advance (one
// Box-Muller pair feeds both references) with sub-episode regeneration.
// Slot 1 and slot 2 are drawn only where their words are used.
__device__ __forceinline__ PmsmStepOut pmsm_random_step(const PmsmConst& k, uint2 key,
                                                        uint32_t env, uint32_t t, PmsmEnv& st) {
  const uint4 w = pmsm_draw(key, env, t, SLOT_STEP);
  PmsmStepOut out;
  out.action = (int)(w.x & 7u);
  const float c = st.c, s = st.s;
  float i_sd = st.i_sd, i_sq = st.i_sq, eps = st.eps;
  pmsm_physics(k, out.action, c, s, i_sd, i_sq, eps);
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

  const float u1 = uniform24(w.y);
  const float u2 = uniform24(w.z);
  const float rad = sqrtf(-2.0f * logf(fmaxf(u1, k.v[C_U_MIN])));
  const float theta = k.v[C_TWO_PI] * u2;
  const float draw_d = rad * cosf(theta);
  const float draw_q = rad * sinf(theta);
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
  return out;
}
