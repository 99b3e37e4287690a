// One env-step of the universal doubly fed induction (DFIM) fused rollouts,
// shared by the kernels of fused_dfim.cu and fused_dfim_record.cu so that the
// reducing rollout and the recorder cannot diverge.
//
// Replaces the step closures of _dfim_family in
// gym_electric_motor_tpu/ops/pallas_dfim.py (:303-782): torque and el_rhs
// (:391-404), rhs and rk4 (:406-420, :495-509, the rotor angle integrated
// with the currents and fluxes), the dual-B6 voltage fractions and _us_of on
// the no-interlock branch (:442-451, :480-493, :597-601: the stator voltages
// Clarke'd, the rotor's Clarke'd and turned into the stator frame by the
// electrical angle), flux_dir (:620-626), ref_quantities (:628-647),
// _sample_actions (:649-655), the angle wrap of step (:729-735) and violated
// (:740-745), with _rotation_protocol of ops/pallas_common.py (:1476-1494)
// for the constant-speed rotation; the reference machinery, the WSE reward,
// the polynomial load and the B6 bridges are common_step.cuh's.  The plain
// PyTorch version of the same arithmetic, in the same order, is
// gym_electric_motor_tpu_torch/ops/fused_dfim_family.py.
//
// The DFIM's electrical right-hand side is the SCIM's (induction_step.cuh)
// with the rotor-voltage terms - c_ur u_ralpha in the currents and
// + u_ralpha in the fluxes.  It is a copy and not a shared function, so
// that the SCIM's instances compile exactly as they did.  Every float
// constant arrives from the host as float32 in DfimConst, formed in double
// precision in the JAX family's expression order; the divisions by tau_sig
// and tau_r are products with their float32 reciprocals, as XLA compiles
// the JAX kernel's divisions by constants.
#pragma once

#include <cstdint>

#include "common_step.cuh"

enum DfimConstIndex {
  D_U_SUP = 0,         // supply voltage
  D_HALF_TAU,          // 0.5 * tau, the RK4 mid-stage step
  D_TAU,
  D_SIXTH,             // tau / 6
  D_TWO_THIRDS,        // Clarke gain
  D_INV_SQRT3,         // Clarke beta gain
  D_TWO_PI,
  D_INV_TWO_PI,
  D_INV_TAU_SIG,       // 1 / tau_sig, tau_sig = sigma l_s / (r_s + r_r l_m^2 / l_r^2)
  D_C_PSI,             // l_m r_r / (sigma l_s l_r^2)
  D_C_W,               // dynamic speed: l_m p / (sigma l_r l_s), times omega
  D_CW_W,              // constant speed: c_w * omega_fixed
  D_C_U,               // 1 / (sigma l_s)
  D_C_UR,              // l_m / (sigma l_r l_s), the rotor voltage's gain in the currents
  D_L_M,
  D_INV_TAU_R,         // 1 / tau_r = r_r / l_r
  D_P,                 // dynamic speed: pole pairs, times omega (flux turn and angle rate)
  D_PW,                // constant speed: p * omega_fixed, the same for both
  D_COS_D,             //   cos / sin of tau * p * omega_fixed (the incremental rotation)
  D_SIN_D,
  D_K_T,               // torque gain 1.5 p l_m / l_r
  D_LOAD_A,            // polynomial static load: a, b, c
  D_LOAD_B,
  D_LOAD_C,
  D_OMEGA_LIN,         //   a / j_total * tau_decay: below it the a-term is linear
  D_JT_OVER_TD,        //   j_total / tau_decay
  D_INV_JT,            //   1 / j_total
  D_INV_ILIM2,         // 1 / i_lim^2 (the squared constraint on |i_alphabeta|)
  D_TINY,              // |psi|^2 below it: the flux direction is (1, 0)
  D_BIAS,              // WSE reward bias
  D_VIOLATION_REWARD,
  D_LN10,
  D_U_MIN,             // guard before the Box-Muller log
  N_DFIM_CONST
};

// What a reference row refers to (the referenced quantity's code).
enum DfimQuantity { DQ_I_SD = 0, DQ_I_SQ, DQ_TORQUE, DQ_OMEGA };

enum DfimFlag {
  DF_QTY0 = 0,   // DfimQuantity of row 0
  DF_QTY1,       // and of row 1
  DF_ALL_CONST,  // every reference constant: no reference draws at all
  DF_NO_CONS,    // constraints=(): the env never terminates
  DF_FINITE,     // the template parameters the host launches
  DF_MECH,
  DF_NREF,
  DF_NEEDS_DQ,   // a row refers to i_sd or i_sq: the step takes the flux direction
  N_DFIM_FLAG
};

struct DfimConst {
  float v[N_DFIM_CONST];
  RefConst ref;   // the reference rows; two_pi, ln10 and u_min repeat D_TWO_PI, D_LN10, D_U_MIN
  int flag[N_DFIM_FLAG];
};

// The drive state of one env; w is unused at constant speed.
struct DfimState {
  float w, isa, isb, psa, psb, eps;
};

// The stator and the rotor bridge's actions: B6 bits (finite) or three
// duties each (continuous).
struct DfimAction {
  B6Action s, r;
};

struct DfimStepOut {
  DfimAction act;
  float reward, done;
  float ref[2];   // the references the reward was taken against
};

__device__ __forceinline__ float dfim_torque(const DfimConst& k, float isa, float isb, float psa,
                                             float psb) {
  return k.v[D_K_T] * (psa * isb - psb * isa);
}

// The electrical right-hand side at one RK4 stage, with the stator voltage
// (u_sal, u_sbe) and the rotor voltage in the stator frame (u_ral, u_rbe).
template <bool MECH>
__device__ __forceinline__ void dfim_el_rhs(const DfimConst& k, float w, float isa, float isb,
                                            float psa, float psb, float u_sal, float u_sbe,
                                            float u_ral, float u_rbe, float& d_isa, float& d_isb,
                                            float& d_psa, float& d_psb) {
  const float cww = MECH ? k.v[D_C_W] * w : k.v[D_CW_W];
  const float pw = MECH ? k.v[D_P] * w : k.v[D_PW];
  d_isa = -isa * k.v[D_INV_TAU_SIG] + k.v[D_C_PSI] * psa + cww * psb + k.v[D_C_U] * u_sal
          - k.v[D_C_UR] * u_ral;
  d_isb = -isb * k.v[D_INV_TAU_SIG] + k.v[D_C_PSI] * psb - cww * psa + k.v[D_C_U] * u_sbe
          - k.v[D_C_UR] * u_rbe;
  d_psa = (k.v[D_L_M] * isa - psa) * k.v[D_INV_TAU_R] - pw * psb + u_ral;
  d_psb = (k.v[D_L_M] * isb - psb) * k.v[D_INV_TAU_R] + pw * psa + u_rbe;
}

template <bool MECH>
__device__ __forceinline__ float dfim_dw(const DfimConst& k, float w, float isa, float isb,
                                         float psa, float psb) {
  return MECH ? poly_load_rhs(k.v[D_LOAD_A], k.v[D_LOAD_B], k.v[D_LOAD_C], k.v[D_OMEGA_LIN],
                              k.v[D_JT_OVER_TD], k.v[D_INV_JT], w,
                              dfim_torque(k, isa, isb, psa, psb))
              : 0.0f;
}

// Dual B6 -> Clarke of both bridges -> the rotor pair turned into the stator
// frame by the electrical angle (c, s) of the cycle start -> RK4 over
// (omega?, i_salpha, i_sbeta, psi_ralpha, psi_rbeta, eps) -> wrap of eps to
// [0, 2 pi).  At constant speed eps integrates the constant rate
// p * omega_fixed through the RK4 sum.
template <bool FINITE, bool MECH>
__device__ __forceinline__ void dfim_physics(const DfimConst& k, const DfimAction& act, float c,
                                             float s, DfimState& x) {
  float fa, fb, fc, ga, gb, gc;
  b6_fractions<FINITE>(act.s, fa, fb, fc);
  b6_fractions<FINITE>(act.r, ga, gb, gc);
  const float u_sup = k.v[D_U_SUP];
  const float ua = fa * u_sup, ub = fb * u_sup, uc = fc * u_sup;
  const float ra = ga * u_sup, rb = gb * u_sup, rc = gc * u_sup;
  const float u_sal = k.v[D_TWO_THIRDS] * (ua - 0.5f * (ub + uc));
  const float u_sbe = k.v[D_INV_SQRT3] * (ub - uc);
  const float u_ral0 = k.v[D_TWO_THIRDS] * (ra - 0.5f * (rb + rc));
  const float u_rbe0 = k.v[D_INV_SQRT3] * (rb - rc);
  const float u_ral = c * u_ral0 - s * u_rbe0;
  const float u_rbe = s * u_ral0 + c * u_rbe0;

  const float h = k.v[D_HALF_TAU], dt = k.v[D_TAU], sixth = k.v[D_SIXTH];
  float k1a, k1b, k1p, k1q, k2a, k2b, k2p, k2q, k3a, k3b, k3p, k3q, k4a, k4b, k4p, k4q;
  const float k1w = dfim_dw<MECH>(k, x.w, x.isa, x.isb, x.psa, x.psb);
  dfim_el_rhs<MECH>(k, x.w, x.isa, x.isb, x.psa, x.psb, u_sal, u_sbe, u_ral, u_rbe, k1a, k1b,
                    k1p, k1q);
  const float w2 = x.w + h * k1w;
  const float a2 = x.isa + h * k1a, b2 = x.isb + h * k1b, p2 = x.psa + h * k1p,
              q2 = x.psb + h * k1q;
  const float k2w = dfim_dw<MECH>(k, w2, a2, b2, p2, q2);
  dfim_el_rhs<MECH>(k, w2, a2, b2, p2, q2, u_sal, u_sbe, u_ral, u_rbe, k2a, k2b, k2p, k2q);
  const float w3 = x.w + h * k2w;
  const float a3 = x.isa + h * k2a, b3 = x.isb + h * k2b, p3 = x.psa + h * k2p,
              q3 = x.psb + h * k2q;
  const float k3w = dfim_dw<MECH>(k, w3, a3, b3, p3, q3);
  dfim_el_rhs<MECH>(k, w3, a3, b3, p3, q3, u_sal, u_sbe, u_ral, u_rbe, k3a, k3b, k3p, k3q);
  const float w4 = x.w + dt * k3w;
  const float a4 = x.isa + dt * k3a, b4 = x.isb + dt * k3b, p4 = x.psa + dt * k3p,
              q4 = x.psb + dt * k3q;
  const float k4w = dfim_dw<MECH>(k, w4, a4, b4, p4, q4);
  dfim_el_rhs<MECH>(k, w4, a4, b4, p4, q4, u_sal, u_sbe, u_ral, u_rbe, k4a, k4b, k4p, k4q);
  if (MECH) {
    const float p = k.v[D_P];
    x.eps = x.eps + sixth * (p * x.w + 2.0f * (p * w2 + p * w3) + p * w4);
    x.w = x.w + sixth * (k1w + 2.0f * (k2w + k3w) + k4w);
  } else {
    const float de = k.v[D_PW];
    x.eps = x.eps + sixth * (de + 2.0f * (de + de) + de);
  }
  x.isa = x.isa + sixth * (k1a + 2.0f * (k2a + k3a) + k4a);
  x.isb = x.isb + sixth * (k1b + 2.0f * (k2b + k3b) + k4b);
  x.psa = x.psa + sixth * (k1p + 2.0f * (k2p + k3p) + k4p);
  x.psb = x.psb + sixth * (k1q + 2.0f * (k2q + k3q) + k4q);
  x.eps = x.eps - k.v[D_TWO_PI] * floorf(x.eps * k.v[D_INV_TWO_PI]);
}

// cos/sin of the rotor-flux field angle as psi / |psi|, (1, 0) at zero
// flux, where the env's atan2(0, 0) is 0.
__device__ __forceinline__ void dfim_flux_dir(const DfimConst& k, const DfimState& x, float& c,
                                              float& s) {
  const float mag2 = x.psa * x.psa + x.psb * x.psb;
  const bool tiny = mag2 < k.v[D_TINY];
  const float inv = rsqrtf(tiny ? 1.0f : mag2);
  c = tiny ? 1.0f : x.psa * inv;
  s = tiny ? 0.0f : x.psb * inv;
}

// The normalised referenced quantity of a row, chosen by selects; (fc, fs)
// is the flux direction from before the step (the stale field angle).
__device__ __forceinline__ float dfim_quantity(const DfimConst& k, int row, const DfimState& x,
                                               float fc, float fs) {
  const int code = k.flag[DF_QTY0 + row];
  const float tq = dfim_torque(k, x.isa, x.isb, x.psa, x.psb);
  float q = fc * x.isa + fs * x.isb;
  q = code == DQ_I_SQ ? fc * x.isb - fs * x.isa : q;
  q = code == DQ_TORQUE ? tq : q;
  q = code == DQ_OMEGA ? x.w : q;
  return q * k.ref.row[row][R_INV_LIM];
}

// One step under an action: physics at the electrical angle (c, s), the
// squared-current constraint on |i_alphabeta|^2, the WSE reward against the
// pre-advance references, the reset of a violating env to zeros (the angle
// too) and, at constant speed, the incremental rotation with rsqrt
// renormalisation, reset to (1, 0) on a violation.  With MECH the caller
// passes (c, s) = (cos, sin)(eps).  The references are left to the caller.
template <bool FINITE, bool MECH, int NREF>
__device__ __forceinline__ DfimStepOut dfim_action_step(const DfimConst& k, const DfimAction& act,
                                                        DfimState& x, float& c, float& s,
                                                        float fc, float fs,
                                                        const RefRows<NREF>& refs) {
  DfimStepOut out;
  out.act = act;
  DfimState y = x;
  dfim_physics<FINITE, MECH>(k, act, c, s, y);
  const bool violated =
      !k.flag[DF_NO_CONS] && (y.isa * y.isa + y.isb * y.isb) * k.v[D_INV_ILIM2] > 1.0f;
  const float wse = ref_wse<NREF>(k.ref, k.v[D_BIAS], dfim_quantity(k, 0, y, fc, fs),
                                  NREF == 2 ? dfim_quantity(k, 1, y, fc, fs) : 0.0f, refs);
  out.reward = violated ? k.v[D_VIOLATION_REWARD] : wse;
  out.done = violated ? 1.0f : 0.0f;
  out.ref[0] = refs.rv[0];
  out.ref[1] = refs.rv[NREF - 1];
  x.w = violated ? 0.0f : y.w;
  x.isa = violated ? 0.0f : y.isa;
  x.isb = violated ? 0.0f : y.isb;
  x.psa = violated ? 0.0f : y.psa;
  x.psb = violated ? 0.0f : y.psb;
  x.eps = violated ? 0.0f : y.eps;
  if (!MECH) {
    const float c_new = c * k.v[D_COS_D] - s * k.v[D_SIN_D];
    const float s_new = s * k.v[D_COS_D] + c * k.v[D_SIN_D];
    const float inv = rsqrtf(c_new * c_new + s_new * s_new);
    c = violated ? 1.0f : c_new * inv;
    s = violated ? 0.0f : s_new * inv;
  }
  return out;
}

// The random action of a step: finite, one word carries both bridges, the
// stator's bits (b & 7) and the rotor's ((b >> 3) & 7); continuous, six
// duties 2 u - 1: the stator's from SLOT_STEP's words x and w and ACTION_C's
// x, the rotor's from ACTION_C's y, z and w.
template <bool FINITE>
__device__ __forceinline__ DfimAction dfim_random_action(uint2 key, uint32_t env, uint32_t t,
                                                         uint4 w) {
  const uint4 cw = FINITE ? make_uint4(0u, 0u, 0u, 0u)
                          : drive_draw(key, env, t, DRIVE_SLOT_ACTION_C);
  DfimAction act;
  act.s = b6_action_of_words<FINITE>(w, cw.x);
  if (FINITE) {
    act.r.bits = (int)((w.x >> 3) & 7u);
    act.r.a = act.r.b = act.r.c = 0.0f;
  } else {
    act.r.bits = 0;
    act.r.a = 2.0f * uniform24(cw.y) - 1.0f;
    act.r.b = 2.0f * uniform24(cw.z) - 1.0f;
    act.r.c = 2.0f * uniform24(cw.w) - 1.0f;
  }
  return act;
}

// One random-mode step: the action, the flux direction (where a row refers
// to the dq currents), (cos, sin) of the angle under the speed ODE,
// dfim_action_step, then (WIENER) the reference advance.
template <bool FINITE, bool MECH, int NREF, bool WIENER>
__device__ __forceinline__ DfimStepOut dfim_random_step(const DfimConst& k, uint2 key,
                                                        uint32_t env, uint32_t t, DfimState& x,
                                                        float& c, float& s, RefRows<NREF>& refs) {
  const uint4 w = drive_draw(key, env, t, DRIVE_SLOT_STEP);
  const DfimAction act = dfim_random_action<FINITE>(key, env, t, w);
  float fc = 1.0f, fs = 0.0f;
  if (k.flag[DF_NEEDS_DQ]) dfim_flux_dir(k, x, fc, fs);
  if (MECH) {
    c = cosf(x.eps);
    s = sinf(x.eps);
  }
  const DfimStepOut out = dfim_action_step<FINITE, MECH, NREF>(k, act, x, c, s, fc, fs, refs);
  if (WIENER) ref_wiener_advance<NREF>(k.ref, key, env, t, w, out.done != 0.0f, refs);
  return out;
}

// The buffer step's action at step t: int32 (T, 2, N) (stator bits, rotor
// bits), or float32 (T, 6, N) duty commands.
template <bool FINITE>
__device__ __forceinline__ DfimAction dfim_read_action(const int* __restrict__ act_i,
                                                       const float* __restrict__ act_f, int n,
                                                       int t, int e) {
  DfimAction a;
  if (FINITE) {
    const size_t base = (size_t)t * 2 * n + e;
    a.s.bits = act_i[base];
    a.r.bits = act_i[base + n];
    a.s.a = a.s.b = a.s.c = a.r.a = a.r.b = a.r.c = 0.0f;
  } else {
    const size_t base = (size_t)t * 6 * n + e;
    a.s.bits = a.r.bits = 0;
    a.s.a = act_f[base];
    a.s.b = act_f[base + n];
    a.s.c = act_f[base + 2 * (size_t)n];
    a.r.a = act_f[base + 3 * (size_t)n];
    a.r.b = act_f[base + 4 * (size_t)n];
    a.r.c = act_f[base + 5 * (size_t)n];
  }
  return a;
}

// The buffer step: the exact (cos, sin) of the angle every step, no
// references, no reset.
template <bool FINITE, bool MECH>
__device__ __forceinline__ void dfim_buffer_step(const DfimConst& k, const DfimAction& act,
                                                 DfimState& x) {
  dfim_physics<FINITE, MECH>(k, act, cosf(x.eps), sinf(x.eps), x);
}

// ---- what the kernels of both sources share ------------------------------

// The planes of one state, (omega or NULL, i_salpha, i_sbeta, psi_ralpha,
// psi_rbeta, eps), by value so that a kernel takes them as parameters.
struct DfimInPlanes {
  const float* p[6];
};

struct DfimPlanes {
  float* p[6];
};

template <bool MECH>
__device__ __forceinline__ DfimState dfim_load_state(const DfimInPlanes& in, int e) {
  DfimState x;
  x.w = MECH ? in.p[0][e] : 0.0f;
  x.isa = in.p[1][e];
  x.isb = in.p[2][e];
  x.psa = in.p[3][e];
  x.psb = in.p[4][e];
  x.eps = in.p[5][e];
  return x;
}

template <bool MECH>
__device__ __forceinline__ void dfim_store_state(const DfimState& x, const DfimPlanes& o,
                                                 size_t i) {
  if (MECH) o.p[0][i] = x.w;
  o.p[1][i] = x.isa;
  o.p[2][i] = x.isb;
  o.p[3][i] = x.psa;
  o.p[4][i] = x.psb;
  o.p[5][i] = x.eps;
}

inline DfimInPlanes dfim_in_planes(const float* const* in) {
  DfimInPlanes planes;
  for (int j = 0; j < 6; ++j) planes.p[j] = in[j];
  return planes;
}

inline DfimPlanes dfim_out_planes(float* const* out) {
  DfimPlanes planes;
  for (int j = 0; j < 6; ++j) planes.p[j] = out[j];
  return planes;
}

inline DfimConst dfim_load_const(const float* host, const int* flags) {
  DfimConst k;
  for (int i = 0; i < N_DFIM_CONST; ++i) k.v[i] = host[i];
  for (int r = 0; r < 2; ++r) {
    for (int j = 0; j < N_ROW_CONST; ++j) {
      k.ref.row[r][j] = host[N_DFIM_CONST + r * N_ROW_CONST + j];
    }
  }
  k.ref.two_pi = host[D_TWO_PI];
  k.ref.ln10 = host[D_LN10];
  k.ref.u_min = host[D_U_MIN];
  for (int i = 0; i < N_DFIM_FLAG; ++i) k.flag[i] = flags[i];
  k.ref.all_const = flags[DF_ALL_CONST];
  return k;
}

inline uint2 dfim_seed_key(unsigned long long seed) {
  return make_uint2((uint32_t)(seed & 0xFFFFFFFFull), (uint32_t)(seed >> 32));
}

// Instance index of (FINITE, MECH, NREF): 4 * finite + 2 * mech + nref - 1
// for the random kernels, 2 * finite + mech for the buffer kernels; -1 for
// flags no instance serves.
inline int dfim_random_index(const int* f) {
  if (f[DF_NREF] != 1 && f[DF_NREF] != 2) return -1;
  return 4 * (f[DF_FINITE] != 0) + 2 * (f[DF_MECH] != 0) + f[DF_NREF] - 1;
}

inline int dfim_buffer_index(const int* f) { return 2 * (f[DF_FINITE] != 0) + (f[DF_MECH] != 0); }
