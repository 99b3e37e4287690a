// One env-step of the universal squirrel-cage induction (SCIM) fused
// rollouts, shared by the kernels of fused_induction.cu and
// fused_induction_record.cu so that the reducing rollout and the recorder
// cannot diverge.
//
// Replaces the step closures of _induction_family in
// gym_electric_motor_tpu/ops/pallas_induction.py (:251-695): el_rhs and
// torque (:364-375), rk4 (:421-435), step_physics on its no-interlock
// branch (:534-538, Clarke only: the ODE lives in the stator frame),
// flux_dir (:437-446), reset_state (:540-545, the polynomial load's reset
// draws nothing), ref_quantities (:557-583), violated (:656-661) and
// _sample_actions (:585-589); the reference machinery, the WSE reward, the
// polynomial load and the B6 bridge are common_step.cuh's.  The plain
// PyTorch version of the same arithmetic, in the same order, is
// gym_electric_motor_tpu_torch/ops/fused_induction_family.py.
//
// Every float constant (motor, load, converter, reward and reference
// constants, the Clarke gains 2/3 and 1/sqrt(3), the flux-direction guard
// 1e-24, ...) arrives from the host as float32 in InductionConst, so host
// and device round them identically.  The divisions by tau_sig and tau_r
// are products with their float32 reciprocals, as XLA compiles the JAX
// kernel's divisions by constants.  The referenced quantity of a row is a
// runtime code; the dq currents rotate the post-step stator current by the
// rotor-flux direction from before the step (the reference's stale field
// angle).
#pragma once

#include <cstdint>

#include "common_step.cuh"

enum InductionConstIndex {
  I_U_SUP = 0,         // supply voltage
  I_HALF_TAU,          // 0.5 * tau, the RK4 mid-stage step
  I_TAU,
  I_SIXTH,             // tau / 6
  I_TWO_THIRDS,        // Clarke gain
  I_INV_SQRT3,         // Clarke beta gain
  I_INV_TAU_SIG,       // 1 / tau_sig, tau_sig = sigma l_s / (r_s + r_r l_m^2 / l_r^2)
  I_C_PSI,             // l_m r_r / (sigma l_s l_r^2)
  I_C_W,               // dynamic speed: l_m p / (sigma l_r l_s), times omega
  I_CW_W,              // constant speed: c_w * omega_fixed
  I_C_U,               // 1 / (sigma l_s)
  I_L_M,
  I_INV_TAU_R,         // 1 / tau_r = r_r / l_r
  I_P,                 // dynamic speed: pole pairs, times omega
  I_PW,                // constant speed: p * omega_fixed
  I_K_T,               // torque gain 1.5 p l_m / l_r
  I_LOAD_A,            // polynomial static load: a, b, c
  I_LOAD_B,
  I_LOAD_C,
  I_OMEGA_LIN,         //   a / j_total * tau_decay: below it the a-term is linear
  I_JT_OVER_TD,        //   j_total / tau_decay
  I_INV_JT,            //   1 / j_total
  I_INV_ILIM2,         // 1 / i_lim^2 (the squared constraint on |i_alphabeta|)
  I_TINY,              // |psi|^2 below it: the flux direction is (1, 0)
  I_BIAS,              // WSE reward bias
  I_VIOLATION_REWARD,
  I_TWO_PI,
  I_LN10,
  I_U_MIN,             // guard before the Box-Muller log
  N_INDUCTION_CONST
};

// What a reference row refers to (the referenced quantity's code).
enum InductionQuantity { IQ_I_SD = 0, IQ_I_SQ, IQ_TORQUE, IQ_OMEGA };

enum InductionFlag {
  IF_QTY0 = 0,   // InductionQuantity of row 0
  IF_QTY1,       // and of row 1
  IF_ALL_CONST,  // every reference constant: no reference draws at all
  IF_NO_CONS,    // constraints=(): the env never terminates
  IF_FINITE,     // the template parameters the host launches
  IF_MECH,
  IF_NREF,
  IF_NEEDS_DQ,   // a row refers to i_sd or i_sq: the step takes the flux direction
  N_INDUCTION_FLAG
};

struct InductionConst {
  float v[N_INDUCTION_CONST];
  RefConst ref;   // the reference rows; two_pi, ln10 and u_min repeat I_TWO_PI, I_LN10, I_U_MIN
  int flag[N_INDUCTION_FLAG];
};

// The drive state of one env; w is unused at constant speed.
struct InductionState {
  float w, isa, isb, psa, psb;
};

struct InductionStepOut {
  B6Action act;
  float reward, done;
  float ref[2];   // the references the reward was taken against
};

__device__ __forceinline__ float ind_torque(const InductionConst& k, float isa, float isb,
                                            float psa, float psb) {
  return k.v[I_K_T] * (psa * isb - psb * isa);
}

// The joint right-hand side at one RK4 stage: (d omega, d i_salpha,
// d i_sbeta, d psi_ralpha, d psi_rbeta).  c_w multiplies the mechanical
// omega, p omega turns the flux; at constant speed both are constants.
template <bool MECH>
__device__ __forceinline__ void ind_rhs(const InductionConst& k, float w, float isa, float isb,
                                        float psa, float psb, float u_al, float u_be, float& dw,
                                        float& d_isa, float& d_isb, float& d_psa, float& d_psb) {
  const float cww = MECH ? k.v[I_C_W] * w : k.v[I_CW_W];
  const float pw = MECH ? k.v[I_P] * w : k.v[I_PW];
  d_isa = -isa * k.v[I_INV_TAU_SIG] + k.v[I_C_PSI] * psa + cww * psb + k.v[I_C_U] * u_al;
  d_isb = -isb * k.v[I_INV_TAU_SIG] + k.v[I_C_PSI] * psb - cww * psa + k.v[I_C_U] * u_be;
  d_psa = (k.v[I_L_M] * isa - psa) * k.v[I_INV_TAU_R] - pw * psb;
  d_psb = (k.v[I_L_M] * isb - psb) * k.v[I_INV_TAU_R] + pw * psa;
  dw = MECH ? poly_load_rhs(k.v[I_LOAD_A], k.v[I_LOAD_B], k.v[I_LOAD_C], k.v[I_OMEGA_LIN],
                            k.v[I_JT_OVER_TD], k.v[I_INV_JT], w, ind_torque(k, isa, isb, psa, psb))
            : 0.0f;
}

// B6 bridge -> Clarke (no Park) -> RK4 over (omega?, i_salpha, i_sbeta,
// psi_ralpha, psi_rbeta).
template <bool FINITE, bool MECH>
__device__ __forceinline__ void ind_physics(const InductionConst& k, const B6Action& act,
                                            InductionState& x) {
  float fa, fb, fc;
  b6_fractions<FINITE>(act, fa, fb, fc);
  const float ua = fa * k.v[I_U_SUP], ub = fb * k.v[I_U_SUP], uc = fc * k.v[I_U_SUP];
  const float u_al = k.v[I_TWO_THIRDS] * (ua - 0.5f * (ub + uc));
  const float u_be = k.v[I_INV_SQRT3] * (ub - uc);

  const float h = k.v[I_HALF_TAU], dt = k.v[I_TAU], sixth = k.v[I_SIXTH];
  float k1w, k1a, k1b, k1p, k1q, k2w, k2a, k2b, k2p, k2q;
  float k3w, k3a, k3b, k3p, k3q, k4w, k4a, k4b, k4p, k4q;
  ind_rhs<MECH>(k, x.w, x.isa, x.isb, x.psa, x.psb, u_al, u_be, k1w, k1a, k1b, k1p, k1q);
  ind_rhs<MECH>(k, x.w + h * k1w, x.isa + h * k1a, x.isb + h * k1b, x.psa + h * k1p,
                x.psb + h * k1q, u_al, u_be, k2w, k2a, k2b, k2p, k2q);
  ind_rhs<MECH>(k, x.w + h * k2w, x.isa + h * k2a, x.isb + h * k2b, x.psa + h * k2p,
                x.psb + h * k2q, u_al, u_be, k3w, k3a, k3b, k3p, k3q);
  ind_rhs<MECH>(k, x.w + dt * k3w, x.isa + dt * k3a, x.isb + dt * k3b, x.psa + dt * k3p,
                x.psb + dt * k3q, u_al, u_be, k4w, k4a, k4b, k4p, k4q);
  if (MECH) x.w = x.w + sixth * (k1w + 2.0f * (k2w + k3w) + k4w);
  x.isa = x.isa + sixth * (k1a + 2.0f * (k2a + k3a) + k4a);
  x.isb = x.isb + sixth * (k1b + 2.0f * (k2b + k3b) + k4b);
  x.psa = x.psa + sixth * (k1p + 2.0f * (k2p + k3p) + k4p);
  x.psb = x.psb + sixth * (k1q + 2.0f * (k2q + k3q) + k4q);
}

// cos/sin of the rotor-flux field angle as psi / |psi|, (1, 0) at zero
// flux, where the env's atan2(0, 0) is 0.  rsqrtf is the instruction
// PyTorch's CUDA rsqrt issues, so kernel and plain version agree.
__device__ __forceinline__ void ind_flux_dir(const InductionConst& k, const InductionState& x,
                                             float& c, float& s) {
  const float mag2 = x.psa * x.psa + x.psb * x.psb;
  const bool tiny = mag2 < k.v[I_TINY];
  const float inv = rsqrtf(tiny ? 1.0f : mag2);
  c = tiny ? 1.0f : x.psa * inv;
  s = tiny ? 0.0f : x.psb * inv;
}

// The normalised referenced quantity of a row, chosen by selects; (c, s)
// is the flux direction from before the step.
__device__ __forceinline__ float ind_quantity(const InductionConst& k, int row,
                                              const InductionState& x, float c, float s) {
  const int code = k.flag[IF_QTY0 + row];
  const float tq = ind_torque(k, x.isa, x.isb, x.psa, x.psb);
  float q = c * x.isa + s * x.isb;
  q = code == IQ_I_SQ ? c * x.isb - s * x.isa : q;
  q = code == IQ_TORQUE ? tq : q;
  q = code == IQ_OMEGA ? x.w : q;
  return q * k.ref.row[row][R_INV_LIM];
}

// One step under an action: physics, the squared-current constraint on
// |i_alphabeta|^2 (rotation-invariant), the WSE reward against the
// pre-advance references and the reset of a violating env to zeros.  The
// references are left to the caller.
template <bool FINITE, bool MECH, int NREF>
__device__ __forceinline__ InductionStepOut ind_action_step(const InductionConst& k,
                                                            const B6Action& act, InductionState& x,
                                                            float c, float s,
                                                            const RefRows<NREF>& refs) {
  InductionStepOut out;
  out.act = act;
  InductionState y = x;
  ind_physics<FINITE, MECH>(k, act, y);
  const bool violated =
      !k.flag[IF_NO_CONS] && (y.isa * y.isa + y.isb * y.isb) * k.v[I_INV_ILIM2] > 1.0f;
  const float wse = ref_wse<NREF>(k.ref, k.v[I_BIAS], ind_quantity(k, 0, y, c, s),
                                  NREF == 2 ? ind_quantity(k, 1, y, c, s) : 0.0f, refs);
  out.reward = violated ? k.v[I_VIOLATION_REWARD] : wse;
  out.done = violated ? 1.0f : 0.0f;
  out.ref[0] = refs.rv[0];
  out.ref[1] = refs.rv[NREF - 1];
  x.w = violated ? 0.0f : y.w;
  x.isa = violated ? 0.0f : y.isa;
  x.isb = violated ? 0.0f : y.isb;
  x.psa = violated ? 0.0f : y.psa;
  x.psb = violated ? 0.0f : y.psb;
  return out;
}

// One random-mode step: the B6 action from the step's words, the flux
// direction (where a row refers to the dq currents), ind_action_step, then
// (WIENER) the reference advance.
template <bool FINITE, bool MECH, int NREF, bool WIENER>
__device__ __forceinline__ InductionStepOut ind_random_step(const InductionConst& k, uint2 key,
                                                            uint32_t env, uint32_t t,
                                                            InductionState& x,
                                                            RefRows<NREF>& refs) {
  const uint4 w = drive_draw(key, env, t, DRIVE_SLOT_STEP);
  const B6Action act = b6_random_action<FINITE>(key, env, t, w);
  float c = 1.0f, s = 0.0f;
  if (k.flag[IF_NEEDS_DQ]) ind_flux_dir(k, x, c, s);
  const InductionStepOut out = ind_action_step<FINITE, MECH, NREF>(k, act, x, c, s, refs);
  if (WIENER) ref_wiener_advance<NREF>(k.ref, key, env, t, w, out.done != 0.0f, refs);
  return out;
}

// ---- what the kernels of both sources share ------------------------------

// The planes of one state, (omega or NULL, i_salpha, i_sbeta, psi_ralpha,
// psi_rbeta), by value so that a kernel takes them as parameters.
struct InductionInPlanes {
  const float* p[5];
};

struct InductionPlanes {
  float* p[5];
};

template <bool MECH>
__device__ __forceinline__ InductionState ind_load_state(const InductionInPlanes& in, int e) {
  InductionState x;
  x.w = MECH ? in.p[0][e] : 0.0f;
  x.isa = in.p[1][e];
  x.isb = in.p[2][e];
  x.psa = in.p[3][e];
  x.psb = in.p[4][e];
  return x;
}

template <bool MECH>
__device__ __forceinline__ void ind_store_state(const InductionState& x, const InductionPlanes& o,
                                                size_t i) {
  if (MECH) o.p[0][i] = x.w;
  o.p[1][i] = x.isa;
  o.p[2][i] = x.isb;
  o.p[3][i] = x.psa;
  o.p[4][i] = x.psb;
}

inline InductionInPlanes ind_in_planes(const float* const* in) {
  InductionInPlanes planes;
  for (int j = 0; j < 5; ++j) planes.p[j] = in[j];
  return planes;
}

inline InductionPlanes ind_out_planes(float* const* out) {
  InductionPlanes planes;
  for (int j = 0; j < 5; ++j) planes.p[j] = out[j];
  return planes;
}

inline InductionConst ind_load_const(const float* host, const int* flags) {
  InductionConst k;
  for (int i = 0; i < N_INDUCTION_CONST; ++i) k.v[i] = host[i];
  for (int r = 0; r < 2; ++r) {
    for (int j = 0; j < N_ROW_CONST; ++j) {
      k.ref.row[r][j] = host[N_INDUCTION_CONST + r * N_ROW_CONST + j];
    }
  }
  k.ref.two_pi = host[I_TWO_PI];
  k.ref.ln10 = host[I_LN10];
  k.ref.u_min = host[I_U_MIN];
  for (int i = 0; i < N_INDUCTION_FLAG; ++i) k.flag[i] = flags[i];
  k.ref.all_const = flags[IF_ALL_CONST];
  return k;
}

inline uint2 ind_seed_key(unsigned long long seed) {
  return make_uint2((uint32_t)(seed & 0xFFFFFFFFull), (uint32_t)(seed >> 32));
}

// Instance index of (FINITE, MECH, NREF): 4 * finite + 2 * mech + nref - 1
// for the random kernels, 2 * finite + mech for the buffer kernels; -1 for
// flags no instance serves.
inline int ind_random_index(const int* f) {
  if (f[IF_NREF] != 1 && f[IF_NREF] != 2) return -1;
  return 4 * (f[IF_FINITE] != 0) + 2 * (f[IF_MECH] != 0) + f[IF_NREF] - 1;
}

inline int ind_buffer_index(const int* f) { return 2 * (f[IF_FINITE] != 0) + (f[IF_MECH] != 0); }
