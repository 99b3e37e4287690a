// One env-step of the universal synchronous-family (PMSM / SynRM) fused
// rollouts, shared by the four kernels of fused_sync.cu so that the
// reducing rollout and the recorder cannot diverge.
//
// Replaces the step closures of _sync_family in
// gym_electric_motor_tpu/ops/pallas_sync.py (:521-918: the mech/electrical
// RK4 :619-689, the B6 fractions, Clarke and Park at the cycle-start angle
// :661-671 and :765-768, the constraint :870-876, the reference quantities
// :787-796) with the machinery of ops/pallas_common.py that it calls:
// _make_fused_mech (:638-746, 'const'), _make_fused_supply (:502, 'ideal')
// and _rotation_protocol (:1476-1494); the reference machinery, the WSE
// reward, the polynomial load and the B6 bridge (_make_b6) are
// common_step.cuh's.  The plain PyTorch version
// of the same arithmetic, in the same order, is
// gym_electric_motor_tpu_torch/ops/fused_sync_family.py.
//
// Every float constant (motor, load, converter, reward and reference
// constants, and the literals 2/3, 1/sqrt(3), 2*pi, ...) arrives from the
// host as float32 in SyncConst, so host and device round them identically.
// The referenced quantity of each reference row is a runtime code, not a
// template parameter.
#pragma once

#include <cstdint>

#include "common_step.cuh"

enum SyncConstIndex {
  S_U_SUP = 0,         // supply voltage
  S_HALF_TAU,          // 0.5 * tau, the RK4 mid-stage step
  S_TAU,
  S_SIXTH,             // tau / 6
  S_TWO_THIRDS,        // Clarke gain
  S_INV_SQRT3,         // Clarke beta gain
  S_TWO_PI,
  S_INV_TWO_PI,
  S_P,                 // pole pairs (dynamic speed: p * omega)
  S_NEG_R_S,           // -r_s
  S_R_S,
  S_L_Q,
  S_L_D,
  S_NEG_PSI_P,         // -psi_p
  S_INV_LD,            // 1 / l_d
  S_INV_LQ,            // 1 / l_q
  S_LQ_PW,             // constant speed: l_q * p * omega_fixed
  S_LD_PW,             //   l_d * p * omega_fixed
  S_NEG_PSI_PW,        //   -psi_p * p * omega_fixed
  S_D_EPS,             //   p * omega_fixed, the angle rate
  S_COS_D,             //   cos / sin of tau * p * omega_fixed (incremental Park)
  S_SIN_D,
  S_TQ_GAIN,           // 1.5 * p
  S_PSI_P,
  S_LD_MINUS_LQ,       // l_d - l_q
  S_LOAD_A,            // polynomial static load: a, b, c
  S_LOAD_B,
  S_LOAD_C,
  S_OMEGA_LIN,         //   a / j_total * tau_decay: below it the a-term is linear
  S_JT_OVER_TD,        //   j_total / tau_decay
  S_INV_JT,            //   1 / j_total
  S_INV_I_LIM,         // 1 / current limit (the squared constraint)
  S_BIAS,              // WSE reward bias
  S_VIOLATION_REWARD,
  S_LN10,
  S_U_MIN,             // guard before the Box-Muller log
  N_SYNC_CONST
};

// What a reference row refers to (the referenced quantity's code).
enum SyncQuantity { Q_I_SD = 0, Q_I_SQ, Q_TORQUE, Q_OMEGA };

enum SyncFlag {
  F_QTY0 = 0,    // SyncQuantity of row 0
  F_QTY1,        // and of row 1
  F_ALL_CONST,   // every reference constant: no reference draws at all
  F_NO_CONS,     // constraints=(): the env never terminates
  F_FINITE,      // the template parameters the host launches
  F_MECH,
  F_NREF,
  N_SYNC_FLAG
};

struct SyncConst {
  float v[N_SYNC_CONST];
  RefConst ref;   // the reference rows; two_pi, ln10 and u_min repeat S_TWO_PI, S_LN10, S_U_MIN
  int flag[N_SYNC_FLAG];
};

// The drive state of one env; w is unused at constant speed.
struct SyncState {
  float w, i_sd, i_sq, eps;
};

// A finite action (3 bits) or a continuous one (3 duty commands).
using SyncAction = B6Action;

__device__ __forceinline__ float sync_torque(const SyncConst& k, float i_sd, float i_sq) {
  return k.v[S_TQ_GAIN] * (k.v[S_PSI_P] + k.v[S_LD_MINUS_LQ] * i_sd) * i_sq;
}

__device__ __forceinline__ float poly_rhs(const SyncConst& k, float w, float t_e) {
  return poly_load_rhs(k.v[S_LOAD_A], k.v[S_LOAD_B], k.v[S_LOAD_C], k.v[S_OMEGA_LIN],
                       k.v[S_JT_OVER_TD], k.v[S_INV_JT], w, t_e);
}

// The dq current ODE; at constant speed the speed products are constants.
template <bool MECH>
__device__ __forceinline__ void sync_el_rhs(const SyncConst& k, float w, float i_sd, float i_sq,
                                            float u_d, float u_q, float& d_sd, float& d_sq) {
  if (MECH) {
    const float pw = k.v[S_P] * w;
    d_sd = (k.v[S_NEG_R_S] * i_sd + k.v[S_L_Q] * pw * i_sq + u_d) * k.v[S_INV_LD];
    d_sq = (k.v[S_NEG_PSI_P] * pw - k.v[S_R_S] * i_sq - k.v[S_L_D] * pw * i_sd + u_q)
           * k.v[S_INV_LQ];
  } else {
    d_sd = (k.v[S_NEG_R_S] * i_sd + k.v[S_LQ_PW] * i_sq + u_d) * k.v[S_INV_LD];
    d_sq = (k.v[S_NEG_PSI_PW] - k.v[S_R_S] * i_sq - k.v[S_LD_PW] * i_sd + u_q) * k.v[S_INV_LQ];
  }
}

// The joint right-hand side at one RK4 stage: (d omega, d i_sd, d i_sq).
template <bool MECH>
__device__ __forceinline__ void sync_rhs(const SyncConst& k, float w, float i_sd, float i_sq,
                                         float u_d, float u_q, float& dw, float& d_sd,
                                         float& d_sq) {
  dw = MECH ? poly_rhs(k, w, sync_torque(k, i_sd, i_sq)) : 0.0f;
  sync_el_rhs<MECH>(k, w, i_sd, i_sq, u_d, u_q, d_sd, d_sq);
}

// B6 bridge -> Clarke -> Park at the cycle-start angle (c, s) -> RK4 over
// (omega?, i_sd, i_sq, eps) -> wrap of eps to [0, 2 pi).  At constant speed
// eps integrates the constant rate p * omega_fixed through the RK4 sum.
template <bool FINITE, bool MECH>
__device__ __forceinline__ void sync_physics(const SyncConst& k, const SyncAction& act, float c,
                                             float s, SyncState& x) {
  float fa, fb, fc;
  b6_fractions<FINITE>(act, fa, fb, fc);
  const float ua = fa * k.v[S_U_SUP], ub = fb * k.v[S_U_SUP], uc = fc * k.v[S_U_SUP];
  const float u_alpha = k.v[S_TWO_THIRDS] * (ua - 0.5f * (ub + uc));
  const float u_beta = k.v[S_INV_SQRT3] * (ub - uc);
  const float u_d = c * u_alpha + s * u_beta;
  const float u_q = -s * u_alpha + c * u_beta;

  const float h = k.v[S_HALF_TAU], dt = k.v[S_TAU], sixth = k.v[S_SIXTH];
  float k1w, k1d, k1q, k2w, k2d, k2q, k3w, k3d, k3q, k4w, k4d, k4q;
  sync_rhs<MECH>(k, x.w, x.i_sd, x.i_sq, u_d, u_q, k1w, k1d, k1q);
  const float w2 = x.w + h * k1w;
  sync_rhs<MECH>(k, w2, x.i_sd + h * k1d, x.i_sq + h * k1q, u_d, u_q, k2w, k2d, k2q);
  const float w3 = x.w + h * k2w;
  sync_rhs<MECH>(k, w3, x.i_sd + h * k2d, x.i_sq + h * k2q, u_d, u_q, k3w, k3d, k3q);
  const float w4 = x.w + dt * k3w;
  sync_rhs<MECH>(k, w4, x.i_sd + dt * k3d, x.i_sq + dt * k3q, u_d, u_q, k4w, k4d, k4q);
  if (MECH) {
    const float p = k.v[S_P];
    x.eps = x.eps + sixth * (p * x.w + 2.0f * (p * w2 + p * w3) + p * w4);
    x.w = x.w + sixth * (k1w + 2.0f * (k2w + k3w) + k4w);
  } else {
    const float de = k.v[S_D_EPS];
    x.eps = x.eps + sixth * (de + 2.0f * (de + de) + de);
  }
  x.i_sd = x.i_sd + sixth * (k1d + 2.0f * (k2d + k3d) + k4d);
  x.i_sq = x.i_sq + sixth * (k1q + 2.0f * (k2q + k3q) + k4q);
  x.eps = x.eps - k.v[S_TWO_PI] * floorf(x.eps * k.v[S_INV_TWO_PI]);
}

// The normalised referenced quantity of a row, chosen by selects.
__device__ __forceinline__ float sync_quantity(const SyncConst& k, int row, const SyncState& x) {
  const int code = k.flag[F_QTY0 + row];
  const float tq = sync_torque(k, x.i_sd, x.i_sq);
  float q = x.i_sd;
  q = code == Q_I_SQ ? x.i_sq : q;
  q = code == Q_TORQUE ? tq : q;
  q = code == Q_OMEGA ? x.w : q;
  return q * k.ref.row[row][R_INV_LIM];
}

struct SyncStepOut {
  SyncAction act;
  float reward, done;
  float ref[2];   // the references the reward was taken against
};

// One step under an action: physics, constraint, WSE reward against the
// pre-advance references, reset of a violating env and, at constant speed,
// the incremental Park rotation with rsqrt renormalisation.  With MECH the
// caller passes (c, s) = (cos, sin)(eps); at constant speed the carried
// rotation.  The references are left to the caller.
template <bool FINITE, bool MECH, int NREF>
__device__ __forceinline__ SyncStepOut sync_action_step(const SyncConst& k, const SyncAction& act,
                                                        SyncState& x, float& c, float& s,
                                                        const RefRows<NREF>& refs) {
  SyncStepOut out;
  out.act = act;
  SyncState y = x;
  sync_physics<FINITE, MECH>(k, act, c, s, y);
  const float i_sd_n = y.i_sd * k.v[S_INV_I_LIM];
  const float i_sq_n = y.i_sq * k.v[S_INV_I_LIM];
  const bool violated = !k.flag[F_NO_CONS] && (i_sd_n * i_sd_n + i_sq_n * i_sq_n) > 1.0f;
  const float wse = ref_wse<NREF>(k.ref, k.v[S_BIAS], sync_quantity(k, 0, y),
                                  NREF == 2 ? sync_quantity(k, 1, y) : 0.0f, refs);
  out.reward = violated ? k.v[S_VIOLATION_REWARD] : wse;
  out.done = violated ? 1.0f : 0.0f;
  out.ref[0] = refs.rv[0];
  out.ref[1] = refs.rv[NREF - 1];
  x.w = violated ? 0.0f : y.w;
  x.i_sd = violated ? 0.0f : y.i_sd;
  x.i_sq = violated ? 0.0f : y.i_sq;
  x.eps = violated ? 0.0f : y.eps;
  if (!MECH) {
    const float c_new = c * k.v[S_COS_D] - s * k.v[S_SIN_D];
    const float s_new = s * k.v[S_COS_D] + c * k.v[S_SIN_D];
    const float inv = rsqrtf(c_new * c_new + s_new * s_new);
    c = violated ? 1.0f : c_new * inv;
    s = violated ? 0.0f : s_new * inv;
  }
  return out;
}

// One random-mode step: the action from the step's words (finite: the low
// 3 bits of word 0; cont: 2 u - 1 from words 0 and 3 and the ACTION_C
// slot), sync_action_step, then (WIENER) the reference advance.
template <bool FINITE, bool MECH, int NREF, bool WIENER>
__device__ __forceinline__ SyncStepOut sync_random_step(const SyncConst& k, uint2 key, uint32_t env,
                                                        uint32_t t, SyncState& x, float& c,
                                                        float& s, RefRows<NREF>& refs) {
  const uint4 w = drive_draw(key, env, t, DRIVE_SLOT_STEP);
  const SyncAction act = b6_random_action<FINITE>(key, env, t, w);
  if (MECH) {
    c = cosf(x.eps);
    s = sinf(x.eps);
  }
  const SyncStepOut out = sync_action_step<FINITE, MECH, NREF>(k, act, x, c, s, refs);
  if (WIENER) ref_wiener_advance<NREF>(k.ref, key, env, t, w, out.done != 0.0f, refs);
  return out;
}

// The constants of one env from the host's float32 and int32 arrays.
inline SyncConst sync_load_const(const float* host, const int* flags) {
  SyncConst k;
  for (int i = 0; i < N_SYNC_CONST; ++i) k.v[i] = host[i];
  for (int r = 0; r < 2; ++r) {
    for (int j = 0; j < N_ROW_CONST; ++j) k.ref.row[r][j] = host[N_SYNC_CONST + r * N_ROW_CONST + j];
  }
  k.ref.two_pi = host[S_TWO_PI];
  k.ref.ln10 = host[S_LN10];
  k.ref.u_min = host[S_U_MIN];
  for (int i = 0; i < N_SYNC_FLAG; ++i) k.flag[i] = flags[i];
  k.ref.all_const = flags[F_ALL_CONST];
  return k;
}
