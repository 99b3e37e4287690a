// One env-step of the universal externally excited synchronous (EESM)
// fused rollouts, shared by the kernels of fused_eesm.cu and
// fused_eesm_record.cu so that the reducing rollout and the recorder cannot
// diverge.
//
// Replaces the step closures of _eesm_family in
// gym_electric_motor_tpu/ops/pallas_eesm.py (:296-708): torque3 and el_rhs
// (:375-389), rhs and rk4 (:391-407, :488-502), the B6 + 4QC voltage
// fractions and _udqe on the no-interlock branch (:431-451, :481-486,
// :567-568), the angle wrap (:657-663), violated (:668-675), ref_quantity
// (:585-593) and _sample_actions (:595-601), with _rotation_protocol of
// ops/pallas_common.py (:1476-1494) for the constant-speed Park rotation;
// the reference machinery (three rows for the CC ids), the WSE reward, the
// polynomial load and the B6 bridge are common_step.cuh's.  The plain
// PyTorch version of the same arithmetic, in the same order, is
// gym_electric_motor_tpu_torch/ops/fused_eesm_family.py.
//
// Every float constant arrives from the host as float32 in EesmConst, so
// host and device round them identically.  The JAX kernel forms its
// constants from Python floats: prefixes such as l_M r_E / (sigma l_E)
// i_k_rs fold in double and round once, a division of a plane by a
// constant is a product with the float32 reciprocal, and under the speed
// ODE a chain such as (p omega) l_M i_k_rs folds its constants in float32
// (XLA's reassociation of constant products), so the host hands each of
// those products over as one constant that multiplies omega.
#pragma once

#include <cstdint>

#include "common_step.cuh"

enum EesmConstIndex {
  E_U_SUP = 0,         // supply voltage
  E_HALF_TAU,          // 0.5 * tau, the RK4 mid-stage step
  E_TAU,
  E_SIXTH,             // tau / 6
  E_TWO_THIRDS,        // Clarke gain
  E_INV_SQRT3,         // Clarke beta gain
  E_TWO_PI,
  E_INV_TWO_PI,
  E_P,                 // pole pairs (dynamic speed: the angle rate p * omega)
  // d i_sd: (A i_sd + B i_e + u_d / sigma - C u_e + W i_sq) / l_d
  E_A_SD,              // -r_s / sigma
  E_B_SD,              // l_M r_E / (sigma l_E) i_k_rs
  E_INV_SIG,           // 1 / sigma
  E_C_SD,              // l_M k / (sigma l_E)
  E_W_SD,              // l_q p omega / sigma: constant speed its value, else times omega
  E_INV_LD,            // 1 / l_d
  // d i_sq: (-r_s i_sq + u_q - W_d i_sd - W_e i_e) / l_q
  E_NEG_R_S,
  E_W_SQ_D,            // l_d p omega
  E_W_SQ_E,            // p omega l_M i_k_rs
  E_INV_LQ,            // 1 / l_q
  // d i_e: (D i_sd - E i_e - F u_d + G u_e - W i_sq) / (l_E i_k_rs)
  E_D_E,               // l_M r_s / (sigma l_d)
  E_E_E,               // r_E / sigma i_k_rs
  E_F_E,               // l_M / (sigma l_d)
  E_G_E,               // k / sigma
  E_W_E,               // p omega l_M l_q / (sigma l_d)
  E_INV_LE,            // 1 / (l_E i_k_rs)
  E_D_EPS,             // constant speed: p * omega_fixed, the angle rate
  E_COS_D,             //   cos / sin of tau * p * omega_fixed (incremental Park)
  E_SIN_D,
  E_TQ_GAIN,           // 1.5 * p
  E_LM_IKRS,           // l_M i_k_rs
  E_LD_MINUS_LQ,       // l_d - l_q
  E_LOAD_A,            // polynomial static load: a, b, c
  E_LOAD_B,
  E_LOAD_C,
  E_OMEGA_LIN,         //   a / j_total * tau_decay: below it the a-term is linear
  E_JT_OVER_TD,        //   j_total / tau_decay
  E_INV_JT,            //   1 / j_total
  E_INV_I_LIM,         // 1 / stator current limit (the squared constraint)
  E_INV_IE_LIM,        // 1 / excitation current limit
  E_BIAS,              // WSE reward bias
  E_VIOLATION_REWARD,
  E_LN10,
  E_U_MIN,             // guard before the Box-Muller log
  N_EESM_CONST
};

// What a reference row refers to (the referenced quantity's code).
enum EesmQuantity { EQ_I_SD = 0, EQ_I_SQ, EQ_I_E, EQ_TORQUE, EQ_OMEGA };

enum EesmFlag {
  EF_QTY0 = 0,   // EesmQuantity of rows 0, 1 and 2
  EF_QTY1,
  EF_QTY2,
  EF_ALL_CONST,  // every reference constant: no reference draws at all
  EF_NO_CONS,    // constraints=(): the env never terminates
  EF_FINITE,     // the template parameters the host launches
  EF_MECH,
  EF_NREF,
  N_EESM_FLAG
};

constexpr int kEesmRows = 3;

struct EesmConst {
  float v[N_EESM_CONST];
  RefConstN<kEesmRows> ref;   // two_pi, ln10 and u_min repeat E_TWO_PI, E_LN10, E_U_MIN
  int flag[N_EESM_FLAG];
};

// The drive state of one env; w is unused at constant speed.
struct EesmState {
  float w, i_sd, i_sq, i_e, eps;
};

// A finite action (B6 bits and the 4QC's 0..3) or a continuous one (three
// B6 duties and the excitation duty).
struct EesmAction {
  B6Action b6;
  int e_bits;
  float e;
};

struct EesmStepOut {
  EesmAction act;
  float reward, done;
  float ref[kEesmRows];   // the references the reward was taken against
};

__device__ __forceinline__ float eesm_torque(const EesmConst& k, float i_sd, float i_sq,
                                             float i_e) {
  return k.v[E_TQ_GAIN] * (i_e * k.v[E_LM_IKRS] + k.v[E_LD_MINUS_LQ] * i_sd) * i_sq;
}

// The three-current ODE; under the speed ODE the omega products are the
// host constant times the stage's omega.
template <bool MECH>
__device__ __forceinline__ void eesm_el_rhs(const EesmConst& k, float w, float i_sd, float i_sq,
                                            float i_e, float u_d, float u_q, float u_e,
                                            float& d_sd, float& d_sq, float& d_e) {
  const float w_sd = MECH ? w * k.v[E_W_SD] : k.v[E_W_SD];
  const float w_sq_d = MECH ? w * k.v[E_W_SQ_D] : k.v[E_W_SQ_D];
  const float w_sq_e = MECH ? w * k.v[E_W_SQ_E] : k.v[E_W_SQ_E];
  const float w_e = MECH ? w * k.v[E_W_E] : k.v[E_W_E];
  d_sd = ((((k.v[E_A_SD] * i_sd + k.v[E_B_SD] * i_e) + u_d * k.v[E_INV_SIG]) - k.v[E_C_SD] * u_e)
          + w_sd * i_sq) * k.v[E_INV_LD];
  d_sq = (((k.v[E_NEG_R_S] * i_sq + u_q) - w_sq_d * i_sd) - w_sq_e * i_e) * k.v[E_INV_LQ];
  d_e = ((((k.v[E_D_E] * i_sd - k.v[E_E_E] * i_e) - k.v[E_F_E] * u_d) + k.v[E_G_E] * u_e)
         - w_e * i_sq) * k.v[E_INV_LE];
}

// The joint right-hand side at one RK4 stage: (d omega, d i_sd, d i_sq,
// d i_e).
template <bool MECH>
__device__ __forceinline__ void eesm_rhs(const EesmConst& k, float w, float i_sd, float i_sq,
                                         float i_e, float u_d, float u_q, float u_e, float& dw,
                                         float& d_sd, float& d_sq, float& d_e) {
  dw = MECH ? poly_load_rhs(k.v[E_LOAD_A], k.v[E_LOAD_B], k.v[E_LOAD_C], k.v[E_OMEGA_LIN],
                            k.v[E_JT_OVER_TD], k.v[E_INV_JT], w, eesm_torque(k, i_sd, i_sq, i_e))
            : 0.0f;
  eesm_el_rhs<MECH>(k, w, i_sd, i_sq, i_e, u_d, u_q, u_e, d_sd, d_sq, d_e);
}

// B6 + 4QC fractions -> Clarke -> Park at the cycle-start angle (c, s) for
// the stator, the excitation voltage straight through -> RK4 over (omega?,
// i_sd, i_sq, i_e, eps) -> wrap of eps to [0, 2 pi).  At constant speed eps
// integrates the constant rate p * omega_fixed through the RK4 sum.
template <bool FINITE, bool MECH>
__device__ __forceinline__ void eesm_physics(const EesmConst& k, const EesmAction& act, float c,
                                             float s, EesmState& x) {
  float fa, fb, fc;
  b6_fractions<FINITE>(act.b6, fa, fb, fc);
  const float fe = FINITE ? (float)(act.e_bits == 1) - (float)(act.e_bits == 2) : act.e;
  const float ua = fa * k.v[E_U_SUP], ub = fb * k.v[E_U_SUP], uc = fc * k.v[E_U_SUP];
  const float u_alpha = k.v[E_TWO_THIRDS] * (ua - 0.5f * (ub + uc));
  const float u_beta = k.v[E_INV_SQRT3] * (ub - uc);
  const float u_d = c * u_alpha + s * u_beta;
  const float u_q = -s * u_alpha + c * u_beta;
  const float u_e = fe * k.v[E_U_SUP];

  const float h = k.v[E_HALF_TAU], dt = k.v[E_TAU], sixth = k.v[E_SIXTH];
  float k1w, k1d, k1q, k1e, k2w, k2d, k2q, k2e, k3w, k3d, k3q, k3e, k4w, k4d, k4q, k4e;
  eesm_rhs<MECH>(k, x.w, x.i_sd, x.i_sq, x.i_e, u_d, u_q, u_e, k1w, k1d, k1q, k1e);
  const float w2 = x.w + h * k1w;
  eesm_rhs<MECH>(k, w2, x.i_sd + h * k1d, x.i_sq + h * k1q, x.i_e + h * k1e, u_d, u_q, u_e, k2w,
                 k2d, k2q, k2e);
  const float w3 = x.w + h * k2w;
  eesm_rhs<MECH>(k, w3, x.i_sd + h * k2d, x.i_sq + h * k2q, x.i_e + h * k2e, u_d, u_q, u_e, k3w,
                 k3d, k3q, k3e);
  const float w4 = x.w + dt * k3w;
  eesm_rhs<MECH>(k, w4, x.i_sd + dt * k3d, x.i_sq + dt * k3q, x.i_e + dt * k3e, u_d, u_q, u_e,
                 k4w, k4d, k4q, k4e);
  if (MECH) {
    const float p = k.v[E_P];
    x.eps = x.eps + sixth * (p * x.w + 2.0f * (p * w2 + p * w3) + p * w4);
    x.w = x.w + sixth * (k1w + 2.0f * (k2w + k3w) + k4w);
  } else {
    const float de = k.v[E_D_EPS];
    x.eps = x.eps + sixth * (de + 2.0f * (de + de) + de);
  }
  x.i_sd = x.i_sd + sixth * (k1d + 2.0f * (k2d + k3d) + k4d);
  x.i_sq = x.i_sq + sixth * (k1q + 2.0f * (k2q + k3q) + k4q);
  x.i_e = x.i_e + sixth * (k1e + 2.0f * (k2e + k3e) + k4e);
  x.eps = x.eps - k.v[E_TWO_PI] * floorf(x.eps * k.v[E_INV_TWO_PI]);
}

// The normalised referenced quantity of a row, chosen by selects.
__device__ __forceinline__ float eesm_quantity(const EesmConst& k, int row, const EesmState& x) {
  const int code = k.flag[EF_QTY0 + row];
  const float tq = eesm_torque(k, x.i_sd, x.i_sq, x.i_e);
  float q = x.i_sd;
  q = code == EQ_I_SQ ? x.i_sq : q;
  q = code == EQ_I_E ? x.i_e : q;
  q = code == EQ_TORQUE ? tq : q;
  q = code == EQ_OMEGA ? x.w : q;
  return q * k.ref.row[row][R_INV_LIM];
}

// One step under an action: physics, the squared stator-current and the
// excitation-current constraints, the WSE reward against the pre-advance
// references, the reset of a violating env to zeros and, at constant speed,
// the incremental Park rotation with rsqrt renormalisation.  With MECH the
// caller passes (c, s) = (cos, sin)(eps); at constant speed the carried
// rotation.  The references are left to the caller.
template <bool FINITE, bool MECH, int NREF>
__device__ __forceinline__ EesmStepOut eesm_action_step(const EesmConst& k, const EesmAction& act,
                                                        EesmState& x, float& c, float& s,
                                                        const RefRows<NREF>& refs) {
  EesmStepOut out;
  out.act = act;
  EesmState y = x;
  eesm_physics<FINITE, MECH>(k, act, c, s, y);
  const float i_sd_n = y.i_sd * k.v[E_INV_I_LIM];
  const float i_sq_n = y.i_sq * k.v[E_INV_I_LIM];
  const bool violated = !k.flag[EF_NO_CONS]
      && ((i_sd_n * i_sd_n + i_sq_n * i_sq_n) > 1.0f || fabsf(y.i_e * k.v[E_INV_IE_LIM]) > 1.0f);
  const float wse = ref_wse<NREF>(k.ref, k.v[E_BIAS], eesm_quantity(k, 0, y),
                                  NREF >= 2 ? eesm_quantity(k, 1, y) : 0.0f, refs,
                                  NREF == 3 ? eesm_quantity(k, 2, y) : 0.0f);
  out.reward = violated ? k.v[E_VIOLATION_REWARD] : wse;
  out.done = violated ? 1.0f : 0.0f;
#pragma unroll
  for (int r = 0; r < kEesmRows; ++r) out.ref[r] = refs.rv[r < NREF ? r : NREF - 1];
  x.w = violated ? 0.0f : y.w;
  x.i_sd = violated ? 0.0f : y.i_sd;
  x.i_sq = violated ? 0.0f : y.i_sq;
  x.i_e = violated ? 0.0f : y.i_e;
  x.eps = violated ? 0.0f : y.eps;
  if (!MECH) {
    const float c_new = c * k.v[E_COS_D] - s * k.v[E_SIN_D];
    const float s_new = s * k.v[E_COS_D] + c * k.v[E_SIN_D];
    const float inv = rsqrtf(c_new * c_new + s_new * s_new);
    c = violated ? 1.0f : c_new * inv;
    s = violated ? 0.0f : s_new * inv;
  }
  return out;
}

// The random action of a step: finite, one word carries both parts, the B6
// bits (b & 7) and the 4QC's (b >> 3) & 3; continuous, the three B6 duties
// (SLOT_STEP words x and w, ACTION_C's x) and the excitation duty
// (ACTION_C's y), each 2 u - 1.
template <bool FINITE>
__device__ __forceinline__ EesmAction eesm_random_action(uint2 key, uint32_t env, uint32_t t,
                                                         uint4 w) {
  const uint4 cw = FINITE ? make_uint4(0u, 0u, 0u, 0u)
                          : drive_draw(key, env, t, DRIVE_SLOT_ACTION_C);
  EesmAction act;
  act.b6 = b6_action_of_words<FINITE>(w, cw.x);
  act.e_bits = FINITE ? (int)((w.x >> 3) & 3u) : 0;
  act.e = FINITE ? 0.0f : 2.0f * uniform24(cw.y) - 1.0f;
  return act;
}

// One random-mode step: the action, (cos, sin) of the angle under the speed
// ODE, eesm_action_step, then (WIENER) the reference advance.
template <bool FINITE, bool MECH, int NREF, bool WIENER>
__device__ __forceinline__ EesmStepOut eesm_random_step(const EesmConst& k, uint2 key,
                                                        uint32_t env, uint32_t t, EesmState& x,
                                                        float& c, float& s, RefRows<NREF>& refs) {
  const uint4 w = drive_draw(key, env, t, DRIVE_SLOT_STEP);
  const EesmAction act = eesm_random_action<FINITE>(key, env, t, w);
  if (MECH) {
    c = cosf(x.eps);
    s = sinf(x.eps);
  }
  const EesmStepOut out = eesm_action_step<FINITE, MECH, NREF>(k, act, x, c, s, refs);
  if (WIENER) ref_wiener_advance<NREF>(k.ref, key, env, t, w, out.done != 0.0f, refs);
  return out;
}

// The buffer step's action at step t: int32 (T, 2, N) (B6 bits, 4QC), or
// float32 (T, 4, N) duty commands.
template <bool FINITE>
__device__ __forceinline__ EesmAction eesm_read_action(const int* __restrict__ act_i,
                                                       const float* __restrict__ act_f, int n,
                                                       int t, int e) {
  EesmAction a;
  if (FINITE) {
    const size_t base = (size_t)t * 2 * n + e;
    a.b6.bits = act_i[base];
    a.b6.a = a.b6.b = a.b6.c = 0.0f;
    a.e_bits = act_i[base + n];
    a.e = 0.0f;
  } else {
    const size_t base = (size_t)t * 4 * n + e;
    a.b6.bits = 0;
    a.b6.a = act_f[base];
    a.b6.b = act_f[base + n];
    a.b6.c = act_f[base + 2 * (size_t)n];
    a.e_bits = 0;
    a.e = act_f[base + 3 * (size_t)n];
  }
  return a;
}

// The buffer step: the exact (cos, sin) of the angle every step, no
// references, no reset.
template <bool FINITE, bool MECH>
__device__ __forceinline__ void eesm_buffer_step(const EesmConst& k, const EesmAction& act,
                                                 EesmState& x) {
  eesm_physics<FINITE, MECH>(k, act, cosf(x.eps), sinf(x.eps), x);
}

// ---- what the kernels of both sources share ------------------------------

// The planes of one state, (omega or NULL, i_sd, i_sq, i_e, eps), by value
// so that a kernel takes them as parameters.
struct EesmInPlanes {
  const float* p[5];
};

struct EesmPlanes {
  float* p[5];
};

template <bool MECH>
__device__ __forceinline__ EesmState eesm_load_state(const EesmInPlanes& in, int e) {
  EesmState x;
  x.w = MECH ? in.p[0][e] : 0.0f;
  x.i_sd = in.p[1][e];
  x.i_sq = in.p[2][e];
  x.i_e = in.p[3][e];
  x.eps = in.p[4][e];
  return x;
}

template <bool MECH>
__device__ __forceinline__ void eesm_store_state(const EesmState& x, const EesmPlanes& o,
                                                 size_t i) {
  if (MECH) o.p[0][i] = x.w;
  o.p[1][i] = x.i_sd;
  o.p[2][i] = x.i_sq;
  o.p[3][i] = x.i_e;
  o.p[4][i] = x.eps;
}

inline EesmInPlanes eesm_in_planes(const float* const* in) {
  EesmInPlanes planes;
  for (int j = 0; j < 5; ++j) planes.p[j] = in[j];
  return planes;
}

inline EesmPlanes eesm_out_planes(float* const* out) {
  EesmPlanes planes;
  for (int j = 0; j < 5; ++j) planes.p[j] = out[j];
  return planes;
}

inline EesmConst eesm_load_const(const float* host, const int* flags) {
  EesmConst k;
  for (int i = 0; i < N_EESM_CONST; ++i) k.v[i] = host[i];
  for (int r = 0; r < kEesmRows; ++r) {
    for (int j = 0; j < N_ROW_CONST; ++j) {
      k.ref.row[r][j] = host[N_EESM_CONST + r * N_ROW_CONST + j];
    }
  }
  k.ref.two_pi = host[E_TWO_PI];
  k.ref.ln10 = host[E_LN10];
  k.ref.u_min = host[E_U_MIN];
  for (int i = 0; i < N_EESM_FLAG; ++i) k.flag[i] = flags[i];
  k.ref.all_const = flags[EF_ALL_CONST];
  return k;
}

inline uint2 eesm_seed_key(unsigned long long seed) {
  return make_uint2((uint32_t)(seed & 0xFFFFFFFFull), (uint32_t)(seed >> 32));
}

// Instance index of (FINITE, MECH, NREF), NREF 1 (TC, SC) or 3 (CC):
// 4 * finite + 2 * mech + (nref == 3) for the random kernels, 2 * finite +
// mech for the buffer kernels; -1 for flags no instance serves.
inline int eesm_random_index(const int* f) {
  if (f[EF_NREF] != 1 && f[EF_NREF] != kEesmRows) return -1;
  return 4 * (f[EF_FINITE] != 0) + 2 * (f[EF_MECH] != 0) + (f[EF_NREF] == kEesmRows);
}

inline int eesm_buffer_index(const int* f) { return 2 * (f[EF_FINITE] != 0) + (f[EF_MECH] != 0); }
