// One env-step of the universal DC-family (PermExDc, SeriesDc, ShuntDc,
// ExtExDc) fused rollouts, shared by the kernels of fused_dc.cu and
// fused_dc_record.cu so that the reducing rollout and the recorder cannot
// diverge.
//
// Replaces the step closures of _dc_family in
// gym_electric_motor_tpu/ops/pallas_dc.py (:593-1101): the converter law
// conv_u without bridge planes (:682-715: finite and cont 1QC, 2QC, 4QC and
// the dual-4QC multi converter, at zero interlock), the motor laws resolve,
// el_rhs and torque (:782-840), rk4 (:878-892), step_physics on its
// zero-interlock branch (:962-964), reset_state (:966-974, the polynomial
// load's reset draws nothing), ref_quantity (:987-997), violated_fn
// (:1003-1010) and _sample_actions (:1020-1042); the reference machinery,
// the WSE reward and the polynomial load are common_step.cuh's.  The plain
// PyTorch version of the same arithmetic, in the same order, is
// gym_electric_motor_tpu_torch/ops/fused_dc_family.py.
//
// Every float constant (motor, load, converter, reward and reference
// constants, 1 / l_a, r_a + r_e, tau / 6, ...) arrives from the host as
// float32 in DcConst, so host and device round them identically.  The motor
// laws of one class share one form: di0/dt = ((-A w - r i0) - (B w) ix + u0)
// / l with (A, B) = (psi_e, 0) for PermExDc and (0, l_e') otherwise, ix = i0
// for one current and i_e for two; at constant speed -A w and B w are host
// constants.  The converter law and the referenced quantity are runtime
// codes selected without branches; what changes the state's shape is a
// template parameter (FINITE, MECH, the motor class MC, NREF).
#pragma once

#include <cstdint>

#include "common_step.cuh"

enum DcConstIndex {
  D_U_SUP = 0,       // supply voltage
  D_HALF_TAU,        // 0.5 * tau, the RK4 mid-stage step
  D_TAU,
  D_SIXTH,           // tau / 6
  D_NEG_A,           // dynamic speed: -A (-psi_e, or -0)
  D_NEG_AW,          // constant speed: -A * omega_fixed
  D_R,               // r_a, or r_a + r_e for SeriesDc
  D_B,               // dynamic speed: B (0, or l_e')
  D_BW,              // constant speed: B * omega_fixed
  D_INV_L,           // 1 / l_a, or 1 / (l_a + l_e) for SeriesDc
  D_NEG_RE,          // two currents: -r_e
  D_INV_LE,          //   1 / l_e
  D_TQ,              // torque gain: psi_e or l_e'
  D_LOAD_A,          // polynomial static load: a, b, c
  D_LOAD_B,
  D_LOAD_C,
  D_OMEGA_LIN,       //   a / j_total * tau_decay: below it the a-term is linear
  D_JT_OVER_TD,      //   j_total / tau_decay
  D_INV_JT,          //   1 / j_total
  D_LIM0,            // current limits of the constraint
  D_LIM1,
  D_BIAS,            // WSE reward bias
  D_VIOLATION_REWARD,
  D_ACT_LO0,         // continuous random actions lo + span * U, per channel
  D_ACT_SPAN0,
  D_ACT_LO1,
  D_ACT_SPAN1,
  D_TWO_PI,
  D_LN10,
  D_U_MIN,           // guard before the Box-Muller log
  N_DC_CONST
};

// What a reference row refers to.
enum DcQuantity { DQ_EL0 = 0, DQ_EL1, DQ_TORQUE, DQ_OMEGA };

// The motor classes: one current (PermExDc, SeriesDc), two currents on one
// converter channel fed i_a + i_e (ShuntDc), two channels (ExtExDc).
enum DcMotorClass { MC_ONE = 0, MC_SHUNT, MC_EXTEX };

enum DcFlag {
  DF_QTY0 = 0,   // DcQuantity of row 0
  DF_QTY1,       // and of row 1
  DF_ALL_CONST,  // every reference constant: no reference draws at all
  DF_NO_CONS,    // constraints=(): the env never terminates
  DF_FINITE,     // the template parameters the host launches
  DF_MECH,
  DF_NREF,
  DF_MCLASS,
  DF_CONV0,      // converter law of each channel: 1, 2 or 4 quadrants
  DF_CONV1,
  DF_SERIES,     // SeriesDc: the torque is l_e' i^2
  N_DC_FLAG
};

struct DcConst {
  float v[N_DC_CONST];
  RefConst ref;   // the reference rows; two_pi, ln10 and u_min repeat D_TWO_PI, D_LN10, D_U_MIN
  int flag[N_DC_FLAG];
};

// The drive state of one env; w is unused at constant speed, i1 with one
// current.
struct DcState {
  float w, i0, i1;
};

// A finite action per channel (a0, a1) or a continuous one (f0, f1).
struct DcAction {
  int a0, a1;
  float f0, f1;
};

struct DcStepOut {
  DcAction act;
  float reward, done;
  float ref[2];   // the references the reward was taken against
};

// One channel's voltage fraction from its action and the pre-step current.
// Finite: 1QC conducts through its diode while i < 0; 2QC action 0
// freewheels (1 while i < 0); 4QC maps 0..3 to 0, 1, -1, 0.  Continuous:
// the duty clipped to [0, 1] (1QC: 1 while i < 0; 2QC) or [-1, 1] (4QC).
template <bool FINITE>
__device__ __forceinline__ float dc_conv_frac(int code, int a, float f, float i) {
  if (FINITE) {
    const float q1 = i >= 0.0f ? (float)a : 1.0f;
    const float free_wheel = i < 0.0f ? 1.0f : 0.0f;
    const float q2 = a == 1 ? 1.0f : (a == 2 ? 0.0f : free_wheel);
    const float q4 = (a == 1 ? 1.0f : 0.0f) - (a == 2 ? 1.0f : 0.0f);
    return code == 1 ? q1 : (code == 2 ? q2 : q4);
  }
  const float c01 = fminf(fmaxf(f, 0.0f), 1.0f);
  const float q1 = i >= 0.0f ? c01 : 1.0f;
  const float q4 = fminf(fmaxf(f, -1.0f), 1.0f);
  return code == 1 ? q1 : (code == 2 ? c01 : q4);
}

// psi_e i (times 1, exact), l_e' i^2 or l_e' i_a i_e.
template <int MC>
__device__ __forceinline__ float dc_torque(const DcConst& k, float i0, float i1) {
  const float t = k.v[D_TQ] * i0;
  if (MC != MC_ONE) return t * i1;
  return t * (k.flag[DF_SERIES] ? i0 : 1.0f);
}

// The joint right-hand side at one RK4 stage: (d omega, d i0, d i1).
template <bool MECH, int MC>
__device__ __forceinline__ void dc_rhs(const DcConst& k, float w, float i0, float i1, float u0,
                                       float u1, float& dw, float& d0, float& d1) {
  const float aw = MECH ? k.v[D_NEG_A] * w : k.v[D_NEG_AW];
  const float bw = MECH ? k.v[D_B] * w : k.v[D_BW];
  const float ix = MC == MC_ONE ? i0 : i1;
  d0 = (((aw - k.v[D_R] * i0) - bw * ix) + u0) * k.v[D_INV_L];
  d1 = MC != MC_ONE ? (k.v[D_NEG_RE] * i1 + u1) * k.v[D_INV_LE] : 0.0f;
  dw = MECH ? poly_load_rhs(k.v[D_LOAD_A], k.v[D_LOAD_B], k.v[D_LOAD_C], k.v[D_OMEGA_LIN],
                            k.v[D_JT_OVER_TD], k.v[D_INV_JT], w, dc_torque<MC>(k, i0, i1))
            : 0.0f;
}

// Converter fractions from the pre-step current (i_a + i_e for ShuntDc),
// times the supply voltage, then RK4 over (omega?, i0, i1?).
template <bool FINITE, bool MECH, int MC>
__device__ __forceinline__ void dc_physics(const DcConst& k, const DcAction& act, DcState& x) {
  const float i_conv = MC == MC_SHUNT ? x.i0 + x.i1 : x.i0;
  const float u0 = dc_conv_frac<FINITE>(k.flag[DF_CONV0], act.a0, act.f0, i_conv) * k.v[D_U_SUP];
  const float u1 = MC == MC_EXTEX
                       ? dc_conv_frac<FINITE>(k.flag[DF_CONV1], act.a1, act.f1, x.i1) * k.v[D_U_SUP]
                       : u0;
  const float h = k.v[D_HALF_TAU], dt = k.v[D_TAU], sixth = k.v[D_SIXTH];
  float k1w, k10, k11, k2w, k20, k21, k3w, k30, k31, k4w, k40, k41;
  dc_rhs<MECH, MC>(k, x.w, x.i0, x.i1, u0, u1, k1w, k10, k11);
  dc_rhs<MECH, MC>(k, x.w + h * k1w, x.i0 + h * k10, x.i1 + h * k11, u0, u1, k2w, k20, k21);
  dc_rhs<MECH, MC>(k, x.w + h * k2w, x.i0 + h * k20, x.i1 + h * k21, u0, u1, k3w, k30, k31);
  dc_rhs<MECH, MC>(k, x.w + dt * k3w, x.i0 + dt * k30, x.i1 + dt * k31, u0, u1, k4w, k40, k41);
  if (MECH) x.w = x.w + sixth * (k1w + 2.0f * (k2w + k3w) + k4w);
  x.i0 = x.i0 + sixth * (k10 + 2.0f * (k20 + k30) + k40);
  if (MC != MC_ONE) x.i1 = x.i1 + sixth * (k11 + 2.0f * (k21 + k31) + k41);
}

// The normalised referenced quantity of a row, chosen by selects.
template <int MC>
__device__ __forceinline__ float dc_quantity(const DcConst& k, int row, const DcState& x) {
  const int code = k.flag[DF_QTY0 + row];
  float q = x.i0;
  q = code == DQ_EL1 ? x.i1 : q;
  q = code == DQ_TORQUE ? dc_torque<MC>(k, x.i0, x.i1) : q;
  q = code == DQ_OMEGA ? x.w : q;
  return q * k.ref.row[row][R_INV_LIM];
}

// One step under an action: physics, the limit constraint on every
// current, the WSE reward against the pre-advance references and the reset
// of a violating env to zeros.  The references are left to the caller.
template <bool FINITE, bool MECH, int MC, int NREF>
__device__ __forceinline__ DcStepOut dc_action_step(const DcConst& k, const DcAction& act,
                                                    DcState& x, const RefRows<NREF>& refs) {
  DcStepOut out;
  out.act = act;
  DcState y = x;
  dc_physics<FINITE, MECH, MC>(k, act, y);
  const bool over = fabsf(y.i0) > k.v[D_LIM0] || (MC != MC_ONE && fabsf(y.i1) > k.v[D_LIM1]);
  const bool violated = !k.flag[DF_NO_CONS] && over;
  const float wse = ref_wse<NREF>(k.ref, k.v[D_BIAS], dc_quantity<MC>(k, 0, y),
                                  NREF == 2 ? dc_quantity<MC>(k, 1, y) : 0.0f, refs);
  out.reward = violated ? k.v[D_VIOLATION_REWARD] : wse;
  out.done = violated ? 1.0f : 0.0f;
  out.ref[0] = refs.rv[0];
  out.ref[1] = refs.rv[NREF - 1];
  x.w = violated ? 0.0f : y.w;
  x.i0 = violated ? 0.0f : y.i0;
  x.i1 = violated ? 0.0f : y.i1;
  return out;
}

// The random actions from the step's words: a finite 4QC takes the low 2
// bits of w.x (ExtExDc both channels, bits 0-1 and 2-3), a 1QC the low bit,
// a 2QC min(floor(3 u), 2); a continuous channel lo + span * u from w.x
// (and w.w for the second).
template <bool FINITE, int MC>
__device__ __forceinline__ DcAction dc_sample(const DcConst& k, uint4 w) {
  DcAction a;
  a.a0 = a.a1 = 0;
  a.f0 = a.f1 = 0.0f;
  if (FINITE) {
    if (MC == MC_EXTEX) {
      a.a0 = (int)(w.x & 3u);
      a.a1 = (int)((w.x >> 2) & 3u);
    } else {
      const int code = k.flag[DF_CONV0];
      const int q2 = min((int)floorf(uniform24(w.x) * 3.0f), 2);
      a.a0 = code == 4 ? (int)(w.x & 3u) : (code == 1 ? (int)(w.x & 1u) : q2);
    }
  } else {
    a.f0 = k.v[D_ACT_LO0] + k.v[D_ACT_SPAN0] * uniform24(w.x);
    if (MC == MC_EXTEX) a.f1 = k.v[D_ACT_LO1] + k.v[D_ACT_SPAN1] * uniform24(w.w);
  }
  return a;
}

// One random-mode step: the actions from the step's words, dc_action_step,
// then (WIENER) the reference advance.
template <bool FINITE, bool MECH, int MC, int NREF, bool WIENER>
__device__ __forceinline__ DcStepOut dc_random_step(const DcConst& k, uint2 key, uint32_t env,
                                                    uint32_t t, DcState& x, RefRows<NREF>& refs) {
  const uint4 w = drive_draw(key, env, t, DRIVE_SLOT_STEP);
  const DcAction act = dc_sample<FINITE, MC>(k, w);
  const DcStepOut out = dc_action_step<FINITE, MECH, MC, NREF>(k, act, x, refs);
  if (WIENER) ref_wiener_advance<NREF>(k.ref, key, env, t, w, out.done != 0.0f, refs);
  return out;
}

// ---- what the kernels of both sources share ------------------------------

// The buffer step's actions at step t: (T, N) for one channel, (T, 2, N)
// for ExtExDc; int32 for a finite converter, float32 for a continuous one.
template <bool FINITE, int MC>
__device__ __forceinline__ DcAction dc_read_action(const int* __restrict__ act_i,
                                                   const float* __restrict__ act_f, int n, int t,
                                                   int e) {
  DcAction a;
  a.a0 = a.a1 = 0;
  a.f0 = a.f1 = 0.0f;
  const int n_ch = MC == MC_EXTEX ? 2 : 1;
  const size_t base = (size_t)t * n_ch * n + e;
  if (FINITE) {
    a.a0 = act_i[base];
    if (MC == MC_EXTEX) a.a1 = act_i[base + n];
  } else {
    a.f0 = act_f[base];
    if (MC == MC_EXTEX) a.f1 = act_f[base + n];
  }
  return a;
}

template <bool MECH, int MC>
__device__ __forceinline__ DcState dc_load_state(const float* __restrict__ w0,
                                                 const float* __restrict__ i00,
                                                 const float* __restrict__ i10, int e) {
  DcState x;
  x.w = MECH ? w0[e] : 0.0f;
  x.i0 = i00[e];
  x.i1 = MC != MC_ONE ? i10[e] : 0.0f;
  return x;
}

template <bool MECH, int MC>
__device__ __forceinline__ void dc_store_state(const DcState& x, float* __restrict__ w,
                                               float* __restrict__ i0, float* __restrict__ i1,
                                               size_t i) {
  if (MECH) w[i] = x.w;
  i0[i] = x.i0;
  if (MC != MC_ONE) i1[i] = x.i1;
}

inline DcConst dc_load_const(const float* host, const int* flags) {
  DcConst k;
  for (int i = 0; i < N_DC_CONST; ++i) k.v[i] = host[i];
  for (int r = 0; r < 2; ++r) {
    for (int j = 0; j < N_ROW_CONST; ++j) k.ref.row[r][j] = host[N_DC_CONST + r * N_ROW_CONST + j];
  }
  k.ref.two_pi = host[D_TWO_PI];
  k.ref.ln10 = host[D_LN10];
  k.ref.u_min = host[D_U_MIN];
  for (int i = 0; i < N_DC_FLAG; ++i) k.flag[i] = flags[i];
  k.ref.all_const = flags[DF_ALL_CONST];
  return k;
}

inline uint2 dc_seed_key(unsigned long long seed) {
  return make_uint2((uint32_t)(seed & 0xFFFFFFFFull), (uint32_t)(seed >> 32));
}

// Instance index of (FINITE, MECH, MC, NREF) in the kernels' tables:
// ((2 finite + mech) 3 + mc) 2 + nref - 1; -1 for flags out of range.  The
// tables hold nullptr where no instance is built: two reference rows exist
// only for ExtExDc at constant speed (the catalog's CC task).
inline int dc_instance(const int* f) {
  if (f[DF_NREF] != 1 && f[DF_NREF] != 2) return -1;
  if (f[DF_MCLASS] < MC_ONE || f[DF_MCLASS] > MC_EXTEX) return -1;
  return ((2 * (f[DF_FINITE] != 0) + (f[DF_MECH] != 0)) * 3 + f[DF_MCLASS]) * 2 + f[DF_NREF] - 1;
}

// Whether (MECH, MC, NREF) is built.
template <bool MECH, int MC, int NREF>
constexpr bool dc_built() {
  return NREF == 1 || (MC == MC_EXTEX && !MECH);
}
