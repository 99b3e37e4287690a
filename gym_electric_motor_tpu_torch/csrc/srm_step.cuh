// One env-step of the universal switched reluctance (SRM) fused rollouts,
// shared by the kernels of fused_srm.cu and fused_srm_record.cu so that the
// reducing rollout and the recorder cannot diverge.
//
// Replaces the step closures of _srm_family in
// gym_electric_motor_tpu/ops/pallas_srm.py (:70-427): _trig_cs (:145-151),
// _tq (:157-173), rhs (:179-226), fracs (:228-235), the stage rotations and
// rk4 (:242-268), physics_step with the ideal-diode clamp (:270-294),
// ref_quantity (:314-325), _sample_actions (:327-335), the kernels' wrap
// (:460-462) and violated (:387-393), with _rotation_protocol of
// ops/pallas_common.py (:1476-1494) for the constant-speed rotation; the
// reference machinery (three rows for the CC ids), the WSE reward and the
// polynomial load are common_step.cuh's.  The plain PyTorch version of the
// same arithmetic, in the same order, is
// gym_electric_motor_tpu_torch/ops/fused_srm_family.py.
//
// The inductance depends on the angle inside the step: every RK4 stage takes
// sin and cos of eps - phi_k for the three phases from one (cos eps, sin eps)
// pair turned by the constant phase offsets, and divides by l0 - l1 c_k (a
// true division, as XLA keeps it: the divisor is not a constant).  At
// constant speed the pair of the stages is the cycle-start pair turned by
// the half- and full-step rotations (no transcendental for the physics);
// under the speed ODE each stage takes cosf and sinf of its own angle.
// Saturation (SAT) is a template parameter: its exp factor and coenergy
// torque cost the linear instances nothing.  Every float constant arrives
// from the host as float32 in SrmConst.
#pragma once

#include <cstdint>

#include "common_step.cuh"

enum SrmConstIndex {
  S_U_SUP = 0,         // supply voltage
  S_HALF_TAU,          // 0.5 * tau, the RK4 mid-stage step
  S_TAU,
  S_SIXTH,             // float32(tau) / 6
  S_TWO_PI,
  S_INV_TWO_PI,
  S_PI,                // the wrap to [-pi, pi)
  S_P,                 // dynamic speed: pole pairs, times omega (the angle rate)
  S_PW,                // constant speed: p * omega_fixed, the angle rate
  S_W_FIXED,           //   omega_fixed, in the back-EMF term
  S_R_S,
  S_PL1,               // p * l1, the inductance slope's amplitude
  S_L0,                // mean inductance
  S_L1,                // half the aligned-unaligned difference
  S_SIN_PHI,           // sin(2 pi / 3); cos(2 pi / 3) is -1/2
  S_CH,                // constant speed: cos / sin of 0.5 tau p omega (the mid stages)
  S_SH,
  S_COS_D,             //   and of tau p omega (the last stage, the incremental rotation)
  S_SIN_D,
  S_INV_PSI_S,         // saturation: 1 / psi_s
  S_PSI_S2,            //   psi_s^2
  S_LOAD_A,            // polynomial static load: a, b, c
  S_LOAD_B,
  S_LOAD_C,
  S_OMEGA_LIN,         //   a / j_total * tau_decay: below it the a-term is linear
  S_JT_OVER_TD,        //   j_total / tau_decay
  S_INV_JT,            //   1 / j_total
  S_INV_ILIM,          // 1 / phase current limit (the limit constraint)
  S_BIAS,              // WSE reward bias
  S_VIOLATION_REWARD,
  S_LN10,
  S_U_MIN,             // guard before the Box-Muller log
  N_SRM_CONST
};

// What a reference row refers to (the referenced quantity's code).
enum SrmQuantity { SQ_I_A = 0, SQ_I_B, SQ_I_C, SQ_TORQUE, SQ_OMEGA };

enum SrmFlag {
  SF_QTY0 = 0,       // SrmQuantity of rows 0, 1 and 2
  SF_QTY1,
  SF_QTY2,
  SF_ALL_CONST,      // every reference constant: no reference draws at all
  SF_NO_CONS,        // constraints=(): the env never terminates
  SF_FINITE,         // the template parameters the host launches
  SF_MECH,
  SF_NREF,
  SF_SAT,
  SF_NEEDS_TORQUE,   // a row refers to the torque: the step takes cos and sin of the angle
  N_SRM_FLAG
};

constexpr int kSrmRows = 3;

struct SrmConst {
  float v[N_SRM_CONST];
  RefConstN<kSrmRows> ref;   // two_pi, ln10 and u_min repeat S_TWO_PI, S_LN10, S_U_MIN
  int flag[N_SRM_FLAG];
};

// The drive state of one env; w is unused at constant speed.
struct SrmState {
  float w, ia, ib, ic, eps;
};

// Per-phase commands 0 (freewheel), 1 (+u_sup), 2 (-u_sup) (finite) or duties
// (continuous).
struct SrmAction {
  int a[3];
  float d[3];
};

struct SrmStepOut {
  SrmAction act;
  float reward, done;
  float ref[kSrmRows];   // the references the reward was taken against
};

// One phase's geometry at a stage: sin and cos of eps - phi_k, the
// inductance l0 - l1 c_k and, saturating, x = i l / psi_s and e = exp(-x).
struct SrmPhase {
  float s, l, x, e;
};

// One phase's geometry from the sine and cosine of its angle eps - phi_k:
// the inductance l0 - l1 c_k and, saturating, x = i l / psi_s and
// e = exp(-x).  srm_phases takes it for each phase, the lane-group step
// (srm_lanes.cuh) for its own.
template <bool SAT>
__device__ __forceinline__ SrmPhase srm_phase(const SrmConst& k, float s_k, float c_k, float i) {
  SrmPhase ph;
  ph.s = s_k;
  ph.l = k.v[S_L0] - k.v[S_L1] * c_k;
  if (SAT) {
    ph.x = i * ph.l * k.v[S_INV_PSI_S];
    ph.e = expf(-ph.x);
  } else {
    ph.x = ph.e = 0.0f;
  }
  return ph;
}

// The three phases from (cos eps, sin eps) = (ce, se): phase a is the pair
// itself, phases b and c turn it by cos phi = -1/2, sin phi = +-sin(2 pi / 3).
template <bool SAT>
__device__ __forceinline__ void srm_phases(const SrmConst& k, float ce, float se, float ia,
                                           float ib, float ic, SrmPhase ph[3]) {
  const float sp = k.v[S_SIN_PHI];
  const float c_k[3] = {ce, ce * -0.5f + se * sp, ce * -0.5f + se * -sp};
  const float s_k[3] = {se, se * -0.5f - ce * sp, se * -0.5f - ce * -sp};
  const float i3[3] = {ia, ib, ic};
#pragma unroll
  for (int j = 0; j < 3; ++j) ph[j] = srm_phase<SAT>(k, s_k[j], c_k[j], i3[j]);
}

// One phase's torque term: i^2 s_k (linear), or the coenergy form's
// ((p l1 s_k) psi_s^2 / l_k^2) ((1 - e) - x e) when saturating.
template <bool SAT>
__device__ __forceinline__ float srm_torque_term(const SrmConst& k, float i, const SrmPhase& ph) {
  return SAT ? (k.v[S_PL1] * ph.s * k.v[S_PSI_S2] / (ph.l * ph.l)) * ((1.0f - ph.e) - ph.x * ph.e)
             : i * i * ph.s;
}

// The reluctance torque from the three terms, summed in phase order: p l1
// (1/2) sum i^2 s_k, or the sum of the coenergy terms when saturating.
template <bool SAT>
__device__ __forceinline__ float srm_torque_sum(const SrmConst& k, float t0, float t1, float t2) {
  return SAT ? t0 + t1 + t2 : k.v[S_PL1] * (0.5f * (t0 + t1 + t2));
}

template <bool SAT>
__device__ __forceinline__ float srm_torque(const SrmConst& k, float ia, float ib, float ic,
                                            const SrmPhase ph[3]) {
  return srm_torque_sum<SAT>(k, srm_torque_term<SAT>(k, ia, ph[0]),
                             srm_torque_term<SAT>(k, ib, ph[1]),
                             srm_torque_term<SAT>(k, ic, ph[2]));
}

// One phase's current slope at the speed wv:
// ((u - r_s i) - (i (p l1 s_k)) wv [e]) / (l_k [e]).
template <bool SAT>
__device__ __forceinline__ float srm_slope(const SrmConst& k, float u, float i, float wv,
                                           const SrmPhase& ph) {
  const float emf = i * (k.v[S_PL1] * ph.s) * wv;
  return SAT ? ((u - k.v[S_R_S] * i) - emf * ph.e) / (ph.l * ph.e)
             : ((u - k.v[S_R_S] * i) - emf) / ph.l;
}

// The right-hand side at one RK4 stage at the angle (ce, se): d omega (the
// polynomial load under the torque, MECH) and the three current slopes
// ((u - r_s i) - (i (p l1 s_k)) w [e]) / (l_k [e]).
template <bool MECH, bool SAT>
__device__ __forceinline__ void srm_rhs(const SrmConst& k, float w, float ia, float ib, float ic,
                                        float ce, float se, const float u[3], float& dw,
                                        float di[3]) {
  SrmPhase ph[3];
  srm_phases<SAT>(k, ce, se, ia, ib, ic, ph);
  const float wv = MECH ? w : k.v[S_W_FIXED];
  const float i3[3] = {ia, ib, ic};
#pragma unroll
  for (int j = 0; j < 3; ++j) di[j] = srm_slope<SAT>(k, u[j], i3[j], wv, ph[j]);
  dw = MECH ? poly_load_rhs(k.v[S_LOAD_A], k.v[S_LOAD_B], k.v[S_LOAD_C], k.v[S_OMEGA_LIN],
                            k.v[S_JT_OVER_TD], k.v[S_INV_JT], w,
                            srm_torque<SAT>(k, ia, ib, ic, ph))
            : 0.0f;
}

// The phase voltages as fractions of the supply voltage: finite
// (a == 1) - (a == 2), continuous the duty clipped to [-1, 1].
template <bool FINITE>
__device__ __forceinline__ float srm_fraction(int a, float d) {
  return FINITE ? (float)(a == 1) - (float)(a == 2) : fminf(fmaxf(d, -1.0f), 1.0f);
}

template <bool FINITE>
__device__ __forceinline__ float srm_fraction(const SrmAction& act, int j) {
  return srm_fraction<FINITE>(act.a[j], act.d[j]);
}

// Fractions times the supply voltage -> RK4 over (omega?, i_a, i_b, i_c,
// eps) -> the currents clamped at zero -> eps wrapped to [-pi, pi).  At
// constant speed (c, s) is cos / sin of the cycle-start angle (the carried
// rotation, or afresh in buffer mode) and eps integrates the constant rate
// p * omega_fixed through the RK4 sum; under the speed ODE every stage takes
// cosf and sinf of its own angle and (c, s) is unused.
template <bool FINITE, bool MECH, bool SAT>
__device__ __forceinline__ void srm_physics(const SrmConst& k, const SrmAction& act, float c,
                                            float s, SrmState& x) {
  float u[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) u[j] = srm_fraction<FINITE>(act, j) * k.v[S_U_SUP];
  const float h = k.v[S_HALF_TAU], dt = k.v[S_TAU], sixth = k.v[S_SIXTH];
  float c1 = c, s1 = s, ch = 0.0f, sh = 0.0f, cf = 0.0f, sf = 0.0f;
  if (MECH) {
    c1 = cosf(x.eps);
    s1 = sinf(x.eps);
  } else {
    ch = c * k.v[S_CH] - s * k.v[S_SH];
    sh = s * k.v[S_CH] + c * k.v[S_SH];
    cf = c * k.v[S_COS_D] - s * k.v[S_SIN_D];
    sf = s * k.v[S_COS_D] + c * k.v[S_SIN_D];
  }
  const float p = k.v[S_P];
  float k1w, k2w, k3w, k4w, k1[3], k2[3], k3[3], k4[3];
  srm_rhs<MECH, SAT>(k, x.w, x.ia, x.ib, x.ic, c1, s1, u, k1w, k1);
  const float w2 = x.w + h * k1w;
  if (MECH) {
    const float e2 = x.eps + h * (p * x.w);
    ch = cosf(e2);
    sh = sinf(e2);
  }
  srm_rhs<MECH, SAT>(k, w2, x.ia + h * k1[0], x.ib + h * k1[1], x.ic + h * k1[2], ch, sh, u, k2w,
                     k2);
  const float w3 = x.w + h * k2w;
  if (MECH) {
    const float e3 = x.eps + h * (p * w2);
    ch = cosf(e3);
    sh = sinf(e3);
  }
  srm_rhs<MECH, SAT>(k, w3, x.ia + h * k2[0], x.ib + h * k2[1], x.ic + h * k2[2], ch, sh, u, k3w,
                     k3);
  const float w4 = x.w + dt * k3w;
  if (MECH) {
    const float e4 = x.eps + dt * (p * w3);
    cf = cosf(e4);
    sf = sinf(e4);
  }
  srm_rhs<MECH, SAT>(k, w4, x.ia + dt * k3[0], x.ib + dt * k3[1], x.ic + dt * k3[2], cf, sf, u,
                     k4w, k4);
  if (MECH) {
    x.eps = x.eps + sixth * (p * x.w + 2.0f * (p * w2 + p * w3) + p * w4);
    x.w = x.w + sixth * (k1w + 2.0f * (k2w + k3w) + k4w);
  } else {
    const float de = k.v[S_PW];
    x.eps = x.eps + sixth * (de + 2.0f * (de + de) + de);
  }
  const float ia = x.ia + sixth * (k1[0] + 2.0f * (k2[0] + k3[0]) + k4[0]);
  const float ib = x.ib + sixth * (k1[1] + 2.0f * (k2[1] + k3[1]) + k4[1]);
  const float ic = x.ic + sixth * (k1[2] + 2.0f * (k2[2] + k3[2]) + k4[2]);
  // the ideal diodes: a phase current never goes negative
  x.ia = ia < 0.0f ? 0.0f : ia;
  x.ib = ib < 0.0f ? 0.0f : ib;
  x.ic = ic < 0.0f ? 0.0f : ic;
  x.eps = x.eps - k.v[S_TWO_PI] * floorf((x.eps + k.v[S_PI]) * k.v[S_INV_TWO_PI]);
}

// The normalised referenced quantity of a row, chosen by selects; tq is the
// torque at the wrapped angle (0 where no row refers to it).
__device__ __forceinline__ float srm_quantity(const SrmConst& k, int row, const SrmState& x,
                                              float tq) {
  const int code = k.flag[SF_QTY0 + row];
  float q = x.ia;
  q = code == SQ_I_B ? x.ib : q;
  q = code == SQ_I_C ? x.ic : q;
  q = code == SQ_TORQUE ? tq : q;
  q = code == SQ_OMEGA ? x.w : q;
  return q * k.ref.row[row][R_INV_LIM];
}

// The constant-speed rotation one step on, renormalised by rsqrt, and
// (1, 0) after a violation.
__device__ __forceinline__ void srm_rotation_advance(const SrmConst& k, bool violated, float& c,
                                                     float& s) {
  const float c_new = c * k.v[S_COS_D] - s * k.v[S_SIN_D];
  const float s_new = s * k.v[S_COS_D] + c * k.v[S_SIN_D];
  const float inv = rsqrtf(c_new * c_new + s_new * s_new);
  c = violated ? 1.0f : c_new * inv;
  s = violated ? 0.0f : s_new * inv;
}

// One step under an action: physics, the limit constraint on the three
// phase currents, the WSE reward against the pre-advance references (a
// torque reference takes cosf and sinf of the wrapped angle afresh), the
// reset of a violating env to zeros (the angle too) and, at constant speed,
// the incremental rotation with rsqrt renormalisation, reset to (1, 0) on a
// violation.  The references are left to the caller.
template <bool FINITE, bool MECH, int NREF, bool SAT>
__device__ __forceinline__ SrmStepOut srm_action_step(const SrmConst& k, const SrmAction& act,
                                                      SrmState& x, float& c, float& s,
                                                      const RefRows<NREF>& refs) {
  SrmStepOut out;
  out.act = act;
  SrmState y = x;
  srm_physics<FINITE, MECH, SAT>(k, act, c, s, y);
  const float il = k.v[S_INV_ILIM];
  const bool violated = !k.flag[SF_NO_CONS]
      && (fabsf(y.ia) * il > 1.0f || fabsf(y.ib) * il > 1.0f || fabsf(y.ic) * il > 1.0f);
  float tq = 0.0f;
  if (k.flag[SF_NEEDS_TORQUE]) {
    SrmPhase ph[3];
    srm_phases<SAT>(k, cosf(y.eps), sinf(y.eps), y.ia, y.ib, y.ic, ph);
    tq = srm_torque<SAT>(k, y.ia, y.ib, y.ic, ph);
  }
  const float wse = ref_wse<NREF>(k.ref, k.v[S_BIAS], srm_quantity(k, 0, y, tq),
                                  NREF >= 2 ? srm_quantity(k, 1, y, tq) : 0.0f, refs,
                                  NREF == 3 ? srm_quantity(k, 2, y, tq) : 0.0f);
  out.reward = violated ? k.v[S_VIOLATION_REWARD] : wse;
  out.done = violated ? 1.0f : 0.0f;
#pragma unroll
  for (int r = 0; r < kSrmRows; ++r) out.ref[r] = refs.rv[r < NREF ? r : NREF - 1];
  x.w = violated ? 0.0f : y.w;
  x.ia = violated ? 0.0f : y.ia;
  x.ib = violated ? 0.0f : y.ib;
  x.ic = violated ? 0.0f : y.ic;
  x.eps = violated ? 0.0f : y.eps;
  if (!MECH) srm_rotation_advance(k, violated, c, s);
  return out;
}

// The random action of a step: the words of a continuous B6 bridge's three
// duties (SLOT_STEP's x and w, ACTION_C's x), finite min(int(3 u), 2) per
// phase, continuous 2 u - 1.
template <bool FINITE>
__device__ __forceinline__ SrmAction srm_random_action(uint2 key, uint32_t env, uint32_t t,
                                                       uint4 w) {
  const uint32_t words[3] = {w.x, w.w, drive_draw(key, env, t, DRIVE_SLOT_ACTION_C).x};
  SrmAction act;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    if (FINITE) {
      act.a[j] = min((int)(uniform24(words[j]) * 3.0f), 2);
      act.d[j] = 0.0f;
    } else {
      act.a[j] = 0;
      act.d[j] = 2.0f * uniform24(words[j]) - 1.0f;
    }
  }
  return act;
}

// One random-mode step: the action, srm_action_step at the carried rotation
// (constant speed), then (WIENER) the reference advance.
template <bool FINITE, bool MECH, int NREF, bool SAT, bool WIENER>
__device__ __forceinline__ SrmStepOut srm_random_step(const SrmConst& k, uint2 key, uint32_t env,
                                                      uint32_t t, SrmState& x, float& c,
                                                      float& s, RefRows<NREF>& refs) {
  const uint4 w = drive_draw(key, env, t, DRIVE_SLOT_STEP);
  const SrmAction act = srm_random_action<FINITE>(key, env, t, w);
  const SrmStepOut out = srm_action_step<FINITE, MECH, NREF, SAT>(k, act, x, c, s, refs);
  if (WIENER) ref_wiener_advance<NREF>(k.ref, key, env, t, w, out.done != 0.0f, refs);
  return out;
}

// The buffer step's action at step t: int32 or float32 (T, 3, N).
template <bool FINITE>
__device__ __forceinline__ SrmAction srm_read_action(const int* __restrict__ act_i,
                                                     const float* __restrict__ act_f, int n, int t,
                                                     int e) {
  SrmAction a;
  const size_t base = (size_t)t * 3 * n + e;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    a.a[j] = FINITE ? act_i[base + (size_t)j * n] : 0;
    a.d[j] = FINITE ? 0.0f : act_f[base + (size_t)j * n];
  }
  return a;
}

// The buffer step: (cos, sin) of the cycle-start angle afresh every step,
// also at constant speed; no references, no reset.
template <bool FINITE, bool MECH, bool SAT>
__device__ __forceinline__ void srm_buffer_step(const SrmConst& k, const SrmAction& act,
                                                SrmState& x) {
  float c = 1.0f, s = 0.0f;
  if (!MECH) {
    c = cosf(x.eps);
    s = sinf(x.eps);
  }
  srm_physics<FINITE, MECH, SAT>(k, act, c, s, x);
}

// ---- what the kernels of both sources share ------------------------------

// The planes of one state, (omega or NULL, i_a, i_b, i_c, eps), by value so
// that a kernel takes them as parameters.
struct SrmInPlanes {
  const float* p[5];
};

struct SrmPlanes {
  float* p[5];
};

template <bool MECH>
__device__ __forceinline__ SrmState srm_load_state(const SrmInPlanes& in, int e) {
  SrmState x;
  x.w = MECH ? in.p[0][e] : 0.0f;
  x.ia = in.p[1][e];
  x.ib = in.p[2][e];
  x.ic = in.p[3][e];
  x.eps = in.p[4][e];
  return x;
}

template <bool MECH>
__device__ __forceinline__ void srm_store_state(const SrmState& x, const SrmPlanes& o, size_t i) {
  if (MECH) o.p[0][i] = x.w;
  o.p[1][i] = x.ia;
  o.p[2][i] = x.ib;
  o.p[3][i] = x.ic;
  o.p[4][i] = x.eps;
}

inline SrmInPlanes srm_in_planes(const float* const* in) {
  SrmInPlanes planes;
  for (int j = 0; j < 5; ++j) planes.p[j] = in[j];
  return planes;
}

inline SrmPlanes srm_out_planes(float* const* out) {
  SrmPlanes planes;
  for (int j = 0; j < 5; ++j) planes.p[j] = out[j];
  return planes;
}

inline SrmConst srm_load_const(const float* host, const int* flags) {
  SrmConst k;
  for (int i = 0; i < N_SRM_CONST; ++i) k.v[i] = host[i];
  for (int r = 0; r < kSrmRows; ++r) {
    for (int j = 0; j < N_ROW_CONST; ++j) {
      k.ref.row[r][j] = host[N_SRM_CONST + r * N_ROW_CONST + j];
    }
  }
  k.ref.two_pi = host[S_TWO_PI];
  k.ref.ln10 = host[S_LN10];
  k.ref.u_min = host[S_U_MIN];
  for (int i = 0; i < N_SRM_FLAG; ++i) k.flag[i] = flags[i];
  k.ref.all_const = flags[SF_ALL_CONST];
  return k;
}

inline uint2 srm_seed_key(unsigned long long seed) {
  return make_uint2((uint32_t)(seed & 0xFFFFFFFFull), (uint32_t)(seed >> 32));
}

// Instance index of (FINITE, MECH, NREF, SAT), NREF 1 (TC, SC) or 3 (CC):
// 8 * sat + 4 * finite + 2 * mech + (nref == 3) for the random kernels,
// 4 * sat + 2 * finite + mech for the buffer kernels; -1 for flags no
// instance serves.
inline int srm_random_index(const int* f) {
  if (f[SF_NREF] != 1 && f[SF_NREF] != kSrmRows) return -1;
  return 8 * (f[SF_SAT] != 0) + 4 * (f[SF_FINITE] != 0) + 2 * (f[SF_MECH] != 0)
         + (f[SF_NREF] == kSrmRows);
}

inline int srm_buffer_index(const int* f) {
  return 4 * (f[SF_SAT] != 0) + 2 * (f[SF_FINITE] != 0) + (f[SF_MECH] != 0);
}
