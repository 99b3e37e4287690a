// The classical control laws of the controller-in-the-loop kernels, and the
// launch and C interface the three kernels share:
//
//   foc_cycle            the PI current controller of Cont-CC-PMSM with the
//                        EMF decoupling, the squared voltage clip's
//                        anti-windup, the advance-angle dq -> abc transform
//                        and the continuous output stage (fused_foc.cu);
//   dc_cascade_law       the DC speed cascade: PI speed control, torque clip,
//                        the analytic operating point, current clip, PI
//                        current control with the EMF feedforward, voltage
//                        clip (fused_dc_cascade.cu);
//   srm_commutation_law  the SRM commutation controller's CC, TC and SC
//                        tasks with single-pulse commutation and per-phase
//                        regulation (fused_srm_cascade.cu).
//
// Replaces the control closures of make_fused_foc_rollout
// (gym_electric_motor_tpu/ops/pallas_sync.py:1186-1221),
// make_fused_dc_cascade_rollout (ops/pallas_dc.py:1355-1384) and
// make_fused_srm_cascade_rollout (ops/pallas_srm.py:703-758).  The plain
// PyTorch versions of the same arithmetic, in the same order, are foc_cycle
// (gym_electric_motor_tpu_torch/ops/fused_sync.py), dc_cascade_law
// (ops/fused_dc_family.py) and srm_cascade_law (ops/fused_srm_family.py).
//
// The laws are plain float functions: they read the tuned controller's
// constants (q, float32 from the host in the order of the enums below) and
// the drive's quantities, and know nothing of a family's state layout.  The
// clips are fminf(fmaxf(x, lo), hi), which return their input bit for bit
// inside the limits, so the anti-windup's exact equality tests (t_ref ==
// t_c, u == u_c, t_raw == t_ref) hold as in the JAX kernels.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

// ---- FOC (Cont-CC-PMSM) -----------------------------------------------------

enum FocIndex {
  FOC_CC_P_D = 0,     // PI gains of the d and q current loops
  FOC_CC_P_Q,
  FOC_CC_I_D,
  FOC_CC_I_Q,
  FOC_INV_CLIP_D,     // float32 reciprocals of the squared clip's limits
  FOC_INV_CLIP_Q,
  FOC_L_EMF_D,        // EMF feedforward (l_emf i + psi_emf) omega_el, the d
  FOC_L_EMF_Q,        //   voltage on i_sq and the q voltage on i_sd
  FOC_PSI_EMF_D,
  FOC_PSI_EMF_Q,
  FOC_OMEGA_EL,       // p * omega
  FOC_REF_LIM_D,      // the references' limits (denormalisation)
  FOC_REF_LIM_Q,
  FOC_INV_OUT,        // 1 / the output stage's voltage limit
  FOC_U_HALF,         // u_sup / 2, the continuous bridge's phase gain
  FOC_COS_A,          // cos / sin of the constant advance angle
  FOC_SIN_A,          //   advance_factor * tau * omega (mechanical omega)
  FOC_HALF_SQRT3,     // sqrt(3) / 2 of the inverse Clarke transform
  FOC_TAU,
  N_FOC_CTRL
};

// One control cycle: PI control of the dq currents toward the denormalised
// references, the EMF decoupling, the squared clip's anti-windup on the
// integrators, the *unclipped* voltage turned into abc at the cycle-start
// rotation (ce, se) advanced by the constant angle, and the output stage's
// and converter's clip to +-1 times u_sup / 2.
__device__ __forceinline__ void foc_cycle(const float* q, float i_sd, float i_sq, float ce,
                                          float se, float ref_d, float ref_q, float& integ_d,
                                          float& integ_q, float& ua, float& ub, float& uc) {
  const float err_d = ref_d * q[FOC_REF_LIM_D] - i_sd;
  const float err_q = ref_q * q[FOC_REF_LIM_Q] - i_sq;
  float u_d = q[FOC_CC_P_D] * err_d + q[FOC_CC_I_D] * integ_d;
  float u_q = q[FOC_CC_P_Q] * err_q + q[FOC_CC_I_Q] * integ_q;
  u_d = u_d + (q[FOC_L_EMF_D] * i_sq + q[FOC_PSI_EMF_D]) * q[FOC_OMEGA_EL];
  u_q = u_q + (q[FOC_L_EMF_Q] * i_sd + q[FOC_PSI_EMF_Q]) * q[FOC_OMEGA_EL];
  const float rel_d = u_d * q[FOC_INV_CLIP_D];
  const float rel_q = u_q * q[FOC_INV_CLIP_Q];
  const float not_clipped = (rel_d * rel_d + rel_q * rel_q) < 1.0f ? 1.0f : 0.0f;
  integ_d = integ_d + q[FOC_TAU] * err_d * not_clipped;
  integ_q = integ_q + q[FOC_TAU] * err_q * not_clipped;
  const float c = ce * q[FOC_COS_A] - se * q[FOC_SIN_A];
  const float s = se * q[FOC_COS_A] + ce * q[FOC_SIN_A];
  const float u_al = c * u_d - s * u_q;
  const float u_be = s * u_d + c * u_q;
  const float u_b = -0.5f * u_al + q[FOC_HALF_SQRT3] * u_be;
  const float u_c = -0.5f * u_al - q[FOC_HALF_SQRT3] * u_be;
  ua = fminf(fmaxf(u_al * q[FOC_INV_OUT], -1.0f), 1.0f) * q[FOC_U_HALF];
  ub = fminf(fmaxf(u_b * q[FOC_INV_OUT], -1.0f), 1.0f) * q[FOC_U_HALF];
  uc = fminf(fmaxf(u_c * q[FOC_INV_OUT], -1.0f), 1.0f) * q[FOC_U_HALF];
}

// ---- DC speed cascade (Cont-SC-{PermExDc, SeriesDc, ShuntDc}) ---------------

enum DcCascadeIndex {
  DCC_SC_P = 0,       // speed PI gains
  DCC_SC_I,
  DCC_SC_LO,          // torque clip
  DCC_SC_HI,
  DCC_TC_LO,          // current clip (the lowest low and highest high row)
  DCC_TC_HI,
  DCC_CC_P,           // current PI gains
  DCC_CC_I,
  DCC_CC_LO,          // voltage clip
  DCC_CC_HI,
  DCC_INV_OUT,        // 1 / the output stage's voltage limit
  DCC_REF_LIM,        // omega's limit (denormalisation)
  DCC_L_EMF,          // EMF feedforward (l_emf i_emf + psi_emf) omega p
  DCC_PSI_EMF,
  DCC_P_FF,
  DCC_TAU,
  DCC_INV_PSI,        // PermExDc: 1 / psi_e
  DCC_INV_LP,         // SeriesDc, ShuntDc: 1 / l_e'
  DCC_IE_LIMIT,       // ShuntDc: the i_e limit beyond which i_a* is pinned
  DCC_IA_LIMIT,       //   to -+ the i_a limit
  N_DCC_CTRL
};

// The analytic operating-point selections.
enum DcOps { OPS_PERMEX = 0, OPS_SERIES, OPS_SHUNT };

__device__ __forceinline__ float sign_of(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

// One cycle of the speed cascade for the speed w, the controlled current i
// (i or i_a), the EMF current i_emf (i or i_e), the field current i_e
// (ShuntDc) and the normalised reference: returns the *unclipped*
// normalised voltage (the converter clips the duty) and advances the two
// integrators, each only while its clip passes the command unchanged.
template <int OPS>
__device__ __forceinline__ float dc_cascade_law(const float* q, float w, float i, float i_emf,
                                                float i_e, float ref_n, float& sc_int,
                                                float& cc_int) {
  const float err = ref_n * q[DCC_REF_LIM] - w;
  const float t_ref = q[DCC_SC_P] * err + q[DCC_SC_I] * sc_int;
  const float t_c = fminf(fmaxf(t_ref, q[DCC_SC_LO]), q[DCC_SC_HI]);
  sc_int = sc_int + q[DCC_TAU] * err * (t_ref == t_c ? 1.0f : 0.0f);
  float i_ref;
  if (OPS == OPS_PERMEX) {
    i_ref = t_c * q[DCC_INV_PSI];
  } else if (OPS == OPS_SERIES) {
    i_ref = sqrtf(fmaxf(t_c, 0.0f) * q[DCC_INV_LP]);
  } else {
    const float guard = sign_of(i_e) * 1e-4f + (i_e == 0.0f ? 1.0f : 0.0f) * 1e-4f;
    const float i_e_safe = fabsf(i_e) < 1e-4f ? guard : i_e;
    i_ref = t_c * q[DCC_INV_LP] / i_e_safe;
    i_ref = i_e > q[DCC_IE_LIMIT] ? -q[DCC_IA_LIMIT] : i_ref;
    i_ref = i_e < -q[DCC_IE_LIMIT] ? q[DCC_IA_LIMIT] : i_ref;
  }
  i_ref = fminf(fmaxf(i_ref, q[DCC_TC_LO]), q[DCC_TC_HI]);
  const float err_i = i_ref - i;
  float u = q[DCC_CC_P] * err_i + q[DCC_CC_I] * cc_int;
  u = u + (q[DCC_L_EMF] * i_emf + q[DCC_PSI_EMF]) * (w * q[DCC_P_FF]);
  const float u_c = fminf(fmaxf(u, q[DCC_CC_LO]), q[DCC_CC_HI]);
  cc_int = cc_int + q[DCC_TAU] * err_i * (u == u_c ? 1.0f : 0.0f);
  return u * q[DCC_INV_OUT];
}

// ---- SRM commutation (the six SRM ids) --------------------------------------

enum SrmCascadeIndex {
  SRC_KP_W = 0,       // speed PI (SC)
  SRC_KI_W,
  SRC_T_MAX,          // torque command clip, +-0.9 T_lim
  SRC_NEG_T_MAX,
  SRC_W_LIM,
  SRC_INV_W_LIM,
  SRC_INV_I_LIM,
  SRC_T_LIM,
  SRC_KI_T,           // torque trim (TC), clipped to [trim_lo, trim_hi]
  SRC_TAU_C,
  SRC_TRIM_LO,
  SRC_TRIM_HI,
  SRC_PL1,            // p * l1, the sqrt linearization's slope amplitude
  SRC_THETA_ON,       // the least usable slope of a firing phase
  SRC_HYST,           // finite: the hysteresis band (normalised)
  SRC_KP_I,           // continuous: duty P gain and resistive feed-forward
  SRC_FF_I,
  SRC_I_MAX,          // setpoint ceiling (1 - margin) i_lim
  SRC_CPH0,           // cos and sin of the phase offsets 0, 2 pi / 3, 4 pi / 3
  SRC_CPH1,
  SRC_CPH2,
  SRC_SPH0,
  SRC_SPH1,
  SRC_SPH2,
  SRC_S_MIN,          // 0.05: the slope floor under the sqrt
  SRC_I_STAR_MIN,     // 1e-6: a setpoint above it holds a phase in the band
  N_SRC_CTRL
};

// The controller's tasks.
enum SrmTask { TASK_CC = 0, TASK_TC, TASK_SC };

// Per-phase regulation toward the normalised setpoints: finite, 1
// (magnetise) below the band, 2 (demagnetise) above it and inside it 0
// while a setpoint exists, 2 otherwise; continuous, P plus the resistive
// feed-forward duty, clipped to +-1.
template <bool FINITE>
__device__ __forceinline__ void srm_regulate(const float* q, const float (&i3)[3],
                                             const float (&i_star)[3], int (&a)[3],
                                             float (&d)[3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float i_n = i3[k] * q[SRC_INV_I_LIM];
    if (FINITE) {
      const bool mag = i_n < i_star[k] - q[SRC_HYST];
      const bool dem = i_n > i_star[k] + q[SRC_HYST];
      const int hold = i_star[k] > q[SRC_I_STAR_MIN] ? 0 : 2;
      a[k] = mag ? 1 : (dem ? 2 : hold);
      d[k] = 0.0f;
    } else {
      a[k] = 0;
      d[k] = fminf(fmaxf(q[SRC_KP_I] * (i_star[k] - i_n) + q[SRC_FF_I] * i_star[k], -1.0f),
                   1.0f);
    }
  }
}

// Single-pulse commutation with the sqrt linearization: the normalised
// setpoints for the torque t_ref at the cycle-start (cos, sin) of the angle.
// A phase fires where its slope times the torque's sign exceeds theta_on
// and is the largest (a tie fires two); sign(0) is 0, so no phase fires at
// zero torque.  The sqrt's argument is an IEEE division.
__device__ __forceinline__ void srm_commutate(const float* q, float t_ref, float ce, float se,
                                              float (&i_star)[3]) {
  const float sign = sign_of(t_ref);
  const float s_k[3] = {se * q[SRC_CPH0] - ce * q[SRC_SPH0], se * q[SRC_CPH1] - ce * q[SRC_SPH1],
                        se * q[SRC_CPH2] - ce * q[SRC_SPH2]};
  const float gain[3] = {s_k[0] * sign, s_k[1] * sign, s_k[2] * sign};
  const float gmax = fmaxf(gain[0], fmaxf(gain[1], gain[2]));
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const bool fire = gain[k] > q[SRC_THETA_ON] && gain[k] >= gmax;
    const float i_cmd =
        sqrtf(2.0f * fabsf(t_ref) / (q[SRC_PL1] * fmaxf(fabsf(s_k[k]), q[SRC_S_MIN])));
    i_star[k] = (fire ? fminf(i_cmd, q[SRC_I_MAX]) : 0.0f) * q[SRC_INV_I_LIM];
  }
}

// One cycle of the commutation controller: CC regulates toward the three
// references ref[0..2]; TC trims the torque command t* = ref[0] T_lim by
// the integral of its error against the measured torque t_meas_n (over
// its limit), clipped; SC runs the anti-windup PI speed loop on the speed w
// (integrating only while the torque clip passes the command unchanged).
// TC and SC then commutate at (ce, se).  integ is the carried integrator.
template <int TASK, bool FINITE>
__device__ __forceinline__ void srm_commutation_law(const float* q, float w,
                                                    const float (&i3)[3], const float (&ref)[3],
                                                    float t_meas_n, float ce, float se,
                                                    float& integ, int (&a)[3], float (&d)[3]) {
  if (TASK == TASK_CC) {
    srm_regulate<FINITE>(q, i3, ref, a, d);
    return;
  }
  float t_ref;
  if (TASK == TASK_TC) {
    const float t_star = ref[0] * q[SRC_T_LIM];
    const float t_meas = t_meas_n * q[SRC_T_LIM];
    integ = fminf(fmaxf(integ + q[SRC_KI_T] * (t_star - t_meas) * q[SRC_TAU_C], q[SRC_TRIM_LO]),
                  q[SRC_TRIM_HI]);
    t_ref = t_star + integ;
  } else {
    const float w_err = (ref[0] - w * q[SRC_INV_W_LIM]) * q[SRC_W_LIM];
    const float t_raw = q[SRC_KP_W] * w_err + integ;
    t_ref = fminf(fmaxf(t_raw, q[SRC_NEG_T_MAX]), q[SRC_T_MAX]);
    integ = integ + (t_raw == t_ref ? q[SRC_KI_W] * w_err * q[SRC_TAU_C] : 0.0f);
  }
  float i_star[3];
  srm_commutate(q, t_ref, ce, se, i_star);
  srm_regulate<FINITE>(q, i3, i_star, a, d);
}

// ---- The launch and the C interface the three kernels share -----------------

constexpr int kControlThreads = 128;
constexpr int kControlMaxCtrl = 32;   // controller constants a kernel takes
constexpr int kControlMaxIn = 6;      // input planes
constexpr int kControlMaxOut = 16;    // output planes

// The tuned controller's constants and the planes, by value so that a
// kernel takes each as one parameter.
struct CtrlConst {
  float v[kControlMaxCtrl];
};

struct ControlIn {
  const float* p[kControlMaxIn];
};

struct ControlOut {
  float* p[kControlMaxOut];
};

// A kernel's host launcher of one instance, as its instance table holds
// them.
template <typename Const>
using ControlLaunchFn = void (*)(const Const&, const CtrlConst&, uint2, int, int,
                                 const ControlIn&, const ControlOut&, cudaStream_t);

// Launch a controller-in-the-loop kernel, one thread per env.
template <typename Const>
void control_launch(void (*kernel)(Const, CtrlConst, uint2, int, int, ControlIn, ControlOut),
                    const Const& k, const CtrlConst& q, uint2 key, int n, int n_steps,
                    const ControlIn& in, const ControlOut& out, cudaStream_t st) {
  kernel<<<(n + kControlThreads - 1) / kControlThreads, kControlThreads, 0, st>>>(
      k, q, key, n, n_steps, in, out);
}

// The body of every <kernel>_rollout: copy the controller's n_ctrl
// constants and the pointer arrays (NULL past n_in and n_out; a NULL entry
// inside them is an absent plane), run the picked launcher and return
// cudaGetLastError(), or cudaErrorInvalidValue where no instance serves the
// flags (fn nullptr).
template <typename Const>
int control_call(ControlLaunchFn<Const> fn, const Const& k, const float* ctrl, int n_ctrl,
                 unsigned long long seed, int n, int n_steps, const float* const* in, int n_in,
                 float* const* out, int n_out, void* stream) {
  if (fn == nullptr || n_ctrl > kControlMaxCtrl || n_in > kControlMaxIn ||
      n_out > kControlMaxOut) {
    return (int)cudaErrorInvalidValue;
  }
  CtrlConst q;
  for (int i = 0; i < kControlMaxCtrl; ++i) q.v[i] = i < n_ctrl ? ctrl[i] : 0.0f;
  ControlIn pin;
  for (int i = 0; i < kControlMaxIn; ++i) pin.p[i] = i < n_in ? in[i] : nullptr;
  ControlOut pout;
  for (int i = 0; i < kControlMaxOut; ++i) pout.p[i] = i < n_out ? out[i] : nullptr;
  const uint2 key = make_uint2((uint32_t)(seed & 0xFFFFFFFFull), (uint32_t)(seed >> 32));
  fn(k, q, key, n, n_steps, pin, pout, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// A controller-in-the-loop library's size queries and error string, for
// ctypes: the family's constants, reference-row constants and flags, and
// the controller's constants.
#define CONTROL_C_INFO(PREFIX, N_CONST, N_ROW, N_FLAG, N_CTRL)                   \
  int PREFIX##_n_const() { return N_CONST; }                                     \
  int PREFIX##_n_row_const() { return N_ROW; }                                   \
  int PREFIX##_n_flag() { return N_FLAG; }                                       \
  int PREFIX##_n_ctrl() { return N_CTRL; }                                       \
  const char* PREFIX##_error_string(int err) {                                   \
    return cudaGetErrorString((cudaError_t)err);                                 \
  }
