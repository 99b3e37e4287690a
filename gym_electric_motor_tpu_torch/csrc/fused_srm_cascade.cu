// The SRM commutation cascade in the loop for Hopper (sm_90a): the six SRM
// ids under the commutation controller's CC, TC or SC task, on the finite
// or the continuous asymmetric bridge, linear or saturating, fused with the
// SRM family's physics, the references (Wiener or constant), the WSE
// reward, the limit constraint and the in-kernel reset, with a plain C
// interface for ctypes (the function returns cudaGetLastError()).
//
// Replaces (gym_electric_motor_tpu/ops/):
//   srm_cascade_rollout  pallas_srm.py  make_fused_srm_cascade_rollout (:622,
//                                       pallas_call :859)
//
// Design: one thread per env, the state, the carried rotation (constant
// speed), the reference rows and the integrator in registers across a
// `#pragma unroll 1` loop over T steps.  The control law is
// control_laws.cuh's srm_commutation_law; the step is srm_step.cuh's
// srm_action_step and the reference advance common_step.cuh's
// ref_wiener_advance, as in srm_rollout_random.  The commutation takes cos
// and sin of the state's angle under the speed ODE (SC) and the carried,
// renormalised rotation at constant speed (CC, TC); TC measures the
// coenergy torque at the pre-step angle afresh.  The integrator persists
// across env resets.  Templates: TASK (CC with three references at
// constant speed, TC with one at constant speed, SC with one under the
// speed ODE), FINITE, SAT and WIENER, the reference advance or constant
// references (24 instances).  Built with -fmad=false.
//
// What bounds it on this card: 4 or 5 planes in and 12 or 13 out per env,
// nothing inside the loop, so the operations of a step: the family's RK4
// with its 12 IEEE divisions (and cosf/sinf per stage under the speed ODE),
// the commutation's three sqrtf of an IEEE division (TC, SC), TC's torque
// at a fresh cosf/sinf pair, and with Wiener references Philox and the
// Box-Muller pairs.  tools/sass_ops.py counts the instructions a step
// always issues, per pipe, from the SASS.
#include <cuda_runtime.h>

#include "control_laws.cuh"
#include "srm_step.cuh"

namespace {

// in: (omega or NULL, i_a, i_b, i_c, eps); out: (omega or NULL, i_a, i_b,
// i_c, eps, reward, terms, rv, rk, rl, rs, integ), the reference planes
// (NREF R, 128).  WIENER: the reference advance (the catalog's Wiener
// references), else constant references.
template <int TASK, bool FINITE, bool SAT, bool WIENER>
__global__ void srm_cascade_rollout_kernel(SrmConst k, CtrlConst q, uint2 key, int n,
                                           int n_steps, ControlIn in, ControlOut out) {
  constexpr bool MECH = TASK == TASK_SC;
  constexpr int NREF = TASK == TASK_CC ? kSrmRows : 1;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  SrmInPlanes pin;
  SrmPlanes pout;
  for (int j = 0; j < 5; ++j) {
    pin.p[j] = in.p[j];
    pout.p[j] = out.p[j];
  }
  SrmState x = srm_load_state<MECH>(pin, e);
  float c = 1.0f, s = 0.0f;
  if (!MECH) {
    c = cosf(x.eps);
    s = sinf(x.eps);
  }
  RefRows<NREF> refs;
  ref_wiener_init<NREF>(k.ref, key, (uint32_t)e, refs);
  float integ = 0.0f, reward = 0.0f, terms = 0.0f;
#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) {
    float ce = c, se = s;
    if (MECH) {
      ce = cosf(x.eps);
      se = sinf(x.eps);
    }
    float t_meas_n = 0.0f;
    if (TASK == TASK_TC) {
      SrmPhase ph[3];
      srm_phases<SAT>(k, cosf(x.eps), sinf(x.eps), x.ia, x.ib, x.ic, ph);
      t_meas_n = srm_torque<SAT>(k, x.ia, x.ib, x.ic, ph) * k.ref.row[0][R_INV_LIM];
    }
    const float i3[3] = {x.ia, x.ib, x.ic};
    const float ref[3] = {refs.rv[0], refs.rv[NREF > 1 ? 1 : 0], refs.rv[NREF - 1]};
    SrmAction act;
    srm_commutation_law<TASK, FINITE>(q.v, x.w, i3, ref, t_meas_n, ce, se, integ, act.a, act.d);
    const SrmStepOut o = srm_action_step<FINITE, MECH, NREF, SAT>(k, act, x, c, s, refs);
    if (WIENER) {
      const uint4 w = drive_draw(key, (uint32_t)e, (uint32_t)t, DRIVE_SLOT_STEP);
      ref_wiener_advance<NREF>(k.ref, key, (uint32_t)e, (uint32_t)t, w, o.done != 0.0f, refs);
    }
    reward += o.reward;
    terms += o.done;
  }
  srm_store_state<MECH>(x, pout, (size_t)e);
  out.p[5][e] = reward;
  out.p[6][e] = terms;
#pragma unroll
  for (int r = 0; r < NREF; ++r) {
    out.p[7][(size_t)r * n + e] = refs.rv[r];
    out.p[8][(size_t)r * n + e] = refs.rk[r];
    out.p[9][(size_t)r * n + e] = refs.rl[r];
    out.p[10][(size_t)r * n + e] = refs.rs[r];
  }
  out.p[11][e] = integ;
}

template <int TASK, bool FINITE, bool SAT, bool WIENER>
void launch(const SrmConst& k, const CtrlConst& q, uint2 key, int n, int n_steps,
            const ControlIn& in, const ControlOut& out, cudaStream_t st) {
  control_launch(srm_cascade_rollout_kernel<TASK, FINITE, SAT, WIENER>, k, q, key, n, n_steps,
                 in, out, st);
}

#define SRM_CASCADE_PAIR(TASK, FINITE, SAT) \
  { launch<TASK, FINITE, SAT, false>, launch<TASK, FINITE, SAT, true> }

// indexed by [4 * task + 2 * finite + sat][wiener]
const ControlLaunchFn<SrmConst> kLaunch[12][2] = {
    SRM_CASCADE_PAIR(TASK_CC, false, false), SRM_CASCADE_PAIR(TASK_CC, false, true),
    SRM_CASCADE_PAIR(TASK_CC, true, false),  SRM_CASCADE_PAIR(TASK_CC, true, true),
    SRM_CASCADE_PAIR(TASK_TC, false, false), SRM_CASCADE_PAIR(TASK_TC, false, true),
    SRM_CASCADE_PAIR(TASK_TC, true, false),  SRM_CASCADE_PAIR(TASK_TC, true, true),
    SRM_CASCADE_PAIR(TASK_SC, false, false), SRM_CASCADE_PAIR(TASK_SC, false, true),
    SRM_CASCADE_PAIR(TASK_SC, true, false),  SRM_CASCADE_PAIR(TASK_SC, true, true)};

#undef SRM_CASCADE_PAIR

}  // namespace

extern "C" {

CONTROL_C_INFO(srm_cascade, N_SRM_CONST, N_ROW_CONST, N_SRM_FLAG, N_SRC_CTRL)

// consts: the SRM family's (srm_step.cuh); flags: the family's N_SRM_FLAG,
// then the task (SrmTask); ctrl: the controller's (SrmCascadeIndex).
// Returns cudaErrorInvalidValue where the flags leave the task's
// configuration: CC three references at constant speed, TC one at constant
// speed, SC one under the speed ODE.
int srm_cascade_rollout(const float* consts, const int* flags, const float* ctrl,
                        unsigned long long seed, int n, int n_steps, const float* const* in,
                        float* const* out, void* stream) {
  const int task = flags[N_SRM_FLAG];
  const bool ok = task >= TASK_CC && task <= TASK_SC &&
                  (flags[SF_MECH] != 0) == (task == TASK_SC) &&
                  flags[SF_NREF] == (task == TASK_CC ? kSrmRows : 1);
  const SrmConst k = srm_load_const(consts, flags);
  const ControlLaunchFn<SrmConst> fn =
      ok ? kLaunch[4 * task + 2 * (flags[SF_FINITE] != 0) + (flags[SF_SAT] != 0)]
                  [k.ref.all_const ? 0 : 1]
         : nullptr;
  return control_call(fn, k, ctrl, N_SRC_CTRL, seed, n, n_steps, in, 5, out, 12, stream);
}

}  // extern "C"
