// The DC speed cascade in the loop for Hopper (sm_90a): Cont-SC-{PermExDc,
// SeriesDc, ShuntDc} under the tuned three-stage cascade, fused with the DC
// family's physics under the polynomial load, the omega reference (Wiener
// or constant), the WSE reward, the limit constraint and the in-kernel
// reset to zero, with a plain C interface for ctypes (the function returns
// cudaGetLastError()).
//
// Replaces (gym_electric_motor_tpu/ops/):
//   dc_cascade_rollout  pallas_dc.py  make_fused_dc_cascade_rollout (:1276,
//                                     pallas_call :1455)
//
// Design: one thread per env, the state (omega, the currents), the
// reference row and the speed and current integrators in registers across
// a `#pragma unroll 1` loop over T steps.  The cascade is control_laws.cuh's
// dc_cascade_law; the step (the continuous 4QC's duty clip, RK4 over the
// speed and the currents, the constraint, the reward, the reset to zero)
// is dc_step.cuh's dc_action_step, and the reference advance
// common_step.cuh's ref_wiener_advance, as in dc_rollout_random.  The
// integrators persist across env resets, as control_environment carries
// the controller state.  Templates: OPS (PermExDc, SeriesDc, ShuntDc) and
// WIENER, the reference advance or constant references (6 instances).
// Built with -fmad=false, so each multiply and add rounds as in the plain
// PyTorch version.
//
// What bounds it on this card: 2 or 3 planes in and 10 or 11 out per env,
// nothing inside the loop, so the operations of a step: the cascade's two
// PI stages, the operating point (a division and the guards for ShuntDc, a
// sqrtf for SeriesDc), the RK4 over the speed and the currents with the
// load's torque, and with a Wiener reference Philox and the Box-Muller
// pair of every second step.  tools/sass_ops.py counts the instructions a
// step always issues, per pipe, from the SASS.
#include <cuda_runtime.h>

#include "control_laws.cuh"
#include "dc_step.cuh"

namespace {

// in: (omega, i0, i1 or NULL); out: (omega, i0, i1 or NULL, reward, terms,
// rv, rk, rl, rs, sc_int, cc_int).  WIENER: the reference advance (the
// catalog's Wiener reference), else constant references.
template <int OPS, bool WIENER>
__global__ void dc_cascade_rollout_kernel(DcConst k, CtrlConst q, uint2 key, int n, int n_steps,
                                          ControlIn in, ControlOut out) {
  constexpr int MC = OPS == OPS_SHUNT ? MC_SHUNT : MC_ONE;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  DcState x = dc_load_state<true, MC>(in.p[0], in.p[1], in.p[2], e);
  RefRows<1> refs;
  ref_wiener_init<1>(k.ref, key, (uint32_t)e, refs);
  float sc_int = 0.0f, cc_int = 0.0f, reward = 0.0f, terms = 0.0f;
#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) {
    DcAction act;
    act.a0 = act.a1 = 0;
    act.f1 = 0.0f;
    act.f0 = dc_cascade_law<OPS>(q.v, x.w, x.i0, MC == MC_SHUNT ? x.i1 : x.i0, x.i1,
                                 refs.rv[0], sc_int, cc_int);
    const DcStepOut o = dc_action_step<false, true, MC, 1>(k, act, x, refs);
    if (WIENER) {
      const uint4 w = drive_draw(key, (uint32_t)e, (uint32_t)t, DRIVE_SLOT_STEP);
      ref_wiener_advance<1>(k.ref, key, (uint32_t)e, (uint32_t)t, w, o.done != 0.0f, refs);
    }
    reward += o.reward;
    terms += o.done;
  }
  dc_store_state<true, MC>(x, out.p[0], out.p[1], out.p[2], (size_t)e);
  out.p[3][e] = reward;
  out.p[4][e] = terms;
  out.p[5][e] = refs.rv[0];
  out.p[6][e] = refs.rk[0];
  out.p[7][e] = refs.rl[0];
  out.p[8][e] = refs.rs[0];
  out.p[9][e] = sc_int;
  out.p[10][e] = cc_int;
}

template <int OPS, bool WIENER>
void launch(const DcConst& k, const CtrlConst& q, uint2 key, int n, int n_steps,
            const ControlIn& in, const ControlOut& out, cudaStream_t st) {
  control_launch(dc_cascade_rollout_kernel<OPS, WIENER>, k, q, key, n, n_steps, in, out, st);
}

// indexed by [ops][wiener]
const ControlLaunchFn<DcConst> kLaunch[3][2] = {
    {launch<OPS_PERMEX, false>, launch<OPS_PERMEX, true>},
    {launch<OPS_SERIES, false>, launch<OPS_SERIES, true>},
    {launch<OPS_SHUNT, false>, launch<OPS_SHUNT, true>}};

}  // namespace

extern "C" {

CONTROL_C_INFO(dc_cascade, N_DC_CONST, N_ROW_CONST, N_DC_FLAG, N_DCC_CTRL)

// consts and flags: the DC family's (dc_step.cuh); ctrl: the cascade's
// (DcCascadeIndex), its operating point given by the motor class and the
// SeriesDc flag.  Returns cudaErrorInvalidValue for flags outside the
// cascade's configuration (continuous, one channel, the speed ODE, one
// reference row on omega).
int dc_cascade_rollout(const float* consts, const int* flags, const float* ctrl,
                       unsigned long long seed, int n, int n_steps, const float* const* in,
                       float* const* out, void* stream) {
  const bool ok = !flags[DF_FINITE] && flags[DF_MECH] && flags[DF_NREF] == 1 &&
                  flags[DF_QTY0] == DQ_OMEGA &&
                  (flags[DF_MCLASS] == MC_ONE || flags[DF_MCLASS] == MC_SHUNT);
  const int ops = flags[DF_MCLASS] == MC_SHUNT ? OPS_SHUNT
                                               : (flags[DF_SERIES] ? OPS_SERIES : OPS_PERMEX);
  const DcConst k = dc_load_const(consts, flags);
  return control_call(ok ? kLaunch[ops][k.ref.all_const ? 0 : 1] : nullptr, k, ctrl,
                      N_DCC_CTRL, seed, n, n_steps, in, 3, out, 11, stream);
}

}  // extern "C"
