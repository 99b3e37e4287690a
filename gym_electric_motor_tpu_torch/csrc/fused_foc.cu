// The FOC closed loop for Hopper (sm_90a): Cont-CC-PMSM under the tuned PI
// current controller, fused with the PMSM physics, the two Wiener (or
// constant) current references, the WSE reward, the squared current
// constraint and the in-kernel reset, with a plain C interface for ctypes
// (the function returns cudaGetLastError()).
//
// Replaces (gym_electric_motor_tpu/ops/):
//   foc_rollout  pallas_sync.py  make_fused_foc_rollout (:1124, pallas_call :1339)
//
// Design: one thread per env, the drive state, the rotation, both
// references and the two integrators in registers across a `#pragma unroll
// 1` loop over T steps.  The control cycle is control_laws.cuh's foc_cycle;
// the physics, the rotation, the reward, the reset and the Wiener process
// are pmsm_step.cuh's (pmsm_voltage_step, wiener_init, wiener_advance_pair),
// so the references are, draw for draw, those of pmsm_rollout_random on the
// same seed (pallas_sync.py:1253-1263, :1299-1315).  An env reset zeroes
// i_sd, i_sq and eps and sets the rotation to (1, 0); the integrators
// persist, as control_environment carries the controller state.  Templates:
// WIENER (2 instances).  Built with -fmad=false (ops/cuda_build.py), so
// each multiply and add rounds as in the plain PyTorch version.
//
// What bounds it on this card: the kernel moves 5 planes in and 13 out per
// env, nothing inside the loop, so the operations of a step bound it: the
// controller's 30-odd FP32 operations and three clips, the RK4 on the dq
// currents, the rotation's rsqrt and, in Wiener mode, Philox and the
// Box-Muller pair's non-fast-math logf, cosf and sinf.  tools/sass_ops.py
// counts the instructions a step always issues, per pipe, from the SASS.
#include <cuda_runtime.h>

#include "control_laws.cuh"
#include "pmsm_step.cuh"

namespace {

template <bool WIENER>
__global__ void foc_rollout_kernel(PmsmConst k, CtrlConst q, uint2 key, int n, int n_steps,
                                   ControlIn in, ControlOut out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  PmsmEnv st;
  st.i_sd = in.p[0][e];
  st.i_sq = in.p[1][e];
  st.eps = in.p[2][e];
  st.c = cosf(st.eps);
  st.s = sinf(st.eps);
  if (WIENER) {
    wiener_init(k, key, (uint32_t)e, st);
  } else {
    st.rv_d = in.p[3][e];
    st.rv_q = in.p[4][e];
    st.rk_d = st.rk_q = 0.0f;
    st.rl_d = st.rl_q = 1e9f;
    st.rs_d = st.rs_q = 0.0f;
  }
  float integ_d = 0.0f, integ_q = 0.0f, reward = 0.0f, terms = 0.0f;
#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) {
    float ua, ub, uc;
    foc_cycle(q.v, st.i_sd, st.i_sq, st.c, st.s, st.rv_d, st.rv_q, integ_d, integ_q, ua, ub, uc);
    const PmsmStepOut o = pmsm_voltage_step(k, ua, ub, uc, st);
    if (WIENER) {
      const uint4 w = pmsm_draw(key, (uint32_t)e, (uint32_t)t, SLOT_STEP);
      wiener_advance_pair(k, key, (uint32_t)e, (uint32_t)t, w, o.done != 0.0f, st);
    }
    reward += o.reward;
    terms += o.done;
  }
  out.p[0][e] = st.i_sd;
  out.p[1][e] = st.i_sq;
  out.p[2][e] = st.eps;
  out.p[3][e] = reward;
  out.p[4][e] = terms;
  // the reference rows, (2R, 128) planes: d rows first, then q rows
  out.p[5][e] = st.rv_d;
  out.p[5][n + e] = st.rv_q;
  out.p[6][e] = st.rk_d;
  out.p[6][n + e] = st.rk_q;
  out.p[7][e] = st.rl_d;
  out.p[7][n + e] = st.rl_q;
  out.p[8][e] = st.rs_d;
  out.p[8][n + e] = st.rs_q;
}

template <bool WIENER>
void launch(const PmsmConst& k, const CtrlConst& q, uint2 key, int n, int n_steps,
            const ControlIn& in, const ControlOut& out, cudaStream_t st) {
  control_launch(foc_rollout_kernel<WIENER>, k, q, key, n, n_steps, in, out, st);
}

}  // namespace

extern "C" {

CONTROL_C_INFO(foc, N_PMSM_CONST, 0, 1, N_FOC_CTRL)

// consts: the PMSM constants (PmsmConstIndex); flags: (wiener); ctrl: the
// controller's (FocIndex).  in: (i_sd, i_sq, eps, ref_d, ref_q), the
// reference planes read in const mode only; out: (i_sd, i_sq, eps, reward,
// terms, rv, rk, rl, rs), the last four (2R, 128).
int foc_rollout(const float* consts, const int* flags, const float* ctrl,
                unsigned long long seed, int n, int n_steps, const float* const* in,
                float* const* out, void* stream) {
  PmsmConst k;
  for (int i = 0; i < N_PMSM_CONST; ++i) k.v[i] = consts[i];
  const ControlLaunchFn<PmsmConst> fn = flags[0] ? &launch<true> : &launch<false>;
  return control_call(fn, k, ctrl, N_FOC_CTRL, seed, n, n_steps, in, 5, out, 9, stream);
}

}  // extern "C"
