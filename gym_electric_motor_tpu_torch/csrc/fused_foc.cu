// The FOC closed loop for Hopper (sm_90a): Cont-CC-PMSM under the tuned PI
// current controller, fused with the PMSM physics, the two Wiener (or
// constant) current references, the WSE reward, the squared current
// constraint and the in-kernel reset, with a plain C interface for ctypes
// (the function returns cudaGetLastError()).
//
// Replaces (gym_electric_motor_tpu/ops/):
//   foc_rollout  pallas_sync.py  make_fused_foc_rollout (:1124, pallas_call :1339)
//
// Design: with Wiener references (the catalog's) the loop is
// warp-specialised on the shared-memory ring of ring_pipe.cuh: producer
// warps draw, in a double-buffered ring of K steps a slot, what a step of
// the references draws whatever the state (pmsm_ring.cuh's pmsm_draws
// without the action uniform: both normal draws of the step's Box-Muller
// pair, each reference's candidate length and sigma and its candidate
// reset value, 8 words); consumer warps run the step, one thread per env,
// the drive state, the rotation, both references and the two integrators
// in registers, and take the candidates by selects
// (pmsm_advance_candidates).  The Philox calls, the pair's non-fast-math
// logf, sqrtf, cosf and sinf and the redraws of the PARAMS and RESET slots
// leave the chain the PI controller and the RK4 wait on.  With constant
// references nothing is drawn and the launch runs one thread per env, the
// same state in registers across a `#pragma unroll 1` loop over T steps;
// the one-thread Wiener instance is built for tools/sass_ops.py's count of
// the function's own work and never launched.  The control cycle is
// control_laws.cuh's foc_cycle; the physics, the rotation, the reward, the
// reset and the one-thread Wiener process are pmsm_step.cuh's
// (pmsm_voltage_step, wiener_init, wiener_advance_pair), so the references
// are, draw for draw, those of pmsm_rollout_random on the same seed
// (pallas_sync.py:1253-1263, :1299-1315).  Both the controller and the
// reward take the pre-step references.  An env reset zeroes i_sd, i_sq and
// eps and sets the rotation to (1, 0); the integrators persist, as
// control_environment carries the controller state.  Templates: WIENER
// (2 instances, and 1 on the ring).  Built with -fmad=false
// (ops/cuda_build.py), so each multiply and add rounds as in the plain
// PyTorch version; the producers compute each candidate with the
// one-thread kernel's functions on the same operands, and a Philox counter
// is (env, step, slot), so the two designs and the plain version are equal
// bit for bit.
//
// What bounds it on this card: the kernel moves 5 planes in and 13 out per
// env, nothing inside the loop, so the operations of a step bound it: the
// controller's 30-odd FP32 operations and three clips, the RK4 on the dq
// currents, the rotation's rsqrt and, in Wiener mode, Philox and the
// Box-Muller pair's non-fast-math logf, cosf and sinf.  tools/sass_ops.py
// counts the instructions a step always issues, per pipe, from the SASS:
// the one-thread Wiener step for the bound of the function's own work,
// and beside it what the ring issues per env-step, the consumer's step and
// the producers' draws (the PARAMS and RESET slots at every step) over the
// K / P steps of a producer iteration, with the shared-memory accesses and
// barriers.
#include <cuda_runtime.h>

#include "control_laws.cuh"
#include "pmsm_ring.cuh"

namespace {

// One closed-loop step: the controller's phase voltages from the pre-step
// state and references, then pmsm_voltage_step (the reward against the
// same references).
__device__ __forceinline__ PmsmStepOut foc_step(const PmsmConst& k, const CtrlConst& q,
                                                PmsmEnv& st, float& integ_d, float& integ_q) {
  float ua, ub, uc;
  foc_cycle(q.v, st.i_sd, st.i_sq, st.c, st.s, st.rv_d, st.rv_q, integ_d, integ_q, ua, ub, uc);
  return pmsm_voltage_step(k, ua, ub, uc, st);
}

// out: (i_sd, i_sq, eps, reward, terms, rv, rk, rl, rs) of env e, the last
// four (2R, 128) planes: d rows first, then q rows.
__device__ __forceinline__ void foc_store(const ControlOut& out, int n, int e, const PmsmEnv& st,
                                          float reward, float terms) {
  out.p[0][e] = st.i_sd;
  out.p[1][e] = st.i_sq;
  out.p[2][e] = st.eps;
  out.p[3][e] = reward;
  out.p[4][e] = terms;
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
    const PmsmStepOut o = foc_step(k, q, st, integ_d, integ_q);
    if (WIENER) {
      const uint4 w = pmsm_draw(key, (uint32_t)e, (uint32_t)t, SLOT_STEP);
      wiener_advance_pair(k, key, (uint32_t)e, (uint32_t)t, w, o.done != 0.0f, st);
    }
    reward += o.reward;
    terms += o.done;
  }
  foc_store(out, n, e, st, reward, terms);
}

// ---- the warp-specialised loop (Wiener references) -----------------------

// The ring: 8 steps a slot, 2 producer warps per consumer warp, each
// drawing 4 steps of a slot (the fastest of K in {4, 8} x P in {1, 2};
// parent one-thread kernel over ring on Cont-CC-PMSM at 16384 x 65536:
// K = 4 with one producer warp 0.846, with two 1.227; K = 8 with one 0.808,
// with two 1.249; PERF.md, slice 18).  At 8 words a step it holds 64 KB,
// above the default 48 KB of dynamic shared memory.
using FocRing = RingShape<8, 2>;
constexpr int kFocWords = pmsm_ring_words<false>();

// Producer warps run pmsm_draws without the action uniform (8 words a
// step); consumer warps foc_step and pmsm_advance_candidates, one thread
// per env.
__global__ void __launch_bounds__(FocRing::kThreads)
    foc_rollout_ws_kernel(PmsmConst k, CtrlConst q, uint2 key, int n, int n_steps, ControlIn in,
                          ControlOut out) {
  extern __shared__ uint32_t ring[];
  const RingThread th = ring_thread(n);
  const uint32_t env = (uint32_t)th.e;
  const RingPipe<FocRing> pipe(n_steps);
  const RingView<kFocWords> v{ring + th.le};
  if (!th.consumer) {
    ring_produce(pipe, v, th.part, [&](uint32_t t, bool, float&) {
      return pmsm_draws_pack<false>(pmsm_draws(k, key, env, t));
    });
    return;
  }
  PmsmEnv st;
  st.i_sd = in.p[0][th.e];
  st.i_sq = in.p[1][th.e];
  st.eps = in.p[2][th.e];
  pmsm_init(k, key, env, st);
  float integ_d = 0.0f, integ_q = 0.0f, reward = 0.0f, terms = 0.0f;
  ring_consume(pipe, v, n_steps, [&](const RingWords<kFocWords>& w) {
    const PmsmStepOut o = foc_step(k, q, st, integ_d, integ_q);
    pmsm_advance_candidates(k, pmsm_draws_unpack<false>(w).c, o.done != 0.0f, st);
    reward += o.reward;
    terms += o.done;
  });
  if (th.live) foc_store(out, n, th.e, st, reward, terms);
}

void launch_const(const PmsmConst& k, const CtrlConst& q, uint2 key, int n, int n_steps,
                  const ControlIn& in, const ControlOut& out, cudaStream_t st) {
  control_launch(foc_rollout_kernel<false>, k, q, key, n, n_steps, in, out, st);
}

void launch_ws(const PmsmConst& k, const CtrlConst& q, uint2 key, int n, int n_steps,
               const ControlIn& in, const ControlOut& out, cudaStream_t st) {
  constexpr int bytes = ring_bytes<FocRing>(kFocWords);
  if (bytes > 48 * 1024) {
    cudaFuncSetAttribute(foc_rollout_ws_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         bytes);
  }
  foc_rollout_ws_kernel<<<(n + kRingEnvs - 1) / kRingEnvs, FocRing::kThreads, bytes, st>>>(
      k, q, key, n, n_steps, in, out);
}

// indexed by [wiener]
const ControlLaunchFn<PmsmConst> kLaunch[2] = {launch_const, launch_ws};

// The one-thread Wiener kernel is never launched: tools/sass_ops.py counts
// its step, the function's own work, for the bound.
template __global__ void foc_rollout_kernel<true>(PmsmConst, CtrlConst, uint2, int, int,
                                                  ControlIn, ControlOut);

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
  return control_call(kLaunch[flags[0] ? 1 : 0], k, ctrl, N_FOC_CTRL, seed, n, n_steps, in, 5,
                      out, 9, stream);
}

// The loop's ring for these flags (ring_pipe.cuh's RingLayout) with Wiener
// references, or RL_DESIGN 1 and the rest zero where constant references
// run one thread per env.
int foc_ring_layout(const int* flags, int* out) {
  if (flags[0]) {
    ring_layout<FocRing>(kFocWords, out);
  } else {
    ring_layout_one_thread(1, out);
  }
  return 0;
}

}  // extern "C"
