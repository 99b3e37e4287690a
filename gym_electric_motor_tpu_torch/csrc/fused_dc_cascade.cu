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
// Design: with Wiener references (the catalog's) the loop is
// warp-specialised on the shared-memory ring of ring_pipe.cuh: producer
// warps draw, in a double-buffered ring of K steps a slot, what a step of
// the reference draws whatever the state (draw_ring.cuh's
// ref_candidates<1>: the row's draw, with the sine half of an even step's
// Box-Muller pair carried to the odd step after it, its candidate length
// and sigma and its candidate reset value, 4 words); consumer warps run the
// step, one thread per env, the state (omega, the currents), the reference
// row and the speed and current integrators in registers, and take the
// candidates by selects (ref_advance_candidates).  The Philox call and the
// pair leave the chain the PI cascade and the RK4 wait on.  With constant
// references the launch runs one thread per env, the same state in
// registers across a `#pragma unroll 1` loop over T steps; the one-thread
// Wiener instances are built for tools/sass_ops.py's count of the
// function's own work and never launched.  The cascade is
// control_laws.cuh's dc_cascade_law; the step (the continuous 4QC's duty
// clip, RK4 over the speed and the currents, the constraint, the reward,
// the reset to zero) is dc_step.cuh's dc_action_step, and the one-thread
// reference advance common_step.cuh's ref_wiener_advance, as in
// dc_rollout_random.  The integrators persist across env resets, as
// control_environment carries the controller state.  Templates: OPS
// (PermExDc, SeriesDc, ShuntDc) and, for the one-thread kernel, WIENER
// (6 instances, and 3 on the ring).  Built with -fmad=false, so each
// multiply and add rounds as in the plain PyTorch version; the producers
// compute each candidate with the one-thread kernel's functions on the
// same operands, and a Philox counter is (env, step, slot), so the two
// designs and the plain version are equal bit for bit.
//
// What bounds it on this card: 2 or 3 planes in and 10 or 11 out per env,
// nothing inside the loop, so the operations of a step: the cascade's two
// PI stages, the operating point (a division and the guards for ShuntDc, a
// sqrtf for SeriesDc), the RK4 over the speed and the currents with the
// load's torque, and with a Wiener reference Philox and the Box-Muller
// pair of every second step.  tools/sass_ops.py counts the instructions a
// step always issues, per pipe, from the SASS: the one-thread Wiener step
// for the bound of the function's own work, and beside it what the ring
// issues per env-step, the consumer's step and the producers' draws (the
// PARAMS and RESET slots at every step) over the K / P steps of a
// producer iteration, with the shared-memory accesses and barriers.
#include <cuda_runtime.h>

#include "control_laws.cuh"
#include "dc_step.cuh"
#include "draw_ring.cuh"

namespace {

// One closed-loop step: the cascade's duty from the pre-step state and
// reference, then dc_action_step (the reward against that reference).
template <int OPS>
__device__ __forceinline__ DcStepOut dc_cascade_step(const DcConst& k, const CtrlConst& q,
                                                     DcState& x, const RefRows<1>& refs,
                                                     float& sc_int, float& cc_int) {
  constexpr int MC = OPS == OPS_SHUNT ? MC_SHUNT : MC_ONE;
  DcAction act;
  act.a0 = act.a1 = 0;
  act.f1 = 0.0f;
  act.f0 = dc_cascade_law<OPS>(q.v, x.w, x.i0, MC == MC_SHUNT ? x.i1 : x.i0, x.i1, refs.rv[0],
                               sc_int, cc_int);
  return dc_action_step<false, true, MC, 1>(k, act, x, refs);
}

// out: (omega, i0, i1 or NULL, reward, terms, rv, rk, rl, rs, sc_int,
// cc_int) of env e.
template <int OPS>
__device__ __forceinline__ void dc_cascade_store(const ControlOut& out, int e, const DcState& x,
                                                 float reward, float terms, const RefRows<1>& refs,
                                                 float sc_int, float cc_int) {
  constexpr int MC = OPS == OPS_SHUNT ? MC_SHUNT : MC_ONE;
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

// in: (omega, i0, i1 or NULL); out: dc_cascade_store's.  WIENER: the
// reference advance (the catalog's Wiener reference), else constant
// references.
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
    const DcStepOut o = dc_cascade_step<OPS>(k, q, x, refs, sc_int, cc_int);
    if (WIENER) {
      const uint4 w = drive_draw(key, (uint32_t)e, (uint32_t)t, DRIVE_SLOT_STEP);
      ref_wiener_advance<1>(k.ref, key, (uint32_t)e, (uint32_t)t, w, o.done != 0.0f, refs);
    }
    reward += o.reward;
    terms += o.done;
  }
  dc_cascade_store<OPS>(out, e, x, reward, terms, refs, sc_int, cc_int);
}

// ---- the warp-specialised loop (Wiener references) -----------------------

// The ring: 4 steps a slot, 2 producer warps per consumer warp, each
// drawing 2 steps of a slot (the fastest of K in {4, 8} x P in {1, 2};
// PERF.md, slice 17).  At 4 words a step it holds 16 KB, within the default
// 48 KB of dynamic shared memory.
using DcCascadeRing = RingShape<4, 2>;

// Producer warps run ref_candidates<1> on the step's SLOT_STEP words (4
// words a step, pack_refs); consumer warps dc_cascade_step and
// ref_advance_candidates, one thread per env.
template <int OPS>
__global__ void __launch_bounds__(DcCascadeRing::kThreads)
    dc_cascade_rollout_ws_kernel(DcConst k, CtrlConst q, uint2 key, int n, int n_steps,
                                 ControlIn in, ControlOut out) {
  constexpr int MC = OPS == OPS_SHUNT ? MC_SHUNT : MC_ONE;
  extern __shared__ uint32_t ring[];
  const RingThread th = ring_thread(n);
  const uint32_t env = (uint32_t)th.e;
  const RingPipe<DcCascadeRing> pipe(n_steps);
  const RingView<kRefWords> v{ring + th.le};
  if (!th.consumer) {
    ring_produce(pipe, v, th.part, [&](uint32_t t, bool odd, float& zb) {
      const uint4 w = drive_draw(key, env, t, DRIVE_SLOT_STEP);
      RingWords<kRefWords> x;
      pack_refs<1>(ref_candidates<1>(k.ref, key, env, t, w, odd, zb), 0, x);
      return x;
    });
    return;
  }
  DcState x = dc_load_state<true, MC>(in.p[0], in.p[1], in.p[2], th.e);
  RefRows<1> refs;
  ref_wiener_init<1>(k.ref, key, env, refs);
  float sc_int = 0.0f, cc_int = 0.0f, reward = 0.0f, terms = 0.0f;
  ring_consume(pipe, v, n_steps, [&](const RingWords<kRefWords>& w) {
    const DcStepOut o = dc_cascade_step<OPS>(k, q, x, refs, sc_int, cc_int);
    ref_advance_candidates<1>(k.ref, unpack_refs<1>(w, 0), o.done != 0.0f, refs);
    reward += o.reward;
    terms += o.done;
  });
  if (th.live) dc_cascade_store<OPS>(out, th.e, x, reward, terms, refs, sc_int, cc_int);
}

template <int OPS>
void launch_const(const DcConst& k, const CtrlConst& q, uint2 key, int n, int n_steps,
                  const ControlIn& in, const ControlOut& out, cudaStream_t st) {
  control_launch(dc_cascade_rollout_kernel<OPS, false>, k, q, key, n, n_steps, in, out, st);
}

template <int OPS>
void launch_ws(const DcConst& k, const CtrlConst& q, uint2 key, int n, int n_steps,
               const ControlIn& in, const ControlOut& out, cudaStream_t st) {
  constexpr int bytes = ring_bytes<DcCascadeRing>(kRefWords);
  static_assert(bytes <= 48 * 1024, "the ring fits the default dynamic shared memory");
  dc_cascade_rollout_ws_kernel<OPS><<<(n + kRingEnvs - 1) / kRingEnvs, DcCascadeRing::kThreads,
                                      bytes, st>>>(k, q, key, n, n_steps, in, out);
}

// indexed by [ops][wiener]
const ControlLaunchFn<DcConst> kLaunch[3][2] = {
    {launch_const<OPS_PERMEX>, launch_ws<OPS_PERMEX>},
    {launch_const<OPS_SERIES>, launch_ws<OPS_SERIES>},
    {launch_const<OPS_SHUNT>, launch_ws<OPS_SHUNT>}};

// The one-thread Wiener kernels are never launched: tools/sass_ops.py counts
// their step, the function's own work, for the bound.
template __global__ void dc_cascade_rollout_kernel<OPS_PERMEX, true>(DcConst, CtrlConst, uint2,
                                                                     int, int, ControlIn,
                                                                     ControlOut);
template __global__ void dc_cascade_rollout_kernel<OPS_SERIES, true>(DcConst, CtrlConst, uint2,
                                                                     int, int, ControlIn,
                                                                     ControlOut);
template __global__ void dc_cascade_rollout_kernel<OPS_SHUNT, true>(DcConst, CtrlConst, uint2,
                                                                    int, int, ControlIn,
                                                                    ControlOut);

// The cascade's configuration (continuous, one channel, the speed ODE, one
// reference row on omega) and its OPS, or -1.
int cascade_ops(const int* flags) {
  const bool ok = !flags[DF_FINITE] && flags[DF_MECH] && flags[DF_NREF] == 1 &&
                  flags[DF_QTY0] == DQ_OMEGA &&
                  (flags[DF_MCLASS] == MC_ONE || flags[DF_MCLASS] == MC_SHUNT);
  if (!ok) return -1;
  return flags[DF_MCLASS] == MC_SHUNT ? OPS_SHUNT : (flags[DF_SERIES] ? OPS_SERIES : OPS_PERMEX);
}

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
  const int ops = cascade_ops(flags);
  const DcConst k = dc_load_const(consts, flags);
  return control_call(ops >= 0 ? kLaunch[ops][k.ref.all_const ? 0 : 1] : nullptr, k, ctrl,
                      N_DCC_CTRL, seed, n, n_steps, in, 3, out, 11, stream);
}

// The loop's ring for these flags (ring_pipe.cuh's RingLayout, the same for
// the three motors), or RL_DESIGN 1 and the rest zero where constant
// references run one thread per env; cudaErrorInvalidValue for flags
// outside the cascade's configuration.
int dc_cascade_ring_layout(const int* flags, int* out) {
  if (cascade_ops(flags) < 0) return (int)cudaErrorInvalidValue;
  if (flags[DF_ALL_CONST]) {
    ring_layout_one_thread(1, out);
    return 0;
  }
  ring_layout<DcCascadeRing>(kRefWords, out);
  return 0;
}

}  // extern "C"
