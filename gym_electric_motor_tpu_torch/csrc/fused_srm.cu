// Universal switched reluctance (SRM) fused rollouts for Hopper (sm_90a): the
// reducing rollout in random and buffer mode, over the shared step of
// srm_step.cuh, with a plain C interface for ctypes (every function returns
// cudaGetLastError()).  They serve the six {Finite, Cont} x {CC, TC, SC} SRM
// catalog ids at their defaults, linear or with the saturating flux model.
// The recorders are in fused_srm_record.cu, a source of its own so that
// nvcc builds the two in parallel.
//
// Replaces (gym_electric_motor_tpu/ops/):
//   srm_rollout_random  pallas_srm.py  make_fused_srm_rollout, random mode (:609)
//   srm_rollout_buffer  pallas_srm.py  make_fused_srm_rollout, buffer mode (:581)
//
// Design.  Templates: FINITE (three commands or three duties), MECH
// (constant speed or the polynomial load's speed ODE), NREF (1 or 3
// reference rows) and SAT (the saturating flux model): 16 random and 8
// buffer instances.  The state, the constant-speed rotation (cos, sin) and
// the reference rows stay in registers across an in-kernel loop over T
// steps.  Random bits come from Philox4x32-10 keyed by the seed and counted
// by (env, step, slot), the slots of the synchronous family; the three
// phase actions take a continuous B6 bridge's three duty words.  A random
// kernel holds two loops, with and without the reference advance, and
// takes the second when every reference is constant.  Built with
// -fmad=false (ops/cuda_build.py), so each multiply and add rounds as in
// the plain PyTorch version.
//
// Two designs, chosen at compile time from MECH.  The buffer rollout and
// the speed-ODE random instances run one thread per env.  The eight
// constant-speed random instances (the CC and TC ids) run the lane-group
// step of srm_lanes.cuh: each env on four lanes of a warp, lane j < 3
// owning phase j (its current, inductance, division and, with three
// references, row j); the step's Philox calls run at once, one per lane:
// lanes 0 and 1 the step slot (action a and the Box-Muller pair; action
// b's word w.w), lane 2 the ROW2 slot with three references (row 2's pair,
// length and sigma) or the step slot with one, lane 3 the ACTION_C slot,
// whose word phase c takes by one shuffle.
//
// What bounded the one-thread step on this card: its loop moves nothing,
// so the operations of a step, and they issue at a fifth to a third of the
// card's rate.  At 16384 envs one thread per env is 512 warps for 528
// schedulers, so nothing hides a dependent instruction's latency, and a
// step is a chain of 12 IEEE divisions (three phases x four RK4 stages,
// each an inline fast path with a branch to a slow path, which keeps the
// phases from interleaving), under the speed ODE a cosf/sinf pair per
// stage, and two or three Philox calls in a row.  The lane groups make
// 2048 warps, about four per scheduler, and a lane's chain holds four
// divisions.  Their price is issue: the per-env work issues on four lanes.
// At constant speed that work is small and the hidden latency wins; under
// the speed ODE the four cosf/sinf pairs and the load are more than half
// of a lane's step, and lane groups ran slower there (PERF.md), so
// those instances keep one thread per env.
//
// The lane groups gather the torque of a torque reward, the violation OR
// over the three clamped currents and, with three references, the WSE
// reward's row terms, and sum them in the plain version's order; the same
// operations on the same operands, IEEE divisions and -fmad=false keep
// both designs bit-equal to srm_rollout_random_plain.  tools/sass_ops.py
// counts the instructions a step always issues, per pipe, from the SASS,
// and chip_smoke.py takes its bounds from that count of the one-thread
// step, the function's own work; for the constant-speed ids it counts the
// one-thread instances that are instantiated below for that purpose and
// never launched.  A lane's count times four, the issue of the lane
// groups, it prints beside.  Every step loop is `#pragma unroll 1`, so
// that one loop iteration is one step in the count.
#include <cuda_runtime.h>

#include "srm_lanes.cuh"

namespace {

constexpr int kThreads = 128;

template <bool FINITE, bool MECH, int NREF, bool SAT, bool WIENER>
__device__ __forceinline__ void rollout_random_loop(const SrmConst& k, uint2 key, int e,
                                                    int n_steps, SrmState& x, float& c, float& s,
                                                    RefRows<NREF>& refs, float& reward,
                                                    float& terms) {
#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) {
    const SrmStepOut o = srm_random_step<FINITE, MECH, NREF, SAT, WIENER>(
        k, key, (uint32_t)e, (uint32_t)t, x, c, s, refs);
    reward += o.reward;
    terms += o.done;
  }
}

// out_red: reward, terms, rv, rk, rl, rs
struct RolloutOut {
  float *reward, *terms, *rv, *rk, *rl, *rs;
};

template <bool FINITE, bool MECH, int NREF, bool SAT>
__global__ void srm_rollout_random_kernel(SrmConst k, uint2 key, int n, int n_steps,
                                          SrmInPlanes in, SrmPlanes out_state, RolloutOut o) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  SrmState x = srm_load_state<MECH>(in, e);
  // the constant-speed rotation starts at the initial angle
  float c = MECH ? 1.0f : cosf(x.eps), s = MECH ? 0.0f : sinf(x.eps);
  RefRows<NREF> refs;
  ref_wiener_init<NREF>(k.ref, key, (uint32_t)e, refs);
  float reward = 0.0f, terms = 0.0f;
  if (k.flag[SF_ALL_CONST]) {
    rollout_random_loop<FINITE, MECH, NREF, SAT, false>(k, key, e, n_steps, x, c, s, refs,
                                                        reward, terms);
  } else {
    rollout_random_loop<FINITE, MECH, NREF, SAT, true>(k, key, e, n_steps, x, c, s, refs, reward,
                                                       terms);
  }
  srm_store_state<MECH>(x, out_state, (size_t)e);
  o.reward[e] = reward;
  o.terms[e] = terms;
  // final reference rows, (NREF * R, 128) planes: row 0 first
#pragma unroll
  for (int r = 0; r < NREF; ++r) {
    o.rv[(size_t)r * n + e] = refs.rv[r];
    o.rk[(size_t)r * n + e] = refs.rk[r];
    o.rl[(size_t)r * n + e] = refs.rl[r];
    o.rs[(size_t)r * n + e] = refs.rs[r];
  }
}

// The lane-group step of srm_lanes.cuh over T steps (constant speed).
template <bool FINITE, int NREF, bool SAT, bool WIENER>
__device__ __forceinline__ void lanes_random_loop(const SrmConst& k, uint2 key, const SrmLane& L,
                                                  int n_steps, float& i, float& eps, float& c,
                                                  float& s, const SrmLaneRow& row,
                                                  SrmLaneRef& ref, float& reward, float& terms) {
  // the lane's Philox slot: the step slot on lanes 0 and 1, ROW2 (three
  // references) or the step slot on lane 2, ACTION_C on lane 3
  const uint32_t slot = L.j == 3 ? DRIVE_SLOT_ACTION_C
                        : (NREF == kSrmRows && L.j == 2 ? DRIVE_SLOT_ROW2 : DRIVE_SLOT_STEP);
#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) {
    const uint4 own = drive_draw(key, (uint32_t)L.env, (uint32_t)t, slot);
    // phase c's action word from lane 3
    const uint32_t act_c = srm_from(own.x, 3);
    const float u01 = uniform24(L.ph == 0 ? own.x : (L.ph == 1 ? own.w : act_c));
    const float u = srm_fraction<FINITE>(FINITE ? min((int)(u01 * 3.0f), 2) : 0,
                                         FINITE ? 0.0f : 2.0f * u01 - 1.0f) * k.v[S_U_SUP];
    bool violated;
    reward += srm_lane_action_step<NREF, SAT>(k, L, u, i, eps, c, s, row, ref, violated);
    terms += violated ? 1.0f : 0.0f;
    if (WIENER) {
      srm_lane_wiener_advance<NREF>(k, key, (uint32_t)L.env, (uint32_t)t, row, own, own.y,
                                    own.z, violated, ref);
    }
  }
}

template <bool FINITE, int NREF, bool SAT>
__global__ void __launch_bounds__(kSrmLaneThreads, kSrmLaneMinBlocks)
    srm_rollout_lanes_kernel(SrmConst k, uint2 key, int n, int n_steps, SrmInPlanes in,
                             SrmPlanes out_state, RolloutOut o) {
  const SrmLane L = srm_lane(k, n);
  float i = (L.ph == 0 ? in.p[1] : (L.ph == 1 ? in.p[2] : in.p[3]))[L.env];
  float eps = in.p[4][L.env];
  // the constant-speed rotation starts at the initial angle
  float c = cosf(eps), s = sinf(eps);
  const SrmLaneRow row = srm_lane_row<NREF>(k, L);
  SrmLaneRef ref = srm_lane_ref_init<NREF>(k, key, L, row);
  float reward = 0.0f, terms = 0.0f;
  if (k.flag[SF_ALL_CONST]) {
    lanes_random_loop<FINITE, NREF, SAT, false>(k, key, L, n_steps, i, eps, c, s, row, ref,
                                                reward, terms);
  } else {
    lanes_random_loop<FINITE, NREF, SAT, true>(k, key, L, n_steps, i, eps, c, s, row, ref,
                                               reward, terms);
  }
  float* const red[6] = {o.reward, o.terms, o.rv, o.rk, o.rl, o.rs};
  srm_lane_store<NREF>(L, n, i, eps, reward, terms, ref, out_state, red);
}

// The one-thread step at constant speed on Finite-CC-SRM-v0 and
// Finite-TC-SRM-v0, never launched: tools/sass_ops.py counts the function's
// own work per env-step from it (chip_smoke.py's bounds).
template __global__ void srm_rollout_random_kernel<true, false, 3, false>(
    SrmConst, uint2, int, int, SrmInPlanes, SrmPlanes, RolloutOut);
template __global__ void srm_rollout_random_kernel<true, false, 1, false>(
    SrmConst, uint2, int, int, SrmInPlanes, SrmPlanes, RolloutOut);

template <bool FINITE, bool MECH, bool SAT>
__global__ void srm_rollout_buffer_kernel(SrmConst k, int n, int n_steps, SrmInPlanes in,
                                          const int* __restrict__ act_i,
                                          const float* __restrict__ act_f, SrmPlanes out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  SrmState x = srm_load_state<MECH>(in, e);
#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) {
    srm_buffer_step<FINITE, MECH, SAT>(k, srm_read_action<FINITE>(act_i, act_f, n, t, e), x);
  }
  srm_store_state<MECH>(x, out, (size_t)e);
}

int blocks(int n) { return (n + kThreads - 1) / kThreads; }

using RandomFn = void (*)(const SrmConst&, uint2, int, int, const float* const*, float* const*,
                          cudaStream_t);
using BufferFn = void (*)(const SrmConst&, int, int, const float* const*, const int*,
                          const float*, float* const*, cudaStream_t);

template <bool F, bool M, int NR, bool S>
void launch_random(const SrmConst& k, uint2 key, int n, int n_steps, const float* const* in,
                   float* const* out, cudaStream_t st) {
  const RolloutOut o = {out[5], out[6], out[7], out[8], out[9], out[10]};
  if constexpr (M) {
    srm_rollout_random_kernel<F, M, NR, S><<<blocks(n), kThreads, 0, st>>>(
        k, key, n, n_steps, srm_in_planes(in), srm_out_planes(out), o);
  } else {
    srm_rollout_lanes_kernel<F, NR, S><<<srm_lane_blocks(n), kSrmLaneThreads, 0, st>>>(
        k, key, n, n_steps, srm_in_planes(in), srm_out_planes(out), o);
  }
}

template <bool F, bool M, bool S>
void launch_buffer(const SrmConst& k, int n, int n_steps, const float* const* in,
                   const int* act_i, const float* act_f, float* const* out, cudaStream_t st) {
  srm_rollout_buffer_kernel<F, M, S><<<blocks(n), kThreads, 0, st>>>(
      k, n, n_steps, srm_in_planes(in), act_i, act_f, srm_out_planes(out));
}

// indexed by srm_random_index() and srm_buffer_index()
const RandomFn kRandom[16] = {
    launch_random<false, false, 1, false>, launch_random<false, false, 3, false>,
    launch_random<false, true, 1, false>,  launch_random<false, true, 3, false>,
    launch_random<true, false, 1, false>,  launch_random<true, false, 3, false>,
    launch_random<true, true, 1, false>,   launch_random<true, true, 3, false>,
    launch_random<false, false, 1, true>,  launch_random<false, false, 3, true>,
    launch_random<false, true, 1, true>,   launch_random<false, true, 3, true>,
    launch_random<true, false, 1, true>,   launch_random<true, false, 3, true>,
    launch_random<true, true, 1, true>,    launch_random<true, true, 3, true>};
const BufferFn kBuffer[8] = {
    launch_buffer<false, false, false>, launch_buffer<false, true, false>,
    launch_buffer<true, false, false>,  launch_buffer<true, true, false>,
    launch_buffer<false, false, true>,  launch_buffer<false, true, true>,
    launch_buffer<true, false, true>,   launch_buffer<true, true, true>};

}  // namespace

extern "C" {

int srm_n_const() { return N_SRM_CONST; }
int srm_n_row_const() { return N_ROW_CONST; }
int srm_n_flag() { return N_SRM_FLAG; }

const char* srm_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// in: (omega or NULL, i_a, i_b, i_c, eps); out: the same five state planes,
// then reward, terms, rv, rk, rl, rs.  Returns cudaErrorInvalidValue for
// flags no instance serves.
int srm_rollout_random(const float* consts, const int* flags, unsigned long long seed, int n,
                       int n_steps, const float* const* in, float* const* out, void* stream) {
  const int idx = srm_random_index(flags);
  if (idx < 0) return (int)cudaErrorInvalidValue;
  kRandom[idx](srm_load_const(consts, flags), srm_seed_key(seed), n, n_steps, in, out,
               (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// actions: int32 (T, 3, N) per-phase commands for a finite converter,
// float32 (T, 3, N) duties for a continuous one (the other pointer NULL);
// out: the five state planes.
int srm_rollout_buffer(const float* consts, const int* flags, int n, int n_steps,
                       const float* const* in, const int* act_i, const float* act_f,
                       float* const* out, void* stream) {
  kBuffer[srm_buffer_index(flags)](srm_load_const(consts, flags), n, n_steps, in, act_i, act_f,
                                   out, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

}  // extern "C"
