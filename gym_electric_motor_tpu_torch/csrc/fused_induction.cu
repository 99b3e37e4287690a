// Universal squirrel-cage induction (SCIM) fused rollouts for Hopper
// (sm_90a): the reducing rollout in random and buffer mode, over the shared
// step of induction_step.cuh, with a plain C interface for ctypes (every
// function returns cudaGetLastError()).  They serve the six {Finite, Cont}
// x {CC, TC, SC} SCIM catalog ids at their defaults.  The recorders are in
// fused_induction_record.cu, a source of its own so that nvcc builds the
// two in parallel.
//
// Replaces (gym_electric_motor_tpu/ops/):
//   induction_rollout_random  pallas_induction.py  make_fused_induction_rollout,
//                                                  random mode (:859)
//   induction_rollout_buffer  pallas_induction.py  make_fused_induction_rollout,
//                                                  buffer mode (:833)
//
// Design: one thread per env, the drive state (4 or 5 planes) and the
// reference rows in registers across an in-kernel loop over T steps.
// Random bits come from Philox4x32-10 keyed by the seed and counted by
// (env, step, slot), the slots of the synchronous family.  Templates:
// FINITE (B6 bits or duty), MECH (constant speed or the polynomial load's
// speed ODE) and NREF (1 or 2 reference rows): 8 random and 4 buffer
// instances.  A random kernel holds two loops, with and without the
// reference advance, and takes the second when every reference is
// constant.  Built with -fmad=false (ops/cuda_build.py), so each multiply
// and add rounds as in the plain PyTorch version.
//
// What bounds it on this card: the kernels move only the initial and final
// state (plus 4 or 12 bytes of action per env-step in buffer mode), so they
// are bound by the operations of a step: RK4 over four coupled currents and
// fluxes (and the speed, with the load's torque), the flux direction's
// rsqrt for the CC ids, and in random mode Philox's integer multiplies and
// xors and the non-fast-math logf, cosf and sinf of the Box-Muller pair;
// tools/sass_ops.py counts the instructions a step always issues, per pipe,
// from the SASS, and chip_smoke.py takes its bounds from that count.  Every
// step loop is `#pragma unroll 1`, so that one loop iteration is one step
// in the count.
#include <cuda_runtime.h>

#include "induction_step.cuh"

namespace {

constexpr int kThreads = 128;

template <bool FINITE, bool MECH, int NREF, bool WIENER>
__device__ __forceinline__ void rollout_random_loop(const InductionConst& k, uint2 key, int e,
                                                    int n_steps, InductionState& x,
                                                    RefRows<NREF>& refs, float& reward,
                                                    float& terms) {
#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) {
    const InductionStepOut o = ind_random_step<FINITE, MECH, NREF, WIENER>(
        k, key, (uint32_t)e, (uint32_t)t, x, refs);
    reward += o.reward;
    terms += o.done;
  }
}

// out_red: reward, terms, rv, rk, rl, rs
struct RolloutOut {
  float *reward, *terms, *rv, *rk, *rl, *rs;
};

template <bool FINITE, bool MECH, int NREF>
__global__ void induction_rollout_random_kernel(InductionConst k, uint2 key, int n, int n_steps,
                                                InductionInPlanes in, InductionPlanes out_state,
                                                RolloutOut o) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  InductionState x = ind_load_state<MECH>(in, e);
  RefRows<NREF> refs;
  ref_wiener_init<NREF>(k.ref, key, (uint32_t)e, refs);
  float reward = 0.0f, terms = 0.0f;
  if (k.flag[IF_ALL_CONST]) {
    rollout_random_loop<FINITE, MECH, NREF, false>(k, key, e, n_steps, x, refs, reward, terms);
  } else {
    rollout_random_loop<FINITE, MECH, NREF, true>(k, key, e, n_steps, x, refs, reward, terms);
  }
  ind_store_state<MECH>(x, out_state, (size_t)e);
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

template <bool FINITE, bool MECH>
__global__ void induction_rollout_buffer_kernel(InductionConst k, int n, int n_steps,
                                                InductionInPlanes in,
                                                const int* __restrict__ act_i,
                                                const float* __restrict__ act_f,
                                                InductionPlanes out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  InductionState x = ind_load_state<MECH>(in, e);
#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) {
    ind_physics<FINITE, MECH>(k, b6_read_action<FINITE>(act_i, act_f, n, t, e), x);
  }
  ind_store_state<MECH>(x, out, (size_t)e);
}

int blocks(int n) { return (n + kThreads - 1) / kThreads; }

using RandomFn = void (*)(const InductionConst&, uint2, int, int, const float* const*,
                          float* const*, cudaStream_t);
using BufferFn = void (*)(const InductionConst&, int, int, const float* const*, const int*,
                          const float*, float* const*, cudaStream_t);

template <bool F, bool M, int NR>
void launch_random(const InductionConst& k, uint2 key, int n, int n_steps, const float* const* in,
                   float* const* out, cudaStream_t st) {
  const RolloutOut o = {out[5], out[6], out[7], out[8], out[9], out[10]};
  induction_rollout_random_kernel<F, M, NR><<<blocks(n), kThreads, 0, st>>>(
      k, key, n, n_steps, ind_in_planes(in), ind_out_planes(out), o);
}

template <bool F, bool M>
void launch_buffer(const InductionConst& k, int n, int n_steps, const float* const* in,
                   const int* act_i, const float* act_f, float* const* out, cudaStream_t st) {
  induction_rollout_buffer_kernel<F, M><<<blocks(n), kThreads, 0, st>>>(
      k, n, n_steps, ind_in_planes(in), act_i, act_f, ind_out_planes(out));
}

// indexed by ind_random_index() and ind_buffer_index()
const RandomFn kRandom[8] = {
    launch_random<false, false, 1>, launch_random<false, false, 2>,
    launch_random<false, true, 1>,  launch_random<false, true, 2>,
    launch_random<true, false, 1>,  launch_random<true, false, 2>,
    launch_random<true, true, 1>,   launch_random<true, true, 2>};
const BufferFn kBuffer[4] = {launch_buffer<false, false>, launch_buffer<false, true>,
                             launch_buffer<true, false>, launch_buffer<true, true>};

}  // namespace

extern "C" {

int induction_n_const() { return N_INDUCTION_CONST; }
int induction_n_row_const() { return N_ROW_CONST; }
int induction_n_flag() { return N_INDUCTION_FLAG; }

const char* induction_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// in: (omega or NULL, i_salpha, i_sbeta, psi_ralpha, psi_rbeta); out: the
// same five state planes, then reward, terms, rv, rk, rl, rs.  Returns
// cudaErrorInvalidValue for flags no instance serves.
int induction_rollout_random(const float* consts, const int* flags, unsigned long long seed, int n,
                             int n_steps, const float* const* in, float* const* out,
                             void* stream) {
  const int idx = ind_random_index(flags);
  if (idx < 0) return (int)cudaErrorInvalidValue;
  kRandom[idx](ind_load_const(consts, flags), ind_seed_key(seed), n, n_steps, in, out,
               (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// actions: int32 (T, N) for a finite converter, float32 (T, 3, N) for a
// continuous one (the other pointer NULL); out: the five state planes.
int induction_rollout_buffer(const float* consts, const int* flags, int n, int n_steps,
                             const float* const* in, const int* act_i, const float* act_f,
                             float* const* out, void* stream) {
  kBuffer[ind_buffer_index(flags)](ind_load_const(consts, flags), n, n_steps, in, act_i, act_f,
                                   out, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

}  // extern "C"
