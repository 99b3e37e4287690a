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
// Design: one thread per env, the drive state (4 or 5 planes), the
// constant-speed rotation (cos, sin) and the reference rows in registers
// across an in-kernel loop over T steps.  Random bits come from
// Philox4x32-10 keyed by the seed and counted by (env, step, slot), the
// slots of the synchronous family; the three phase actions take a
// continuous B6 bridge's three duty words.  Templates: FINITE (three
// commands or three duties), MECH (constant speed or the polynomial load's
// speed ODE), NREF (1 or 3 reference rows) and SAT (the saturating flux
// model): 16 random and 8 buffer instances.  A random kernel holds two
// loops, with and without the reference advance, and takes the second when
// every reference is constant.  Built with -fmad=false (ops/cuda_build.py),
// so each multiply and add rounds as in the plain PyTorch version.
//
// What bounds it on this card: the kernels move only the initial and final
// state (plus 12 bytes of action per env-step in buffer mode), so they are
// bound by the operations of a step: four RK4 stages, each with the three
// phases' inductance profile and 3 IEEE divisions (12 a step), under the
// speed ODE a cosf/sinf pair per stage, saturating an expf per phase and
// stage; in random mode Philox's integer multiplies and xors and the
// non-fast-math logf, cosf and sinf of the Box-Muller pairs; a TC id's
// torque reward takes one more cosf/sinf pair.  tools/sass_ops.py counts the
// instructions a step always issues, per pipe, from the SASS, and
// chip_smoke.py takes its bounds from that count.  Every step loop is
// `#pragma unroll 1`, so that one loop iteration is one step in the count.
#include <cuda_runtime.h>

#include "srm_step.cuh"

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
  srm_rollout_random_kernel<F, M, NR, S><<<blocks(n), kThreads, 0, st>>>(
      k, key, n, n_steps, srm_in_planes(in), srm_out_planes(out), o);
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
