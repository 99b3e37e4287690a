// Universal doubly fed induction (DFIM) fused rollouts for Hopper (sm_90a):
// the reducing rollout in random and buffer mode, over the shared step of
// dfim_step.cuh, with a plain C interface for ctypes (every function returns
// cudaGetLastError()).  They serve the six {Finite, Cont} x {CC, TC, SC}
// DFIM catalog ids at their defaults.  The recorders are in
// fused_dfim_record.cu, a source of its own so that nvcc builds the two in
// parallel.
//
// Replaces (gym_electric_motor_tpu/ops/):
//   dfim_rollout_random  pallas_dfim.py  make_fused_dfim_family_rollout, random mode (:974)
//   dfim_rollout_buffer  pallas_dfim.py  make_fused_dfim_family_rollout, buffer mode (:947)
//
// Design: one thread per env, the drive state (5 or 6 planes, the rotor
// angle among them: it turns the rotor voltages into the stator frame), the
// constant-speed rotation (cos, sin) and the reference rows in registers
// across an in-kernel loop over T steps.  Random bits come from
// Philox4x32-10 keyed by the seed and counted by (env, step, slot), the
// slots of the synchronous family; the rotor's three duties take the spare
// words of the ACTION_C slot.  Templates: FINITE (two B6 words or six
// duties), MECH (constant speed or the polynomial load's speed ODE) and NREF
// (1 or 2 reference rows): 8 random and 4 buffer instances.  A random kernel
// holds two loops, with and without the reference advance, and takes the
// second when every reference is constant.  Built with -fmad=false
// (ops/cuda_build.py), so each multiply and add rounds as in the plain
// PyTorch version.
//
// What bounds it on this card: the kernels move only the initial and final
// state (plus 8 or 24 bytes of action per env-step in buffer mode), so they
// are bound by the operations of a step: RK4 over four coupled currents and
// fluxes with two voltage inputs (and the speed, with the load's torque),
// the rotor-voltage rotation (cosf and sinf of the angle under the speed
// ODE), the flux direction's rsqrt for the CC ids, and in random mode
// Philox's integer multiplies and xors and the non-fast-math logf, cosf and
// sinf of the Box-Muller pair; tools/sass_ops.py counts the instructions a
// step always issues, per pipe, from the SASS, and chip_smoke.py takes its
// bounds from that count.  Every step loop is `#pragma unroll 1`, so that
// one loop iteration is one step in the count.
#include <cuda_runtime.h>

#include "dfim_step.cuh"

namespace {

constexpr int kThreads = 128;

template <bool FINITE, bool MECH, int NREF, bool WIENER>
__device__ __forceinline__ void rollout_random_loop(const DfimConst& k, uint2 key, int e,
                                                    int n_steps, DfimState& x, float& c, float& s,
                                                    RefRows<NREF>& refs, float& reward,
                                                    float& terms) {
#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) {
    const DfimStepOut o = dfim_random_step<FINITE, MECH, NREF, WIENER>(
        k, key, (uint32_t)e, (uint32_t)t, x, c, s, refs);
    reward += o.reward;
    terms += o.done;
  }
}

// out_red: reward, terms, rv, rk, rl, rs
struct RolloutOut {
  float *reward, *terms, *rv, *rk, *rl, *rs;
};

template <bool FINITE, bool MECH, int NREF>
__global__ void dfim_rollout_random_kernel(DfimConst k, uint2 key, int n, int n_steps,
                                           DfimInPlanes in, DfimPlanes out_state, RolloutOut o) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  DfimState x = dfim_load_state<MECH>(in, e);
  // the constant-speed rotation starts at the initial angle
  float c = MECH ? 1.0f : cosf(x.eps), s = MECH ? 0.0f : sinf(x.eps);
  RefRows<NREF> refs;
  ref_wiener_init<NREF>(k.ref, key, (uint32_t)e, refs);
  float reward = 0.0f, terms = 0.0f;
  if (k.flag[DF_ALL_CONST]) {
    rollout_random_loop<FINITE, MECH, NREF, false>(k, key, e, n_steps, x, c, s, refs, reward,
                                                   terms);
  } else {
    rollout_random_loop<FINITE, MECH, NREF, true>(k, key, e, n_steps, x, c, s, refs, reward,
                                                  terms);
  }
  dfim_store_state<MECH>(x, out_state, (size_t)e);
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
__global__ void dfim_rollout_buffer_kernel(DfimConst k, int n, int n_steps, DfimInPlanes in,
                                           const int* __restrict__ act_i,
                                           const float* __restrict__ act_f, DfimPlanes out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  DfimState x = dfim_load_state<MECH>(in, e);
#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) {
    dfim_buffer_step<FINITE, MECH>(k, dfim_read_action<FINITE>(act_i, act_f, n, t, e), x);
  }
  dfim_store_state<MECH>(x, out, (size_t)e);
}

int blocks(int n) { return (n + kThreads - 1) / kThreads; }

using RandomFn = void (*)(const DfimConst&, uint2, int, int, const float* const*, float* const*,
                          cudaStream_t);
using BufferFn = void (*)(const DfimConst&, int, int, const float* const*, const int*,
                          const float*, float* const*, cudaStream_t);

template <bool F, bool M, int NR>
void launch_random(const DfimConst& k, uint2 key, int n, int n_steps, const float* const* in,
                   float* const* out, cudaStream_t st) {
  const RolloutOut o = {out[6], out[7], out[8], out[9], out[10], out[11]};
  dfim_rollout_random_kernel<F, M, NR><<<blocks(n), kThreads, 0, st>>>(
      k, key, n, n_steps, dfim_in_planes(in), dfim_out_planes(out), o);
}

template <bool F, bool M>
void launch_buffer(const DfimConst& k, int n, int n_steps, const float* const* in,
                   const int* act_i, const float* act_f, float* const* out, cudaStream_t st) {
  dfim_rollout_buffer_kernel<F, M><<<blocks(n), kThreads, 0, st>>>(
      k, n, n_steps, dfim_in_planes(in), act_i, act_f, dfim_out_planes(out));
}

// indexed by dfim_random_index() and dfim_buffer_index()
const RandomFn kRandom[8] = {
    launch_random<false, false, 1>, launch_random<false, false, 2>,
    launch_random<false, true, 1>,  launch_random<false, true, 2>,
    launch_random<true, false, 1>,  launch_random<true, false, 2>,
    launch_random<true, true, 1>,   launch_random<true, true, 2>};
const BufferFn kBuffer[4] = {launch_buffer<false, false>, launch_buffer<false, true>,
                             launch_buffer<true, false>, launch_buffer<true, true>};

}  // namespace

extern "C" {

int dfim_n_const() { return N_DFIM_CONST; }
int dfim_n_row_const() { return N_ROW_CONST; }
int dfim_n_flag() { return N_DFIM_FLAG; }

const char* dfim_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// in: (omega or NULL, i_salpha, i_sbeta, psi_ralpha, psi_rbeta, eps); out:
// the same six state planes, then reward, terms, rv, rk, rl, rs.  Returns
// cudaErrorInvalidValue for flags no instance serves.
int dfim_rollout_random(const float* consts, const int* flags, unsigned long long seed, int n,
                        int n_steps, const float* const* in, float* const* out, void* stream) {
  const int idx = dfim_random_index(flags);
  if (idx < 0) return (int)cudaErrorInvalidValue;
  kRandom[idx](dfim_load_const(consts, flags), dfim_seed_key(seed), n, n_steps, in, out,
               (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// actions: int32 (T, 2, N) (stator bits, rotor bits) for a finite
// converter, float32 (T, 6, N) for a continuous one (the other pointer
// NULL); out: the six state planes.
int dfim_rollout_buffer(const float* consts, const int* flags, int n, int n_steps,
                        const float* const* in, const int* act_i, const float* act_f,
                        float* const* out, void* stream) {
  kBuffer[dfim_buffer_index(flags)](dfim_load_const(consts, flags), n, n_steps, in, act_i, act_f,
                                    out, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

}  // extern "C"
