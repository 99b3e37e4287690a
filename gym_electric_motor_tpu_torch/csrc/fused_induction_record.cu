// Universal squirrel-cage induction (SCIM) trajectory recorders for Hopper
// (sm_90a): the random and the buffer recorder over the shared step of
// induction_step.cuh (the one fused_induction.cu's rollouts take), with a
// plain C interface for ctypes (every function returns cudaGetLastError()).
//
// Replaces (gym_electric_motor_tpu/ops/):
//   induction_record_random  pallas_record.py  make_fused_record_rollout, random mode
//                                              (:303), for the induction family
//   induction_record_buffer  pallas_record.py  make_fused_record_rollout, buffer mode
//                                              (:147), for the induction family
//
// Design: one thread per env, the state and the reference rows in registers
// across an in-kernel loop over T steps.  The TPU recorder's sequential
// chunk grid and per-chunk reseed (pallas_record.py:206-211) do not carry
// over: the recorders store [t, env], so a warp writes 128 contiguous bytes
// per signal and step.  Templates as in fused_induction.cu (8 random and 4
// buffer instances); built with -fmad=false.
//
// What bounds it on this card: besides the step's operations (see
// fused_induction.cu), 4 bytes per signal and env-step of HBM writes: 8 to
// 11 signals in random mode (states, references, actions, reward, done), 4
// or 5 in buffer mode; at large T the random recorder is bound by the
// writes or the operations, whichever chip_smoke.py's bound finds larger.
#include <cuda_runtime.h>

#include "induction_step.cuh"

namespace {

constexpr int kThreads = 128;

struct RecordOut {
  InductionPlanes state;
  float *ref0, *ref1;
  int* act_i;
  float *act_a, *act_b, *act_c, *reward, *done;
};

template <bool FINITE, bool MECH, int NREF, bool WIENER>
__device__ __forceinline__ void record_random_loop(const InductionConst& k, uint2 key, int e, int n,
                                                   int n_steps, InductionState& x,
                                                   RefRows<NREF>& refs, const RecordOut& o) {
#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) {
    const InductionStepOut r = ind_random_step<FINITE, MECH, NREF, WIENER>(
        k, key, (uint32_t)e, (uint32_t)t, x, refs);
    const size_t i = (size_t)t * n + e;
    ind_store_state<MECH>(x, o.state, i);
    o.ref0[i] = r.ref[0];
    if (NREF == 2) o.ref1[i] = r.ref[1];
    if (FINITE) {
      o.act_i[i] = r.act.bits;
    } else {
      o.act_a[i] = r.act.a;
      o.act_b[i] = r.act.b;
      o.act_c[i] = r.act.c;
    }
    o.reward[i] = r.reward;
    o.done[i] = r.done;
  }
}

template <bool FINITE, bool MECH, int NREF>
__global__ void induction_record_random_kernel(InductionConst k, uint2 key, int n, int n_steps,
                                               InductionInPlanes in, RecordOut o) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  InductionState x = ind_load_state<MECH>(in, e);
  RefRows<NREF> refs;
  ref_wiener_init<NREF>(k.ref, key, (uint32_t)e, refs);
  if (k.flag[IF_ALL_CONST]) {
    record_random_loop<FINITE, MECH, NREF, false>(k, key, e, n, n_steps, x, refs, o);
  } else {
    record_random_loop<FINITE, MECH, NREF, true>(k, key, e, n, n_steps, x, refs, o);
  }
}

template <bool FINITE, bool MECH>
__global__ void induction_record_buffer_kernel(InductionConst k, int n, int n_steps,
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
    ind_store_state<MECH>(x, out, (size_t)t * n + e);
  }
}

int blocks(int n) { return (n + kThreads - 1) / kThreads; }

using RandomFn = void (*)(const InductionConst&, uint2, int, int, const float* const*,
                          const RecordOut&, cudaStream_t);
using BufferFn = void (*)(const InductionConst&, int, int, const float* const*, const int*,
                          const float*, float* const*, cudaStream_t);

template <bool F, bool M, int NR>
void launch_random(const InductionConst& k, uint2 key, int n, int n_steps, const float* const* in,
                   const RecordOut& o, cudaStream_t st) {
  induction_record_random_kernel<F, M, NR><<<blocks(n), kThreads, 0, st>>>(
      k, key, n, n_steps, ind_in_planes(in), o);
}

template <bool F, bool M>
void launch_buffer(const InductionConst& k, int n, int n_steps, const float* const* in,
                   const int* act_i, const float* act_f, float* const* out, cudaStream_t st) {
  induction_record_buffer_kernel<F, M><<<blocks(n), kThreads, 0, st>>>(
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

// out: (omega or NULL, i_salpha, i_sbeta, psi_ralpha, psi_rbeta, ref row 0,
// ref row 1 or NULL, int32 action or NULL, action a, b, c or NULL, reward,
// done), each (T, N).  Returns cudaErrorInvalidValue for flags no instance
// serves.
int induction_record_random(const float* consts, const int* flags, unsigned long long seed, int n,
                            int n_steps, const float* const* in, void* const* out, void* stream) {
  const int idx = ind_random_index(flags);
  if (idx < 0) return (int)cudaErrorInvalidValue;
  RecordOut o;
  o.state = ind_out_planes((float* const*)out);
  o.ref0 = (float*)out[5];
  o.ref1 = (float*)out[6];
  o.act_i = (int*)out[7];
  o.act_a = (float*)out[8];
  o.act_b = (float*)out[9];
  o.act_c = (float*)out[10];
  o.reward = (float*)out[11];
  o.done = (float*)out[12];
  kRandom[idx](ind_load_const(consts, flags), ind_seed_key(seed), n, n_steps, in, o,
               (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// As induction_rollout_buffer, every step's state stored (T, N).
int induction_record_buffer(const float* consts, const int* flags, int n, int n_steps,
                            const float* const* in, const int* act_i, const float* act_f,
                            float* const* out, void* stream) {
  kBuffer[ind_buffer_index(flags)](ind_load_const(consts, flags), n, n_steps, in, act_i, act_f,
                                   out, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

}  // extern "C"
