// Universal externally excited synchronous (EESM) trajectory recorders for
// Hopper (sm_90a): the random and the buffer recorder over the shared step
// of eesm_step.cuh (the one fused_eesm.cu's rollouts take), with a plain C
// interface for ctypes (every function returns cudaGetLastError()).
//
// Replaces (gym_electric_motor_tpu/ops/):
//   eesm_record_random  pallas_record.py  make_fused_record_rollout, random mode (:303),
//                                         for the EESM family
//   eesm_record_buffer  pallas_record.py  make_fused_record_rollout, buffer mode (:147),
//                                         for the EESM family
//
// Design: one thread per env, the state, the rotation and the reference
// rows in registers across an in-kernel loop over T steps.  The TPU
// recorder's sequential chunk grid and per-chunk reseed
// (pallas_record.py:206-211) do not carry over: the recorders store
// [t, env], so a warp writes 128 contiguous bytes per signal and step.
// Templates as in fused_eesm.cu (8 random and 4 buffer instances); built
// with -fmad=false.
//
// What bounds it on this card: besides the step's operations (see
// fused_eesm.cu), 4 bytes per signal and env-step of HBM writes: 9 to 12
// signals in random mode (states, references, actions, reward, done), 4 or
// 5 in buffer mode; at large T the random recorder is bound by the writes
// or the operations, whichever chip_smoke.py's bound finds larger.
#include <cuda_runtime.h>

#include "eesm_step.cuh"

namespace {

constexpr int kThreads = 128;

struct RecordOut {
  EesmPlanes state;
  float* ref[kEesmRows];
  int *act_b6, *act_e;                         // finite: B6 bits, 4QC
  float *act_a, *act_b, *act_c, *act_ef;       // continuous: the four duties
  float *reward, *done;
};

template <bool FINITE, bool MECH, int NREF, bool WIENER>
__device__ __forceinline__ void record_random_loop(const EesmConst& k, uint2 key, int e, int n,
                                                   int n_steps, EesmState& x, float& c, float& s,
                                                   RefRows<NREF>& refs, const RecordOut& o) {
#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) {
    const EesmStepOut r = eesm_random_step<FINITE, MECH, NREF, WIENER>(
        k, key, (uint32_t)e, (uint32_t)t, x, c, s, refs);
    const size_t i = (size_t)t * n + e;
    eesm_store_state<MECH>(x, o.state, i);
#pragma unroll
    for (int j = 0; j < NREF; ++j) o.ref[j][i] = r.ref[j];
    if (FINITE) {
      o.act_b6[i] = r.act.b6.bits;
      o.act_e[i] = r.act.e_bits;
    } else {
      o.act_a[i] = r.act.b6.a;
      o.act_b[i] = r.act.b6.b;
      o.act_c[i] = r.act.b6.c;
      o.act_ef[i] = r.act.e;
    }
    o.reward[i] = r.reward;
    o.done[i] = r.done;
  }
}

template <bool FINITE, bool MECH, int NREF>
__global__ void eesm_record_random_kernel(EesmConst k, uint2 key, int n, int n_steps,
                                          EesmInPlanes in, RecordOut o) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  EesmState x = eesm_load_state<MECH>(in, e);
  float c = MECH ? 1.0f : cosf(x.eps), s = MECH ? 0.0f : sinf(x.eps);
  RefRows<NREF> refs;
  ref_wiener_init<NREF>(k.ref, key, (uint32_t)e, refs);
  if (k.flag[EF_ALL_CONST]) {
    record_random_loop<FINITE, MECH, NREF, false>(k, key, e, n, n_steps, x, c, s, refs, o);
  } else {
    record_random_loop<FINITE, MECH, NREF, true>(k, key, e, n, n_steps, x, c, s, refs, o);
  }
}

template <bool FINITE, bool MECH>
__global__ void eesm_record_buffer_kernel(EesmConst k, int n, int n_steps, EesmInPlanes in,
                                          const int* __restrict__ act_i,
                                          const float* __restrict__ act_f, EesmPlanes out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  EesmState x = eesm_load_state<MECH>(in, e);
#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) {
    eesm_buffer_step<FINITE, MECH>(k, eesm_read_action<FINITE>(act_i, act_f, n, t, e), x);
    eesm_store_state<MECH>(x, out, (size_t)t * n + e);
  }
}

int blocks(int n) { return (n + kThreads - 1) / kThreads; }

using RandomFn = void (*)(const EesmConst&, uint2, int, int, const float* const*,
                          const RecordOut&, cudaStream_t);
using BufferFn = void (*)(const EesmConst&, int, int, const float* const*, const int*,
                          const float*, float* const*, cudaStream_t);

template <bool F, bool M, int NR>
void launch_random(const EesmConst& k, uint2 key, int n, int n_steps, const float* const* in,
                   const RecordOut& o, cudaStream_t st) {
  eesm_record_random_kernel<F, M, NR><<<blocks(n), kThreads, 0, st>>>(
      k, key, n, n_steps, eesm_in_planes(in), o);
}

template <bool F, bool M>
void launch_buffer(const EesmConst& k, int n, int n_steps, const float* const* in,
                   const int* act_i, const float* act_f, float* const* out, cudaStream_t st) {
  eesm_record_buffer_kernel<F, M><<<blocks(n), kThreads, 0, st>>>(
      k, n, n_steps, eesm_in_planes(in), act_i, act_f, eesm_out_planes(out));
}

// indexed by eesm_random_index() and eesm_buffer_index()
const RandomFn kRandom[8] = {
    launch_random<false, false, 1>, launch_random<false, false, 3>,
    launch_random<false, true, 1>,  launch_random<false, true, 3>,
    launch_random<true, false, 1>,  launch_random<true, false, 3>,
    launch_random<true, true, 1>,   launch_random<true, true, 3>};
const BufferFn kBuffer[4] = {launch_buffer<false, false>, launch_buffer<false, true>,
                             launch_buffer<true, false>, launch_buffer<true, true>};

}  // namespace

extern "C" {

int eesm_n_const() { return N_EESM_CONST; }
int eesm_n_row_const() { return N_ROW_CONST; }
int eesm_n_flag() { return N_EESM_FLAG; }

const char* eesm_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// out: (omega or NULL, i_sd, i_sq, i_e, eps, ref rows 0 to 2 (NULL past
// NREF), int32 B6 bits and 4QC action or NULL, duties a, b, c and the
// excitation duty or NULL, reward, done), each (T, N).  Returns
// cudaErrorInvalidValue for flags no instance serves.
int eesm_record_random(const float* consts, const int* flags, unsigned long long seed, int n,
                       int n_steps, const float* const* in, void* const* out, void* stream) {
  const int idx = eesm_random_index(flags);
  if (idx < 0) return (int)cudaErrorInvalidValue;
  RecordOut o;
  o.state = eesm_out_planes((float* const*)out);
  for (int j = 0; j < kEesmRows; ++j) o.ref[j] = (float*)out[5 + j];
  o.act_b6 = (int*)out[8];
  o.act_e = (int*)out[9];
  o.act_a = (float*)out[10];
  o.act_b = (float*)out[11];
  o.act_c = (float*)out[12];
  o.act_ef = (float*)out[13];
  o.reward = (float*)out[14];
  o.done = (float*)out[15];
  kRandom[idx](eesm_load_const(consts, flags), eesm_seed_key(seed), n, n_steps, in, o,
               (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// As eesm_rollout_buffer, every step's state stored (T, N).
int eesm_record_buffer(const float* consts, const int* flags, int n, int n_steps,
                       const float* const* in, const int* act_i, const float* act_f,
                       float* const* out, void* stream) {
  kBuffer[eesm_buffer_index(flags)](eesm_load_const(consts, flags), n, n_steps, in, act_i, act_f,
                                    out, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

}  // extern "C"
