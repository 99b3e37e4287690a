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
// Templates as in fused_eesm.cu (8 random and 4 buffer instances, and 8
// ring instances below); built with -fmad=false.
//
// What bounds it on this card: besides the step's operations (see
// fused_eesm.cu), 4 bytes per signal and env-step of HBM writes: 9 to 12
// signals in random mode (states, references, actions, reward, done), 4 or
// 5 in buffer mode; at large T the random recorder is bound by the writes
// or the operations, whichever chip_smoke.py's bound finds larger.
//
// The random recorder on a ring.  One thread per env put every Philox call
// of a step (the action's two slots, and with Wiener references the
// PARAMS, RESET and, with three rows, ROW2 slots), the Box-Muller pairs and
// the divergent reference redraw after a reset on the step's dependent
// chain, beside the RK4 over three coupled currents; its writes did not
// bound it (PERF.md).  With Wiener references the recorder is
// warp-specialised as fused_eesm.cu's rollout is (eesm_ring.cuh): producer
// warps draw, in a double-buffered shared-memory ring, each step's action
// and each reference row's candidates, whatever the state (6 to 16 words a
// step); consumer warps run eesm_ring_step, one thread per env (under the
// speed ODE with the angle's cosf and sinf), and store the recorded planes.
// ref_wiener_init and the cycle-start rotation stay with the consumer.
// With constant references a step draws only its action, and the recorder
// keeps its one-thread loop.  The same functions on the same operands make
// both designs and the plain version equal bit for bit; the one-thread
// Wiener loop stays tools/sass_ops.py's count of the function's own work.
#include <cuda_runtime.h>

#include "eesm_ring.cuh"

namespace {

constexpr int kThreads = 128;

struct RecordOut {
  EesmPlanes state;
  float* ref[kEesmRows];
  int *act_b6, *act_e;                         // finite: B6 bits, 4QC
  float *act_a, *act_b, *act_c, *act_ef;       // continuous: the four duties
  float *reward, *done;
};

// Step t's recorded planes, at i = t n + e.
template <bool FINITE, bool MECH, int NREF>
__device__ __forceinline__ void store_step(const EesmStepOut& r, const EesmState& x,
                                           const RecordOut& o, size_t i) {
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

template <bool FINITE, bool MECH, int NREF, bool WIENER>
__device__ __forceinline__ void record_random_loop(const EesmConst& k, uint2 key, int e, int n,
                                                   int n_steps, EesmState& x, float& c, float& s,
                                                   RefRows<NREF>& refs, const RecordOut& o) {
#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) {
    const EesmStepOut r = eesm_random_step<FINITE, MECH, NREF, WIENER>(
        k, key, (uint32_t)e, (uint32_t)t, x, c, s, refs);
    store_step<FINITE, MECH, NREF>(r, x, o, (size_t)t * n + e);
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

// ---- the warp-specialised random recorder -------------------------------

// The ring: K steps a slot, P producer warps per consumer warp; of K in
// {4, 8} x P in {1, 2} the fastest or within 2% of it on the three timed
// ids (under the speed ODE K = 4 with one producer warp led by 2%; on
// Finite-CC-EESM one producer warp ran slower than the one-thread loop,
// PERF.md, slice 22); ops/fused_eesm_family.py's EESM_RECORD_RING mirrors
// it.
using EesmRecordRing = RingShape<8, 2>;

// The random recorder with Wiener references (with constant ones the
// launch takes eesm_record_random_kernel): producer warps run eesm_draws,
// consumer warps the step, one thread per env.
template <bool FINITE, bool MECH, int NREF>
__global__ void __launch_bounds__(EesmRecordRing::kThreads)
    eesm_record_ws_kernel(EesmConst k, uint2 key, int n, int n_steps, EesmInPlanes in,
                          RecordOut o) {
  constexpr int W = eesm_ring_words<FINITE, NREF>();
  extern __shared__ uint32_t ring[];
  const RingThread th = ring_thread(n);
  const int e = th.e;
  const RingPipe<EesmRecordRing> pipe(n_steps);
  const RingView<W> v{ring + th.le};
  if (!th.consumer) {
    ring_produce(pipe, v, th.part, [&](uint32_t t, bool odd, float& zb) {
      return eesm_pack<FINITE, NREF>(
          eesm_draws<FINITE, NREF, true>(k, key, (uint32_t)e, t, odd, zb));
    });
    return;
  }
  EesmState x = eesm_load_state<MECH>(in, e);
  // the constant-speed rotation starts at the initial angle
  float c = MECH ? 1.0f : cosf(x.eps), s = MECH ? 0.0f : sinf(x.eps);
  RefRows<NREF> refs;
  ref_wiener_init<NREF>(k.ref, key, (uint32_t)e, refs);
  size_t i = (size_t)e;
  ring_consume(pipe, v, n_steps, [&](const RingWords<W>& words) {
    const EesmStepOut r = eesm_ring_step<FINITE, MECH, NREF, true>(
        k, eesm_unpack<FINITE, NREF>(words), x, c, s, refs);
    if (th.live) store_step<FINITE, MECH, NREF>(r, x, o, i);
    i += (size_t)n;
  });
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

using RandomFn = int (*)(const EesmConst&, uint2, int, int, const float* const*,
                         const RecordOut&, cudaStream_t);
using BufferFn = void (*)(const EesmConst&, int, int, const float* const*, const int*,
                          const float*, float* const*, cudaStream_t);

// Wiener references run the warp-specialised kernel; constant ones, which
// draw only the action, the one-thread kernel.  Returns the error of
// raising the kernel's shared-memory limit, or 0.
template <bool F, bool M, int NR>
int launch_random(const EesmConst& k, uint2 key, int n, int n_steps, const float* const* in,
                  const RecordOut& o, cudaStream_t st) {
  if (k.flag[EF_ALL_CONST]) {
    eesm_record_random_kernel<F, M, NR><<<blocks(n), kThreads, 0, st>>>(
        k, key, n, n_steps, eesm_in_planes(in), o);
    return 0;
  }
  constexpr int bytes = ring_bytes<EesmRecordRing>(eesm_ring_words<F, NR>());
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        eesm_record_ws_kernel<F, M, NR>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
  }
  eesm_record_ws_kernel<F, M, NR><<<(n + kRingEnvs - 1) / kRingEnvs, EesmRecordRing::kThreads,
                                    bytes, st>>>(k, key, n, n_steps, eesm_in_planes(in), o);
  return 0;
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
  const int err = kRandom[idx](eesm_load_const(consts, flags), eesm_seed_key(seed), n, n_steps,
                               in, o, (cudaStream_t)stream);
  return err != 0 ? err : (int)cudaGetLastError();
}

// The random recorder's ring for the instance and loop of these flags
// (ring_pipe.cuh's RingLayout), or RL_DESIGN 1 and the rest zero where the
// launch runs one thread per env (constant references);
// cudaErrorInvalidValue for flags no instance serves.
int eesm_record_ring_layout(const int* flags, int* out) {
  if (eesm_random_index(flags) < 0) return (int)cudaErrorInvalidValue;
  if (flags[EF_ALL_CONST]) {
    ring_layout_one_thread(1, out);
    return 0;
  }
  ring_layout<EesmRecordRing>((flags[EF_FINITE] ? 2 : 4) + kRefWords * flags[EF_NREF], out);
  return 0;
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
