// Universal doubly fed induction (DFIM) trajectory recorders for Hopper
// (sm_90a): the random and the buffer recorder over the shared step of
// dfim_step.cuh (the one fused_dfim.cu's rollouts take), with a plain C
// interface for ctypes (every function returns cudaGetLastError()).
//
// Replaces (gym_electric_motor_tpu/ops/):
//   dfim_record_random  pallas_record.py  make_fused_record_rollout, random mode (:303),
//                                         for the DFIM family
//   dfim_record_buffer  pallas_record.py  make_fused_record_rollout, buffer mode (:147),
//                                         for the DFIM family
//
// Design: the state, the rotation and the reference rows in registers
// across an in-kernel loop over T steps, one thread per env but in the
// random recorder with Wiener references.  The TPU recorder's sequential
// chunk grid and per-chunk reseed (pallas_record.py:206-211) do not carry
// over: the recorders store [t, env], so a warp writes 128 contiguous bytes
// per signal and step.  Templates as in fused_dfim.cu (8 random and 4
// buffer instances, and 8 ring instances below); built with -fmad=false.
//
// What bounds it on this card: besides the step's operations (see
// fused_dfim.cu), 4 bytes per signal and env-step of HBM writes: 10 to 16
// signals in random mode (states, references, actions, reward, done), 5 or
// 6 in buffer mode; at large T the random recorder is bound by the writes
// or the operations, whichever chip_smoke.py's bound finds larger.
//
// The random recorder on a ring.  One thread per env put every Philox call
// of a step (the action's, the ACTION_C call that gives a continuous
// converter its six duties, and with Wiener references the PARAMS and
// RESET slots), the Box-Muller pair's logf, sqrtf, cosf and sinf and the
// divergent reference redraw on the step's dependent chain, as the rollout
// did before its ring.  With Wiener references the recorder is
// warp-specialised as fused_dfim.cu's rollout is: producer warps draw, in
// a double-buffered shared-memory ring, each step's action and each
// reference row's candidates (dfim_ring.cuh's dfim_draws, 5 to 14 words a
// step, 112 KB of ring at most); consumer warps run dfim_ring_step, one
// thread per env, and store the recorded planes.  ref_wiener_init stays
// with the consumer.  With constant references a step draws only its
// action, and the recorder keeps its one-thread loop.  The same functions
// on the same operands make both designs and the plain version equal bit
// for bit; the one-thread Wiener loop stays tools/sass_ops.py's count of
// the function's own work.
#include <cuda_runtime.h>

#include "dfim_ring.cuh"

namespace {

constexpr int kThreads = 128;

struct RecordOut {
  DfimPlanes state;
  float *ref0, *ref1;
  int *act_s, *act_r;                          // finite: stator and rotor bits
  float* act_f[6];                             // continuous: the six duties
  float *reward, *done;
};

// Step t's recorded planes, at i = t n + e.
template <bool FINITE, bool MECH, int NREF>
__device__ __forceinline__ void store_step(const DfimStepOut& r, const DfimState& x,
                                           const RecordOut& o, size_t i) {
  dfim_store_state<MECH>(x, o.state, i);
  o.ref0[i] = r.ref[0];
  if (NREF == 2) o.ref1[i] = r.ref[1];
  if (FINITE) {
    o.act_s[i] = r.act.s.bits;
    o.act_r[i] = r.act.r.bits;
  } else {
    o.act_f[0][i] = r.act.s.a;
    o.act_f[1][i] = r.act.s.b;
    o.act_f[2][i] = r.act.s.c;
    o.act_f[3][i] = r.act.r.a;
    o.act_f[4][i] = r.act.r.b;
    o.act_f[5][i] = r.act.r.c;
  }
  o.reward[i] = r.reward;
  o.done[i] = r.done;
}

template <bool FINITE, bool MECH, int NREF, bool WIENER>
__device__ __forceinline__ void record_random_loop(const DfimConst& k, uint2 key, int e, int n,
                                                   int n_steps, DfimState& x, float& c, float& s,
                                                   RefRows<NREF>& refs, const RecordOut& o) {
#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) {
    const DfimStepOut r = dfim_random_step<FINITE, MECH, NREF, WIENER>(
        k, key, (uint32_t)e, (uint32_t)t, x, c, s, refs);
    store_step<FINITE, MECH, NREF>(r, x, o, (size_t)t * n + e);
  }
}

template <bool FINITE, bool MECH, int NREF>
__global__ void dfim_record_random_kernel(DfimConst k, uint2 key, int n, int n_steps,
                                          DfimInPlanes in, RecordOut o) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  DfimState x = dfim_load_state<MECH>(in, e);
  float c = MECH ? 1.0f : cosf(x.eps), s = MECH ? 0.0f : sinf(x.eps);
  RefRows<NREF> refs;
  ref_wiener_init<NREF>(k.ref, key, (uint32_t)e, refs);
  if (k.flag[DF_ALL_CONST]) {
    record_random_loop<FINITE, MECH, NREF, false>(k, key, e, n, n_steps, x, c, s, refs, o);
  } else {
    record_random_loop<FINITE, MECH, NREF, true>(k, key, e, n, n_steps, x, c, s, refs, o);
  }
}

// ---- the warp-specialised random recorder -------------------------------

// The ring: K steps a slot, P producer warps per consumer warp; of K in
// {4, 8} x P in {1, 2} the fastest on Cont-CC-, Finite-CC- and Cont-TC-DFIM
// and within 1.6% of the fastest on Cont-SC-DFIM, and the only shape
// faster than the one-thread recorder on every id probed (one producer
// warp ran 5% to 10% slower than it on the CC ids, PERF.md, slice 24);
// ops/fused_dfim_family.py's DFIM_RECORD_RING mirrors it.
using DfimRecordRing = RingShape<8, 2>;

// The random recorder with Wiener references (with constant ones the
// launch takes dfim_record_random_kernel): producer warps run dfim_draws,
// consumer warps the step, one thread per env.
template <bool FINITE, bool MECH, int NREF>
__global__ void __launch_bounds__(DfimRecordRing::kThreads)
    dfim_record_ws_kernel(DfimConst k, uint2 key, int n, int n_steps, DfimInPlanes in,
                          RecordOut o) {
  constexpr int W = dfim_ring_words<FINITE, NREF>();
  extern __shared__ uint32_t ring[];
  const RingThread th = ring_thread(n);
  const int e = th.e;
  const RingPipe<DfimRecordRing> pipe(n_steps);
  const RingView<W> v{ring + th.le};
  if (!th.consumer) {
    ring_produce(pipe, v, th.part, [&](uint32_t t, bool odd, float& zb) {
      return dfim_draws_pack<FINITE, NREF>(
          dfim_draws<FINITE, NREF>(k, key, (uint32_t)e, t, odd, zb));
    });
    return;
  }
  DfimState x = dfim_load_state<MECH>(in, e);
  float c = MECH ? 1.0f : cosf(x.eps), s = MECH ? 0.0f : sinf(x.eps);
  RefRows<NREF> refs;
  ref_wiener_init<NREF>(k.ref, key, (uint32_t)e, refs);
  size_t i = (size_t)e;
  ring_consume(pipe, v, n_steps, [&](const RingWords<W>& words) {
    const DfimStepOut r = dfim_ring_step<FINITE, MECH, NREF>(
        k, dfim_draws_unpack<FINITE, NREF>(words), x, c, s, refs);
    if (th.live) store_step<FINITE, MECH, NREF>(r, x, o, i);
    i += (size_t)n;
  });
}

template <bool FINITE, bool MECH>
__global__ void dfim_record_buffer_kernel(DfimConst k, int n, int n_steps, DfimInPlanes in,
                                          const int* __restrict__ act_i,
                                          const float* __restrict__ act_f, DfimPlanes out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  DfimState x = dfim_load_state<MECH>(in, e);
#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) {
    dfim_buffer_step<FINITE, MECH>(k, dfim_read_action<FINITE>(act_i, act_f, n, t, e), x);
    dfim_store_state<MECH>(x, out, (size_t)t * n + e);
  }
}

int blocks(int n) { return (n + kThreads - 1) / kThreads; }

using RandomFn = int (*)(const DfimConst&, uint2, int, int, const float* const*,
                         const RecordOut&, cudaStream_t);
using BufferFn = void (*)(const DfimConst&, int, int, const float* const*, const int*,
                          const float*, float* const*, cudaStream_t);

// Wiener references run the warp-specialised kernel; constant ones, which
// draw only the action, the one-thread kernel.  Returns the error of
// raising the kernel's shared-memory limit, or 0.
template <bool F, bool M, int NR>
int launch_random(const DfimConst& k, uint2 key, int n, int n_steps, const float* const* in,
                  const RecordOut& o, cudaStream_t st) {
  if (k.flag[DF_ALL_CONST]) {
    dfim_record_random_kernel<F, M, NR><<<blocks(n), kThreads, 0, st>>>(
        k, key, n, n_steps, dfim_in_planes(in), o);
    return 0;
  }
  constexpr int bytes = ring_bytes<DfimRecordRing>(dfim_ring_words<F, NR>());
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        dfim_record_ws_kernel<F, M, NR>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
  }
  dfim_record_ws_kernel<F, M, NR><<<(n + kRingEnvs - 1) / kRingEnvs, DfimRecordRing::kThreads,
                                    bytes, st>>>(k, key, n, n_steps, dfim_in_planes(in), o);
  return 0;
}

template <bool F, bool M>
void launch_buffer(const DfimConst& k, int n, int n_steps, const float* const* in,
                   const int* act_i, const float* act_f, float* const* out, cudaStream_t st) {
  dfim_record_buffer_kernel<F, M><<<blocks(n), kThreads, 0, st>>>(
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

// out: (omega or NULL, i_salpha, i_sbeta, psi_ralpha, psi_rbeta, eps, ref
// row 0, ref row 1 or NULL, int32 stator and rotor bits or NULL, the six
// duties or NULL, reward, done), each (T, N).  Returns
// cudaErrorInvalidValue for flags no instance serves.
int dfim_record_random(const float* consts, const int* flags, unsigned long long seed, int n,
                       int n_steps, const float* const* in, void* const* out, void* stream) {
  const int idx = dfim_random_index(flags);
  if (idx < 0) return (int)cudaErrorInvalidValue;
  RecordOut o;
  o.state = dfim_out_planes((float* const*)out);
  o.ref0 = (float*)out[6];
  o.ref1 = (float*)out[7];
  o.act_s = (int*)out[8];
  o.act_r = (int*)out[9];
  for (int j = 0; j < 6; ++j) o.act_f[j] = (float*)out[10 + j];
  o.reward = (float*)out[16];
  o.done = (float*)out[17];
  const int err = kRandom[idx](dfim_load_const(consts, flags), dfim_seed_key(seed), n, n_steps,
                               in, o, (cudaStream_t)stream);
  return err != 0 ? err : (int)cudaGetLastError();
}

// The random recorder's ring for the instance and loop of these flags
// (ring_pipe.cuh's RingLayout), or RL_DESIGN 1 and the rest zero where the
// launch runs one thread per env (constant references);
// cudaErrorInvalidValue for flags no instance serves.
int dfim_record_ring_layout(const int* flags, int* out) {
  if (dfim_random_index(flags) < 0) return (int)cudaErrorInvalidValue;
  if (flags[DF_ALL_CONST]) {
    ring_layout_one_thread(1, out);
    return 0;
  }
  ring_layout<DfimRecordRing>((flags[DF_FINITE] ? 1 : 6) + kRefWords * flags[DF_NREF], out);
  return 0;
}

// As dfim_rollout_buffer, every step's state stored (T, N).
int dfim_record_buffer(const float* consts, const int* flags, int n, int n_steps,
                       const float* const* in, const int* act_i, const float* act_f,
                       float* const* out, void* stream) {
  kBuffer[dfim_buffer_index(flags)](dfim_load_const(consts, flags), n, n_steps, in, act_i, act_f,
                                    out, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

}  // extern "C"
