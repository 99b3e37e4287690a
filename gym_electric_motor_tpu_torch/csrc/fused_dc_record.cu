// Universal DC-family trajectory recorders for Hopper (sm_90a): the random
// and the buffer recorder over the shared step of dc_step.cuh (the one
// fused_dc.cu's rollouts take), with a plain C interface for ctypes (every
// function returns cudaGetLastError()).
//
// Replaces (gym_electric_motor_tpu/ops/):
//   dc_record_random  pallas_record.py  make_fused_record_rollout, random mode (:303),
//                                       for the DC family
//   dc_record_buffer  pallas_record.py  make_fused_record_rollout, buffer mode (:147),
//                                       for the DC family
//
// Design: one thread per env, the state and the reference rows in registers
// across an in-kernel loop over T steps.  The TPU recorder's sequential
// chunk grid and per-chunk reseed (pallas_record.py:206-211) do not carry
// over: the recorders store [t, env], so a warp writes 128 contiguous bytes
// per signal and step.  Templates as in fused_dc.cu (14 random and 12
// buffer instances, and 14 ring instances below); built with -fmad=false.
//
// What bounds it on this card: besides the step's operations (see
// fused_dc.cu), 4 bytes per signal and env-step of HBM writes: 6 to 9
// signals in random mode (states, references, actions, reward, done), 1 to
// 3 in buffer mode; at large T the random recorder is bound by the writes
// or the operations, whichever chip_smoke.py's bound finds larger.
//
// The random recorder on a ring.  One thread per env put every Philox call
// of a step (the action's, and with Wiener references the PARAMS and RESET
// slots), the Box-Muller pair and the divergent reference redraw after a
// reset on the step's dependent chain, and ran as slowly as the one-thread
// rollout: it was not bound by its writes (PERF.md).  With Wiener
// references the recorder is warp-specialised as fused_dc.cu's rollout is
// (dc_ring.cuh): producer warps draw, in a double-buffered shared-memory
// ring, each step's action and each reference row's candidates, whatever
// the state (5 to 10 words a step); consumer warps run dc_ring_step, one
// thread per env, and store the recorded planes.  ref_wiener_init stays
// with the consumer.  With constant references a step draws only its
// action, and the recorder keeps its one-thread loop.  The same functions
// on the same operands make both designs and the plain version equal bit
// for bit; the one-thread Wiener loop stays tools/sass_ops.py's count of
// the function's own work.
#include <cuda_runtime.h>

#include "dc_ring.cuh"

namespace {

constexpr int kThreads = 128;

struct RecordOut {
  float *w, *i0, *i1, *ref0, *ref1;
  void *act0, *act1;   // int32 (finite) or float32 (continuous)
  float *reward, *done;
};

// Step t's recorded planes, at i = t n + e.
template <bool FINITE, bool MECH, int MC, int NREF>
__device__ __forceinline__ void store_step(const DcStepOut& r, const DcState& x,
                                           const RecordOut& o, size_t i) {
  dc_store_state<MECH, MC>(x, o.w, o.i0, o.i1, i);
  o.ref0[i] = r.ref[0];
  if (NREF == 2) o.ref1[i] = r.ref[1];
  if (FINITE) {
    static_cast<int*>(o.act0)[i] = r.act.a0;
    if (MC == MC_EXTEX) static_cast<int*>(o.act1)[i] = r.act.a1;
  } else {
    static_cast<float*>(o.act0)[i] = r.act.f0;
    if (MC == MC_EXTEX) static_cast<float*>(o.act1)[i] = r.act.f1;
  }
  o.reward[i] = r.reward;
  o.done[i] = r.done;
}

template <bool FINITE, bool MECH, int MC, int NREF, bool WIENER>
__device__ __forceinline__ void record_random_loop(const DcConst& k, uint2 key, int e, int n,
                                                   int n_steps, DcState& x, RefRows<NREF>& refs,
                                                   const RecordOut& o) {
#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) {
    const DcStepOut r = dc_random_step<FINITE, MECH, MC, NREF, WIENER>(k, key, (uint32_t)e,
                                                                       (uint32_t)t, x, refs);
    store_step<FINITE, MECH, MC, NREF>(r, x, o, (size_t)t * n + e);
  }
}

template <bool FINITE, bool MECH, int MC, int NREF>
__global__ void dc_record_random_kernel(DcConst k, uint2 key, int n, int n_steps,
                                        const float* __restrict__ w0,
                                        const float* __restrict__ i00,
                                        const float* __restrict__ i10, RecordOut o) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  DcState x = dc_load_state<MECH, MC>(w0, i00, i10, e);
  RefRows<NREF> refs;
  ref_wiener_init<NREF>(k.ref, key, (uint32_t)e, refs);
  if (k.ref.all_const) {
    record_random_loop<FINITE, MECH, MC, NREF, false>(k, key, e, n, n_steps, x, refs, o);
  } else {
    record_random_loop<FINITE, MECH, MC, NREF, true>(k, key, e, n, n_steps, x, refs, o);
  }
}

// ---- the warp-specialised random recorder -------------------------------

// The ring: K steps a slot, P producer warps per consumer warp; of K in
// {4, 8} x P in {1, 2} the fastest or within 2.2% of it on both timed ids
// (under the speed ODE K = 4 with one producer warp led by 2.2%; at
// constant speed one producer warp took 14% to 17% longer, PERF.md, slice 22);
// ops/fused_dc_family.py's DC_RECORD_RING mirrors it.
using DcRecordRing = RingShape<8, 2>;

// The random recorder with Wiener references (with constant ones the
// launch takes dc_record_random_kernel): producer warps run dc_draws,
// consumer warps the step, one thread per env.
template <bool FINITE, bool MECH, int MC, int NREF>
__global__ void __launch_bounds__(DcRecordRing::kThreads)
    dc_record_ws_kernel(DcConst k, uint2 key, int n, int n_steps, const float* __restrict__ w0,
                        const float* __restrict__ i00, const float* __restrict__ i10,
                        RecordOut o) {
  constexpr int W = dc_ring_words<MC, NREF>();
  extern __shared__ uint32_t ring[];
  const RingThread th = ring_thread(n);
  const int e = th.e;
  const RingPipe<DcRecordRing> pipe(n_steps);
  const RingView<W> v{ring + th.le};
  if (!th.consumer) {
    ring_produce(pipe, v, th.part, [&](uint32_t t, bool odd, float& zb) {
      return dc_pack<FINITE, MC, NREF>(
          dc_draws<FINITE, MC, NREF>(k, key, (uint32_t)e, t, odd, zb));
    });
    return;
  }
  DcState x = dc_load_state<MECH, MC>(w0, i00, i10, e);
  RefRows<NREF> refs;
  ref_wiener_init<NREF>(k.ref, key, (uint32_t)e, refs);
  size_t i = (size_t)e;
  ring_consume(pipe, v, n_steps, [&](const RingWords<W>& words) {
    const DcStepOut r =
        dc_ring_step<FINITE, MECH, MC, NREF>(k, dc_unpack<FINITE, MC, NREF>(words), x, refs);
    if (th.live) store_step<FINITE, MECH, MC, NREF>(r, x, o, i);
    i += (size_t)n;
  });
}

template <bool FINITE, bool MECH, int MC>
__global__ void dc_record_buffer_kernel(DcConst k, int n, int n_steps,
                                        const float* __restrict__ w0,
                                        const float* __restrict__ i00,
                                        const float* __restrict__ i10,
                                        const int* __restrict__ act_i,
                                        const float* __restrict__ act_f, float* __restrict__ out_w,
                                        float* __restrict__ out_i0, float* __restrict__ out_i1) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  DcState x = dc_load_state<MECH, MC>(w0, i00, i10, e);
#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) {
    dc_physics<FINITE, MECH, MC>(k, dc_read_action<FINITE, MC>(act_i, act_f, n, t, e), x);
    dc_store_state<MECH, MC>(x, out_w, out_i0, out_i1, (size_t)t * n + e);
  }
}

int blocks(int n) { return (n + kThreads - 1) / kThreads; }

using RandomFn = int (*)(const DcConst&, uint2, int, int, const float* const*, const RecordOut&,
                         cudaStream_t);
using BufferFn = void (*)(const DcConst&, int, int, const float* const*, const int*, const float*,
                          float* const*, cudaStream_t);

// Wiener references run the warp-specialised kernel; constant ones, which
// draw only the action, the one-thread kernel.  Returns the error of
// raising the kernel's shared-memory limit, or 0.
template <bool F, bool M, int MC, int NR>
int launch_random(const DcConst& k, uint2 key, int n, int n_steps, const float* const* in,
                  const RecordOut& o, cudaStream_t st) {
  if (k.ref.all_const) {
    dc_record_random_kernel<F, M, MC, NR><<<blocks(n), kThreads, 0, st>>>(
        k, key, n, n_steps, in[0], in[1], in[2], o);
    return 0;
  }
  constexpr int bytes = ring_bytes<DcRecordRing>(dc_ring_words<MC, NR>());
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        dc_record_ws_kernel<F, M, MC, NR>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
  }
  dc_record_ws_kernel<F, M, MC, NR><<<(n + kRingEnvs - 1) / kRingEnvs, DcRecordRing::kThreads,
                                      bytes, st>>>(k, key, n, n_steps, in[0], in[1], in[2], o);
  return 0;
}

template <bool F, bool M, int MC, int NR>
constexpr RandomFn random_fn() {
  if constexpr (dc_built<M, MC, NR>()) {
    return launch_random<F, M, MC, NR>;
  } else {
    return nullptr;
  }
}

template <bool F, bool M, int MC>
void launch_buffer(const DcConst& k, int n, int n_steps, const float* const* in, const int* act_i,
                   const float* act_f, float* const* out, cudaStream_t st) {
  dc_record_buffer_kernel<F, M, MC><<<blocks(n), kThreads, 0, st>>>(
      k, n, n_steps, in[0], in[1], in[2], act_i, act_f, out[0], out[1], out[2]);
}

#define DC_RANDOM_ROW(F, M)                                                            \
  random_fn<F, M, MC_ONE, 1>(), random_fn<F, M, MC_ONE, 2>(), random_fn<F, M, MC_SHUNT, 1>(), \
      random_fn<F, M, MC_SHUNT, 2>(), random_fn<F, M, MC_EXTEX, 1>(),                  \
      random_fn<F, M, MC_EXTEX, 2>()
#define DC_BUFFER_ROW(F, M) \
  launch_buffer<F, M, MC_ONE>, launch_buffer<F, M, MC_SHUNT>, launch_buffer<F, M, MC_EXTEX>

// indexed by dc_instance(); the buffer table by dc_instance() / 2
const RandomFn kRandom[24] = {DC_RANDOM_ROW(false, false), DC_RANDOM_ROW(false, true),
                              DC_RANDOM_ROW(true, false), DC_RANDOM_ROW(true, true)};
const BufferFn kBuffer[12] = {DC_BUFFER_ROW(false, false), DC_BUFFER_ROW(false, true),
                              DC_BUFFER_ROW(true, false), DC_BUFFER_ROW(true, true)};

}  // namespace

extern "C" {

int dc_n_const() { return N_DC_CONST; }
int dc_n_row_const() { return N_ROW_CONST; }
int dc_n_flag() { return N_DC_FLAG; }

const char* dc_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// out: (omega or NULL, i0, i1 or NULL, ref row 0, ref row 1 or NULL, action
// 0, action 1 or NULL (int32 or float32), reward, done), each (T, N).
// Returns cudaErrorInvalidValue for flags no instance serves.
int dc_record_random(const float* consts, const int* flags, unsigned long long seed, int n,
                     int n_steps, const float* const* in, void* const* out, void* stream) {
  const int idx = dc_instance(flags);
  if (idx < 0 || kRandom[idx] == nullptr) return (int)cudaErrorInvalidValue;
  RecordOut o;
  o.w = (float*)out[0];
  o.i0 = (float*)out[1];
  o.i1 = (float*)out[2];
  o.ref0 = (float*)out[3];
  o.ref1 = (float*)out[4];
  o.act0 = out[5];
  o.act1 = out[6];
  o.reward = (float*)out[7];
  o.done = (float*)out[8];
  const int err = kRandom[idx](dc_load_const(consts, flags), dc_seed_key(seed), n, n_steps, in, o,
                               (cudaStream_t)stream);
  return err != 0 ? err : (int)cudaGetLastError();
}

// The random recorder's ring for the instance and loop of these flags
// (ring_pipe.cuh's RingLayout), or RL_DESIGN 1 and the rest zero where the
// launch runs one thread per env (constant references);
// cudaErrorInvalidValue for flags no instance serves.
int dc_record_ring_layout(const int* flags, int* out) {
  const int idx = dc_instance(flags);
  if (idx < 0 || kRandom[idx] == nullptr) return (int)cudaErrorInvalidValue;
  if (flags[DF_ALL_CONST]) {
    ring_layout_one_thread(1, out);
    return 0;
  }
  ring_layout<DcRecordRing>((flags[DF_MCLASS] == MC_EXTEX ? 2 : 1) + kRefWords * flags[DF_NREF],
                            out);
  return 0;
}

// As dc_rollout_buffer, every step's state stored (T, N).
int dc_record_buffer(const float* consts, const int* flags, int n, int n_steps,
                     const float* const* in, const int* act_i, const float* act_f,
                     float* const* out, void* stream) {
  const int idx = dc_instance(flags);
  if (idx < 0) return (int)cudaErrorInvalidValue;
  kBuffer[idx / 2](dc_load_const(consts, flags), n, n_steps, in, act_i, act_f, out,
                   (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

}  // extern "C"
