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
// Design: the state and the reference rows in registers across an
// in-kernel loop over T steps, one thread per env but in the random
// recorder with Wiener references.  The TPU recorder's sequential
// chunk grid and per-chunk reseed (pallas_record.py:206-211) do not carry
// over: the recorders store [t, env], so a warp writes 128 contiguous bytes
// per signal and step.  Templates as in fused_induction.cu (8 random and 4
// buffer instances, and 8 ring instances below); built with -fmad=false.
//
// What bounds it on this card: besides the step's operations (see
// fused_induction.cu), 4 bytes per signal and env-step of HBM writes: 8 to
// 11 signals in random mode (states, references, actions, reward, done), 4
// or 5 in buffer mode; at large T the random recorder is bound by the
// writes or the operations, whichever chip_smoke.py's bound finds larger.
//
// The random recorder on a ring.  One thread per env put every Philox call
// of a step (the action's, and with Wiener references the PARAMS and RESET
// slots), the Box-Muller pair and the divergent reference redraw after a
// reset on the step's dependent chain, as the rollout did before its ring.
// With Wiener references the recorder is warp-specialised as
// fused_induction.cu's rollout is: producer warps draw, in a
// double-buffered shared-memory ring, each step's B6 action and each
// reference row's candidates (draw_ring.cuh's b6_draws, 5 to 11 words a
// step); consumer warps run ind_ring_step (induction_ring.cuh), one thread
// per env, and store the recorded planes.  ref_wiener_init stays with the
// consumer.  With constant references a step draws only its action, and
// the recorder keeps its one-thread loop.  The same functions on the same
// operands make both designs and the plain version equal bit for bit; the
// one-thread Wiener loop stays tools/sass_ops.py's count of the function's
// own work.
#include <cuda_runtime.h>

#include "induction_ring.cuh"

namespace {

constexpr int kThreads = 128;

struct RecordOut {
  InductionPlanes state;
  float *ref0, *ref1;
  int* act_i;
  float *act_a, *act_b, *act_c, *reward, *done;
};

// Step t's recorded planes, at i = t n + e.
template <bool FINITE, bool MECH, int NREF>
__device__ __forceinline__ void store_step(const InductionStepOut& r, const InductionState& x,
                                           const RecordOut& o, size_t i) {
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

template <bool FINITE, bool MECH, int NREF, bool WIENER>
__device__ __forceinline__ void record_random_loop(const InductionConst& k, uint2 key, int e, int n,
                                                   int n_steps, InductionState& x,
                                                   RefRows<NREF>& refs, const RecordOut& o) {
#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) {
    const InductionStepOut r = ind_random_step<FINITE, MECH, NREF, WIENER>(
        k, key, (uint32_t)e, (uint32_t)t, x, refs);
    store_step<FINITE, MECH, NREF>(r, x, o, (size_t)t * n + e);
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

// ---- the warp-specialised random recorder -------------------------------

// The ring: K steps a slot, P producer warps per consumer warp; of K in
// {4, 8} x P in {1, 2} the fastest or within 0.5% of it on every id probed
// (one producer warp ran 10% and 11% slower than the one-thread recorder
// on Finite-CC-SCIM, PERF.md, slice 23);
// ops/fused_induction_family.py's IND_RECORD_RING mirrors it.
using IndRecordRing = RingShape<8, 2>;

// The random recorder with Wiener references (with constant ones the
// launch takes induction_record_random_kernel): producer warps run
// b6_draws, consumer warps the step, one thread per env.
template <bool FINITE, bool MECH, int NREF>
__global__ void __launch_bounds__(IndRecordRing::kThreads)
    induction_record_ws_kernel(InductionConst k, uint2 key, int n, int n_steps,
                               InductionInPlanes in, RecordOut o) {
  constexpr int W = b6_draw_words<FINITE, NREF>();
  extern __shared__ uint32_t ring[];
  const RingThread th = ring_thread(n);
  const int e = th.e;
  const RingPipe<IndRecordRing> pipe(n_steps);
  const RingView<W> v{ring + th.le};
  if (!th.consumer) {
    ring_produce(pipe, v, th.part, [&](uint32_t t, bool odd, float& zb) {
      return b6_draws_pack<FINITE, NREF>(
          b6_draws<FINITE, NREF, true>(k.ref, key, (uint32_t)e, t, odd, zb));
    });
    return;
  }
  InductionState x = ind_load_state<MECH>(in, e);
  RefRows<NREF> refs;
  ref_wiener_init<NREF>(k.ref, key, (uint32_t)e, refs);
  size_t i = (size_t)e;
  ring_consume(pipe, v, n_steps, [&](const RingWords<W>& words) {
    const InductionStepOut r =
        ind_ring_step<FINITE, MECH, NREF>(k, b6_draws_unpack<FINITE, NREF>(words), x, refs);
    if (th.live) store_step<FINITE, MECH, NREF>(r, x, o, i);
    i += (size_t)n;
  });
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

using RandomFn = int (*)(const InductionConst&, uint2, int, int, const float* const*,
                         const RecordOut&, cudaStream_t);
using BufferFn = void (*)(const InductionConst&, int, int, const float* const*, const int*,
                          const float*, float* const*, cudaStream_t);

// Wiener references run the warp-specialised kernel; constant ones, which
// draw only the action, the one-thread kernel.  Returns the error of
// raising the kernel's shared-memory limit, or 0.
template <bool F, bool M, int NR>
int launch_random(const InductionConst& k, uint2 key, int n, int n_steps, const float* const* in,
                  const RecordOut& o, cudaStream_t st) {
  if (k.flag[IF_ALL_CONST]) {
    induction_record_random_kernel<F, M, NR><<<blocks(n), kThreads, 0, st>>>(
        k, key, n, n_steps, ind_in_planes(in), o);
    return 0;
  }
  constexpr int bytes = ring_bytes<IndRecordRing>(b6_draw_words<F, NR>());
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        induction_record_ws_kernel<F, M, NR>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
  }
  induction_record_ws_kernel<F, M, NR><<<(n + kRingEnvs - 1) / kRingEnvs, IndRecordRing::kThreads,
                                         bytes, st>>>(k, key, n, n_steps, ind_in_planes(in), o);
  return 0;
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
  const int err = kRandom[idx](ind_load_const(consts, flags), ind_seed_key(seed), n, n_steps, in,
                               o, (cudaStream_t)stream);
  return err != 0 ? err : (int)cudaGetLastError();
}

// The random recorder's ring for the instance and loop of these flags
// (ring_pipe.cuh's RingLayout), or RL_DESIGN 1 and the rest zero where the
// launch runs one thread per env (constant references);
// cudaErrorInvalidValue for flags no instance serves.
int induction_record_ring_layout(const int* flags, int* out) {
  if (ind_random_index(flags) < 0) return (int)cudaErrorInvalidValue;
  if (flags[IF_ALL_CONST]) {
    ring_layout_one_thread(1, out);
    return 0;
  }
  ring_layout<IndRecordRing>((flags[IF_FINITE] ? 1 : 3) + kRefWords * flags[IF_NREF], out);
  return 0;
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
