// Universal switched reluctance (SRM) trajectory recorders for Hopper
// (sm_90a): the random and the buffer recorder over the shared step of
// srm_step.cuh (the one fused_srm.cu's rollouts take), with a plain C
// interface for ctypes (every function returns cudaGetLastError()).
//
// Replaces (gym_electric_motor_tpu/ops/):
//   srm_record_random  pallas_record.py  make_fused_record_rollout, random mode (:303),
//                                        for the SRM family
//   srm_record_buffer  pallas_record.py  make_fused_record_rollout, buffer mode (:147),
//                                        for the SRM family
//
// Design: one thread per env, the state, the rotation and the reference
// rows in registers across an in-kernel loop over T steps.  The TPU
// recorder's sequential chunk grid and per-chunk reseed
// (pallas_record.py:206-211) do not carry over: the recorders store
// [t, env], so a warp writes 128 contiguous bytes per signal and step.
// Templates as in fused_srm.cu (16 random and 8 buffer instances); built
// with -fmad=false.
//
// What bounds it on this card: besides the step's operations (see
// fused_srm.cu), 4 bytes per signal and env-step of HBM writes: 11 to 15
// signals in random mode (states, references, the three actions, reward,
// done), 4 or 5 in buffer mode; at large T the random recorder is bound by
// the writes or the operations, whichever chip_smoke.py's bound finds
// larger.
//
// The random recorder on a ring.  One thread per env put every Philox call
// of a step (the action's two slots, and with Wiener references the
// PARAMS, RESET and, with three rows, ROW2 slots), the Box-Muller pair and
// the divergent reference redraw after a reset on the step's chain, where
// the SRM step's divisions and cos/sin pairs already sit.  With Wiener
// references the recorder is warp-specialised (ring_pipe.cuh,
// draw_ring.cuh): producer warps draw, in a double-buffered shared-memory
// ring, each step's three duties and each reference row's draw, candidate
// length and sigma and candidate reset value, whatever the state (7 or 15
// words a step); consumer warps
// run srm_action_step, one thread per env (under the speed ODE where MECH
// is set), take the candidates by selects and store the recorded planes.
// ref_wiener_init and the cycle-start rotation stay with the consumer.
// With constant references a step draws only its action, and the recorder
// keeps its one-thread loop; so do the finite instances, where every ring
// shape ran slower (srm_record_on_ring).  The same functions on the same operands make
// both designs and the plain version equal bit for bit; the one-thread
// Wiener loop stays tools/sass_ops.py's count of the function's own work.
#include <cuda_runtime.h>

#include "draw_ring.cuh"
#include "srm_step.cuh"

namespace {

constexpr int kThreads = 128;

struct RecordOut {
  SrmPlanes state;
  float* ref[kSrmRows];
  int* act_i[3];     // finite: the per-phase commands
  float* act_f[3];   // continuous: the duties
  float *reward, *done;
};

template <bool FINITE, bool MECH, int NREF, bool SAT, bool WIENER>
__device__ __forceinline__ void record_random_loop(const SrmConst& k, uint2 key, int e, int n,
                                                   int n_steps, SrmState& x, float& c, float& s,
                                                   RefRows<NREF>& refs, const RecordOut& o) {
#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) {
    const SrmStepOut r = srm_random_step<FINITE, MECH, NREF, SAT, WIENER>(
        k, key, (uint32_t)e, (uint32_t)t, x, c, s, refs);
    const size_t i = (size_t)t * n + e;
    srm_store_state<MECH>(x, o.state, i);
#pragma unroll
    for (int j = 0; j < NREF; ++j) o.ref[j][i] = r.ref[j];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      if (FINITE) {
        o.act_i[j][i] = r.act.a[j];
      } else {
        o.act_f[j][i] = r.act.d[j];
      }
    }
    o.reward[i] = r.reward;
    o.done[i] = r.done;
  }
}

template <bool FINITE, bool MECH, int NREF, bool SAT>
__global__ void srm_record_random_kernel(SrmConst k, uint2 key, int n, int n_steps,
                                         SrmInPlanes in, RecordOut o) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  SrmState x = srm_load_state<MECH>(in, e);
  float c = MECH ? 1.0f : cosf(x.eps), s = MECH ? 0.0f : sinf(x.eps);
  RefRows<NREF> refs;
  ref_wiener_init<NREF>(k.ref, key, (uint32_t)e, refs);
  if (k.flag[SF_ALL_CONST]) {
    record_random_loop<FINITE, MECH, NREF, SAT, false>(k, key, e, n, n_steps, x, c, s, refs, o);
  } else {
    record_random_loop<FINITE, MECH, NREF, SAT, true>(k, key, e, n, n_steps, x, c, s, refs, o);
  }
}

// ---- the warp-specialised random recorder -------------------------------

// The ring: K steps a slot, P producer warps per consumer warp (the fastest
// of K in {4, 8} x P in {1, 2}, PERF.md, slice 21); ops/fused_srm_family.py's
// SRM_RECORD_RING mirrors it.
using SrmRecordRing = RingShape<8, 2>;

// The instances whose Wiener loop runs on the ring: the continuous ones,
// whose envs reset (0.6% of env-steps from zero states) and then took the
// divergent redraw on the step's chain.  The finite ones, whose envs almost
// never reset, ran slower on every ring shape than on the one-thread loop
// (PERF.md, slice 21), which they keep; ops/fused_srm_family.py's
// srm_record_ring_layout mirrors the choice.
template <bool FINITE>
__host__ __device__ constexpr bool srm_record_on_ring() {
  return !FINITE;
}

// Ring words a step: the three duties' bits, then kRefWords per reference
// row.
template <int NREF>
__host__ __device__ constexpr int srm_ring_words() {
  return 3 + kRefWords * NREF;
}

// What step t draws, whatever the state: the action and the reference
// rows' candidates.
template <int NREF>
struct SrmDraws {
  SrmAction a;
  RefCandidates<NREF> c;
};

template <int NREF>
__device__ __forceinline__ RingWords<srm_ring_words<NREF>()> srm_draws(
    const SrmConst& k, uint2 key, uint32_t env, uint32_t t, bool odd, float& zb) {
  const uint4 w = drive_draw(key, env, t, DRIVE_SLOT_STEP);
  SrmDraws<NREF> d;
  d.a = srm_random_action<false>(key, env, t, w);
  d.c = ref_candidates<NREF>(k.ref, key, env, t, w, odd, zb);
  RingWords<srm_ring_words<NREF>()> x;
#pragma unroll
  for (int j = 0; j < 3; ++j) x.w[j] = __float_as_uint(d.a.d[j]);
  pack_refs<NREF>(d.c, 3, x);
  return x;
}

template <int NREF>
__device__ __forceinline__ SrmDraws<NREF> srm_unpack(const RingWords<srm_ring_words<NREF>()>& x) {
  SrmDraws<NREF> d;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    d.a.a[j] = 0;
    d.a.d[j] = __uint_as_float(x.w[j]);
  }
  d.c = unpack_refs<NREF>(x, 3);
  return d;
}

// The random recorder of a continuous instance with Wiener references
// (with constant ones the launch takes srm_record_random_kernel): producer
// warps run srm_draws, consumer warps the step, one thread per env.
template <bool FINITE, bool MECH, int NREF, bool SAT>
__global__ void __launch_bounds__(SrmRecordRing::kThreads)
    srm_record_ws_kernel(SrmConst k, uint2 key, int n, int n_steps, SrmInPlanes in,
                         RecordOut o) {
  static_assert(srm_record_on_ring<FINITE>(), "the finite instances keep the one-thread loop");
  constexpr int W = srm_ring_words<NREF>();
  extern __shared__ uint32_t ring[];
  const RingThread th = ring_thread(n);
  const int e = th.e;
  const RingPipe<SrmRecordRing> pipe(n_steps);
  const RingView<W> v{ring + th.le};
  if (!th.consumer) {
    ring_produce(pipe, v, th.part, [&](uint32_t t, bool odd, float& zb) {
      return srm_draws<NREF>(k, key, (uint32_t)e, t, odd, zb);
    });
    return;
  }
  SrmState x = srm_load_state<MECH>(in, e);
  float c = MECH ? 1.0f : cosf(x.eps), s = MECH ? 0.0f : sinf(x.eps);
  RefRows<NREF> refs;
  ref_wiener_init<NREF>(k.ref, key, (uint32_t)e, refs);
  size_t i = (size_t)e;
  ring_consume(pipe, v, n_steps, [&](const RingWords<W>& words) {
    const SrmDraws<NREF> d = srm_unpack<NREF>(words);
    const SrmStepOut r = srm_action_step<FINITE, MECH, NREF, SAT>(k, d.a, x, c, s, refs);
    ref_advance_candidates<NREF>(k.ref, d.c, r.done != 0.0f, refs);
    if (th.live) {
      srm_store_state<MECH>(x, o.state, i);
#pragma unroll
      for (int j = 0; j < NREF; ++j) o.ref[j][i] = r.ref[j];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        if (FINITE) {
          o.act_i[j][i] = r.act.a[j];
        } else {
          o.act_f[j][i] = r.act.d[j];
        }
      }
      o.reward[i] = r.reward;
      o.done[i] = r.done;
    }
    i += (size_t)n;
  });
}

template <bool FINITE, bool MECH, bool SAT>
__global__ void srm_record_buffer_kernel(SrmConst k, int n, int n_steps, SrmInPlanes in,
                                         const int* __restrict__ act_i,
                                         const float* __restrict__ act_f, SrmPlanes out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  SrmState x = srm_load_state<MECH>(in, e);
#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) {
    srm_buffer_step<FINITE, MECH, SAT>(k, srm_read_action<FINITE>(act_i, act_f, n, t, e), x);
    srm_store_state<MECH>(x, out, (size_t)t * n + e);
  }
}

int blocks(int n) { return (n + kThreads - 1) / kThreads; }

using RandomFn = int (*)(const SrmConst&, uint2, int, int, const float* const*,
                         const RecordOut&, cudaStream_t);
using BufferFn = void (*)(const SrmConst&, int, int, const float* const*, const int*,
                          const float*, float* const*, cudaStream_t);

// Wiener references run the warp-specialised kernel where
// srm_record_on_ring; constant ones, which draw only the action, and the
// other instances the one-thread kernel.  Returns the error of raising the
// kernel's shared-memory limit, or 0.
template <bool F, bool M, int NR, bool S>
int launch_random(const SrmConst& k, uint2 key, int n, int n_steps, const float* const* in,
                  const RecordOut& o, cudaStream_t st) {
  if constexpr (srm_record_on_ring<F>()) {
    if (!k.flag[SF_ALL_CONST]) {
      constexpr int bytes = ring_bytes<SrmRecordRing>(srm_ring_words<NR>());
      if (bytes > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            srm_record_ws_kernel<F, M, NR, S>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
        if (err != cudaSuccess) return (int)err;
      }
      srm_record_ws_kernel<F, M, NR, S>
          <<<(n + kRingEnvs - 1) / kRingEnvs, SrmRecordRing::kThreads, bytes, st>>>(
              k, key, n, n_steps, srm_in_planes(in), o);
      return 0;
    }
  }
  srm_record_random_kernel<F, M, NR, S><<<blocks(n), kThreads, 0, st>>>(
      k, key, n, n_steps, srm_in_planes(in), o);
  return 0;
}

template <bool F, bool M, bool S>
void launch_buffer(const SrmConst& k, int n, int n_steps, const float* const* in,
                   const int* act_i, const float* act_f, float* const* out, cudaStream_t st) {
  srm_record_buffer_kernel<F, M, S><<<blocks(n), kThreads, 0, st>>>(
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

// out: (omega or NULL, i_a, i_b, i_c, eps, ref rows 0, 1, 2 (NULL past
// n_ref), int32 commands a, b, c or NULL, float32 duties a, b, c or NULL,
// reward, done), each (T, N).  Returns cudaErrorInvalidValue for flags no
// instance serves.
int srm_record_random(const float* consts, const int* flags, unsigned long long seed, int n,
                      int n_steps, const float* const* in, void* const* out, void* stream) {
  const int idx = srm_random_index(flags);
  if (idx < 0) return (int)cudaErrorInvalidValue;
  RecordOut o;
  o.state = srm_out_planes((float* const*)out);
  for (int j = 0; j < kSrmRows; ++j) o.ref[j] = (float*)out[5 + j];
  for (int j = 0; j < 3; ++j) {
    o.act_i[j] = (int*)out[8 + j];
    o.act_f[j] = (float*)out[11 + j];
  }
  o.reward = (float*)out[14];
  o.done = (float*)out[15];
  const int err = kRandom[idx](srm_load_const(consts, flags), srm_seed_key(seed), n, n_steps, in,
                               o, (cudaStream_t)stream);
  return err != 0 ? err : (int)cudaGetLastError();
}

// The random recorder's ring for the instance and loop of these flags
// (ring_pipe.cuh's RingLayout), or RL_DESIGN 1 and the rest zero where the
// launch runs one thread per env (constant references, or an instance not
// srm_record_on_ring); cudaErrorInvalidValue for flags no instance serves.
int srm_record_ring_layout(const int* flags, int* out) {
  if (srm_random_index(flags) < 0) return (int)cudaErrorInvalidValue;
  const bool on_ring = flags[SF_FINITE] ? srm_record_on_ring<true>() : srm_record_on_ring<false>();
  if (flags[SF_ALL_CONST] || !on_ring) {
    ring_layout_one_thread(1, out);
    return 0;
  }
  ring_layout<SrmRecordRing>(3 + kRefWords * flags[SF_NREF], out);
  return 0;
}

// As srm_rollout_buffer, every step's state stored (T, N).
int srm_record_buffer(const float* consts, const int* flags, int n, int n_steps,
                      const float* const* in, const int* act_i, const float* act_f,
                      float* const* out, void* stream) {
  kBuffer[srm_buffer_index(flags)](srm_load_const(consts, flags), n, n_steps, in, act_i, act_f,
                                   out, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

}  // extern "C"
