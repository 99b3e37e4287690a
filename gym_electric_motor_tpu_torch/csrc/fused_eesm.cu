// Universal externally excited synchronous (EESM) fused rollouts for Hopper
// (sm_90a): the reducing rollout in random and buffer mode, over the shared
// step of eesm_step.cuh, with a plain C interface for ctypes (every
// function returns cudaGetLastError()).  They serve the six {Finite, Cont}
// x {CC, TC, SC} EESM catalog ids at their defaults.  The recorders are in
// fused_eesm_record.cu, a source of its own so that nvcc builds the two in
// parallel.
//
// Replaces (gym_electric_motor_tpu/ops/):
//   eesm_rollout_random  pallas_eesm.py  make_fused_eesm_family_rollout, random mode (:902)
//   eesm_rollout_buffer  pallas_eesm.py  make_fused_eesm_family_rollout, buffer mode (:875)
//
// Design.  Templates: FINITE (B6 bits and the 4QC, or four duties), MECH
// (constant speed or the polynomial load's speed ODE) and NREF (1
// reference row for TC and SC, 3 for CC): 8 random and 4 buffer instances.
// The drive state (4 or 5 planes), the constant-speed rotation (cos, sin)
// and the reference rows stay in registers across an in-kernel loop over T
// steps.  Random bits come from Philox4x32-10 keyed by the seed and
// counted by (env, step, slot), the slots of the synchronous family plus
// the third reference row's own.  The one-thread random kernel holds two loops, with
// and without the reference advance, and takes the second when every
// reference is constant.  Built with -fmad=false (ops/cuda_build.py), so
// each multiply and add rounds as in the plain PyTorch version.
//
// What bounded the one-thread random rollout on this card (PERF.md): its
// loop moves nothing, so the operations of a step bound it (RK4 over three
// coupled currents, and the speed with the load's torque, and Philox with
// the non-fast-math logf, cosf and sinf of the Box-Muller pairs, two pairs
// a step with the three CC references), and it reached 9% to 21% of that
// bound.  At 16384 envs one thread per env is one warp per scheduler, so
// nothing hid a dependent instruction's latency; and the blocks a step ran
// only when one of the warp's 32 envs needed them (the PARAMS draw with
// floorf and expf after a regeneration, the RESET draw after a violation,
// with one row the Box-Muller pair of every second step) were larger than
// the step and sat on its dependent chain: the continuous ids reset in
// 10.7% of env-steps, so about 97% of warp-steps took them.  None of that
// work depends on the state.
//
// With Wiener references the random rollout is warp-specialised
// (eesm_ring.cuh): four consumer warps run the step, one thread per env
// (under the speed ODE with the angle's cosf and sinf), and producer warps
// draw, in a double-buffered shared-memory ring of K = 4 steps a slot,
// every value of a step that depends on the constants alone: the sampled
// action (finite: the B6 bits and the 4QC action; continuous: the four
// duties, with the ACTION_C call) and per row the Box-Muller draw (with
// three rows the ROW2 call and its second pair), the candidate length and
// sigma and the candidate reset value: 6 to 16 words a step.  At constant
// speed two producer warps per consumer warp, each drawing two steps of a
// slot (with one, the consumers waited on the producers); under the speed
// ODE, where the consumer's step is the longer, one, drawing the whole
// slot (a second one there took issue slots from the consumers, PERF.md).
// The consumer takes the candidates by selects.  With constant references a
// step draws only its action, and the launch takes one thread per env that
// draws step t + 1's action beside step t's physics, which ran faster than
// both the warp-specialised kernel and the one-thread kernel's loop.  The
// same functions on the same operands make every design equal to the plain
// version bit for bit.
//
// tools/sass_ops.py counts the instructions a step always issues, per
// pipe, from the SASS.  chip_smoke.py takes its bounds from the one-thread
// step of the same instance, the function's own work, which is built below
// for that count and never launched; beside it, the count of what the
// launch issues: both roles per env-step (the consumer's step plus a
// producer's slot loop over its steps) or the ahead loop's.  Every step
// loop is `#pragma unroll 1` and a producer's slot loop unrolls exactly its
// steps, so that one loop iteration is one step, or two or four, in the
// count.
#include <cuda_runtime.h>

#include "eesm_ring.cuh"

namespace {

constexpr int kThreads = 128;

template <bool FINITE, bool MECH, int NREF, bool WIENER>
__device__ __forceinline__ void rollout_random_loop(const EesmConst& k, uint2 key, int e,
                                                    int n_steps, EesmState& x, float& c, float& s,
                                                    RefRows<NREF>& refs, float& reward,
                                                    float& terms) {
#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) {
    const EesmStepOut o = eesm_random_step<FINITE, MECH, NREF, WIENER>(
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
__global__ void eesm_rollout_random_kernel(EesmConst k, uint2 key, int n, int n_steps,
                                           EesmInPlanes in, EesmPlanes out_state, RolloutOut o) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  EesmState x = eesm_load_state<MECH>(in, e);
  // the constant-speed rotation starts at the initial angle
  float c = MECH ? 1.0f : cosf(x.eps), s = MECH ? 0.0f : sinf(x.eps);
  RefRows<NREF> refs;
  ref_wiener_init<NREF>(k.ref, key, (uint32_t)e, refs);
  float reward = 0.0f, terms = 0.0f;
  if (k.flag[EF_ALL_CONST]) {
    rollout_random_loop<FINITE, MECH, NREF, false>(k, key, e, n_steps, x, c, s, refs, reward,
                                                   terms);
  } else {
    rollout_random_loop<FINITE, MECH, NREF, true>(k, key, e, n_steps, x, c, s, refs, reward,
                                                  terms);
  }
  eesm_store_state<MECH>(x, out_state, (size_t)e);
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

// ---- the warp-specialised random rollout ------------------------------

// One role of the warp-specialised kernel over the launch's steps.
template <bool FINITE, bool MECH, int NREF>
__device__ __forceinline__ void eesm_ws_role(const EesmConst& k, uint2 key, const RingThread& th,
                                             int n_steps, uint32_t* column, EesmState& x,
                                             float& c, float& s, RefRows<NREF>& refs,
                                             float& reward, float& terms) {
  constexpr int W = eesm_ring_words<FINITE, NREF>();
  const RingPipe<EesmRing<MECH>> pipe(n_steps);
  const RingView<W> v{column};
  const uint32_t env = (uint32_t)th.e;
  if (th.consumer) {
    ring_consume(pipe, v, n_steps, [&](const RingWords<W>& w) {
      eesm_draw_step<FINITE, MECH, NREF, true>(k, eesm_unpack<FINITE, NREF>(w), x, c, s, refs,
                                               reward, terms);
    });
  } else {
    ring_produce(pipe, v, th.part, [&](uint32_t t, bool odd, float& zb) {
      return eesm_pack<FINITE, NREF>(eesm_draws<FINITE, NREF, true>(k, key, env, t, odd, zb));
    });
  }
}

// The random rollout with Wiener references (with constant ones the
// launch takes eesm_rollout_ahead_kernel).
template <bool FINITE, bool MECH, int NREF>
__global__ void __launch_bounds__(EesmRing<MECH>::kThreads)
    eesm_rollout_ws_kernel(EesmConst k, uint2 key, int n, int n_steps, EesmInPlanes in,
                           EesmPlanes out_state, RolloutOut o) {
  extern __shared__ uint32_t ring[];
  const RingThread th = ring_thread(n);
  uint32_t* const column = ring + th.le;
  const int e = th.e;
  EesmState x = eesm_load_state<MECH>(in, e);
  // the constant-speed rotation starts at the initial angle
  float c = MECH ? 1.0f : cosf(x.eps), s = MECH ? 0.0f : sinf(x.eps);
  RefRows<NREF> refs;
  ref_wiener_init<NREF>(k.ref, key, (uint32_t)e, refs);
  float reward = 0.0f, terms = 0.0f;
  eesm_ws_role<FINITE, MECH, NREF>(k, key, th, n_steps, column, x, c, s, refs, reward, terms);
  if (!th.consumer || !th.live) return;
  eesm_store_state<MECH>(x, out_state, (size_t)e);
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

// ---- constant references: one thread per env, the next step's draws
// ahead -------------------------------------------------------------------

template <bool FINITE, bool MECH, int NREF>
__device__ __forceinline__ void eesm_ahead_loop(const EesmConst& k, uint2 key, uint32_t env,
                                                int n_steps, EesmState& x, float& c, float& s,
                                                RefRows<NREF>& refs, float& reward,
                                                float& terms) {
  float zb = 0.0f;  // unused: constant references draw no Box-Muller pair
  EesmDraws<NREF> d = eesm_draws<FINITE, NREF, false>(k, key, env, 0u, false, zb);
#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) {
    const EesmDraws<NREF> next =
        eesm_draws<FINITE, NREF, false>(k, key, env, (uint32_t)(t + 1), false, zb);
    eesm_draw_step<FINITE, MECH, NREF, false>(k, d, x, c, s, refs, reward, terms);
    d = next;
  }
}

// With constant references a step draws only its action; this loop draws
// step t + 1's action beside step t's physics, which ran faster than the
// warp-specialised kernel and the one-thread kernel's loop (PERF.md).
template <bool FINITE, bool MECH, int NREF>
__global__ void eesm_rollout_ahead_kernel(EesmConst k, uint2 key, int n, int n_steps,
                                          EesmInPlanes in, EesmPlanes out_state, RolloutOut o) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  EesmState x = eesm_load_state<MECH>(in, e);
  float c = MECH ? 1.0f : cosf(x.eps), s = MECH ? 0.0f : sinf(x.eps);
  RefRows<NREF> refs;
  ref_wiener_init<NREF>(k.ref, key, (uint32_t)e, refs);
  float reward = 0.0f, terms = 0.0f;
  eesm_ahead_loop<FINITE, MECH, NREF>(k, key, (uint32_t)e, n_steps, x, c, s, refs, reward, terms);
  eesm_store_state<MECH>(x, out_state, (size_t)e);
  o.reward[e] = reward;
  o.terms[e] = terms;
#pragma unroll
  for (int r = 0; r < NREF; ++r) {
    o.rv[(size_t)r * n + e] = refs.rv[r];
    o.rk[(size_t)r * n + e] = refs.rk[r];
    o.rl[(size_t)r * n + e] = refs.rl[r];
    o.rs[(size_t)r * n + e] = refs.rs[r];
  }
}

// The one-thread step on the ids whose bounds chip_smoke.py takes
// (Cont-SC-EESM-v0, Cont-TC-EESM-v0, Finite-CC-EESM-v0), never launched:
// tools/sass_ops.py counts the function's own work per env-step from it.
template __global__ void eesm_rollout_random_kernel<false, true, 1>(EesmConst, uint2, int, int,
                                                                     EesmInPlanes, EesmPlanes,
                                                                     RolloutOut);
template __global__ void eesm_rollout_random_kernel<false, false, 1>(EesmConst, uint2, int, int,
                                                                      EesmInPlanes, EesmPlanes,
                                                                      RolloutOut);
template __global__ void eesm_rollout_random_kernel<true, false, 3>(EesmConst, uint2, int, int,
                                                                     EesmInPlanes, EesmPlanes,
                                                                     RolloutOut);

template <bool FINITE, bool MECH>
__global__ void eesm_rollout_buffer_kernel(EesmConst k, int n, int n_steps, EesmInPlanes in,
                                           const int* __restrict__ act_i,
                                           const float* __restrict__ act_f, EesmPlanes out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  EesmState x = eesm_load_state<MECH>(in, e);
#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) {
    eesm_buffer_step<FINITE, MECH>(k, eesm_read_action<FINITE>(act_i, act_f, n, t, e), x);
  }
  eesm_store_state<MECH>(x, out, (size_t)e);
}

int blocks(int n) { return (n + kThreads - 1) / kThreads; }

using RandomFn = void (*)(const EesmConst&, uint2, int, int, const float* const*, float* const*,
                          cudaStream_t);
using BufferFn = void (*)(const EesmConst&, int, int, const float* const*, const int*,
                          const float*, float* const*, cudaStream_t);

// Wiener references run the warp-specialised kernel, constant ones the
// one-thread kernel with the next step's draws ahead.
template <bool F, bool M, int NR>
void launch_random(const EesmConst& k, uint2 key, int n, int n_steps, const float* const* in,
                   float* const* out, cudaStream_t st) {
  const RolloutOut o = {out[5], out[6], out[7], out[8], out[9], out[10]};
  if (k.flag[EF_ALL_CONST]) {
    eesm_rollout_ahead_kernel<F, M, NR><<<blocks(n), kThreads, 0, st>>>(
        k, key, n, n_steps, eesm_in_planes(in), eesm_out_planes(out), o);
    return;
  }
  constexpr int bytes = ring_bytes<EesmRing<M>>(eesm_ring_words<F, NR>());
  if (bytes > 48 * 1024) {
    cudaFuncSetAttribute(eesm_rollout_ws_kernel<F, M, NR>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  }
  eesm_rollout_ws_kernel<F, M, NR><<<(n + kRingEnvs - 1) / kRingEnvs, EesmRing<M>::kThreads,
                                     bytes, st>>>(k, key, n, n_steps, eesm_in_planes(in),
                                                  eesm_out_planes(out), o);
}

template <bool F, bool M>
void launch_buffer(const EesmConst& k, int n, int n_steps, const float* const* in,
                   const int* act_i, const float* act_f, float* const* out, cudaStream_t st) {
  eesm_rollout_buffer_kernel<F, M><<<blocks(n), kThreads, 0, st>>>(
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

// in: (omega or NULL, i_sd, i_sq, i_e, eps); out: the same five state
// planes, then reward, terms, rv, rk, rl, rs.  Returns
// cudaErrorInvalidValue for flags no instance serves.
int eesm_rollout_random(const float* consts, const int* flags, unsigned long long seed, int n,
                        int n_steps, const float* const* in, float* const* out, void* stream) {
  const int idx = eesm_random_index(flags);
  if (idx < 0) return (int)cudaErrorInvalidValue;
  kRandom[idx](eesm_load_const(consts, flags), eesm_seed_key(seed), n, n_steps, in, out,
               (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// The random rollout's ring for the instance and loop of these flags
// (draw_ring.cuh's RingLayout), or RL_DESIGN 2 and the rest zero where the
// launch runs one thread per env with the next step's draws ahead;
// cudaErrorInvalidValue for flags no instance serves.
int eesm_ring_layout(const int* flags, int* out) {
  if (eesm_random_index(flags) < 0) return (int)cudaErrorInvalidValue;
  if (flags[EF_ALL_CONST]) {
    ring_layout_one_thread(2, out);
    return 0;
  }
  const int words = (flags[EF_FINITE] ? 2 : 4) + kRefWords * flags[EF_NREF];
  if (flags[EF_MECH]) {
    ring_layout<EesmRing<true>>(words, out);
  } else {
    ring_layout<EesmRing<false>>(words, out);
  }
  return 0;
}

// actions: int32 (T, 2, N) (B6 bits, 4QC) for a finite converter, float32
// (T, 4, N) for a continuous one (the other pointer NULL); out: the five
// state planes.
int eesm_rollout_buffer(const float* consts, const int* flags, int n, int n_steps,
                        const float* const* in, const int* act_i, const float* act_f,
                        float* const* out, void* stream) {
  kBuffer[eesm_buffer_index(flags)](eesm_load_const(consts, flags), n, n_steps, in, act_i, act_f,
                                    out, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

}  // extern "C"
