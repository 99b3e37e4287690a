// Universal squirrel-cage induction (SCIM) fused rollouts for Hopper
// (sm_90a): the reducing rollout in random and buffer mode, over the shared
// step of induction_step.cuh, with a plain C interface for ctypes (every
// function returns cudaGetLastError()).  They serve the six {Finite, Cont}
// x {CC, TC, SC} SCIM catalog ids at their defaults.  The recorders are in
// fused_induction_record.cu, a source of its own so that nvcc builds the
// two in parallel.
//
// Replaces (gym_electric_motor_tpu/ops/):
//   induction_rollout_random  pallas_induction.py  make_fused_induction_rollout,
//                                                  random mode (:859)
//   induction_rollout_buffer  pallas_induction.py  make_fused_induction_rollout,
//                                                  buffer mode (:833)
//
// Design: the drive state (4 or 5 planes) and the reference rows in
// registers across an in-kernel loop over T steps.  Random bits come from
// Philox4x32-10 keyed by the seed and counted by (env, step, slot), the
// slots of the synchronous family.  Templates: FINITE (B6 bits or duty),
// MECH (constant speed or the polynomial load's speed ODE) and NREF (1 or 2
// reference rows): 8 instances of each random kernel and 4 buffer
// instances.  Built with -fmad=false (ops/cuda_build.py), so each multiply
// and add rounds as in the plain PyTorch version.
//
// With Wiener references the random rollout is warp-specialised
// (draw_ring.cuh; the consumer's step in induction_ring.cuh, shared with
// the random recorder), as the DC and EESM ones: four consumer warps run
// the step, one thread per env (the flux direction where a row refers to
// the dq currents, the physics, the violation, the reward, the
// regeneration test), and producer warps draw, in a double-buffered
// shared-memory ring of K = 8 steps a slot, every value of a step that
// depends on the constants alone: the B6 action (the bits, or three duties
// with the ACTION_C call) and per row the Box-Muller draw, the candidate
// length and sigma and the candidate reset value, 5 to 11 words a step.  The
// continuous ids reset in 2.4% of env-steps, so one thread per env took the
// divergent redraw in about 55% of warp-steps.  Two producer warps per
// consumer warp, at constant speed and under the speed ODE (IndRing).  With
// constant references a step draws only its action, and the launch takes
// the one-thread kernel, whose constant-reference loop draws step t + 1's
// action beside step t's physics.  That kernel's Wiener loop is built for
// the bound's count alone.  Every design equals the plain version bit for
// bit.
//
// What bounds it on this card: the kernels move only the initial and final
// state (plus 4 or 12 bytes of action per env-step in buffer mode), so they
// are bound by the operations of a step: RK4 over four coupled currents and
// fluxes (and the speed, with the load's torque), the flux direction's
// rsqrt for the CC ids, and in random mode Philox's integer multiplies and
// xors and the non-fast-math logf, cosf and sinf of the Box-Muller pair;
// tools/sass_ops.py counts the instructions a step always issues, per pipe,
// from the SASS, and chip_smoke.py takes its bounds from that count: the
// one-thread step of the same instance, the function's own work (its Wiener
// loop, which the launch no longer takes, is built for that count); beside
// it, the count of both roles per env-step, what the warp-specialised
// kernel issues.  Every step loop is `#pragma unroll 1` and a producer's
// slot loop unrolls exactly its four steps, so that one loop iteration is
// one step, or four, in the count.
#include <cuda_runtime.h>

#include "induction_ring.cuh"

namespace {

constexpr int kThreads = 128;

// out_red: reward, terms, rv, rk, rl, rs
struct RolloutOut {
  float *reward, *terms, *rv, *rk, *rl, *rs;
};

// A random kernel's results for env e: the final state, the reward sum,
// the termination count and the final reference rows ((NREF * R, 128)
// planes, row 0 first).
template <bool MECH, int NREF>
__device__ __forceinline__ void ind_store_out(const InductionState& x, float reward, float terms,
                                              const RefRows<NREF>& refs, int n, int e,
                                              const InductionPlanes& out_state,
                                              const RolloutOut& o) {
  ind_store_state<MECH>(x, out_state, (size_t)e);
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

// The ring: K = 8 steps a slot, two producer warps per consumer warp, each
// drawing four steps of a slot, at constant speed and under the speed ODE
// alike (one producer warp left the consumers waiting on both, and K = 4
// ran 2% to 3% slower, PERF.md).
using IndRing = RingShape<8, 2>;

// One thread per env.  With Wiener references (the loop the bound counts;
// the launch takes the warp-specialised kernel) each step draws and steps
// as ind_random_step; with constant ones step t + 1's action is drawn
// beside step t's physics.
template <bool FINITE, bool MECH, int NREF>
__global__ void induction_rollout_random_kernel(InductionConst k, uint2 key, int n, int n_steps,
                                                InductionInPlanes in, InductionPlanes out_state,
                                                RolloutOut o) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  InductionState x = ind_load_state<MECH>(in, e);
  RefRows<NREF> refs;
  ref_wiener_init<NREF>(k.ref, key, (uint32_t)e, refs);
  float reward = 0.0f, terms = 0.0f;
  if (k.flag[IF_ALL_CONST]) {
    float zb = 0.0f;  // unused: constant references draw no Box-Muller pair
    B6Draws<NREF> d = b6_draws<FINITE, NREF, false>(k.ref, key, (uint32_t)e, 0u, false, zb);
#pragma unroll 1
    for (int t = 0; t < n_steps; ++t) {
      const B6Draws<NREF> next =
          b6_draws<FINITE, NREF, false>(k.ref, key, (uint32_t)e, (uint32_t)(t + 1), false, zb);
      ind_draw_step<FINITE, MECH, NREF, false>(k, d, x, refs, reward, terms);
      d = next;
    }
  } else {
#pragma unroll 1
    for (int t = 0; t < n_steps; ++t) {
      const InductionStepOut s = ind_random_step<FINITE, MECH, NREF, true>(
          k, key, (uint32_t)e, (uint32_t)t, x, refs);
      reward += s.reward;
      terms += s.done;
    }
  }
  ind_store_out<MECH, NREF>(x, reward, terms, refs, n, e, out_state, o);
}

// The random rollout with Wiener references on the ring IndRing.
template <bool FINITE, bool MECH, int NREF>
__global__ void __launch_bounds__(IndRing::kThreads)
    induction_rollout_ws_kernel(InductionConst k, uint2 key, int n, int n_steps,
                                InductionInPlanes in, InductionPlanes out_state, RolloutOut o) {
  constexpr int W = b6_draw_words<FINITE, NREF>();
  extern __shared__ uint32_t ring[];
  const RingThread th = ring_thread(n);
  const int e = th.e;
  InductionState x = ind_load_state<MECH>(in, e);
  RefRows<NREF> refs;
  ref_wiener_init<NREF>(k.ref, key, (uint32_t)e, refs);
  float reward = 0.0f, terms = 0.0f;
  const RingPipe<IndRing> pipe(n_steps);
  const RingView<W> v{ring + th.le};
  if (th.consumer) {
    ring_consume(pipe, v, n_steps, [&](const RingWords<W>& w) {
      ind_draw_step<FINITE, MECH, NREF, true>(k, b6_draws_unpack<FINITE, NREF>(w), x, refs,
                                              reward, terms);
    });
  } else {
    ring_produce(pipe, v, th.part, [&](uint32_t t, bool odd, float& zb) {
      return b6_draws_pack<FINITE, NREF>(
          b6_draws<FINITE, NREF, true>(k.ref, key, (uint32_t)e, t, odd, zb));
    });
  }
  if (!th.consumer || !th.live) return;
  ind_store_out<MECH, NREF>(x, reward, terms, refs, n, e, out_state, o);
}

template <bool FINITE, bool MECH>
__global__ void induction_rollout_buffer_kernel(InductionConst k, int n, int n_steps,
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
  }
  ind_store_state<MECH>(x, out, (size_t)e);
}

int blocks(int n) { return (n + kThreads - 1) / kThreads; }

// The warp-specialised kernel with Wiener references, the one-thread
// kernel's constant-reference loop with constant ones.
template <bool F, bool M, int NR>
void launch_random(const InductionConst& k, uint2 key, int n, int n_steps, const float* const* in,
                   float* const* out, cudaStream_t st) {
  const RolloutOut o = {out[5], out[6], out[7], out[8], out[9], out[10]};
  if (k.flag[IF_ALL_CONST]) {
    induction_rollout_random_kernel<F, M, NR><<<blocks(n), kThreads, 0, st>>>(
        k, key, n, n_steps, ind_in_planes(in), ind_out_planes(out), o);
    return;
  }
  constexpr int bytes = ring_bytes<IndRing>(b6_draw_words<F, NR>());
  if (bytes > 48 * 1024) {
    cudaFuncSetAttribute(induction_rollout_ws_kernel<F, M, NR>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  }
  induction_rollout_ws_kernel<F, M, NR><<<(n + kRingEnvs - 1) / kRingEnvs, IndRing::kThreads,
                                          bytes, st>>>(k, key, n, n_steps, ind_in_planes(in),
                                                       ind_out_planes(out), o);
}

template <bool F, bool M>
void launch_buffer(const InductionConst& k, int n, int n_steps, const float* const* in,
                   const int* act_i, const float* act_f, float* const* out, cudaStream_t st) {
  induction_rollout_buffer_kernel<F, M><<<blocks(n), kThreads, 0, st>>>(
      k, n, n_steps, ind_in_planes(in), act_i, act_f, ind_out_planes(out));
}

using RandomFn = void (*)(const InductionConst&, uint2, int, int, const float* const*,
                          float* const*, cudaStream_t);
using BufferFn = void (*)(const InductionConst&, int, int, const float* const*, const int*,
                          const float*, float* const*, cudaStream_t);

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

// in: (omega or NULL, i_salpha, i_sbeta, psi_ralpha, psi_rbeta); out: the
// same five state planes, then reward, terms, rv, rk, rl, rs.  Returns
// cudaErrorInvalidValue for flags no instance serves.
int induction_rollout_random(const float* consts, const int* flags, unsigned long long seed, int n,
                             int n_steps, const float* const* in, float* const* out,
                             void* stream) {
  const int idx = ind_random_index(flags);
  if (idx < 0) return (int)cudaErrorInvalidValue;
  kRandom[idx](ind_load_const(consts, flags), ind_seed_key(seed), n, n_steps, in, out,
               (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// The random rollout's ring for the instance and loop of these flags
// (draw_ring.cuh's RingLayout), or RL_DESIGN 2 and the rest zero where the
// launch runs one thread per env with the next step's draws ahead
// (constant references); cudaErrorInvalidValue for flags no instance
// serves.
int induction_ring_layout(const int* flags, int* out) {
  if (ind_random_index(flags) < 0) return (int)cudaErrorInvalidValue;
  if (flags[IF_ALL_CONST]) {
    ring_layout_one_thread(2, out);
    return 0;
  }
  ring_layout<IndRing>((flags[IF_FINITE] ? 1 : 3) + kRefWords * flags[IF_NREF], out);
  return 0;
}

// actions: int32 (T, N) for a finite converter, float32 (T, 3, N) for a
// continuous one (the other pointer NULL); out: the five state planes.
int induction_rollout_buffer(const float* consts, const int* flags, int n, int n_steps,
                             const float* const* in, const int* act_i, const float* act_f,
                             float* const* out, void* stream) {
  kBuffer[ind_buffer_index(flags)](ind_load_const(consts, flags), n, n_steps, in, act_i, act_f,
                                   out, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

}  // extern "C"
