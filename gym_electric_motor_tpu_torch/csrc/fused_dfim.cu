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
// Design: the drive state (5 or 6 planes, the rotor angle among them: it
// turns the rotor voltages into the stator frame), the constant-speed
// rotation (cos, sin) and the reference rows in registers across an
// in-kernel loop over T steps.  Random bits come from Philox4x32-10 keyed by
// the seed and counted by (env, step, slot), the slots of the synchronous
// family; the rotor's three duties take the spare words of the ACTION_C
// slot.  Templates: FINITE (two B6 words or six duties), MECH (constant
// speed or the polynomial load's speed ODE) and NREF (1 or 2 reference
// rows): 8 instances of each random kernel and 4 buffer instances.  Built
// with -fmad=false (ops/cuda_build.py), so each multiply and add rounds as
// in the plain PyTorch version.
//
// With Wiener references the random rollout is warp-specialised
// (draw_ring.cuh; the draws in dfim_ring.cuh, shared with the random
// recorder), as the DC, SCIM, EESM and synchronous ones: four consumer
// warps run the step, one thread per env (the flux direction where a row
// refers to the dq currents, cos and sin of the angle under the speed ODE,
// the physics, the violation, the reward, the regeneration test), and two
// producer warps per consumer warp draw, in a double-buffered shared-memory
// ring of K = 8 steps a slot, every value of a step that depends on the
// constants alone: the action (both bridges' bits in one word, or six
// duties with the ACTION_C call) and per row the Box-Muller draw, the
// candidate length and sigma and the candidate reset value, 5 to 14 words
// a step (112 KB of ring at most, above the 48 KB default).  The DFIM ids
// almost never reset (PERF.md, slice 7), so the ring wins less by taking
// the divergent redraw off the step than by moving the two Philox calls and
// the Box-Muller pair off the consumers' dependent chain.  An env on a pair
// of lanes (alpha on one, beta on the other, the partner's flux by shuffle)
// was slower: both lanes issue the per-env work, which is most of the step
// (PERF.md, slice 15).  With constant references a step draws only its action,
// and the launch takes the one-thread kernel, whose Wiener loop is built
// for the bound's count alone.  Every design equals the plain version bit
// for bit.
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
// bounds from that count: the one-thread step of the same instance, the
// function's own work; beside it, the count of both roles per env-step,
// what the warp-specialised kernel issues.  Every step loop is `#pragma
// unroll 1` and a producer's slot loop unrolls exactly its four steps, so
// that one loop iteration is one step, or four, in the count.
#include <cuda_runtime.h>

#include "dfim_ring.cuh"

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

// A random kernel's results for env e: the final state, the reward sum,
// the termination count and the final reference rows ((NREF * R, 128)
// planes, row 0 first).
template <bool MECH, int NREF>
__device__ __forceinline__ void dfim_store_out(const DfimState& x, float reward, float terms,
                                               const RefRows<NREF>& refs, int n, int e,
                                               const DfimPlanes& out_state, const RolloutOut& o) {
  dfim_store_state<MECH>(x, out_state, (size_t)e);
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

// The ring: K = 8 steps a slot, two producer warps per consumer warp
// (SCIM's IndRing).  Words a step (dfim_ring.cuh): the action (both
// bridges' bits in one word, or six duties), then kRefWords per reference
// row.
using DfimRing = RingShape<8, 2>;

// What depends on the state: dfim_random_step with the step's draws given.
template <bool FINITE, bool MECH, int NREF>
__device__ __forceinline__ void dfim_draw_step(const DfimConst& k, const DfimDraws<NREF>& d,
                                               DfimState& x, float& c, float& s,
                                               RefRows<NREF>& refs, float& reward,
                                               float& terms) {
  float fc = 1.0f, fs = 0.0f;
  if (k.flag[DF_NEEDS_DQ]) dfim_flux_dir(k, x, fc, fs);
  if (MECH) {
    c = cosf(x.eps);
    s = sinf(x.eps);
  }
  const DfimStepOut o = dfim_action_step<FINITE, MECH, NREF>(k, d.a, x, c, s, fc, fs, refs);
  reward += o.reward;
  terms += o.done;
  ref_advance_candidates<NREF>(k.ref, d.c, o.done != 0.0f, refs);
}

// One thread per env: the launch takes its constant-reference loop; its
// Wiener loop counts the function's own work.  (Drawing step t + 1's action
// beside step t's physics, as the SCIM's and the synchronous family's
// constant-reference loops do, was slower here, PERF.md, slice 15.)
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
  dfim_store_out<MECH, NREF>(x, reward, terms, refs, n, e, out_state, o);
}

// The random rollout with Wiener references on the ring DfimRing.
template <bool FINITE, bool MECH, int NREF>
__global__ void __launch_bounds__(DfimRing::kThreads)
    dfim_rollout_ws_kernel(DfimConst k, uint2 key, int n, int n_steps, DfimInPlanes in,
                           DfimPlanes out_state, RolloutOut o) {
  constexpr int W = dfim_ring_words<FINITE, NREF>();
  extern __shared__ uint32_t ring[];
  const RingThread th = ring_thread(n);
  const int e = th.e;
  DfimState x = dfim_load_state<MECH>(in, e);
  float c = MECH ? 1.0f : cosf(x.eps), s = MECH ? 0.0f : sinf(x.eps);
  RefRows<NREF> refs;
  ref_wiener_init<NREF>(k.ref, key, (uint32_t)e, refs);
  float reward = 0.0f, terms = 0.0f;
  const RingPipe<DfimRing> pipe(n_steps);
  const RingView<W> v{ring + th.le};
  if (th.consumer) {
    ring_consume(pipe, v, n_steps, [&](const RingWords<W>& w) {
      dfim_draw_step<FINITE, MECH, NREF>(k, dfim_draws_unpack<FINITE, NREF>(w), x, c, s, refs,
                                         reward, terms);
    });
  } else {
    ring_produce(pipe, v, th.part, [&](uint32_t t, bool odd, float& zb) {
      return dfim_draws_pack<FINITE, NREF>(
          dfim_draws<FINITE, NREF>(k, key, (uint32_t)e, t, odd, zb));
    });
  }
  if (!th.consumer || !th.live) return;
  dfim_store_out<MECH, NREF>(x, reward, terms, refs, n, e, out_state, o);
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

// The warp-specialised kernel with Wiener references, the one-thread
// kernel's constant-reference loop with constant ones.
template <bool F, bool M, int NR>
void launch_random(const DfimConst& k, uint2 key, int n, int n_steps, const float* const* in,
                   float* const* out, cudaStream_t st) {
  const RolloutOut o = {out[6], out[7], out[8], out[9], out[10], out[11]};
  if (k.flag[DF_ALL_CONST]) {
    dfim_rollout_random_kernel<F, M, NR><<<blocks(n), kThreads, 0, st>>>(
        k, key, n, n_steps, dfim_in_planes(in), dfim_out_planes(out), o);
    return;
  }
  constexpr int bytes = ring_bytes<DfimRing>(dfim_ring_words<F, NR>());
  if (bytes > 48 * 1024) {
    cudaFuncSetAttribute(dfim_rollout_ws_kernel<F, M, NR>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  }
  dfim_rollout_ws_kernel<F, M, NR><<<(n + kRingEnvs - 1) / kRingEnvs, DfimRing::kThreads, bytes,
                                     st>>>(k, key, n, n_steps, dfim_in_planes(in),
                                           dfim_out_planes(out), o);
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

// The random rollout's ring for the instance and loop of these flags
// (draw_ring.cuh's RingLayout), or RL_DESIGN 1 and the rest zero where the
// launch runs one thread per env (constant references);
// cudaErrorInvalidValue for flags no instance serves.
int dfim_ring_layout(const int* flags, int* out) {
  if (dfim_random_index(flags) < 0) return (int)cudaErrorInvalidValue;
  if (flags[DF_ALL_CONST]) {
    ring_layout_one_thread(1, out);
    return 0;
  }
  ring_layout<DfimRing>((flags[DF_FINITE] ? 1 : 6) + kRefWords * flags[DF_NREF], out);
  return 0;
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
