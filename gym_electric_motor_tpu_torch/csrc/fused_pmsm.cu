// Fused Finite-CC-PMSM / SynRM rollouts for Hopper (sm_90a): four kernels
// over the shared step of pmsm_step.cuh, with a plain C interface for
// ctypes (every function returns cudaGetLastError()).
//
// Replaces (gym_electric_motor_tpu/ops/pallas_sync.py):
//   pmsm_rollout_random  make_fused_pmsm_rollout, random mode (:280)
//   pmsm_rollout_buffer  make_fused_pmsm_rollout, buffer mode (:297)
//   pmsm_record_random   make_fused_pmsm_record_rollout, random mode (:502)
//   pmsm_record_buffer   make_fused_pmsm_record_rollout, buffer mode (:392)
//
// Design: the whole drive and reference state of an env in registers across
// an in-kernel loop over T steps; the TPU's (R, 128) planes are one flat
// array of N envs here, and the recorders store [t, env] so that a warp
// writes 128 contiguous bytes per signal and step.  The random rollout is
// warp-specialised on the shared-memory ring of ring_pipe.cuh: producer
// warps draw, in a double-buffered ring of K steps a slot, what a step
// draws whatever the state (pmsm_ring.cuh's pmsm_draws with the action
// code: the code w.x & 7, both normal draws of the step's Box-Muller pair,
// each reference's candidate length and sigma and its candidate reset
// value, 9 words); consumer warps run the step, one thread per env, and
// take the candidates by selects (pmsm_advance_candidates).  The random
// recorder runs the same producers and consumer step on a ring of its own
// (PmsmRecordRing) and stores each step's signals [t, env].  The one-thread
// random kernels had the Philox calls, the pair's non-fast-math logf,
// sqrtf, cosf and sinf and the PARAMS and RESET redraws on every step's
// chain; they are built for tools/sass_ops.py's count of the function's own
// work and never launched.  The buffer kernels run one thread per env.
// Random bits come from Philox4x32-10 keyed by the seed and counted
// by (env, step, slot), so the result does not depend on the launch
// geometry, and the producers compute each candidate with the one-thread
// step's functions on the same operands, so the two designs are equal bit
// for bit.
// ops/cuda_build.py builds it with -fmad=false: each multiply and add
// rounds on its own, as in the plain PyTorch version, which the kernels
// then track over thousands of steps.
//
// What bounds it on this card: the reducing kernels move only the initial
// and final state (plus 4 bytes of action per env-step in buffer mode), so
// they are compute-bound.  The source's transcendentals per random-mode
// env-step (log, sqrt, cos, sin, rsqrt, and 2 exp where a sub-episode ends)
// compile to 2 MUFU instructions (rsqrt, and the rsqrt inside sqrtf) per
// step: without fast math, logf, sinf and cosf are FP32 polynomials.  So
// the issue pipes bound it, not the SFU: the always-executed step issues
// about 190 FP32 operations (RK4 on the dq currents and the polynomials)
// and about 70 ALU instructions (the Philox call's xors, compares and
// selects), the ALU at half the FP32 rate; tools/sass_ops.py counts them
// from the SASS, and chip_smoke.py takes its bounds from that count.  The
// design keeps the Park rotation incremental (4 multiplies and an rsqrt
// instead of a sin/cos pair), draws the parameter and reset slots only
// where they are used, and needs no memory traffic inside the loop.  At
// the bench size (16384 envs = 512 warps, about 4 per SM) the loop is
// latency-bound: too few warps hide the dependent FP32 and ALU chains.
// The recorders add 32 (random) or 16 (buffer) bytes of HBM traffic per
// env-step and are bound by that.  Every step loop is `#pragma unroll 1`,
// so that one loop iteration is one step in the SASS count.  On the ring
// the producers issue three Philox calls a step (PARAMS and RESET too) and
// the Box-Muller pair, the consumers 9 shared-memory loads; tools/sass_ops.py
// counts both roles beside the one-thread step; the recorder's consumers
// add its 8 stores.
#include <cuda_runtime.h>

#include "pmsm_ring.cuh"

namespace {

constexpr int kThreads = 128;

// The random rollout's outputs: (i_sd, i_sq, eps, reward, terms) and the
// final Wiener state, (2R, 128) planes with the d rows first, then the q
// rows.
struct PmsmOut {
  float *isd, *isq, *eps, *reward, *terms, *rv, *rk, *rl, *rs;

  __device__ __forceinline__ void store(int n, int e, const PmsmEnv& st, float r,
                                        float t) const {
    isd[e] = st.i_sd;
    isq[e] = st.i_sq;
    eps[e] = st.eps;
    reward[e] = r;
    terms[e] = t;
    rv[e] = st.rv_d;
    rv[n + e] = st.rv_q;
    rk[e] = st.rk_d;
    rk[n + e] = st.rk_q;
    rl[e] = st.rl_d;
    rl[n + e] = st.rl_q;
    rs[e] = st.rs_d;
    rs[n + e] = st.rs_q;
  }
};

// The one-thread random rollout: built, never launched; tools/sass_ops.py
// counts its step, the function's own work, for the bound.
__global__ void pmsm_rollout_random_kernel(PmsmConst k, uint2 key, int n, int n_steps,
                                           const float* __restrict__ i_sd0,
                                           const float* __restrict__ i_sq0,
                                           const float* __restrict__ eps0,
                                           float* __restrict__ out_isd, float* __restrict__ out_isq,
                                           float* __restrict__ out_eps, float* __restrict__ out_reward,
                                           float* __restrict__ out_terms, float* __restrict__ out_rv,
                                           float* __restrict__ out_rk, float* __restrict__ out_rl,
                                           float* __restrict__ out_rs) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  PmsmEnv st;
  st.i_sd = i_sd0[e];
  st.i_sq = i_sq0[e];
  st.eps = eps0[e];
  pmsm_init(k, key, (uint32_t)e, st);
  float reward = 0.0f, terms = 0.0f;
#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) {
    const PmsmStepOut o = pmsm_random_step(k, key, (uint32_t)e, (uint32_t)t, st);
    reward += o.reward;
    terms += o.done;
  }
  PmsmOut{out_isd, out_isq, out_eps, out_reward, out_terms, out_rv, out_rk, out_rl, out_rs}
      .store(n, e, st, reward, terms);
}

// ---- the warp-specialised random rollout ------------------------------

// The ring: 8 steps a slot, 2 producer warps per consumer warp, each
// drawing 4 steps of a slot (the fastest of K in {4, 8} x P in {1, 2},
// PERF.md, slice 20); ops/fused_sync.py's PMSM_RING mirrors it.  At 9 words
// a step it holds 72 KB, above the default 48 KB of dynamic shared memory.
using PmsmRing = RingShape<8, 2>;

// Producer warps run pmsm_draws with the action code (9 words a step);
// consumer warps pmsm_action_step and pmsm_advance_candidates, one thread
// per env.
__global__ void __launch_bounds__(PmsmRing::kThreads)
    pmsm_rollout_ws_kernel(PmsmConst k, uint2 key, int n, int n_steps,
                           const float* __restrict__ i_sd0, const float* __restrict__ i_sq0,
                           const float* __restrict__ eps0, PmsmOut out) {
  extern __shared__ uint32_t ring[];
  const RingThread th = ring_thread(n);
  const uint32_t env = (uint32_t)th.e;
  const RingPipe<PmsmRing> pipe(n_steps);
  const RingView<kPmsmActionWords> v{ring + th.le};
  if (!th.consumer) {
    ring_produce(pipe, v, th.part, [&](uint32_t t, bool, float&) {
      return pmsm_action_draws_pack(pmsm_draws(k, key, env, t));
    });
    return;
  }
  PmsmEnv st;
  st.i_sd = i_sd0[th.e];
  st.i_sq = i_sq0[th.e];
  st.eps = eps0[th.e];
  pmsm_init(k, key, env, st);
  float reward = 0.0f, terms = 0.0f;
  ring_consume(pipe, v, n_steps, [&](const RingWords<kPmsmActionWords>& w) {
    const PmsmDraws d = pmsm_action_draws_unpack(w);
    const PmsmStepOut o = pmsm_action_step(k, (int)d.action, st);
    pmsm_advance_candidates(k, d.c, o.done != 0.0f, st);
    reward += o.reward;
    terms += o.done;
  });
  if (th.live) out.store(n, th.e, st, reward, terms);
}

__global__ void pmsm_rollout_buffer_kernel(PmsmConst k, int n, int n_steps,
                                           const float* __restrict__ i_sd0,
                                           const float* __restrict__ i_sq0,
                                           const float* __restrict__ eps0,
                                           const int* __restrict__ actions,
                                           float* __restrict__ out_isd, float* __restrict__ out_isq,
                                           float* __restrict__ out_eps, float* __restrict__ out_reward,
                                           float* __restrict__ out_terms) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float i_sd = i_sd0[e], i_sq = i_sq0[e], eps = eps0[e];
#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) {
    const int a = actions[(size_t)t * n + e];
    pmsm_physics(k, a, cosf(eps), sinf(eps), i_sd, i_sq, eps);
  }
  out_isd[e] = i_sd;
  out_isq[e] = i_sq;
  out_eps[e] = eps;
  out_reward[e] = 0.0f;
  out_terms[e] = 0.0f;
}

// The one-thread random recorder: built, never launched; tools/sass_ops.py
// counts its step, the function's own work, for the bound.
__global__ void pmsm_record_random_kernel(PmsmConst k, uint2 key, int n, int n_steps,
                                          const float* __restrict__ i_sd0,
                                          const float* __restrict__ i_sq0,
                                          const float* __restrict__ eps0,
                                          float* __restrict__ out_isd, float* __restrict__ out_isq,
                                          float* __restrict__ out_eps, float* __restrict__ out_refd,
                                          float* __restrict__ out_refq, int* __restrict__ out_act,
                                          float* __restrict__ out_reward, float* __restrict__ out_done) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  PmsmEnv st;
  st.i_sd = i_sd0[e];
  st.i_sq = i_sq0[e];
  st.eps = eps0[e];
  pmsm_init(k, key, (uint32_t)e, st);
#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) {
    const PmsmStepOut o = pmsm_random_step(k, key, (uint32_t)e, (uint32_t)t, st);
    const size_t i = (size_t)t * n + e;
    out_isd[i] = st.i_sd;
    out_isq[i] = st.i_sq;
    out_eps[i] = st.eps;
    out_refd[i] = o.ref_d;
    out_refq[i] = o.ref_q;
    out_act[i] = o.action;
    out_reward[i] = o.reward;
    out_done[i] = o.done;
  }
}

// ---- the warp-specialised random recorder ------------------------------

// The recorder's planes, each (T, N) stored [t, env].
struct PmsmRecordOut {
  float *isd, *isq, *eps, *refd, *refq;
  int* act;
  float *reward, *done;

  __device__ __forceinline__ void store(size_t i, const PmsmEnv& st,
                                        const PmsmStepOut& o) const {
    isd[i] = st.i_sd;
    isq[i] = st.i_sq;
    eps[i] = st.eps;
    refd[i] = o.ref_d;
    refq[i] = o.ref_q;
    act[i] = o.action;
    reward[i] = o.reward;
    done[i] = o.done;
  }
};

// The recorder's ring: 8 steps a slot, 2 producer warps per consumer warp,
// the fastest of K in {4, 8} x P in {1, 2} at 16384 envs x 1024 steps on
// Finite-CC-PMSM (PERF.md, slice 26; the one-thread recorder 0.4460 ms):
// K = 8, P = 2 0.3586 ms; K = 4, P = 2 0.3759; K = 4, P = 1 0.5136; K = 8,
// P = 1 0.5581 (one producer warp cannot draw three Philox calls and the
// pair for 32 envs as fast as a consumer warp steps and stores them).
// ops/fused_sync.py's PMSM_RECORD_RING mirrors it.  At 9 words a step it
// holds 72 KB, above the default 48 KB of dynamic shared memory.
using PmsmRecordRing = RingShape<8, 2>;

// The random recorder warp-specialised: the rollout's producers
// (pmsm_draws with the action code, 9 words a step); consumer warps run
// pmsm_action_step and pmsm_advance_candidates, one thread per env, and
// store what pmsm_record_random_kernel stores: the post-step state, the
// pre-advance references, the action, the reward and done.
__global__ void __launch_bounds__(PmsmRecordRing::kThreads)
    pmsm_record_ws_kernel(PmsmConst k, uint2 key, int n, int n_steps,
                          const float* __restrict__ i_sd0, const float* __restrict__ i_sq0,
                          const float* __restrict__ eps0, PmsmRecordOut out) {
  extern __shared__ uint32_t ring[];
  const RingThread th = ring_thread(n);
  const uint32_t env = (uint32_t)th.e;
  const RingPipe<PmsmRecordRing> pipe(n_steps);
  const RingView<kPmsmActionWords> v{ring + th.le};
  if (!th.consumer) {
    ring_produce(pipe, v, th.part, [&](uint32_t t, bool, float&) {
      return pmsm_action_draws_pack(pmsm_draws(k, key, env, t));
    });
    return;
  }
  PmsmEnv st;
  st.i_sd = i_sd0[th.e];
  st.i_sq = i_sq0[th.e];
  st.eps = eps0[th.e];
  pmsm_init(k, key, env, st);
  size_t at = (size_t)th.e;   // t n + e at step t
  ring_consume(pipe, v, n_steps, [&](const RingWords<kPmsmActionWords>& w) {
    const PmsmDraws d = pmsm_action_draws_unpack(w);
    const PmsmStepOut o = pmsm_action_step(k, (int)d.action, st);
    pmsm_advance_candidates(k, d.c, o.done != 0.0f, st);
    if (th.live) out.store(at, st, o);
    at += (size_t)n;
  });
}

__global__ void pmsm_record_buffer_kernel(PmsmConst k, int n, int n_steps,
                                          const float* __restrict__ i_sd0,
                                          const float* __restrict__ i_sq0,
                                          const float* __restrict__ eps0,
                                          const int* __restrict__ actions,
                                          float* __restrict__ out_isd, float* __restrict__ out_isq,
                                          float* __restrict__ out_eps) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float i_sd = i_sd0[e], i_sq = i_sq0[e], eps = eps0[e];
#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) {
    const size_t i = (size_t)t * n + e;
    pmsm_physics(k, actions[i], cosf(eps), sinf(eps), i_sd, i_sq, eps);
    out_isd[i] = i_sd;
    out_isq[i] = i_sq;
    out_eps[i] = eps;
  }
}

PmsmConst load_const(const float* host) {
  PmsmConst k;
  for (int i = 0; i < N_PMSM_CONST; ++i) k.v[i] = host[i];
  return k;
}

uint2 seed_key(unsigned long long seed) {
  return make_uint2((uint32_t)(seed & 0xFFFFFFFFull), (uint32_t)(seed >> 32));
}

int blocks(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

extern "C" {

int pmsm_n_const() { return N_PMSM_CONST; }

const char* gemx_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// The random rollout on its ring.
int pmsm_rollout_random(const float* consts, unsigned long long seed, int n, int n_steps,
                        const float* i_sd0, const float* i_sq0, const float* eps0, float* out_isd,
                        float* out_isq, float* out_eps, float* out_reward, float* out_terms,
                        float* out_rv, float* out_rk, float* out_rl, float* out_rs, void* stream) {
  constexpr int bytes = ring_bytes<PmsmRing>(kPmsmActionWords);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        pmsm_rollout_ws_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
  }
  pmsm_rollout_ws_kernel<<<(n + kRingEnvs - 1) / kRingEnvs, PmsmRing::kThreads, bytes,
                           (cudaStream_t)stream>>>(
      load_const(consts), seed_key(seed), n, n_steps, i_sd0, i_sq0, eps0,
      PmsmOut{out_isd, out_isq, out_eps, out_reward, out_terms, out_rv, out_rk, out_rl, out_rs});
  return (int)cudaGetLastError();
}

// The random rollout's ring (ring_pipe.cuh's RingLayout).
int pmsm_ring_layout(int* out) {
  ring_layout<PmsmRing>(kPmsmActionWords, out);
  return 0;
}

int pmsm_rollout_buffer(const float* consts, int n, int n_steps, const float* i_sd0,
                        const float* i_sq0, const float* eps0, const int* actions, float* out_isd,
                        float* out_isq, float* out_eps, float* out_reward, float* out_terms,
                        void* stream) {
  pmsm_rollout_buffer_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
      load_const(consts), n, n_steps, i_sd0, i_sq0, eps0, actions, out_isd, out_isq, out_eps,
      out_reward, out_terms);
  return (int)cudaGetLastError();
}

// The random recorder on its ring.
int pmsm_record_random(const float* consts, unsigned long long seed, int n, int n_steps,
                       const float* i_sd0, const float* i_sq0, const float* eps0, float* out_isd,
                       float* out_isq, float* out_eps, float* out_refd, float* out_refq,
                       int* out_act, float* out_reward, float* out_done, void* stream) {
  constexpr int bytes = ring_bytes<PmsmRecordRing>(kPmsmActionWords);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        pmsm_record_ws_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
  }
  pmsm_record_ws_kernel<<<(n + kRingEnvs - 1) / kRingEnvs, PmsmRecordRing::kThreads, bytes,
                          (cudaStream_t)stream>>>(
      load_const(consts), seed_key(seed), n, n_steps, i_sd0, i_sq0, eps0,
      PmsmRecordOut{out_isd, out_isq, out_eps, out_refd, out_refq, out_act, out_reward,
                    out_done});
  return (int)cudaGetLastError();
}

// The random recorder's ring (ring_pipe.cuh's RingLayout).
int pmsm_record_ring_layout(int* out) {
  ring_layout<PmsmRecordRing>(kPmsmActionWords, out);
  return 0;
}

int pmsm_record_buffer(const float* consts, int n, int n_steps, const float* i_sd0,
                       const float* i_sq0, const float* eps0, const int* actions, float* out_isd,
                       float* out_isq, float* out_eps, void* stream) {
  pmsm_record_buffer_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
      load_const(consts), n, n_steps, i_sd0, i_sq0, eps0, actions, out_isd, out_isq, out_eps);
  return (int)cudaGetLastError();
}

}  // extern "C"
