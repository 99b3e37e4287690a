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
// Design: one thread per env, the whole drive and reference state in
// registers across an in-kernel loop over T steps; the TPU's (R, 128)
// planes are one flat array of N envs here, and the recorders store
// [t, env] so that a warp writes 128 contiguous bytes per signal and step.
// Random bits come from Philox4x32-10 keyed by the seed and counted by
// (env, step, slot), so the result does not depend on the launch geometry.
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
// so that one loop iteration is one step in the SASS count.
#include <cuda_runtime.h>

#include "pmsm_step.cuh"

namespace {

constexpr int kThreads = 128;

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
  out_isd[e] = st.i_sd;
  out_isq[e] = st.i_sq;
  out_eps[e] = st.eps;
  out_reward[e] = reward;
  out_terms[e] = terms;
  // final Wiener state, (2R, 128) planes: d rows first, then q rows
  out_rv[e] = st.rv_d;
  out_rv[n + e] = st.rv_q;
  out_rk[e] = st.rk_d;
  out_rk[n + e] = st.rk_q;
  out_rl[e] = st.rl_d;
  out_rl[n + e] = st.rl_q;
  out_rs[e] = st.rs_d;
  out_rs[n + e] = st.rs_q;
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

int pmsm_rollout_random(const float* consts, unsigned long long seed, int n, int n_steps,
                        const float* i_sd0, const float* i_sq0, const float* eps0, float* out_isd,
                        float* out_isq, float* out_eps, float* out_reward, float* out_terms,
                        float* out_rv, float* out_rk, float* out_rl, float* out_rs, void* stream) {
  pmsm_rollout_random_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
      load_const(consts), seed_key(seed), n, n_steps, i_sd0, i_sq0, eps0, out_isd, out_isq,
      out_eps, out_reward, out_terms, out_rv, out_rk, out_rl, out_rs);
  return (int)cudaGetLastError();
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

int pmsm_record_random(const float* consts, unsigned long long seed, int n, int n_steps,
                       const float* i_sd0, const float* i_sq0, const float* eps0, float* out_isd,
                       float* out_isq, float* out_eps, float* out_refd, float* out_refq,
                       int* out_act, float* out_reward, float* out_done, void* stream) {
  pmsm_record_random_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
      load_const(consts), seed_key(seed), n, n_steps, i_sd0, i_sq0, eps0, out_isd, out_isq,
      out_eps, out_refd, out_refq, out_act, out_reward, out_done);
  return (int)cudaGetLastError();
}

int pmsm_record_buffer(const float* consts, int n, int n_steps, const float* i_sd0,
                       const float* i_sq0, const float* eps0, const int* actions, float* out_isd,
                       float* out_isq, float* out_eps, void* stream) {
  pmsm_record_buffer_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
      load_const(consts), n, n_steps, i_sd0, i_sq0, eps0, actions, out_isd, out_isq, out_eps);
  return (int)cudaGetLastError();
}

}  // extern "C"
