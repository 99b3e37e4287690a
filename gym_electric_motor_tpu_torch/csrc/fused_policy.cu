// Policy-in-the-loop Finite-CC-PMSM kernels for Hopper (sm_90a): the
// 2-layer tanh MLP of policy_step.cuh picks each step's B6 action inside
// the kernel, over the PMSM step of pmsm_step.cuh.  Plain C interface for
// ctypes; every function returns cudaGetLastError().
//
// Replaces (gym_electric_motor_tpu/ops/pallas_policy.py):
//   policy_rollout    make_fused_policy_rollout (:268): reducing rollout,
//                     categorical or greedy, Wiener or constant references
//   policy_record     make_fused_policy_record_rollout (:477): the PPO
//                     collection engine, every step recorded
//   reinforce_rollout make_fused_reinforce_rollout (:747): the rollout with
//                     the policy gradient accumulated from eligibility traces
//   reinforce_reduce  the same call's reduction of the per-env gradient
//                     sums to the (P, 128) block, lane = env mod 128
//
// Design: one thread per env, the drive and reference state in registers
// across an in-kernel T loop (`#pragma unroll 1`, so one iteration is one
// step for tools/sass_ops.py).  H is a template parameter (8, 16, 32): every
// loop over features, hidden units and actions unrolls, so the hidden layer
// and the logits live in registers.  The weights (F*H + H + 8*H + 8 floats,
// 2080 B at F = 7, H = 32) change every training iteration, so they come as
// a device pointer and each block stages them into shared memory once; all
// threads then read one address at a time (a broadcast).  Random bits are
// Philox4x32-10 keyed by the seed and counted by (env, step, slot):
// the action uniform and the Box-Muller pair of the policy kernels are the
// words of SLOT_STEP, REINFORCE's 8 Gumbel uniforms and 2 Box-Muller pairs
// have slots of their own (policy_step.cuh).  Built with -fmad=false, as
// fused_pmsm.cu, so that each multiply and add rounds as in the plain
// version.
//
// What bounds them on this card: the reducing rollout moves only the
// initial and final state, so it is bound by its operations per step: the
// MLP (F*H + 8*H multiply-adds, as separate FMUL and FADD), H tanhf and, in
// categorical mode, 8 expf, beside the PMSM step; tools/sass_ops.py counts
// them from the SASS.  The recorder adds 32 B of stores per env-step.
// REINFORCE keeps two traces of P = 6H + H + 8H + 8 floats per env (e and
// G), which one thread cannot hold in registers.  The launch splits the
// roles (reinforce_split.cuh): step warps run the envs' steps and pass each
// env-step's H + 17 words (observation, logits, action, adv, geff, hidden
// layer) through a shared-memory ring to trace warps, which take the score
// and its backward pass and hold each env's e in registers and G in shared
// memory for the whole launch, as the TPU kernel holds them in VMEM
// scratch; G is written once, to acc [P, n], at the end.  The bytes the function must move
// (inputs once, outputs once, acc included) are far fewer than its
// operations need, so its bound_ms is set by the operations, its FP32 work.
// The one-thread kernel, which kept e and G as [P, n] tensors in global
// memory and read and wrote both at every step (16 P bytes per env-step),
// is built for the count of that work and never launched.  The reduction
// reads G once, in a fixed order with no atomics, so a rerun gives the same
// bits.
//
// policy_record at PPO's width.  PPO collects 2048 envs: one thread per env
// is 16 blocks on 16 of the card's 132 SMs, one warp per scheduler, each
// thread working through the MLP's long per-env chain (520 shared-memory
// loads, 480 multiply-adds, 32 tanhf a step), at 1.7% of the bound of its
// own work (PERF.md).  On lane groups (policy_lanes.cuh) G lanes of a warp
// serve one env: a lane computes H / G hidden units and 8 / G logits,
// gathering the hidden values by __shfl_sync in the plain version's order.
// At PPO's width G = 8 and lane 0 of a group samples and steps the env and
// passes the results on; 2048 envs are then 128 blocks on 128 SMs.  With
// more envs the launch takes four lanes an env, each of them stepping,
// then one thread per env (record_lanes), where lane groups would issue
// the per-env step G times over on a full card.  Every design equals the
// plain version bit for bit.  The one-thread kernel stays the count of the
// function's own work for the bound.
//
// policy_rollout on a ring.  At 16384 envs one thread per env is one warp a
// scheduler, and each step put the Philox call, the Box-Muller pair's
// logf, sqrtf, cosf and sinf and the divergent regeneration and reset
// draws on the MLP's thread.  With Wiener references the rollout is
// warp-specialised (ring_pipe.cuh, pmsm_ring.cuh): two producer warps per
// consumer warp draw, in a double-buffered ring of K = 8 steps a slot, the
// action uniform, both references' draws and their candidate lengths,
// sigmas and reset values (9 words a step, 8 greedy); the consumer warps
// run the observation, the MLP, the sample, the PMSM step and the
// reference update by selects, one thread per env.  The consumers hold b1
// and the first rows of w1 (112 floats at H 16, all of layer 1) in
// registers across the step loop, with a register budget of 200 that
// setmaxnreg raises from the launch's 168 while the producers lower
// theirs to 56; layer 2 and the rest of w1 stay in shared memory behind
// the compiler barrier, read as 16-byte vectors (mlp_forward_vec).  The
// parent's scalar reads were already merged into LDS.128 by ptxas (62
// shared-memory loads a step at H 16), so the gain is the loads taken off
// the step, not wider ones.  With constant references the rollout stays one
// thread per env (greedy at H 8 and 16 in mlp_forward_vec's loop order,
// const_vec).  One producer warp per consumer warp, K = 4, a ring without
// the held weights and mlp_forward's loop order with them were slower
// (PERF.md, slice 16).
#include <cuda_runtime.h>

#include <type_traits>

#include "pmsm_ring.cuh"
#include "policy_lanes.cuh"
#include "reinforce_split.cuh"

namespace {

constexpr int kThreads = 128;

template <int H, bool kGreedy, bool kWiener, bool kVec>
__global__ void __launch_bounds__(kThreads)
policy_rollout_kernel(PmsmConst k, PolicyConst q, uint2 key, int n, int n_steps,
                      const float* __restrict__ w1, const float* __restrict__ b1,
                      const float* __restrict__ w2, const float* __restrict__ b2,
                      const float* __restrict__ i_sd0, const float* __restrict__ i_sq0,
                      const float* __restrict__ eps0, const float* __restrict__ ref_d,
                      const float* __restrict__ ref_q, float* __restrict__ out_isd,
                      float* __restrict__ out_isq, float* __restrict__ out_eps,
                      float* __restrict__ out_reward, float* __restrict__ out_terms) {
  __shared__ __align__(16) float sw[MlpLayout<6, H>::N];
  stage_weights<6, H>(sw, w1, b1, w2, b2);
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  PmsmEnv st;
  st.i_sd = i_sd0[e];
  st.i_sq = i_sq0[e];
  st.eps = eps0[e];
  if (kWiener) {
    pmsm_init(k, key, (uint32_t)e, st);
  } else {
    st.c = cosf(st.eps);
    st.s = sinf(st.eps);
    st.rv_d = ref_d[e];
    st.rv_q = ref_q[e];
  }
  float reward = 0.0f, terms = 0.0f;
#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) {
    compiler_barrier();
    float obs[6], h[H], logit[kActions];
    policy_obs6(k, q, st, obs);
    if constexpr (kVec) {
      mlp_forward_vec<6, H, 0>(sw, MlpHeld<H, 0>{}, obs, h, logit);
    } else {
      mlp_forward<6, H>(sw, obs, h, logit);
    }
    uint4 w = make_uint4(0u, 0u, 0u, 0u);
    if (!kGreedy || kWiener) w = pmsm_draw(key, (uint32_t)e, (uint32_t)t, SLOT_STEP);
    const int action = kGreedy ? argmax8(logit) : sample_inverse_cdf(logit, uniform24(w.x));
    const PmsmStepOut o = pmsm_action_step(k, action, st);
    reward += o.reward;
    terms += o.done;
    if (kWiener) wiener_advance_pair(k, key, (uint32_t)e, (uint32_t)t, w, o.done != 0.0f, st);
  }
  out_isd[e] = st.i_sd;
  out_isq[e] = st.i_sq;
  out_eps[e] = st.eps;
  out_reward[e] = reward;
  out_terms[e] = terms;
}

// One consumer step of the warp-specialised rollout: policy_rollout_kernel's
// Wiener step with the step's draws taken from the ring (pmsm_ring.cuh) and
// layer 1's weights from registers (mlp_forward_vec over MlpHeld).
template <int H, bool kGreedy, int NROW>
__device__ __forceinline__ void policy_ring_step(const PmsmConst& k, const PolicyConst& q,
                                                 const float* sw, const MlpHeld<H, NROW>& held,
                                                 const PmsmDraws& d, PmsmEnv& st, float& reward,
                                                 float& terms) {
  compiler_barrier();
  float obs[6], h[H], logit[kActions];
  policy_obs6(k, q, st, obs);
  mlp_forward_vec<6, H, NROW>(sw, held, obs, h, logit);
  const int action = kGreedy ? argmax8(logit) : sample_inverse_cdf(logit, d.u);
  const PmsmStepOut o = pmsm_action_step(k, action, st);
  reward += o.reward;
  terms += o.done;
  pmsm_advance_candidates(k, d.c, o.done != 0.0f, st);
}

// The ring of the evaluation rollout: K = 8 steps a slot, two producer
// warps per consumer warp (one was slower at H 8, 32 and greedy, PERF.md).
using PolicyRing = RingShape<8, 2>;

// setmaxnreg budgets (sm_90a) of the two roles: the consumer warpgroup
// raises its threads' registers to kConsumerRegs, enough to hold layer 1
// (mlp_held_rows) beside the step, the producer warpgroups lower theirs to
// kProducerRegs.  The launch allocates 168 a thread (__launch_bounds__ of
// one block an SM), so the consumers' raise always finds the registers the
// producers gave back.
constexpr int kProducerRegs = 56;
constexpr int kConsumerRegs = 200;

// The evaluation rollout with Wiener references, warp-specialised
// (ring_pipe.cuh, pmsm_ring.cuh): producer warps draw each step's action
// uniform, Box-Muller pair and reference candidates into the ring,
// consumer warps run policy_ring_step, one thread per env, with b1 and the
// first rows of w1 in registers across the step loop.  Each role's branch
// runs to its own end, so that the two never reconverge (setmaxnreg
// requires it).
template <int H, bool kGreedy>
__global__ void __launch_bounds__(PolicyRing::kThreads, 1)
policy_rollout_ws_kernel(PmsmConst k, PolicyConst q, uint2 key, int n, int n_steps,
                         const float* __restrict__ w1, const float* __restrict__ b1,
                         const float* __restrict__ w2, const float* __restrict__ b2,
                         const float* __restrict__ i_sd0, const float* __restrict__ i_sq0,
                         const float* __restrict__ eps0, float* __restrict__ out_isd,
                         float* __restrict__ out_isq, float* __restrict__ out_eps,
                         float* __restrict__ out_reward, float* __restrict__ out_terms) {
  constexpr int W = pmsm_ring_words<!kGreedy>();
  constexpr int NROW = mlp_held_rows<6, H>();
  extern __shared__ uint32_t ring[];
  __shared__ __align__(16) float sw[MlpLayout<6, H>::N];
  stage_weights<6, H>(sw, w1, b1, w2, b2);
  const RingThread th = ring_thread(n);
  const int e = th.e;
  const RingPipe<PolicyRing> pipe(n_steps);
  const RingView<W> v{ring + th.le};
  if (th.consumer) {
    ring_regs_inc<kConsumerRegs>();
    const MlpHeld<H, NROW> held = mlp_hold<6, H, NROW>(sw);
    PmsmEnv st;
    st.i_sd = i_sd0[e];
    st.i_sq = i_sq0[e];
    st.eps = eps0[e];
    pmsm_init(k, key, (uint32_t)e, st);
    float reward = 0.0f, terms = 0.0f;
    ring_consume(pipe, v, n_steps, [&](const RingWords<W>& w) {
      policy_ring_step<H, kGreedy, NROW>(k, q, sw, held, pmsm_draws_unpack<!kGreedy>(w), st,
                                         reward, terms);
    });
    if (th.live) {
      out_isd[e] = st.i_sd;
      out_isq[e] = st.i_sq;
      out_eps[e] = st.eps;
      out_reward[e] = reward;
      out_terms[e] = terms;
    }
  } else {
    ring_regs_dec<kProducerRegs>();
    ring_produce(pipe, v, th.part, [&](uint32_t t, bool, float&) {
      return pmsm_draws_pack<!kGreedy>(pmsm_draws(k, key, (uint32_t)e, t));
    });
  }
}

// Categorical, Wiener references; the 7-feature observation takes the
// angle as the rotation's (cos, sin) (pallas_policy.py:378-380).
template <int H>
__global__ void __launch_bounds__(kThreads)
policy_record_kernel(PmsmConst k, PolicyConst q, uint2 key, int n, int n_steps,
                     const float* __restrict__ w1, const float* __restrict__ b1,
                     const float* __restrict__ w2, const float* __restrict__ b2,
                     const float* __restrict__ i_sd0, const float* __restrict__ i_sq0,
                     const float* __restrict__ eps0, float* __restrict__ out_isd,
                     float* __restrict__ out_isq, float* __restrict__ out_eps,
                     float* __restrict__ out_refd, float* __restrict__ out_refq,
                     int* __restrict__ out_act, float* __restrict__ out_reward,
                     float* __restrict__ out_done) {
  __shared__ __align__(16) float sw[MlpLayout<7, H>::N];
  stage_weights<7, H>(sw, w1, b1, w2, b2);
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  PmsmEnv st;
  st.i_sd = i_sd0[e];
  st.i_sq = i_sq0[e];
  st.eps = eps0[e];
  pmsm_init(k, key, (uint32_t)e, st);
#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) {
    compiler_barrier();
    const float obs[7] = {q.v[Q_OMEGA_N], st.i_sd * k.v[C_INV_I_LIM], st.i_sq * k.v[C_INV_I_LIM],
                          st.c, st.s, st.rv_d, st.rv_q};
    float h[H], logit[kActions];
    mlp_forward<7, H>(sw, obs, h, logit);
    const uint4 w = pmsm_draw(key, (uint32_t)e, (uint32_t)t, SLOT_STEP);
    const PmsmStepOut o = pmsm_action_step(k, sample_inverse_cdf(logit, uniform24(w.x)), st);
    wiener_advance_pair(k, key, (uint32_t)e, (uint32_t)t, w, o.done != 0.0f, st);
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

// policy_record on lane groups: G lanes of a warp serve one env
// (policy_lanes.cuh), a block 128 / G envs.  Per step a lane computes H / G
// hidden units and 8 / G logits; every lane of the group then samples and
// steps the env on the same 8 logits and words, or with kLead lane 0 alone
// does and passes the results on.  Lane p % G stores recorded plane p, so
// a step costs a lane 8 / G stores.
template <int H, int G, bool kLead>
__global__ void __launch_bounds__(kThreads)
policy_record_lanes_kernel(PmsmConst k, PolicyConst q, uint2 key, int n, int n_steps,
                           const float* __restrict__ w1, const float* __restrict__ b1,
                           const float* __restrict__ w2, const float* __restrict__ b2,
                           const float* __restrict__ i_sd0, const float* __restrict__ i_sq0,
                           const float* __restrict__ eps0, RecordPlanes out) {
  constexpr int AL = kRecordPlanes / G;  // planes a lane stores
  __shared__ __align__(16) float sw[MlpLayout<7, H>::N];
  stage_weights<7, H>(sw, w1, b1, w2, b2);
  // a group past the last env steps env n - 1 and stores nothing, so that
  // every lane of the warp takes part in each shuffle
  const int ge = (int)((blockIdx.x * blockDim.x + threadIdx.x) / G);
  const bool live = ge < n;
  const int e = live ? ge : n - 1;
  const int l = (int)(threadIdx.x % G);
  uint32_t* dst[AL];
#pragma unroll
  for (int i = 0; i < AL; ++i) dst[i] = record_plane(l + G * i, out);
  PmsmEnv st;
  st.i_sd = i_sd0[e];
  st.i_sq = i_sq0[e];
  st.eps = eps0[e];
  pmsm_init(k, key, (uint32_t)e, st);
#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) {
    compiler_barrier();
    const float obs[7] = {q.v[Q_OMEGA_N], st.i_sd * k.v[C_INV_I_LIM], st.i_sq * k.v[C_INV_I_LIM],
                          st.c, st.s, st.rv_d, st.rv_q};
    float logit[kActions];
    mlp_forward_lanes<H, G>(sw, obs, l, logit);
    PmsmStepOut o = {};
    if (!kLead || l == 0) {
      const uint4 w = pmsm_draw(key, (uint32_t)e, (uint32_t)t, SLOT_STEP);
      o = pmsm_action_step(k, sample_inverse_cdf(logit, uniform24(w.x)), st);
      wiener_advance_pair(k, key, (uint32_t)e, (uint32_t)t, w, o.done != 0.0f, st);
    }
    if (kLead) share_lead(G, st, o);
    const uint32_t v[kRecordPlanes] = {
        __float_as_uint(st.i_sd),  __float_as_uint(st.i_sq),  __float_as_uint(st.eps),
        __float_as_uint(o.ref_d),  __float_as_uint(o.ref_q),  (uint32_t)o.action,
        __float_as_uint(o.reward), __float_as_uint(o.done)};
    const size_t idx = (size_t)t * n + e;
#pragma unroll
    for (int i = 0; i < AL; ++i) {
      if (live) dst[i][idx] = record_value(l + G * i, v);
    }
  }
}

// REINFORCE with the backward pass in the loop (pallas_policy.py:613-722),
// one thread per env: the step of reinforce_split.cuh, then per
// parameter p, e = gamma * (1 - reset_{t-1}) * e + g and G += (r - baseline)
// * e, then the reference advance.  The baseline is one float on the device
// (a trainer updates it there, without a round trip to the host); `trace`
// and `acc` are [P, n] scratch.  Built for tools/sass_ops.py's count of the
// function's own work at H 16 (categorical, Wiener) and never launched:
// reinforce_rollout runs reinforce_split_kernel.
template <int H, bool kGreedy, bool kWiener>
__global__ void __launch_bounds__(kThreads)
reinforce_rollout_kernel(PmsmConst k, PolicyConst q, uint2 key, int n, int n_steps, float gamma,
                         const float* __restrict__ baseline_p, const float* __restrict__ w1,
                         const float* __restrict__ b1, const float* __restrict__ w2,
                         const float* __restrict__ b2, const float* __restrict__ i_sd0,
                         const float* __restrict__ i_sq0, const float* __restrict__ eps0,
                         const float* __restrict__ ref_d, const float* __restrict__ ref_q,
                         float* __restrict__ out_isd, float* __restrict__ out_isq,
                         float* __restrict__ out_eps, float* __restrict__ out_reward,
                         float* __restrict__ out_terms, float* __restrict__ trace,
                         float* __restrict__ acc) {
  using L = MlpLayout<6, H>;
  constexpr int F = 6;
  constexpr int P = L::N;
  __shared__ __align__(16) float sw[P];
  stage_weights<F, H>(sw, w1, b1, w2, b2);
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float* __restrict__ et = trace + e;
  float* __restrict__ gt = acc + e;
  const size_t stride = (size_t)n;
#pragma unroll 8
  for (int p = 0; p < P; ++p) {
    et[p * stride] = 0.0f;
    gt[p * stride] = 0.0f;
  }
  PmsmEnv st;
  st.i_sd = i_sd0[e];
  st.i_sq = i_sq0[e];
  st.eps = eps0[e];
  if (kWiener) {
    wiener_init(k, key, (uint32_t)e, st);
  } else {
    st.rv_d = ref_d[e];
    st.rv_q = ref_q[e];
  }
  const float baseline = *baseline_p;
  float reward_sum = 0.0f, terms = 0.0f, viol_prev = 0.0f;
#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) {
    compiler_barrier();
    float obs[F], h[H], logit[kActions], dlogit[kActions], dpre[H];
    const int action = reinforce_act<H, kGreedy>(k, q, key, (uint32_t)e, (uint32_t)t, sw, st, obs,
                                                 h, logit);
    reinforce_score(logit, action, dlogit);
#pragma unroll
    for (int j = 0; j < H; ++j) dpre[j] = reinforce_dpre<H>(sw, j, h[j], dlogit);
    const PmsmStepOut o = reinforce_physics(k, action, st);
    reward_sum += o.reward;
    terms += o.done;

    // eligibility traces and the gradient sums, parameter by parameter in
    // the packing order [w1 (f*H + j) | b1 | w2 (j*8 + a) | b2]
    const float geff = gamma * (1.0f - viol_prev);
    const float adv = o.reward - baseline;
    float* __restrict__ ep = reinterpret_cast<float*>(opaque64(reinterpret_cast<uintptr_t>(et)));
    float* __restrict__ gp = reinterpret_cast<float*>(opaque64(reinterpret_cast<uintptr_t>(gt)));
    const size_t s = opaque64(stride);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      float gv;
      if (p < L::B1) {
        gv = obs[p / H] * dpre[p % H];
      } else if (p < L::W2) {
        gv = dpre[p - L::B1];
      } else if (p < L::B2) {
        gv = h[(p - L::W2) / kActions] * dlogit[(p - L::W2) % kActions];
      } else {
        gv = dlogit[p - L::B2];
      }
      const float ev = *ep * geff + gv;
      *ep = ev;
      *gp = *gp + adv * ev;
      ep += s;
      gp += s;
    }
    viol_prev = o.done;

    if (kWiener) reinforce_wiener(k, key, (uint32_t)e, (uint32_t)t, o.done != 0.0f, st);
  }
  out_isd[e] = st.i_sd;
  out_isq[e] = st.i_sq;
  out_eps[e] = st.eps;
  out_reward[e] = reward_sum;
  out_terms[e] = terms;
}

// The role-split rollout (reinforce_split.cuh): the block's first SW warps
// step its 32 SW envs and write each step's observation, hidden layer,
// logits, action, adv and geff into the ring; the other warps, T per step
// warp, each take the score and its backward pass for their hidden units
// and keep their share of the envs' traces and sums.  Each role's branch
// runs to its own end, so that the two never reconverge (setmaxnreg
// requires it).  A lane past the last env steps env n - 1 and stores
// nothing.
template <int H, bool kGreedy, bool kWiener>
__global__ void __launch_bounds__(ReinforceRing<H>::kThreads, ReinforceRing<H>::kMinBlocks)
reinforce_split_kernel(PmsmConst k, PolicyConst q, uint2 key, int n, int n_steps, float gamma,
                       const float* __restrict__ baseline_p, const float* __restrict__ w1,
                       const float* __restrict__ b1, const float* __restrict__ w2,
                       const float* __restrict__ b2, const float* __restrict__ i_sd0,
                       const float* __restrict__ i_sq0, const float* __restrict__ eps0,
                       const float* __restrict__ ref_d, const float* __restrict__ ref_q,
                       float* __restrict__ out_isd, float* __restrict__ out_isq,
                       float* __restrict__ out_eps, float* __restrict__ out_reward,
                       float* __restrict__ out_terms, float* __restrict__ acc) {
  using RR = ReinforceRing<H>;
  using L = MlpLayout<6, H>;
  constexpr int K = RR::K, W = RR::W, E = RR::kEnvs;
  extern __shared__ float rf_ring[];
  __shared__ __align__(16) float sw[L::N];
  stage_weights<6, H>(sw, w1, b1, w2, b2);
  constexpr int SW = RR::kStepWarps;
  const int warp = (int)threadIdx.x / 32;
  const int lane = (int)threadIdx.x % 32;
  // a step warp's envs, or a trace warp's: env-warp s, share w
  const bool stepper = warp < SW;
  const int w = stepper ? 0 : (warp - SW) / SW;
  const int le = (stepper ? warp : (warp - SW) % SW) * 32 + lane;   // env in the block
  const int ge = (int)blockIdx.x * E + le;
  const bool live = ge < n;
  const int e = live ? ge : n - 1;
  const RingPipe<RR> pipe(n_steps);
  float* col = rf_ring + le;   // word j of ring position p at col[(p W + j) E]

  if (stepper) {
    if constexpr (RR::kSetMaxNReg) ring_regs_dec<kStepRegs>();
    PmsmEnv st;
    st.i_sd = i_sd0[e];
    st.i_sq = i_sq0[e];
    st.eps = eps0[e];
    if (kWiener) {
      wiener_init(k, key, (uint32_t)e, st);
    } else {
      st.rv_d = ref_d[e];
      st.rv_q = ref_q[e];
    }
    const float baseline = *baseline_p;
    float reward_sum = 0.0f, terms = 0.0f, viol_prev = 0.0f;
#pragma unroll 1
    for (int t = 0; t < n_steps; ++t) {
      if ((t & (K - 1)) == 0) pipe.producer_acquire(t / K);
      compiler_barrier();
      float obs[6], h[H], logit[kActions];
      const int action = reinforce_act<H, kGreedy>(k, q, key, (uint32_t)e, (uint32_t)t, sw, st,
                                                   obs, h, logit);
      const PmsmStepOut o = reinforce_physics(k, action, st);
      reward_sum += o.reward;
      terms += o.done;
      float* dst = col + (t & (2 * K - 1)) * W * E;
#pragma unroll
      for (int f = 0; f < 6; ++f) dst[(RW_OBS + f) * E] = obs[f];
#pragma unroll
      for (int a = 0; a < kActions; ++a) dst[(RW_LOGIT + a) * E] = logit[a];
      dst[RW_ACTION * E] = __int_as_float(action);
      dst[RW_ADV * E] = o.reward - baseline;
      dst[RW_GEFF * E] = gamma * (1.0f - viol_prev);
#pragma unroll
      for (int j = 0; j < H; ++j) dst[(RW_H + j) * E] = h[j];
      if ((t & (K - 1)) == K - 1 || t == n_steps - 1) pipe.producer_commit(t / K);
      viol_prev = o.done;
      if (kWiener) reinforce_wiener(k, key, (uint32_t)e, (uint32_t)t, o.done != 0.0f, st);
    }
    if (live) {
      out_isd[e] = st.i_sd;
      out_isq[e] = st.i_sq;
      out_eps[e] = st.eps;
      out_reward[e] = reward_sum;
      out_terms[e] = terms;
    }
    return;
  }

  // a trace warp: units j = w + T m, b2 entries a = w + T m; its e in
  // registers, its G in shared memory after the ring (slot r at gsh[r E])
  if constexpr (RR::kSetMaxNReg) ring_regs_inc<kTraceRegs>();
  constexpr int T = RR::T, NU = RR::kUnits, NB = RR::kB2, PU = 6 + 1 + kActions;
  float ev[RR::kOwn];
  float* gsh = rf_ring + RR::kRingFloats + w * RR::kOwn * E + le;
#pragma unroll
  for (int i = 0; i < RR::kOwn; ++i) {
    ev[i] = 0.0f;
    gsh[i * E] = 0.0f;
  }
  const float* hw = col + (RW_H + w) * E;   // h[w] at ring position 0
#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) {
    pipe.consumer_wait(t);
    const int pos = (t & (2 * K - 1)) * W * E;
    const float* src = col + pos;
    float obs[6], logit[kActions], h[NU];
#pragma unroll
    for (int f = 0; f < 6; ++f) obs[f] = src[(RW_OBS + f) * E];
#pragma unroll
    for (int a = 0; a < kActions; ++a) logit[a] = src[(RW_LOGIT + a) * E];
    const int action = __float_as_int(src[RW_ACTION * E]);
    const float adv = src[RW_ADV * E];
    const float geff = src[RW_GEFF * E];
#pragma unroll
    for (int m = 0; m < NU; ++m) h[m] = hw[pos + T * m * E];
    pipe.consumer_release(t);
    float dlogit[kActions];
    reinforce_score(logit, action, dlogit);
#pragma unroll
    for (int m = 0; m < NU; ++m) {
      const float dpre = reinforce_dpre<H>(sw, w + T * m, h[m], dlogit);
#pragma unroll
      for (int f = 0; f < 6; ++f) {
        trace_update<E>(ev, gsh, m * PU + f, geff, adv, obs[f] * dpre);
      }
      trace_update<E>(ev, gsh, m * PU + 6, geff, adv, dpre);
#pragma unroll
      for (int a = 0; a < kActions; ++a) {
        trace_update<E>(ev, gsh, m * PU + 7 + a, geff, adv, h[m] * dlogit[a]);
      }
    }
#pragma unroll
    for (int m = 0; m < NB; ++m) {
      float g = dlogit[0];   // dlogit[w + T m], taken by selects
#pragma unroll
      for (int a = 1; a < kActions; ++a) g = a == w + T * m ? dlogit[a] : g;
      trace_update<E>(ev, gsh, NU * PU + m, geff, adv, g);
    }
  }
  if (!live) return;
  float* out = acc + e;
  const size_t s = (size_t)n;
#pragma unroll
  for (int m = 0; m < NU; ++m) {
    const int j = w + T * m;
#pragma unroll
    for (int f = 0; f < 6; ++f) {
      out[(size_t)(L::W1 + f * H + j) * s] = gsh[(m * PU + f) * E];
    }
    out[(size_t)(L::B1 + j) * s] = gsh[(m * PU + 6) * E];
#pragma unroll
    for (int a = 0; a < kActions; ++a) {
      out[(size_t)(L::W2 + j * kActions + a) * s] = gsh[(m * PU + 7 + a) * E];
    }
  }
#pragma unroll
  for (int m = 0; m < NB; ++m) {
    out[(size_t)(L::B2 + w + T * m) * s] = gsh[(NU * PU + m) * E];
  }
}

// out[p, lane] = sum over r of acc[p, r * 128 + lane], r ascending: one
// thread per (p, lane), a warp reads 128 contiguous bytes per r.
__global__ void __launch_bounds__(kThreads)
reinforce_reduce_kernel(int n, int n_params, const float* __restrict__ acc,
                        float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_params * 128) return;
  const float* g = acc + (size_t)(i / 128) * n + (i % 128);
  float s = g[0];
  const int rows = n / 128;
#pragma unroll 1
  for (int r = 1; r < rows; ++r) s = s + g[(size_t)r * 128];
  out[i] = s;
}

PmsmConst load_const(const float* host) {
  PmsmConst k;
  for (int i = 0; i < N_PMSM_CONST; ++i) k.v[i] = host[i];
  return k;
}

PolicyConst load_policy_const(const float* host) {
  PolicyConst q;
  for (int i = 0; i < N_POLICY_CONST; ++i) q.v[i] = host[N_PMSM_CONST + i];
  return q;
}

uint2 seed_key(unsigned long long seed) {
  return make_uint2((uint32_t)(seed & 0xFFFFFFFFull), (uint32_t)(seed >> 32));
}

int blocks(int n) { return (n + kThreads - 1) / kThreads; }

// Calls fn(std::integral_constant<int, H>) for an instantiated H (8, 16
// or 32); returns false for any other.
template <typename Fn>
bool with_hidden(int hidden, Fn&& fn) {
  switch (hidden) {
    case 8: fn(std::integral_constant<int, 8>{}); return true;
    case 16: fn(std::integral_constant<int, 16>{}); return true;
    case 32: fn(std::integral_constant<int, 32>{}); return true;
    default: return false;
  }
}

// The SMs of the current device, read once per device.
int device_sms() {
  static int sms[16] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 16) return 0;
  if (sms[dev] == 0) cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  return sms[dev];
}

// The lanes an env of policy_record's launch over n envs: eight (lane 0
// stepping) while that launch puts at most one block on each SM, four
// (every lane stepping) while that one puts at most three, else one thread
// per env.  Measured at H 32 and 256 steps on an H100 (PERF.md, §5 slice
// 14): at 2048 envs (128 blocks) eight lanes with lane 0 stepping took
// 0.39 of one thread's time, every lane stepping 0.47, four lanes 0.47; at
// 4096 to 12288 envs (128 to 384 blocks) four lanes were the fastest
// design; at 16384 one thread per env already puts a block on 128 of the
// SMs and lane groups issue the per-env step G times over (four lanes took
// 1.01 times its time, eight 1.49).
int record_lanes(int n) {
  const long long sms = device_sms();
  if ((long long)blocks(n) * 8 <= sms) return 8;
  if ((long long)blocks(n) * 4 <= 3 * sms) return 4;
  return 1;
}

template <int H, int G, bool kLead>
void launch_record_lanes(PmsmConst k, PolicyConst q, uint2 key, int n, int n_steps,
                         const float* w1, const float* b1, const float* w2, const float* b2,
                         const float* i_sd0, const float* i_sq0, const float* eps0,
                         const RecordPlanes& out, cudaStream_t s) {
  const long long threads = (long long)n * G;
  policy_record_lanes_kernel<H, G, kLead><<<(int)((threads + kThreads - 1) / kThreads), kThreads,
                                            0, s>>>(k, q, key, n, n_steps, w1, b1, w2, b2, i_sd0,
                                                    i_sq0, eps0, out);
}

// With constant references policy_rollout runs one thread per env; greedy
// at H 8 and 16 in mlp_forward_vec's loop order (kVec), which ran 4% to 6%
// faster there and 0.5% to 4.6% slower in every other constant-reference
// instance (PERF.md, slice 16).
template <int H, bool kGreedy>
constexpr bool const_vec() {
  return kGreedy && H < 32;
}

// The one-thread instances that read the weights in mlp_forward's order,
// never launched at H 16 with Wiener references or greedy: tools/sass_ops.py
// counts their step, the function's own work, for the bound.
template __global__ void policy_rollout_kernel<16, false, true, false>(
    PmsmConst, PolicyConst, uint2, int, int, const float*, const float*, const float*,
    const float*, const float*, const float*, const float*, const float*, const float*, float*,
    float*, float*, float*, float*);
template __global__ void policy_rollout_kernel<16, true, false, false>(
    PmsmConst, PolicyConst, uint2, int, int, const float*, const float*, const float*,
    const float*, const float*, const float*, const float*, const float*, const float*, float*,
    float*, float*, float*, float*);
template __global__ void reinforce_rollout_kernel<16, false, true>(
    PmsmConst, PolicyConst, uint2, int, int, float, const float*, const float*, const float*,
    const float*, const float*, const float*, const float*, const float*, const float*,
    const float*, float*, float*, float*, float*, float*, float*, float*);

}  // namespace

extern "C" {

int policy_n_const() { return N_PMSM_CONST + N_POLICY_CONST; }


const char* gemx_policy_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

int policy_rollout(const float* consts, unsigned long long seed, int n, int n_steps, int hidden,
                   int greedy, int wiener, const float* w1, const float* b1, const float* w2,
                   const float* b2, const float* i_sd0, const float* i_sq0, const float* eps0,
                   const float* ref_d, const float* ref_q, float* out_isd, float* out_isq,
                   float* out_eps, float* out_reward, float* out_terms, void* stream) {
  const PmsmConst k = load_const(consts);
  const PolicyConst q = load_policy_const(consts);
  const uint2 key = seed_key(seed);
  cudaStream_t s = (cudaStream_t)stream;
  const bool ok = with_hidden(hidden, [&](auto hc) {
    constexpr int H = decltype(hc)::value;
    auto launch = [&](auto gc) {
      constexpr bool G = decltype(gc)::value;
      if (wiener) {
        constexpr int bytes = ring_bytes<PolicyRing>(pmsm_ring_words<!G>());
        if (bytes > 48 * 1024) {
          cudaFuncSetAttribute(policy_rollout_ws_kernel<H, G>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
        }
        policy_rollout_ws_kernel<H, G><<<(n + kRingEnvs - 1) / kRingEnvs, PolicyRing::kThreads,
                                         bytes, s>>>(k, q, key, n, n_steps, w1, b1, w2, b2, i_sd0,
                                                     i_sq0, eps0, out_isd, out_isq, out_eps,
                                                     out_reward, out_terms);
      } else {
        policy_rollout_kernel<H, G, false, const_vec<H, G>()><<<blocks(n), kThreads, 0, s>>>(
            k, q, key, n, n_steps, w1, b1, w2, b2, i_sd0, i_sq0, eps0, ref_d, ref_q, out_isd,
            out_isq, out_eps, out_reward, out_terms);
      }
    };
    if (greedy) {
      launch(std::true_type{});
    } else {
      launch(std::false_type{});
    }
  });
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// policy_rollout's launch for these modes: ring_pipe.cuh's RingLayout of
// its ring with Wiener references, RL_DESIGN 1 and the rest zero with
// constant ones (one thread per env); then the consumer and producer
// threads' register budgets (setmaxnreg), or zeros.
int policy_rollout_layout(int hidden, int greedy, int wiener, int* out) {
  if (hidden != 8 && hidden != 16 && hidden != 32) return (int)cudaErrorInvalidValue;
  if (wiener) {
    ring_layout<PolicyRing>(greedy ? pmsm_ring_words<false>() : pmsm_ring_words<true>(), out);
  } else {
    ring_layout_one_thread(1, out);
  }
  out[N_RING_LAYOUT] = wiener ? kConsumerRegs : 0;
  out[N_RING_LAYOUT + 1] = wiener ? kProducerRegs : 0;
  return 0;
}

int policy_record(const float* consts, unsigned long long seed, int n, int n_steps, int hidden,
                  const float* w1, const float* b1, const float* w2, const float* b2,
                  const float* i_sd0, const float* i_sq0, const float* eps0, float* out_isd,
                  float* out_isq, float* out_eps, float* out_refd, float* out_refq, int* out_act,
                  float* out_reward, float* out_done, void* stream) {
  const PmsmConst k = load_const(consts);
  const PolicyConst q = load_policy_const(consts);
  const uint2 key = seed_key(seed);
  cudaStream_t s = (cudaStream_t)stream;
  const int g = record_lanes(n);
  float* planes[kRecordPlanes] = {out_isd, out_isq, out_eps, out_refd, out_refq,
                                  reinterpret_cast<float*>(out_act), out_reward, out_done};
  RecordPlanes out;
  for (int j = 0; j < kRecordPlanes; ++j) out.p[j] = reinterpret_cast<uint32_t*>(planes[j]);
  const bool ok = with_hidden(hidden, [&](auto hc) {
    constexpr int H = decltype(hc)::value;
    if (g == 8) {
      launch_record_lanes<H, 8, true>(k, q, key, n, n_steps, w1, b1, w2, b2, i_sd0, i_sq0, eps0,
                                      out, s);
    } else if (g == 4) {
      launch_record_lanes<H, 4, false>(k, q, key, n, n_steps, w1, b1, w2, b2, i_sd0, i_sq0, eps0,
                                       out, s);
    } else {
      policy_record_kernel<H><<<blocks(n), kThreads, 0, s>>>(
          k, q, key, n, n_steps, w1, b1, w2, b2, i_sd0, i_sq0, eps0, out_isd, out_isq, out_eps,
          out_refd, out_refq, out_act, out_reward, out_done);
    }
  });
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// The launch of policy_record over n envs on the current device: out =
// (lanes an env, lane 0 alone stepping, blocks of kThreads, the card's SMs).
int policy_record_layout(int n, int* out) {
  const int g = record_lanes(n);
  out[0] = g;
  out[1] = g == 8;
  out[2] = (int)(((long long)n * g + kThreads - 1) / kThreads);
  out[3] = device_sms();
  return 0;
}

// acc: the [P, n] per-env gradient sums, written once at the end.
int reinforce_rollout(const float* consts, unsigned long long seed, int n, int n_steps,
                      int hidden, int greedy, int wiener, float gamma, const float* baseline,
                      const float* w1, const float* b1, const float* w2, const float* b2,
                      const float* i_sd0, const float* i_sq0, const float* eps0,
                      const float* ref_d, const float* ref_q, float* out_isd, float* out_isq,
                      float* out_eps, float* out_reward, float* out_terms, float* acc,
                      void* stream) {
  const PmsmConst k = load_const(consts);
  const PolicyConst q = load_policy_const(consts);
  const uint2 key = seed_key(seed);
  cudaStream_t s = (cudaStream_t)stream;
  const bool ok = with_hidden(hidden, [&](auto hc) {
    constexpr int H = decltype(hc)::value;
    using RR = ReinforceRing<H>;
    auto launch = [&](auto kernel) {
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, RR::kBytes);
      kernel<<<(n + RR::kEnvs - 1) / RR::kEnvs, RR::kThreads, RR::kBytes, s>>>(
          k, q, key, n, n_steps, gamma, baseline, w1, b1, w2, b2, i_sd0, i_sq0, eps0, ref_d,
          ref_q, out_isd, out_isq, out_eps, out_reward, out_terms, acc);
    };
    if (greedy) {
      if (wiener) launch(reinforce_split_kernel<H, true, true>);
      else launch(reinforce_split_kernel<H, true, false>);
    } else {
      if (wiener) launch(reinforce_split_kernel<H, false, true>);
      else launch(reinforce_split_kernel<H, false, false>);
    }
  });
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// reinforce_rollout's role split at H (reinforce_split.cuh): out = (trace
// warps per step warp, K steps a ring slot, words a step, shared-memory
// bytes of the ring and of G in it, threads a block, envs a block,
// parameters a trace thread owns, blocks an SM the registers must allow,
// the step and trace warps' setmaxnreg budgets or zeros).
int reinforce_shape(int hidden, int* out) {
  const bool ok = with_hidden(hidden, [&](auto hc) {
    using RR = ReinforceRing<decltype(hc)::value>;
    const int v[] = {RR::T,        RR::K,     RR::W,    RR::kBytes,
                     RR::kThreads, RR::kEnvs, RR::kOwn, RR::kMinBlocks,
                     RR::kSetMaxNReg ? kStepRegs : 0, RR::kSetMaxNReg ? kTraceRegs : 0};
    for (int i = 0; i < 10; ++i) out[i] = v[i];
  });
  return ok ? 0 : (int)cudaErrorInvalidValue;
}

int reinforce_reduce(int n, int n_params, const float* acc, float* out, void* stream) {
  reinforce_reduce_kernel<<<blocks(n_params * 128), kThreads, 0, (cudaStream_t)stream>>>(
      n, n_params, acc, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
