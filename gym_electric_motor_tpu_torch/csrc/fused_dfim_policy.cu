// The universal policy-in-the-loop recorder of the DFIM family (the six
// {Finite, Cont} x {CC, TC, SC} DFIM ids) for Hopper (sm_90a), with a plain
// C interface for ctypes (every function returns cudaGetLastError()).
//
// Replaces (gym_electric_motor_tpu/ops/):
//   dfim_policy_record  pallas_policy.py  make_fused_policy_record_universal (:1256),
//                                         for the DFIM family
//
// Design: as fused_sync_policy.cu, over dfim_action_step (dfim_step.cuh).
// The observation is omega, the stator currents over their limit, the
// rotor fluxes over l_m i_lim, the rotation's (cos, sin), the referenced
// quantities of the pre-step state (the dq currents at the pre-step flux
// direction, which the step's reward takes too) and the references.
// Finite: the stator's and the rotor's 8-way B6 heads, or one 64-way joint
// head; continuous: six squashed-Gaussian duties (three Box-Muller pairs,
// the third from the POLICY_B slot).  Templates FINITE, MECH, NREF and
// JOINT (8 instances as dfim_record_random's, and 4 joint ones); H at run
// time; built with -fmad=false.
//
// What bounds it on this card: beside the step's operations (see
// fused_dfim.cu), the MLP's F H + H A multiplies and adds (A up to 64), H
// tanhf and, finite, 16 or 64 expf; 4 bytes per signal and env-step of HBM
// writes.
//
// At PPO's width.  Fused PPO collects 2048 envs: one thread per env is 16
// blocks of 128 threads on 16 of the card's 132 SMs, each thread working
// through its MLP (864 multiply-adds a step on Finite-CC-DFIM at H 32, 2400
// with the joint head) and a step with two bridges on its own chain.  On
// lane groups, as the EESM family's recorder (fused_eesm_policy.cu, over
// policy_heads_lanes.cuh), G lanes of a warp serve one env and lane p % G
// stores recorded plane p; a lead design passes lane 0's state, the
// constant-speed rotation, the references, reward, done and the two heads
// or six raw samples on to the group, and every lane takes the pre-step
// flux direction itself.  The joint head's 64 logits stay with the lanes
// that sum them (joint_sample_lanes), so that no lane holds all 64.  The
// launch takes the family's wide design while the one-thread launch would
// put at most one block on each SM, its narrow one while it would put at
// most three, else one thread per env (policy_width).  Every design equals
// the one-thread kernel bit for bit; the one-thread kernel stays
// tools/sass_ops.py's count of the function's own work.
#include <cuda_runtime.h>

#include "dfim_step.cuh"
#include "policy_heads.cuh"
#include "policy_heads_lanes.cuh"

namespace {

constexpr int kStateSlots = 6;  // (omega or NULL, i_salpha, i_sbeta, psi_ralpha, psi_rbeta, eps)

template <bool FINITE, int NREF, bool JOINT>
struct Shape {
  static constexpr int F = 7 + 2 * NREF;
  static constexpr int NC = 6;
  static constexpr int A = !FINITE ? NC : (JOINT ? 64 : 16);
};

template <bool FINITE, bool MECH, int NREF, bool JOINT, bool WIENER>
__device__ __forceinline__ void policy_loop(const DfimConst& k, const PolicyConst& q,
                                            const float* sw, uint2 key, int e, int n,
                                            int n_steps, DfimState& x, float& c, float& s,
                                            RefRows<NREF>& refs, const DfimPlanes& so,
                                            const PolicyOut& o) {
  using S = Shape<FINITE, NREF, JOINT>;
  const float* std = sw + S::F * q.h + q.h + q.h * S::A + S::A;
#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) {
    policy_barrier();
    float fc = 1.0f, fs = 0.0f;
    if (k.flag[DF_NEEDS_DQ]) dfim_flux_dir(k, x, fc, fs);
    if (MECH) {
      c = cosf(x.eps);
      s = sinf(x.eps);
    }
    float obs[S::F];
    obs[0] = MECH ? x.w * q.feat[0] : q.feat[0];
    obs[1] = x.isa * q.feat[1];
    obs[2] = x.isb * q.feat[2];
    obs[3] = x.psa * q.feat[3];
    obs[4] = x.psb * q.feat[4];
    obs[5] = c;
    obs[6] = s;
#pragma unroll
    for (int r = 0; r < NREF; ++r) {
      obs[7 + r] = dfim_quantity(k, r, x, fc, fs);
      obs[7 + NREF + r] = refs.rv[r];
    }
    float logit[S::A];
    policy_mlp<S::F, S::A>(sw, obs, q.h, S::A, logit);
    const PolicyDraw d = policy_draw<FINITE ? (JOINT ? 1 : 2) : 6>(key, (uint32_t)e, (uint32_t)t);
    int heads[kPolicyMaxHeads] = {0, 0, 0};
    float raw[S::NC], duty[S::NC];
#pragma unroll
    for (int j = 0; j < S::NC; ++j) raw[j] = duty[j] = 0.0f;
    DfimAction act;
    if constexpr (FINITE) {
      policy_heads<2, 8, 8, 1, JOINT>(logit, 8, d, heads);
      act.s.bits = heads[0];
      act.r.bits = heads[1];
      act.s.a = act.s.b = act.s.c = act.r.a = act.r.b = act.r.c = 0.0f;
    } else {
      policy_gaussian<S::NC>(logit, std, q, d, k.ref.two_pi, k.ref.u_min, raw, duty);
      act.s.bits = act.r.bits = 0;
      act.s.a = duty[0];
      act.s.b = duty[1];
      act.s.c = duty[2];
      act.r.a = duty[3];
      act.r.b = duty[4];
      act.r.c = duty[5];
    }
    const uint4 w = WIENER ? drive_draw(key, (uint32_t)e, (uint32_t)t, DRIVE_SLOT_STEP)
                           : make_uint4(0u, 0u, 0u, 0u);
    const DfimStepOut r = dfim_action_step<FINITE, MECH, NREF>(k, act, x, c, s, fc, fs, refs);
    if (WIENER) {
      ref_wiener_advance<NREF>(k.ref, key, (uint32_t)e, (uint32_t)t, w, r.done != 0.0f, refs);
    }
    const size_t i = (size_t)t * n + e;
    dfim_store_state<MECH>(x, so, i);
    policy_store_common<NREF>(o, i, r.ref, r.reward, r.done);
    policy_store_actions<FINITE, 2, S::NC>(o, i, heads, raw);
  }
}

template <bool FINITE, bool MECH, int NREF, bool JOINT>
__global__ void __launch_bounds__(kPolicyThreads)
dfim_policy_record_kernel(DfimConst k, PolicyConst q, uint2 key, int n, int n_steps,
                          PolicyWeights w, DfimInPlanes in, DfimPlanes so, PolicyOut o) {
  using S = Shape<FINITE, NREF, JOINT>;
  extern __shared__ __align__(16) float sw[];
  policy_stage(sw, S::F, q.h, S::A, FINITE ? 0 : S::NC, w);
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  DfimState x = dfim_load_state<MECH>(in, e);
  float c = 1.0f, s = 0.0f;
  if (!MECH) {
    c = cosf(x.eps);
    s = sinf(x.eps);
  }
  RefRows<NREF> refs;
  ref_wiener_init<NREF>(k.ref, key, (uint32_t)e, refs);
  if (k.flag[DF_ALL_CONST]) {
    policy_loop<FINITE, MECH, NREF, JOINT, false>(k, q, sw, key, e, n, n_steps, x, c, s, refs,
                                                  so, o);
  } else {
    policy_loop<FINITE, MECH, NREF, JOINT, true>(k, q, sw, key, e, n, n_steps, x, c, s, refs,
                                                 so, o);
  }
}

// ---- the lane-group recorder --------------------------------------------

// The designs of the width rule, the fastest of G in {4, 8} x lead or every
// lane at 2048 and 4096 envs x 256 steps, H 32 (PERF.md, slice 27): eight
// lanes, every lane stepping, at both widths (at 2048 envs on
// Finite-CC-DFIM, its joint head, Cont-CC- and Cont-SC-DFIM 0.5344,
// 0.8435, 0.7327 and 0.7638 ms against 0.5443, 0.8835, 0.7553 and 0.7712
// with lane 0 stepping and 0.80 to 1.24 on four lanes; 2.874 against
// 2.954 ms in sum at 2048 envs, 3.193 against 3.275 at 4096).  So the
// narrow design is the wide one, for the joint table too (its lane
// instances take 146 to 151 registers and spill none).
// ops/fused_policy.py's DFIM_POLICY_WIDE and DFIM_POLICY_NARROW mirror
// them.
using WideDesign = LaneDesign<8, false>;
using NarrowDesign = LaneDesign<8, false>;

// The recorded planes of an instance, in the order of dfim_policy_record's
// outputs: [omega,] i_salpha, i_sbeta, psi_ralpha, psi_rbeta, eps, the
// references, the two heads' actions (finite) or the six channels' raw
// samples, reward and done.
template <bool FINITE, bool MECH, int NREF>
__host__ __device__ constexpr int dfim_policy_planes() {
  return (MECH ? 1 : 0) + 5 + NREF + (FINITE ? 2 : 6) + 2;
}

// The MLP's N joint logits on a group of G lanes, each held by one lane:
// acc[i] is logit a = l + G i.  The body of policy_mlp_lanes
// (policy_heads_lanes.cuh) without its last step, the broadcast of every
// logit to every lane; a copy and not a shared function, so that the four
// other families' lane kernels compile exactly as they did (routed
// through a shared slot function, their SASS changed).
template <int F, int N, int G>
__device__ __forceinline__ void joint_mlp_lanes(const float* sw, const float (&obs)[F], int H,
                                                int l, float (&acc)[N / G]) {
  static_assert(N % G == 0, "the joint logits fill the lanes' slots");
  constexpr int HL = (kPolicyMaxHidden + G - 1) / G;   // hidden slots of a lane
  constexpr int AL = N / G;                            // logit slots of a lane
  const float* w1 = sw;
  const float* b1 = w1 + F * H;
  const float* w2 = b1 + H;
  const float* b2 = w2 + H * N;
  float h[HL];
#pragma unroll
  for (int m = 0; m < HL; ++m) {
    const int j = l + G * m;
    float v = 0.0f;
    if (j < H) {
      float z = b1[j];
#pragma unroll
      for (int f = 0; f < F; ++f) z = z + w1[f * H + j] * obs[f];
      v = tanhf(z);
    }
    h[m] = v;
  }
#pragma unroll
  for (int i = 0; i < AL; ++i) acc[i] = b2[l + G * i];
#pragma unroll
  for (int j = 0; j < kPolicyMaxHidden; ++j) {
    const float hj = __shfl_sync(kPolicyWarpMask, h[j / G], j % G, G);
    if (j < H) {
#pragma unroll
      for (int i = 0; i < AL; ++i) acc[i] = acc[i] + w2[j * N + l + G * i] * hj;
    }
  }
}

// The joint head's sample (policy_sample over N logits) on a group of G
// lanes, each lane holding logits a = l + G i in acc[i]
// (joint_mlp_lanes): the maximum by a butterfly of fmaxf (the same
// value in any order; where only the sign of a zero maximum differs,
// logit - max is the same), each lane's exps, then one chain that adds the
// exps in index order, shuffled from their lanes, as the one-thread sum
// does, each lane keeping the partial sums below its own logits; the
// action, the last a with u * total >= the sum below a, is the largest of
// the lanes' own.  Every lane returns it.
template <int N, int G>
__device__ __forceinline__ int joint_sample_lanes(const float (&acc)[N / G], int l, float u) {
  static_assert(N % G == 0, "the joint logits fill the lanes' slots");
  constexpr int AL = N / G;
  float m = acc[0];
#pragma unroll
  for (int i = 1; i < AL; ++i) m = fmaxf(m, acc[i]);
#pragma unroll
  for (int o = G / 2; o > 0; o /= 2) m = fmaxf(m, __shfl_xor_sync(kPolicyWarpMask, m, o, G));
  float es[AL], below[AL];
#pragma unroll
  for (int i = 0; i < AL; ++i) {
    es[i] = expf(acc[i] - m);
    below[i] = 0.0f;
  }
  float total = 0.0f;
#pragma unroll
  for (int a = 0; a < N; ++a) {
    const float ea = __shfl_sync(kPolicyWarpMask, es[a / G], a % G, G);
    below[a / G] = l == a % G ? total : below[a / G];
    total = a == 0 ? ea : total + ea;
  }
  const float uu = u * total;
  int action = 0;
#pragma unroll
  for (int i = 0; i < AL; ++i) {
    const int a = l + G * i;
    if (a >= 1 && uu >= below[i]) action = a;
  }
#pragma unroll
  for (int o = G / 2; o > 0; o /= 2) {
    action = max(action, __shfl_xor_sync(kPolicyWarpMask, action, o, G));
  }
  return action;
}

template <bool FINITE, bool MECH, int NREF, bool JOINT, int G, bool LEAD, bool WIENER>
__device__ __forceinline__ void policy_lanes_loop(const DfimConst& k, const PolicyConst& q,
                                                  const float* sw, uint2 key, int e, int l,
                                                  bool live, int n, int n_steps, DfimState& x,
                                                  float& c, float& s, RefRows<NREF>& refs,
                                                  uint32_t* const* dst) {
  using S = Shape<FINITE, NREF, JOINT>;
  constexpr int NP = dfim_policy_planes<FINITE, MECH, NREF>();
  constexpr int PL = (NP + G - 1) / G;  // planes a lane stores
  const float* std = sw + S::F * q.h + q.h + q.h * S::A + S::A;
#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) {
    policy_barrier();
    float fc = 1.0f, fs = 0.0f;
    if (k.flag[DF_NEEDS_DQ]) dfim_flux_dir(k, x, fc, fs);
    if (MECH) {
      c = cosf(x.eps);
      s = sinf(x.eps);
    }
    float obs[S::F];
    obs[0] = MECH ? x.w * q.feat[0] : q.feat[0];
    obs[1] = x.isa * q.feat[1];
    obs[2] = x.isb * q.feat[2];
    obs[3] = x.psa * q.feat[3];
    obs[4] = x.psb * q.feat[4];
    obs[5] = c;
    obs[6] = s;
#pragma unroll
    for (int r = 0; r < NREF; ++r) {
      obs[7 + r] = dfim_quantity(k, r, x, fc, fs);
      obs[7 + NREF + r] = refs.rv[r];
    }
    float logit[S::A];
    int heads[kPolicyMaxHeads] = {0, 0, 0};
    if constexpr (JOINT) {
      // every lane of the group takes part in the joint sample
      float acc[S::A / G];
      joint_mlp_lanes<S::F, S::A, G>(sw, obs, q.h, l, acc);
      const int j =
          joint_sample_lanes<S::A, G>(acc, l, policy_draw<1>(key, (uint32_t)e, (uint32_t)t).u[0]);
      heads[1] = j % 8;
      heads[0] = j / 8;
    } else {
      policy_mlp_lanes<S::F, S::A, G>(sw, obs, q.h, S::A, l, logit);
    }
    float raw[S::NC], duty[S::NC];
#pragma unroll
    for (int j = 0; j < S::NC; ++j) raw[j] = duty[j] = 0.0f;
    float ref[NREF], reward = 0.0f, done = 0.0f;
#pragma unroll
    for (int r = 0; r < NREF; ++r) ref[r] = 0.0f;
    if (!LEAD || l == 0) {
      DfimAction act;
      if constexpr (FINITE) {
        if constexpr (!JOINT) {
          policy_heads<2, 8, 8, 1, false>(logit, 8, policy_draw<2>(key, (uint32_t)e, (uint32_t)t),
                                          heads);
        }
        act.s.bits = heads[0];
        act.r.bits = heads[1];
        act.s.a = act.s.b = act.s.c = act.r.a = act.r.b = act.r.c = 0.0f;
      } else {
        policy_gaussian<S::NC>(logit, std, q, policy_draw<6>(key, (uint32_t)e, (uint32_t)t),
                               k.ref.two_pi, k.ref.u_min, raw, duty);
        act.s.bits = act.r.bits = 0;
        act.s.a = duty[0];
        act.s.b = duty[1];
        act.s.c = duty[2];
        act.r.a = duty[3];
        act.r.b = duty[4];
        act.r.c = duty[5];
      }
      const uint4 w = WIENER ? drive_draw(key, (uint32_t)e, (uint32_t)t, DRIVE_SLOT_STEP)
                             : make_uint4(0u, 0u, 0u, 0u);
      const DfimStepOut r = dfim_action_step<FINITE, MECH, NREF>(k, act, x, c, s, fc, fs, refs);
      if (WIENER) {
        ref_wiener_advance<NREF>(k.ref, key, (uint32_t)e, (uint32_t)t, w, r.done != 0.0f, refs);
      }
#pragma unroll
      for (int j = 0; j < NREF; ++j) ref[j] = r.ref[j];
      reward = r.reward;
      done = r.done;
    }
    if constexpr (LEAD) {
      // lane 0's step to the group: the state, the constant-speed rotation
      // and the references the next observation reads, and the values the
      // lanes store (a joint head's actions every lane has already)
      if (MECH) x.w = lead_float(x.w, G);
      x.isa = lead_float(x.isa, G);
      x.isb = lead_float(x.isb, G);
      x.psa = lead_float(x.psa, G);
      x.psb = lead_float(x.psb, G);
      x.eps = lead_float(x.eps, G);
      if (!MECH) {
        c = lead_float(c, G);
        s = lead_float(s, G);
      }
#pragma unroll
      for (int r = 0; r < NREF; ++r) {
        refs.rv[r] = lead_float(refs.rv[r], G);
        ref[r] = lead_float(ref[r], G);
      }
      reward = lead_float(reward, G);
      done = lead_float(done, G);
      if constexpr (FINITE && !JOINT) {
        heads[0] = lead_int(heads[0], G);
        heads[1] = lead_int(heads[1], G);
      } else if constexpr (!FINITE) {
#pragma unroll
        for (int j = 0; j < S::NC; ++j) raw[j] = lead_float(raw[j], G);
      }
    }
    uint32_t v[NP];
    int j = 0;
    if (MECH) v[j++] = __float_as_uint(x.w);
    v[j++] = __float_as_uint(x.isa);
    v[j++] = __float_as_uint(x.isb);
    v[j++] = __float_as_uint(x.psa);
    v[j++] = __float_as_uint(x.psb);
    v[j++] = __float_as_uint(x.eps);
#pragma unroll
    for (int r = 0; r < NREF; ++r) v[j++] = __float_as_uint(ref[r]);
    if constexpr (FINITE) {
      v[j++] = (uint32_t)heads[0];
      v[j++] = (uint32_t)heads[1];
    } else {
#pragma unroll
      for (int a = 0; a < S::NC; ++a) v[j++] = __float_as_uint(raw[a]);
    }
    v[j++] = __float_as_uint(reward);
    v[j] = __float_as_uint(done);
    const size_t i = (size_t)t * n + e;
#pragma unroll
    for (int m = 0; m < PL; ++m) {
      const int p = l + G * m;
      if (live && p < NP) dst[m][i] = lane_value<NP>(p, v);
    }
  }
}

// dfim_policy_record on lane groups: G lanes of a warp serve one env, a
// block 128 / G envs, lane 0 alone stepping (LEAD) or every lane; a group
// past the last env steps env n - 1 and stores nothing, so that every lane
// of the warp takes part in each shuffle.
template <bool FINITE, bool MECH, int NREF, bool JOINT, int G, bool LEAD>
__global__ void __launch_bounds__(kPolicyThreads, kPolicyLaneBlocksPerSm)
dfim_policy_record_lanes_kernel(DfimConst k, PolicyConst q, uint2 key, int n, int n_steps,
                                PolicyWeights w, DfimInPlanes in, DfimPlanes so, PolicyOut o) {
  using S = Shape<FINITE, NREF, JOINT>;
  constexpr int NP = dfim_policy_planes<FINITE, MECH, NREF>();
  constexpr int PL = (NP + G - 1) / G;
  extern __shared__ __align__(16) float sw[];
  policy_stage(sw, S::F, q.h, S::A, FINITE ? 0 : S::NC, w);
  const int ge = (int)((blockIdx.x * blockDim.x + threadIdx.x) / G);
  const bool live = ge < n;
  const int e = live ? ge : n - 1;
  const int l = (int)(threadIdx.x % G);
  uint32_t* planes[NP];
  int j = 0;
#pragma unroll
  for (int p = MECH ? 0 : 1; p < kStateSlots; ++p) {
    planes[j++] = reinterpret_cast<uint32_t*>(so.p[p]);
  }
#pragma unroll
  for (int r = 0; r < NREF; ++r) planes[j++] = reinterpret_cast<uint32_t*>(o.ref[r]);
  if constexpr (FINITE) {
    planes[j++] = reinterpret_cast<uint32_t*>(o.act_i[0]);
    planes[j++] = reinterpret_cast<uint32_t*>(o.act_i[1]);
  } else {
#pragma unroll
    for (int a = 0; a < S::NC; ++a) planes[j++] = reinterpret_cast<uint32_t*>(o.act_f[a]);
  }
  planes[j++] = reinterpret_cast<uint32_t*>(o.reward);
  planes[j] = reinterpret_cast<uint32_t*>(o.done);
  uint32_t* dst[PL];
#pragma unroll
  for (int m = 0; m < PL; ++m) dst[m] = lane_plane<NP>(l + G * m, planes);
  DfimState x = dfim_load_state<MECH>(in, e);
  float c = 1.0f, s = 0.0f;
  if (!MECH) {
    c = cosf(x.eps);
    s = sinf(x.eps);
  }
  RefRows<NREF> refs;
  ref_wiener_init<NREF>(k.ref, key, (uint32_t)e, refs);
  if (k.flag[DF_ALL_CONST]) {
    policy_lanes_loop<FINITE, MECH, NREF, JOINT, G, LEAD, false>(k, q, sw, key, e, l, live, n,
                                                                 n_steps, x, c, s, refs, dst);
  } else {
    policy_lanes_loop<FINITE, MECH, NREF, JOINT, G, LEAD, true>(k, q, sw, key, e, l, live, n,
                                                                n_steps, x, c, s, refs, dst);
  }
}

// ---- the launch --------------------------------------------------------

using LaunchFn = PolicyDesignFn<DfimConst>;

template <bool F, bool M, int NR, bool J>
void launch(const DfimConst& k, const PolicyConst& q, uint2 key, int n, int n_steps,
            const PolicyWeights& w, const float* const* in, void* const* out, const PolicyOut& o,
            cudaStream_t st, int design) {
  using S = Shape<F, NR, J>;
  const PolicyWidth d =
      design == 1 ? kPolicyOneThread : policy_width<WideDesign, NarrowDesign>(n);
  if (d == kPolicyWide) {
    policy_launch(dfim_policy_record_lanes_kernel<F, M, NR, J, WideDesign::G, WideDesign::LEAD>,
                  S::F, F ? 0 : S::NC, k, q, key, n, n_steps, w, in, out, o, st, WideDesign::G);
  } else if (d == kPolicyNarrow) {
    policy_launch(
        dfim_policy_record_lanes_kernel<F, M, NR, J, NarrowDesign::G, NarrowDesign::LEAD>, S::F,
        F ? 0 : S::NC, k, q, key, n, n_steps, w, in, out, o, st, NarrowDesign::G);
  } else {
    policy_launch(dfim_policy_record_kernel<F, M, NR, J>, S::F, F ? 0 : S::NC, k, q, key, n,
                  n_steps, w, in, out, o, st);
  }
}

// indexed by dfim_random_index(); the joint table by its finite half
const LaunchFn kLaunch[8] = {launch<false, false, 1, false>, launch<false, false, 2, false>,
                             launch<false, true, 1, false>,  launch<false, true, 2, false>,
                             launch<true, false, 1, false>,  launch<true, false, 2, false>,
                             launch<true, true, 1, false>,   launch<true, true, 2, false>};
const LaunchFn kLaunchJoint[4] = {launch<true, false, 1, true>, launch<true, false, 2, true>,
                                  launch<true, true, 1, true>, launch<true, true, 2, true>};

}  // namespace

extern "C" {

POLICY_C_INFO(dfim, N_DFIM_CONST, N_DFIM_FLAG)

// The recorder in a given design (0: the width rule at n, as
// dfim_policy_record; 1: one thread per env, the design a full card takes),
// for the tests and tools that hold the designs against each other.
int dfim_policy_record_design(const float* consts, const int* flags, const float* pk,
                              const int* pi, unsigned long long seed, int n, int n_steps,
                              int hidden, const float* w1, const float* b1, const float* w2,
                              const float* b2, const float* ls, const float* const* in,
                              void* const* out, int design, void* stream) {
  const int idx = dfim_random_index(flags);
  const int finite = flags[DF_FINITE] != 0, joint = pi[1 + kPolicyMaxHeads] != 0;
  const bool ok = idx >= 0 && pi[0] == (finite ? 2 : 0) && !(joint && !finite);
  const LaunchFn fn = !ok ? nullptr : joint ? kLaunchJoint[idx - 4] : kLaunch[idx];
  const int n_out = !finite ? 6 : (joint ? 64 : 16);
  return policy_design_call(fn, dfim_load_const(consts, flags), pk, pi, seed, n, n_steps, hidden,
                            n_out, {w1, b1, w2, b2, ls}, in, out, kStateSlots, design, stream);
}

// As sync_policy_record; in: (omega or NULL, i_salpha, i_sbeta,
// psi_ralpha, psi_rbeta, eps); out: those six planes, then the PolicyOut
// planes, each (T, N).  Runs on lane groups or one thread per env by the
// width rule (policy_width).
int dfim_policy_record(const float* consts, const int* flags, const float* pk, const int* pi,
                       unsigned long long seed, int n, int n_steps, int hidden, const float* w1,
                       const float* b1, const float* w2, const float* b2, const float* ls,
                       const float* const* in, void* const* out, void* stream) {
  return dfim_policy_record_design(consts, flags, pk, pi, seed, n, n_steps, hidden, w1, b1, w2,
                                   b2, ls, in, out, 0, stream);
}

// The launch of dfim_policy_record over n envs on the current device: out =
// (lanes an env, lane 0 alone stepping, blocks of kPolicyThreads, the
// card's SMs).
int dfim_policy_layout(int n, int* out) {
  policy_layout<WideDesign, NarrowDesign>(n, out);
  return 0;
}

}  // extern "C"
