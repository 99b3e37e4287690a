// The universal policy-in-the-loop recorder of the induction family (the six
// {Finite, Cont} x {CC, TC, SC} SCIM ids) for Hopper (sm_90a), with a plain
// C interface for ctypes (every function returns cudaGetLastError()).
//
// Replaces (gym_electric_motor_tpu/ops/):
//   induction_policy_record  pallas_policy.py  make_fused_policy_record_universal
//                                              (:1256), for the induction family
//
// Design: as fused_sync_policy.cu, over ind_action_step
// (induction_step.cuh).  The observation is omega, the stator currents over
// their limit and the rotor fluxes over l_m i_lim (the stator frame has no
// angle plane), the referenced quantities of the pre-step state (the dq
// currents at the pre-step flux direction, which the step's reward takes
// too) and the references.  One 8-way head for the B6 bits, or three
// squashed-Gaussian duties.  Templates FINITE, MECH, NREF (8 instances), H
// at run time; built with -fmad=false.
//
// What bounds it on this card: beside the step's operations (see
// fused_induction.cu), the MLP's F H + H A multiplies and adds, H tanhf
// and, finite, 8 expf; 4 bytes per signal and env-step of HBM writes.
//
// At PPO's width.  Fused PPO collects 2048 envs: one thread per env is 16
// blocks of 128 threads on 16 of the card's 132 SMs, each thread working
// through its MLP (544 multiply-adds a step on Finite-CC-SCIM at H 32) and
// the step on its own chain.  On lane groups, as the EESM family's recorder
// (fused_eesm_policy.cu, over policy_heads_lanes.cuh), G lanes of a warp
// serve one env and lane p % G stores recorded plane p; a lead design
// passes lane 0's state, the references, reward, done and the head or the
// three raw samples on to the group, and every lane takes the pre-step flux
// direction itself.  The launch takes the family's wide design while the
// one-thread launch would put at most one block on each SM, its narrow one
// while it would put at most three, else one thread per env
// (policy_width).  Every design equals the one-thread kernel bit for bit;
// the one-thread kernel stays tools/sass_ops.py's count of the function's
// own work.
#include <cuda_runtime.h>

#include "induction_step.cuh"
#include "policy_heads.cuh"
#include "policy_heads_lanes.cuh"

namespace {

constexpr int kStateSlots = 5;  // (omega or NULL, i_salpha, i_sbeta, psi_ralpha, psi_rbeta)

template <bool FINITE, int NREF>
struct Shape {
  static constexpr int F = 5 + 2 * NREF;
  static constexpr int NC = 3;
  static constexpr int A = FINITE ? 8 : NC;
};

template <bool FINITE, bool MECH, int NREF, bool WIENER>
__device__ __forceinline__ void policy_loop(const InductionConst& k, const PolicyConst& q,
                                            const float* sw, uint2 key, int e, int n,
                                            int n_steps, InductionState& x, RefRows<NREF>& refs,
                                            const InductionPlanes& so, const PolicyOut& o) {
  using S = Shape<FINITE, NREF>;
  const float* std = sw + S::F * q.h + q.h + q.h * S::A + S::A;
#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) {
    policy_barrier();
    float fc = 1.0f, fs = 0.0f;
    if (k.flag[IF_NEEDS_DQ]) ind_flux_dir(k, x, fc, fs);
    float obs[S::F];
    obs[0] = MECH ? x.w * q.feat[0] : q.feat[0];
    obs[1] = x.isa * q.feat[1];
    obs[2] = x.isb * q.feat[2];
    obs[3] = x.psa * q.feat[3];
    obs[4] = x.psb * q.feat[4];
#pragma unroll
    for (int r = 0; r < NREF; ++r) {
      obs[5 + r] = ind_quantity(k, r, x, fc, fs);
      obs[5 + NREF + r] = refs.rv[r];
    }
    float logit[S::A];
    policy_mlp<S::F, S::A>(sw, obs, q.h, S::A, logit);
    const PolicyDraw d = policy_draw<FINITE ? 1 : 4>(key, (uint32_t)e, (uint32_t)t);
    int heads[kPolicyMaxHeads] = {0, 0, 0};
    float raw[S::NC] = {0.0f, 0.0f, 0.0f}, duty[S::NC] = {0.0f, 0.0f, 0.0f};
    B6Action act;
    if constexpr (FINITE) {
      policy_heads<1, 8, 1, 1, false>(logit, 8, d, heads);
      act.bits = heads[0];
      act.a = act.b = act.c = 0.0f;
    } else {
      policy_gaussian<S::NC>(logit, std, q, d, k.ref.two_pi, k.ref.u_min, raw, duty);
      act.bits = 0;
      act.a = duty[0];
      act.b = duty[1];
      act.c = duty[2];
    }
    const uint4 w = WIENER ? drive_draw(key, (uint32_t)e, (uint32_t)t, DRIVE_SLOT_STEP)
                           : make_uint4(0u, 0u, 0u, 0u);
    const InductionStepOut r = ind_action_step<FINITE, MECH, NREF>(k, act, x, fc, fs, refs);
    if (WIENER) {
      ref_wiener_advance<NREF>(k.ref, key, (uint32_t)e, (uint32_t)t, w, r.done != 0.0f, refs);
    }
    const size_t i = (size_t)t * n + e;
    ind_store_state<MECH>(x, so, i);
    policy_store_common<NREF>(o, i, r.ref, r.reward, r.done);
    policy_store_actions<FINITE, 1, S::NC>(o, i, heads, raw);
  }
}

template <bool FINITE, bool MECH, int NREF>
__global__ void __launch_bounds__(kPolicyThreads)
induction_policy_record_kernel(InductionConst k, PolicyConst q, uint2 key, int n, int n_steps,
                               PolicyWeights w, InductionInPlanes in, InductionPlanes so,
                               PolicyOut o) {
  using S = Shape<FINITE, NREF>;
  extern __shared__ __align__(16) float sw[];
  policy_stage(sw, S::F, q.h, S::A, FINITE ? 0 : S::NC, w);
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  InductionState x = ind_load_state<MECH>(in, e);
  RefRows<NREF> refs;
  ref_wiener_init<NREF>(k.ref, key, (uint32_t)e, refs);
  if (k.flag[IF_ALL_CONST]) {
    policy_loop<FINITE, MECH, NREF, false>(k, q, sw, key, e, n, n_steps, x, refs, so, o);
  } else {
    policy_loop<FINITE, MECH, NREF, true>(k, q, sw, key, e, n, n_steps, x, refs, so, o);
  }
}

// ---- the lane-group recorder --------------------------------------------

// The designs of the width rule, the fastest of G in {4, 8} x lead or every
// lane at 2048 and 4096 envs x 256 steps, H 32 (PERF.md, slice 27): eight
// lanes, every lane stepping, at both widths (over Finite-CC-, Cont-CC- and
// Cont-SC-SCIM 1.449 ms in sum at 2048 envs against 1.485 with lane 0
// stepping and 1.742 and 1.838 on four lanes, 1.682 at 4096 against 1.724,
// 1.743 and 1.838; four lanes, every lane stepping, led on Cont-CC-SCIM
// alone, 0.5074 against 0.5461 ms at 2048 envs).  So the narrow design is
// the wide one.  ops/fused_policy.py's INDUCTION_POLICY_WIDE and
// INDUCTION_POLICY_NARROW mirror them.
using WideDesign = LaneDesign<8, false>;
using NarrowDesign = LaneDesign<8, false>;

// The recorded planes of an instance, in the order of
// induction_policy_record's outputs: [omega,] i_salpha, i_sbeta,
// psi_ralpha, psi_rbeta, the references, the head's action (finite) or
// the three channels' raw samples, reward and done.
template <bool FINITE, bool MECH, int NREF>
__host__ __device__ constexpr int induction_policy_planes() {
  return (MECH ? 1 : 0) + 4 + NREF + (FINITE ? 1 : 3) + 2;
}

template <bool FINITE, bool MECH, int NREF, int G, bool LEAD, bool WIENER>
__device__ __forceinline__ void policy_lanes_loop(const InductionConst& k, const PolicyConst& q,
                                                  const float* sw, uint2 key, int e, int l,
                                                  bool live, int n, int n_steps,
                                                  InductionState& x, RefRows<NREF>& refs,
                                                  uint32_t* const* dst) {
  using S = Shape<FINITE, NREF>;
  constexpr int NP = induction_policy_planes<FINITE, MECH, NREF>();
  constexpr int PL = (NP + G - 1) / G;  // planes a lane stores
  const float* std = sw + S::F * q.h + q.h + q.h * S::A + S::A;
#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) {
    policy_barrier();
    float fc = 1.0f, fs = 0.0f;
    if (k.flag[IF_NEEDS_DQ]) ind_flux_dir(k, x, fc, fs);
    float obs[S::F];
    obs[0] = MECH ? x.w * q.feat[0] : q.feat[0];
    obs[1] = x.isa * q.feat[1];
    obs[2] = x.isb * q.feat[2];
    obs[3] = x.psa * q.feat[3];
    obs[4] = x.psb * q.feat[4];
#pragma unroll
    for (int r = 0; r < NREF; ++r) {
      obs[5 + r] = ind_quantity(k, r, x, fc, fs);
      obs[5 + NREF + r] = refs.rv[r];
    }
    float logit[S::A];
    policy_mlp_lanes<S::F, S::A, G>(sw, obs, q.h, S::A, l, logit);
    int heads[kPolicyMaxHeads] = {0, 0, 0};
    float raw[S::NC] = {0.0f, 0.0f, 0.0f}, duty[S::NC] = {0.0f, 0.0f, 0.0f};
    float ref[NREF], reward = 0.0f, done = 0.0f;
#pragma unroll
    for (int r = 0; r < NREF; ++r) ref[r] = 0.0f;
    if (!LEAD || l == 0) {
      const PolicyDraw d = policy_draw<FINITE ? 1 : 4>(key, (uint32_t)e, (uint32_t)t);
      B6Action act;
      if constexpr (FINITE) {
        policy_heads<1, 8, 1, 1, false>(logit, 8, d, heads);
        act.bits = heads[0];
        act.a = act.b = act.c = 0.0f;
      } else {
        policy_gaussian<S::NC>(logit, std, q, d, k.ref.two_pi, k.ref.u_min, raw, duty);
        act.bits = 0;
        act.a = duty[0];
        act.b = duty[1];
        act.c = duty[2];
      }
      const uint4 w = WIENER ? drive_draw(key, (uint32_t)e, (uint32_t)t, DRIVE_SLOT_STEP)
                             : make_uint4(0u, 0u, 0u, 0u);
      const InductionStepOut r = ind_action_step<FINITE, MECH, NREF>(k, act, x, fc, fs, refs);
      if (WIENER) {
        ref_wiener_advance<NREF>(k.ref, key, (uint32_t)e, (uint32_t)t, w, r.done != 0.0f, refs);
      }
#pragma unroll
      for (int j = 0; j < NREF; ++j) ref[j] = r.ref[j];
      reward = r.reward;
      done = r.done;
    }
    if constexpr (LEAD) {
      // lane 0's step to the group: the state and the references the next
      // observation reads, and the values the lanes store
      if (MECH) x.w = lead_float(x.w, G);
      x.isa = lead_float(x.isa, G);
      x.isb = lead_float(x.isb, G);
      x.psa = lead_float(x.psa, G);
      x.psb = lead_float(x.psb, G);
#pragma unroll
      for (int r = 0; r < NREF; ++r) {
        refs.rv[r] = lead_float(refs.rv[r], G);
        ref[r] = lead_float(ref[r], G);
      }
      reward = lead_float(reward, G);
      done = lead_float(done, G);
      if constexpr (FINITE) {
        heads[0] = lead_int(heads[0], G);
      } else {
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
#pragma unroll
    for (int r = 0; r < NREF; ++r) v[j++] = __float_as_uint(ref[r]);
    if constexpr (FINITE) {
      v[j++] = (uint32_t)heads[0];
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

// induction_policy_record on lane groups: G lanes of a warp serve one env,
// a block 128 / G envs, lane 0 alone stepping (LEAD) or every lane; a group
// past the last env steps env n - 1 and stores nothing, so that every lane
// of the warp takes part in each shuffle.
template <bool FINITE, bool MECH, int NREF, int G, bool LEAD>
__global__ void __launch_bounds__(kPolicyThreads, kPolicyLaneBlocksPerSm)
induction_policy_record_lanes_kernel(InductionConst k, PolicyConst q, uint2 key, int n,
                                     int n_steps, PolicyWeights w, InductionInPlanes in,
                                     InductionPlanes so, PolicyOut o) {
  using S = Shape<FINITE, NREF>;
  constexpr int NP = induction_policy_planes<FINITE, MECH, NREF>();
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
  } else {
#pragma unroll
    for (int a = 0; a < S::NC; ++a) planes[j++] = reinterpret_cast<uint32_t*>(o.act_f[a]);
  }
  planes[j++] = reinterpret_cast<uint32_t*>(o.reward);
  planes[j] = reinterpret_cast<uint32_t*>(o.done);
  uint32_t* dst[PL];
#pragma unroll
  for (int m = 0; m < PL; ++m) dst[m] = lane_plane<NP>(l + G * m, planes);
  InductionState x = ind_load_state<MECH>(in, e);
  RefRows<NREF> refs;
  ref_wiener_init<NREF>(k.ref, key, (uint32_t)e, refs);
  if (k.flag[IF_ALL_CONST]) {
    policy_lanes_loop<FINITE, MECH, NREF, G, LEAD, false>(k, q, sw, key, e, l, live, n, n_steps,
                                                          x, refs, dst);
  } else {
    policy_lanes_loop<FINITE, MECH, NREF, G, LEAD, true>(k, q, sw, key, e, l, live, n, n_steps,
                                                         x, refs, dst);
  }
}

// ---- the launch --------------------------------------------------------

using LaunchFn = PolicyDesignFn<InductionConst>;

template <bool F, bool M, int NR>
void launch(const InductionConst& k, const PolicyConst& q, uint2 key, int n, int n_steps,
            const PolicyWeights& w, const float* const* in, void* const* out, const PolicyOut& o,
            cudaStream_t st, int design) {
  using S = Shape<F, NR>;
  const PolicyWidth d =
      design == 1 ? kPolicyOneThread : policy_width<WideDesign, NarrowDesign>(n);
  if (d == kPolicyWide) {
    policy_launch(induction_policy_record_lanes_kernel<F, M, NR, WideDesign::G, WideDesign::LEAD>,
                  S::F, F ? 0 : S::NC, k, q, key, n, n_steps, w, in, out, o, st, WideDesign::G);
  } else if (d == kPolicyNarrow) {
    policy_launch(
        induction_policy_record_lanes_kernel<F, M, NR, NarrowDesign::G, NarrowDesign::LEAD>, S::F,
        F ? 0 : S::NC, k, q, key, n, n_steps, w, in, out, o, st, NarrowDesign::G);
  } else {
    policy_launch(induction_policy_record_kernel<F, M, NR>, S::F, F ? 0 : S::NC, k, q, key, n,
                  n_steps, w, in, out, o, st);
  }
}

// indexed by ind_random_index()
const LaunchFn kLaunch[8] = {launch<false, false, 1>, launch<false, false, 2>,
                             launch<false, true, 1>,  launch<false, true, 2>,
                             launch<true, false, 1>,  launch<true, false, 2>,
                             launch<true, true, 1>,   launch<true, true, 2>};

}  // namespace

extern "C" {

POLICY_C_INFO(induction, N_INDUCTION_CONST, N_INDUCTION_FLAG)

// The recorder in a given design (0: the width rule at n, as
// induction_policy_record; 1: one thread per env, the design a full card
// takes), for the tests and tools that hold the designs against each other.
int induction_policy_record_design(const float* consts, const int* flags, const float* pk,
                                   const int* pi, unsigned long long seed, int n, int n_steps,
                                   int hidden, const float* w1, const float* b1,
                                   const float* w2, const float* b2, const float* ls,
                                   const float* const* in, void* const* out, int design,
                                   void* stream) {
  const int idx = ind_random_index(flags);
  const int finite = flags[IF_FINITE] != 0;
  const bool ok = idx >= 0 && pi[0] == finite && pi[1 + kPolicyMaxHeads] == 0;
  return policy_design_call(ok ? kLaunch[idx] : nullptr, ind_load_const(consts, flags), pk, pi,
                            seed, n, n_steps, hidden, finite ? 8 : 3, {w1, b1, w2, b2, ls}, in,
                            out, kStateSlots, design, stream);
}

// As sync_policy_record; in: (omega or NULL, i_salpha, i_sbeta,
// psi_ralpha, psi_rbeta); out: those five planes, then the PolicyOut
// planes, each (T, N).  Runs on lane groups or one thread per env by the
// width rule (policy_width).
int induction_policy_record(const float* consts, const int* flags, const float* pk,
                            const int* pi, unsigned long long seed, int n, int n_steps,
                            int hidden, const float* w1, const float* b1, const float* w2,
                            const float* b2, const float* ls, const float* const* in,
                            void* const* out, void* stream) {
  return induction_policy_record_design(consts, flags, pk, pi, seed, n, n_steps, hidden, w1, b1,
                                        w2, b2, ls, in, out, 0, stream);
}

// The launch of induction_policy_record over n envs on the current device:
// out = (lanes an env, lane 0 alone stepping, blocks of kPolicyThreads, the
// card's SMs).
int induction_policy_layout(int n, int* out) {
  policy_layout<WideDesign, NarrowDesign>(n, out);
  return 0;
}

}  // extern "C"
