// The universal policy-in-the-loop recorder of the switched reluctance
// family (the six {Finite, Cont} x {CC, TC, SC} SRM ids, linear or
// saturating) for Hopper (sm_90a), with a plain C interface for ctypes
// (every function returns cudaGetLastError()).
//
// Replaces (gym_electric_motor_tpu/ops/):
//   srm_policy_record  pallas_policy.py  make_fused_policy_record_universal (:1256),
//                                        for the SRM family
//
// Design: as fused_sync_policy.cu, over srm_action_step (srm_step.cuh).
// The observation is omega, the three phase currents over their limit, the
// angle's (cos, sin) (the carried rotation at constant speed), the
// referenced quantities of the pre-step state (a torque takes cosf and sinf
// of the angle afresh, as the reward does) and the references.  Finite:
// three 3-way heads of the per-phase commands, or one 27-way joint head;
// continuous: three squashed-Gaussian duties.  Templates FINITE, MECH, NREF
// (1 or 3), SAT and JOINT (16 instances as srm_record_random's, and 8 joint
// ones); H at run time; built with -fmad=false.
//
// What bounds it on this card: beside the step's operations (see
// fused_srm.cu), the MLP's F H + H A multiplies and adds, H tanhf and,
// finite, 9 or 27 expf; 4 bytes per signal and env-step of HBM writes.
//
// At PPO's width.  Fused PPO collects 2048 envs: one thread per env is 16
// blocks of 128 threads on 16 of the card's 132 SMs, each thread working
// through the MLP (672 multiply-adds a step on Finite-CC-SRM at H 32, 352
// on Cont-SC-SRM) and the port's longest step chain on its own.  On lane
// groups, as the sync family's recorder (fused_sync_policy.cu, over
// policy_heads_lanes.cuh), G lanes of a warp serve one env and lane p % G
// stores recorded plane p; a lead design passes lane 0's state, the
// constant-speed rotation, the references, reward, done and the three heads
// or raw samples on to the group.  The lanes split the MLP, not the step.
// Where a row refers to the torque, every lane takes it for the observation
// from the same state bits, so each reads lane 0's torque bit for bit.  The
// launch takes the family's wide design while the one-thread launch would
// put at most one block on each SM, its narrow one while it would put at
// most three, else one thread per env (policy_width).  Every design equals
// the one-thread kernel bit for bit; the one-thread kernel stays
// tools/sass_ops.py's count of the function's own work.
#include <cuda_runtime.h>

#include "policy_heads.cuh"
#include "policy_heads_lanes.cuh"
#include "srm_step.cuh"

namespace {

constexpr int kStateSlots = 5;  // (omega or NULL, i_a, i_b, i_c, eps)

template <bool FINITE, int NREF, bool JOINT>
struct Shape {
  static constexpr int F = 6 + 2 * NREF;
  static constexpr int NC = 3;
  static constexpr int A = !FINITE ? NC : (JOINT ? 27 : 9);
};

template <bool FINITE, bool MECH, int NREF, bool SAT, bool JOINT, bool WIENER>
__device__ __forceinline__ void policy_loop(const SrmConst& k, const PolicyConst& q,
                                            const float* sw, uint2 key, int e, int n,
                                            int n_steps, SrmState& x, float& c, float& s,
                                            RefRows<NREF>& refs, const SrmPlanes& so,
                                            const PolicyOut& o) {
  using S = Shape<FINITE, NREF, JOINT>;
  const float* std = sw + S::F * q.h + q.h + q.h * S::A + S::A;
#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) {
    policy_barrier();
    if (MECH) {
      c = cosf(x.eps);
      s = sinf(x.eps);
    }
    float tq = 0.0f;
    if (k.flag[SF_NEEDS_TORQUE]) {
      SrmPhase ph[3];
      srm_phases<SAT>(k, cosf(x.eps), sinf(x.eps), x.ia, x.ib, x.ic, ph);
      tq = srm_torque<SAT>(k, x.ia, x.ib, x.ic, ph);
    }
    float obs[S::F];
    obs[0] = MECH ? x.w * q.feat[0] : q.feat[0];
    obs[1] = x.ia * q.feat[1];
    obs[2] = x.ib * q.feat[2];
    obs[3] = x.ic * q.feat[3];
    obs[4] = c;
    obs[5] = s;
#pragma unroll
    for (int r = 0; r < NREF; ++r) {
      obs[6 + r] = srm_quantity(k, r, x, tq);
      obs[6 + NREF + r] = refs.rv[r];
    }
    float logit[S::A];
    policy_mlp<S::F, S::A>(sw, obs, q.h, S::A, logit);
    const PolicyDraw d = policy_draw<FINITE ? (JOINT ? 1 : 3) : 4>(key, (uint32_t)e, (uint32_t)t);
    int heads[kPolicyMaxHeads] = {0, 0, 0};
    float raw[S::NC] = {0.0f, 0.0f, 0.0f}, duty[S::NC] = {0.0f, 0.0f, 0.0f};
    SrmAction act;
    if constexpr (FINITE) {
      policy_heads<3, 3, 3, 3, JOINT>(logit, 3, d, heads);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        act.a[j] = heads[j];
        act.d[j] = 0.0f;
      }
    } else {
      policy_gaussian<S::NC>(logit, std, q, d, k.ref.two_pi, k.ref.u_min, raw, duty);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        act.a[j] = 0;
        act.d[j] = duty[j];
      }
    }
    const uint4 w = WIENER ? drive_draw(key, (uint32_t)e, (uint32_t)t, DRIVE_SLOT_STEP)
                           : make_uint4(0u, 0u, 0u, 0u);
    const SrmStepOut r = srm_action_step<FINITE, MECH, NREF, SAT>(k, act, x, c, s, refs);
    if (WIENER) {
      ref_wiener_advance<NREF>(k.ref, key, (uint32_t)e, (uint32_t)t, w, r.done != 0.0f, refs);
    }
    const size_t i = (size_t)t * n + e;
    srm_store_state<MECH>(x, so, i);
    policy_store_common<NREF>(o, i, r.ref, r.reward, r.done);
    policy_store_actions<FINITE, 3, S::NC>(o, i, heads, raw);
  }
}

template <bool FINITE, bool MECH, int NREF, bool SAT, bool JOINT>
__global__ void __launch_bounds__(kPolicyThreads)
srm_policy_record_kernel(SrmConst k, PolicyConst q, uint2 key, int n, int n_steps,
                         PolicyWeights w, SrmInPlanes in, SrmPlanes so, PolicyOut o) {
  using S = Shape<FINITE, NREF, JOINT>;
  extern __shared__ __align__(16) float sw[];
  policy_stage(sw, S::F, q.h, S::A, FINITE ? 0 : S::NC, w);
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  SrmState x = srm_load_state<MECH>(in, e);
  float c = MECH ? 1.0f : cosf(x.eps), s = MECH ? 0.0f : sinf(x.eps);
  RefRows<NREF> refs;
  ref_wiener_init<NREF>(k.ref, key, (uint32_t)e, refs);
  if (k.flag[SF_ALL_CONST]) {
    policy_loop<FINITE, MECH, NREF, SAT, JOINT, false>(k, q, sw, key, e, n, n_steps, x, c, s,
                                                       refs, so, o);
  } else {
    policy_loop<FINITE, MECH, NREF, SAT, JOINT, true>(k, q, sw, key, e, n, n_steps, x, c, s,
                                                      refs, so, o);
  }
}

// ---- the lane-group recorder --------------------------------------------

// The designs of the width rule, the fastest of G in {4, 8} x lead or every
// lane at 2048 and 4096 envs x 256 steps, H 32 (PERF.md, slice 25): eight
// lanes, every lane stepping, at both widths (at 2048 envs on
// Finite-CC-SRM, its joint head, Cont-SC-SRM and saturating Finite-TC-SRM
// 0.8774, 1.0305, 0.8273 and 1.0373 ms against 0.8824, 1.0834, 1.0107 and
// 1.0611 with lane 0 stepping and 0.98 to 1.29 on four lanes; at 4096
// envs 0.9829, 1.1939, 0.8984 and 1.1746 against 0.9822, 1.2476, 1.0660
// and 1.1849).  So the narrow design is the wide one.  ops/fused_policy.py's
// SRM_POLICY_WIDE and SRM_POLICY_NARROW mirror them.
using WideDesign = LaneDesign<8, false>;
using NarrowDesign = LaneDesign<8, false>;

// The recorded planes of an instance, in the order of srm_policy_record's
// outputs: [omega,] i_a, i_b, i_c, eps, the references, the three heads'
// actions (finite) or the three channels' raw samples, reward and done.
template <bool MECH, int NREF>
__host__ __device__ constexpr int srm_policy_planes() {
  return (MECH ? 1 : 0) + 4 + NREF + 3 + 2;
}

template <bool FINITE, bool MECH, int NREF, bool SAT, bool JOINT, int G, bool LEAD, bool WIENER>
__device__ __forceinline__ void policy_lanes_loop(const SrmConst& k, const PolicyConst& q,
                                                  const float* sw, uint2 key, int e, int l,
                                                  bool live, int n, int n_steps, SrmState& x,
                                                  float& c, float& s, RefRows<NREF>& refs,
                                                  uint32_t* const* dst) {
  using S = Shape<FINITE, NREF, JOINT>;
  constexpr int NP = srm_policy_planes<MECH, NREF>();
  constexpr int PL = (NP + G - 1) / G;  // planes a lane stores
  const float* std = sw + S::F * q.h + q.h + q.h * S::A + S::A;
#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) {
    policy_barrier();
    if (MECH) {
      c = cosf(x.eps);
      s = sinf(x.eps);
    }
    float tq = 0.0f;
    if (k.flag[SF_NEEDS_TORQUE]) {
      SrmPhase ph[3];
      srm_phases<SAT>(k, cosf(x.eps), sinf(x.eps), x.ia, x.ib, x.ic, ph);
      tq = srm_torque<SAT>(k, x.ia, x.ib, x.ic, ph);
    }
    float obs[S::F];
    obs[0] = MECH ? x.w * q.feat[0] : q.feat[0];
    obs[1] = x.ia * q.feat[1];
    obs[2] = x.ib * q.feat[2];
    obs[3] = x.ic * q.feat[3];
    obs[4] = c;
    obs[5] = s;
#pragma unroll
    for (int r = 0; r < NREF; ++r) {
      obs[6 + r] = srm_quantity(k, r, x, tq);
      obs[6 + NREF + r] = refs.rv[r];
    }
    float logit[S::A];
    policy_mlp_lanes<S::F, S::A, G>(sw, obs, q.h, S::A, l, logit);
    int heads[kPolicyMaxHeads] = {0, 0, 0};
    float raw[S::NC] = {0.0f, 0.0f, 0.0f}, duty[S::NC] = {0.0f, 0.0f, 0.0f};
    float ref[NREF], reward = 0.0f, done = 0.0f;
#pragma unroll
    for (int r = 0; r < NREF; ++r) ref[r] = 0.0f;
    if (!LEAD || l == 0) {
      const PolicyDraw d =
          policy_draw<FINITE ? (JOINT ? 1 : 3) : 4>(key, (uint32_t)e, (uint32_t)t);
      SrmAction act;
      if constexpr (FINITE) {
        policy_heads<3, 3, 3, 3, JOINT>(logit, 3, d, heads);
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          act.a[j] = heads[j];
          act.d[j] = 0.0f;
        }
      } else {
        policy_gaussian<S::NC>(logit, std, q, d, k.ref.two_pi, k.ref.u_min, raw, duty);
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          act.a[j] = 0;
          act.d[j] = duty[j];
        }
      }
      const uint4 w = WIENER ? drive_draw(key, (uint32_t)e, (uint32_t)t, DRIVE_SLOT_STEP)
                             : make_uint4(0u, 0u, 0u, 0u);
      const SrmStepOut r = srm_action_step<FINITE, MECH, NREF, SAT>(k, act, x, c, s, refs);
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
      // lanes store
      if (MECH) x.w = lead_float(x.w, G);
      x.ia = lead_float(x.ia, G);
      x.ib = lead_float(x.ib, G);
      x.ic = lead_float(x.ic, G);
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
      if constexpr (FINITE) {
#pragma unroll
        for (int h = 0; h < 3; ++h) heads[h] = lead_int(heads[h], G);
      } else {
#pragma unroll
        for (int j = 0; j < S::NC; ++j) raw[j] = lead_float(raw[j], G);
      }
    }
    uint32_t v[NP];
    int j = 0;
    if (MECH) v[j++] = __float_as_uint(x.w);
    v[j++] = __float_as_uint(x.ia);
    v[j++] = __float_as_uint(x.ib);
    v[j++] = __float_as_uint(x.ic);
    v[j++] = __float_as_uint(x.eps);
#pragma unroll
    for (int r = 0; r < NREF; ++r) v[j++] = __float_as_uint(ref[r]);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      v[j++] = FINITE ? (uint32_t)heads[a] : __float_as_uint(raw[a]);
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

// srm_policy_record on lane groups: G lanes of a warp serve one env, a
// block 128 / G envs, lane 0 alone stepping (LEAD) or every lane; a group
// past the last env steps env n - 1 and stores nothing, so that every lane
// of the warp takes part in each shuffle.
template <bool FINITE, bool MECH, int NREF, bool SAT, bool JOINT, int G, bool LEAD>
__global__ void __launch_bounds__(kPolicyThreads, kPolicyLaneBlocksPerSm)
srm_policy_record_lanes_kernel(SrmConst k, PolicyConst q, uint2 key, int n, int n_steps,
                               PolicyWeights w, SrmInPlanes in, SrmPlanes so, PolicyOut o) {
  using S = Shape<FINITE, NREF, JOINT>;
  constexpr int NP = srm_policy_planes<MECH, NREF>();
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
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    planes[j++] = FINITE ? reinterpret_cast<uint32_t*>(o.act_i[a])
                         : reinterpret_cast<uint32_t*>(o.act_f[a]);
  }
  planes[j++] = reinterpret_cast<uint32_t*>(o.reward);
  planes[j] = reinterpret_cast<uint32_t*>(o.done);
  uint32_t* dst[PL];
#pragma unroll
  for (int m = 0; m < PL; ++m) dst[m] = lane_plane<NP>(l + G * m, planes);
  SrmState x = srm_load_state<MECH>(in, e);
  float c = MECH ? 1.0f : cosf(x.eps), s = MECH ? 0.0f : sinf(x.eps);
  RefRows<NREF> refs;
  ref_wiener_init<NREF>(k.ref, key, (uint32_t)e, refs);
  if (k.flag[SF_ALL_CONST]) {
    policy_lanes_loop<FINITE, MECH, NREF, SAT, JOINT, G, LEAD, false>(
        k, q, sw, key, e, l, live, n, n_steps, x, c, s, refs, dst);
  } else {
    policy_lanes_loop<FINITE, MECH, NREF, SAT, JOINT, G, LEAD, true>(
        k, q, sw, key, e, l, live, n, n_steps, x, c, s, refs, dst);
  }
}

// ---- the launch --------------------------------------------------------

using LaunchFn = PolicyDesignFn<SrmConst>;

template <bool F, bool M, int NR, bool SAT, bool J>
void launch(const SrmConst& k, const PolicyConst& q, uint2 key, int n, int n_steps,
            const PolicyWeights& w, const float* const* in, void* const* out, const PolicyOut& o,
            cudaStream_t st, int design) {
  using S = Shape<F, NR, J>;
  const PolicyWidth d =
      design == 1 ? kPolicyOneThread : policy_width<WideDesign, NarrowDesign>(n);
  if (d == kPolicyWide) {
    policy_launch(
        srm_policy_record_lanes_kernel<F, M, NR, SAT, J, WideDesign::G, WideDesign::LEAD>, S::F,
        F ? 0 : S::NC, k, q, key, n, n_steps, w, in, out, o, st, WideDesign::G);
  } else if (d == kPolicyNarrow) {
    policy_launch(
        srm_policy_record_lanes_kernel<F, M, NR, SAT, J, NarrowDesign::G, NarrowDesign::LEAD>,
        S::F, F ? 0 : S::NC, k, q, key, n, n_steps, w, in, out, o, st, NarrowDesign::G);
  } else {
    policy_launch(srm_policy_record_kernel<F, M, NR, SAT, J>, S::F, F ? 0 : S::NC, k, q, key, n,
                  n_steps, w, in, out, o, st);
  }
}

// indexed by srm_random_index(); the joint table by 4 * sat + 2 * mech +
// (nref == 3) of its finite instances
const LaunchFn kLaunch[16] = {
    launch<false, false, 1, false, false>, launch<false, false, 3, false, false>,
    launch<false, true, 1, false, false>,  launch<false, true, 3, false, false>,
    launch<true, false, 1, false, false>,  launch<true, false, 3, false, false>,
    launch<true, true, 1, false, false>,   launch<true, true, 3, false, false>,
    launch<false, false, 1, true, false>,  launch<false, false, 3, true, false>,
    launch<false, true, 1, true, false>,   launch<false, true, 3, true, false>,
    launch<true, false, 1, true, false>,   launch<true, false, 3, true, false>,
    launch<true, true, 1, true, false>,    launch<true, true, 3, true, false>};
const LaunchFn kLaunchJoint[8] = {
    launch<true, false, 1, false, true>, launch<true, false, 3, false, true>,
    launch<true, true, 1, false, true>,  launch<true, true, 3, false, true>,
    launch<true, false, 1, true, true>,  launch<true, false, 3, true, true>,
    launch<true, true, 1, true, true>,   launch<true, true, 3, true, true>};

}  // namespace

extern "C" {

POLICY_C_INFO(srm, N_SRM_CONST, N_SRM_FLAG)

// The recorder in a given design (0: the width rule at n, as
// srm_policy_record; 1: one thread per env, the design a full card takes),
// for the tests and tools that hold the designs against each other.
int srm_policy_record_design(const float* consts, const int* flags, const float* pk,
                             const int* pi, unsigned long long seed, int n, int n_steps,
                             int hidden, const float* w1, const float* b1, const float* w2,
                             const float* b2, const float* ls, const float* const* in,
                             void* const* out, int design, void* stream) {
  const int idx = srm_random_index(flags);
  const int finite = flags[SF_FINITE] != 0, joint = pi[1 + kPolicyMaxHeads] != 0;
  const bool ok = idx >= 0 && pi[0] == (finite ? 3 : 0) && !(joint && !finite);
  const LaunchFn fn = !ok    ? nullptr
                      : joint ? kLaunchJoint[4 * (flags[SF_SAT] != 0) + (idx & 3)]
                              : kLaunch[idx];
  const int n_out = !finite ? 3 : (joint ? 27 : 9);
  return policy_design_call(fn, srm_load_const(consts, flags), pk, pi, seed, n, n_steps, hidden,
                            n_out, {w1, b1, w2, b2, ls}, in, out, kStateSlots, design, stream);
}

// As sync_policy_record; in: (omega or NULL, i_a, i_b, i_c, eps); out:
// those five planes, then the PolicyOut planes, each (T, N).  Runs on lane
// groups or one thread per env by the width rule (policy_width).
int srm_policy_record(const float* consts, const int* flags, const float* pk, const int* pi,
                      unsigned long long seed, int n, int n_steps, int hidden, const float* w1,
                      const float* b1, const float* w2, const float* b2, const float* ls,
                      const float* const* in, void* const* out, void* stream) {
  return srm_policy_record_design(consts, flags, pk, pi, seed, n, n_steps, hidden, w1, b1, w2,
                                  b2, ls, in, out, 0, stream);
}

// The launch of srm_policy_record over n envs on the current device: out =
// (lanes an env, lane 0 alone stepping, blocks of kPolicyThreads, the
// card's SMs).
int srm_policy_layout(int n, int* out) {
  policy_layout<WideDesign, NarrowDesign>(n, out);
  return 0;
}

}  // extern "C"
