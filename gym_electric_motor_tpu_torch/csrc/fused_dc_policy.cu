// The universal policy-in-the-loop recorder of the DC family (PermExDc,
// SeriesDc, ShuntDc and ExtExDc, the 24 {Finite, Cont} x {CC, TC, SC} ids,
// with the 1QC, 2QC and 4QC converters) for Hopper (sm_90a), with a plain C
// interface for ctypes (every function returns cudaGetLastError()).
//
// Replaces (gym_electric_motor_tpu/ops/):
//   dc_policy_record  pallas_policy.py  make_fused_policy_record_universal (:1256),
//                                       for the DC family
//
// Design: as fused_sync_policy.cu, over dc_action_step (dc_step.cuh).  The
// observation is omega and the currents over their limits, the referenced
// quantities of the pre-step state and the references.  A finite converter
// channel is one head: its 2, 3 or 4 actions (a run-time count; the logits
// are sized for 4), or ExtExDc's two 4-way heads (or one 16-way joint
// head); a continuous channel is one squashed-Gaussian duty in the
// converter's range.  Templates FINITE, MECH, the motor class MC, NREF and
// JOINT (14 instances as dc_record_random's, and 3 joint ones for ExtExDc);
// H at run time; built with -fmad=false.
//
// What bounds it on this card: beside the step's operations (see
// fused_dc.cu), the MLP's F H + H A multiplies and adds, H tanhf and,
// finite, up to 16 expf; 4 bytes per signal and env-step of HBM writes.
//
// At PPO's width.  Fused PPO collects 2048 envs: one thread per env is 16
// blocks of 128 threads on 16 of the card's 132 SMs, each thread working
// through the MLP's F H + H A multiply-adds and H tanhf a step on its own
// chain (1.6% of the bound at 2048 x 64, H 32; PERF.md).  On lane groups
// (policy_heads_lanes.cuh) G lanes of a warp serve one env: a lane computes
// the hidden units j = l, l + G, ... and its share of the logits, gathering
// the hidden values by __shfl_sync in the one-thread kernel's order, and
// lane p % G stores recorded plane p.  The width rule
// (policy_heads_lanes.cuh's policy_width) is the PMSM recorder's
// (record_lanes, fused_policy.cu): the wide design (WideDesign) while that
// launch puts at most one block on each SM, the narrow one (NarrowDesign)
// while it puts at most three, else one thread per env; a lane design
// either lets lane 0 alone sample and step the env and pass the results on
// (lead) or has every lane do so on the same operands.  Every design
// equals the one-thread kernel bit for bit; the one-thread kernel stays
// tools/sass_ops.py's count of the function's own work.
#include <cuda_runtime.h>

#include "dc_step.cuh"
#include "policy_heads.cuh"
#include "policy_heads_lanes.cuh"

namespace {

constexpr int kStateSlots = 3;  // (omega or NULL, i0, i1 or NULL)

template <bool FINITE, int MC, int NREF, bool JOINT>
struct Shape {
  static constexpr int N_EL = MC == MC_ONE ? 1 : 2;
  static constexpr int F = 1 + N_EL + 2 * NREF;
  static constexpr int NC = MC == MC_EXTEX ? 2 : 1;
  static constexpr int NH = MC == MC_EXTEX ? 2 : 1;
  static constexpr int A = !FINITE ? NC : (MC == MC_EXTEX ? (JOINT ? 16 : 8) : 4);
};

template <bool FINITE, bool MECH, int MC, int NREF, bool JOINT, bool WIENER>
__device__ __forceinline__ void policy_loop(const DcConst& k, const PolicyConst& q,
                                            const float* sw, uint2 key, int e, int n,
                                            int n_steps, DcState& x, RefRows<NREF>& refs,
                                            float* const* so, const PolicyOut& o) {
  using S = Shape<FINITE, MC, NREF, JOINT>;
  const float* std = sw + S::F * q.h + q.h + q.h * q.a + q.a;
#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) {
    policy_barrier();
    float obs[S::F];
    obs[0] = MECH ? x.w * q.feat[0] : q.feat[0];
    obs[1] = x.i0 * q.feat[1];
    if (S::N_EL == 2) obs[2] = x.i1 * q.feat[2];
#pragma unroll
    for (int r = 0; r < NREF; ++r) {
      obs[1 + S::N_EL + r] = dc_quantity<MC>(k, r, x);
      obs[1 + S::N_EL + NREF + r] = refs.rv[r];
    }
    float logit[S::A];
    // the single head's logits: its run-time count, for 4 built
    policy_mlp<S::F, S::A>(sw, obs, q.h, (FINITE && MC != MC_EXTEX) ? q.a : S::A, logit);
    const PolicyDraw d = policy_draw<FINITE ? S::NH : 2 * ((S::NC + 1) / 2)>(key, (uint32_t)e,
                                                                           (uint32_t)t);
    int heads[kPolicyMaxHeads] = {0, 0, 0};
    float raw[S::NC], duty[S::NC];
#pragma unroll
    for (int c = 0; c < S::NC; ++c) raw[c] = duty[c] = 0.0f;
    DcAction act;
    act.a0 = act.a1 = 0;
    act.f0 = act.f1 = 0.0f;
    if constexpr (FINITE) {
      policy_heads<S::NH, 4, 4, 1, JOINT>(logit, q.ns[0], d, heads);
      act.a0 = heads[0];
      act.a1 = heads[1];
    } else {
      policy_gaussian<S::NC>(logit, std, q, d, k.ref.two_pi, k.ref.u_min, raw, duty);
      act.f0 = duty[0];
      act.f1 = duty[S::NC - 1];
    }
    const uint4 w = WIENER ? drive_draw(key, (uint32_t)e, (uint32_t)t, DRIVE_SLOT_STEP)
                           : make_uint4(0u, 0u, 0u, 0u);
    const DcStepOut r = dc_action_step<FINITE, MECH, MC, NREF>(k, act, x, refs);
    if (WIENER) {
      ref_wiener_advance<NREF>(k.ref, key, (uint32_t)e, (uint32_t)t, w, r.done != 0.0f, refs);
    }
    const size_t i = (size_t)t * n + e;
    dc_store_state<MECH, MC>(x, so[0], so[1], so[2], i);
    policy_store_common<NREF>(o, i, r.ref, r.reward, r.done);
    policy_store_actions<FINITE, S::NH, S::NC>(o, i, heads, raw);
  }
}

template <bool FINITE, bool MECH, int MC, int NREF, bool JOINT>
__global__ void __launch_bounds__(kPolicyThreads)
dc_policy_record_kernel(DcConst k, PolicyConst q, uint2 key, int n, int n_steps, PolicyWeights w,
                        PolicyInPlanes<kStateSlots> in, PolicyOutPlanes<kStateSlots> so,
                        PolicyOut o) {
  using S = Shape<FINITE, MC, NREF, JOINT>;
  extern __shared__ __align__(16) float sw[];
  policy_stage(sw, S::F, q.h, q.a, FINITE ? 0 : S::NC, w);
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  DcState x = dc_load_state<MECH, MC>(in.p[0], in.p[1], in.p[2], e);
  RefRows<NREF> refs;
  ref_wiener_init<NREF>(k.ref, key, (uint32_t)e, refs);
  if (k.ref.all_const) {
    policy_loop<FINITE, MECH, MC, NREF, JOINT, false>(k, q, sw, key, e, n, n_steps, x, refs,
                                                      so.p, o);
  } else {
    policy_loop<FINITE, MECH, MC, NREF, JOINT, true>(k, q, sw, key, e, n, n_steps, x, refs,
                                                     so.p, o);
  }
}

// ---- the lane-group recorder --------------------------------------------

// The designs of the width rule, the fastest of G in {4, 8} x lead or every
// lane at 2048 and 4096 envs x 256 steps, H 32, on Finite-CC-PermExDc,
// Cont-CC-PermExDc and the joint ExtExDc head (PERF.md, slice 21): at PPO's
// width eight lanes, every lane stepping; then four lanes, lane 0 stepping.
// ops/fused_policy.py's DC_POLICY_WIDE and DC_POLICY_NARROW mirror them.
using WideDesign = LaneDesign<8, false>;
using NarrowDesign = LaneDesign<4, true>;

// The recorded planes of an instance, in the order of policy_record's
// outputs: [omega,] i0, [i1,] the references, the heads' actions (finite)
// or the channels' raw samples, reward and done.
template <bool FINITE, bool MECH, int MC, int NREF, bool JOINT>
__host__ __device__ constexpr int dc_policy_planes() {
  using S = Shape<FINITE, MC, NREF, JOINT>;
  return (MECH ? 1 : 0) + S::N_EL + NREF + (FINITE ? S::NH : S::NC) + 2;
}

template <bool FINITE, bool MECH, int MC, int NREF, bool JOINT, int G, bool LEAD, bool WIENER>
__device__ __forceinline__ void policy_lanes_loop(const DcConst& k, const PolicyConst& q,
                                                  const float* sw, uint2 key, int e, int l,
                                                  bool live, int n, int n_steps, DcState& x,
                                                  RefRows<NREF>& refs, uint32_t* const* dst) {
  using S = Shape<FINITE, MC, NREF, JOINT>;
  constexpr int NP = dc_policy_planes<FINITE, MECH, MC, NREF, JOINT>();
  constexpr int PL = (NP + G - 1) / G;  // planes a lane stores
  const float* std = sw + S::F * q.h + q.h + q.h * q.a + q.a;
#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) {
    policy_barrier();
    float obs[S::F];
    obs[0] = MECH ? x.w * q.feat[0] : q.feat[0];
    obs[1] = x.i0 * q.feat[1];
    if (S::N_EL == 2) obs[2] = x.i1 * q.feat[2];
#pragma unroll
    for (int r = 0; r < NREF; ++r) {
      obs[1 + S::N_EL + r] = dc_quantity<MC>(k, r, x);
      obs[1 + S::N_EL + NREF + r] = refs.rv[r];
    }
    float logit[S::A];
    policy_mlp_lanes<S::F, S::A, G>(sw, obs, q.h, (FINITE && MC != MC_EXTEX) ? q.a : S::A, l,
                                    logit);
    int heads[kPolicyMaxHeads] = {0, 0, 0};
    float raw[S::NC], duty[S::NC];
#pragma unroll
    for (int c = 0; c < S::NC; ++c) raw[c] = duty[c] = 0.0f;
    float ref[2] = {0.0f, 0.0f}, reward = 0.0f, done = 0.0f;
    if (!LEAD || l == 0) {
      const PolicyDraw d = policy_draw<FINITE ? S::NH : 2 * ((S::NC + 1) / 2)>(
          key, (uint32_t)e, (uint32_t)t);
      DcAction act;
      act.a0 = act.a1 = 0;
      act.f0 = act.f1 = 0.0f;
      if constexpr (FINITE) {
        policy_heads<S::NH, 4, 4, 1, JOINT>(logit, q.ns[0], d, heads);
        act.a0 = heads[0];
        act.a1 = heads[1];
      } else {
        policy_gaussian<S::NC>(logit, std, q, d, k.ref.two_pi, k.ref.u_min, raw, duty);
        act.f0 = duty[0];
        act.f1 = duty[S::NC - 1];
      }
      const uint4 w = WIENER ? drive_draw(key, (uint32_t)e, (uint32_t)t, DRIVE_SLOT_STEP)
                             : make_uint4(0u, 0u, 0u, 0u);
      const DcStepOut r = dc_action_step<FINITE, MECH, MC, NREF>(k, act, x, refs);
      if (WIENER) {
        ref_wiener_advance<NREF>(k.ref, key, (uint32_t)e, (uint32_t)t, w, r.done != 0.0f, refs);
      }
      ref[0] = r.ref[0];
      ref[1] = r.ref[1];
      reward = r.reward;
      done = r.done;
    }
    if constexpr (LEAD) {
      // lane 0's step to the group: the state and references the next
      // observation reads, and the values the lanes store
      if (MECH) x.w = lead_float(x.w, G);
      x.i0 = lead_float(x.i0, G);
      if (S::N_EL == 2) x.i1 = lead_float(x.i1, G);
#pragma unroll
      for (int r = 0; r < NREF; ++r) {
        refs.rv[r] = lead_float(refs.rv[r], G);
        ref[r] = lead_float(ref[r], G);
      }
      reward = lead_float(reward, G);
      done = lead_float(done, G);
      if constexpr (FINITE) {
#pragma unroll
        for (int h = 0; h < S::NH; ++h) heads[h] = lead_int(heads[h], G);
      } else {
#pragma unroll
        for (int c = 0; c < S::NC; ++c) raw[c] = lead_float(raw[c], G);
      }
    }
    uint32_t v[NP];
    int j = 0;
    if (MECH) v[j++] = __float_as_uint(x.w);
    v[j++] = __float_as_uint(x.i0);
    if (S::N_EL == 2) v[j++] = __float_as_uint(x.i1);
#pragma unroll
    for (int r = 0; r < NREF; ++r) v[j++] = __float_as_uint(ref[r]);
    if constexpr (FINITE) {
#pragma unroll
      for (int h = 0; h < S::NH; ++h) v[j++] = (uint32_t)heads[h];
    } else {
#pragma unroll
      for (int c = 0; c < S::NC; ++c) v[j++] = __float_as_uint(raw[c]);
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

// dc_policy_record on lane groups: G lanes of a warp serve one env, a block
// 128 / G envs, lane 0 alone stepping (LEAD) or every lane; a group past
// the last env steps env n - 1 and stores nothing, so that every lane of
// the warp takes part in each shuffle.
template <bool FINITE, bool MECH, int MC, int NREF, bool JOINT, int G, bool LEAD>
__global__ void __launch_bounds__(kPolicyThreads)
dc_policy_record_lanes_kernel(DcConst k, PolicyConst q, uint2 key, int n, int n_steps,
                              PolicyWeights w, PolicyInPlanes<kStateSlots> in,
                              PolicyOutPlanes<kStateSlots> so, PolicyOut o) {
  using S = Shape<FINITE, MC, NREF, JOINT>;
  constexpr int NP = dc_policy_planes<FINITE, MECH, MC, NREF, JOINT>();
  constexpr int PL = (NP + G - 1) / G;
  extern __shared__ __align__(16) float sw[];
  policy_stage(sw, S::F, q.h, q.a, FINITE ? 0 : S::NC, w);
  const int ge = (int)((blockIdx.x * blockDim.x + threadIdx.x) / G);
  const bool live = ge < n;
  const int e = live ? ge : n - 1;
  const int l = (int)(threadIdx.x % G);
  uint32_t* planes[NP];
  int j = 0;
  if (MECH) planes[j++] = reinterpret_cast<uint32_t*>(so.p[0]);
  planes[j++] = reinterpret_cast<uint32_t*>(so.p[1]);
  if (S::N_EL == 2) planes[j++] = reinterpret_cast<uint32_t*>(so.p[2]);
#pragma unroll
  for (int r = 0; r < NREF; ++r) planes[j++] = reinterpret_cast<uint32_t*>(o.ref[r]);
  if constexpr (FINITE) {
#pragma unroll
    for (int h = 0; h < S::NH; ++h) planes[j++] = reinterpret_cast<uint32_t*>(o.act_i[h]);
  } else {
#pragma unroll
    for (int c = 0; c < S::NC; ++c) planes[j++] = reinterpret_cast<uint32_t*>(o.act_f[c]);
  }
  planes[j++] = reinterpret_cast<uint32_t*>(o.reward);
  planes[j] = reinterpret_cast<uint32_t*>(o.done);
  uint32_t* dst[PL];
#pragma unroll
  for (int m = 0; m < PL; ++m) dst[m] = lane_plane<NP>(l + G * m, planes);
  DcState x = dc_load_state<MECH, MC>(in.p[0], in.p[1], in.p[2], e);
  RefRows<NREF> refs;
  ref_wiener_init<NREF>(k.ref, key, (uint32_t)e, refs);
  if (k.ref.all_const) {
    policy_lanes_loop<FINITE, MECH, MC, NREF, JOINT, G, LEAD, false>(k, q, sw, key, e, l, live,
                                                                     n, n_steps, x, refs, dst);
  } else {
    policy_lanes_loop<FINITE, MECH, MC, NREF, JOINT, G, LEAD, true>(k, q, sw, key, e, l, live,
                                                                    n, n_steps, x, refs, dst);
  }
}

// ---- the launch --------------------------------------------------------

using LaunchFn = PolicyDesignFn<DcConst>;

template <bool F, bool M, int MC, int NR, bool J>
void launch(const DcConst& k, const PolicyConst& q, uint2 key, int n, int n_steps,
            const PolicyWeights& w, const float* const* in, void* const* out, const PolicyOut& o,
            cudaStream_t st, int design) {
  using S = Shape<F, MC, NR, J>;
  const PolicyWidth d =
      design == 1 ? kPolicyOneThread : policy_width<WideDesign, NarrowDesign>(n);
  if (d == kPolicyWide) {
    policy_launch(
        dc_policy_record_lanes_kernel<F, M, MC, NR, J, WideDesign::G, WideDesign::LEAD>, S::F,
        F ? 0 : S::NC, k, q, key, n, n_steps, w, in, out, o, st, WideDesign::G);
  } else if (d == kPolicyNarrow) {
    policy_launch(
        dc_policy_record_lanes_kernel<F, M, MC, NR, J, NarrowDesign::G, NarrowDesign::LEAD>,
        S::F, F ? 0 : S::NC, k, q, key, n, n_steps, w, in, out, o, st, NarrowDesign::G);
  } else {
    policy_launch(dc_policy_record_kernel<F, M, MC, NR, J>, S::F, F ? 0 : S::NC, k, q, key, n,
                  n_steps, w, in, out, o, st);
  }
}

// The built instances: dc_built's, and the joint head only on a finite
// ExtExDc.
template <bool F, bool M, int MC, int NR, bool J>
constexpr LaunchFn pick() {
  if constexpr (dc_built<M, MC, NR>() && (!J || (F && MC == MC_EXTEX))) {
    return launch<F, M, MC, NR, J>;
  } else {
    return nullptr;
  }
}

#define DC_POLICY_ROW(F, M, J)                                                         \
  pick<F, M, MC_ONE, 1, J>(), pick<F, M, MC_ONE, 2, J>(), pick<F, M, MC_SHUNT, 1, J>(), \
      pick<F, M, MC_SHUNT, 2, J>(), pick<F, M, MC_EXTEX, 1, J>(), pick<F, M, MC_EXTEX, 2, J>()

// indexed by dc_instance(); nullptr where no instance is built
const LaunchFn kLaunch[24] = {
    DC_POLICY_ROW(false, false, false), DC_POLICY_ROW(false, true, false),
    DC_POLICY_ROW(true, false, false), DC_POLICY_ROW(true, true, false)};
const LaunchFn kLaunchJoint[24] = {
    DC_POLICY_ROW(false, false, true), DC_POLICY_ROW(false, true, true),
    DC_POLICY_ROW(true, false, true), DC_POLICY_ROW(true, true, true)};

#undef DC_POLICY_ROW

}  // namespace

extern "C" {

POLICY_C_INFO(dc, N_DC_CONST, N_DC_FLAG)

// The recorder in a given design (0: the width rule at n, as
// dc_policy_record; 1: one thread per env, the design a full card takes),
// for the tests and tools that hold the designs against each other.
int dc_policy_record_design(const float* consts, const int* flags, const float* pk,
                            const int* pi, unsigned long long seed, int n, int n_steps,
                            int hidden, const float* w1, const float* b1, const float* w2,
                            const float* b2, const float* ls, const float* const* in,
                            void* const* out, int design, void* stream) {
  const int idx = dc_instance(flags);
  const int finite = flags[DF_FINITE] != 0, joint = pi[1 + kPolicyMaxHeads] != 0;
  const int n_ch = flags[DF_MCLASS] == MC_EXTEX ? 2 : 1;
  const bool ok = idx >= 0 && pi[0] == (finite ? n_ch : 0)
                  && !(finite && n_ch == 1 && (pi[1] < 2 || pi[1] > 4));
  const LaunchFn fn = ok ? (joint ? kLaunchJoint : kLaunch)[idx] : nullptr;
  const int n_out = !finite ? n_ch : (n_ch == 2 ? (joint ? 16 : 8) : pi[1]);
  return policy_design_call(fn, dc_load_const(consts, flags), pk, pi, seed, n, n_steps, hidden,
                            n_out, {w1, b1, w2, b2, ls}, in, out, kStateSlots, design, stream);
}

// As sync_policy_record; in: (omega or NULL, i0, i1 or NULL); out: those
// three planes, then the PolicyOut planes, each (T, N).  Runs on lane
// groups or one thread per env by the width rule (policy_width).
int dc_policy_record(const float* consts, const int* flags, const float* pk, const int* pi,
                     unsigned long long seed, int n, int n_steps, int hidden, const float* w1,
                     const float* b1, const float* w2, const float* b2, const float* ls,
                     const float* const* in, void* const* out, void* stream) {
  return dc_policy_record_design(consts, flags, pk, pi, seed, n, n_steps, hidden, w1, b1, w2,
                                 b2, ls, in, out, 0, stream);
}

// The launch of dc_policy_record over n envs on the current device: out =
// (lanes an env, lane 0 alone stepping, blocks of kPolicyThreads, the
// card's SMs).
int dc_policy_layout(int n, int* out) {
  policy_layout<WideDesign, NarrowDesign>(n, out);
  return 0;
}

}  // extern "C"
