// The universal policy-in-the-loop recorder of the EESM family (the six
// {Finite, Cont} x {CC, TC, SC} EESM ids, three references on the CC ids)
// for Hopper (sm_90a), with a plain C interface for ctypes (every function
// returns cudaGetLastError()).
//
// Replaces (gym_electric_motor_tpu/ops/):
//   eesm_policy_record  pallas_policy.py  make_fused_policy_record_universal (:1256),
//                                         for the EESM family
//
// Design: as fused_sync_policy.cu, over eesm_action_step (eesm_step.cuh).
// The observation is omega, i_sd, i_sq and i_e over their limits, the
// rotation's (cos, sin), the referenced quantities of the pre-step state
// and the references.  Finite: the B6 bits' 8-way and the excitation 4QC's
// 4-way heads, or one 32-way joint head; continuous: four squashed-Gaussian
// duties (the B6's three, the excitation's).  Templates FINITE, MECH, NREF
// (1 or 3) and JOINT (8 instances as eesm_record_random's, and 4 joint
// ones); H at run time; built with -fmad=false.
//
// What bounds it on this card: beside the step's operations (see
// fused_eesm.cu), the MLP's F H + H A multiplies and adds, H tanhf and,
// finite, 12 or 32 expf; 4 bytes per signal and env-step of HBM writes.
//
// At PPO's width.  Fused PPO collects 2048 envs: one thread per env is 16
// blocks of 128 threads on 16 of the card's 132 SMs, each thread working
// through the widest MLP of any family (768 multiply-adds a step on
// Finite-CC-EESM at H 32, 1408 with the joint head) on its own chain.  On
// lane groups, as the sync family's recorder (fused_sync_policy.cu, over
// policy_heads_lanes.cuh), G lanes of a warp serve one env and lane p % G
// stores recorded plane p; a lead design passes lane 0's state (i_e with
// it), the constant-speed rotation, the references, reward, done and the
// two heads or four raw samples on to the group.  The launch takes the
// family's wide design while the one-thread launch would put at most one
// block on each SM, its narrow one while it would put at most three, else
// one thread per env (policy_width).  Every design equals the one-thread
// kernel bit for bit; the one-thread kernel stays tools/sass_ops.py's count
// of the function's own work.
#include <cuda_runtime.h>

#include "eesm_step.cuh"
#include "policy_heads.cuh"
#include "policy_heads_lanes.cuh"

namespace {

constexpr int kStateSlots = 5;  // (omega or NULL, i_sd, i_sq, i_e, eps)

template <bool FINITE, int NREF, bool JOINT>
struct Shape {
  static constexpr int F = 6 + 2 * NREF;
  static constexpr int NC = 4;
  static constexpr int A = !FINITE ? NC : (JOINT ? 32 : 12);
};

template <bool FINITE, bool MECH, int NREF, bool JOINT, bool WIENER>
__device__ __forceinline__ void policy_loop(const EesmConst& k, const PolicyConst& q,
                                            const float* sw, uint2 key, int e, int n,
                                            int n_steps, EesmState& x, float& c, float& s,
                                            RefRows<NREF>& refs, const EesmPlanes& so,
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
    float obs[S::F];
    obs[0] = MECH ? x.w * q.feat[0] : q.feat[0];
    obs[1] = x.i_sd * q.feat[1];
    obs[2] = x.i_sq * q.feat[2];
    obs[3] = x.i_e * q.feat[3];
    obs[4] = c;
    obs[5] = s;
#pragma unroll
    for (int r = 0; r < NREF; ++r) {
      obs[6 + r] = eesm_quantity(k, r, x);
      obs[6 + NREF + r] = refs.rv[r];
    }
    float logit[S::A];
    policy_mlp<S::F, S::A>(sw, obs, q.h, S::A, logit);
    const PolicyDraw d = policy_draw<FINITE ? (JOINT ? 1 : 2) : 4>(key, (uint32_t)e, (uint32_t)t);
    int heads[kPolicyMaxHeads] = {0, 0, 0};
    float raw[S::NC] = {0.0f, 0.0f, 0.0f, 0.0f}, duty[S::NC] = {0.0f, 0.0f, 0.0f, 0.0f};
    EesmAction act;
    if constexpr (FINITE) {
      policy_heads<2, 8, 4, 1, JOINT>(logit, 8, d, heads);
      act.b6.bits = heads[0];
      act.b6.a = act.b6.b = act.b6.c = 0.0f;
      act.e_bits = heads[1];
      act.e = 0.0f;
    } else {
      policy_gaussian<S::NC>(logit, std, q, d, k.ref.two_pi, k.ref.u_min, raw, duty);
      act.b6.bits = 0;
      act.b6.a = duty[0];
      act.b6.b = duty[1];
      act.b6.c = duty[2];
      act.e_bits = 0;
      act.e = duty[3];
    }
    const uint4 w = WIENER ? drive_draw(key, (uint32_t)e, (uint32_t)t, DRIVE_SLOT_STEP)
                           : make_uint4(0u, 0u, 0u, 0u);
    const EesmStepOut r = eesm_action_step<FINITE, MECH, NREF>(k, act, x, c, s, refs);
    if (WIENER) {
      ref_wiener_advance<NREF>(k.ref, key, (uint32_t)e, (uint32_t)t, w, r.done != 0.0f, refs);
    }
    const size_t i = (size_t)t * n + e;
    eesm_store_state<MECH>(x, so, i);
    policy_store_common<NREF>(o, i, r.ref, r.reward, r.done);
    policy_store_actions<FINITE, 2, S::NC>(o, i, heads, raw);
  }
}

template <bool FINITE, bool MECH, int NREF, bool JOINT>
__global__ void __launch_bounds__(kPolicyThreads)
eesm_policy_record_kernel(EesmConst k, PolicyConst q, uint2 key, int n, int n_steps,
                          PolicyWeights w, EesmInPlanes in, EesmPlanes so, PolicyOut o) {
  using S = Shape<FINITE, NREF, JOINT>;
  extern __shared__ __align__(16) float sw[];
  policy_stage(sw, S::F, q.h, S::A, FINITE ? 0 : S::NC, w);
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  EesmState x = eesm_load_state<MECH>(in, e);
  float c = 1.0f, s = 0.0f;
  if (!MECH) {
    c = cosf(x.eps);
    s = sinf(x.eps);
  }
  RefRows<NREF> refs;
  ref_wiener_init<NREF>(k.ref, key, (uint32_t)e, refs);
  if (k.flag[EF_ALL_CONST]) {
    policy_loop<FINITE, MECH, NREF, JOINT, false>(k, q, sw, key, e, n, n_steps, x, c, s, refs,
                                                  so, o);
  } else {
    policy_loop<FINITE, MECH, NREF, JOINT, true>(k, q, sw, key, e, n, n_steps, x, c, s, refs,
                                                 so, o);
  }
}

// ---- the lane-group recorder --------------------------------------------

// The designs of the width rule, the fastest of G in {4, 8} x lead or every
// lane at 2048 and 4096 envs x 256 steps, H 32 (PERF.md, slice 25): eight
// lanes, every lane stepping, at both widths (at 2048 envs on
// Finite-CC-EESM, its joint head and Cont-SC-EESM 0.6586, 0.8290 and
// 0.6523 ms against 0.6772, 0.8412 and 0.6094 with lane 0 stepping and 0.83
// to 1.12 on four lanes; over the six EESM ids and the joint head 4.356
// against 4.543 ms in sum at 2048 envs, 4.937 against 5.124 at 4096).  So
// the narrow design is the wide one.  ops/fused_policy.py's
// EESM_POLICY_WIDE and EESM_POLICY_NARROW mirror them.
using WideDesign = LaneDesign<8, false>;
using NarrowDesign = LaneDesign<8, false>;

// The recorded planes of an instance, in the order of eesm_policy_record's
// outputs: [omega,] i_sd, i_sq, i_e, eps, the references, the two heads'
// actions (finite) or the four channels' raw samples, reward and done.
template <bool FINITE, bool MECH, int NREF>
__host__ __device__ constexpr int eesm_policy_planes() {
  return (MECH ? 1 : 0) + 4 + NREF + (FINITE ? 2 : 4) + 2;
}

template <bool FINITE, bool MECH, int NREF, bool JOINT, int G, bool LEAD, bool WIENER>
__device__ __forceinline__ void policy_lanes_loop(const EesmConst& k, const PolicyConst& q,
                                                  const float* sw, uint2 key, int e, int l,
                                                  bool live, int n, int n_steps, EesmState& x,
                                                  float& c, float& s, RefRows<NREF>& refs,
                                                  uint32_t* const* dst) {
  using S = Shape<FINITE, NREF, JOINT>;
  constexpr int NP = eesm_policy_planes<FINITE, MECH, NREF>();
  constexpr int PL = (NP + G - 1) / G;  // planes a lane stores
  const float* std = sw + S::F * q.h + q.h + q.h * S::A + S::A;
#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) {
    policy_barrier();
    if (MECH) {
      c = cosf(x.eps);
      s = sinf(x.eps);
    }
    float obs[S::F];
    obs[0] = MECH ? x.w * q.feat[0] : q.feat[0];
    obs[1] = x.i_sd * q.feat[1];
    obs[2] = x.i_sq * q.feat[2];
    obs[3] = x.i_e * q.feat[3];
    obs[4] = c;
    obs[5] = s;
#pragma unroll
    for (int r = 0; r < NREF; ++r) {
      obs[6 + r] = eesm_quantity(k, r, x);
      obs[6 + NREF + r] = refs.rv[r];
    }
    float logit[S::A];
    policy_mlp_lanes<S::F, S::A, G>(sw, obs, q.h, S::A, l, logit);
    int heads[kPolicyMaxHeads] = {0, 0, 0};
    float raw[S::NC] = {0.0f, 0.0f, 0.0f, 0.0f}, duty[S::NC] = {0.0f, 0.0f, 0.0f, 0.0f};
    float ref[NREF], reward = 0.0f, done = 0.0f;
#pragma unroll
    for (int r = 0; r < NREF; ++r) ref[r] = 0.0f;
    if (!LEAD || l == 0) {
      const PolicyDraw d =
          policy_draw<FINITE ? (JOINT ? 1 : 2) : 4>(key, (uint32_t)e, (uint32_t)t);
      EesmAction act;
      if constexpr (FINITE) {
        policy_heads<2, 8, 4, 1, JOINT>(logit, 8, d, heads);
        act.b6.bits = heads[0];
        act.b6.a = act.b6.b = act.b6.c = 0.0f;
        act.e_bits = heads[1];
        act.e = 0.0f;
      } else {
        policy_gaussian<S::NC>(logit, std, q, d, k.ref.two_pi, k.ref.u_min, raw, duty);
        act.b6.bits = 0;
        act.b6.a = duty[0];
        act.b6.b = duty[1];
        act.b6.c = duty[2];
        act.e_bits = 0;
        act.e = duty[3];
      }
      const uint4 w = WIENER ? drive_draw(key, (uint32_t)e, (uint32_t)t, DRIVE_SLOT_STEP)
                             : make_uint4(0u, 0u, 0u, 0u);
      const EesmStepOut r = eesm_action_step<FINITE, MECH, NREF>(k, act, x, c, s, refs);
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
      x.i_sd = lead_float(x.i_sd, G);
      x.i_sq = lead_float(x.i_sq, G);
      x.i_e = lead_float(x.i_e, G);
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
        heads[0] = lead_int(heads[0], G);
        heads[1] = lead_int(heads[1], G);
      } else {
#pragma unroll
        for (int j = 0; j < S::NC; ++j) raw[j] = lead_float(raw[j], G);
      }
    }
    uint32_t v[NP];
    int j = 0;
    if (MECH) v[j++] = __float_as_uint(x.w);
    v[j++] = __float_as_uint(x.i_sd);
    v[j++] = __float_as_uint(x.i_sq);
    v[j++] = __float_as_uint(x.i_e);
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

// eesm_policy_record on lane groups: G lanes of a warp serve one env, a
// block 128 / G envs, lane 0 alone stepping (LEAD) or every lane; a group
// past the last env steps env n - 1 and stores nothing, so that every lane
// of the warp takes part in each shuffle.
template <bool FINITE, bool MECH, int NREF, bool JOINT, int G, bool LEAD>
__global__ void __launch_bounds__(kPolicyThreads, kPolicyLaneBlocksPerSm)
eesm_policy_record_lanes_kernel(EesmConst k, PolicyConst q, uint2 key, int n, int n_steps,
                                PolicyWeights w, EesmInPlanes in, EesmPlanes so, PolicyOut o) {
  using S = Shape<FINITE, NREF, JOINT>;
  constexpr int NP = eesm_policy_planes<FINITE, MECH, NREF>();
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
  EesmState x = eesm_load_state<MECH>(in, e);
  float c = 1.0f, s = 0.0f;
  if (!MECH) {
    c = cosf(x.eps);
    s = sinf(x.eps);
  }
  RefRows<NREF> refs;
  ref_wiener_init<NREF>(k.ref, key, (uint32_t)e, refs);
  if (k.flag[EF_ALL_CONST]) {
    policy_lanes_loop<FINITE, MECH, NREF, JOINT, G, LEAD, false>(k, q, sw, key, e, l, live, n,
                                                                 n_steps, x, c, s, refs, dst);
  } else {
    policy_lanes_loop<FINITE, MECH, NREF, JOINT, G, LEAD, true>(k, q, sw, key, e, l, live, n,
                                                                n_steps, x, c, s, refs, dst);
  }
}

// ---- the launch --------------------------------------------------------

using LaunchFn = PolicyDesignFn<EesmConst>;

template <bool F, bool M, int NR, bool J>
void launch(const EesmConst& k, const PolicyConst& q, uint2 key, int n, int n_steps,
            const PolicyWeights& w, const float* const* in, void* const* out, const PolicyOut& o,
            cudaStream_t st, int design) {
  using S = Shape<F, NR, J>;
  const PolicyWidth d =
      design == 1 ? kPolicyOneThread : policy_width<WideDesign, NarrowDesign>(n);
  if (d == kPolicyWide) {
    policy_launch(eesm_policy_record_lanes_kernel<F, M, NR, J, WideDesign::G, WideDesign::LEAD>,
                  S::F, F ? 0 : S::NC, k, q, key, n, n_steps, w, in, out, o, st, WideDesign::G);
  } else if (d == kPolicyNarrow) {
    policy_launch(
        eesm_policy_record_lanes_kernel<F, M, NR, J, NarrowDesign::G, NarrowDesign::LEAD>, S::F,
        F ? 0 : S::NC, k, q, key, n, n_steps, w, in, out, o, st, NarrowDesign::G);
  } else {
    policy_launch(eesm_policy_record_kernel<F, M, NR, J>, S::F, F ? 0 : S::NC, k, q, key, n,
                  n_steps, w, in, out, o, st);
  }
}

// indexed by eesm_random_index(); the joint table by its finite half
const LaunchFn kLaunch[8] = {launch<false, false, 1, false>, launch<false, false, 3, false>,
                             launch<false, true, 1, false>,  launch<false, true, 3, false>,
                             launch<true, false, 1, false>,  launch<true, false, 3, false>,
                             launch<true, true, 1, false>,   launch<true, true, 3, false>};
const LaunchFn kLaunchJoint[4] = {launch<true, false, 1, true>, launch<true, false, 3, true>,
                                  launch<true, true, 1, true>, launch<true, true, 3, true>};

}  // namespace

extern "C" {

POLICY_C_INFO(eesm, N_EESM_CONST, N_EESM_FLAG)

// The recorder in a given design (0: the width rule at n, as
// eesm_policy_record; 1: one thread per env, the design a full card takes),
// for the tests and tools that hold the designs against each other.
int eesm_policy_record_design(const float* consts, const int* flags, const float* pk,
                              const int* pi, unsigned long long seed, int n, int n_steps,
                              int hidden, const float* w1, const float* b1, const float* w2,
                              const float* b2, const float* ls, const float* const* in,
                              void* const* out, int design, void* stream) {
  const int idx = eesm_random_index(flags);
  const int finite = flags[EF_FINITE] != 0, joint = pi[1 + kPolicyMaxHeads] != 0;
  const bool ok = idx >= 0 && pi[0] == (finite ? 2 : 0) && !(joint && !finite);
  const LaunchFn fn = !ok ? nullptr : joint ? kLaunchJoint[idx - 4] : kLaunch[idx];
  const int n_out = !finite ? 4 : (joint ? 32 : 12);
  return policy_design_call(fn, eesm_load_const(consts, flags), pk, pi, seed, n, n_steps, hidden,
                            n_out, {w1, b1, w2, b2, ls}, in, out, kStateSlots, design, stream);
}

// As sync_policy_record; in: (omega or NULL, i_sd, i_sq, i_e, eps); out:
// those five planes, then the PolicyOut planes, each (T, N).  Runs on lane
// groups or one thread per env by the width rule (policy_width).
int eesm_policy_record(const float* consts, const int* flags, const float* pk, const int* pi,
                       unsigned long long seed, int n, int n_steps, int hidden, const float* w1,
                       const float* b1, const float* w2, const float* b2, const float* ls,
                       const float* const* in, void* const* out, void* stream) {
  return eesm_policy_record_design(consts, flags, pk, pi, seed, n, n_steps, hidden, w1, b1, w2,
                                   b2, ls, in, out, 0, stream);
}

// The launch of eesm_policy_record over n envs on the current device: out =
// (lanes an env, lane 0 alone stepping, blocks of kPolicyThreads, the
// card's SMs).
int eesm_policy_layout(int n, int* out) {
  policy_layout<WideDesign, NarrowDesign>(n, out);
  return 0;
}

}  // extern "C"
