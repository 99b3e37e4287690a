// The universal policy-in-the-loop recorder of the synchronous family (PMSM
// and SynRM, the twelve {Finite, Cont} x {CC, TC, SC} ids) for Hopper
// (sm_90a), with a plain C interface for ctypes (every function returns
// cudaGetLastError()).
//
// Replaces (gym_electric_motor_tpu/ops/):
//   sync_policy_record  pallas_policy.py  make_fused_policy_record_universal (:1256),
//                                         for the sync family
//
// Design: one thread per env, the state, the Park rotation and the
// reference rows in registers across a `#pragma unroll 1` loop over T
// steps; each step reads the observation (omega, i_sd and i_sq over their
// limits, the rotation's (cos, sin), the referenced quantities of the
// pre-step state, the references before they advance), runs the MLP of
// policy_heads.cuh on the weights the block staged in shared memory, picks
// the action (one 8-way head for the B6 bits, or three squashed-Gaussian
// duties) and then takes sync_action_step and the reference advance of the
// random kernels (sync_step.cuh).  Stores are [t, env].  The TPU kernel's
// chunked grid and per-chunk reseed (pallas_policy.py:1063) do not carry
// over.  Templates FINITE, MECH, NREF (8 instances), H at run time; built
// with -fmad=false.
//
// What bounds it on this card: beside the step's operations (see
// fused_sync.cu), the MLP's F H + H A multiplies and adds (as separate
// FMUL and FADD), H tanhf and, finite, 8 expf; 4 bytes per signal and
// env-step of HBM writes (7 to 10 signals).  chip_smoke.py takes the
// per-step count from tools/sass_ops.py, the hidden loop's body H times.
//
// At PPO's width.  Fused PPO collects 2048 envs: one thread per env is 16
// blocks of 128 threads on 16 of the card's 132 SMs, each thread working
// through the MLP's F H + H A multiply-adds (544 at H 32 on a two-row
// finite id), H tanhf and 8 expf a step on its own chain (1.35% of the
// bound at 2048 x 64, H 32; PERF.md).  On lane groups, as the DC family's
// recorder (fused_dc_policy.cu, over policy_heads_lanes.cuh), G lanes of a
// warp serve one env: a lane computes the hidden units j = l, l + G, ...
// and its share of the logits, gathering the hidden values by __shfl_sync
// in the one-thread kernel's order, and lane p % G stores recorded plane
// p.  A design either lets lane 0 alone sample and step the env and pass
// on what the next observation and the stores read (the state, the
// constant-speed rotation, the references, reward, done and the heads or
// raw samples; under the speed ODE every lane takes cos and sin of the
// passed angle itself), or has every lane do so on the same operands.  The
// launch takes the family's wide design while the one-thread launch would
// put at most one block on each SM, its narrow one while it would put at
// most three, else one thread per env (policy_heads_lanes.cuh's
// policy_width).  Every design equals the one-thread kernel bit for bit;
// the one-thread kernel stays tools/sass_ops.py's count of the function's
// own work.
#include <cuda_runtime.h>

#include "policy_heads.cuh"
#include "policy_heads_lanes.cuh"
#include "sync_step.cuh"

namespace {

constexpr int kStateSlots = 4;  // (omega or NULL, i_sd, i_sq, eps)

template <bool FINITE, int NREF>
struct Shape {
  static constexpr int F = 5 + 2 * NREF;
  static constexpr int NC = 3;
  static constexpr int A = FINITE ? 8 : NC;
};

template <bool FINITE, bool MECH, int NREF, bool WIENER>
__device__ __forceinline__ void policy_loop(const SyncConst& k, const PolicyConst& q,
                                            const float* sw, uint2 key, int e, int n,
                                            int n_steps, SyncState& x, float& c, float& s,
                                            RefRows<NREF>& refs, float* const* so,
                                            const PolicyOut& o) {
  using S = Shape<FINITE, NREF>;
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
    obs[3] = c;
    obs[4] = s;
#pragma unroll
    for (int r = 0; r < NREF; ++r) {
      obs[5 + r] = sync_quantity(k, r, x);
      obs[5 + NREF + r] = refs.rv[r];
    }
    float logit[S::A];
    policy_mlp<S::F, S::A>(sw, obs, q.h, S::A, logit);
    const PolicyDraw d = policy_draw<FINITE ? 1 : 4>(key, (uint32_t)e, (uint32_t)t);
    int heads[kPolicyMaxHeads] = {0, 0, 0};
    float raw[S::NC] = {0.0f, 0.0f, 0.0f}, duty[S::NC] = {0.0f, 0.0f, 0.0f};
    SyncAction act;
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
    const SyncStepOut r = sync_action_step<FINITE, MECH, NREF>(k, act, x, c, s, refs);
    if (WIENER) {
      ref_wiener_advance<NREF>(k.ref, key, (uint32_t)e, (uint32_t)t, w, r.done != 0.0f, refs);
    }
    const size_t i = (size_t)t * n + e;
    if (MECH) so[0][i] = x.w;
    so[1][i] = x.i_sd;
    so[2][i] = x.i_sq;
    so[3][i] = x.eps;
    policy_store_common<NREF>(o, i, r.ref, r.reward, r.done);
    policy_store_actions<FINITE, 1, S::NC>(o, i, heads, raw);
  }
}

template <bool FINITE, bool MECH, int NREF>
__global__ void __launch_bounds__(kPolicyThreads)
sync_policy_record_kernel(SyncConst k, PolicyConst q, uint2 key, int n, int n_steps,
                          PolicyWeights w, PolicyInPlanes<kStateSlots> in,
                          PolicyOutPlanes<kStateSlots> so, PolicyOut o) {
  using S = Shape<FINITE, NREF>;
  extern __shared__ __align__(16) float sw[];
  policy_stage(sw, S::F, q.h, S::A, FINITE ? 0 : S::NC, w);
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  SyncState x;
  x.w = MECH ? in.p[0][e] : 0.0f;
  x.i_sd = in.p[1][e];
  x.i_sq = in.p[2][e];
  x.eps = in.p[3][e];
  float c = 1.0f, s = 0.0f;
  if (!MECH) {
    c = cosf(x.eps);
    s = sinf(x.eps);
  }
  RefRows<NREF> refs;
  ref_wiener_init<NREF>(k.ref, key, (uint32_t)e, refs);
  if (k.flag[F_ALL_CONST]) {
    policy_loop<FINITE, MECH, NREF, false>(k, q, sw, key, e, n, n_steps, x, c, s, refs, so.p, o);
  } else {
    policy_loop<FINITE, MECH, NREF, true>(k, q, sw, key, e, n, n_steps, x, c, s, refs, so.p, o);
  }
}

// ---- the lane-group recorder --------------------------------------------

// The designs of the width rule, the fastest of G in {4, 8} x lead or every
// lane at 2048 and 4096 envs x 256 steps, H 32, on Finite-CC-PMSM,
// Cont-CC-PMSM and Cont-SC-PMSM (PERF.md, slice 24): eight lanes, every
// lane stepping, at both widths (at 2048 envs 0.4348, 0.4497 and 0.4381 ms
// against 0.4783, 0.4659 and 0.4497 with lane 0 stepping and 0.59 to 0.67
// on four lanes; at 4096 envs 0.4948, 0.5196 and 0.5143 against 0.5307,
// 0.5420 and 0.5332 and 0.59 to 0.67).  So the narrow design is the wide
// one, and one lane instance serves both.  ops/fused_policy.py's
// SYNC_POLICY_WIDE and SYNC_POLICY_NARROW mirror them.
using WideDesign = LaneDesign<8, false>;
using NarrowDesign = LaneDesign<8, false>;

// The recorded planes of an instance, in the order of sync_policy_record's
// outputs: [omega,] i_sd, i_sq, eps, the references, the head's action
// (finite) or the three channels' raw samples, reward and done.
template <bool FINITE, bool MECH, int NREF>
__host__ __device__ constexpr int sync_policy_planes() {
  return (MECH ? 1 : 0) + 3 + NREF + (FINITE ? 1 : Shape<FINITE, NREF>::NC) + 2;
}

template <bool FINITE, bool MECH, int NREF, int G, bool LEAD, bool WIENER>
__device__ __forceinline__ void policy_lanes_loop(const SyncConst& k, const PolicyConst& q,
                                                  const float* sw, uint2 key, int e, int l,
                                                  bool live, int n, int n_steps, SyncState& x,
                                                  float& c, float& s, RefRows<NREF>& refs,
                                                  uint32_t* const* dst) {
  using S = Shape<FINITE, NREF>;
  constexpr int NP = sync_policy_planes<FINITE, MECH, NREF>();
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
    obs[3] = c;
    obs[4] = s;
#pragma unroll
    for (int r = 0; r < NREF; ++r) {
      obs[5 + r] = sync_quantity(k, r, x);
      obs[5 + NREF + r] = refs.rv[r];
    }
    float logit[S::A];
    policy_mlp_lanes<S::F, S::A, G>(sw, obs, q.h, S::A, l, logit);
    int heads[kPolicyMaxHeads] = {0, 0, 0};
    float raw[S::NC] = {0.0f, 0.0f, 0.0f}, duty[S::NC] = {0.0f, 0.0f, 0.0f};
    float ref[2] = {0.0f, 0.0f}, reward = 0.0f, done = 0.0f;
    if (!LEAD || l == 0) {
      const PolicyDraw d = policy_draw<FINITE ? 1 : 4>(key, (uint32_t)e, (uint32_t)t);
      SyncAction act;
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
      const SyncStepOut r = sync_action_step<FINITE, MECH, NREF>(k, act, x, c, s, refs);
      if (WIENER) {
        ref_wiener_advance<NREF>(k.ref, key, (uint32_t)e, (uint32_t)t, w, r.done != 0.0f, refs);
      }
      ref[0] = r.ref[0];
      ref[1] = r.ref[1];
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
    v[j++] = __float_as_uint(x.eps);
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

// sync_policy_record on lane groups: G lanes of a warp serve one env, a
// block 128 / G envs, lane 0 alone stepping (LEAD) or every lane; a group
// past the last env steps env n - 1 and stores nothing, so that every lane
// of the warp takes part in each shuffle.
template <bool FINITE, bool MECH, int NREF, int G, bool LEAD>
__global__ void __launch_bounds__(kPolicyThreads)
sync_policy_record_lanes_kernel(SyncConst k, PolicyConst q, uint2 key, int n, int n_steps,
                                PolicyWeights w, PolicyInPlanes<kStateSlots> in,
                                PolicyOutPlanes<kStateSlots> so, PolicyOut o) {
  using S = Shape<FINITE, NREF>;
  constexpr int NP = sync_policy_planes<FINITE, MECH, NREF>();
  constexpr int PL = (NP + G - 1) / G;
  extern __shared__ __align__(16) float sw[];
  policy_stage(sw, S::F, q.h, S::A, FINITE ? 0 : S::NC, w);
  const int ge = (int)((blockIdx.x * blockDim.x + threadIdx.x) / G);
  const bool live = ge < n;
  const int e = live ? ge : n - 1;
  const int l = (int)(threadIdx.x % G);
  uint32_t* planes[NP];
  int j = 0;
  if (MECH) planes[j++] = reinterpret_cast<uint32_t*>(so.p[0]);
  planes[j++] = reinterpret_cast<uint32_t*>(so.p[1]);
  planes[j++] = reinterpret_cast<uint32_t*>(so.p[2]);
  planes[j++] = reinterpret_cast<uint32_t*>(so.p[3]);
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
  SyncState x;
  x.w = MECH ? in.p[0][e] : 0.0f;
  x.i_sd = in.p[1][e];
  x.i_sq = in.p[2][e];
  x.eps = in.p[3][e];
  float c = 1.0f, s = 0.0f;
  if (!MECH) {
    c = cosf(x.eps);
    s = sinf(x.eps);
  }
  RefRows<NREF> refs;
  ref_wiener_init<NREF>(k.ref, key, (uint32_t)e, refs);
  if (k.flag[F_ALL_CONST]) {
    policy_lanes_loop<FINITE, MECH, NREF, G, LEAD, false>(k, q, sw, key, e, l, live, n, n_steps,
                                                          x, c, s, refs, dst);
  } else {
    policy_lanes_loop<FINITE, MECH, NREF, G, LEAD, true>(k, q, sw, key, e, l, live, n, n_steps,
                                                         x, c, s, refs, dst);
  }
}

// ---- the launch --------------------------------------------------------

using LaunchFn = PolicyDesignFn<SyncConst>;

template <bool F, bool M, int NR>
void launch(const SyncConst& k, const PolicyConst& q, uint2 key, int n, int n_steps,
            const PolicyWeights& w, const float* const* in, void* const* out,
            const PolicyOut& o, cudaStream_t st, int design) {
  using S = Shape<F, NR>;
  const PolicyWidth d =
      design == 1 ? kPolicyOneThread : policy_width<WideDesign, NarrowDesign>(n);
  if (d == kPolicyWide) {
    policy_launch(sync_policy_record_lanes_kernel<F, M, NR, WideDesign::G, WideDesign::LEAD>,
                  S::F, F ? 0 : S::NC, k, q, key, n, n_steps, w, in, out, o, st, WideDesign::G);
  } else if (d == kPolicyNarrow) {
    policy_launch(sync_policy_record_lanes_kernel<F, M, NR, NarrowDesign::G, NarrowDesign::LEAD>,
                  S::F, F ? 0 : S::NC, k, q, key, n, n_steps, w, in, out, o, st,
                  NarrowDesign::G);
  } else {
    policy_launch(sync_policy_record_kernel<F, M, NR>, S::F, F ? 0 : S::NC, k, q, key, n,
                  n_steps, w, in, out, o, st);
  }
}

// indexed by 4 * finite + 2 * mech + nref - 1
const LaunchFn kLaunch[8] = {launch<false, false, 1>, launch<false, false, 2>,
                             launch<false, true, 1>,  launch<false, true, 2>,
                             launch<true, false, 1>,  launch<true, false, 2>,
                             launch<true, true, 1>,   launch<true, true, 2>};

}  // namespace

extern "C" {

POLICY_C_INFO(sync, N_SYNC_CONST, N_SYNC_FLAG)

// The recorder in a given design (0: the width rule at n, as
// sync_policy_record; 1: one thread per env, the design a full card takes),
// for the tests and tools that hold the designs against each other.
int sync_policy_record_design(const float* consts, const int* flags, const float* pk,
                              const int* pi, unsigned long long seed, int n, int n_steps,
                              int hidden, const float* w1, const float* b1, const float* w2,
                              const float* b2, const float* ls, const float* const* in,
                              void* const* out, int design, void* stream) {
  const int finite = flags[F_FINITE] != 0;
  const bool ok = (flags[F_NREF] == 1 || flags[F_NREF] == 2) && pi[0] == finite
                  && pi[1 + kPolicyMaxHeads] == 0;
  const LaunchFn fn =
      ok ? kLaunch[4 * finite + 2 * (flags[F_MECH] != 0) + flags[F_NREF] - 1] : nullptr;
  return policy_design_call(fn, sync_load_const(consts, flags), pk, pi, seed, n, n_steps, hidden,
                            finite ? 8 : 3, {w1, b1, w2, b2, ls}, in, out, kStateSlots, design,
                            stream);
}

// pk, pi: the policy constants (PolicyConst); w1, b1, w2, b2, ls: the flat
// weights and log-stds (ls NULL for a finite env); in: (omega or NULL,
// i_sd, i_sq, eps); out: those four planes, then the PolicyOut planes, each
// (T, N).  Runs on lane groups or one thread per env by the width rule
// (policy_width).  Returns cudaErrorInvalidValue for flags no instance
// serves.
int sync_policy_record(const float* consts, const int* flags, const float* pk, const int* pi,
                       unsigned long long seed, int n, int n_steps, int hidden, const float* w1,
                       const float* b1, const float* w2, const float* b2, const float* ls,
                       const float* const* in, void* const* out, void* stream) {
  return sync_policy_record_design(consts, flags, pk, pi, seed, n, n_steps, hidden, w1, b1, w2,
                                   b2, ls, in, out, 0, stream);
}

// The launch of sync_policy_record over n envs on the current device: out =
// (lanes an env, lane 0 alone stepping, blocks of kPolicyThreads, the
// card's SMs).
int sync_policy_layout(int n, int* out) {
  policy_layout<WideDesign, NarrowDesign>(n, out);
  return 0;
}

}  // extern "C"
