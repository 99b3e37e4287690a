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
#include <cuda_runtime.h>

#include "policy_heads.cuh"
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

using LaunchFn = PolicyLaunchFn<SyncConst>;

template <bool F, bool M, int NR>
void launch(const SyncConst& k, const PolicyConst& q, uint2 key, int n, int n_steps,
            const PolicyWeights& w, const float* const* in, void* const* out,
            const PolicyOut& o, cudaStream_t st) {
  using S = Shape<F, NR>;
  policy_launch(sync_policy_record_kernel<F, M, NR>, S::F, F ? 0 : S::NC, k, q, key, n, n_steps,
                w, in, out, o, st);
}

// indexed by 4 * finite + 2 * mech + nref - 1
const LaunchFn kLaunch[8] = {launch<false, false, 1>, launch<false, false, 2>,
                             launch<false, true, 1>,  launch<false, true, 2>,
                             launch<true, false, 1>,  launch<true, false, 2>,
                             launch<true, true, 1>,   launch<true, true, 2>};

}  // namespace

extern "C" {

POLICY_C_INFO(sync, N_SYNC_CONST, N_SYNC_FLAG)

// pk, pi: the policy constants (PolicyConst); w1, b1, w2, b2, ls: the flat
// weights and log-stds (ls NULL for a finite env); in: (omega or NULL,
// i_sd, i_sq, eps); out: those four planes, then the PolicyOut planes, each
// (T, N).  Returns cudaErrorInvalidValue for flags no instance serves.
int sync_policy_record(const float* consts, const int* flags, const float* pk, const int* pi,
                       unsigned long long seed, int n, int n_steps, int hidden, const float* w1,
                       const float* b1, const float* w2, const float* b2, const float* ls,
                       const float* const* in, void* const* out, void* stream) {
  const int finite = flags[F_FINITE] != 0;
  const bool ok = (flags[F_NREF] == 1 || flags[F_NREF] == 2) && pi[0] == finite
                  && pi[1 + kPolicyMaxHeads] == 0;
  const LaunchFn fn =
      ok ? kLaunch[4 * finite + 2 * (flags[F_MECH] != 0) + flags[F_NREF] - 1] : nullptr;
  return policy_call(fn, sync_load_const(consts, flags), pk, pi, seed, n, n_steps, hidden,
                     finite ? 8 : 3, {w1, b1, w2, b2, ls}, in, out, kStateSlots, stream);
}

}  // extern "C"
