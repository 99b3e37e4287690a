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
#include <cuda_runtime.h>

#include "policy_heads.cuh"
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

using LaunchFn = PolicyLaunchFn<SrmConst>;

template <bool F, bool M, int NR, bool SAT, bool J>
void launch(const SrmConst& k, const PolicyConst& q, uint2 key, int n, int n_steps,
            const PolicyWeights& w, const float* const* in, void* const* out, const PolicyOut& o,
            cudaStream_t st) {
  using S = Shape<F, NR, J>;
  policy_launch(srm_policy_record_kernel<F, M, NR, SAT, J>, S::F, F ? 0 : S::NC, k, q, key, n,
                n_steps, w, in, out, o, st);
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

// As sync_policy_record; in: (omega or NULL, i_a, i_b, i_c, eps); out:
// those five planes, then the PolicyOut planes, each (T, N).
int srm_policy_record(const float* consts, const int* flags, const float* pk, const int* pi,
                      unsigned long long seed, int n, int n_steps, int hidden, const float* w1,
                      const float* b1, const float* w2, const float* b2, const float* ls,
                      const float* const* in, void* const* out, void* stream) {
  const int idx = srm_random_index(flags);
  const int finite = flags[SF_FINITE] != 0, joint = pi[1 + kPolicyMaxHeads] != 0;
  const bool ok = idx >= 0 && pi[0] == (finite ? 3 : 0) && !(joint && !finite);
  const LaunchFn fn = !ok    ? nullptr
                      : joint ? kLaunchJoint[4 * (flags[SF_SAT] != 0) + (idx & 3)]
                              : kLaunch[idx];
  const int n_out = !finite ? 3 : (joint ? 27 : 9);
  return policy_call(fn, srm_load_const(consts, flags), pk, pi, seed, n, n_steps, hidden, n_out,
                     {w1, b1, w2, b2, ls}, in, out, kStateSlots, stream);
}

}  // extern "C"
