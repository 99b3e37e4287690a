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
#include <cuda_runtime.h>

#include "induction_step.cuh"
#include "policy_heads.cuh"

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

using LaunchFn = PolicyLaunchFn<InductionConst>;

template <bool F, bool M, int NR>
void launch(const InductionConst& k, const PolicyConst& q, uint2 key, int n, int n_steps,
            const PolicyWeights& w, const float* const* in, void* const* out, const PolicyOut& o,
            cudaStream_t st) {
  using S = Shape<F, NR>;
  policy_launch(induction_policy_record_kernel<F, M, NR>, S::F, F ? 0 : S::NC, k, q, key, n,
                n_steps, w, in, out, o, st);
}

// indexed by ind_random_index()
const LaunchFn kLaunch[8] = {launch<false, false, 1>, launch<false, false, 2>,
                             launch<false, true, 1>,  launch<false, true, 2>,
                             launch<true, false, 1>,  launch<true, false, 2>,
                             launch<true, true, 1>,   launch<true, true, 2>};

}  // namespace

extern "C" {

POLICY_C_INFO(induction, N_INDUCTION_CONST, N_INDUCTION_FLAG)

// As sync_policy_record; in: (omega or NULL, i_salpha, i_sbeta,
// psi_ralpha, psi_rbeta); out: those five planes, then the PolicyOut
// planes, each (T, N).
int induction_policy_record(const float* consts, const int* flags, const float* pk,
                            const int* pi, unsigned long long seed, int n, int n_steps,
                            int hidden, const float* w1, const float* b1, const float* w2,
                            const float* b2, const float* ls, const float* const* in,
                            void* const* out, void* stream) {
  const int idx = ind_random_index(flags);
  const int finite = flags[IF_FINITE] != 0;
  const bool ok = idx >= 0 && pi[0] == finite && pi[1 + kPolicyMaxHeads] == 0;
  return policy_call(ok ? kLaunch[idx] : nullptr, ind_load_const(consts, flags), pk, pi, seed, n,
                     n_steps, hidden, finite ? 8 : 3, {w1, b1, w2, b2, ls}, in, out,
                     kStateSlots, stream);
}

}  // extern "C"
