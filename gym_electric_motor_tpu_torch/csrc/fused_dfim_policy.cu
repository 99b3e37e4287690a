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
#include <cuda_runtime.h>

#include "dfim_step.cuh"
#include "policy_heads.cuh"

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

using LaunchFn = PolicyLaunchFn<DfimConst>;

template <bool F, bool M, int NR, bool J>
void launch(const DfimConst& k, const PolicyConst& q, uint2 key, int n, int n_steps,
            const PolicyWeights& w, const float* const* in, void* const* out, const PolicyOut& o,
            cudaStream_t st) {
  using S = Shape<F, NR, J>;
  policy_launch(dfim_policy_record_kernel<F, M, NR, J>, S::F, F ? 0 : S::NC, k, q, key, n,
                n_steps, w, in, out, o, st);
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

// As sync_policy_record; in: (omega or NULL, i_salpha, i_sbeta,
// psi_ralpha, psi_rbeta, eps); out: those six planes, then the PolicyOut
// planes, each (T, N).
int dfim_policy_record(const float* consts, const int* flags, const float* pk, const int* pi,
                       unsigned long long seed, int n, int n_steps, int hidden, const float* w1,
                       const float* b1, const float* w2, const float* b2, const float* ls,
                       const float* const* in, void* const* out, void* stream) {
  const int idx = dfim_random_index(flags);
  const int finite = flags[DF_FINITE] != 0, joint = pi[1 + kPolicyMaxHeads] != 0;
  const bool ok = idx >= 0 && pi[0] == (finite ? 2 : 0) && !(joint && !finite);
  const LaunchFn fn = !ok ? nullptr : joint ? kLaunchJoint[idx - 4] : kLaunch[idx];
  const int n_out = !finite ? 6 : (joint ? 64 : 16);
  return policy_call(fn, dfim_load_const(consts, flags), pk, pi, seed, n, n_steps, hidden, n_out,
                     {w1, b1, w2, b2, ls}, in, out, kStateSlots, stream);
}

}  // extern "C"
