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
#include <cuda_runtime.h>

#include "eesm_step.cuh"
#include "policy_heads.cuh"

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

using LaunchFn = PolicyLaunchFn<EesmConst>;

template <bool F, bool M, int NR, bool J>
void launch(const EesmConst& k, const PolicyConst& q, uint2 key, int n, int n_steps,
            const PolicyWeights& w, const float* const* in, void* const* out, const PolicyOut& o,
            cudaStream_t st) {
  using S = Shape<F, NR, J>;
  policy_launch(eesm_policy_record_kernel<F, M, NR, J>, S::F, F ? 0 : S::NC, k, q, key, n,
                n_steps, w, in, out, o, st);
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

// As sync_policy_record; in: (omega or NULL, i_sd, i_sq, i_e, eps); out:
// those five planes, then the PolicyOut planes, each (T, N).
int eesm_policy_record(const float* consts, const int* flags, const float* pk, const int* pi,
                       unsigned long long seed, int n, int n_steps, int hidden, const float* w1,
                       const float* b1, const float* w2, const float* b2, const float* ls,
                       const float* const* in, void* const* out, void* stream) {
  const int idx = eesm_random_index(flags);
  const int finite = flags[EF_FINITE] != 0, joint = pi[1 + kPolicyMaxHeads] != 0;
  const bool ok = idx >= 0 && pi[0] == (finite ? 2 : 0) && !(joint && !finite);
  const LaunchFn fn = !ok ? nullptr : joint ? kLaunchJoint[idx - 4] : kLaunch[idx];
  const int n_out = !finite ? 4 : (joint ? 32 : 12);
  return policy_call(fn, eesm_load_const(consts, flags), pk, pi, seed, n, n_steps, hidden, n_out,
                     {w1, b1, w2, b2, ls}, in, out, kStateSlots, stream);
}

}  // extern "C"
