// The specialised Cont-TC-SCIM fused rollout for Hopper (sm_90a), in a
// random-action and an action-buffer mode, with a plain C interface for
// ctypes (every function returns cudaGetLastError()).
//
// Replaces (gym_electric_motor_tpu/ops/):
//   scim_rollout_buffer  pallas_induction.py  make_fused_scim_rollout, buffer mode (:220)
//   scim_rollout_random  pallas_induction.py  make_fused_scim_rollout, random mode (:235)
//
// The step (pallas_induction.py:67-201): three continuous B6 duties (phase
// voltage a u_sup / 2), Clarke and one RK4 step of the 4-state alpha-beta
// ODE at constant speed (rotor shorted) are induction_step.cuh's
// ind_physics<continuous, constant speed> with the induction family's
// constants of the env (InductionConst, from ops/fused_induction_family.py's
// InductionConsts on the host: the divisions by tau_sig and tau_r are
// products with their float32 reciprocals, as XLA compiles them); then the
// torque k_t (psi_a i_b - psi_b i_a) (ind_torque), the squared current
// constraint on |i_alphabeta|^2 / i_lim^2 (the Park rotation keeps the
// norm, so no field angle is needed), the WSE reward -|T_n - ref| / 2
// against the pre-advance torque reference, the reset of a violating env to
// zeros, and the Wiener torque reference with the builder's constants
// (lengths floor(U[500, 2000)), sigma 10^U[-3, -1], the margin nominal /
// limit of the torque).
//
// Design: one thread per env, the state and the reference row in
// registers across a `#pragma unroll 1` loop over T steps.  Random bits
// from Philox4x32-10, counter (env, step, slot): SPEC_SLOT_STEP gives the
// three duties (a, b, c, -) every step, SPEC_SLOT_EXTRA the Box-Muller
// (u1, u2, -, -) at even steps only (its sine kept for the odd step,
// pallas_induction.py:167-184), SPEC_SLOT_PARAMS (length, sigma, reset
// value, -) where the row regenerates, SPEC_SLOT_INIT_0 (value, length,
// sigma, -) at step 0.  Built with -fmad=false (ops/cuda_build.py), so each
// multiply and add rounds as in the plain PyTorch version
// (ops/fused_induction.py).
//
// What bounds it on this card: 4 planes in and 10 out per env (and 12 bytes
// of duty per env-step in buffer mode); the step is four stages of the
// 4-state right-hand side (about 100 FP32 operations), the Clarke
// transform, the torque, one Philox call, and at every second step a second
// call and the Box-Muller pair.
#include "induction_step.cuh"
#include "specialised_step.cuh"

// The builder's own constants; the physics takes the induction family's
// (InductionConst).
enum ScimConstIndex {
  SC_INV_T_LIM = 0,   // 1 / torque limit
  SC_NEG_W,           // -1/2
  SC_VIOLATION_REWARD,
  SC_MARGIN,          // nominal / limit of the torque
  SC_EP_LO,           // SpecParams: 500, 1500, -3, 2, ln 10
  SC_EP_SPAN,
  SC_SIG_BASE,
  SC_SIG_SPAN,
  SC_LN10,
  SC_U_MIN,
  SC_TWO_PI,
  N_SCIM_CONST
};

struct ScimConst {
  float v[N_SCIM_CONST];
};

namespace {

// The phase voltages (duty times u_sup / 2), Clarke, one RK4 step.
__device__ __forceinline__ InductionState scim_physics(const InductionConst& ic,
                                                       const InductionState& x, float da,
                                                       float db, float dc) {
  InductionState y = x;
  ind_physics<false, false>(ic, B6Action{0, da, db, dc}, y);
  return y;
}

__device__ __forceinline__ SpecParams scim_params(const ScimConst& k) {
  return SpecParams{k.v[SC_EP_LO], k.v[SC_EP_SPAN], k.v[SC_SIG_BASE], k.v[SC_SIG_SPAN],
                    k.v[SC_LN10]};
}

__device__ __forceinline__ float scim_value(const ScimConst& k, uint32_t b) {
  return (2.0f * uniform24(b) - 1.0f) * k.v[SC_MARGIN];
}

__global__ void scim_rollout_random_kernel(InductionConst ic, ScimConst k, uint2 key, int n,
                                           int n_steps, SpecIn in, SpecOut out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  InductionState x{0.0f, in.p[0][e], in.p[1][e], in.p[2][e], in.p[3][e]};
  SpecRow r;
  {
    const uint4 w0 = spec_draw(key, (uint32_t)e, 0u, SPEC_SLOT_INIT_0);
    r.rv = scim_value(k, w0.x);
    r.rk = 0.0f;
    spec_params(scim_params(k), w0.y, w0.z, r.rl, r.rs);
  }
  float reward = 0.0f, terms = 0.0f, zb = 0.0f;
#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) {
    const uint4 w = spec_draw(key, (uint32_t)e, (uint32_t)t, SPEC_SLOT_STEP);
    const InductionState y = scim_physics(ic, x, 2.0f * uniform24(w.x) - 1.0f,
                                          2.0f * uniform24(w.y) - 1.0f,
                                          2.0f * uniform24(w.z) - 1.0f);
    const float t_n = ind_torque(ic, y.isa, y.isb, y.psa, y.psb) * k.v[SC_INV_T_LIM];
    const bool violated = (y.isa * y.isa + y.isb * y.isb) * ic.v[I_INV_ILIM2] > 1.0f;
    reward += violated ? k.v[SC_VIOLATION_REWARD] : k.v[SC_NEG_W] * fabsf(t_n - r.rv);
    terms += violated ? 1.0f : 0.0f;
    x.isa = violated ? 0.0f : y.isa;
    x.isb = violated ? 0.0f : y.isb;
    x.psa = violated ? 0.0f : y.psa;
    x.psb = violated ? 0.0f : y.psb;
    float draw;
    if ((t & 1) == 0) {
      const uint4 b = spec_draw(key, (uint32_t)e, (uint32_t)t, SPEC_SLOT_EXTRA);
      spec_box_muller(k.v[SC_U_MIN], k.v[SC_TWO_PI], b.x, b.y, draw, zb);
    } else {
      draw = zb;
    }
    const bool regen = (r.rk >= r.rl) || violated;
    float rl = 0.0f, rs = 0.0f;
    uint4 p = make_uint4(0u, 0u, 0u, 0u);
    if (regen) {
      p = spec_draw(key, (uint32_t)e, (uint32_t)t, SPEC_SLOT_PARAMS);
      spec_params(scim_params(k), p.x, p.y, rl, rs);
    }
    const float m = k.v[SC_MARGIN];
    spec_row_walk(r, regen, rl, rs, draw, -m, m);
    if (violated) r.rv = scim_value(k, p.z);
  }
  out.p[0][e] = x.isa;
  out.p[1][e] = x.isb;
  out.p[2][e] = x.psa;
  out.p[3][e] = x.psb;
  out.p[4][e] = reward;
  out.p[5][e] = terms;
  out.p[6][e] = r.rv;
  out.p[7][e] = r.rk;
  out.p[8][e] = r.rl;
  out.p[9][e] = r.rs;
}

__global__ void scim_rollout_buffer_kernel(InductionConst ic, int n, int n_steps, SpecIn in,
                                           const float* __restrict__ actions, SpecOut out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  InductionState x{0.0f, in.p[0][e], in.p[1][e], in.p[2][e], in.p[3][e]};
#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) {
    const size_t at = (size_t)t * 3 * n + e;
    x = scim_physics(ic, x, actions[at], actions[at + n], actions[at + 2 * (size_t)n]);
  }
  out.p[0][e] = x.isa;
  out.p[1][e] = x.isb;
  out.p[2][e] = x.psa;
  out.p[3][e] = x.psb;
}

ScimConst sc_consts(const float* spec) {
  ScimConst k;
  for (int j = 0; j < N_SCIM_CONST; ++j) k.v[j] = spec[j];
  return k;
}

}  // namespace

extern "C" {

SPEC_FAMILY_C_INFO(scim, N_INDUCTION_CONST, N_ROW_CONST, N_INDUCTION_FLAG, N_SCIM_CONST)

// consts and flags: the induction family's (induction_step.cuh) for
// Cont-TC-SCIM; spec: the builder's own (ScimConstIndex), which the buffer
// kernel does not read (its step is the family's alone).
// in: (i_salpha, i_sbeta, psi_ralpha, psi_rbeta); out: the state, reward,
// terms, rv, rk, rl, rs, each (R, 128).
int scim_rollout_random(const float* consts, const int* flags, const float* spec,
                        unsigned long long seed, int n, int n_steps, const float* const* in,
                        float* const* out, void* stream) {
  scim_rollout_random_kernel<<<spec_blocks(n), kSpecThreads, 0, (cudaStream_t)stream>>>(
      ind_load_const(consts, flags), sc_consts(spec), spec_seed_key(seed), n, n_steps,
      spec_in(in, 4), spec_out(out, 10));
  return (int)cudaGetLastError();
}

// actions: float32 (T, 3, R, 128) duties; out: the state, each (R, 128).
int scim_rollout_buffer(const float* consts, const int* flags, const float*, int n,
                        int n_steps, const float* const* in, const float* actions,
                        float* const* out, void* stream) {
  scim_rollout_buffer_kernel<<<spec_blocks(n), kSpecThreads, 0, (cudaStream_t)stream>>>(
      ind_load_const(consts, flags), n, n_steps, spec_in(in, 4), actions, spec_out(out, 4));
  return (int)cudaGetLastError();
}

}  // extern "C"
