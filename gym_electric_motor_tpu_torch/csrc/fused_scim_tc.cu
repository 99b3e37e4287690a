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
// Design: the state and the reference row in registers across a
// `#pragma unroll 1` loop over T steps.  The random rollout is
// warp-specialised on the shared-memory ring of ring_pipe.cuh: producer
// warps draw, in a double-buffered ring of K steps a slot, every value of a
// step that depends on the constants alone (scim_draws: the three duties,
// the row's normal draw, its candidate length and sigma and its candidate
// reset value, 7 words); consumer warps run the step, one thread per env,
// and take the candidates by selects (scim_ring_step).  The one-thread
// random kernel drew a Philox slot and, at every second step, a second one
// and the Box-Muller pair on every step's chain, and the PARAMS slot in a
// divergent branch; it is built for tools/sass_ops.py's count of the
// function's own work and never launched.  The buffer kernel runs one
// thread per env.  Random bits from Philox4x32-10, counter (env, step,
// slot): SPEC_SLOT_STEP gives the three duties (a, b, c, -) every step,
// SPEC_SLOT_EXTRA the Box-Muller (u1, u2, -, -) at even steps only (its
// sine kept for the odd step, pallas_induction.py:167-184), SPEC_SLOT_PARAMS
// (length, sigma, reset value, -) where the row regenerates,
// SPEC_SLOT_INIT_0 (value, length, sigma, -) at step 0; the producers draw
// PARAMS at every step, which changes no bit of what a step uses, and each
// producer's steps pair an even step with the odd one after it, so the
// sine half reaches the odd step in the producer's registers.  Built with
// -fmad=false (ops/cuda_build.py), so each multiply and add rounds as in the
// plain PyTorch version (ops/fused_induction.py), and the producers compute
// each candidate with the one-thread kernel's functions on the same
// operands, so the two designs are equal bit for bit.
//
// What bounds it on this card: 4 planes in and 10 out per env (and 12 bytes
// of duty per env-step in buffer mode); the step is four stages of the
// 4-state right-hand side (about 100 FP32 operations), the Clarke
// transform, the torque, one Philox call, and at every second step a second
// call and the Box-Muller pair.  On the ring the producers issue two Philox
// calls a step (PARAMS too) and the Box-Muller pair every second step, the
// consumers 7 shared-memory loads; tools/sass_ops.py counts both roles
// beside the one-thread step.
#include "induction_step.cuh"
#include "ring_pipe.cuh"
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

// The reference row at step 0.
__device__ __forceinline__ SpecRow scim_row_init(const ScimConst& k, uint2 key, uint32_t e) {
  SpecRow r;
  const uint4 w0 = spec_draw(key, e, 0u, SPEC_SLOT_INIT_0);
  r.rv = scim_value(k, w0.x);
  r.rk = 0.0f;
  spec_params(scim_params(k), w0.y, w0.z, r.rl, r.rs);
  return r;
}

// The physics under the duties, the torque, the constraint, the reward and
// the reset of a step: the state moves on; returns whether the env violated.
__device__ __forceinline__ bool scim_step(const InductionConst& ic, const ScimConst& k, float da,
                                          float db, float dc, InductionState& x, const SpecRow& r,
                                          float& reward, float& terms) {
  const InductionState y = scim_physics(ic, x, da, db, dc);
  const float t_n = ind_torque(ic, y.isa, y.isb, y.psa, y.psb) * k.v[SC_INV_T_LIM];
  const bool violated = (y.isa * y.isa + y.isb * y.isb) * ic.v[I_INV_ILIM2] > 1.0f;
  reward += violated ? k.v[SC_VIOLATION_REWARD] : k.v[SC_NEG_W] * fabsf(t_n - r.rv);
  terms += violated ? 1.0f : 0.0f;
  x.isa = violated ? 0.0f : y.isa;
  x.isb = violated ? 0.0f : y.isb;
  x.psa = violated ? 0.0f : y.psa;
  x.psb = violated ? 0.0f : y.psb;
  return violated;
}

// The state, reward, terms and reference row of env e.
__device__ __forceinline__ void scim_store(const SpecOut& out, int e, const InductionState& x,
                                           float reward, float terms, const SpecRow& r) {
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

// The one-thread random rollout: built, never launched; tools/sass_ops.py
// counts its step, the function's own work, for the bound.
__global__ void scim_rollout_random_kernel(InductionConst ic, ScimConst k, uint2 key, int n,
                                           int n_steps, SpecIn in, SpecOut out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  InductionState x{0.0f, in.p[0][e], in.p[1][e], in.p[2][e], in.p[3][e]};
  SpecRow r = scim_row_init(k, key, (uint32_t)e);
  float reward = 0.0f, terms = 0.0f, zb = 0.0f;
#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) {
    const uint4 w = spec_draw(key, (uint32_t)e, (uint32_t)t, SPEC_SLOT_STEP);
    const bool violated = scim_step(ic, k, 2.0f * uniform24(w.x) - 1.0f,
                                    2.0f * uniform24(w.y) - 1.0f, 2.0f * uniform24(w.z) - 1.0f,
                                    x, r, reward, terms);
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
  scim_store(out, e, x, reward, terms, r);
}

// ---- the warp-specialised random rollout ------------------------------

// The words of a step on the ring (ring_pipe.cuh): the three duties, the
// reference row's draw, its candidate length and sigma, and its candidate
// reset value.
constexpr int kScimWords = 7;

// Producer side: what step t draws whatever the state, in the operand
// order of scim_rollout_random_kernel's step: the duties 2 U - 1 of
// SPEC_SLOT_STEP's first three words, the Box-Muller pair of
// SPEC_SLOT_EXTRA at even steps (odd false) with its sine left in zb for
// the odd step after it, and of SPEC_SLOT_PARAMS the length and sigma a
// regeneration takes and the value a reset takes.
__device__ __forceinline__ RingWords<kScimWords> scim_draws(const ScimConst& k, uint2 key,
                                                           uint32_t env, uint32_t t, bool odd,
                                                           float& zb) {
  const uint4 w = spec_draw(key, env, t, SPEC_SLOT_STEP);
  float draw;
  if (odd) {
    draw = zb;
  } else {
    const uint4 b = spec_draw(key, env, t, SPEC_SLOT_EXTRA);
    spec_box_muller(k.v[SC_U_MIN], k.v[SC_TWO_PI], b.x, b.y, draw, zb);
  }
  const uint4 p = spec_draw(key, env, t, SPEC_SLOT_PARAMS);
  float rl, rs;
  spec_params(scim_params(k), p.x, p.y, rl, rs);
  RingWords<kScimWords> x;
  x.w[0] = __float_as_uint(2.0f * uniform24(w.x) - 1.0f);
  x.w[1] = __float_as_uint(2.0f * uniform24(w.y) - 1.0f);
  x.w[2] = __float_as_uint(2.0f * uniform24(w.z) - 1.0f);
  x.w[3] = __float_as_uint(draw);
  x.w[4] = __float_as_uint(rl);
  x.w[5] = __float_as_uint(rs);
  x.w[6] = __float_as_uint(scim_value(k, p.z));
  return x;
}

// Consumer side: the one-thread step with the step's words given, the
// candidates taken by selects.
__device__ __forceinline__ void scim_ring_step(const InductionConst& ic, const ScimConst& k,
                                               const RingWords<kScimWords>& x, InductionState& s,
                                               SpecRow& r, float& reward, float& terms) {
  const bool violated = scim_step(ic, k, __uint_as_float(x.w[0]), __uint_as_float(x.w[1]),
                                  __uint_as_float(x.w[2]), s, r, reward, terms);
  const bool regen = (r.rk >= r.rl) || violated;
  const float m = k.v[SC_MARGIN];
  spec_row_walk(r, regen, __uint_as_float(x.w[4]), __uint_as_float(x.w[5]),
                __uint_as_float(x.w[3]), -m, m);
  r.rv = violated ? __uint_as_float(x.w[6]) : r.rv;
}

// The ring: 8 steps a slot, 2 producer warps per consumer warp, each
// drawing 4 steps of a slot (the fastest of K in {4, 8} x P in {1, 2},
// PERF.md, slice 19); ops/fused_induction.py's SCIM_TC_RING mirrors it.
// At 7 words a step it holds 57,344 B, above the default 48 KB of dynamic
// shared memory.
using ScimRing = RingShape<8, 2>;

// The random rollout warp-specialised: producer warps run scim_draws,
// consumer warps scim_ring_step, one thread per env.
__global__ void __launch_bounds__(ScimRing::kThreads)
    scim_rollout_ws_kernel(InductionConst ic, ScimConst k, uint2 key, int n, int n_steps,
                           SpecIn in, SpecOut out) {
  extern __shared__ uint32_t ring[];
  const RingThread th = ring_thread(n);
  const int e = th.e;
  const RingPipe<ScimRing> pipe(n_steps);
  const RingView<kScimWords> v{ring + th.le};
  if (!th.consumer) {
    ring_produce(pipe, v, th.part, [&](uint32_t t, bool odd, float& zb) {
      return scim_draws(k, key, (uint32_t)e, t, odd, zb);
    });
    return;
  }
  InductionState x{0.0f, in.p[0][e], in.p[1][e], in.p[2][e], in.p[3][e]};
  SpecRow r = scim_row_init(k, key, (uint32_t)e);
  float reward = 0.0f, terms = 0.0f;
  ring_consume(pipe, v, n_steps, [&](const RingWords<kScimWords>& w) {
    scim_ring_step(ic, k, w, x, r, reward, terms);
  });
  if (th.live) scim_store(out, e, x, reward, terms, r);
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
  constexpr int bytes = ring_bytes<ScimRing>(kScimWords);
  if (bytes > 48 * 1024) {
    cudaFuncSetAttribute(scim_rollout_ws_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         bytes);
  }
  scim_rollout_ws_kernel<<<(n + kRingEnvs - 1) / kRingEnvs, ScimRing::kThreads, bytes,
                           (cudaStream_t)stream>>>(
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
