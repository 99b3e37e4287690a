// The specialised Cont-CC-DFIM fused rollout for Hopper (sm_90a), in a
// random-action and an action-buffer mode, with a plain C interface for
// ctypes (every function returns cudaGetLastError()).
//
// Replaces (gym_electric_motor_tpu/ops/):
//   dfim_cc_rollout_buffer  pallas_dfim.py  make_fused_dfim_rollout, buffer mode (:271)
//   dfim_cc_rollout_random  pallas_dfim.py  make_fused_dfim_rollout, random mode (:287)
//
// The step (pallas_dfim.py:67-260): six continuous duties (stator a, b, c,
// rotor a, b, c; phase voltage d u_sup / 2), Clarke of both bridges, the
// rotor voltage turned into the stator frame by one rotation through the
// electrical angle (the reference's def -> dq -> alpha-beta pair of
// rotations collapsed, :58-62) and one RK4 step of the 4-state alpha-beta
// ODE at constant speed are dfim_step.cuh's dfim_physics<continuous,
// constant speed> with the DFIM family's constants of the env (DfimConst,
// from ops/fused_dfim_family.py's DfimConsts on the host; the divisions by
// tau_sig and tau_r are products with their float32 reciprocals, as XLA
// compiles them); the angle advances by the builder's own tau p omega and
// wraps (the family's RK4 sum of the angle rate is not used); then the
// field-oriented dq currents from the post-step rotor-flux direction
// cosines psi / |psi| with rsqrtf of max(|psi|^2, 1e-18) in place of atan2
// (:185-193; the family's guard differs), the squared dq current
// constraint, the WSE reward against two references (1/4 each), the reset
// of a violating env (state and angle 0, the rotation (1, 0)) and the two
// Wiener current references with the builder's constants (lengths
// floor(U[500, 2000)), sigma 10^U[-3, -1], the margin nominal / limit).
// The random mode turns the rotation (c, s) by the constant increment of
// one step with rsqrtf renormalisation (spec_rotate, :194-214); the buffer
// mode takes cosf and sinf of the angle each step (:142).
//
// Design: the state, the rotation and both reference rows in registers
// across a `#pragma unroll 1` loop over T steps.  The random rollout is
// warp-specialised on the shared-memory ring of ring_pipe.cuh: producer
// warps draw, in a double-buffered ring of K steps a slot, every value of a
// step that depends on the constants alone (fc_draws: the six duties, each
// row's normal draw, its candidate length and sigma and its candidate
// reset value, 14 words); consumer warps run the step, one thread per env,
// and take the candidates by selects (fc_ring_step).  The one-thread random
// kernel drew two Philox slots and the Box-Muller pair on every step's
// chain, and the PARAMS and RESET slots in divergent branches; it is built
// for tools/sass_ops.py's count of the function's own work and never
// launched.  The buffer kernel runs one thread per env.  Random bits from
// Philox4x32-10, counter (env, step, slot): SPEC_SLOT_STEP gives duties
// (0, 1, 2, 3) and SPEC_SLOT_EXTRA (duty 4, duty 5, u1, u2) every step, the
// Box-Muller pair feeding both references (pallas_dfim.py:222-228);
// SPEC_SLOT_PARAMS (length row 0, sigma row 0, length row 1, sigma row 1)
// where a row regenerates, SPEC_SLOT_RESET (reset value rows 0, 1, -, -)
// where the env reset, SPEC_SLOT_INIT_0 and _1 (value, length, sigma, -)
// at step 0; the producers draw PARAMS and RESET at every step, which
// changes no bit of what a step uses.  Built with -fmad=false
// (ops/cuda_build.py), so each multiply and add rounds as in the plain
// PyTorch version (ops/fused_dfim.py), and the producers compute each
// candidate with the one-thread kernel's functions on the same operands,
// so the two designs are equal bit for bit.
//
// What bounds it on this card: 5 planes in and 15 out per env (24 bytes of
// duties per env-step in buffer mode); the step is four stages of the
// 4-state right-hand side with both voltages (about 120 FP32 operations),
// two Clarke transforms and a rotation, two rsqrtf, two Philox calls and
// the Box-Muller pair.  On the ring the producers issue four Philox calls
// a step (PARAMS and RESET too) and the consumers 14 shared-memory loads;
// tools/sass_ops.py counts both roles beside the one-thread step.
#include "dfim_step.cuh"
#include "ring_pipe.cuh"
#include "specialised_step.cuh"

// The builder's own constants; the physics takes the DFIM family's
// (DfimConst).
enum DfimCcConstIndex {
  FC_D_EPS = 0,       // tau p omega, the angle's advance per step
  FC_TINY,            // 1e-18: |psi|^2 at or below it gives the direction (1, 0)
  FC_INV_I_LIM,       // 1 / i_lim
  FC_W,               // 1/4: the WSE weight over the span
  FC_VIOLATION_REWARD,
  FC_MARGIN,          // nominal / limit of i_sd
  FC_EP_LO,           // SpecParams: 500, 1500, -3, 2, ln 10
  FC_EP_SPAN,
  FC_SIG_BASE,
  FC_SIG_SPAN,
  FC_LN10,
  FC_U_MIN,
  FC_TWO_PI,
  N_DFIM_CC_CONST
};

struct DfimCcConst {
  float v[N_DFIM_CC_CONST];
};

namespace {

// Both bridges' voltages, Clarke, the rotor voltage turned by (c, s), one
// RK4 step; the angle is the caller's.
__device__ __forceinline__ DfimState fc_physics(const DfimConst& dk, const DfimState& x, float c,
                                                float s, const float* d) {
  const DfimAction act{B6Action{0, d[0], d[1], d[2]}, B6Action{0, d[3], d[4], d[5]}};
  DfimState y = x;
  dfim_physics<false, false>(dk, act, c, s, y);
  return y;
}

// The angle's advance by tau p omega, wrapped to [0, 2 pi).
__device__ __forceinline__ float fc_advance(const DfimConst& dk, const DfimCcConst& k,
                                            float eps) {
  const float a = eps + k.v[FC_D_EPS];
  return a - dk.v[D_TWO_PI] * floorf(a * dk.v[D_INV_TWO_PI]);
}

__device__ __forceinline__ SpecParams fc_params(const DfimCcConst& k) {
  return SpecParams{k.v[FC_EP_LO], k.v[FC_EP_SPAN], k.v[FC_SIG_BASE], k.v[FC_SIG_SPAN],
                    k.v[FC_LN10]};
}

__device__ __forceinline__ float fc_value(const DfimCcConst& k, uint32_t b) {
  return (2.0f * uniform24(b) - 1.0f) * k.v[FC_MARGIN];
}

// The rows and the rotation at step 0.
__device__ __forceinline__ void fc_init(const DfimCcConst& k, uint2 key, uint32_t e, float eps,
                                        float& c, float& s, SpecRow (&row)[2]) {
  c = cosf(eps);
  s = sinf(eps);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const uint4 w0 = spec_draw(key, e, 0u, r == 0 ? SPEC_SLOT_INIT_0 : SPEC_SLOT_INIT_1);
    row[r].rv = fc_value(k, w0.x);
    row[r].rk = 0.0f;
    spec_params(fc_params(k), w0.y, w0.z, row[r].rl, row[r].rs);
  }
}

// The physics under duties d, the field-oriented dq currents, the
// constraint, the reward and the reset of a step: the state, the angle and
// the rotation move on; returns whether the env violated.
__device__ __forceinline__ bool fc_step(const DfimConst& dk, const DfimCcConst& k, const float* d,
                                        DfimState& x, float& eps, float& c, float& s,
                                        const SpecRow (&row)[2], float& reward, float& terms) {
  const DfimState y = fc_physics(dk, x, c, s, d);
  const float eps_new = fc_advance(dk, k, eps);
  // the field-oriented dq currents from the flux direction cosines
  const float pn2 = y.psa * y.psa + y.psb * y.psb;
  const float inv_pn = rsqrtf(fmaxf(pn2, k.v[FC_TINY]));
  const bool safe = pn2 > k.v[FC_TINY];
  const float cf = safe ? y.psa * inv_pn : 1.0f;
  const float sf = safe ? y.psb * inv_pn : 0.0f;
  const float i_sd = (cf * y.isa + sf * y.isb) * k.v[FC_INV_I_LIM];
  const float i_sq = (-sf * y.isa + cf * y.isb) * k.v[FC_INV_I_LIM];
  const bool violated = (i_sd * i_sd + i_sq * i_sq) > 1.0f;
  const float wgt = k.v[FC_W];
  const float wse = -(wgt * fabsf(i_sd - row[0].rv) + wgt * fabsf(i_sq - row[1].rv));
  reward += violated ? k.v[FC_VIOLATION_REWARD] : wse;
  terms += violated ? 1.0f : 0.0f;
  x.isa = violated ? 0.0f : y.isa;
  x.isb = violated ? 0.0f : y.isb;
  x.psa = violated ? 0.0f : y.psa;
  x.psb = violated ? 0.0f : y.psb;
  eps = violated ? 0.0f : eps_new;
  spec_rotate(dk.v[D_COS_D], dk.v[D_SIN_D], violated, c, s);
  return violated;
}

// The state, reward, terms and (2R, 128) reference planes (i_sd* rows
// first) of env e.
__device__ __forceinline__ void fc_store(const SpecOut& out, int n, int e, const DfimState& x,
                                         float eps, float reward, float terms,
                                         const SpecRow (&row)[2]) {
  out.p[0][e] = x.isa;
  out.p[1][e] = x.isb;
  out.p[2][e] = x.psa;
  out.p[3][e] = x.psb;
  out.p[4][e] = eps;
  out.p[5][e] = reward;
  out.p[6][e] = terms;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    out.p[7][(size_t)r * n + e] = row[r].rv;
    out.p[8][(size_t)r * n + e] = row[r].rk;
    out.p[9][(size_t)r * n + e] = row[r].rl;
    out.p[10][(size_t)r * n + e] = row[r].rs;
  }
}

// The one-thread random rollout: built, never launched; tools/sass_ops.py
// counts its step, the function's own work, for the bound.
__global__ void dfim_cc_rollout_random_kernel(DfimConst dk, DfimCcConst k, uint2 key, int n,
                                              int n_steps, SpecIn in, SpecOut out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const uint32_t ue = (uint32_t)e;
  DfimState x{0.0f, in.p[0][e], in.p[1][e], in.p[2][e], in.p[3][e], 0.0f};
  float eps = in.p[4][e];
  float c, s;
  SpecRow row[2];
  fc_init(k, key, ue, eps, c, s, row);
  float reward = 0.0f, terms = 0.0f;
#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) {
    const uint4 w = spec_draw(key, ue, (uint32_t)t, SPEC_SLOT_STEP);
    const uint4 v = spec_draw(key, ue, (uint32_t)t, SPEC_SLOT_EXTRA);
    const float d[6] = {2.0f * uniform24(w.x) - 1.0f, 2.0f * uniform24(w.y) - 1.0f,
                        2.0f * uniform24(w.z) - 1.0f, 2.0f * uniform24(w.w) - 1.0f,
                        2.0f * uniform24(v.x) - 1.0f, 2.0f * uniform24(v.y) - 1.0f};
    const bool violated = fc_step(dk, k, d, x, eps, c, s, row, reward, terms);

    float draw[2];
    spec_box_muller(k.v[FC_U_MIN], k.v[FC_TWO_PI], v.z, v.w, draw[0], draw[1]);
    const bool regen0 = (row[0].rk >= row[0].rl) || violated;
    const bool regen1 = (row[1].rk >= row[1].rl) || violated;
    uint4 p = make_uint4(0u, 0u, 0u, 0u);
    if (regen0 || regen1) p = spec_draw(key, ue, (uint32_t)t, SPEC_SLOT_PARAMS);
    float rl = 0.0f, rs = 0.0f;
    if (regen0) spec_params(fc_params(k), p.x, p.y, rl, rs);
    const float m = k.v[FC_MARGIN];
    spec_row_walk(row[0], regen0, rl, rs, draw[0], -m, m);
    if (regen1) spec_params(fc_params(k), p.z, p.w, rl, rs);
    spec_row_walk(row[1], regen1, rl, rs, draw[1], -m, m);
    if (violated) {
      const uint4 q = spec_draw(key, ue, (uint32_t)t, SPEC_SLOT_RESET);
      row[0].rv = fc_value(k, q.x);
      row[1].rv = fc_value(k, q.y);
    }
  }
  fc_store(out, n, e, x, eps, reward, terms, row);
}

// ---- the warp-specialised random rollout ------------------------------

// The words of a step on the ring (ring_pipe.cuh): the six duties, then per
// reference row its normal draw, its candidate length and sigma and its
// candidate reset value (kRefWords, pack_refs).
constexpr int kFcWords = 6 + 2 * kRefWords;

// Producer side: what step t draws whatever the state, in the operand
// order of dfim_cc_rollout_random_kernel's step: the duties from
// SPEC_SLOT_STEP and SPEC_SLOT_EXTRA, the Box-Muller pair from
// SPEC_SLOT_EXTRA, both rows' length and sigma from SPEC_SLOT_PARAMS, the
// reset values from SPEC_SLOT_RESET.
__device__ __forceinline__ RingWords<kFcWords> fc_draws(const DfimCcConst& k, uint2 key,
                                                        uint32_t env, uint32_t t) {
  const uint4 w = spec_draw(key, env, t, SPEC_SLOT_STEP);
  const uint4 v = spec_draw(key, env, t, SPEC_SLOT_EXTRA);
  const uint4 p = spec_draw(key, env, t, SPEC_SLOT_PARAMS);
  const uint4 q = spec_draw(key, env, t, SPEC_SLOT_RESET);
  RingWords<kFcWords> x;
  const uint32_t b_duty[6] = {w.x, w.y, w.z, w.w, v.x, v.y};
#pragma unroll
  for (int j = 0; j < 6; ++j) x.w[j] = __float_as_uint(2.0f * uniform24(b_duty[j]) - 1.0f);
  RefCandidates<2> cand;
  spec_box_muller(k.v[FC_U_MIN], k.v[FC_TWO_PI], v.z, v.w, cand.draw[0], cand.draw[1]);
  spec_params(fc_params(k), p.x, p.y, cand.rl[0], cand.rs[0]);
  spec_params(fc_params(k), p.z, p.w, cand.rl[1], cand.rs[1]);
  cand.rv[0] = fc_value(k, q.x);
  cand.rv[1] = fc_value(k, q.y);
  pack_refs<2>(cand, 6, x);
  return x;
}

// Consumer side: the one-thread step with the step's words given, the
// candidates taken by selects.
__device__ __forceinline__ void fc_ring_step(const DfimConst& dk, const DfimCcConst& k,
                                             const RingWords<kFcWords>& x, DfimState& st,
                                             float& eps, float& c, float& s, SpecRow (&row)[2],
                                             float& reward, float& terms) {
  float d[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) d[j] = __uint_as_float(x.w[j]);
  const bool violated = fc_step(dk, k, d, st, eps, c, s, row, reward, terms);
  const RefCandidates<2> cand = unpack_refs<2>(x, 6);
  const float m = k.v[FC_MARGIN];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool regen = (row[r].rk >= row[r].rl) || violated;
    spec_row_walk(row[r], regen, cand.rl[r], cand.rs[r], cand.draw[r], -m, m);
    row[r].rv = violated ? cand.rv[r] : row[r].rv;
  }
}

// The ring: 8 steps a slot, 2 producer warps per consumer warp, each
// drawing 4 steps of a slot (the fastest of K in {4, 8} x P in {1, 2};
// parent one-thread kernel over ring on Cont-CC-DFIM at 16384 x 65536:
// K = 4 with one producer warp 0.959, with two 1.144; K = 8 with one 0.859,
// with two 1.170; PERF.md, slice 18).  At 14 words a step it holds
// 114,688 B, above the default 48 KB of dynamic shared memory.
using DfimCcRing = RingShape<8, 2>;

// The random rollout warp-specialised: producer warps run fc_draws,
// consumer warps fc_ring_step, one thread per env.
__global__ void __launch_bounds__(DfimCcRing::kThreads)
    dfim_cc_rollout_ws_kernel(DfimConst dk, DfimCcConst k, uint2 key, int n, int n_steps,
                              SpecIn in, SpecOut out) {
  extern __shared__ uint32_t ring[];
  const RingThread th = ring_thread(n);
  const int e = th.e;
  const RingPipe<DfimCcRing> pipe(n_steps);
  const RingView<kFcWords> v{ring + th.le};
  if (!th.consumer) {
    ring_produce(pipe, v, th.part, [&](uint32_t t, bool, float&) {
      return fc_draws(k, key, (uint32_t)e, t);
    });
    return;
  }
  DfimState x{0.0f, in.p[0][e], in.p[1][e], in.p[2][e], in.p[3][e], 0.0f};
  float eps = in.p[4][e];
  float c, s;
  SpecRow row[2];
  fc_init(k, key, (uint32_t)e, eps, c, s, row);
  float reward = 0.0f, terms = 0.0f;
  ring_consume(pipe, v, n_steps, [&](const RingWords<kFcWords>& w) {
    fc_ring_step(dk, k, w, x, eps, c, s, row, reward, terms);
  });
  if (th.live) fc_store(out, n, e, x, eps, reward, terms, row);
}

__global__ void dfim_cc_rollout_buffer_kernel(DfimConst dk, DfimCcConst k, int n, int n_steps,
                                              SpecIn in, const float* __restrict__ actions,
                                              SpecOut out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  DfimState x{0.0f, in.p[0][e], in.p[1][e], in.p[2][e], in.p[3][e], 0.0f};
  float eps = in.p[4][e];
#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) {
    const size_t at = (size_t)t * 6 * n + e;
    float d[6];
#pragma unroll
    for (int j = 0; j < 6; ++j) d[j] = actions[at + (size_t)j * n];
    x = fc_physics(dk, x, cosf(eps), sinf(eps), d);
    eps = fc_advance(dk, k, eps);
  }
  out.p[0][e] = x.isa;
  out.p[1][e] = x.isb;
  out.p[2][e] = x.psa;
  out.p[3][e] = x.psb;
  out.p[4][e] = eps;
}

DfimCcConst fc_consts(const float* spec) {
  DfimCcConst k;
  for (int j = 0; j < N_DFIM_CC_CONST; ++j) k.v[j] = spec[j];
  return k;
}

}  // namespace

extern "C" {

SPEC_FAMILY_C_INFO(dfim_cc, N_DFIM_CONST, N_ROW_CONST, N_DFIM_FLAG, N_DFIM_CC_CONST)

// consts and flags: the DFIM family's (dfim_step.cuh) for Cont-CC-DFIM;
// spec: the builder's own (DfimCcConstIndex).
// in: (i_salpha, i_sbeta, psi_ralpha, psi_rbeta, eps); out: the state,
// reward, terms, each (R, 128), then rv, rk, rl, rs, each (2R, 128).
int dfim_cc_rollout_random(const float* consts, const int* flags, const float* spec,
                           unsigned long long seed, int n, int n_steps, const float* const* in,
                           float* const* out, void* stream) {
  constexpr int bytes = ring_bytes<DfimCcRing>(kFcWords);
  if (bytes > 48 * 1024) {
    cudaFuncSetAttribute(dfim_cc_rollout_ws_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         bytes);
  }
  dfim_cc_rollout_ws_kernel<<<(n + kRingEnvs - 1) / kRingEnvs, DfimCcRing::kThreads, bytes,
                              (cudaStream_t)stream>>>(
      dfim_load_const(consts, flags), fc_consts(spec), spec_seed_key(seed), n, n_steps,
      spec_in(in, 5), spec_out(out, 11));
  return (int)cudaGetLastError();
}

// The random rollout's ring (ring_pipe.cuh's RingLayout).
int dfim_cc_ring_layout(int* out) {
  ring_layout<DfimCcRing>(kFcWords, out);
  return 0;
}

// actions: float32 (T, 6, R, 128) duties; out: the state, each (R, 128).
int dfim_cc_rollout_buffer(const float* consts, const int* flags, const float* spec, int n,
                           int n_steps, const float* const* in, const float* actions,
                           float* const* out, void* stream) {
  dfim_cc_rollout_buffer_kernel<<<spec_blocks(n), kSpecThreads, 0, (cudaStream_t)stream>>>(
      dfim_load_const(consts, flags), fc_consts(spec), n, n_steps, spec_in(in, 5), actions,
      spec_out(out, 5));
  return (int)cudaGetLastError();
}

}  // extern "C"
