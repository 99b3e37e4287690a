// The specialised Finite-CC-EESM fused rollout for Hopper (sm_90a), in a
// random-action and an action-buffer mode, with a plain C interface for
// ctypes (every function returns cudaGetLastError()).
//
// Replaces (gym_electric_motor_tpu/ops/):
//   eesm_cc_rollout_buffer  pallas_eesm.py  make_fused_eesm_rollout, buffer mode (:264)
//   eesm_cc_rollout_random  pallas_eesm.py  make_fused_eesm_rollout, random mode (:280)
//
// The step (pallas_eesm.py:72-253): one action word split into the B6 bits
// (b & 7) and the 4QC command ((b >> 3) & 3) of the excitation, the phase
// voltages, Clarke, Park at the angle of the cycle start and one RK4 step
// of the three dq currents (i_sd, i_sq, i_e) at constant speed are
// eesm_step.cuh's eesm_physics<finite, constant speed> with the EESM
// family's constants of the env (EesmConst, from ops/fused_eesm_family.py's
// EesmConsts on the host; the division by sigma a product with its float32
// reciprocal, as XLA compiles it); the angle advances by the builder's own
// tau p omega and wraps to [0, 2 pi) (the family's RK4 sum of the angle
// rate rounds otherwise and is not used); then the squared (i_sd, i_sq) and
// the i_e limit constraints, the WSE reward against three references (1/6
// each, the one-sided (0, 1) band for i_e), the reset of a violating env
// (currents and angle 0, the rotation (1, 0)), and the three Wiener
// references with the builder's constants (lengths floor(U[500, 2000)),
// sigma 10^U[-3, -1]).  The random mode turns the Park rotation (c, s) by
// the constant increment of one step and renormalises it with rsqrtf
// (spec_rotate, pallas_eesm.py:185-208); the buffer mode takes cosf and
// sinf of the angle each step (:138).
//
// Design: the state, the rotation and the three reference rows in
// registers across a `#pragma unroll 1` loop over T steps.  The random
// rollout is warp-specialised on the shared-memory ring of ring_pipe.cuh:
// producer warps draw, in a double-buffered ring of K steps a slot, every
// value of a step that depends on the constants alone (ec_draws: the action
// word, each row's normal draw, its candidate length and sigma and its
// candidate reset value, 13 words); consumer warps run the step, one
// thread per env, and take the candidates by selects (ec_ring_step).  The
// one-thread random kernel drew two Philox slots and two Box-Muller pairs
// on every step's chain, and the PARAMS and RESET slots in divergent
// branches; it is built for tools/sass_ops.py's count of the function's
// own work and never launched.  The buffer kernel runs one thread per env.
// Random bits from Philox4x32-10, counter (env, step, slot):
// SPEC_SLOT_STEP gives (action, u1, u2, u3) and SPEC_SLOT_EXTRA (u4,
// length row 2, sigma row 2, -) every step: one Box-Muller pair (u1, u2)
// for i_sd* and i_sq* and a single draw (u3, u4) for i_e*
// (pallas_eesm.py:213-224); SPEC_SLOT_PARAMS (length row 0, sigma row 0,
// length row 1, sigma row 1) where row 0 or 1 regenerates, SPEC_SLOT_RESET
// (reset value rows 0, 1, 2, -) where the env reset, SPEC_SLOT_INIT_0, _1
// and _2 (value, length, sigma, -) of rows 0, 1 and 2 at step 0; the
// producers draw PARAMS and RESET at every step, which changes no bit of
// what a step uses.  Built with -fmad=false (ops/cuda_build.py), so each
// multiply and add rounds as in the plain PyTorch version
// (ops/fused_eesm.py), and the producers compute each candidate with the
// one-thread kernel's functions on the same operands, so the two designs
// are equal bit for bit.
//
// What bounds it on this card: 4 planes in and 18 out per env (8 bytes of
// action per env-step in buffer mode); the step is four stages of the
// 3-current right-hand side (about 130 FP32 operations), Clarke and Park,
// the rotation's rsqrt, two Philox calls and the three normal draws'
// non-fast-math logf, cosf and sinf.  On the ring the producers issue four
// Philox calls a step (PARAMS and RESET too) and the consumers 13 shared-
// memory loads; tools/sass_ops.py counts both roles beside the one-thread
// step.
#include "eesm_step.cuh"
#include "ring_pipe.cuh"
#include "specialised_step.cuh"

// The builder's own constants; the physics takes the EESM family's
// (EesmConst).
enum EesmCcConstIndex {
  EC_D_EPS = 0,       // tau p omega, the angle's advance per step
  EC_W,               // 1/6: the WSE weight over the span
  EC_VIOLATION_REWARD,
  EC_M_SD,            // nominal / limit of i_sd: the rows 0, 1 window [-m, m]
  EC_EP_LO,           // SpecParams: 500, 1500, -3, 2, ln 10
  EC_EP_SPAN,
  EC_SIG_BASE,
  EC_SIG_SPAN,
  EC_LN10,
  EC_U_MIN,
  EC_TWO_PI,
  N_EESM_CC_CONST
};

struct EesmCcConst {
  float v[N_EESM_CC_CONST];
};

namespace {

// The B6 + 4QC voltages, Clarke, Park at (c, s), one RK4 step of the three
// currents; the angle is the caller's.
__device__ __forceinline__ EesmState ec_physics(const EesmConst& ec, const EesmState& x, float c,
                                                float s, int b6, int q4) {
  EesmAction act;
  act.b6 = B6Action{b6, 0.0f, 0.0f, 0.0f};
  act.e_bits = q4;
  act.e = 0.0f;
  EesmState y = x;
  eesm_physics<true, false>(ec, act, c, s, y);
  return y;
}

// The angle's advance by tau p omega, wrapped to [0, 2 pi).
__device__ __forceinline__ float ec_advance(const EesmConst& ec, const EesmCcConst& k,
                                            float eps) {
  const float a = eps + k.v[EC_D_EPS];
  return a - ec.v[E_TWO_PI] * floorf(a * ec.v[E_INV_TWO_PI]);
}

__device__ __forceinline__ SpecParams ec_params(const EesmCcConst& k) {
  return SpecParams{k.v[EC_EP_LO], k.v[EC_EP_SPAN], k.v[EC_SIG_BASE], k.v[EC_SIG_SPAN],
                    k.v[EC_LN10]};
}

// The window of row r: [-m, m] for i_sd* and i_sq*, [0, 1] for i_e*; a value
// lo + (hi - lo) U.
__device__ __forceinline__ float ec_lo(const EesmCcConst& k, int r) {
  return r == 2 ? 0.0f : -k.v[EC_M_SD];
}
__device__ __forceinline__ float ec_hi(const EesmCcConst& k, int r) {
  return r == 2 ? 1.0f : k.v[EC_M_SD];
}
__device__ __forceinline__ float ec_value(const EesmCcConst& k, int r, uint32_t b) {
  return ec_lo(k, r) + (ec_hi(k, r) - ec_lo(k, r)) * uniform24(b);
}

// The rows and the rotation at step 0.
__device__ __forceinline__ void ec_init(const EesmCcConst& k, uint2 key, uint32_t e, float eps,
                                        float& c, float& s, SpecRow (&row)[3]) {
  c = cosf(eps);
  s = sinf(eps);
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const uint4 w0 = spec_draw(key, e, 0u, r == 0 ? SPEC_SLOT_INIT_0
                                             : (r == 1 ? SPEC_SLOT_INIT_1 : SPEC_SLOT_INIT_2));
    row[r].rv = ec_value(k, r, w0.x);
    row[r].rk = 0.0f;
    spec_params(ec_params(k), w0.y, w0.z, row[r].rl, row[r].rs);
  }
}

// The physics, the constraints, the reward and the reset of a step with
// action b6 and q4: the state, the angle and the rotation move on; returns
// whether the env violated.
__device__ __forceinline__ bool ec_step(const EesmConst& ec, const EesmCcConst& k, int b6, int q4,
                                        EesmState& x, float& eps, float& c, float& s,
                                        const SpecRow (&row)[3], float& reward, float& terms) {
  const EesmState y = ec_physics(ec, x, c, s, b6, q4);
  const float eps_new = ec_advance(ec, k, eps);
  const float isd_n = y.i_sd * ec.v[E_INV_I_LIM];
  const float isq_n = y.i_sq * ec.v[E_INV_I_LIM];
  const float ie_n = y.i_e * ec.v[E_INV_IE_LIM];
  const bool violated = ((isd_n * isd_n + isq_n * isq_n) > 1.0f) || (fabsf(ie_n) > 1.0f);
  const float wgt = k.v[EC_W];
  const float wse = -((wgt * fabsf(isd_n - row[0].rv) + wgt * fabsf(isq_n - row[1].rv)) +
                      wgt * fabsf(ie_n - row[2].rv));
  reward += violated ? k.v[EC_VIOLATION_REWARD] : wse;
  terms += violated ? 1.0f : 0.0f;
  x.i_sd = violated ? 0.0f : y.i_sd;
  x.i_sq = violated ? 0.0f : y.i_sq;
  x.i_e = violated ? 0.0f : y.i_e;
  eps = violated ? 0.0f : eps_new;
  spec_rotate(ec.v[E_COS_D], ec.v[E_SIN_D], violated, c, s);
  return violated;
}

// The state, reward, terms and (3R, 128) reference planes (i_sd* rows,
// i_sq* rows, i_e* rows) of env e.
__device__ __forceinline__ void ec_store(const SpecOut& out, int n, int e, const EesmState& x,
                                         float eps, float reward, float terms,
                                         const SpecRow (&row)[3]) {
  out.p[0][e] = x.i_sd;
  out.p[1][e] = x.i_sq;
  out.p[2][e] = x.i_e;
  out.p[3][e] = eps;
  out.p[4][e] = reward;
  out.p[5][e] = terms;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    out.p[6][(size_t)r * n + e] = row[r].rv;
    out.p[7][(size_t)r * n + e] = row[r].rk;
    out.p[8][(size_t)r * n + e] = row[r].rl;
    out.p[9][(size_t)r * n + e] = row[r].rs;
  }
}

// The one-thread random rollout: built, never launched; tools/sass_ops.py
// counts its step, the function's own work, for the bound.
__global__ void eesm_cc_rollout_random_kernel(EesmConst ec, EesmCcConst k, uint2 key, int n,
                                              int n_steps, SpecIn in, SpecOut out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const uint32_t ue = (uint32_t)e;
  EesmState x{0.0f, in.p[0][e], in.p[1][e], in.p[2][e], 0.0f};
  float eps = in.p[3][e];
  float c, s;
  SpecRow row[3];
  ec_init(k, key, ue, eps, c, s, row);
  float reward = 0.0f, terms = 0.0f;
#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) {
    const uint4 w = spec_draw(key, ue, (uint32_t)t, SPEC_SLOT_STEP);
    const uint4 v = spec_draw(key, ue, (uint32_t)t, SPEC_SLOT_EXTRA);
    const bool violated = ec_step(ec, k, (int)(w.x & 7u), (int)((w.x >> 3) & 3u), x, eps, c, s,
                                  row, reward, terms);
    float draw[3], z_s;
    spec_box_muller(k.v[EC_U_MIN], k.v[EC_TWO_PI], w.y, w.z, draw[0], draw[1]);
    spec_box_muller(k.v[EC_U_MIN], k.v[EC_TWO_PI], w.w, v.x, draw[2], z_s);
    bool regen[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) regen[r] = (row[r].rk >= row[r].rl) || violated;
    uint4 p = make_uint4(0u, 0u, 0u, 0u);
    if (regen[0] || regen[1]) p = spec_draw(key, ue, (uint32_t)t, SPEC_SLOT_PARAMS);
    const uint32_t b_len[3] = {p.x, p.z, v.y};
    const uint32_t b_sig[3] = {p.y, p.w, v.z};
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      float rl = 0.0f, rs = 0.0f;
      if (regen[r]) spec_params(ec_params(k), b_len[r], b_sig[r], rl, rs);
      spec_row_walk(row[r], regen[r], rl, rs, draw[r], ec_lo(k, r), ec_hi(k, r));
    }
    if (violated) {
      const uint4 q = spec_draw(key, ue, (uint32_t)t, SPEC_SLOT_RESET);
      row[0].rv = ec_value(k, 0, q.x);
      row[1].rv = ec_value(k, 1, q.y);
      row[2].rv = ec_value(k, 2, q.z);
    }
  }
  ec_store(out, n, e, x, eps, reward, terms, row);
}

// ---- the warp-specialised random rollout ------------------------------

// The words of a step on the ring (ring_pipe.cuh): the action word (the
// B6 bits and the 4QC command, w.x & 31), then per reference row its
// normal draw, its candidate length and sigma and its candidate reset
// value (kRefWords, pack_refs).
constexpr int kEcWords = 1 + 3 * kRefWords;

// Producer side: what step t draws whatever the state, in the operand
// order of eesm_cc_rollout_random_kernel's step: both Box-Muller pairs (the
// second's sine unused), rows 0 and 1's length and sigma from
// SPEC_SLOT_PARAMS and row 2's from SPEC_SLOT_EXTRA, the reset values from
// SPEC_SLOT_RESET.
__device__ __forceinline__ RingWords<kEcWords> ec_draws(const EesmCcConst& k, uint2 key,
                                                        uint32_t env, uint32_t t) {
  const uint4 w = spec_draw(key, env, t, SPEC_SLOT_STEP);
  const uint4 v = spec_draw(key, env, t, SPEC_SLOT_EXTRA);
  const uint4 p = spec_draw(key, env, t, SPEC_SLOT_PARAMS);
  const uint4 q = spec_draw(key, env, t, SPEC_SLOT_RESET);
  RefCandidates<3> cand;
  float z_s;
  spec_box_muller(k.v[EC_U_MIN], k.v[EC_TWO_PI], w.y, w.z, cand.draw[0], cand.draw[1]);
  spec_box_muller(k.v[EC_U_MIN], k.v[EC_TWO_PI], w.w, v.x, cand.draw[2], z_s);
  const uint32_t b_len[3] = {p.x, p.z, v.y};
  const uint32_t b_sig[3] = {p.y, p.w, v.z};
  const uint32_t b_val[3] = {q.x, q.y, q.z};
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    spec_params(ec_params(k), b_len[r], b_sig[r], cand.rl[r], cand.rs[r]);
    cand.rv[r] = ec_value(k, r, b_val[r]);
  }
  RingWords<kEcWords> x;
  x.w[0] = w.x & 31u;
  pack_refs<3>(cand, 1, x);
  return x;
}

// Consumer side: the one-thread step with the step's words given, the
// candidates taken by selects.
__device__ __forceinline__ void ec_ring_step(const EesmConst& ec, const EesmCcConst& k,
                                             const RingWords<kEcWords>& x, EesmState& st,
                                             float& eps, float& c, float& s, SpecRow (&row)[3],
                                             float& reward, float& terms) {
  const int b = (int)x.w[0];
  const bool violated = ec_step(ec, k, b & 7, (b >> 3) & 3, st, eps, c, s, row, reward, terms);
  const RefCandidates<3> cand = unpack_refs<3>(x, 1);
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const bool regen = (row[r].rk >= row[r].rl) || violated;
    spec_row_walk(row[r], regen, cand.rl[r], cand.rs[r], cand.draw[r], ec_lo(k, r), ec_hi(k, r));
    row[r].rv = violated ? cand.rv[r] : row[r].rv;
  }
}

// The ring: 4 steps a slot, 2 producer warps per consumer warp, each
// drawing 2 steps of a slot (the fastest of K in {4, 8} x P in {1, 2};
// PERF.md, slice 17).  At 13 words a step it holds 53,248 B, above the
// default 48 KB of dynamic shared memory.
using EesmCcRing = RingShape<4, 2>;

// The random rollout warp-specialised: producer warps run ec_draws,
// consumer warps ec_ring_step, one thread per env.
__global__ void __launch_bounds__(EesmCcRing::kThreads)
    eesm_cc_rollout_ws_kernel(EesmConst ec, EesmCcConst k, uint2 key, int n, int n_steps,
                              SpecIn in, SpecOut out) {
  extern __shared__ uint32_t ring[];
  const RingThread th = ring_thread(n);
  const int e = th.e;
  const RingPipe<EesmCcRing> pipe(n_steps);
  const RingView<kEcWords> v{ring + th.le};
  if (!th.consumer) {
    ring_produce(pipe, v, th.part, [&](uint32_t t, bool, float&) {
      return ec_draws(k, key, (uint32_t)e, t);
    });
    return;
  }
  EesmState x{0.0f, in.p[0][e], in.p[1][e], in.p[2][e], 0.0f};
  float eps = in.p[3][e];
  float c, s;
  SpecRow row[3];
  ec_init(k, key, (uint32_t)e, eps, c, s, row);
  float reward = 0.0f, terms = 0.0f;
  ring_consume(pipe, v, n_steps, [&](const RingWords<kEcWords>& w) {
    ec_ring_step(ec, k, w, x, eps, c, s, row, reward, terms);
  });
  if (th.live) ec_store(out, n, e, x, eps, reward, terms, row);
}

__global__ void eesm_cc_rollout_buffer_kernel(EesmConst ec, EesmCcConst k, int n, int n_steps,
                                              SpecIn in, const int* __restrict__ actions,
                                              SpecOut out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  EesmState x{0.0f, in.p[0][e], in.p[1][e], in.p[2][e], 0.0f};
  float eps = in.p[3][e];
#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) {
    const size_t at = (size_t)t * 2 * n + e;
    x = ec_physics(ec, x, cosf(eps), sinf(eps), actions[at], actions[at + n]);
    eps = ec_advance(ec, k, eps);
  }
  out.p[0][e] = x.i_sd;
  out.p[1][e] = x.i_sq;
  out.p[2][e] = x.i_e;
  out.p[3][e] = eps;
}

EesmCcConst ec_consts(const float* spec) {
  EesmCcConst k;
  for (int j = 0; j < N_EESM_CC_CONST; ++j) k.v[j] = spec[j];
  return k;
}

}  // namespace

extern "C" {

SPEC_FAMILY_C_INFO(eesm_cc, N_EESM_CONST, N_ROW_CONST, N_EESM_FLAG, N_EESM_CC_CONST)

// consts and flags: the EESM family's (eesm_step.cuh) for Finite-CC-EESM;
// spec: the builder's own (EesmCcConstIndex).
// in: (i_sd, i_sq, i_e, eps); out: the state, reward, terms, each (R, 128),
// then rv, rk, rl, rs, each (3R, 128).
int eesm_cc_rollout_random(const float* consts, const int* flags, const float* spec,
                           unsigned long long seed, int n, int n_steps, const float* const* in,
                           float* const* out, void* stream) {
  constexpr int bytes = ring_bytes<EesmCcRing>(kEcWords);
  if (bytes > 48 * 1024) {
    cudaFuncSetAttribute(eesm_cc_rollout_ws_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         bytes);
  }
  eesm_cc_rollout_ws_kernel<<<(n + kRingEnvs - 1) / kRingEnvs, EesmCcRing::kThreads, bytes,
                              (cudaStream_t)stream>>>(
      eesm_load_const(consts, flags), ec_consts(spec), spec_seed_key(seed), n, n_steps,
      spec_in(in, 4), spec_out(out, 10));
  return (int)cudaGetLastError();
}

// The random rollout's ring (ring_pipe.cuh's RingLayout).
int eesm_cc_ring_layout(int* out) {
  ring_layout<EesmCcRing>(kEcWords, out);
  return 0;
}

// actions: int32 (T, 2, R, 128), the B6 bits and the 4QC command; out: the
// state, each (R, 128).
int eesm_cc_rollout_buffer(const float* consts, const int* flags, const float* spec, int n,
                           int n_steps, const float* const* in, const int* actions,
                           float* const* out, void* stream) {
  eesm_cc_rollout_buffer_kernel<<<spec_blocks(n), kSpecThreads, 0, (cudaStream_t)stream>>>(
      eesm_load_const(consts, flags), ec_consts(spec), n, n_steps, spec_in(in, 4), actions,
      spec_out(out, 4));
  return (int)cudaGetLastError();
}

}  // extern "C"
