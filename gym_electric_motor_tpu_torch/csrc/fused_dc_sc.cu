// The specialised Cont-SC-SeriesDc / Cont-SC-ShuntDc fused rollouts for
// Hopper (sm_90a), in a random-action and an action-buffer mode, with a
// plain C interface for ctypes (every function returns cudaGetLastError()).
//
// Replaces (gym_electric_motor_tpu/ops/):
//   dc_sc_rollout_buffer  pallas_dc.py  make_fused_dc_sc_rollout, buffer mode (:560)
//   dc_sc_rollout_random  pallas_dc.py  make_fused_dc_sc_rollout, random mode (:577)
//
// The step (pallas_dc.py:380-467): the Cont-4QC voltage u = a u_sup, one
// joint RK4 step over [omega, i] (SeriesDc: r_a + r_e, l_a + l_e, torque
// l_e' i^2) or [omega, i_a, i_e] (ShuntDc: both windings on the same
// voltage, torque l_e' i_e i_a), the polynomial static load with its
// linearisation below omega_lin (common_step.cuh's poly_load_rhs, the
// arithmetic of mech_rhs at :447-452, sign 0 at omega = 0), the limit
// constraint on the currents, the WSE reward -|omega_n - ref|, the reset of
// a violating env to zeros, and the Wiener omega reference on the window
// [0, nominal / limit] with the env's sigma range.
//
// Design: the state and the reference row in registers across a
// `#pragma unroll 1` loop over T steps; the template NEL (1 SeriesDc, 2
// ShuntDc) picks the motor.  The random rollout is warp-specialised on the
// ring of ring_pipe.cuh: two producer warps per consumer warp draw, in a
// double-buffered ring of K = 8 steps a slot, every value of a step that
// depends on the constants alone (dcsc_draws: the duty, the row's draw,
// its candidate length and sigma and its candidate reset value, 5 words);
// consumer warps run the step, one thread per env, and take the candidates
// by selects (dcsc_ring_step).  Where 33% of env-steps reset (Cont-SC-
// ShuntDc) the one-thread loop drew the PARAMS slot in a divergent branch
// on most warp-steps; the producers draw it at every step off the step's
// dependent chain.  The one-thread random kernel is built for the count of
// the function's own work and never launched; the buffer kernel runs one
// thread per env.  Random bits from
// Philox4x32-10, counter (env, step, slot): SPEC_SLOT_STEP gives (duty,
// Box-Muller u1, u2, -) every step, SPEC_SLOT_PARAMS (length, sigma, reset
// value, -) where the row regenerates, SPEC_SLOT_INIT_0 (value, length,
// sigma, -) at step 0; one Box-Muller pair at even steps, its sine kept for
// the odd step (pallas_dc.py:512-521).  Built with -fmad=false
// (ops/cuda_build.py), so each multiply and add rounds as in the plain
// PyTorch version (ops/fused_dc.py).
//
// What bounds it on this card: 2 or 3 planes in and 8 or 9 out per env (and
// 4 bytes of duty per env-step in buffer mode); the step is four stages of
// the joint right-hand side (about 60 to 90 FP32 operations with the load's
// selects), a Philox call, and at every second step the Box-Muller pair.
#include "common_step.cuh"
#include "ring_pipe.cuh"
#include "specialised_step.cuh"

enum DcScConstIndex {
  DS_U_SUP = 0,
  DS_NEG_R0,          // -(r_a + r_e) for SeriesDc, -r_a for ShuntDc
  DS_L_P,             // l_e'
  DS_INV_L0,          // 1 / (l_a + l_e), or 1 / l_a
  DS_NEG_R1,          // ShuntDc: -r_e
  DS_INV_L1,          // ShuntDc: 1 / l_e
  DS_LOAD_A,          // polynomial static load a, b, c
  DS_LOAD_B,
  DS_LOAD_C,
  DS_OMEGA_LIN,       // a / j_total * tau_decay
  DS_JT_OVER_TD,      // j_total / tau_decay
  DS_INV_JT,          // 1 / j_total
  DS_HALF_TAU,
  DS_TAU,
  DS_SIXTH,
  DS_INV_W_LIM,       // 1 / omega limit
  DS_I0_LIM,          // limit of i (SeriesDc) or i_a (ShuntDc)
  DS_I1_LIM,          // ShuntDc: limit of i_e
  DS_VIOLATION_REWARD,
  DS_MARGIN,          // nominal / limit of omega: the window [0, margin]
  DS_EP_LO,           // SpecParams: 500, 1500, the env's log10 sigma range, ln 10
  DS_EP_SPAN,
  DS_SIG_BASE,
  DS_SIG_SPAN,
  DS_LN10,
  DS_U_MIN,
  DS_TWO_PI,
  DS_SHUNT,           // 1 for ShuntDc (NEL 2), 0 for SeriesDc (NEL 1)
  N_DC_SC_CONST
};

struct DcScConst {
  float v[N_DC_SC_CONST];
};

namespace {

struct DcScState {
  float w, i0, i1;
};

template <int NEL>
__device__ __forceinline__ DcScState dcsc_rhs(const DcScConst& k, const DcScState& s, float u) {
  DcScState d;
  float torque;
  if (NEL == 1) {
    d.i0 = ((k.v[DS_NEG_R0] * s.i0 - (k.v[DS_L_P] * s.i0) * s.w) + u) * k.v[DS_INV_L0];
    d.i1 = 0.0f;
    torque = (k.v[DS_L_P] * s.i0) * s.i0;
  } else {
    d.i0 = ((k.v[DS_NEG_R0] * s.i0 - (k.v[DS_L_P] * s.i1) * s.w) + u) * k.v[DS_INV_L0];
    d.i1 = (k.v[DS_NEG_R1] * s.i1 + u) * k.v[DS_INV_L1];
    torque = (k.v[DS_L_P] * s.i1) * s.i0;
  }
  d.w = poly_load_rhs(k.v[DS_LOAD_A], k.v[DS_LOAD_B], k.v[DS_LOAD_C], k.v[DS_OMEGA_LIN],
                      k.v[DS_JT_OVER_TD], k.v[DS_INV_JT], s.w, torque);
  return d;
}

template <int NEL>
__device__ __forceinline__ DcScState dcsc_axpy(const DcScState& s, float c, const DcScState& d) {
  DcScState y;
  y.w = s.w + c * d.w;
  y.i0 = s.i0 + c * d.i0;
  y.i1 = NEL == 2 ? s.i1 + c * d.i1 : 0.0f;
  return y;
}

// Cont-4QC, then one joint RK4 step.
template <int NEL>
__device__ __forceinline__ DcScState dcsc_physics(const DcScConst& k, const DcScState& s,
                                                  float a) {
  const float u = a * k.v[DS_U_SUP];
  const float h = k.v[DS_HALF_TAU];
  const DcScState k1 = dcsc_rhs<NEL>(k, s, u);
  const DcScState k2 = dcsc_rhs<NEL>(k, dcsc_axpy<NEL>(s, h, k1), u);
  const DcScState k3 = dcsc_rhs<NEL>(k, dcsc_axpy<NEL>(s, h, k2), u);
  const DcScState k4 = dcsc_rhs<NEL>(k, dcsc_axpy<NEL>(s, k.v[DS_TAU], k3), u);
  const float sixth = k.v[DS_SIXTH];
  DcScState y;
  y.w = s.w + sixth * ((k1.w + 2.0f * (k2.w + k3.w)) + k4.w);
  y.i0 = s.i0 + sixth * ((k1.i0 + 2.0f * (k2.i0 + k3.i0)) + k4.i0);
  y.i1 = NEL == 2 ? s.i1 + sixth * ((k1.i1 + 2.0f * (k2.i1 + k3.i1)) + k4.i1) : 0.0f;
  return y;
}

__device__ __forceinline__ SpecParams dcsc_params(const DcScConst& k) {
  return SpecParams{k.v[DS_EP_LO], k.v[DS_EP_SPAN], k.v[DS_SIG_BASE], k.v[DS_SIG_SPAN],
                    k.v[DS_LN10]};
}

// A reference value on the window [0, margin]: (1 U - 0) margin, the
// arithmetic of the plain version's shared value form (exactly U margin).
__device__ __forceinline__ float dcsc_value(const DcScConst& k, uint32_t b) {
  return (1.0f * uniform24(b) - 0.0f) * k.v[DS_MARGIN];
}

template <int NEL>
__device__ __forceinline__ DcScState dcsc_load(const SpecIn& in, int e) {
  DcScState s;
  s.w = in.p[0][e];
  s.i0 = in.p[1][e];
  s.i1 = NEL == 2 ? in.p[2][e] : 0.0f;
  return s;
}

// The reference row at step 0.
__device__ __forceinline__ SpecRow dcsc_row_init(const DcScConst& k, uint2 key, uint32_t e) {
  const uint4 w0 = spec_draw(key, e, 0u, SPEC_SLOT_INIT_0);
  SpecRow r;
  r.rv = dcsc_value(k, w0.x);
  r.rk = 0.0f;
  spec_params(dcsc_params(k), w0.y, w0.z, r.rl, r.rs);
  return r;
}

// The state, reward, terms, rv, rk, rl, rs of env e.
template <int NEL>
__device__ __forceinline__ void dcsc_store(const SpecOut& out, int e, const DcScState& s,
                                           float reward, float terms, const SpecRow& r) {
  out.p[0][e] = s.w;
  out.p[1][e] = s.i0;
  const int o = NEL == 2 ? 3 : 2;
  if (NEL == 2) out.p[2][e] = s.i1;
  out.p[o][e] = reward;
  out.p[o + 1][e] = terms;
  out.p[o + 2][e] = r.rv;
  out.p[o + 3][e] = r.rk;
  out.p[o + 4][e] = r.rl;
  out.p[o + 5][e] = r.rs;
}

template <int NEL>
__global__ void dc_sc_rollout_random_kernel(DcScConst k, uint2 key, int n, int n_steps,
                                            SpecIn in, SpecOut out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  DcScState s = dcsc_load<NEL>(in, e);
  SpecRow r = dcsc_row_init(k, key, (uint32_t)e);
  float reward = 0.0f, terms = 0.0f, zb = 0.0f;
#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) {
    const uint4 w = spec_draw(key, (uint32_t)e, (uint32_t)t, SPEC_SLOT_STEP);
    const DcScState y = dcsc_physics<NEL>(k, s, 2.0f * uniform24(w.x) - 1.0f);
    const float w_n = y.w * k.v[DS_INV_W_LIM];
    bool violated = fabsf(y.i0) > k.v[DS_I0_LIM];
    if (NEL == 2) violated = violated || (fabsf(y.i1) > k.v[DS_I1_LIM]);
    reward += violated ? k.v[DS_VIOLATION_REWARD] : -fabsf(w_n - r.rv);
    terms += violated ? 1.0f : 0.0f;
    s.w = violated ? 0.0f : y.w;
    s.i0 = violated ? 0.0f : y.i0;
    s.i1 = violated ? 0.0f : y.i1;
    float draw;
    if ((t & 1) == 0) {
      spec_box_muller(k.v[DS_U_MIN], k.v[DS_TWO_PI], w.y, w.z, draw, zb);
    } else {
      draw = zb;
    }
    const bool regen = (r.rk >= r.rl) || violated;
    float rl = 0.0f, rs = 0.0f;
    uint4 p = make_uint4(0u, 0u, 0u, 0u);
    if (regen) {
      p = spec_draw(key, (uint32_t)e, (uint32_t)t, SPEC_SLOT_PARAMS);
      spec_params(dcsc_params(k), p.x, p.y, rl, rs);
    }
    spec_row_walk(r, regen, rl, rs, draw, 0.0f, k.v[DS_MARGIN]);
    if (violated) r.rv = dcsc_value(k, p.z);
  }
  dcsc_store<NEL>(out, e, s, reward, terms, r);
}

// ---- the warp-specialised random rollout ------------------------------

// The words of a step on the ring (ring_pipe.cuh): the duty, the reference
// row's draw, its candidate length and sigma, and its candidate reset value.
constexpr int kDcScWords = 5;

// Producer side: what step t draws whatever the state, in the operand
// order of dc_sc_rollout_random_kernel's step: the duty 2 U - 1 of
// SPEC_SLOT_STEP's first word, the Box-Muller pair at even steps (odd false)
// with its sine left in zb for the odd step after it, and of
// SPEC_SLOT_PARAMS the length and sigma a regeneration takes and the value
// a reset takes.
__device__ __forceinline__ RingWords<kDcScWords> dcsc_draws(const DcScConst& k, uint2 key,
                                                            uint32_t env, uint32_t t, bool odd,
                                                            float& zb) {
  const uint4 w = spec_draw(key, env, t, SPEC_SLOT_STEP);
  float draw;
  if (odd) {
    draw = zb;
  } else {
    spec_box_muller(k.v[DS_U_MIN], k.v[DS_TWO_PI], w.y, w.z, draw, zb);
  }
  const uint4 p = spec_draw(key, env, t, SPEC_SLOT_PARAMS);
  float rl, rs;
  spec_params(dcsc_params(k), p.x, p.y, rl, rs);
  RingWords<kDcScWords> x;
  x.w[0] = __float_as_uint(2.0f * uniform24(w.x) - 1.0f);
  x.w[1] = __float_as_uint(draw);
  x.w[2] = __float_as_uint(rl);
  x.w[3] = __float_as_uint(rs);
  x.w[4] = __float_as_uint(dcsc_value(k, p.z));
  return x;
}

// Consumer side: the one-thread step with the step's words given, the
// candidates taken by selects.
template <int NEL>
__device__ __forceinline__ void dcsc_ring_step(const DcScConst& k, const RingWords<kDcScWords>& x,
                                               DcScState& s, SpecRow& r, float& reward,
                                               float& terms) {
  const DcScState y = dcsc_physics<NEL>(k, s, __uint_as_float(x.w[0]));
  const float w_n = y.w * k.v[DS_INV_W_LIM];
  bool violated = fabsf(y.i0) > k.v[DS_I0_LIM];
  if (NEL == 2) violated = violated || (fabsf(y.i1) > k.v[DS_I1_LIM]);
  reward += violated ? k.v[DS_VIOLATION_REWARD] : -fabsf(w_n - r.rv);
  terms += violated ? 1.0f : 0.0f;
  s.w = violated ? 0.0f : y.w;
  s.i0 = violated ? 0.0f : y.i0;
  s.i1 = violated ? 0.0f : y.i1;
  const bool regen = (r.rk >= r.rl) || violated;
  spec_row_walk(r, regen, __uint_as_float(x.w[2]), __uint_as_float(x.w[3]),
                __uint_as_float(x.w[1]), 0.0f, k.v[DS_MARGIN]);
  r.rv = violated ? __uint_as_float(x.w[4]) : r.rv;
}

// The ring: K = 8 steps a slot, two producer warps per consumer warp, each
// drawing four steps of a slot (K = 4 or one producer warp was slower on
// both motors, PERF.md, slice 16).
using DcScRing = RingShape<8, 2>;

// The random rollout warp-specialised: producer warps run dcsc_draws,
// consumer warps dcsc_ring_step, one thread per env.
template <int NEL>
__global__ void __launch_bounds__(DcScRing::kThreads)
    dc_sc_rollout_ws_kernel(DcScConst k, uint2 key, int n, int n_steps, SpecIn in, SpecOut out) {
  extern __shared__ uint32_t ring[];
  const RingThread th = ring_thread(n);
  const int e = th.e;
  const RingPipe<DcScRing> pipe(n_steps);
  const RingView<kDcScWords> v{ring + th.le};
  if (!th.consumer) {
    ring_produce(pipe, v, th.part, [&](uint32_t t, bool odd, float& zb) {
      return dcsc_draws(k, key, (uint32_t)e, t, odd, zb);
    });
    return;
  }
  DcScState s = dcsc_load<NEL>(in, e);
  SpecRow r = dcsc_row_init(k, key, (uint32_t)e);
  float reward = 0.0f, terms = 0.0f;
  ring_consume(pipe, v, n_steps, [&](const RingWords<kDcScWords>& x) {
    dcsc_ring_step<NEL>(k, x, s, r, reward, terms);
  });
  if (th.live) dcsc_store<NEL>(out, e, s, reward, terms, r);
}

template <int NEL>
__global__ void dc_sc_rollout_buffer_kernel(DcScConst k, int n, int n_steps, SpecIn in,
                                            const float* __restrict__ actions, SpecOut out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  DcScState s;
  s.w = in.p[0][e];
  s.i0 = in.p[1][e];
  s.i1 = NEL == 2 ? in.p[2][e] : 0.0f;
#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) s = dcsc_physics<NEL>(k, s, actions[(size_t)t * n + e]);
  out.p[0][e] = s.w;
  out.p[1][e] = s.i0;
  if (NEL == 2) out.p[2][e] = s.i1;
}

DcScConst ds_consts(const float* consts) {
  DcScConst k;
  for (int j = 0; j < N_DC_SC_CONST; ++j) k.v[j] = consts[j];
  return k;
}

bool ds_shunt(const DcScConst& k) { return k.v[DS_SHUNT] != 0.0f; }

// The one-thread random kernels are never launched: tools/sass_ops.py counts
// their step, the function's own work, for the bound.
template __global__ void dc_sc_rollout_random_kernel<1>(DcScConst, uint2, int, int, SpecIn,
                                                        SpecOut);
template __global__ void dc_sc_rollout_random_kernel<2>(DcScConst, uint2, int, int, SpecIn,
                                                        SpecOut);

}  // namespace

extern "C" {

SPEC_C_INFO(dc_sc, N_DC_SC_CONST)

// in: (omega, i) or (omega, i_a, i_e); out: the state, reward, terms, rv,
// rk, rl, rs, each (R, 128).
int dc_sc_rollout_random(const float* consts, unsigned long long seed, int n, int n_steps,
                         const float* const* in, float* const* out, void* stream) {
  const DcScConst k = ds_consts(consts);
  const bool shunt = ds_shunt(k);
  const int n_state = shunt ? 3 : 2;
  auto kernel = shunt ? dc_sc_rollout_ws_kernel<2> : dc_sc_rollout_ws_kernel<1>;
  constexpr int bytes = ring_bytes<DcScRing>(kDcScWords);
  static_assert(bytes <= 48 * 1024, "the ring fits the default dynamic shared memory");
  kernel<<<(n + kRingEnvs - 1) / kRingEnvs, DcScRing::kThreads, bytes, (cudaStream_t)stream>>>(
      k, spec_seed_key(seed), n, n_steps, spec_in(in, n_state), spec_out(out, n_state + 6));
  return (int)cudaGetLastError();
}

// The random rollout's ring (ring_pipe.cuh's RingLayout), the same for
// both motors.
int dc_sc_ring_layout(int* out) {
  ring_layout<DcScRing>(kDcScWords, out);
  return 0;
}

// actions: float32 (T, R, 128) duties; out: the state, each (R, 128).
int dc_sc_rollout_buffer(const float* consts, int n, int n_steps, const float* const* in,
                         const float* actions, float* const* out, void* stream) {
  const DcScConst k = ds_consts(consts);
  const bool shunt = ds_shunt(k);
  const int n_state = shunt ? 3 : 2;
  auto kernel = shunt ? dc_sc_rollout_buffer_kernel<2> : dc_sc_rollout_buffer_kernel<1>;
  kernel<<<spec_blocks(n), kSpecThreads, 0, (cudaStream_t)stream>>>(
      k, n, n_steps, spec_in(in, n_state), actions, spec_out(out, n_state));
  return (int)cudaGetLastError();
}

}  // extern "C"
