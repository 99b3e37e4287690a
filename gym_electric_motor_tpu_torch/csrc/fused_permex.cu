// The specialised Finite-CC-PermExDc fused rollouts for Hopper (sm_90a): the
// reducing rollout and the trajectory recorder, each in a random-action and
// an action-buffer mode, with a plain C interface for ctypes (every
// function returns cudaGetLastError()).
//
// Replaces (gym_electric_motor_tpu/ops/):
//   permex_rollout_buffer  pallas_dc.py  make_fused_permex_rollout, buffer mode (:192)
//   permex_rollout_random  pallas_dc.py  make_fused_permex_rollout, random mode (:206)
//   permex_record_buffer   pallas_dc.py  make_fused_permex_record_rollout, buffer mode (:275)
//   permex_record_random   pallas_dc.py  make_fused_permex_record_rollout, random mode (:349)
//
// The step (_PermExCtx, pallas_dc.py:54-91): the 4QC voltage table (action 1
// gives +u_sup, 2 gives -u_sup, else 0) and RK4 on the armature current at
// constant speed are dc_step.cuh's dc_physics<FINITE, constant speed, one
// current> with the DC family's constants of the env (DcConst, from
// ops/fused_dc_family.py's DcConsts on the host, its converter code the
// 4QC's; the family's x - (0 w) i term rounds exactly as the JAX kernel's
// x); then the limit constraint on
// |i| / i_lim, the WSE reward -|i_n - ref| / 2 against the pre-advance
// reference, the reset of a violating env to i = 0, and the Wiener current
// reference with the builder's own constants (sub-episode length
// floor(U[500, 2000)), sigma 10^U[-2, -1], the margin nominal / limit).
//
// Design: the current and the reference row in registers across a
// `#pragma unroll 1` loop over T steps.  The random rollout is
// warp-specialised on the shared-memory ring of ring_pipe.cuh: producer
// warps draw, in a double-buffered ring of K steps a slot, every value of a
// step that depends on the constants alone (px_draws: the action code, the
// row's normal draw, its candidate length and sigma and its candidate reset
// value, 5 words); consumer warps run the step, one thread per env, and
// take the candidates by selects (px_ring_advance).  The random recorder
// runs on a ring of its own (PermexRecordRing): its producers draw the same
// 5 words with the recorder's fresh pair each step (px_record_draws), its
// consumers run the rollout's px_ring_advance and store each step's signals
// [t, env].  The one-thread random kernels had the
// Philox call and the Box-Muller pair (the rollout's at every second step)
// on every step's chain, and the PARAMS slot in a branch that most warps
// took at some lane (3.6% of env-steps reset); they are built for
// tools/sass_ops.py's count of the function's own work and never launched.
// The buffer kernels run one thread per env.  Random bits
// from Philox4x32-10 keyed by the seed, counter (env, step, slot): slot
// SPEC_SLOT_STEP gives (action, Box-Muller u1, u2, -) every step, slot
// SPEC_SLOT_PARAMS (length, sigma, reset value, -) where the row
// regenerates (a violation always does), slot SPEC_SLOT_INIT_0 (value,
// length, sigma, -) at step 0.  The rollout draws one Box-Muller pair at
// even steps and keeps its sine for the odd step (pallas_dc.py:146-163);
// the recorder draws a fresh pair each step and uses its cosine
// (:335-340).  The producers draw PARAMS at every step, which changes no
// bit of what a step uses, and each producer's steps pair an even step with
// the odd one after it, so the sine half reaches the odd step in the
// producer's registers; the recorder's producers carry nothing between
// steps.  The recorder needs no chunk grid: the state stays in registers
// and each step's signals are stored [t, env], coalesced.
// Built with -fmad=false (ops/cuda_build.py), so each multiply and add
// rounds as in the plain PyTorch version (ops/fused_dc.py), and the
// producers compute each candidate with the one-thread kernel's functions
// on the same operands, so the two designs are equal bit for bit.
//
// What bounds it on this card: the rollouts move one plane in and seven
// out (and 4 bytes of action per env-step in buffer mode), the recorders
// 17 bytes per env-step (4 in buffer mode); the step itself is about 37
// FP32 operations of RK4 (the family's, with its x - (0 w) i term), a
// Philox call, and at every second step the Box-Muller pair's
// non-fast-math logf, cosf and sinf.  tools/sass_ops.py counts the
// instructions a step always issues, per pipe.  On the ring the producers
// issue two Philox calls a step (PARAMS too) and the Box-Muller pair every
// second step (the recorder's every step), the consumers 5 shared-memory
// loads and the recorder's its 5 stores; tools/sass_ops.py counts both
// roles beside the one-thread step.
#include "dc_step.cuh"
#include "ring_pipe.cuh"
#include "specialised_step.cuh"

// The builder's own constants; the physics takes the DC family's (DcConst).
enum PermexConstIndex {
  PX_INV_I_LIM = 0,   // 1 / i_lim
  PX_NEG_W,           // -w / span = -1/2
  PX_VIOLATION_REWARD,
  PX_MARGIN,          // nominal / limit of i
  PX_EP_LO,           // SpecParams: 500, 1500, -2, 1, ln 10
  PX_EP_SPAN,
  PX_SIG_BASE,
  PX_SIG_SPAN,
  PX_LN10,
  PX_U_MIN,           // guard before the Box-Muller log
  PX_TWO_PI,
  N_PERMEX_CONST
};

struct PermexConst {
  float v[N_PERMEX_CONST];
};

namespace {

// The 4QC voltage table, then one RK4 step of the armature current.
__device__ __forceinline__ float px_physics(const DcConst& dc, float i, int a) {
  DcState x{0.0f, i, 0.0f};
  dc_physics<true, false, MC_ONE>(dc, DcAction{a, 0, 0.0f, 0.0f}, x);
  return x.i0;
}

__device__ __forceinline__ SpecParams px_params(const PermexConst& k) {
  return SpecParams{k.v[PX_EP_LO], k.v[PX_EP_SPAN], k.v[PX_SIG_BASE], k.v[PX_SIG_SPAN],
                    k.v[PX_LN10]};
}

__device__ __forceinline__ void px_ref_init(const PermexConst& k, uint2 key, uint32_t e,
                                            SpecRow& r) {
  const uint4 w = spec_draw(key, e, 0u, SPEC_SLOT_INIT_0);
  r.rv = (2.0f * uniform24(w.x) - 1.0f) * k.v[PX_MARGIN];
  r.rk = 0.0f;
  spec_params(px_params(k), w.y, w.z, r.rl, r.rs);
}

// The current, reward, terms, rv, rk, rl, rs of env e.
__device__ __forceinline__ void px_store(const SpecOut& out, int e, float i, float reward,
                                         float terms, const SpecRow& r) {
  out.p[0][e] = i;
  out.p[1][e] = reward;
  out.p[2][e] = terms;
  out.p[3][e] = r.rv;
  out.p[4][e] = r.rk;
  out.p[5][e] = r.rl;
  out.p[6][e] = r.rs;
}

struct PxStepOut {
  float reward, done, ref;
};

// Physics, constraint, reward against the pre-advance reference, reset.
__device__ __forceinline__ PxStepOut px_action_step(const DcConst& dc, const PermexConst& k,
                                                    int a, float& i, const SpecRow& r) {
  const float i_new = px_physics(dc, i, a);
  const float i_n = i_new * k.v[PX_INV_I_LIM];
  const bool violated = fabsf(i_n) > 1.0f;
  PxStepOut o;
  o.reward = violated ? k.v[PX_VIOLATION_REWARD] : k.v[PX_NEG_W] * fabsf(i_n - r.rv);
  o.done = violated ? 1.0f : 0.0f;
  o.ref = r.rv;
  i = violated ? 0.0f : i_new;
  return o;
}

// The reference's advance with the step's normal draw.
__device__ __forceinline__ void px_ref_advance(const PermexConst& k, uint2 key, uint32_t e,
                                               uint32_t t, bool violated, float draw, SpecRow& r) {
  const bool regen = (r.rk >= r.rl) || violated;
  float rl = 0.0f, rs = 0.0f;
  uint4 p = make_uint4(0u, 0u, 0u, 0u);
  if (regen) {
    p = spec_draw(key, e, t, SPEC_SLOT_PARAMS);
    spec_params(px_params(k), p.x, p.y, rl, rs);
  }
  const float m = k.v[PX_MARGIN];
  spec_row_walk(r, regen, rl, rs, draw, -m, m);
  if (violated) r.rv = (2.0f * uniform24(p.z) - 1.0f) * m;
}

// The one-thread random rollout: built, never launched; tools/sass_ops.py
// counts its step, the function's own work, for the bound.
__global__ void permex_rollout_random_kernel(DcConst dc, PermexConst k, uint2 key, int n,
                                             int n_steps, SpecIn in, SpecOut out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float i = in.p[0][e];
  SpecRow r;
  px_ref_init(k, key, (uint32_t)e, r);
  float reward = 0.0f, terms = 0.0f, zb = 0.0f;
#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) {
    const uint4 w = spec_draw(key, (uint32_t)e, (uint32_t)t, SPEC_SLOT_STEP);
    const PxStepOut o = px_action_step(dc, k, (int)(w.x & 3u), i, r);
    float draw;
    if ((t & 1) == 0) {
      spec_box_muller(k.v[PX_U_MIN], k.v[PX_TWO_PI], w.y, w.z, draw, zb);
    } else {
      draw = zb;
    }
    px_ref_advance(k, key, (uint32_t)e, (uint32_t)t, o.done != 0.0f, draw, r);
    reward += o.reward;
    terms += o.done;
  }
  px_store(out, e, i, reward, terms, r);
}

// ---- the warp-specialised random rollout ------------------------------

// The words of a step on the ring (ring_pipe.cuh): the action code, the
// reference row's draw, its candidate length and sigma, and its candidate
// reset value.
constexpr int kPermexWords = 5;

// The words of a step from the action word w.x of SPEC_SLOT_STEP, the row's
// normal draw and the SPEC_SLOT_PARAMS words p: the code w.x & 3, the draw,
// the length and sigma a regeneration takes and the value a reset takes.
__device__ __forceinline__ RingWords<kPermexWords> px_pack(const PermexConst& k, uint32_t wx,
                                                           float draw, uint4 p) {
  float rl, rs;
  spec_params(px_params(k), p.x, p.y, rl, rs);
  RingWords<kPermexWords> x;
  x.w[0] = wx & 3u;
  x.w[1] = __float_as_uint(draw);
  x.w[2] = __float_as_uint(rl);
  x.w[3] = __float_as_uint(rs);
  x.w[4] = __float_as_uint((2.0f * uniform24(p.z) - 1.0f) * k.v[PX_MARGIN]);
  return x;
}

// Producer side: what step t draws whatever the state, in the operand
// order of permex_rollout_random_kernel's step: SPEC_SLOT_STEP's action
// word, the Box-Muller pair at even steps (odd false) with its sine left in
// zb for the odd step after it, and SPEC_SLOT_PARAMS.
__device__ __forceinline__ RingWords<kPermexWords> px_draws(const PermexConst& k, uint2 key,
                                                            uint32_t env, uint32_t t, bool odd,
                                                            float& zb) {
  const uint4 w = spec_draw(key, env, t, SPEC_SLOT_STEP);
  float draw;
  if (odd) {
    draw = zb;
  } else {
    spec_box_muller(k.v[PX_U_MIN], k.v[PX_TWO_PI], w.y, w.z, draw, zb);
  }
  return px_pack(k, w.x, draw, spec_draw(key, env, t, SPEC_SLOT_PARAMS));
}

// The recorder's producer side: a fresh pair at every step, its cosine
// alone, in permex_record_random_kernel's expression and operand order
// (not spec_box_muller's), then the words of px_draws.
__device__ __forceinline__ RingWords<kPermexWords> px_record_draws(const PermexConst& k,
                                                                   uint2 key, uint32_t env,
                                                                   uint32_t t) {
  const uint4 w = spec_draw(key, env, t, SPEC_SLOT_STEP);
  const float rad = sqrtf(-2.0f * logf(fmaxf(uniform24(w.y), k.v[PX_U_MIN])));
  const float draw = rad * cosf(k.v[PX_TWO_PI] * uniform24(w.z));
  return px_pack(k, w.x, draw, spec_draw(key, env, t, SPEC_SLOT_PARAMS));
}

// Consumer side: the one-thread step with the step's words given, the
// candidates taken by selects; returns the step's reward, done and
// pre-advance reference.
__device__ __forceinline__ PxStepOut px_ring_advance(const DcConst& dc, const PermexConst& k,
                                                     const RingWords<kPermexWords>& x, float& i,
                                                     SpecRow& r) {
  const PxStepOut o = px_action_step(dc, k, (int)x.w[0], i, r);
  const bool violated = o.done != 0.0f;
  const bool regen = (r.rk >= r.rl) || violated;
  const float m = k.v[PX_MARGIN];
  spec_row_walk(r, regen, __uint_as_float(x.w[2]), __uint_as_float(x.w[3]),
                __uint_as_float(x.w[1]), -m, m);
  r.rv = violated ? __uint_as_float(x.w[4]) : r.rv;
  return o;
}

// The ring: 8 steps a slot, 2 producer warps per consumer warp, each
// drawing 4 steps of a slot (the fastest of K in {4, 8} x P in {1, 2} and
// K = 8 with P = 4, PERF.md, slice 20); ops/fused_dc.py's PERMEX_RING
// mirrors it.  At 5 words a step it holds 40 KB.
using PermexRing = RingShape<8, 2>;

// The random rollout warp-specialised: producer warps run px_draws,
// consumer warps px_ring_advance, one thread per env.
__global__ void __launch_bounds__(PermexRing::kThreads)
    permex_rollout_ws_kernel(DcConst dc, PermexConst k, uint2 key, int n, int n_steps,
                             SpecIn in, SpecOut out) {
  extern __shared__ uint32_t ring[];
  const RingThread th = ring_thread(n);
  const int e = th.e;
  const RingPipe<PermexRing> pipe(n_steps);
  const RingView<kPermexWords> v{ring + th.le};
  if (!th.consumer) {
    ring_produce(pipe, v, th.part, [&](uint32_t t, bool odd, float& zb) {
      return px_draws(k, key, (uint32_t)e, t, odd, zb);
    });
    return;
  }
  float i = in.p[0][e];
  SpecRow r;
  px_ref_init(k, key, (uint32_t)e, r);
  float reward = 0.0f, terms = 0.0f;
  ring_consume(pipe, v, n_steps, [&](const RingWords<kPermexWords>& x) {
    const PxStepOut o = px_ring_advance(dc, k, x, i, r);
    reward += o.reward;
    terms += o.done;
  });
  if (th.live) px_store(out, e, i, reward, terms, r);
}

// The one-thread random recorder: built, never launched; tools/sass_ops.py
// counts its step, the function's own work, for the bound.
__global__ void permex_record_random_kernel(DcConst dc, PermexConst k, uint2 key, int n,
                                            int n_steps, SpecIn in, SpecOut out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float i = in.p[0][e];
  SpecRow r;
  px_ref_init(k, key, (uint32_t)e, r);
  int* out_act = reinterpret_cast<int*>(out.p[2]);
#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) {
    const uint4 w = spec_draw(key, (uint32_t)e, (uint32_t)t, SPEC_SLOT_STEP);
    const int a = (int)(w.x & 3u);
    const PxStepOut o = px_action_step(dc, k, a, i, r);
    const size_t at = (size_t)t * n + e;
    out.p[0][at] = i;
    out.p[1][at] = o.ref;
    out_act[at] = a;
    out.p[3][at] = o.reward;
    out.p[4][at] = o.done;
    const float rad = sqrtf(-2.0f * logf(fmaxf(uniform24(w.y), k.v[PX_U_MIN])));
    const float draw = rad * cosf(k.v[PX_TWO_PI] * uniform24(w.z));
    px_ref_advance(k, key, (uint32_t)e, (uint32_t)t, o.done != 0.0f, draw, r);
  }
}

// ---- the warp-specialised random recorder ------------------------------

// The recorder's ring: 8 steps a slot, 2 producer warps per consumer warp,
// of K in {4, 8} x P in {1, 2} at 16384 envs x 1024 steps on
// Finite-CC-PermExDc (PERF.md, slice 26; each shape against the one-thread
// recorder in its own process, 0.3752 to 0.3783 ms): K = 8, P = 2 0.2619 ms
// (1.445 of the one-thread time); K = 4, P = 2 0.2606 (1.441); K = 4,
// P = 1 0.3603 (1.042); K = 8, P = 1 0.3675 (1.022).  The two shapes with
// two producer warps lie within 0.5%, and K = 8 gained the most against
// the parent in its own process.  ops/fused_dc.py's PERMEX_RECORD_RING
// mirrors it.  No sine half is carried, so a producer's steps need not
// pair.  At 5 words a step it holds 40 KB.
using PermexRecordRing = RingShape<8, 2>;

// The random recorder warp-specialised: producer warps run
// px_record_draws, consumer warps px_ring_advance, one thread per env, and
// store what permex_record_random_kernel stores: the post-step current, the
// pre-advance reference, the action (int32), the reward and done.
__global__ void __launch_bounds__(PermexRecordRing::kThreads)
    permex_record_ws_kernel(DcConst dc, PermexConst k, uint2 key, int n, int n_steps,
                            SpecIn in, SpecOut out) {
  extern __shared__ uint32_t ring[];
  const RingThread th = ring_thread(n);
  const int e = th.e;
  const RingPipe<PermexRecordRing> pipe(n_steps);
  const RingView<kPermexWords> v{ring + th.le};
  if (!th.consumer) {
    ring_produce(pipe, v, th.part, [&](uint32_t t, bool, float&) {
      return px_record_draws(k, key, (uint32_t)e, t);
    });
    return;
  }
  float i = in.p[0][e];
  SpecRow r;
  px_ref_init(k, key, (uint32_t)e, r);
  int* out_act = reinterpret_cast<int*>(out.p[2]);
  size_t at = (size_t)e;   // t n + e at step t
  ring_consume(pipe, v, n_steps, [&](const RingWords<kPermexWords>& x) {
    const PxStepOut o = px_ring_advance(dc, k, x, i, r);
    if (th.live) {
      out.p[0][at] = i;
      out.p[1][at] = o.ref;
      out_act[at] = (int)x.w[0];
      out.p[3][at] = o.reward;
      out.p[4][at] = o.done;
    }
    at += (size_t)n;
  });
}

__global__ void permex_rollout_buffer_kernel(DcConst dc, int n, int n_steps, SpecIn in,
                                             const int* __restrict__ actions, SpecOut out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float i = in.p[0][e];
#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) i = px_physics(dc, i, actions[(size_t)t * n + e]);
  out.p[0][e] = i;
}

__global__ void permex_record_buffer_kernel(DcConst dc, int n, int n_steps, SpecIn in,
                                            const int* __restrict__ actions, SpecOut out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float i = in.p[0][e];
#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) {
    const size_t at = (size_t)t * n + e;
    i = px_physics(dc, i, actions[at]);
    out.p[0][at] = i;
  }
}

PermexConst px_consts(const float* spec) {
  PermexConst k;
  for (int j = 0; j < N_PERMEX_CONST; ++j) k.v[j] = spec[j];
  return k;
}

}  // namespace

extern "C" {

SPEC_FAMILY_C_INFO(permex, N_DC_CONST, N_ROW_CONST, N_DC_FLAG, N_PERMEX_CONST)

// consts and flags: the DC family's (dc_step.cuh) for Finite-CC-PermExDc;
// spec: the builder's own (PermexConstIndex), which the buffer kernels do
// not read (their step is the family's alone).
// in: (i0); out: (i, reward, terms, rv, rk, rl, rs), each (R, 128).
// The random rollout runs on its ring.
int permex_rollout_random(const float* consts, const int* flags, const float* spec,
                          unsigned long long seed, int n, int n_steps, const float* const* in,
                          float* const* out, void* stream) {
  constexpr int bytes = ring_bytes<PermexRing>(kPermexWords);
  static_assert(bytes <= 48 * 1024, "the ring fits the default dynamic shared memory");
  permex_rollout_ws_kernel<<<(n + kRingEnvs - 1) / kRingEnvs, PermexRing::kThreads, bytes,
                             (cudaStream_t)stream>>>(
      dc_load_const(consts, flags), px_consts(spec), spec_seed_key(seed), n, n_steps,
      spec_in(in, 1), spec_out(out, 7));
  return (int)cudaGetLastError();
}

// The random rollout's ring (ring_pipe.cuh's RingLayout).
int permex_ring_layout(int* out) {
  ring_layout<PermexRing>(kPermexWords, out);
  return 0;
}

// out: (i, ref, action (int32), reward, done), each (T, R, 128).  The
// random recorder runs on its ring.
int permex_record_random(const float* consts, const int* flags, const float* spec,
                         unsigned long long seed, int n, int n_steps, const float* const* in,
                         float* const* out, void* stream) {
  constexpr int bytes = ring_bytes<PermexRecordRing>(kPermexWords);
  static_assert(bytes <= 48 * 1024, "the ring fits the default dynamic shared memory");
  permex_record_ws_kernel<<<(n + kRingEnvs - 1) / kRingEnvs, PermexRecordRing::kThreads, bytes,
                            (cudaStream_t)stream>>>(
      dc_load_const(consts, flags), px_consts(spec), spec_seed_key(seed), n, n_steps,
      spec_in(in, 1), spec_out(out, 5));
  return (int)cudaGetLastError();
}

// The random recorder's ring (ring_pipe.cuh's RingLayout).
int permex_record_ring_layout(int* out) {
  ring_layout<PermexRecordRing>(kPermexWords, out);
  return 0;
}

// actions: int32 (T, R, 128); out: (i), (R, 128).
int permex_rollout_buffer(const float* consts, const int* flags, const float*, int n,
                          int n_steps, const float* const* in, const int* actions,
                          float* const* out, void* stream) {
  permex_rollout_buffer_kernel<<<spec_blocks(n), kSpecThreads, 0, (cudaStream_t)stream>>>(
      dc_load_const(consts, flags), n, n_steps, spec_in(in, 1), actions, spec_out(out, 1));
  return (int)cudaGetLastError();
}

// out: (i), (T, R, 128).
int permex_record_buffer(const float* consts, const int* flags, const float*, int n,
                         int n_steps, const float* const* in, const int* actions,
                         float* const* out, void* stream) {
  permex_record_buffer_kernel<<<spec_blocks(n), kSpecThreads, 0, (cudaStream_t)stream>>>(
      dc_load_const(consts, flags), n, n_steps, spec_in(in, 1), actions, spec_out(out, 1));
  return (int)cudaGetLastError();
}

}  // extern "C"
