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
// Design: one thread per env, the current and the reference row in
// registers across a `#pragma unroll 1` loop over T steps.  Random bits
// from Philox4x32-10 keyed by the seed, counter (env, step, slot): slot
// SPEC_SLOT_STEP gives (action, Box-Muller u1, u2, -) every step, slot
// SPEC_SLOT_PARAMS (length, sigma, reset value, -) where the row
// regenerates (a violation always does), slot SPEC_SLOT_INIT_0 (value,
// length, sigma, -) at step 0.  The rollout draws one Box-Muller pair at
// even steps and keeps its sine for the odd step (pallas_dc.py:146-163);
// the recorder draws a fresh pair each step and uses its cosine
// (:335-340).  The recorder needs no chunk grid: the state stays in
// registers and each step's signals are stored [t, env], coalesced.  Built
// with -fmad=false (ops/cuda_build.py), so each multiply and add rounds as
// in the plain PyTorch version (ops/fused_dc.py).
//
// What bounds it on this card: the rollouts move one plane in and seven
// out (and 4 bytes of action per env-step in buffer mode), the recorders
// 17 bytes per env-step (4 in buffer mode); the step itself is about 37
// FP32 operations of RK4 (the family's, with its x - (0 w) i term), a
// Philox call, and at every second step the Box-Muller pair's
// non-fast-math logf, cosf and sinf.  tools/sass_ops.py counts the
// instructions a step always issues, per pipe.
#include "dc_step.cuh"
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
  out.p[0][e] = i;
  out.p[1][e] = reward;
  out.p[2][e] = terms;
  out.p[3][e] = r.rv;
  out.p[4][e] = r.rk;
  out.p[5][e] = r.rl;
  out.p[6][e] = r.rs;
}

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
int permex_rollout_random(const float* consts, const int* flags, const float* spec,
                          unsigned long long seed, int n, int n_steps, const float* const* in,
                          float* const* out, void* stream) {
  permex_rollout_random_kernel<<<spec_blocks(n), kSpecThreads, 0, (cudaStream_t)stream>>>(
      dc_load_const(consts, flags), px_consts(spec), spec_seed_key(seed), n, n_steps,
      spec_in(in, 1), spec_out(out, 7));
  return (int)cudaGetLastError();
}

// out: (i, ref, action (int32), reward, done), each (T, R, 128).
int permex_record_random(const float* consts, const int* flags, const float* spec,
                         unsigned long long seed, int n, int n_steps, const float* const* in,
                         float* const* out, void* stream) {
  permex_record_random_kernel<<<spec_blocks(n), kSpecThreads, 0, (cudaStream_t)stream>>>(
      dc_load_const(consts, flags), px_consts(spec), spec_seed_key(seed), n, n_steps,
      spec_in(in, 1), spec_out(out, 5));
  return (int)cudaGetLastError();
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
