// What the specialised fused rollouts share (fused_permex.cu, fused_dc_sc.cu,
// fused_scim_tc.cu, fused_eesm_cc.cu, fused_dfim_cc.cu): the Philox draw
// slots, one Wiener reference row with its sub-episode parameters, the
// Box-Muller pair, the constant-increment rotation, the pointer tables of
// the plain C interface and the launch of one thread per env.  Their
// physics is the universal families' (dc_step.cuh, induction_step.cuh,
// eesm_step.cuh, dfim_step.cuh), except the DC SC kernel's, whose
// right-hand side rounds otherwise (fused_dc_sc.cu).
//
// Replaces the reference machinery the specialised builders of
// gym_electric_motor_tpu/ops/pallas_{dc,induction,eesm,dfim}.py write out in
// each kernel (their _draw_params, the Box-Muller pair and the clipped
// random-walk step, e.g. pallas_dc.py:125-131, :146-171), with the
// constants each builder bakes (sub-episode length floor(U[500, 2000)),
// log10 sigma range) arriving from the host as float32.  The plain PyTorch
// version of the same arithmetic, in the same order, is in
// gym_electric_motor_tpu_torch/ops/fused_common.py (spec_params,
// box_muller) and the four builder modules.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "philox.cuh"

// Draw slots: the Philox counter of one call is (env, step, slot, 0).  Each
// kernel names which words of a slot it reads (see its source); a slot whose
// words a step discards is not drawn (the parameter slot without a
// regeneration, the reset slot without a violation, the Box-Muller slot of
// SCIM at an odd step), which is safe because every call is independent.
enum SpecSlot {
  SPEC_SLOT_STEP = 0,    // the step's actions and Box-Muller words
  SPEC_SLOT_PARAMS = 1,  // sub-episode lengths and sigmas (and, with one row, its reset value)
  SPEC_SLOT_RESET = 2,   // the reset values of several rows
  SPEC_SLOT_INIT_0 = 3,  // at step 0: (value, length, sigma) of row 0
  SPEC_SLOT_INIT_1 = 4,  // of row 1
  SPEC_SLOT_EXTRA = 5,   // a step's further action and Box-Muller words
  SPEC_SLOT_INIT_2 = 6   // of row 2
};

__device__ __forceinline__ uint4 spec_draw(uint2 key, uint32_t env, uint32_t t, uint32_t slot) {
  return philox4x32_10(make_uint4(env, t, slot, 0u), key);
}

inline uint2 spec_seed_key(unsigned long long seed) {
  return make_uint2((uint32_t)(seed & 0xFFFFFFFFull), (uint32_t)(seed >> 32));
}

// One reference row: value, steps since regeneration, sub-episode length,
// sigma.
struct SpecRow {
  float rv, rk, rl, rs;
};

// The row constants a builder bakes: sub-episode length floor(ep_lo +
// ep_span U), sigma 10^(sig_base + sig_span U).
struct SpecParams {
  float ep_lo, ep_span, sig_base, sig_span, ln10;
};

__device__ __forceinline__ void spec_params(const SpecParams& p, uint32_t b_len, uint32_t b_sig,
                                            float& rl, float& rs) {
  rl = floorf(p.ep_lo + p.ep_span * uniform24(b_len));
  rs = expf(p.ln10 * (p.sig_base + p.sig_span * uniform24(b_sig)));
}

// r cos(theta) and r sin(theta) of two words, r = sqrt(-2 log max(u1,
// u_min)), theta = 2 pi u2.
__device__ __forceinline__ void spec_box_muller(float u_min, float two_pi, uint32_t b1,
                                                uint32_t b2, float& zc, float& zs) {
  const float rad = sqrtf(-2.0f * logf(fmaxf(uniform24(b1), u_min)));
  const float theta = two_pi * uniform24(b2);
  zc = rad * cosf(theta);
  zs = rad * sinf(theta);
}

// The row's advance after a step: regeneration (new length and sigma, the
// counter back to 0) where the sub-episode ended or the env reset, then the
// clipped random-walk step with the row's draw.  The reset value of a
// violating env is the caller's.
__device__ __forceinline__ void spec_row_walk(SpecRow& r, bool regen, float new_rl, float new_rs,
                                              float draw, float lo, float hi) {
  if (regen) {
    r.rl = new_rl;
    r.rs = new_rs;
  }
  r.rk = (regen ? 0.0f : r.rk) + 1.0f;
  r.rv = fminf(fmaxf(r.rv + r.rs * draw, lo), hi);
}

// The Park rotation (c, s) turned by the constant increment (cos_d, sin_d)
// of one step and renormalised with rsqrtf, the instruction PyTorch's CUDA
// rsqrt issues (pallas_eesm.py:185-187, pallas_dfim.py:185-187); (1, 0)
// where the env reset.
__device__ __forceinline__ void spec_rotate(float cos_d, float sin_d, bool reset, float& c,
                                            float& s) {
  const float c_new = c * cos_d - s * sin_d;
  const float s_new = s * cos_d + c * sin_d;
  const float inv = rsqrtf(c_new * c_new + s_new * s_new);
  c = reset ? 1.0f : c_new * inv;
  s = reset ? 0.0f : s_new * inv;
}

// The state planes a kernel reads and the planes it writes, flat arrays of
// n envs (a (T, R, 128) plane is T * n floats, a (k R, 128) one k * n).
constexpr int kSpecMaxIn = 8;
constexpr int kSpecMaxOut = 16;
constexpr int kSpecThreads = 128;

struct SpecIn {
  const float* p[kSpecMaxIn];
};

struct SpecOut {
  float* p[kSpecMaxOut];
};

inline SpecIn spec_in(const float* const* in, int n_in) {
  SpecIn s;
  for (int i = 0; i < kSpecMaxIn; ++i) s.p[i] = i < n_in ? in[i] : nullptr;
  return s;
}

inline SpecOut spec_out(float* const* out, int n_out) {
  SpecOut s;
  for (int i = 0; i < kSpecMaxOut; ++i) s.p[i] = i < n_out ? out[i] : nullptr;
  return s;
}

inline int spec_blocks(int n) { return (n + kSpecThreads - 1) / kSpecThreads; }

// The size queries and error string of a library's C interface: the
// kernel's own constants (N_SPEC) and, where its step is a family's, the
// family's constant, reference-row and flag counts.
#define SPEC_C_INFO(PREFIX, N_SPEC)                                 \
  int PREFIX##_n_spec() { return N_SPEC; }                          \
  const char* PREFIX##_error_string(int err) {                      \
    return cudaGetErrorString((cudaError_t)err);                    \
  }
#define SPEC_FAMILY_C_INFO(PREFIX, N_CONST, N_ROW, N_FLAG, N_SPEC)  \
  int PREFIX##_n_const() { return N_CONST; }                        \
  int PREFIX##_n_row_const() { return N_ROW; }                      \
  int PREFIX##_n_flag() { return N_FLAG; }                          \
  SPEC_C_INFO(PREFIX, N_SPEC)
