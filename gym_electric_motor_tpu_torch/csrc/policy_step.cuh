// The policy side of the policy-in-the-loop kernels of fused_policy.cu: the
// 2-layer tanh MLP (F features, H hidden units, 8 logits), the categorical
// samplers and the hand-written score backward of REINFORCE.  The PMSM
// step they drive is pmsm_step.cuh's.
//
// Replaces the in-kernel actor of gym_electric_motor_tpu/ops/pallas_policy.py
// (:164-209, :374-407 and :616-682).  The plain PyTorch version of the same
// arithmetic, in the same order, is gym_electric_motor_tpu_torch/ops/fused_policy.py.
#pragma once

#include "pmsm_step.cuh"

// The constants the policy kernels add to PmsmConst (the rest of
// _policy_pmsm_ctx, pallas_policy.py:80-81), as float32 from the host.
enum PolicyConstIndex {
  Q_OMEGA_N = 0,  // omega_fixed / omega limit: the constant speed feature
  Q_INV_EPS_LIM,  // 1 / epsilon limit (pi)
  Q_PI,           // upper end of the (-pi, pi] angle wrap of the feature
  N_POLICY_CONST
};

struct PolicyConst {
  float v[N_POLICY_CONST];
};

// REINFORCE's own draw slots, beside PmsmSlot: 8 Gumbel uniforms and the
// two Box-Muller pairs of its reference advance (one per reference, cosine
// branch only).  Its parameter and reset draws use SLOT_PARAMS and
// SLOT_RESET.
enum ReinforceSlot {
  SLOT_GUMBEL_A = 5,    // (gumbel 0, 1, 2, 3)
  SLOT_GUMBEL_B = 6,    // (gumbel 4, 5, 6, 7)
  SLOT_BOX_MULLER = 7   // (u1 d, u1 q, u2 d, u2 q)
};

constexpr int kActions = 8;

// The weights as one block of floats: [w1 (F*H, w1[f*H + j]) | b1 (H) |
// w2 (H*8, w2[j*8 + a]) | b2 (8)], the packing of flatten_policy_params.
template <int F, int H>
struct MlpLayout {
  static constexpr int W1 = 0;
  static constexpr int B1 = F * H;
  static constexpr int W2 = B1 + H;
  static constexpr int B2 = W2 + H * kActions;
  static constexpr int N = B2 + kActions;
};

// Copy the weights into the block's shared memory once per launch; every
// thread of the block then reads them at the same address (a broadcast).
template <int F, int H>
__device__ __forceinline__ void stage_weights(float* sw, const float* __restrict__ w1,
                                              const float* __restrict__ b1,
                                              const float* __restrict__ w2,
                                              const float* __restrict__ b2) {
  using L = MlpLayout<F, H>;
  for (int i = threadIdx.x; i < L::N; i += blockDim.x) {
    float v;
    if (i < L::B1) {
      v = w1[i];
    } else if (i < L::W2) {
      v = b1[i - L::B1];
    } else if (i < L::B2) {
      v = w2[i - L::W2];
    } else {
      v = b2[i - L::B2];
    }
    sw[i] = v;
  }
  __syncthreads();
}

// A compiler-only memory barrier; it emits no instruction.  No memory
// access moves across it, and shared memory read after it is read again.
// At the top of each step it keeps the compiler from hoisting the 128 to
// 520 loop-invariant weights into registers across the T loop (without
// it ptxas spilled up to 1.4 kB per thread at H = 32).
__device__ __forceinline__ void compiler_barrier() { asm volatile("" ::: "memory"); }

// x, which the compiler may not assume unchanged: what a loop derives from
// it is not loop-invariant.  REINFORCE takes its trace addresses from it
// each step; otherwise the compiler hoists the 2 P addresses out of the T
// loop and spills them (12 P bytes of stack per thread, one local load per
// trace access).
__device__ __forceinline__ unsigned long long opaque64(unsigned long long x) {
  asm volatile("" : "+l"(x));
  return x;
}

// h = tanh(b1 + obs @ w1), logits = b2 + h @ w2, each sum taken in the
// order of the index (the plain version's loop order).
template <int F, int H>
__device__ __forceinline__ void mlp_forward(const float* sw, const float (&obs)[F], float (&h)[H],
                                            float (&logit)[kActions]) {
  using L = MlpLayout<F, H>;
#pragma unroll
  for (int j = 0; j < H; ++j) {
    float acc = sw[L::B1 + j];
#pragma unroll
    for (int f = 0; f < F; ++f) acc = acc + sw[L::W1 + f * H + j] * obs[f];
    h[j] = tanhf(acc);
  }
#pragma unroll
  for (int a = 0; a < kActions; ++a) {
    float acc = sw[L::B2 + a];
#pragma unroll
    for (int j = 0; j < H; ++j) acc = acc + sw[L::W2 + j * kActions + a] * h[j];
    logit[a] = acc;
  }
}

// Layer 1's weights held in registers across a rollout's step loop: b1 and
// the first NROW rows of w1 (NROW 0: none, every weight read from shared
// memory).  kMlpHeldFloats bounds what a consumer thread holds.
constexpr int kMlpHeldFloats = 112;

template <int F, int H>
__host__ __device__ constexpr int mlp_held_rows() {
  return (kMlpHeldFloats - H) / H < F ? (kMlpHeldFloats - H) / H : F;
}

template <int H, int NROW>
struct MlpHeld {
  float b1[NROW > 0 ? H : 1];
  float w1[NROW > 0 ? NROW : 1][H];
};

template <int F, int H, int NROW>
__device__ __forceinline__ MlpHeld<H, NROW> mlp_hold(const float* sw) {
  using L = MlpLayout<F, H>;
  MlpHeld<H, NROW> w = {};
  if constexpr (NROW > 0) {
#pragma unroll
    for (int j = 0; j < H; ++j) w.b1[j] = sw[L::B1 + j];
#pragma unroll
    for (int f = 0; f < NROW; ++f) {
#pragma unroll
      for (int j = 0; j < H; ++j) w.w1[f][j] = sw[L::W1 + f * H + j];
    }
  }
  return w;
}

// mlp_forward with the weights read from shared memory as 16-byte vectors
// (LDS.128: every offset of MlpLayout is a multiple of 4 floats for H a
// multiple of 4, and sw is 16-byte aligned), and with NROW > 0 b1 and the
// first NROW rows of w1 taken from registers (mlp_hold).  The loops run f
// outer and j inner over H accumulators in layer 1, j outer and a inner
// over 8 in layer 2, so that every accumulator still sums its operands in
// the order of the index, as mlp_forward does: the same bits.
template <int F, int H, int NROW>
__device__ __forceinline__ void mlp_forward_vec(const float* sw, const MlpHeld<H, NROW>& held,
                                                const float (&obs)[F], float (&h)[H],
                                                float (&logit)[kActions]) {
  using L = MlpLayout<F, H>;
  static_assert(H % 4 == 0 && L::B1 % 4 == 0 && L::W2 % 4 == 0 && L::B2 % 4 == 0,
                "the layout's offsets are whole 16-byte vectors");
  const float4* v = reinterpret_cast<const float4*>(sw);
  float acc[H];
#pragma unroll
  for (int j4 = 0; j4 < H / 4; ++j4) {
    if constexpr (NROW > 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[4 * j4 + i] = held.b1[4 * j4 + i];
    } else {
      const float4 b = v[L::B1 / 4 + j4];
      acc[4 * j4] = b.x;
      acc[4 * j4 + 1] = b.y;
      acc[4 * j4 + 2] = b.z;
      acc[4 * j4 + 3] = b.w;
    }
  }
#pragma unroll
  for (int f = 0; f < F; ++f) {
#pragma unroll
    for (int j4 = 0; j4 < H / 4; ++j4) {
      const int fh = f < NROW ? f : 0;
      const float4 x = f < NROW ? make_float4(held.w1[fh][4 * j4], held.w1[fh][4 * j4 + 1],
                                              held.w1[fh][4 * j4 + 2], held.w1[fh][4 * j4 + 3])
                                : v[(L::W1 + f * H) / 4 + j4];
      const float w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[4 * j4 + i] = acc[4 * j4 + i] + w[i] * obs[f];
    }
  }
#pragma unroll
  for (int j = 0; j < H; ++j) h[j] = tanhf(acc[j]);
  {
    const float4 b0 = v[L::B2 / 4], b1 = v[L::B2 / 4 + 1];
    logit[0] = b0.x;
    logit[1] = b0.y;
    logit[2] = b0.z;
    logit[3] = b0.w;
    logit[4] = b1.x;
    logit[5] = b1.y;
    logit[6] = b1.z;
    logit[7] = b1.w;
  }
#pragma unroll
  for (int j = 0; j < H; ++j) {
    const float4 x0 = v[(L::W2 + j * kActions) / 4], x1 = v[(L::W2 + j * kActions) / 4 + 1];
    const float w[kActions] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
    for (int a = 0; a < kActions; ++a) logit[a] = logit[a] + w[a] * h[j];
  }
}

// First maximum wins (strict >).
__device__ __forceinline__ int argmax8(const float (&logit)[kActions]) {
  float best = logit[0];
  int action = 0;
#pragma unroll
  for (int a = 1; a < kActions; ++a) {
    if (logit[a] > best) {
      best = logit[a];
      action = a;
    }
  }
  return action;
}

// Inverse-CDF categorical sample over the softmax: 8 exps and one uniform;
// the action is the last a with u * total >= cumsum(exp)[a - 1]
// (pallas_policy.py:197-209).
__device__ __forceinline__ int sample_inverse_cdf(const float (&logit)[kActions], float u) {
  float m = logit[0];
#pragma unroll
  for (int a = 1; a < kActions; ++a) m = fmaxf(m, logit[a]);
  float es[kActions];
#pragma unroll
  for (int a = 0; a < kActions; ++a) es[a] = expf(logit[a] - m);
  float total = es[0];
#pragma unroll
  for (int a = 1; a < kActions; ++a) total = total + es[a];
  const float uu = u * total;
  float cum = es[0];
  int action = 0;
#pragma unroll
  for (int a = 1; a < kActions; ++a) {
    if (uu >= cum) action = a;
    cum = cum + es[a];
  }
  return action;
}

// The 6-feature observation of the reducing rollout and REINFORCE: the
// angle wrapped to (-pi, pi] and scaled by 1 / pi (pallas_policy.py:166-171).
__device__ __forceinline__ void policy_obs6(const PmsmConst& k, const PolicyConst& q,
                                            const PmsmEnv& st, float (&obs)[6]) {
  float eps_w = st.eps - k.v[C_TWO_PI] * floorf(st.eps * k.v[C_INV_TWO_PI]);
  eps_w = eps_w > q.v[Q_PI] ? eps_w - k.v[C_TWO_PI] : eps_w;
  obs[0] = q.v[Q_OMEGA_N];
  obs[1] = st.i_sd * k.v[C_INV_I_LIM];
  obs[2] = st.i_sq * k.v[C_INV_I_LIM];
  obs[3] = eps_w * q.v[Q_INV_EPS_LIM];
  obs[4] = st.rv_d;
  obs[5] = st.rv_q;
}
