// The policy side of the universal policy-in-the-loop recorders
// (fused_<family>_policy.cu, one per family): the staged weights, the
// 2-layer tanh MLP, the categorical heads (factorised or one joint head
// decoded by radix) and the squashed-Gaussian duty channels, with the
// policy's own draw slots, the recorders' output planes, and the launcher
// and C interface the six recorders share.  The family
// step each recorder drives is its *_step.cuh's *_action_step, the very
// device function of its random and buffer kernels.
//
// Replaces the actor block of make_fused_policy_record_universal in
// gym_electric_motor_tpu/ops/pallas_policy.py (:1092-1187).  The plain
// PyTorch version of the same arithmetic, in the same order, is
// gym_electric_motor_tpu_torch/ops/fused_policy.py (mlp_forward,
// sample_heads, gaussian_raw, policy_record_universal_plain).
//
// Sizes.  F (features) and the logit count's bound AMAX are template
// constants of an instance; the hidden width H is a runtime count (1 to 32),
// so one instance serves every H: the hidden loop is a `#pragma unroll 1`
// loop that accumulates each logit as its hidden unit completes, so that
// only the F features and the AMAX logits stay live beside the family's
// step (no h[H] array).  Each logit still sums b2[a] + w2[0,a] h0 + w2[1,a]
// h1 + ... in index order, as the plain version does, so with -fmad=false
// the two round alike.
#pragma once

#include <cuda_runtime.h>

#include "common_step.cuh"

// The policy's draw slots beside DriveSlot: the categorical heads' uniforms
// (one per head, or one for a joint head) and the Box-Muller pairs of the
// Gaussian channels (words 2p and 2p + 1 for pair p; the DFIM's third pair
// takes POLICY_B).  The reference advance keeps DRIVE_SLOT_STEP's pair.
enum PolicySlot {
  DRIVE_SLOT_POLICY_A = 11,  // (uniform 0, 1, 2, 3)
  DRIVE_SLOT_POLICY_B = 12   // (uniform 4, 5, -, -)
};

constexpr int kPolicyMaxHidden = 32;
constexpr int kPolicyFeatConst = 8;   // constants of the non-angle features
constexpr int kPolicyMaxChannels = 6;
constexpr int kPolicyMaxHeads = 3;
constexpr int kPolicyMaxRows = 3;

// The host's policy constants: pk (UniversalPolicy.pk) holds feat[i], the
// i-th non-angle feature's constant (the constant speed feature, or a state
// plane's scale), then the duty channels' range mid points and half widths;
// pi (UniversalPolicy.pi) the head count, the heads' cardinalities and the
// joint flag, which the launchers read; h and a are the launch's hidden
// units and logits.
struct PolicyConst {
  float feat[kPolicyFeatConst];
  float mid[kPolicyMaxChannels], half[kPolicyMaxChannels];
  int ns[kPolicyMaxHeads];
  int h, a;
};

inline PolicyConst policy_load_const(const float* pk, const int* pi, int hidden, int n_out) {
  PolicyConst q;
  for (int i = 0; i < kPolicyFeatConst; ++i) q.feat[i] = pk[i];
  for (int i = 0; i < kPolicyMaxChannels; ++i) {
    q.mid[i] = pk[kPolicyFeatConst + i];
    q.half[i] = pk[kPolicyFeatConst + kPolicyMaxChannels + i];
  }
  for (int i = 0; i < kPolicyMaxHeads; ++i) q.ns[i] = pi[1 + i];
  q.h = hidden;
  q.a = n_out;
  return q;
}

inline uint2 policy_seed_key(unsigned long long seed) {
  return make_uint2((uint32_t)(seed & 0xFFFFFFFFull), (uint32_t)(seed >> 32));
}

// The recorded planes after the family's state planes, each (T, N): the
// references (NULL past n_ref), the heads' int32 actions (finite) or the
// channels' float32 raw samples (continuous), NULL past their count, the
// reward and the done flag.  `out` is the wrapper's pointer array, whose
// first n_state_slots entries are the family's state planes.
struct PolicyOut {
  float* ref[kPolicyMaxRows];
  int* act_i[kPolicyMaxHeads];
  float* act_f[kPolicyMaxChannels];
  float *reward, *done;
};

inline PolicyOut policy_out(void* const* out, int n_state_slots) {
  PolicyOut o;
  int j = n_state_slots;
  for (int r = 0; r < kPolicyMaxRows; ++r) o.ref[r] = (float*)out[j++];
  for (int h = 0; h < kPolicyMaxHeads; ++h) o.act_i[h] = (int*)out[j++];
  for (int c = 0; c < kPolicyMaxChannels; ++c) o.act_f[c] = (float*)out[j++];
  o.reward = (float*)out[j++];
  o.done = (float*)out[j];
  return o;
}

// The flat weights and log-stds (ls NULL for a finite env), by value so
// that a kernel takes them as one parameter.
struct PolicyWeights {
  const float *w1, *b1, *w2, *b2, *ls;
};

// NS state planes (NULL where a plane is absent), by value, for the
// families whose step header has no plane structs of its own (sync, DC).
template <int NS>
struct PolicyInPlanes {
  const float* p[NS];
};

template <int NS>
struct PolicyOutPlanes {
  float* p[NS];
};

// The weights the block stages in shared memory: [w1 (F*H, w1[f*H + j]) |
// b1 (H) | w2 (H*A, w2[j*A + a]) | b2 (A) | exp(ls) (NC)].
inline size_t policy_smem_bytes(int f, int h, int a, int nc) {
  return sizeof(float) * ((size_t)f * h + h + (size_t)h * a + a + nc);
}

// Copy the weights into the block's shared memory once per launch, the
// channels' standard deviations as exp(ls); every thread then reads them at
// one address at a time (a broadcast).  Called by every thread of the block
// before any returns.
__device__ __forceinline__ void policy_stage(float* sw, int f, int h, int a, int nc,
                                             const PolicyWeights& w) {
  const int n1 = f * h, n2 = n1 + h, n3 = n2 + h * a, n4 = n3 + a, n5 = n4 + nc;
  for (int i = threadIdx.x; i < n5; i += blockDim.x) {
    float v;
    if (i < n1) {
      v = w.w1[i];
    } else if (i < n2) {
      v = w.b1[i - n1];
    } else if (i < n3) {
      v = w.w2[i - n2];
    } else if (i < n4) {
      v = w.b2[i - n3];
    } else {
      v = expf(w.ls[i - n4]);
    }
    sw[i] = v;
  }
  __syncthreads();
}

// A compiler-only memory barrier; it emits no instruction.  At the top of
// each step it keeps the compiler from hoisting loop-invariant weights into
// registers across the T loop (as policy_step.cuh's).
__device__ __forceinline__ void policy_barrier() { asm volatile("" ::: "memory"); }

// logit[a] = b2[a] + sum_j w2[j*A + a] tanh(b1[j] + sum_f w1[f*H + j]
// obs[f]), every sum in index order, for the A <= AMAX logits (A a runtime
// count only for a DC converter's single head, where it is 2, 3 or 4).
template <int F, int AMAX>
__device__ __forceinline__ void policy_mlp(const float* sw, const float (&obs)[F], int H, int A,
                                           float (&logit)[AMAX]) {
  const float* w1 = sw;
  const float* b1 = w1 + F * H;
  const float* w2 = b1 + H;
  const float* b2 = w2 + H * A;
#pragma unroll
  for (int a = 0; a < AMAX; ++a) logit[a] = a < A ? b2[a] : 0.0f;
#pragma unroll 1
  for (int j = 0; j < H; ++j) {
    float acc = b1[j];
#pragma unroll
    for (int f = 0; f < F; ++f) acc = acc + w1[f * H + j] * obs[f];
    const float hj = tanhf(acc);
    const float* w2j = w2 + j * A;
#pragma unroll
    for (int a = 0; a < AMAX; ++a) {
      if (a < A) logit[a] = logit[a] + w2j[a] * hj;
    }
  }
}

// The step's policy uniforms, n of them (1 to 6), from the POLICY slots.
struct PolicyDraw {
  float u[kPolicyMaxChannels];
};

template <int NW>
__device__ __forceinline__ PolicyDraw policy_draw(uint2 key, uint32_t env, uint32_t t) {
  PolicyDraw d;
  const uint4 a = drive_draw(key, env, t, DRIVE_SLOT_POLICY_A);
  d.u[0] = uniform24(a.x);
  d.u[1] = uniform24(a.y);
  d.u[2] = uniform24(a.z);
  d.u[3] = uniform24(a.w);
  d.u[4] = d.u[5] = 0.0f;
  if (NW > 4) {
    const uint4 b = drive_draw(key, env, t, DRIVE_SLOT_POLICY_B);
    d.u[4] = uniform24(b.x);
    d.u[5] = uniform24(b.y);
  }
  return d;
}

// Inverse-CDF categorical sample over the softmax of the n <= NMAX logits
// starting at logit[OFF] (pallas_policy.py:1154-1175): the last a with
// u * total >= cumsum(exp)[a - 1].
template <int OFF, int NMAX, int AMAX>
__device__ __forceinline__ int policy_sample(const float (&logit)[AMAX], int n, float u) {
  float m = logit[OFF];
#pragma unroll
  for (int a = 1; a < NMAX; ++a) {
    if (a < n) m = fmaxf(m, logit[OFF + a]);
  }
  float es[NMAX];
#pragma unroll
  for (int a = 0; a < NMAX; ++a) es[a] = a < n ? expf(logit[OFF + a] - m) : 0.0f;
  float total = es[0];
#pragma unroll
  for (int a = 1; a < NMAX; ++a) {
    if (a < n) total = total + es[a];
  }
  const float uu = u * total;
  float cum = es[0];
  int action = 0;
#pragma unroll
  for (int a = 1; a < NMAX; ++a) {
    if (a < n) {
      if (uu >= cum) action = a;
      cum = cum + es[a];
    }
  }
  return action;
}

// The finite actions of NH heads of cardinalities N0, N1, N2 (compile-time;
// a DC single head passes its runtime count n0 <= N0): one draw per head
// over its slice of the logits or, JOINT, one draw over the N0 N1 N2 joint
// logits decoded by radix, the last head fastest (pallas_policy.py:
// 1176-1187).
template <int NH, int N0, int N1, int N2, bool JOINT, int AMAX>
__device__ __forceinline__ void policy_heads(const float (&logit)[AMAX], int n0,
                                             const PolicyDraw& d, int (&act)[kPolicyMaxHeads]) {
  if constexpr (JOINT) {
    constexpr int kJoint = N0 * (NH > 1 ? N1 : 1) * (NH > 2 ? N2 : 1);
    int j = policy_sample<0, kJoint, AMAX>(logit, kJoint, d.u[0]);
    if constexpr (NH > 2) {
      act[2] = j % N2;
      j = j / N2;
    }
    act[1] = j % N1;
    act[0] = j / N1;
  } else {
    act[0] = policy_sample<0, N0, AMAX>(logit, n0, d.u[0]);
    if constexpr (NH > 1) act[1] = policy_sample<N0, N1, AMAX>(logit, N1, d.u[1]);
    if constexpr (NH > 2) act[2] = policy_sample<N0 + N1, N2, AMAX>(logit, N2, d.u[2]);
  }
}

// The NC squashed-Gaussian channels (pallas_policy.py:1133-1153): raw =
// mu + exp(ls) z with a Box-Muller pair per two channels (cosine, then
// sine), duty = mid + half tanh(raw).  std is exp(ls), staged.
template <int NC, int AMAX>
__device__ __forceinline__ void policy_gaussian(const float (&mu)[AMAX], const float* std,
                                                const PolicyConst& q, const PolicyDraw& d,
                                                float two_pi, float u_min, float (&raw)[NC],
                                                float (&duty)[NC]) {
#pragma unroll
  for (int c = 0; c < NC; c += 2) {
    const float rad = sqrtf(-2.0f * logf(fmaxf(d.u[c], u_min)));
    const float th = two_pi * d.u[c + 1];
    raw[c] = mu[c] + std[c] * (rad * cosf(th));
    if (c + 1 < NC) raw[c + 1] = mu[c + 1] + std[c + 1] * (rad * sinf(th));
  }
#pragma unroll
  for (int c = 0; c < NC; ++c) duty[c] = q.mid[c] + q.half[c] * tanhf(raw[c]);
}

// Store a step's references, reward and done at index i.
template <int NREF>
__device__ __forceinline__ void policy_store_common(const PolicyOut& o, size_t i,
                                                    const float* ref, float reward, float done) {
#pragma unroll
  for (int r = 0; r < NREF; ++r) o.ref[r][i] = ref[r];
  o.reward[i] = reward;
  o.done[i] = done;
}

// Store a step's actions: the heads' (finite) or the channels' raw samples.
template <bool FINITE, int NH, int NC>
__device__ __forceinline__ void policy_store_actions(const PolicyOut& o, size_t i,
                                                     const int (&act)[kPolicyMaxHeads],
                                                     const float (&raw)[NC]) {
  if constexpr (FINITE) {
#pragma unroll
    for (int h = 0; h < NH; ++h) o.act_i[h][i] = act[h];
  } else {
#pragma unroll
    for (int c = 0; c < NC; ++c) o.act_f[c][i] = raw[c];
  }
}

// ---- The launch and the C interface every fused_<family>_policy.cu shares.

constexpr int kPolicyThreads = 128;

// Launch a policy kernel, `lanes` threads per env (one, or a lane group of
// policy_heads_lanes.cuh), with the staged weights' bytes of shared memory
// (f features, nc log-stds); In and Out are plane structs of a `p` pointer
// array, filled from in and out.
template <typename Const, typename In, typename Out>
void policy_launch(void (*kernel)(Const, PolicyConst, uint2, int, int, PolicyWeights, In, Out,
                                  PolicyOut),
                   int f, int nc, const Const& k, const PolicyConst& q, uint2 key, int n,
                   int n_steps, const PolicyWeights& w, const float* const* in,
                   void* const* out, const PolicyOut& o, cudaStream_t st, int lanes = 1) {
  In pin;
  Out pout;
  constexpr int kIn = sizeof(pin.p) / sizeof(pin.p[0]), kOut = sizeof(pout.p) / sizeof(pout.p[0]);
  for (int j = 0; j < kIn; ++j) pin.p[j] = in[j];
  for (int j = 0; j < kOut; ++j) pout.p[j] = (float*)out[j];
  const long long threads = (long long)n * lanes;
  kernel<<<(int)((threads + kPolicyThreads - 1) / kPolicyThreads), kPolicyThreads,
           policy_smem_bytes(f, q.h, q.a, nc), st>>>(k, q, key, n, n_steps, w, pin, pout, o);
}

// A policy library's size queries and error string, for ctypes.
#define POLICY_C_INFO(PREFIX, N_CONST, N_FLAG)                                      \
  int PREFIX##_policy_n_const() { return N_CONST; }                                 \
  int PREFIX##_policy_n_row_const() { return N_ROW_CONST; }                         \
  int PREFIX##_policy_n_flag() { return N_FLAG; }                                   \
  const char* PREFIX##_policy_error_string(int err) {                               \
    return cudaGetErrorString((cudaError_t)err);                                    \
  }
