// REINFORCE with the eligibility traces on chip (fused_policy.cu's
// reinforce_rollout): the step of the rollout with the backward pass in the
// loop, and the shape of the role split (fused_policy.cu's
// reinforce_split_kernel) that keeps every env's traces e and gradient sums
// G in registers from step 0 to the end of the launch, as the TPU kernel
// keeps them in VMEM scratch (pallas_policy.py:520-541, :757).
//
// Why.  One thread per env cannot hold e and G (2 P floats, P = 15 H + 8:
// 496 at H 16, 976 at H 32) in its registers, so the first port kept them
// as [P, n] tensors in global memory and read and wrote both at every step:
// 16 P bytes per env-step, 65 MB a step at H 16 and 16384 envs over a 32.5
// MB working set, which ran at 1.9 to 2.0 TB/s and 2.1% of the bound of the
// function's own FP32 work (PERF.md).
//
// Design (role split).  A block holds SW step warps and T trace warps per
// step warp (ReinforceShape).  Lane i of step warp s runs the step of
// block env 32 s + i, one thread per env, as the one-thread kernel does but
// for the score: observation, MLP forward, action, physics, reward, reset
// and the Wiener draw.  Per env-step it writes the W = H + 17 words the
// rest takes (obs 6, the 8 logits, the action, adv, geff, h H) into a
// shared-memory ring of two slots of K steps (ring_pipe.cuh's RingPipe and
// named barriers, its producers the step warps, its consumers the trace
// warps): word j of ring position p for block env i at ring[(p W + j) E +
// i], so a warp's 32 lanes touch 32 consecutive words.  Lane i of trace
// warp (w, s) takes env 32 s + i's score dlogit = onehot(a) - softmax
// (logits) and its backward pass dpre for the hidden units j = w + T m (m <
// H / T), and owns that env's e and G of those units' parameters (w1[f, j]
// for the 6 features, b1[j] and w2[j, a] for the 8 logits, 15 a unit) and
// of b2[a] for a = w + T m (m < 8 / T): e in registers (124 floats at H 16
// and T 2), G in shared memory after the ring, read and written once per
// parameter and step.  The score and the backward pass leave the step
// warps, whose dependent chain sets the time, for the trace warps.  G goes
// to acc[P, n] once, at the end; reinforce_reduce is unchanged.  At H 16 a
// block holds 128 envs (four step warps, the warpgroup that setmaxnreg
// lowers to 104 registers, and eight trace warps raised to 200), 195 KB of
// shared memory, one block an SM: 16384 envs run in one wave on 128 SMs.
// At H 8 and H 32 a block holds 32 envs, four and two blocks an SM.

// Bits.  Each quantity is the one-thread kernel's, from the same functions
// on the same operands in the same order, built with -fmad=false: the
// score, dpre = (1 - h^2) (w2[j, :] . dlogit), and per parameter g from the
// same product (obs[f] dpre[j], dpre[j], h[j] dlogit[a] or dlogit[a]),
// ev = e geff + g, e = ev, G = G + adv ev.  So every output equals the
// one-thread kernel's bit for bit.
#pragma once

#include "policy_step.cuh"
#include "ring_pipe.cuh"

// REINFORCE's step up to the update (pallas_policy.py:613-700), in the
// parent's order: reinforce_act (the observation, the forward pass and the
// action), reinforce_score (dlogit), reinforce_dpre for each hidden unit,
// reinforce_physics.  The reference advance follows the update
// (reinforce_wiener).

// The observation, the forward pass and the action: Gumbel-max over the 8
// logits (strict >, the first maximum wins) or argmax.
template <int H, bool kGreedy>
__device__ __forceinline__ int reinforce_act(const PmsmConst& k, const PolicyConst& q, uint2 key,
                                             uint32_t e, uint32_t t, const float* sw,
                                             const PmsmEnv& st, float (&obs)[6], float (&h)[H],
                                             float (&logit)[kActions]) {
  policy_obs6(k, q, st, obs);
  mlp_forward<6, H>(sw, obs, h, logit);
  compiler_barrier();  // w2 again for dh, not kept live from the forward pass
  if (kGreedy) return argmax8(logit);
  const uint4 ga = pmsm_draw(key, e, t, SLOT_GUMBEL_A);
  const uint4 gb = pmsm_draw(key, e, t, SLOT_GUMBEL_B);
  const uint32_t bits[kActions] = {ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, gb.z, gb.w};
  const float u_min = k.v[C_U_MIN];
  float best = 0.0f;
  int action = 0;
#pragma unroll
  for (int a = 0; a < kActions; ++a) {
    const float pert = logit[a] - logf(-logf(fmaxf(uniform24(bits[a]), u_min)));
    if (a == 0) {
      best = pert;
    } else if (pert > best) {
      best = pert;
      action = a;
    }
  }
  return action;
}

// The categorical score dlogit = onehot(a) - softmax(logits).
__device__ __forceinline__ void reinforce_score(const float (&logit)[kActions], int action,
                                                float (&dlogit)[kActions]) {
  float m = logit[0];
#pragma unroll
  for (int a = 1; a < kActions; ++a) m = fmaxf(m, logit[a]);
  float ex[kActions];
#pragma unroll
  for (int a = 0; a < kActions; ++a) ex[a] = expf(logit[a] - m);
  float z = ex[0];
#pragma unroll
  for (int a = 1; a < kActions; ++a) z = z + ex[a];
  const float inv_z = 1.0f / z;
#pragma unroll
  for (int a = 0; a < kActions; ++a) dlogit[a] = (action == a ? 1.0f : 0.0f) - ex[a] * inv_z;
}

// The score backpropagated to hidden unit j's pre-activation: dh =
// w2[j, :] . dlogit in the order of the logits, dpre = (1 - h^2) dh.
template <int H>
__device__ __forceinline__ float reinforce_dpre(const float* sw, int j, float h,
                                                const float (&dlogit)[kActions]) {
  const float* w2 = sw + MlpLayout<6, H>::W2 + j * kActions;
  float dh = w2[0] * dlogit[0];
#pragma unroll
  for (int a = 1; a < kActions; ++a) dh = dh + w2[a] * dlogit[a];
  return (1.0f - h * h) * dh;
}

// The physics at the exact angle (no incremental rotation), the reward,
// the constraint and the reset.
__device__ __forceinline__ PmsmStepOut reinforce_physics(const PmsmConst& k, int action,
                                                         PmsmEnv& st) {
  st.c = cosf(st.eps);
  st.s = sinf(st.eps);
  return pmsm_action_step(k, action, st);
}

// The Wiener advance of both references after step t, each with the cosine
// half of its own Box-Muller pair.
__device__ __forceinline__ void reinforce_wiener(const PmsmConst& k, uint2 key, uint32_t e,
                                                 uint32_t t, bool done, PmsmEnv& st) {
  const float u_min = k.v[C_U_MIN];
  const uint4 b = pmsm_draw(key, e, t, SLOT_BOX_MULLER);
  const float draw_d = sqrtf(-2.0f * logf(fmaxf(uniform24(b.x), u_min)))
                       * cosf(k.v[C_TWO_PI] * uniform24(b.z));
  const float draw_q = sqrtf(-2.0f * logf(fmaxf(uniform24(b.y), u_min)))
                       * cosf(k.v[C_TWO_PI] * uniform24(b.w));
  wiener_advance(k, key, e, t, draw_d, draw_q, done, st);
}

// Word offsets of a step on the ring: obs, the logits, the action, adv,
// geff, then h (H words).
enum ReinforceWord { RW_OBS = 0, RW_LOGIT = 6, RW_ACTION = 14, RW_ADV = 15, RW_GEFF = 16,
                     RW_H = 17 };

// The role split of each H: SW step warps a block (32 SW envs), T trace
// warps per step warp and B blocks an SM that the registers must allow
// (__launch_bounds__).  With SW 4 the step warps are warpgroup 0 of the
// block and the trace warps the rest, and setmaxnreg moves registers from
// the step warps to the trace warps (kStepRegs, kTraceRegs).
template <int H>
struct ReinforceShape;
template <>
struct ReinforceShape<8> {
  static constexpr int SW = 1, T = 4, B = 4;
};
template <>
struct ReinforceShape<16> {
  static constexpr int SW = 4, T = 2, B = 1;
};
template <>
struct ReinforceShape<32> {
  static constexpr int SW = 1, T = 8, B = 2;
};

// Steps a ring slot.
constexpr int kReinforceK = 2;

// setmaxnreg budgets of a block of four step warps: the step warps lower
// theirs to kStepRegs, the trace warps raise theirs to kTraceRegs, a
// multiple of 8 below (65536 - 128 kStepRegs) / (128 T).  Budgets that fill
// the register file exactly (96 and 208) hung the launch on an H100
// (PERF.md, slice 19).
constexpr int kStepRegs = 104;
constexpr int kTraceRegs = 200;

// The ring and the ownership of the role-split kernel at H (RingPipe's
// shape: K and kThreads).
template <int H>
struct ReinforceRing {
  static constexpr int kStepWarps = ReinforceShape<H>::SW;
  static constexpr int SW = kStepWarps;
  static constexpr int T = ReinforceShape<H>::T;
  static constexpr int K = kReinforceK;
  static constexpr int kMinBlocks = ReinforceShape<H>::B;
  static constexpr int kEnvs = 32 * SW;              // envs a block
  static constexpr int kThreads = kEnvs * (1 + T);
  static constexpr bool kSetMaxNReg = SW > 1;
  static constexpr int W = RW_H + H;                 // words a step
  static constexpr int kRingFloats = kRingSlots * K * W * kEnvs;
  static constexpr int P = MlpLayout<6, H>::N;
  static constexpr int kBytes = (kRingFloats + P * kEnvs) * 4;   // the ring, then G
  static constexpr int kUnits = H / T;               // hidden units a trace thread owns
  static constexpr int kB2 = kActions / T;           // entries of b2 it owns
  static constexpr int kOwn = kUnits * (6 + 1 + kActions) + kB2;
  static_assert(H % T == 0 && kActions % T == 0, "T divides H and the 8 logits");
  static_assert(SW == 1 || SW == 4, "one step warp, or a warpgroup of them");
  static_assert(!kSetMaxNReg
                    || (kEnvs * (kStepRegs + T * kTraceRegs) < 65536 && kMinBlocks == 1),
                "the budgets fit one block's registers with room to spare");
  static_assert((K & (K - 1)) == 0, "K is a power of two");
};

// Slot r of a trace thread's parameters: e = e geff + g in ev, then
// G = G + adv e at gsh[r E] in shared memory.
template <int E, int N>
__device__ __forceinline__ void trace_update(float (&ev)[N], float* gsh, int r, float geff,
                                             float adv, float g) {
  const float x = ev[r] * geff + g;
  ev[r] = x;
  gsh[r * E] = gsh[r * E] + adv * x;
}
