// The lane-group form of the PPO collection engine (policy_record of
// fused_policy.cu): G lanes of one warp serve one env.  Lane l of a group
// computes the hidden units j = l, l + G, ... and the logits a = l, l + G,
// ...; a logit gathers each hidden value from the lane that holds it by
// __shfl_sync and sums them in index order, so every hidden value and
// logit is the bit the one-thread mlp_forward (policy_step.cuh) computes.
// The 8 logits then reach every lane of the group, and each lane runs the
// sampler and the PMSM step on the same operands (or, kLead, lane 0 runs
// them and passes the results on).  Lane p % G stores the recorded plane p.
//
// The plain PyTorch version of the same arithmetic, in the same order, is
// gym_electric_motor_tpu_torch/ops/fused_policy.py (policy_record_plain).
#pragma once

#include "policy_step.cuh"

// The recorded planes of one step, in the order of policy_record's outputs:
// i_sd, i_sq, eps, ref_d, ref_q, action (int32), reward, done.
constexpr int kRecordPlanes = 8;

struct RecordPlanes {
  uint32_t* p[kRecordPlanes];
};

// Every lane of a warp takes part in every shuffle (no group leaves the
// step loop early), so each shuffle names the whole warp: with a group's
// mask nvcc wraps each one in a convergence barrier (WARPSYNC.COLLECTIVE)
// and moves it out of line.
constexpr unsigned kWarpMask = 0xffffffffu;

// The MLP of mlp_forward<7, H> on a group of G lanes (l = this lane's
// place in it): every lane of the group returns all 8 logits.
template <int H, int G>
__device__ __forceinline__ void mlp_forward_lanes(const float* sw, const float (&obs)[7], int l,
                                                  float (&logit)[kActions]) {
  static_assert(32 % G == 0, "a lane group divides the warp");
  static_assert(H % G == 0, "the hidden units spread evenly over the lanes");
  static_assert(kActions % G == 0, "the logits spread evenly over the lanes");
  using L = MlpLayout<7, H>;
  constexpr int HL = H / G;                          // hidden units of a lane
  constexpr int AL = kActions / G;                   // logits of a lane
  float h[HL];
#pragma unroll
  for (int m = 0; m < HL; ++m) {
    const int j = l + G * m;
    float acc = sw[L::B1 + j];
#pragma unroll
    for (int f = 0; f < 7; ++f) acc = acc + sw[L::W1 + f * H + j] * obs[f];
    h[m] = tanhf(acc);
  }
  float acc[AL];
#pragma unroll
  for (int i = 0; i < AL; ++i) acc[i] = sw[L::B2 + l + G * i];
#pragma unroll
  for (int j = 0; j < H; ++j) {
    const float hj = __shfl_sync(kWarpMask, h[j / G], j % G, G);
#pragma unroll
    for (int i = 0; i < AL; ++i) {
      acc[i] = acc[i] + sw[L::W2 + j * kActions + l + G * i] * hj;
    }
  }
#pragma unroll
  for (int a = 0; a < kActions; ++a) logit[a] = __shfl_sync(kWarpMask, acc[a / G], a % G, G);
}

// The value of recorded plane p (0..7) among a step's eight, by selects,
// so that a lane's plane index stays a register and the values never go
// through local memory.
__device__ __forceinline__ uint32_t record_value(int p, const uint32_t (&v)[kRecordPlanes]) {
  uint32_t x = v[0];
#pragma unroll
  for (int q = 1; q < kRecordPlanes; ++q) x = p == q ? v[q] : x;
  return x;
}

// Recorded plane p's pointer, by selects (a lane-dependent index into the
// kernel's parameters would copy them to the stack).
__device__ __forceinline__ uint32_t* record_plane(int p, const RecordPlanes& out) {
  uint32_t* x = out.p[0];
#pragma unroll
  for (int q = 1; q < kRecordPlanes; ++q) x = p == q ? out.p[q] : x;
  return x;
}

// Lane 0's step results to the whole group (kLead): the state the next
// observation reads and the values the lanes store.
__device__ __forceinline__ void share_lead(int G, PmsmEnv& st, PmsmStepOut& o) {
  st.i_sd = __shfl_sync(kWarpMask, st.i_sd, 0, G);
  st.i_sq = __shfl_sync(kWarpMask, st.i_sq, 0, G);
  st.eps = __shfl_sync(kWarpMask, st.eps, 0, G);
  st.c = __shfl_sync(kWarpMask, st.c, 0, G);
  st.s = __shfl_sync(kWarpMask, st.s, 0, G);
  st.rv_d = __shfl_sync(kWarpMask, st.rv_d, 0, G);
  st.rv_q = __shfl_sync(kWarpMask, st.rv_q, 0, G);
  o.ref_d = __shfl_sync(kWarpMask, o.ref_d, 0, G);
  o.ref_q = __shfl_sync(kWarpMask, o.ref_q, 0, G);
  o.action = __shfl_sync(kWarpMask, o.action, 0, G);
  o.reward = __shfl_sync(kWarpMask, o.reward, 0, G);
  o.done = __shfl_sync(kWarpMask, o.done, 0, G);
}
