// The lane-group form of the universal policy recorders' MLP
// (policy_heads.cuh's policy_mlp): G lanes of one warp serve one env.  Lane
// l of a group computes the hidden units j = l, l + G, ... and the logits
// a = l, l + G, ...; a logit gathers each hidden value from the lane that
// holds it by __shfl_sync and sums them in index order, so every hidden
// value and logit is the bit the one-thread policy_mlp computes (built with
// -fmad=false).  H stays a run-time count (1 to kPolicyMaxHidden): a lane
// holds ceil(kPolicyMaxHidden / G) hidden slots, unrolled and predicated on
// j < H, and the gather runs over all kPolicyMaxHidden units, adding those
// below H.  As policy_lanes.cuh does for the PMSM recorder, every lane of a
// warp takes part in every shuffle (a group past the last env computes on a
// clamped env), so each shuffle names the whole warp.
//
// The width rule the lane-group recorders share (policy_width): a family
// names its (wide, narrow) pair of LaneDesigns in its own source, and its
// launch takes the wide design while the one-thread launch would put at
// most one block on each SM (PPO's 2048 envs), the narrow one while it
// would put at most three, else one thread per env (at 16384 envs one
// thread per env already puts a block on 128 of the SMs, and lane groups
// would issue the per-env step G times over).  ops/fused_policy.py's
// policy_universal_lanes computes the same rule without the library.
//
// The plain PyTorch version of the same arithmetic, in the same order, is
// gym_electric_motor_tpu_torch/ops/fused_policy.py (mlp_forward).
#pragma once

#include <cstdint>

#include "policy_heads.cuh"

constexpr unsigned kPolicyWarpMask = 0xffffffffu;

// logit[a] = b2[a] + sum_j w2[j*A + a] tanh(b1[j] + sum_f w1[f*H + j]
// obs[f]) for the A <= AMAX logits (0 past A), every sum in index order, on
// a group of G lanes (l: this lane's place in it); every lane of the group
// returns all AMAX logits.
template <int F, int AMAX, int G>
__device__ __forceinline__ void policy_mlp_lanes(const float* sw, const float (&obs)[F], int H,
                                                 int A, int l, float (&logit)[AMAX]) {
  static_assert(32 % G == 0, "a lane group divides the warp");
  constexpr int HL = (kPolicyMaxHidden + G - 1) / G;   // hidden slots of a lane
  constexpr int AL = (AMAX + G - 1) / G;               // logit slots of a lane
  const float* w1 = sw;
  const float* b1 = w1 + F * H;
  const float* w2 = b1 + H;
  const float* b2 = w2 + H * A;
  float h[HL];
#pragma unroll
  for (int m = 0; m < HL; ++m) {
    const int j = l + G * m;
    float v = 0.0f;
    if (j < H) {
      float acc = b1[j];
#pragma unroll
      for (int f = 0; f < F; ++f) acc = acc + w1[f * H + j] * obs[f];
      v = tanhf(acc);
    }
    h[m] = v;
  }
  float acc[AL];
#pragma unroll
  for (int i = 0; i < AL; ++i) {
    const int a = l + G * i;
    acc[i] = a < A ? b2[a] : 0.0f;
  }
#pragma unroll
  for (int j = 0; j < kPolicyMaxHidden; ++j) {
    const float hj = __shfl_sync(kPolicyWarpMask, h[j / G], j % G, G);
    if (j < H) {
#pragma unroll
      for (int i = 0; i < AL; ++i) {
        const int a = l + G * i;
        if (a < A) acc[i] = acc[i] + w2[j * A + a] * hj;
      }
    }
  }
#pragma unroll
  for (int a = 0; a < AMAX; ++a) {
    logit[a] = __shfl_sync(kPolicyWarpMask, acc[a / G], a % G, G);
  }
}

// Lane 0's value of x to the whole group.
__device__ __forceinline__ float lead_float(float x, int G) {
  return __shfl_sync(kPolicyWarpMask, x, 0, G);
}

__device__ __forceinline__ int lead_int(int x, int G) {
  return __shfl_sync(kPolicyWarpMask, x, 0, G);
}

// The value of recorded plane p among a step's NP, by selects, so that a
// lane's plane index stays a register and the values never go through
// local memory.
template <int NP>
__device__ __forceinline__ uint32_t lane_value(int p, const uint32_t (&v)[NP]) {
  uint32_t x = v[0];
#pragma unroll
  for (int q = 1; q < NP; ++q) x = p == q ? v[q] : x;
  return x;
}

// Recorded plane p's pointer among NP, by selects.
template <int NP>
__device__ __forceinline__ uint32_t* lane_plane(int p, uint32_t* const (&planes)[NP]) {
  uint32_t* x = planes[0];
#pragma unroll
  for (int q = 1; q < NP; ++q) x = p == q ? planes[q] : x;
  return x;
}

// ---- the width rule (host side) ------------------------------------------

// The most blocks a lane-group launch of the width rule puts on an SM (the
// narrow design's bound in policy_width), for a lane kernel's
// __launch_bounds__: ptxas then allocates registers for that occupancy and
// no tighter (the EESM and SRM lane kernels; under the default bound the
// saturating continuous SRM lane instance with the speed ODE and three
// rows spilled 12 B where its one-thread instance spills none).
constexpr int kPolicyLaneBlocksPerSm = 3;

// A lane design: G lanes an env, and whether lane 0 alone samples and
// steps it (LEAD) or every lane does.
template <int G_, bool LEAD_>
struct LaneDesign {
  static constexpr int G = G_;
  static constexpr bool LEAD = LEAD_;
};

inline int device_sms() {
  static int sms[16] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 16) return 0;
  if (sms[dev] == 0) cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  return sms[dev];
}

// blocks of the one-thread launch over n envs
inline int policy_blocks(int n) { return (n + kPolicyThreads - 1) / kPolicyThreads; }

// The design a launch over n envs takes: the pair's wide one, its narrow
// one or one thread per env.
enum PolicyWidth { kPolicyOneThread, kPolicyNarrow, kPolicyWide };

template <class Wide, class Narrow>
PolicyWidth policy_width(int n) {
  const long long sms = device_sms();
  if ((long long)policy_blocks(n) * Wide::G <= sms) return kPolicyWide;
  if ((long long)policy_blocks(n) * Narrow::G <= 3 * sms) return kPolicyNarrow;
  return kPolicyOneThread;
}

// The launch over n envs on the current device, as <family>_policy_layout
// reports it: out = (lanes an env, lane 0 alone stepping, blocks of
// kPolicyThreads, the card's SMs).
template <class Wide, class Narrow>
void policy_layout(int n, int* out) {
  const PolicyWidth d = policy_width<Wide, Narrow>(n);
  const int g = d == kPolicyWide ? Wide::G : (d == kPolicyNarrow ? Narrow::G : 1);
  out[0] = g;
  out[1] = d == kPolicyWide ? Wide::LEAD : (d == kPolicyNarrow && Narrow::LEAD);
  out[2] = (int)(((long long)n * g + kPolicyThreads - 1) / kPolicyThreads);
  out[3] = device_sms();
}

// A family's host launcher of one instance in a design (0: the width rule
// at n, 1: one thread per env), as its instance tables hold them.
template <typename Const>
using PolicyDesignFn = void (*)(const Const&, const PolicyConst&, uint2, int, int,
                                const PolicyWeights&, const float* const*, void* const*,
                                const PolicyOut&, cudaStream_t, int);

// The body of every <family>_policy_record_design: run the picked launcher
// (nullptr where no instance serves the flags) at `hidden` units and n_out
// logits in `design`, and return cudaGetLastError(), or
// cudaErrorInvalidValue for a hidden width out of 1 to kPolicyMaxHidden, a
// missing instance or a design other than 0 and 1.
template <typename Const>
int policy_design_call(PolicyDesignFn<Const> fn, const Const& k, const float* pk, const int* pi,
                       unsigned long long seed, int n, int n_steps, int hidden, int n_out,
                       const PolicyWeights& w, const float* const* in, void* const* out,
                       int n_state_slots, int design, void* stream) {
  if (fn == nullptr || hidden < 1 || hidden > kPolicyMaxHidden || design < 0 || design > 1) {
    return (int)cudaErrorInvalidValue;
  }
  fn(k, policy_load_const(pk, pi, hidden, n_out), policy_seed_key(seed), n, n_steps, w, in, out,
     policy_out(out, n_state_slots), (cudaStream_t)stream, design);
  return (int)cudaGetLastError();
}
