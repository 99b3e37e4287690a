// Universal synchronous-family (PMSM / SynRM) fused rollouts for Hopper
// (sm_90a): four kernels over the shared step of sync_step.cuh, with a
// plain C interface for ctypes (every function returns cudaGetLastError()).
// They serve the twelve {Finite, Cont} x {CC, TC, SC} x {PMSM, SynRM}
// catalog ids at their defaults.
//
// Replaces (gym_electric_motor_tpu/ops/):
//   sync_rollout_random  pallas_sync.py   make_fused_sync_rollout, random mode (:1112)
//   sync_rollout_buffer  pallas_sync.py   make_fused_sync_rollout, buffer mode (:1085)
//   sync_record_random   pallas_record.py make_fused_record_rollout, random mode (:303),
//                                         for the sync family
//   sync_record_buffer   pallas_record.py make_fused_record_rollout, buffer mode (:147),
//                                         for the sync family
//
// Design: the drive state, the Park rotation and the reference rows in
// registers across an in-kernel loop over T steps, one thread per env but
// in the random rollout and the random recorder with Wiener references.
// The TPU recorder's sequential chunk grid and per-chunk reseed
// (pallas_record.py:206-211) do not carry over: the recorders store
// [t, env], so a warp writes 128 contiguous bytes per signal and step.
// Random bits come from Philox4x32-10 keyed by the seed and counted by
// (env, step, slot).  Templates: FINITE (B6 bits or duty), MECH (constant
// speed or the polynomial load's speed ODE) and NREF (1 or 2 reference
// rows); the referenced quantity of a row is a runtime code.  A random
// kernel holds two loops, with and without the reference advance, and
// takes the second when every reference is constant.  Built with
// -fmad=false (ops/cuda_build.py), so each multiply and add rounds as in
// the plain PyTorch version.
//
// With Wiener references the random rollout is warp-specialised
// (draw_ring.cuh), as the SCIM's: four consumer warps run the step, one
// thread per env (cos and sin of the angle under the speed ODE,
// sync_action_step, the reference update by selects), and two producer
// warps per consumer warp draw, in a double-buffered shared-memory ring of
// K = 8 steps a slot, the B6 action (the bits, or three duties with the
// ACTION_C call) and per row the Box-Muller draw and the candidate length,
// sigma and reset value, 5 to 11 words a step.  The Philox calls and the
// Box-Muller pair are a large share of the synchronous step, so taking
// them off the consumers' dependent chain pays though the ids rarely reset
// (PERF.md, slice 15).  The one-thread kernel's Wiener loop, which the launch
// does not take, counts the function's own work.  Every design equals the
// plain version bit for bit.
//
// The random recorder on a ring.  One thread per env put every Philox call
// of a step, the Box-Muller pair's logf, sqrtf, cosf and sinf and the
// divergent reference redraw after a reset on the step's dependent chain,
// as the rollout did before its ring.  With Wiener references the recorder
// is warp-specialised over the rollout's draws: producer warps fill the
// ring with b6_draws (5 to 11 words a step), consumer warps run
// sync_ring_step, one thread per env, and store the recorded planes.
// ref_wiener_init stays with the consumer.  With constant references a
// step draws only its action, and the recorder keeps its one-thread loop.
//
// What bounds it on this card: the reducing kernels move only the initial
// and final state (plus 4 or 12 bytes of action per env-step in buffer
// mode), so they are bound by the operations of a step: RK4 over the dq
// currents (and the speed, with the load's torque), the non-fast-math
// cosf/sinf/logf polynomials on the FP32 pipe, and Philox's integer
// multiplies and xors; tools/sass_ops.py counts the instructions a step
// always issues, per pipe, from the SASS, and chip_smoke.py takes its
// bounds from that count.  The recorders add 4 bytes per signal and
// env-step of HBM traffic (7 to 10 signals in random mode) and are bound by
// it at large T.  Every step loop is `#pragma unroll 1` and a producer's
// slot loop unrolls exactly its four steps, so that one loop iteration is
// one step, or four, in the SASS count.
#include <cuda_runtime.h>

#include "draw_ring.cuh"
#include "sync_step.cuh"

namespace {

constexpr int kThreads = 128;

template <bool MECH>
__device__ __forceinline__ SyncState load_state(const float* __restrict__ w0,
                                                const float* __restrict__ i_sd0,
                                                const float* __restrict__ i_sq0,
                                                const float* __restrict__ eps0, int e) {
  SyncState x;
  x.w = MECH ? w0[e] : 0.0f;
  x.i_sd = i_sd0[e];
  x.i_sq = i_sq0[e];
  x.eps = eps0[e];
  return x;
}

template <bool MECH>
__device__ __forceinline__ void store_state(const SyncState& x, float* __restrict__ w,
                                            float* __restrict__ i_sd, float* __restrict__ i_sq,
                                            float* __restrict__ eps, size_t i) {
  if (MECH) w[i] = x.w;
  i_sd[i] = x.i_sd;
  i_sq[i] = x.i_sq;
  eps[i] = x.eps;
}

// out_red: reward, terms, rv, rk, rl, rs
struct RolloutOut {
  float *reward, *terms, *rv, *rk, *rl, *rs;
};

// A random kernel's results for env e: the final state, the reward sum,
// the termination count and the final reference rows ((NREF * R, 128)
// planes, row 0 first).
template <bool MECH, int NREF>
__device__ __forceinline__ void store_out(const SyncState& x, float reward, float terms,
                                          const RefRows<NREF>& refs, int n, int e,
                                          float* const* out_state, const RolloutOut& o) {
  store_state<MECH>(x, out_state[0], out_state[1], out_state[2], out_state[3], (size_t)e);
  o.reward[e] = reward;
  o.terms[e] = terms;
#pragma unroll
  for (int r = 0; r < NREF; ++r) {
    o.rv[(size_t)r * n + e] = refs.rv[r];
    o.rk[(size_t)r * n + e] = refs.rk[r];
    o.rl[(size_t)r * n + e] = refs.rl[r];
    o.rs[(size_t)r * n + e] = refs.rs[r];
  }
}

// The kernel parameters of a random rollout: the state planes in and out
// (omega or NULL first) and the reductions.
struct RandomIo {
  const float* in[4];
  float* out[4];
  RolloutOut o;
};

// What depends on the state: sync_random_step with the step's draws given
// (under the speed ODE cos and sin of the angle, then the action step and
// the reference advance by the candidates).
template <bool FINITE, bool MECH, int NREF, bool WIENER>
__device__ __forceinline__ void sync_draw_step(const SyncConst& k, const B6Draws<NREF>& d,
                                               SyncState& x, float& c, float& s,
                                               RefRows<NREF>& refs, float& reward,
                                               float& terms) {
  if (MECH) {
    c = cosf(x.eps);
    s = sinf(x.eps);
  }
  const SyncStepOut o = sync_action_step<FINITE, MECH, NREF>(k, d.a, x, c, s, refs);
  reward += o.reward;
  terms += o.done;
  if constexpr (WIENER) ref_advance_candidates<NREF>(k.ref, d.c, o.done != 0.0f, refs);
}

// sync_draw_step for the recorder: the same step with Wiener references,
// returning what the recorder stores (the reducing step above keeps its
// sums before the reference advance, the order the rollout's SASS was
// counted in).
template <bool FINITE, bool MECH, int NREF>
__device__ __forceinline__ SyncStepOut sync_ring_step(const SyncConst& k, const B6Draws<NREF>& d,
                                                      SyncState& x, float& c, float& s,
                                                      RefRows<NREF>& refs) {
  if (MECH) {
    c = cosf(x.eps);
    s = sinf(x.eps);
  }
  const SyncStepOut o = sync_action_step<FINITE, MECH, NREF>(k, d.a, x, c, s, refs);
  ref_advance_candidates<NREF>(k.ref, d.c, o.done != 0.0f, refs);
  return o;
}

// One thread per env.  With Wiener references (the loop the bound counts;
// the launch takes the warp-specialised kernel) each step draws and steps
// as sync_random_step.  With constant ones, at constant speed step t + 1's
// action is drawn beside step t's physics; under the speed ODE the step
// draws its own action, the faster form there (PERF.md, slice 15).
template <bool FINITE, bool MECH, int NREF>
__global__ void sync_rollout_random_kernel(SyncConst k, uint2 key, int n, int n_steps,
                                           RandomIo io) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  SyncState x = load_state<MECH>(io.in[0], io.in[1], io.in[2], io.in[3], e);
  float c = 1.0f, s = 0.0f;
  if (!MECH) {
    c = cosf(x.eps);
    s = sinf(x.eps);
  }
  RefRows<NREF> refs;
  ref_wiener_init<NREF>(k.ref, key, (uint32_t)e, refs);
  float reward = 0.0f, terms = 0.0f;
  if (k.flag[F_ALL_CONST] && MECH) {
#pragma unroll 1
    for (int t = 0; t < n_steps; ++t) {
      const SyncStepOut o = sync_random_step<FINITE, MECH, NREF, false>(
          k, key, (uint32_t)e, (uint32_t)t, x, c, s, refs);
      reward += o.reward;
      terms += o.done;
    }
  } else if (k.flag[F_ALL_CONST]) {
    float zb = 0.0f;  // unused: constant references draw no Box-Muller pair
    B6Draws<NREF> d = b6_draws<FINITE, NREF, false>(k.ref, key, (uint32_t)e, 0u, false, zb);
#pragma unroll 1
    for (int t = 0; t < n_steps; ++t) {
      const B6Draws<NREF> next =
          b6_draws<FINITE, NREF, false>(k.ref, key, (uint32_t)e, (uint32_t)(t + 1), false, zb);
      sync_draw_step<FINITE, MECH, NREF, false>(k, d, x, c, s, refs, reward, terms);
      d = next;
    }
  } else {
#pragma unroll 1
    for (int t = 0; t < n_steps; ++t) {
      const SyncStepOut o = sync_random_step<FINITE, MECH, NREF, true>(
          k, key, (uint32_t)e, (uint32_t)t, x, c, s, refs);
      reward += o.reward;
      terms += o.done;
    }
  }
  store_out<MECH, NREF>(x, reward, terms, refs, n, e, io.out, io.o);
}

// The random rollout with Wiener references on a ring of shape S
// (draw_ring.cuh): producer warps draw each step's action and reference
// candidates, consumer warps run sync_draw_step.
template <bool FINITE, bool MECH, int NREF, class S>
__global__ void __launch_bounds__(S::kThreads)
    sync_rollout_ws_kernel(SyncConst k, uint2 key, int n, int n_steps, RandomIo io) {
  constexpr int W = b6_draw_words<FINITE, NREF>();
  extern __shared__ uint32_t ring[];
  const RingThread th = ring_thread(n);
  const int e = th.e;
  SyncState x = load_state<MECH>(io.in[0], io.in[1], io.in[2], io.in[3], e);
  float c = 1.0f, s = 0.0f;
  if (!MECH) {
    c = cosf(x.eps);
    s = sinf(x.eps);
  }
  RefRows<NREF> refs;
  ref_wiener_init<NREF>(k.ref, key, (uint32_t)e, refs);
  float reward = 0.0f, terms = 0.0f;
  const RingPipe<S> pipe(n_steps);
  const RingView<W> v{ring + th.le};
  if (th.consumer) {
    ring_consume(pipe, v, n_steps, [&](const RingWords<W>& w) {
      sync_draw_step<FINITE, MECH, NREF, true>(k, b6_draws_unpack<FINITE, NREF>(w), x, c, s,
                                               refs, reward, terms);
    });
  } else {
    ring_produce(pipe, v, th.part, [&](uint32_t t, bool odd, float& zb) {
      return b6_draws_pack<FINITE, NREF>(
          b6_draws<FINITE, NREF, true>(k.ref, key, (uint32_t)e, t, odd, zb));
    });
  }
  if (!th.consumer || !th.live) return;
  store_out<MECH, NREF>(x, reward, terms, refs, n, e, io.out, io.o);
}

template <bool FINITE, bool MECH>
__global__ void sync_rollout_buffer_kernel(SyncConst k, int n, int n_steps,
                                           const float* __restrict__ w0,
                                           const float* __restrict__ i_sd0,
                                           const float* __restrict__ i_sq0,
                                           const float* __restrict__ eps0,
                                           const int* __restrict__ act_i,
                                           const float* __restrict__ act_f,
                                           float* __restrict__ out_w, float* __restrict__ out_isd,
                                           float* __restrict__ out_isq,
                                           float* __restrict__ out_eps) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  SyncState x = load_state<MECH>(w0, i_sd0, i_sq0, eps0, e);
#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) {
    const SyncAction a = b6_read_action<FINITE>(act_i, act_f, n, t, e);
    sync_physics<FINITE, MECH>(k, a, cosf(x.eps), sinf(x.eps), x);
  }
  store_state<MECH>(x, out_w, out_isd, out_isq, out_eps, (size_t)e);
}

struct RecordOut {
  float *w, *i_sd, *i_sq, *eps, *ref0, *ref1;
  int* act_i;
  float *act_a, *act_b, *act_c, *reward, *done;
};

// Step t's recorded planes, at i = t n + e.
template <bool FINITE, bool MECH, int NREF>
__device__ __forceinline__ void store_step(const SyncStepOut& r, const SyncState& x,
                                           const RecordOut& o, size_t i) {
  store_state<MECH>(x, o.w, o.i_sd, o.i_sq, o.eps, i);
  o.ref0[i] = r.ref[0];
  if (NREF == 2) o.ref1[i] = r.ref[1];
  if (FINITE) {
    o.act_i[i] = r.act.bits;
  } else {
    o.act_a[i] = r.act.a;
    o.act_b[i] = r.act.b;
    o.act_c[i] = r.act.c;
  }
  o.reward[i] = r.reward;
  o.done[i] = r.done;
}

template <bool FINITE, bool MECH, int NREF, bool WIENER>
__device__ __forceinline__ void record_random_loop(const SyncConst& k, uint2 key, int e, int n,
                                                   int n_steps, SyncState& x, float& c, float& s,
                                                   RefRows<NREF>& refs, const RecordOut& o) {
#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) {
    const SyncStepOut r =
        sync_random_step<FINITE, MECH, NREF, WIENER>(k, key, (uint32_t)e, (uint32_t)t, x, c, s, refs);
    store_step<FINITE, MECH, NREF>(r, x, o, (size_t)t * n + e);
  }
}

template <bool FINITE, bool MECH, int NREF>
__global__ void sync_record_random_kernel(SyncConst k, uint2 key, int n, int n_steps,
                                          const float* __restrict__ w0,
                                          const float* __restrict__ i_sd0,
                                          const float* __restrict__ i_sq0,
                                          const float* __restrict__ eps0, RecordOut o) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  SyncState x = load_state<MECH>(w0, i_sd0, i_sq0, eps0, e);
  float c = 1.0f, s = 0.0f;
  if (!MECH) {
    c = cosf(x.eps);
    s = sinf(x.eps);
  }
  RefRows<NREF> refs;
  ref_wiener_init<NREF>(k.ref, key, (uint32_t)e, refs);
  if (k.flag[F_ALL_CONST]) {
    record_random_loop<FINITE, MECH, NREF, false>(k, key, e, n, n_steps, x, c, s, refs, o);
  } else {
    record_random_loop<FINITE, MECH, NREF, true>(k, key, e, n, n_steps, x, c, s, refs, o);
  }
}

// The recorder's ring: K steps a slot, P producer warps per consumer warp;
// of K in {4, 8} x P in {1, 2} the fastest or within 1.5% of it on every id
// probed, and the only shape that ran faster than the one-thread recorder
// on all of them (one producer warp ran 5% to 14% slower than that on the
// CC ids, PERF.md, slice 23); ops/fused_sync_family.py's SYNC_RECORD_RING
// mirrors it.
using SyncRecordRing = RingShape<8, 2>;

// The random recorder with Wiener references (with constant ones the
// launch takes sync_record_random_kernel): producer warps run b6_draws,
// consumer warps the step, one thread per env.
template <bool FINITE, bool MECH, int NREF>
__global__ void __launch_bounds__(SyncRecordRing::kThreads)
    sync_record_ws_kernel(SyncConst k, uint2 key, int n, int n_steps,
                          const float* __restrict__ w0, const float* __restrict__ i_sd0,
                          const float* __restrict__ i_sq0, const float* __restrict__ eps0,
                          RecordOut o) {
  constexpr int W = b6_draw_words<FINITE, NREF>();
  extern __shared__ uint32_t ring[];
  const RingThread th = ring_thread(n);
  const int e = th.e;
  const RingPipe<SyncRecordRing> pipe(n_steps);
  const RingView<W> v{ring + th.le};
  if (!th.consumer) {
    ring_produce(pipe, v, th.part, [&](uint32_t t, bool odd, float& zb) {
      return b6_draws_pack<FINITE, NREF>(
          b6_draws<FINITE, NREF, true>(k.ref, key, (uint32_t)e, t, odd, zb));
    });
    return;
  }
  SyncState x = load_state<MECH>(w0, i_sd0, i_sq0, eps0, e);
  float c = 1.0f, s = 0.0f;
  if (!MECH) {
    c = cosf(x.eps);
    s = sinf(x.eps);
  }
  RefRows<NREF> refs;
  ref_wiener_init<NREF>(k.ref, key, (uint32_t)e, refs);
  size_t i = (size_t)e;
  ring_consume(pipe, v, n_steps, [&](const RingWords<W>& words) {
    const SyncStepOut r = sync_ring_step<FINITE, MECH, NREF>(
        k, b6_draws_unpack<FINITE, NREF>(words), x, c, s, refs);
    if (th.live) store_step<FINITE, MECH, NREF>(r, x, o, i);
    i += (size_t)n;
  });
}

template <bool FINITE, bool MECH>
__global__ void sync_record_buffer_kernel(SyncConst k, int n, int n_steps,
                                          const float* __restrict__ w0,
                                          const float* __restrict__ i_sd0,
                                          const float* __restrict__ i_sq0,
                                          const float* __restrict__ eps0,
                                          const int* __restrict__ act_i,
                                          const float* __restrict__ act_f, float* __restrict__ out_w,
                                          float* __restrict__ out_isd, float* __restrict__ out_isq,
                                          float* __restrict__ out_eps) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  SyncState x = load_state<MECH>(w0, i_sd0, i_sq0, eps0, e);
#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) {
    const SyncAction a = b6_read_action<FINITE>(act_i, act_f, n, t, e);
    sync_physics<FINITE, MECH>(k, a, cosf(x.eps), sinf(x.eps), x);
    store_state<MECH>(x, out_w, out_isd, out_isq, out_eps, (size_t)t * n + e);
  }
}

uint2 seed_key(unsigned long long seed) {
  return make_uint2((uint32_t)(seed & 0xFFFFFFFFull), (uint32_t)(seed >> 32));
}

int blocks(int n) { return (n + kThreads - 1) / kThreads; }

// Instance index of (FINITE, MECH, NREF): 4 * finite + 2 * mech + nref - 1
// for the random kernels, 2 * finite + mech for the buffer kernels; -1 for
// flags no instance serves.
int random_index(const int* f) {
  if (f[F_NREF] != 1 && f[F_NREF] != 2) return -1;
  return 4 * (f[F_FINITE] != 0) + 2 * (f[F_MECH] != 0) + f[F_NREF] - 1;
}

int buffer_index(const int* f) { return 2 * (f[F_FINITE] != 0) + (f[F_MECH] != 0); }

RandomIo random_io(const float* const* in, float* const* out) {
  RandomIo io;
  for (int j = 0; j < 4; ++j) {
    io.in[j] = in[j];
    io.out[j] = out[j];
  }
  io.o = {out[4], out[5], out[6], out[7], out[8], out[9]};
  return io;
}

// The ring of the synchronous random rollout: K = 8 steps a slot, two
// producer warps per consumer warp (the SCIM's IndRing), on every instance
// (one producer warp was slower at constant speed and under Cont-SC's speed
// ODE, PERF.md, slice 15).
using SyncRing = RingShape<8, 2>;

// The warp-specialised kernel with Wiener references, the one-thread
// kernel's constant-reference loop with constant ones.
template <bool F, bool M, int NR>
void launch_rollout_random(const SyncConst& k, uint2 key, int n, int n_steps, const float* const* in,
                           float* const* out, cudaStream_t st) {
  const RandomIo io = random_io(in, out);
  if (k.flag[F_ALL_CONST]) {
    sync_rollout_random_kernel<F, M, NR><<<blocks(n), kThreads, 0, st>>>(k, key, n, n_steps, io);
    return;
  }
  constexpr int bytes = ring_bytes<SyncRing>(b6_draw_words<F, NR>());
  if (bytes > 48 * 1024) {
    cudaFuncSetAttribute(sync_rollout_ws_kernel<F, M, NR, SyncRing>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  }
  sync_rollout_ws_kernel<F, M, NR, SyncRing><<<(n + kRingEnvs - 1) / kRingEnvs,
                                               SyncRing::kThreads, bytes, st>>>(k, key, n,
                                                                                 n_steps, io);
}

// Wiener references run the warp-specialised kernel; constant ones, which
// draw only the action, the one-thread kernel.  Returns the error of
// raising the kernel's shared-memory limit, or 0.
template <bool F, bool M, int NR>
int launch_record_random(const SyncConst& k, uint2 key, int n, int n_steps, const float* const* in,
                         const RecordOut& o, cudaStream_t st) {
  if (k.flag[F_ALL_CONST]) {
    sync_record_random_kernel<F, M, NR><<<blocks(n), kThreads, 0, st>>>(k, key, n, n_steps, in[0],
                                                                        in[1], in[2], in[3], o);
    return 0;
  }
  constexpr int bytes = ring_bytes<SyncRecordRing>(b6_draw_words<F, NR>());
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sync_record_ws_kernel<F, M, NR>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
  }
  sync_record_ws_kernel<F, M, NR><<<(n + kRingEnvs - 1) / kRingEnvs, SyncRecordRing::kThreads,
                                    bytes, st>>>(k, key, n, n_steps, in[0], in[1], in[2], in[3],
                                                 o);
  return 0;
}

template <bool F, bool M>
void launch_rollout_buffer(const SyncConst& k, int n, int n_steps, const float* const* in,
                           const int* act_i, const float* act_f, float* const* out,
                           cudaStream_t st) {
  sync_rollout_buffer_kernel<F, M><<<blocks(n), kThreads, 0, st>>>(
      k, n, n_steps, in[0], in[1], in[2], in[3], act_i, act_f, out[0], out[1], out[2], out[3]);
}

template <bool F, bool M>
void launch_record_buffer(const SyncConst& k, int n, int n_steps, const float* const* in,
                          const int* act_i, const float* act_f, float* const* out,
                          cudaStream_t st) {
  sync_record_buffer_kernel<F, M><<<blocks(n), kThreads, 0, st>>>(
      k, n, n_steps, in[0], in[1], in[2], in[3], act_i, act_f, out[0], out[1], out[2], out[3]);
}

using RolloutRandomFn = void (*)(const SyncConst&, uint2, int, int, const float* const*,
                                 float* const*, cudaStream_t);
using RecordRandomFn = int (*)(const SyncConst&, uint2, int, int, const float* const*,
                               const RecordOut&, cudaStream_t);
using BufferFn = void (*)(const SyncConst&, int, int, const float* const*, const int*,
                          const float*, float* const*, cudaStream_t);

const RolloutRandomFn kRolloutRandom[8] = {
    launch_rollout_random<false, false, 1>, launch_rollout_random<false, false, 2>,
    launch_rollout_random<false, true, 1>,  launch_rollout_random<false, true, 2>,
    launch_rollout_random<true, false, 1>,  launch_rollout_random<true, false, 2>,
    launch_rollout_random<true, true, 1>,   launch_rollout_random<true, true, 2>};
const RecordRandomFn kRecordRandom[8] = {
    launch_record_random<false, false, 1>, launch_record_random<false, false, 2>,
    launch_record_random<false, true, 1>,  launch_record_random<false, true, 2>,
    launch_record_random<true, false, 1>,  launch_record_random<true, false, 2>,
    launch_record_random<true, true, 1>,   launch_record_random<true, true, 2>};
const BufferFn kRolloutBuffer[4] = {
    launch_rollout_buffer<false, false>, launch_rollout_buffer<false, true>,
    launch_rollout_buffer<true, false>, launch_rollout_buffer<true, true>};
const BufferFn kRecordBuffer[4] = {
    launch_record_buffer<false, false>, launch_record_buffer<false, true>,
    launch_record_buffer<true, false>, launch_record_buffer<true, true>};

}  // namespace

extern "C" {

int sync_n_const() { return N_SYNC_CONST; }
int sync_n_row_const() { return N_ROW_CONST; }
int sync_n_flag() { return N_SYNC_FLAG; }

const char* sync_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// in: (omega or NULL, i_sd, i_sq, eps); out: (omega or NULL, i_sd, i_sq,
// eps, reward, terms, rv, rk, rl, rs).  Returns cudaErrorInvalidValue for
// flags no instance serves.
int sync_rollout_random(const float* consts, const int* flags, unsigned long long seed, int n,
                        int n_steps, const float* const* in, float* const* out, void* stream) {
  const int idx = random_index(flags);
  if (idx < 0) return (int)cudaErrorInvalidValue;
  kRolloutRandom[idx](sync_load_const(consts, flags), seed_key(seed), n, n_steps, in, out,
                      (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// The random rollout's ring for the instance and loop of these flags
// (draw_ring.cuh's RingLayout), or the rest zero where the launch runs one
// thread per env (constant references): RL_DESIGN 2 at constant speed,
// where the next step's draws are ahead, 1 under the speed ODE;
// cudaErrorInvalidValue for flags no instance serves.
int sync_ring_layout(const int* flags, int* out) {
  if (random_index(flags) < 0) return (int)cudaErrorInvalidValue;
  if (flags[F_ALL_CONST]) {
    ring_layout_one_thread(flags[F_MECH] ? 1 : 2, out);
    return 0;
  }
  ring_layout<SyncRing>((flags[F_FINITE] ? 1 : 3) + kRefWords * flags[F_NREF], out);
  return 0;
}

// actions: int32 (T, N) for a finite converter, float32 (T, 3, N) for a
// continuous one (the other pointer NULL); out: (omega or NULL, i_sd, i_sq,
// eps).
int sync_rollout_buffer(const float* consts, const int* flags, int n, int n_steps,
                        const float* const* in, const int* act_i, const float* act_f,
                        float* const* out, void* stream) {
  kRolloutBuffer[buffer_index(flags)](sync_load_const(consts, flags), n, n_steps, in, act_i, act_f,
                                     out, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// out: (omega or NULL, i_sd, i_sq, eps, ref row 0, ref row 1 or NULL, int32
// action or NULL, action a, b, c or NULL, reward, done), each (T, N).
int sync_record_random(const float* consts, const int* flags, unsigned long long seed, int n,
                       int n_steps, const float* const* in, void* const* out, void* stream) {
  const int idx = random_index(flags);
  if (idx < 0) return (int)cudaErrorInvalidValue;
  RecordOut o;
  o.w = (float*)out[0];
  o.i_sd = (float*)out[1];
  o.i_sq = (float*)out[2];
  o.eps = (float*)out[3];
  o.ref0 = (float*)out[4];
  o.ref1 = (float*)out[5];
  o.act_i = (int*)out[6];
  o.act_a = (float*)out[7];
  o.act_b = (float*)out[8];
  o.act_c = (float*)out[9];
  o.reward = (float*)out[10];
  o.done = (float*)out[11];
  const int err = kRecordRandom[idx](sync_load_const(consts, flags), seed_key(seed), n, n_steps,
                                     in, o, (cudaStream_t)stream);
  return err != 0 ? err : (int)cudaGetLastError();
}

// The random recorder's ring for the instance and loop of these flags
// (ring_pipe.cuh's RingLayout), or RL_DESIGN 1 and the rest zero where the
// launch runs one thread per env (constant references);
// cudaErrorInvalidValue for flags no instance serves.
int sync_record_ring_layout(const int* flags, int* out) {
  if (random_index(flags) < 0) return (int)cudaErrorInvalidValue;
  if (flags[F_ALL_CONST]) {
    ring_layout_one_thread(1, out);
    return 0;
  }
  ring_layout<SyncRecordRing>((flags[F_FINITE] ? 1 : 3) + kRefWords * flags[F_NREF], out);
  return 0;
}

// As sync_rollout_buffer, every step's state stored (T, N).
int sync_record_buffer(const float* consts, const int* flags, int n, int n_steps,
                       const float* const* in, const int* act_i, const float* act_f,
                       float* const* out, void* stream) {
  kRecordBuffer[buffer_index(flags)](sync_load_const(consts, flags), n, n_steps, in, act_i, act_f,
                                    out, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

}  // extern "C"
