// The warp-specialised random rollouts of the DC, SCIM, EESM and synchronous
// families (fused_dc.cu, fused_induction.cu, fused_eesm.cu, fused_sync.cu):
// producer warps compute every value of a
// step that does not depend on the state into a shared-memory ring, and
// consumer warps run the step, one thread per env, reading those values.
//
// The split.  Everything a random step draws comes from drive_draw(key,
// env, t, slot), and every value made of those words depends on the
// constants alone: the sampled action, each reference row's Box-Muller
// draw (with one row the sine half of an even step's pair, carried to the
// odd step after it), and the values a row would take if it regenerated
// (sub-episode length and sigma, ref_params) or if the env reset
// (ref_uniform_value).  The producer computes all of them at every step, in
// the operand order of ref_wiener_advance (common_step.cuh); the consumer
// keeps what depends on the state: the physics, the violation, the reward,
// the regeneration test rk >= rl || violated, the rk and rv update and the
// reset to zero, and takes the candidates by selects.  The same functions
// on the same operands, built with -fmad=false, make the two designs and
// the plain PyTorch version equal bit for bit.
//
// Roles and layout.  A block holds kRingEnvs = 128 envs on kConsumerWarps
// consumer warps (thread i of the consumers owns env i of the block, its
// state in registers) and P producer warps per consumer warp (RingShape):
// lane i of producer warp 4 q + w draws for env 32 w + i the q-th K / P
// steps of each slot, unrolled, so that their Philox calls are independent
// chains.  The role is a warp's (warp index < kConsumerWarps), so no warp
// diverges on it.  The ring holds two slots (double buffer) of K steps;
// step t sits in slot (t / K) % 2, and word j of its W words for block env
// i at ring[((t % 2K) W + j) 128 + i]: a warp's 32 lanes touch 32
// consecutive words, one per bank.  A consumer loads step t + 1's words
// before it runs step t.
//
// Barriers.  Four named barriers (ids 1 to 4, never 0, which
// __syncthreads takes), each counting all the block's threads: FULL of a
// slot (bar.arrive by the producers once they have written it, bar.sync by
// the consumers before they read it) and EMPTY of a slot (bar.arrive by the
// consumers once they have read it, bar.sync by the producers before they
// write it again).  The producers skip EMPTY on the first fill of each
// slot, and the consumers arrive at EMPTY only where a later fill waits,
// so every barrier completes exactly as often as it is waited on.
// bar.arrive orders the thread's earlier shared-memory accesses before the
// barrier's completion and bar.sync the later ones after it, so a slot is
// read only after it was written and written only after it was read.
// Every thread runs its role's loop to the end: a thread past the last env
// computes on a clamped env and stores nothing.
#pragma once

#include <cstdint>

#include "common_step.cuh"

constexpr int kRingEnvs = 128;
constexpr int kConsumerWarps = kRingEnvs / 32;
constexpr int kRingSlots = 2;
constexpr int kBarFull = 1;                 // FULL of slot s: kBarFull + s
constexpr int kBarEmpty = 1 + kRingSlots;   // EMPTY of slot s: kBarEmpty + s

// The shape of a ring: K steps a slot, P producer warps per consumer warp
// (each drawing K / P consecutive steps of a slot for its partner's envs).
template <int K_, int P_>
struct RingShape {
  static constexpr int K = K_;
  static constexpr int P = P_;
  static constexpr int kThreads = 32 * kConsumerWarps * (1 + P);
  static_assert((K & (K - 1)) == 0, "K is a power of two");
  static_assert(K % P == 0 && (K / P) % 2 == 0,
                "a producer's steps pair an even step with the odd one after it");
};

template <int THREADS>
__device__ __forceinline__ void ring_bar_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(THREADS) : "memory");
}

template <int THREADS>
__device__ __forceinline__ void ring_bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "n"(THREADS) : "memory");
}

// Bytes of dynamic shared memory for a ring of W words a step.
template <class S>
__host__ __device__ constexpr int ring_bytes(int words) {
  return kRingSlots * S::K * words * kRingEnvs * 4;
}

// A thread's place in the block: its role, its env in the block (the same
// for a consumer thread and the producer lane that draws for it) and its
// env in the launch, clamped to the last one.
struct RingThread {
  bool consumer;
  int part;    // a producer's share of a slot: steps part K / P .. (part + 1) K / P - 1
  int le;      // env in the block
  int e;       // env in the launch, clamped to n - 1
  bool live;   // e was not clamped: the thread stores its env's results
};

__device__ __forceinline__ RingThread ring_thread(int n) {
  const int warp = (int)threadIdx.x / 32;
  RingThread r;
  r.consumer = warp < kConsumerWarps;
  r.part = r.consumer ? 0 : (warp - kConsumerWarps) / kConsumerWarps;
  r.le = (warp % kConsumerWarps) * 32 + (int)threadIdx.x % 32;
  const int e = (int)blockIdx.x * kRingEnvs + r.le;
  r.live = e < n;
  r.e = r.live ? e : n - 1;
  return r;
}

// The pipeline of one launch: n_slots fills of K steps, the last one
// partly past n_steps (the producers draw whole slots; the consumers read
// the first n_steps steps).
template <class S>
struct RingPipe {
  static constexpr int K = S::K;
  int n_slots;

  __device__ __forceinline__ explicit RingPipe(int n_steps) : n_slots((n_steps + K - 1) / K) {}

  // producers, around fill i (of slot i % 2, steps i K .. i K + K - 1)
  __device__ __forceinline__ void producer_acquire(int i) const {
    if (i >= kRingSlots) ring_bar_sync<S::kThreads>(kBarEmpty + (i & 1));
  }
  __device__ __forceinline__ void producer_commit(int i) const {
    ring_bar_arrive<S::kThreads>(kBarFull + (i & 1));
  }
  // consumers, before and after step t
  __device__ __forceinline__ void consumer_wait(int t) const {
    if ((t & (K - 1)) == 0) ring_bar_sync<S::kThreads>(kBarFull + ((t / K) & 1));
  }
  __device__ __forceinline__ void consumer_release(int t) const {
    if ((t & (K - 1)) == K - 1 && t / K + kRingSlots < n_slots) {
      ring_bar_arrive<S::kThreads>(kBarEmpty + ((t / K) & 1));
    }
  }
};

// The W words of one step.
template <int W>
struct RingWords {
  uint32_t w[W];
};

// A thread's view of the ring for one env: word j of the step in ring
// position p (= t % 2K) at base[(p W + j) 128].
template <int W>
struct RingView {
  uint32_t* base;   // the ring plus the env's column

  __device__ __forceinline__ void store(int p, const RingWords<W>& x) const {
#pragma unroll
    for (int j = 0; j < W; ++j) base[(p * W + j) * kRingEnvs] = x.w[j];
  }
  __device__ __forceinline__ RingWords<W> load(int p) const {
    RingWords<W> x;
#pragma unroll
    for (int j = 0; j < W; ++j) x.w[j] = base[(p * W + j) * kRingEnvs];
    return x;
  }
};

// Producer: fill i of every slot, each step's words from draw(t, odd, zb)
// (odd: t is odd; zb: one reference row's carried sine half), the thread's
// K / P steps unrolled.
template <class S, int W, class Draw>
__device__ __forceinline__ void ring_produce(const RingPipe<S>& pipe, const RingView<W>& v,
                                             int part, Draw draw) {
  constexpr int K = S::K, kPart = S::K / S::P;
#pragma unroll 1
  for (int i = 0; i < pipe.n_slots; ++i) {
    pipe.producer_acquire(i);
    float zb = 0.0f;
#pragma unroll
    for (int jj = 0; jj < kPart; ++jj) {
      const int j = part * kPart + jj;
      v.store((i & 1) * K + j, draw((uint32_t)(i * K + j), (jj & 1) != 0, zb));
    }
    pipe.producer_commit(i);
  }
}

// Consumer: step(words) for t = 0 .. n_steps - 1, the words of step t + 1
// loaded before step t runs, so that the load's latency overlaps the step.
template <class S, int W, class Step>
__device__ __forceinline__ void ring_consume(const RingPipe<S>& pipe, const RingView<W>& v,
                                             int n_steps, Step step) {
  constexpr int K = S::K;
  if (n_steps <= 0) return;
  pipe.consumer_wait(0);
  RingWords<W> cur = v.load(0);
#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) {
    if (t + 1 < n_steps) pipe.consumer_wait(t + 1);
    // past the last step the position holds a slot no producer writes again
    const RingWords<W> next = v.load((t + 1) & (2 * K - 1));
    pipe.consumer_release(t);
    step(cur);
    cur = next;
  }
}

// What a step of the reference rows draws, whatever the state: each row's
// Box-Muller draw, the sub-episode length and sigma a regeneration takes
// and the value a reset takes.
template <int NREF>
struct RefCandidates {
  float draw[NREF], rl[NREF], rs[NREF], rv[NREF];
};

constexpr int kRefWords = 4;   // ring words per reference row

// Producer side: the candidates of step t from its SLOT_STEP words w, in
// the operand order of ref_wiener_advance.  With one row an even step
// (odd false) draws the pair and leaves its sine half in zb for the odd
// step after it.  The PARAMS and RESET slots are drawn at every step.
template <int NREF, class RC>
__device__ __forceinline__ RefCandidates<NREF> ref_candidates(const RC& k, uint2 key, uint32_t env,
                                                              uint32_t t, uint4 w, bool odd,
                                                              float& zb) {
  RefCandidates<NREF> c;
  uint4 x = make_uint4(0u, 0u, 0u, 0u);  // three rows: the ROW2 slot's words
  if constexpr (NREF == 3) {
    x = drive_draw(key, env, t, DRIVE_SLOT_ROW2);
    const float rad = sqrtf(-2.0f * logf(fmaxf(uniform24(w.y), k.u_min)));
    const float theta = k.two_pi * uniform24(w.z);
    c.draw[0] = rad * cosf(theta);
    c.draw[1] = rad * sinf(theta);
    const float rad2 = sqrtf(-2.0f * logf(fmaxf(uniform24(x.x), k.u_min)));
    c.draw[2] = rad2 * cosf(k.two_pi * uniform24(x.y));
  } else if (NREF == 2 || !odd) {
    const float rad = sqrtf(-2.0f * logf(fmaxf(uniform24(w.y), k.u_min)));
    const float theta = k.two_pi * uniform24(w.z);
    c.draw[0] = rad * cosf(theta);
    if (NREF == 2) {
      c.draw[NREF - 1] = rad * sinf(theta);
    } else {
      zb = rad * sinf(theta);
    }
  } else {
    c.draw[0] = zb;
  }
  const uint4 p = drive_draw(key, env, t, DRIVE_SLOT_PARAMS);
#pragma unroll
  for (int r = 0; r < NREF; ++r) {
    ref_params(k, r, r == 2 ? x.z : (r ? p.y : p.x), r == 2 ? x.w : (r ? p.w : p.z), c.rl[r],
               c.rs[r]);
  }
  const uint4 q = drive_draw(key, env, t, DRIVE_SLOT_RESET);
#pragma unroll
  for (int r = 0; r < NREF; ++r) c.rv[r] = ref_uniform_value(k, r, r == 2 ? q.z : (r ? q.y : q.x));
  return c;
}

template <int NREF, int W>
__device__ __forceinline__ void pack_refs(const RefCandidates<NREF>& c, int j0, RingWords<W>& x) {
#pragma unroll
  for (int r = 0; r < NREF; ++r) {
    x.w[j0 + kRefWords * r] = __float_as_uint(c.draw[r]);
    x.w[j0 + kRefWords * r + 1] = __float_as_uint(c.rl[r]);
    x.w[j0 + kRefWords * r + 2] = __float_as_uint(c.rs[r]);
    x.w[j0 + kRefWords * r + 3] = __float_as_uint(c.rv[r]);
  }
}

template <int NREF, int W>
__device__ __forceinline__ RefCandidates<NREF> unpack_refs(const RingWords<W>& x, int j0) {
  RefCandidates<NREF> c;
#pragma unroll
  for (int r = 0; r < NREF; ++r) {
    c.draw[r] = __uint_as_float(x.w[j0 + kRefWords * r]);
    c.rl[r] = __uint_as_float(x.w[j0 + kRefWords * r + 1]);
    c.rs[r] = __uint_as_float(x.w[j0 + kRefWords * r + 2]);
    c.rv[r] = __uint_as_float(x.w[j0 + kRefWords * r + 3]);
  }
  return c;
}

// A B6 bridge's action in the ring (the SCIM's and the synchronous
// family's random rollouts): the 3 bits in one word (finite), or the three
// duty commands' float bits (continuous).
template <bool FINITE>
__host__ __device__ constexpr int b6_ring_words() {
  return FINITE ? 1 : 3;
}

template <bool FINITE, int W>
__device__ __forceinline__ void pack_b6(const B6Action& a, int j0, RingWords<W>& x) {
  if constexpr (FINITE) {
    x.w[j0] = (uint32_t)a.bits;
  } else {
    x.w[j0] = __float_as_uint(a.a);
    x.w[j0 + 1] = __float_as_uint(a.b);
    x.w[j0 + 2] = __float_as_uint(a.c);
  }
}

template <bool FINITE, int W>
__device__ __forceinline__ B6Action unpack_b6(const RingWords<W>& x, int j0) {
  B6Action a;
  if constexpr (FINITE) {
    a.bits = (int)x.w[j0];
    a.a = a.b = a.c = 0.0f;
  } else {
    a.bits = 0;
    a.a = __uint_as_float(x.w[j0]);
    a.b = __uint_as_float(x.w[j0 + 1]);
    a.c = __uint_as_float(x.w[j0 + 2]);
  }
  return a;
}

// What step t of a B6 bridge's random rollout draws, whatever the state
// (the SCIM's and the synchronous family's): the action and (WIENER) the
// reference rows' candidates, in the one-thread step's operand order; in
// the ring the action's b6_ring_words, then kRefWords per row.
template <int NREF>
struct B6Draws {
  B6Action a;
  RefCandidates<NREF> c;
};

template <bool FINITE, int NREF>
__host__ __device__ constexpr int b6_draw_words() {
  return b6_ring_words<FINITE>() + kRefWords * NREF;
}

template <bool FINITE, int NREF, bool WIENER, class RC>
__device__ __forceinline__ B6Draws<NREF> b6_draws(const RC& k, uint2 key, uint32_t env,
                                                  uint32_t t, bool odd, float& zb) {
  B6Draws<NREF> d;
  const uint4 w = drive_draw(key, env, t, DRIVE_SLOT_STEP);
  d.a = b6_random_action<FINITE>(key, env, t, w);
  if constexpr (WIENER) d.c = ref_candidates<NREF>(k, key, env, t, w, odd, zb);
  return d;
}

template <bool FINITE, int NREF>
__device__ __forceinline__ RingWords<b6_draw_words<FINITE, NREF>()> b6_draws_pack(
    const B6Draws<NREF>& d) {
  RingWords<b6_draw_words<FINITE, NREF>()> x;
  pack_b6<FINITE>(d.a, 0, x);
  pack_refs<NREF>(d.c, b6_ring_words<FINITE>(), x);
  return x;
}

template <bool FINITE, int NREF>
__device__ __forceinline__ B6Draws<NREF> b6_draws_unpack(
    const RingWords<b6_draw_words<FINITE, NREF>()>& x) {
  B6Draws<NREF> d;
  d.a = unpack_b6<FINITE>(x, 0);
  d.c = unpack_refs<NREF>(x, b6_ring_words<FINITE>());
  return d;
}

// Consumer side: ref_wiener_advance with the draws and candidates of the
// step given, taken by selects: a regenerating row takes the candidate
// length and sigma, every row advances by its sigma times its draw within
// the margins, and a violating env's rows take the candidate reset values.
template <int NREF, class RC>
__device__ __forceinline__ void ref_advance_candidates(const RC& k, const RefCandidates<NREF>& c,
                                                       bool violated, RefRows<NREF>& refs) {
#pragma unroll
  for (int r = 0; r < NREF; ++r) {
    const bool regen = (refs.rk[r] >= refs.rl[r]) || violated;
    refs.rl[r] = regen ? c.rl[r] : refs.rl[r];
    refs.rs[r] = regen ? c.rs[r] : refs.rs[r];
    refs.rk[r] = (regen ? 0.0f : refs.rk[r]) + 1.0f;
    refs.rv[r] = fminf(fmaxf(refs.rv[r] + refs.rs[r] * c.draw[r], k.row[r][R_MLO]), k.row[r][R_MHI]);
    refs.rv[r] = violated ? c.rv[r] : refs.rv[r];
  }
}

// The ring's layout for the host: consumer and producer warps, K, slots,
// words a step, dynamic shared-memory bytes and the design the launch
// takes (0 warp-specialised; else one thread per env, which fills the
// rest).
enum RingLayout { RL_CONSUMER_WARPS = 0, RL_PRODUCER_WARPS, RL_K, RL_SLOTS, RL_WORDS, RL_BYTES,
                  RL_DESIGN, N_RING_LAYOUT };

inline void ring_layout_one_thread(int design, int* out) {
  for (int i = 0; i < N_RING_LAYOUT; ++i) out[i] = 0;
  out[RL_DESIGN] = design;
}

template <class S>
inline void ring_layout(int words, int* out) {
  out[RL_DESIGN] = 0;
  out[RL_CONSUMER_WARPS] = kConsumerWarps;
  out[RL_PRODUCER_WARPS] = S::P * kConsumerWarps;
  out[RL_K] = S::K;
  out[RL_SLOTS] = kRingSlots;
  out[RL_WORDS] = words;
  out[RL_BYTES] = ring_bytes<S>(words);
}
