// The shared-memory ring of the warp-specialised rollouts and recorders
// (draw_ring.cuh for the universal families' random rollouts and the DC,
// EESM, SRM, synchronous and SCIM random recorders, pmsm_ring.cuh for the
// Finite-CC-PMSM random rollout and recorder, the PMSM policy evaluation
// rollout and the FOC closed loop, fused_permex.cu, fused_dc_sc.cu,
// fused_scim_tc.cu, fused_eesm_cc.cu and fused_dfim_cc.cu for the
// specialised Finite-CC-PermExDc rollout and recorder and the Cont-SC DC,
// Cont-TC-SCIM, Finite-CC-EESM and Cont-CC-DFIM rollouts,
// fused_dc_cascade.cu for the DC speed cascade):
// producer warps compute every value of a step that does not
// depend on the state into a shared-memory ring, and consumer warps run
// the step, one thread per env, reading those values.  This header holds
// the roles, the double buffer and the named barriers, whatever a step
// draws; what the producers draw, and through which Philox slots, is the
// including kernel's (its Draw functor).
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

// setmaxnreg (sm_90a): a warpgroup (four consecutive warps, all of which
// execute it) raises or lowers its threads' register budget to N.  The
// consumer warps are warpgroup 0 of the block, the producers the rest.
template <int N>
__device__ __forceinline__ void ring_regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void ring_regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
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
