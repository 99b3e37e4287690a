// Universal DC-family fused rollouts for Hopper (sm_90a): the reducing
// rollout in random and buffer mode, over the shared step of dc_step.cuh,
// with a plain C interface for ctypes (every function returns
// cudaGetLastError()).  They serve the 24 {Finite, Cont} x {CC, TC, SC} x
// {PermExDc, SeriesDc, ShuntDc, ExtExDc} catalog ids at their defaults, and
// the finite and continuous 1QC and 2QC converters.  The recorders are in
// fused_dc_record.cu, a source of its own so that nvcc builds the two in
// parallel.
//
// Replaces (gym_electric_motor_tpu/ops/):
//   dc_rollout_random  pallas_dc.py  make_fused_dc_rollout, random mode (:1266)
//   dc_rollout_buffer  pallas_dc.py  make_fused_dc_rollout, buffer mode (:1240)
//
// Design.  Templates: FINITE, MECH (constant speed or the polynomial
// load's speed ODE), MC (the motor class) and NREF (1 or 2 reference rows;
// 2 only for ExtExDc at constant speed): 14 random and 12 buffer
// instances.  The drive state and the reference rows stay in registers
// across an in-kernel loop over T steps.  Random bits come from
// Philox4x32-10 keyed by the seed and counted by (env, step, slot).  The one-thread
// random kernel holds two loops, with and without the reference advance,
// and takes the second when every reference is constant.  Built with
// -fmad=false (ops/cuda_build.py), so each multiply and add rounds as in
// the plain PyTorch version.
//
// What bounded the one-thread random rollout on this card (PERF.md): its
// loop moves nothing, so the operations of a step bound it, and it reached
// 10% to 18% of that bound.  At 16384 envs one thread per env is 128
// blocks of four warps, one warp per scheduler, so nothing hid a
// dependent instruction's latency; and the blocks a step ran only when one
// of the warp's 32 envs needed them (the Box-Muller pair, the PARAMS draw
// with floorf and expf after a regeneration, the RESET draw after a
// violation) were larger than the step itself and sat on its dependent
// chain: at 3.6% of env-steps resetting, about 69% of warp-steps took
// them, at 33% all of them.  None of that work depends on the state.
//
// With Wiener references the random rollout is warp-specialised
// (dc_ring.cuh): four consumer warps run the step, one thread per env,
// and eight producer warps draw, in a double-buffered shared-memory ring of
// K = 4 steps a slot, every value of a step that depends on the constants
// alone: the sampled action (one word per converter channel) and per row
// the Box-Muller draw, the candidate length and sigma (PARAMS) and the
// candidate reset value (RESET), 5 to 10 words a step.  Two producer warps
// per consumer warp, each drawing two steps of a slot: with one, the
// consumers waited on the producers (PERF.md).  The consumer takes the
// candidates by selects.  A block is 128 envs on twelve warps, three per
// scheduler at 16384 envs.  With constant references a step draws only its
// action, and the launch takes the one-thread kernel, whose loop ran as
// fast as the warp-specialised one's and as one thread with the next
// step's action drawn ahead.  The same functions on the same operands make
// every design equal to the plain version bit for bit.
//
// tools/sass_ops.py counts the instructions a step always issues, per
// pipe, from the SASS.  chip_smoke.py takes its bounds from the one-thread
// step of the same instance, the function's own work (the one-thread
// kernel's Wiener loop is built for that count and never run); beside it,
// the count of both roles per env-step (the consumer's step plus a
// producer's two steps over two), what the warp-specialised kernel
// issues.  Every step loop is `#pragma unroll 1` and a producer's slot
// loop unrolls exactly its steps, so that one loop iteration is one step,
// or two, in the count.
#include <cuda_runtime.h>

#include "dc_ring.cuh"

namespace {

constexpr int kThreads = 128;

template <bool FINITE, bool MECH, int MC, int NREF, bool WIENER>
__device__ __forceinline__ void rollout_random_loop(const DcConst& k, uint2 key, int e,
                                                    int n_steps, DcState& x, RefRows<NREF>& refs,
                                                    float& reward, float& terms) {
#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) {
    const DcStepOut o = dc_random_step<FINITE, MECH, MC, NREF, WIENER>(k, key, (uint32_t)e,
                                                                       (uint32_t)t, x, refs);
    reward += o.reward;
    terms += o.done;
  }
}

template <bool FINITE, bool MECH, int MC, int NREF>
__global__ void dc_rollout_random_kernel(DcConst k, uint2 key, int n, int n_steps,
                                         const float* __restrict__ w0,
                                         const float* __restrict__ i00,
                                         const float* __restrict__ i10, float* __restrict__ out_w,
                                         float* __restrict__ out_i0, float* __restrict__ out_i1,
                                         float* __restrict__ out_reward,
                                         float* __restrict__ out_terms, float* __restrict__ out_rv,
                                         float* __restrict__ out_rk, float* __restrict__ out_rl,
                                         float* __restrict__ out_rs) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  DcState x = dc_load_state<MECH, MC>(w0, i00, i10, e);
  RefRows<NREF> refs;
  ref_wiener_init<NREF>(k.ref, key, (uint32_t)e, refs);
  float reward = 0.0f, terms = 0.0f;
  if (k.ref.all_const) {
    rollout_random_loop<FINITE, MECH, MC, NREF, false>(k, key, e, n_steps, x, refs, reward, terms);
  } else {
    rollout_random_loop<FINITE, MECH, MC, NREF, true>(k, key, e, n_steps, x, refs, reward, terms);
  }
  dc_store_state<MECH, MC>(x, out_w, out_i0, out_i1, (size_t)e);
  out_reward[e] = reward;
  out_terms[e] = terms;
  // final reference rows, (NREF * R, 128) planes: row 0 first
#pragma unroll
  for (int r = 0; r < NREF; ++r) {
    out_rv[(size_t)r * n + e] = refs.rv[r];
    out_rk[(size_t)r * n + e] = refs.rk[r];
    out_rl[(size_t)r * n + e] = refs.rl[r];
    out_rs[(size_t)r * n + e] = refs.rs[r];
  }
}

// ---- the warp-specialised random rollout ------------------------------

// One role of the warp-specialised kernel over the launch's steps.
template <bool FINITE, bool MECH, int MC, int NREF>
__device__ __forceinline__ void dc_ws_role(const DcConst& k, uint2 key, const RingThread& th,
                                           int n_steps, uint32_t* column, DcState& x,
                                           RefRows<NREF>& refs, float& reward, float& terms) {
  constexpr int W = dc_ring_words<MC, NREF>();
  const RingPipe<DcRing> pipe(n_steps);
  const RingView<W> v{column};
  const uint32_t env = (uint32_t)th.e;
  if (th.consumer) {
    ring_consume(pipe, v, n_steps, [&](const RingWords<W>& w) {
      dc_draw_step<FINITE, MECH, MC, NREF>(k, dc_unpack<FINITE, MC, NREF>(w), x, refs, reward,
                                           terms);
    });
  } else {
    ring_produce(pipe, v, th.part, [&](uint32_t t, bool odd, float& zb) {
      return dc_pack<FINITE, MC, NREF>(dc_draws<FINITE, MC, NREF>(k, key, env, t, odd, zb));
    });
  }
}

// The random rollout with Wiener references (with constant ones the
// launch takes dc_rollout_random_kernel).
template <bool FINITE, bool MECH, int MC, int NREF>
__global__ void __launch_bounds__(DcRing::kThreads)
    dc_rollout_ws_kernel(DcConst k, uint2 key, int n, int n_steps, const float* __restrict__ w0,
                         const float* __restrict__ i00, const float* __restrict__ i10,
                         float* __restrict__ out_w, float* __restrict__ out_i0,
                         float* __restrict__ out_i1, float* __restrict__ out_reward,
                         float* __restrict__ out_terms, float* __restrict__ out_rv,
                         float* __restrict__ out_rk, float* __restrict__ out_rl,
                         float* __restrict__ out_rs) {
  extern __shared__ uint32_t ring[];
  const RingThread th = ring_thread(n);
  uint32_t* const column = ring + th.le;
  const int e = th.e;
  DcState x = dc_load_state<MECH, MC>(w0, i00, i10, e);
  RefRows<NREF> refs;
  ref_wiener_init<NREF>(k.ref, key, (uint32_t)e, refs);
  float reward = 0.0f, terms = 0.0f;
  dc_ws_role<FINITE, MECH, MC, NREF>(k, key, th, n_steps, column, x, refs, reward, terms);
  if (!th.consumer || !th.live) return;
  dc_store_state<MECH, MC>(x, out_w, out_i0, out_i1, (size_t)e);
  out_reward[e] = reward;
  out_terms[e] = terms;
  // final reference rows, (NREF * R, 128) planes: row 0 first
#pragma unroll
  for (int r = 0; r < NREF; ++r) {
    out_rv[(size_t)r * n + e] = refs.rv[r];
    out_rk[(size_t)r * n + e] = refs.rk[r];
    out_rl[(size_t)r * n + e] = refs.rl[r];
    out_rs[(size_t)r * n + e] = refs.rs[r];
  }
}

template <bool FINITE, bool MECH, int MC>
__global__ void dc_rollout_buffer_kernel(DcConst k, int n, int n_steps,
                                         const float* __restrict__ w0,
                                         const float* __restrict__ i00,
                                         const float* __restrict__ i10,
                                         const int* __restrict__ act_i,
                                         const float* __restrict__ act_f, float* __restrict__ out_w,
                                         float* __restrict__ out_i0, float* __restrict__ out_i1) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  DcState x = dc_load_state<MECH, MC>(w0, i00, i10, e);
#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) {
    dc_physics<FINITE, MECH, MC>(k, dc_read_action<FINITE, MC>(act_i, act_f, n, t, e), x);
  }
  dc_store_state<MECH, MC>(x, out_w, out_i0, out_i1, (size_t)e);
}

int blocks(int n) { return (n + kThreads - 1) / kThreads; }

using RandomFn = void (*)(const DcConst&, uint2, int, int, const float* const*, float* const*,
                          cudaStream_t);
using BufferFn = void (*)(const DcConst&, int, int, const float* const*, const int*, const float*,
                          float* const*, cudaStream_t);

// Wiener references run the warp-specialised kernel; constant ones, which
// draw only the action, the one-thread kernel (its constant-reference loop
// ran as fast as the warp-specialised one's and as one thread with the next
// step's draws ahead, PERF.md).
template <bool F, bool M, int MC, int NR>
void launch_random(const DcConst& k, uint2 key, int n, int n_steps, const float* const* in,
                   float* const* out, cudaStream_t st) {
  if (k.ref.all_const) {
    dc_rollout_random_kernel<F, M, MC, NR><<<blocks(n), kThreads, 0, st>>>(
        k, key, n, n_steps, in[0], in[1], in[2], out[0], out[1], out[2], out[3], out[4], out[5],
        out[6], out[7], out[8]);
    return;
  }
  constexpr int bytes = ring_bytes<DcRing>(dc_ring_words<MC, NR>());
  if (bytes > 48 * 1024) {
    cudaFuncSetAttribute(dc_rollout_ws_kernel<F, M, MC, NR>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  }
  dc_rollout_ws_kernel<F, M, MC, NR><<<(n + kRingEnvs - 1) / kRingEnvs, DcRing::kThreads, bytes,
                                       st>>>(k, key, n, n_steps, in[0], in[1], in[2], out[0],
                                             out[1], out[2], out[3], out[4], out[5], out[6],
                                             out[7], out[8]);
}

template <bool F, bool M, int MC, int NR>
constexpr RandomFn random_fn() {
  if constexpr (dc_built<M, MC, NR>()) {
    return launch_random<F, M, MC, NR>;
  } else {
    return nullptr;
  }
}

template <bool F, bool M, int MC>
void launch_buffer(const DcConst& k, int n, int n_steps, const float* const* in, const int* act_i,
                   const float* act_f, float* const* out, cudaStream_t st) {
  dc_rollout_buffer_kernel<F, M, MC><<<blocks(n), kThreads, 0, st>>>(
      k, n, n_steps, in[0], in[1], in[2], act_i, act_f, out[0], out[1], out[2]);
}

#define DC_RANDOM_ROW(F, M)                                                            \
  random_fn<F, M, MC_ONE, 1>(), random_fn<F, M, MC_ONE, 2>(), random_fn<F, M, MC_SHUNT, 1>(), \
      random_fn<F, M, MC_SHUNT, 2>(), random_fn<F, M, MC_EXTEX, 1>(),                  \
      random_fn<F, M, MC_EXTEX, 2>()
#define DC_BUFFER_ROW(F, M) \
  launch_buffer<F, M, MC_ONE>, launch_buffer<F, M, MC_SHUNT>, launch_buffer<F, M, MC_EXTEX>

// indexed by dc_instance(); the buffer table by dc_instance() / 2
const RandomFn kRandom[24] = {DC_RANDOM_ROW(false, false), DC_RANDOM_ROW(false, true),
                              DC_RANDOM_ROW(true, false), DC_RANDOM_ROW(true, true)};
const BufferFn kBuffer[12] = {DC_BUFFER_ROW(false, false), DC_BUFFER_ROW(false, true),
                              DC_BUFFER_ROW(true, false), DC_BUFFER_ROW(true, true)};

}  // namespace

extern "C" {

int dc_n_const() { return N_DC_CONST; }
int dc_n_row_const() { return N_ROW_CONST; }
int dc_n_flag() { return N_DC_FLAG; }

const char* dc_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// in: (omega or NULL, i0, i1 or NULL); out: (omega or NULL, i0, i1 or NULL,
// reward, terms, rv, rk, rl, rs).  Returns cudaErrorInvalidValue for flags
// no instance serves.
int dc_rollout_random(const float* consts, const int* flags, unsigned long long seed, int n,
                      int n_steps, const float* const* in, float* const* out, void* stream) {
  const int idx = dc_instance(flags);
  if (idx < 0 || kRandom[idx] == nullptr) return (int)cudaErrorInvalidValue;
  kRandom[idx](dc_load_const(consts, flags), dc_seed_key(seed), n, n_steps, in, out,
               (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// The random rollout's ring for the instance and loop of these flags
// (draw_ring.cuh's RingLayout), or RL_DESIGN 1 and the rest zero where the
// launch runs one thread per env; cudaErrorInvalidValue for flags no
// instance serves.
int dc_ring_layout(const int* flags, int* out) {
  const int idx = dc_instance(flags);
  if (idx < 0 || kRandom[idx] == nullptr) return (int)cudaErrorInvalidValue;
  if (flags[DF_ALL_CONST]) {
    ring_layout_one_thread(1, out);
    return 0;
  }
  ring_layout<DcRing>((flags[DF_MCLASS] == MC_EXTEX ? 2 : 1) + kRefWords * flags[DF_NREF], out);
  return 0;
}

// actions: int32 (T, [2,] N) for a finite converter, float32 for a
// continuous one (the other pointer NULL); out: (omega or NULL, i0, i1 or
// NULL).
int dc_rollout_buffer(const float* consts, const int* flags, int n, int n_steps,
                      const float* const* in, const int* act_i, const float* act_f,
                      float* const* out, void* stream) {
  const int idx = dc_instance(flags);
  if (idx < 0) return (int)cudaErrorInvalidValue;
  kBuffer[idx / 2](dc_load_const(consts, flags), n, n_steps, in, act_i, act_f, out,
                   (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

}  // extern "C"
