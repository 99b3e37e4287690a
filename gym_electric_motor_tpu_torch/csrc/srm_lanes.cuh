// The phase-parallel SRM step at constant speed: one env on a group of four
// consecutive lanes of a warp, lane j < 3 owning phase j.  fused_srm.cu's
// random rollout runs it for its constant-speed instances (the CC and TC
// ids); its speed-ODE instances, the recorders, the buffer rollout, the
// cascade and the policy recorder keep the one-thread step of srm_step.cuh,
// whose per-phase helpers (srm_phase, srm_slope, srm_torque_term,
// srm_torque_sum, srm_fraction, srm_rotation_advance) this header calls.
//
// Lane map.  A group is lanes 4g .. 4g + 3 of a warp (eight envs a warp):
// lane j < 3 carries phase j's current, its inductance, its division and,
// with three references, reference row j; the fourth lane repeats phase c's
// instruction stream (its results are never read) and draws the ACTION_C
// Philox slot, so that every Philox call of a step runs at once, one per
// lane.  Four lanes and not three: the spare lane is the fourth Philox
// stream, the groups are aligned quads, and a three-lane group (ten envs a
// warp) has a fifth fewer warps to hide latency with.
// Lanes differ by data, never by code: the phase's offset (cos and sin of
// -2 pi / 3 j) is a register chosen by the lane, and a step has no branch
// on the lane.  Per-env work (the constant-speed rotation, the angle and
// its wrap, the reward, one reference row) runs on every lane of the group
// on the same operands, so it is bit-identical across the group.
//
// Why constant speed only.  Per-env work issues on all four lanes, so it
// costs four issue slots per env.  At constant speed it is small (a
// rotation and the Box-Muller pair), and four warps a scheduler, each
// lane with a chain of four divisions instead of twelve, hide the latency
// that bounds the one-thread step.  Under the speed ODE each RK4 stage adds
// a cosf / sinf pair and the load, all per env; on lane groups that step
// turned issue-bound and ran slower than one thread per env on an H100
// (PERF.md, slice 12).
//
// The phases meet only in sums, gathered into every lane by __shfl_sync
// and then added in the one-thread order: a torque reward's torque
// ((t_a + t_b) + t_c, srm_torque_sum), the violation OR over the three
// clamped currents, and with three references the WSE reward
// ((bias - e_0) - e_1) - e_2.  Every operation is the one of srm_step.cuh
// on the same operands, the divisions stay IEEE divisions, and the sources
// build with -fmad=false, so the kernel equals its plain PyTorch version
// (ops/fused_srm_family.py) bit for bit.
//
// The ragged edge: no thread leaves before its last shuffle (every shuffle
// takes the full mask); a lane past the last env computes on the last env
// and stores nothing.
#pragma once

#include <cstdint>

#include "srm_step.cuh"

constexpr int kSrmLanes = 4;                       // lanes per env
constexpr unsigned kSrmFullMask = 0xffffffffu;

// Where one thread sits: its env (clamped to the last), whether that env
// exists, its lane j in the group and the phase it owns (the fourth lane
// repeats phase c), and the phase-offset registers of that phase.
struct SrmLane {
  int env;
  bool live;
  int j, ph;
  bool pa;     // phase a: the pair itself, no offset
  float spj;   // sin of the offset: +sin(2 pi / 3) for phase b, - for c
};

__device__ __forceinline__ SrmLane srm_lane(const SrmConst& k, int n) {
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int e = tid / kSrmLanes;
  SrmLane L;
  L.j = tid % kSrmLanes;
  L.ph = min(L.j, 2);
  L.live = e < n;
  L.env = min(e, n - 1);
  L.pa = L.ph == 0;
  L.spj = L.ph == 1 ? k.v[S_SIN_PHI] : -k.v[S_SIN_PHI];
  return L;
}

// A value of lane `from` of this thread's group.
template <typename T>
__device__ __forceinline__ T srm_from(T v, int from) {
  return __shfl_sync(kSrmFullMask, v, from, kSrmLanes);
}

// The lane's phase from (cos eps, sin eps) = (ce, se), as srm_phases turns
// it.
template <bool SAT>
__device__ __forceinline__ SrmPhase srm_lane_phase(const SrmConst& k, const SrmLane& L, float ce,
                                                   float se, float i) {
  return srm_phase<SAT>(k, L.pa ? se : se * -0.5f - ce * L.spj,
                        L.pa ? ce : ce * -0.5f + se * L.spj, i);
}

// srm_physics at constant speed for the lane's phase voltage u: RK4 from
// the carried rotation (c, s), the diode clamp, the wrap.  (i, eps): the
// lane's current and the env's angle.
template <bool SAT>
__device__ __forceinline__ void srm_lane_physics(const SrmConst& k, const SrmLane& L, float u,
                                                 float c, float s, float& i, float& eps) {
  const float h = k.v[S_HALF_TAU], dt = k.v[S_TAU], sixth = k.v[S_SIXTH];
  const float ch = c * k.v[S_CH] - s * k.v[S_SH];
  const float sh = s * k.v[S_CH] + c * k.v[S_SH];
  const float cf = c * k.v[S_COS_D] - s * k.v[S_SIN_D];
  const float sf = s * k.v[S_COS_D] + c * k.v[S_SIN_D];
  const float w = k.v[S_W_FIXED];
  const float k1 = srm_slope<SAT>(k, u, i, w, srm_lane_phase<SAT>(k, L, c, s, i));
  const float i2 = i + h * k1;
  const float k2 = srm_slope<SAT>(k, u, i2, w, srm_lane_phase<SAT>(k, L, ch, sh, i2));
  const float i3 = i + h * k2;
  const float k3 = srm_slope<SAT>(k, u, i3, w, srm_lane_phase<SAT>(k, L, ch, sh, i3));
  const float i4 = i + dt * k3;
  const float k4 = srm_slope<SAT>(k, u, i4, w, srm_lane_phase<SAT>(k, L, cf, sf, i4));
  const float de = k.v[S_PW];
  eps = eps + sixth * (de + 2.0f * (de + de) + de);
  const float i_new = i + sixth * (k1 + 2.0f * (k2 + k3) + k4);
  i = i_new < 0.0f ? 0.0f : i_new;
  eps = eps - k.v[S_TWO_PI] * floorf((eps + k.v[S_PI]) * k.v[S_INV_TWO_PI]);
}

// The reference row a lane carries: with three references row j on lane
// j (the fourth lane repeats row 2), with one the single row on every
// lane.  The row's constants sit in registers.
struct SrmLaneRow {
  int r;         // the row's index
  int code;      // SrmQuantity
  float coef, inv_lim, mlo, mhi, ep_lo, ep_span, sig_base, sig_span;
};

struct SrmLaneRef {
  float rv, rk, rl, rs, zb;
};

template <int NREF>
__device__ __forceinline__ SrmLaneRow srm_lane_row(const SrmConst& k, const SrmLane& L) {
  SrmLaneRow row;
  row.r = NREF == kSrmRows ? L.ph : 0;
  // selects, not an index into the parameter block
  float c[N_ROW_CONST];
#pragma unroll
  for (int j = 0; j < N_ROW_CONST; ++j) c[j] = k.ref.row[0][j];
  row.code = k.flag[SF_QTY0];
#pragma unroll
  for (int r = 1; r < NREF; ++r) {
#pragma unroll
    for (int j = 0; j < N_ROW_CONST; ++j) c[j] = row.r == r ? k.ref.row[r][j] : c[j];
    row.code = row.r == r ? k.flag[SF_QTY0 + r] : row.code;
  }
  row.coef = c[R_COEF];
  row.inv_lim = c[R_INV_LIM];
  row.mlo = c[R_MLO];
  row.mhi = c[R_MHI];
  row.ep_lo = c[R_EP_LO];
  row.ep_span = c[R_EP_SPAN];
  row.sig_base = c[R_SIG_BASE];
  row.sig_span = c[R_SIG_SPAN];
  return row;
}

// ref_wiener_init, taken on every lane, and the lane's row of it.
template <int NREF>
__device__ __forceinline__ SrmLaneRef srm_lane_ref_init(const SrmConst& k, uint2 key,
                                                        const SrmLane& L, const SrmLaneRow& row) {
  RefRows<NREF> refs;
  ref_wiener_init<NREF>(k.ref, key, (uint32_t)L.env, refs);
  SrmLaneRef ref;
  ref.rv = refs.rv[0];
  ref.rk = refs.rk[0];
  ref.rl = refs.rl[0];
  ref.rs = refs.rs[0];
#pragma unroll
  for (int r = 1; r < NREF; ++r) {
    ref.rv = row.r == r ? refs.rv[r] : ref.rv;
    ref.rk = row.r == r ? refs.rk[r] : ref.rk;
    ref.rl = row.r == r ? refs.rl[r] : ref.rl;
    ref.rs = row.r == r ? refs.rs[r] : ref.rs;
  }
  ref.zb = refs.zb;
  return ref;
}

// ref_wiener_advance for the lane's row.  `own` is the lane's Philox draw
// of the step, the ROW2 slot on row 2 with three references; (wy, wz) the
// step slot's Box-Muller pair.  Row 1 takes the sine of the step's pair,
// rows 0 and 2 a cosine; a regenerating row draws the PARAMS slot (row 2
// its length and sigma from ROW2's z and w), a violation the RESET slot.
template <int NREF>
__device__ __forceinline__ void srm_lane_wiener_advance(const SrmConst& k, uint2 key,
                                                        uint32_t env, uint32_t t,
                                                        const SrmLaneRow& row, uint4 own,
                                                        uint32_t wy, uint32_t wz, bool violated,
                                                        SrmLaneRef& ref) {
  const RefConstN<kSrmRows>& rc = k.ref;
  float draw;
  if (NREF == kSrmRows) {
    const bool pair2 = row.r == 2;
    const float rad = sqrtf(-2.0f * logf(fmaxf(uniform24(pair2 ? own.x : wy), rc.u_min)));
    const float theta = rc.two_pi * uniform24(pair2 ? own.y : wz);
    const float ct = cosf(theta), st = sinf(theta);
    draw = rad * (row.r == 1 ? st : ct);
  } else if ((t & 1u) == 0u) {
    const float rad = sqrtf(-2.0f * logf(fmaxf(uniform24(wy), rc.u_min)));
    const float theta = rc.two_pi * uniform24(wz);
    draw = rad * cosf(theta);
    ref.zb = rad * sinf(theta);
  } else {
    draw = ref.zb;
  }
  const bool regen = (ref.rk >= ref.rl) || violated;
  if (regen) {
    const uint4 p = drive_draw(key, env, t, DRIVE_SLOT_PARAMS);
    const uint32_t b_len = row.r == 2 ? own.z : (row.r ? p.y : p.x);
    const uint32_t b_sig = row.r == 2 ? own.w : (row.r ? p.w : p.z);
    ref.rl = floorf(row.ep_lo + row.ep_span * uniform24(b_len));
    ref.rs = expf(rc.ln10 * (row.sig_base + row.sig_span * uniform24(b_sig)));
  }
  ref.rk = (regen ? 0.0f : ref.rk) + 1.0f;
  ref.rv = fminf(fmaxf(ref.rv + ref.rs * draw, row.mlo), row.mhi);
  if (violated) {
    const uint4 q = drive_draw(key, env, t, DRIVE_SLOT_RESET);
    ref.rv = row.mlo + (row.mhi - row.mlo) * uniform24(row.r == 2 ? q.z : (row.r ? q.y : q.x));
  }
}

// srm_action_step at constant speed for the lane's phase voltage u:
// physics from the carried rotation (c, s), the violation OR over the three
// gathered currents, the WSE reward against the pre-advance references
// (with three, each lane's row term gathered; a torque row takes cosf and
// sinf of the wrapped angle afresh and the three terms gathered), the
// reset of the whole group and the rotation advance.  Constant speed has
// no omega row (SrmConsts rejects it).  Returns the reward; `violated` is
// the same on every lane of the group.
template <int NREF, bool SAT>
__device__ __forceinline__ float srm_lane_action_step(const SrmConst& k, const SrmLane& L, float u,
                                                      float& i, float& eps, float& c, float& s,
                                                      const SrmLaneRow& row,
                                                      const SrmLaneRef& ref, bool& violated) {
  float yi = i, yeps = eps;
  srm_lane_physics<SAT>(k, L, u, c, s, yi, yeps);
  const float ia = srm_from(yi, 0), ib = srm_from(yi, 1), ic = srm_from(yi, 2);
  const float il = k.v[S_INV_ILIM];
  violated = !k.flag[SF_NO_CONS]
      && (fabsf(ia) * il > 1.0f || fabsf(ib) * il > 1.0f || fabsf(ic) * il > 1.0f);
  float tq = 0.0f;
  if (k.flag[SF_NEEDS_TORQUE]) {
    const float term = srm_torque_term<SAT>(
        k, yi, srm_lane_phase<SAT>(k, L, cosf(yeps), sinf(yeps), yi));
    tq = srm_torque_sum<SAT>(k, srm_from(term, 0), srm_from(term, 1), srm_from(term, 2));
  }
  // srm_quantity of the lane's row
  float q = ia;
  q = row.code == SQ_I_B ? ib : q;
  q = row.code == SQ_I_C ? ic : q;
  q = row.code == SQ_TORQUE ? tq : q;
  const float err = row.coef * fabsf(q * row.inv_lim - ref.rv);
  float wse;
  if (NREF == kSrmRows) {
    const float e0 = srm_from(err, 0), e1 = srm_from(err, 1), e2 = srm_from(err, 2);
    wse = k.v[S_BIAS] - e0 - e1 - e2;
  } else {
    wse = k.v[S_BIAS] - err;
  }
  i = violated ? 0.0f : yi;
  eps = violated ? 0.0f : yeps;
  srm_rotation_advance(k, violated, c, s);
  return violated ? k.v[S_VIOLATION_REWARD] : wse;
}

// ---- load and store -------------------------------------------------------

// Lane j < 3 of a live group stores its phase's current and, with three
// references, its row; lane 0 the angle, the reward sums (and the single
// row).
template <int NREF>
__device__ __forceinline__ void srm_lane_store(const SrmLane& L, int n, float i, float eps,
                                               float reward, float terms, const SrmLaneRef& ref,
                                               const SrmPlanes& out, float* const* red) {
  if (!L.live || L.j >= 3) return;
  const size_t e = (size_t)L.env;
  (L.j == 0 ? out.p[1] : (L.j == 1 ? out.p[2] : out.p[3]))[e] = i;
  const bool row_lane = NREF == kSrmRows || L.j == 0;
  if (row_lane) {
    const size_t at = (size_t)(NREF == kSrmRows ? L.j : 0) * n + e;
    red[2][at] = ref.rv;
    red[3][at] = ref.rk;
    red[4][at] = ref.rl;
    red[5][at] = ref.rs;
  }
  if (L.j == 0) {
    out.p[4][e] = eps;
    red[0][e] = reward;
    red[1][e] = terms;
  }
}

// Threads and blocks of a launch: kSrmLanes threads per env, and at
// least four blocks of 128 on an SM (16 warps: at most 128 registers).
constexpr int kSrmLaneThreads = 128;
constexpr int kSrmLaneMinBlocks = 4;

inline int srm_lane_blocks(int n) {
  return (int)(((long long)n * kSrmLanes + kSrmLaneThreads - 1) / kSrmLaneThreads);
}
