// The machinery the universal family steps share (sync_step.cuh for PMSM /
// SynRM, dc_step.cuh for the DC motors, induction_step.cuh for the SCIM,
// eesm_step.cuh for the EESM, dfim_step.cuh for the DFIM):
// the Philox draw slots, the reference rows with their Wiener process, the
// Box-Muller pair and the WSE reward at power 1, the polynomial static load,
// and the B6 bridge's actions and voltage fractions.
//
// Replaces the parts of gym_electric_motor_tpu/ops/pallas_common.py that the
// universal builders call: _make_wiener (:1095-1443, 'wiener' and 'const'
// rows: the n_ref = 2 spatial Box-Muller pair, the n_ref = 3 two pairs and
// the n_ref = 1 temporal pair :1379-1404), _wse_err (:912-925, power 1), _make_fused_mech's
// 'poly' mode (:662-689) and _make_b6 (:773-821, finite, and cont with no
// interlock).  The plain PyTorch version of the same arithmetic, in the
// same order, is in gym_electric_motor_tpu_torch/ops/fused_common.py
// (wiener_init, reference_step, wse_err, poly_load_rhs, b6_fractions).
#pragma once

#include <cstdint>

#include "philox.cuh"

// Per reference row (one referenced state).
enum RefRowIndex {
  R_COEF = 0,    // WSE weight / state length
  R_INV_LIM,     // 1 / limit of the referenced state
  R_MLO,         // margins of the reference value
  R_MHI,
  R_EP_LO,       // sub-episode length ~ floor(U[ep_lo, ep_lo + ep_span))
  R_EP_SPAN,
  R_SIG_BASE,    // sigma = 10^(sig_base + sig_span * U)
  R_SIG_SPAN,
  N_ROW_CONST
};

// The reference constants of one env, as float32 from the host, for up to
// NROWS reference rows.
template <int NROWS>
struct RefConstN {
  float row[NROWS][N_ROW_CONST];
  float two_pi, ln10;
  float u_min;     // guard before the Box-Muller log
  int all_const;   // every reference constant: no reference draws at all
};

// The families with at most two reference rows; the EESM's three current
// references take RefConstN<3>.
using RefConst = RefConstN<2>;

// Draw slots of the universal families: the Philox counter of one call is
// (env, step, slot, 0), with the numbering of pmsm_step.cuh's PmsmSlot.  A
// third reference row draws from slots of its own, so the one- and two-row
// instances draw what they drew before it existed.
enum DriveSlot {
  DRIVE_SLOT_STEP = 0,      // (action 0, box-muller u1, box-muller u2, action 1)
  DRIVE_SLOT_PARAMS = 1,    // (length row 0, length row 1, sigma row 0, sigma row 1)
  DRIVE_SLOT_RESET = 2,     // (reset value row 0, row 1, row 2, -)
  DRIVE_SLOT_INIT_A = 3,    // at step 0: (value row 0, value row 1, length row 0, length row 1)
  DRIVE_SLOT_INIT_B = 4,    // at step 0: (sigma row 0, sigma row 1, -, -)
  DRIVE_SLOT_ACTION_C = 8,  // the B6 bridge's third duty, the EESM's excitation duty and
                            // the DFIM's rotor duties: (action 2, action 3, action 4, action 5)
  DRIVE_SLOT_ROW2 = 9,      // three rows: (box-muller u1 of pair 2, u2 of pair 2,
                            // length row 2, sigma row 2)
  DRIVE_SLOT_INIT_C = 10    // three rows, at step 0: (value row 2, length row 2, sigma row 2, -)
};

__device__ __forceinline__ uint4 drive_draw(uint2 key, uint32_t env, uint32_t t, uint32_t slot) {
  return philox4x32_10(make_uint4(env, t, slot, 0u), key);
}

// The reference rows of one env: value, steps since regeneration, sub-
// episode length, sigma; zb carries the sine half of a single reference's
// Box-Muller pair to the next (odd) step.
template <int NREF>
struct RefRows {
  float rv[NREF], rk[NREF], rl[NREF], rs[NREF];
  float zb;
};

template <class RC>
__device__ __forceinline__ void ref_params(const RC& k, int r, uint32_t b_len, uint32_t b_sig,
                                           float& rl, float& rs) {
  rl = floorf(k.row[r][R_EP_LO] + k.row[r][R_EP_SPAN] * uniform24(b_len));
  rs = expf(k.ln10 * (k.row[r][R_SIG_BASE] + k.row[r][R_SIG_SPAN] * uniform24(b_sig)));
}

template <class RC>
__device__ __forceinline__ float ref_uniform_value(const RC& k, int r, uint32_t b) {
  return k.row[r][R_MLO] + (k.row[r][R_MHI] - k.row[r][R_MLO]) * uniform24(b);
}

// The reference rows at step 0.  All-constant references draw nothing.
template <int NREF, class RC>
__device__ __forceinline__ void ref_wiener_init(const RC& k, uint2 key, uint32_t env,
                                                RefRows<NREF>& refs) {
  refs.zb = 0.0f;
  if (k.all_const) {
#pragma unroll
    for (int r = 0; r < NREF; ++r) {
      refs.rv[r] = k.row[r][R_MLO];
      refs.rk[r] = 0.0f;
      refs.rl[r] = 1e9f;
      refs.rs[r] = 0.0f;
    }
    return;
  }
  const uint4 a = drive_draw(key, env, 0u, DRIVE_SLOT_INIT_A);
  const uint4 b = drive_draw(key, env, 0u, DRIVE_SLOT_INIT_B);
  uint4 c = make_uint4(0u, 0u, 0u, 0u);
  if constexpr (NREF == 3) c = drive_draw(key, env, 0u, DRIVE_SLOT_INIT_C);
#pragma unroll
  for (int r = 0; r < NREF; ++r) {
    refs.rv[r] = ref_uniform_value(k, r, r == 2 ? c.x : (r ? a.y : a.x));
    refs.rk[r] = 0.0f;
    ref_params(k, r, r == 2 ? c.y : (r ? a.w : a.z), r == 2 ? c.z : (r ? b.y : b.x), refs.rl[r],
               refs.rs[r]);
  }
}

// The Wiener advance of every row: the step's Box-Muller pair (w.y, w.z)
// feeds both rows (n_ref = 2) or, for one row, is drawn at even steps and
// its cosine used there, its sine at the next odd step; three rows take the
// step's pair for rows 0 and 1 and the cosine of a second pair, from the
// ROW2 slot, for row 2 (cos, sin, cos, as pallas_common.py:1379-1389).
// Sub-episode regeneration and the reset value of a violating env draw
// their slots only where they are used.
template <int NREF, class RC>
__device__ __forceinline__ void ref_wiener_advance(const RC& k, uint2 key, uint32_t env,
                                                   uint32_t t, uint4 w, bool violated,
                                                   RefRows<NREF>& refs) {
  float draw[NREF];
  uint4 x = make_uint4(0u, 0u, 0u, 0u);  // three rows: the ROW2 slot's words
  if constexpr (NREF == 3) {
    x = drive_draw(key, env, t, DRIVE_SLOT_ROW2);
    const float rad = sqrtf(-2.0f * logf(fmaxf(uniform24(w.y), k.u_min)));
    const float theta = k.two_pi * uniform24(w.z);
    draw[0] = rad * cosf(theta);
    draw[1] = rad * sinf(theta);
    const float rad2 = sqrtf(-2.0f * logf(fmaxf(uniform24(x.x), k.u_min)));
    draw[2] = rad2 * cosf(k.two_pi * uniform24(x.y));
  } else if (NREF == 2 || (t & 1u) == 0u) {
    const float rad = sqrtf(-2.0f * logf(fmaxf(uniform24(w.y), k.u_min)));
    const float theta = k.two_pi * uniform24(w.z);
    draw[0] = rad * cosf(theta);
    if (NREF == 2) {
      draw[NREF - 1] = rad * sinf(theta);
    } else {
      refs.zb = rad * sinf(theta);
    }
  } else {
    draw[0] = refs.zb;
  }
  bool regen[NREF];
  bool any = false;
#pragma unroll
  for (int r = 0; r < NREF; ++r) {
    regen[r] = (refs.rk[r] >= refs.rl[r]) || violated;
    any = any || regen[r];
  }
  if (any) {
    const uint4 p = drive_draw(key, env, t, DRIVE_SLOT_PARAMS);
#pragma unroll
    for (int r = 0; r < NREF; ++r) {
      if (regen[r]) {
        ref_params(k, r, r == 2 ? x.z : (r ? p.y : p.x), r == 2 ? x.w : (r ? p.w : p.z),
                   refs.rl[r], refs.rs[r]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < NREF; ++r) {
    refs.rk[r] = (regen[r] ? 0.0f : refs.rk[r]) + 1.0f;
    refs.rv[r] = fminf(fmaxf(refs.rv[r] + refs.rs[r] * draw[r], k.row[r][R_MLO]), k.row[r][R_MHI]);
  }
  if (violated) {
    const uint4 q = drive_draw(key, env, t, DRIVE_SLOT_RESET);
#pragma unroll
    for (int r = 0; r < NREF; ++r) {
      refs.rv[r] = ref_uniform_value(k, r, r == 2 ? q.z : (r ? q.y : q.x));
    }
  }
}

// The WSE reward at power 1 against the pre-advance references: bias minus
// coef * |q - ref| per row, in row order (q1 is read with two or three
// rows, q2 with three).
template <int NREF, class RC>
__device__ __forceinline__ float ref_wse(const RC& k, float bias, float q0, float q1,
                                         const RefRows<NREF>& refs, float q2 = 0.0f) {
  float wse = bias - k.row[0][R_COEF] * fabsf(q0 - refs.rv[0]);
  if (NREF >= 2) wse = wse - k.row[1][R_COEF] * fabsf(q1 - refs.rv[NREF > 1 ? 1 : 0]);
  if (NREF == 3) wse = wse - k.row[NREF - 1][R_COEF] * fabsf(q2 - refs.rv[NREF - 1]);
  return wse;
}

// PolynomialStaticLoad: d omega / dt with the a-term linearised below
// omega_lin.  The sign is written out: 0 at w = 0, as jnp.sign.
__device__ __forceinline__ float poly_load_rhs(float load_a, float load_b, float load_c,
                                               float omega_lin, float jt_over_td, float inv_jt,
                                               float w, float t_e) {
  const float sign = w > 0.0f ? 1.0f : (w < 0.0f ? -1.0f : 0.0f);
  const float a_term = fabsf(w) > omega_lin ? sign * load_a : jt_over_td * w;
  const float t_load = sign * load_c * w * w + load_b * w + a_term;
  return (t_e - t_load) * inv_jt;
}

// A B6 bridge's action: 3 bits (finite) or 3 duty commands (continuous).
struct B6Action {
  int bits;
  float a, b, c;
};

// The phase voltages as fractions of the supply voltage.  Finite: phase k
// is high iff bit (2 - k) of the action is set, minus 1/2; continuous with
// no interlock: half the duty, no clip (pallas_common.py:798-799).
template <bool FINITE>
__device__ __forceinline__ void b6_fractions(const B6Action& act, float& fa, float& fb,
                                             float& fc) {
  if (FINITE) {
    fa = (float)((act.bits >> 2) & 1) - 0.5f;
    fb = (float)((act.bits >> 1) & 1) - 0.5f;
    fc = (float)(act.bits & 1) - 0.5f;
  } else {
    fa = 0.5f * act.a;
    fb = 0.5f * act.b;
    fc = 0.5f * act.c;
  }
}

// The B6 action of a step's words: finite, the low 3 bits of the SLOT_STEP
// word w.x; continuous, 2 u - 1 from w.x, w.w and the ACTION_C slot's first
// word c.
template <bool FINITE>
__device__ __forceinline__ B6Action b6_action_of_words(uint4 w, uint32_t c) {
  B6Action act;
  if (FINITE) {
    act.bits = (int)(w.x & 7u);
    act.a = act.b = act.c = 0.0f;
  } else {
    act.bits = 0;
    act.a = 2.0f * uniform24(w.x) - 1.0f;
    act.b = 2.0f * uniform24(w.w) - 1.0f;
    act.c = 2.0f * uniform24(c) - 1.0f;
  }
  return act;
}

// The random action of a step from its SLOT_STEP words w (continuous: and
// the ACTION_C slot).
template <bool FINITE>
__device__ __forceinline__ B6Action b6_random_action(uint2 key, uint32_t env, uint32_t t, uint4 w) {
  return b6_action_of_words<FINITE>(
      w, FINITE ? 0u : drive_draw(key, env, t, DRIVE_SLOT_ACTION_C).x);
}

// The buffer step's action at step t: int32 (T, N) bits, or float32
// (T, 3, N) duty commands.
template <bool FINITE>
__device__ __forceinline__ B6Action b6_read_action(const int* __restrict__ act_i,
                                                   const float* __restrict__ act_f, int n, int t,
                                                   int e) {
  B6Action a;
  if (FINITE) {
    a.bits = act_i[(size_t)t * n + e];
    a.a = a.b = a.c = 0.0f;
  } else {
    const size_t base = (size_t)t * 3 * n + e;
    a.bits = 0;
    a.a = act_f[base];
    a.b = act_f[base + n];
    a.c = act_f[base + 2 * (size_t)n];
  }
  return a;
}
