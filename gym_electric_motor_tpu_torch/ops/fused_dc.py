"""The specialised DC fused rollouts: Finite-CC-PermExDc (the reducing
rollout and the trajectory recorder) and Cont-SC-SeriesDc / ShuntDc, each
in a random-action and an action-buffer mode.

Counterpart of ``_PermExCtx``, ``make_fused_permex_rollout``,
``make_fused_permex_record_rollout`` and ``make_fused_dc_sc_rollout`` in
``gym_electric_motor_tpu/ops/pallas_dc.py``.  Six kernels written in CUDA
carry the work on the GPU:

=========================  ===================================================
``permex_rollout_random``  T random 4QC steps of Finite-CC-PermExDc, reduced
                           (``csrc/fused_permex.cu``; warp-specialised:
                           producer warps draw each step's words into a
                           shared-memory ring, consumer warps step the envs)
``permex_rollout_buffer``  T steps of a given action buffer, the final current
``permex_record_random``   the random step, every step recorded (on a ring
                           of its own, 5 words a step)
``permex_record_buffer``   the buffer step, every step recorded
``dc_sc_rollout_random``   T random duty steps of Cont-SC-SeriesDc or
                           Cont-SC-ShuntDc, reduced (``csrc/fused_dc_sc.cu``)
``dc_sc_rollout_buffer``   T steps of a given duty buffer
=========================  ===================================================

They serve ids the universal DC kernels (``fused_dc_family.py``) serve too.
The PermExDc step is theirs (``dc_physics`` here and in csrc/dc_step.cuh,
with the family's constants of the env); the SC step keeps its own
right-hand side, which rounds as the JAX kernel's and not as the family's.
Both keep the JAX builders' own reward, references, draw order and Wiener
scheme:
the rollouts draw one Box-Muller pair every second step and keep its sine
for the odd step, the recorder draws a fresh pair each step.  Each kernel
has a plain PyTorch version here (``*_plain``) with the same arithmetic in
the same order and the same Philox bits (``fused_common.SlotBits``; the
slots are named in the CUDA sources); it takes ``bits=``, an object of the
same interface, so that a test replays the JAX interpret kernels'
xorshift.  A wrapper runs the plain version only for tensors on the CPU;
for CUDA tensors it launches the kernel, counts the launch in
``LAUNCHES``, or raises.

The builders keep the JAX builders' signatures and ``(n_envs // 128, 128)``
planes; ``chunk`` of the recorder only sets the step blocks of the JAX
kernel's per-chunk reseed, which the Philox counters do not need.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .fused_common import (LANE, RING_LAYOUT_FIELDS, ROW_NAMES, SPEC_SLOT_INIT_0,
                           SPEC_SLOT_PARAMS, SPEC_SLOT_STEP, SlotBits, TWO_PI, box_muller,
                           check_planes, check_rollout_inputs, check_tensor, fused_check_system,
                           launch_kernel, named_ring_layout, pack_consts,
                           poly_load_rhs, ptr_array, require, require_lanes,
                           require_specialised_defaults, seed_u64, shaped_words, spec_library,
                           spec_params, spec_row_walk, specialised_load, specialised_u_sup,
                           uniform_from_bits)
from .fused_dc_family import CONST_NAMES, FLAG_NAMES, DcConsts, dc_physics

KERNELS = ("permex_rollout_random", "permex_rollout_buffer", "permex_record_random",
           "permex_record_buffer", "dc_sc_rollout_random", "dc_sc_rollout_buffer")

# launches of each CUDA kernel since the last reset_launches()
LAUNCHES = dict.fromkeys(KERNELS, 0)


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# the PermExDc random rollout's ring (PermexRing in csrc/fused_permex.cu): K
# steps a slot, producer warps per consumer warp; and the words of a step
PERMEX_RING = (8, 2)
PERMEX_RING_WORDS = 5
# the random recorder's ring (PermexRecordRing in csrc/fused_permex.cu), with
# the rollout's 5 words a step
PERMEX_RECORD_RING = (8, 2)


# the bit layouts of csrc/fused_permex.cu and csrc/fused_dc_sc.cu: role ->
# (slot, word)
DC_INIT_WORDS = {"value": (SPEC_SLOT_INIT_0, 0), "len": (SPEC_SLOT_INIT_0, 1),
                 "sig": (SPEC_SLOT_INIT_0, 2)}
DC_STEP_WORDS = {"action": (SPEC_SLOT_STEP, 0), "u1": (SPEC_SLOT_STEP, 1),
                 "u2": (SPEC_SLOT_STEP, 2), "len": (SPEC_SLOT_PARAMS, 0),
                 "sig": (SPEC_SLOT_PARAMS, 1), "reset": (SPEC_SLOT_PARAMS, 2)}


def dc_bits(seed, n, device):
    """The Philox bit source of the four random DC kernels."""
    return SlotBits(seed, n, device, DC_INIT_WORDS, DC_STEP_WORDS)


# ---------------------------------------------------------------------------
# Finite-CC-PermExDc
# ---------------------------------------------------------------------------


class PermexConsts:
    """The baked constants of a Finite-CC-PermExDc env (``_PermExCtx``,
    pallas_dc.py:54-91): ``dc`` the DC family's physics constants of the
    env (``DcConsts(env, physics_only=True)``, the arrays
    csrc/dc_step.cuh's ``DcConst`` takes), and the builder's own in
    ``PermexConstIndex`` order of csrc/fused_permex.cu (``host`` for the
    kernel, ``f`` as Python floats).  The Wiener constants are the
    builder's own, not the env's reference generator's: lengths
    floor(U[500, 2000)), sigma 10^U[-2, -1], the margin nominal / limit of
    i.  The kernel bakes the 4QC table: another converter raises."""

    NAMES = ("inv_i_lim", "neg_w", "violation_reward", "margin", "ep_lo", "ep_span", "sig_base",
             "sig_span", "ln10", "u_min", "two_pi")
    state_names = ("i",)
    n_state = 1

    def __init__(self, env):
        ps = env.physical_system
        names = list(ps.state_names)
        i_lim = float(np.asarray(ps.limits)[names.index("i")])
        specialised_load(ps, ("ConstantSpeedLoad",))
        specialised_u_sup(ps)
        if ps.converter.kind != "Finite-4QC":
            raise NotImplementedError(
                f"the specialised PermExDc kernel bakes the Finite-4QC table; got "
                f"{ps.converter.kind!r}: use make_fused_rollout (the universal dispatch)")
        self.dc = DcConsts(env, physics_only=True)
        pack_consts(self, self.NAMES, dict(
            inv_i_lim=1.0 / i_lim, neg_w=-1.0 / 2.0, violation_reward=-1.0 / (1.0 - 0.9),
            margin=float(ps.nominal_state[names.index("i")] / i_lim),
            ep_lo=500.0, ep_span=1500.0, sig_base=-2.0, sig_span=1.0,
            ln10=np.log(10.0), u_min=1e-12, two_pi=TWO_PI))


def permex_physics(c: PermexConsts, i, a):
    """The 4QC voltage table (action 1: +u_sup, 2: -u_sup, else 0), then one
    RK4 step of the armature current (``_PermExCtx.step_physics``): the DC
    family's ``dc_physics`` at constant speed."""
    return dc_physics(c.dc, (a, None), {"i0": i})["i0"]


def _value(k, b, scale, offset):
    """A reference value from one word: ``(scale U - offset) margin``."""
    return (scale * uniform_from_bits(b) - offset) * k["margin"]


def _ref_init(k, w, scale, offset):
    rl, rs = spec_params(k, w["len"], w["sig"])
    return {"rv": _value(k, w["value"], scale, offset), "rk": torch.zeros_like(rl),
            "rl": rl, "rs": rs}


def _ref_advance(k, ref, violated, draw, w, lo, hi, scale, offset):
    """The one reference row's advance (``px_ref_advance``,
    ``dcsc_ref_advance``), in place."""
    regen = (ref["rk"] >= ref["rl"]) | violated
    rl, rs = spec_params(k, w["len"], w["sig"])
    spec_row_walk(ref, regen, rl, rs, draw, lo, hi)
    ref["rv"] = torch.where(violated, _value(k, w["reset"], scale, offset), ref["rv"])


def _px_action_step(c, a, i, ref):
    k = c.f
    i_new = permex_physics(c, i, a)
    i_n = i_new * k["inv_i_lim"]
    violated = torch.abs(i_n) > 1.0
    reward = torch.where(violated, torch.full_like(i_n, k["violation_reward"]),
                         k["neg_w"] * torch.abs(i_n - ref["rv"]))
    return torch.where(violated, torch.zeros_like(i_new), i_new), reward, violated


def _px_reference(k, ref, violated, draw, w):
    m = k["margin"]
    _ref_advance(k, ref, violated, draw, w, -m, m, 2.0, 1.0)


def permex_rollout_random_plain(c: PermexConsts, seed, i0, n_steps, bits=None):
    """Plain version of ``permex_rollout_random``: ``(i, reward_sum,
    term_count, rv, rk, rl, rs)``."""
    k = c.f
    bits = bits or dc_bits(seed, i0.numel(), i0.device)
    ref = _ref_init(k, shaped_words(bits.init_words(), i0.shape), 2.0, 1.0)
    i = i0.clone()
    reward, terms = torch.zeros_like(i0), torch.zeros_like(i0)
    zb = None
    for t in range(n_steps):
        w = shaped_words(bits.step_words(t), i0.shape)
        i, r, violated = _px_action_step(c, (w["action"] & 3).to(torch.int32), i, ref)
        if t % 2 == 0:
            draw, zb = box_muller(k, w["u1"], w["u2"])
        else:
            draw = zb
        _px_reference(k, ref, violated, draw, w)
        reward = reward + r
        terms = terms + violated.to(torch.float32)
    return i, reward, terms, ref["rv"], ref["rk"], ref["rl"], ref["rs"]


def permex_record_random_plain(c: PermexConsts, seed, i0, n_steps, bits=None):
    """Plain version of ``permex_record_random``: ``(i, ref, action,
    reward, done)``, each ``(T, R, 128)`` (``action`` int32): the post-step,
    post-reset current and the reference the step's reward was taken
    against; a fresh Box-Muller pair each step, its cosine used."""
    k = c.f
    bits = bits or dc_bits(seed, i0.numel(), i0.device)
    ref = _ref_init(k, shaped_words(bits.init_words(), i0.shape), 2.0, 1.0)
    i = i0.clone()
    shape = (int(n_steps),) + tuple(i0.shape)
    out = [torch.empty(shape, dtype=torch.int32 if j == 2 else torch.float32, device=i0.device)
           for j in range(5)]
    for t in range(n_steps):
        w = shaped_words(bits.step_words(t), i0.shape)
        a = (w["action"] & 3).to(torch.int32)
        out[1][t] = ref["rv"]
        i, r, violated = _px_action_step(c, a, i, ref)
        out[0][t], out[2][t], out[3][t], out[4][t] = i, a, r, violated.to(torch.float32)
        _px_reference(k, ref, violated, box_muller(k, w["u1"], w["u2"])[0], w)
    return tuple(out)


def permex_rollout_buffer_plain(c: PermexConsts, i0, actions):
    """Plain version of ``permex_rollout_buffer``: the final current."""
    i = i0
    for t in range(actions.shape[0]):
        i = permex_physics(c, i, actions[t])
    return i.clone()


def permex_record_buffer_plain(c: PermexConsts, i0, actions):
    """Plain version of ``permex_record_buffer``: the current after each
    step, ``(T, R, 128)``."""
    out = torch.empty(tuple(actions.shape), dtype=torch.float32, device=i0.device)
    i = i0
    for t in range(actions.shape[0]):
        i = permex_physics(c, i, actions[t])
        out[t] = i
    return out


# ---------------------------------------------------------------------------
# Cont-SC-SeriesDc / Cont-SC-ShuntDc
# ---------------------------------------------------------------------------


class DcScConsts:
    """The baked constants of a Cont-SC-SeriesDc or Cont-SC-ShuntDc env
    (``make_fused_dc_sc_rollout``, pallas_dc.py:380-467), in
    ``DcScConstIndex`` order of csrc/fused_dc_sc.cu.  Row 0 of the currents
    is SeriesDc's ``i`` (r_a + r_e, l_a + l_e) or ShuntDc's ``i_a``; row 1
    ShuntDc's ``i_e``.  The sigma range is the env's reference generator's,
    the margin window [0, nominal / limit] of omega."""

    NAMES = ("u_sup", "neg_r0", "l_p", "inv_l0", "neg_r1", "inv_l1", "load_a", "load_b",
             "load_c", "omega_lin", "jt_over_td", "inv_jt", "half_tau", "tau", "sixth",
             "inv_w_lim", "i0_lim", "i1_lim", "violation_reward", "margin", "ep_lo", "ep_span",
             "sig_base", "sig_span", "ln10", "u_min", "two_pi", "shunt")

    def __init__(self, env):
        ps = env.physical_system
        fused_check_system(ps)
        mp = ps.motor.parameter
        names = list(ps.state_names)
        lim = np.asarray(ps.limits)
        kind = ps.motor.kind
        require(kind in ("SeriesDc", "ShuntDc"), kind)
        self.series = kind == "SeriesDc"
        self.state_names = ("omega", "i") if self.series else ("omega", "i_a", "i_e")
        self.n_state = len(self.state_names)
        tau = float(ps.tau)
        u_sup = specialised_u_sup(ps)
        lp = specialised_load(ps, ("PolynomialStaticLoad",)).parameter
        a_c, b_c, c_c = float(lp["a"]), float(lp["b"]), float(lp["c"])
        j_total = float(ps.load.j_load) + float(mp["j_rotor"])
        tau_decay = 1e-3
        w_lim = float(lim[names.index("omega")])
        sigma_lo, sigma_hi = env.reference_generator.subs[0].sigma_range
        if self.series:
            r0, l0 = float(mp["r_a"]) + float(mp["r_e"]), float(mp["l_a"]) + float(mp["l_e"])
            r1, l1 = 0.0, 1.0
            i0_lim, i1_lim = float(lim[names.index("i")]), 0.0
        else:
            r0, l0 = float(mp["r_a"]), float(mp["l_a"])
            r1, l1 = float(mp["r_e"]), float(mp["l_e"])
            i0_lim, i1_lim = float(lim[names.index("i_a")]), float(lim[names.index("i_e")])
        pack_consts(self, self.NAMES, dict(
            u_sup=u_sup, neg_r0=-r0, l_p=float(mp["l_e_prime"]), inv_l0=1.0 / l0, neg_r1=-r1,
            inv_l1=1.0 / l1, load_a=a_c, load_b=b_c, load_c=c_c,
            omega_lin=a_c / j_total * tau_decay, jt_over_td=j_total / tau_decay,
            inv_jt=1.0 / j_total, half_tau=0.5 * tau, tau=tau, sixth=tau / 6.0,
            inv_w_lim=1.0 / w_lim, i0_lim=i0_lim, i1_lim=i1_lim,
            violation_reward=-1.0 / (1.0 - 0.9),
            margin=float(ps.nominal_state[names.index("omega")] / w_lim),
            ep_lo=500.0, ep_span=1500.0, sig_base=np.log10(sigma_lo),
            sig_span=np.log10(sigma_hi) - np.log10(sigma_lo), ln10=np.log(10.0),
            u_min=1e-12, two_pi=TWO_PI, shunt=float(not self.series)))


def _dcsc_rhs(c, k, s, u):
    """``(d omega, d i0[, d i1])`` of one RK4 stage: the polynomial load
    against the motor torque (``fused_common.poly_load_rhs``), and the
    motor's currents.  The DC family's right-hand side forms ``(l_e' w) i``
    where this one, as the JAX kernel, forms ``(l_e' i) w``, so the two
    round apart and this step keeps its own."""
    w, i0 = s[0], s[1]
    if c.series:
        d = (((k["neg_r0"] * i0 - (k["l_p"] * i0) * w) + u) * k["inv_l0"],)
        torque = (k["l_p"] * i0) * i0
    else:
        i1 = s[2]
        d = (((k["neg_r0"] * i0 - (k["l_p"] * i1) * w) + u) * k["inv_l0"],
             (k["neg_r1"] * i1 + u) * k["inv_l1"])
        torque = (k["l_p"] * i1) * i0
    return (poly_load_rhs(k, w, torque),) + d


def dc_sc_physics(c, k, s, a):
    """Cont-4QC (u = a u_sup), then one joint RK4 step over the speed and
    the currents."""
    u = a * k["u_sup"]
    h = k["half_tau"]
    k1 = _dcsc_rhs(c, k, s, u)
    k2 = _dcsc_rhs(c, k, [x + h * d for x, d in zip(s, k1)], u)
    k3 = _dcsc_rhs(c, k, [x + h * d for x, d in zip(s, k2)], u)
    k4 = _dcsc_rhs(c, k, [x + k["tau"] * d for x, d in zip(s, k3)], u)
    return [x + k["sixth"] * ((a1 + 2.0 * (a2 + a3)) + a4)
            for x, a1, a2, a3, a4 in zip(s, k1, k2, k3, k4)]


def dc_sc_rollout_random_plain(c: DcScConsts, seed, state0, n_steps, bits=None):
    """Plain version of ``dc_sc_rollout_random``: ``(*state, reward_sum,
    term_count, rv, rk, rl, rs)``, the state ``[omega, i]`` or ``[omega,
    i_a, i_e]``."""
    k = c.f
    x0 = state0[0]
    bits = bits or dc_bits(seed, x0.numel(), x0.device)
    ref = _ref_init(k, shaped_words(bits.init_words(), x0.shape), 1.0, 0.0)
    s = [x.clone() for x in state0]
    reward, terms = torch.zeros_like(x0), torch.zeros_like(x0)
    zb = None
    zero = torch.zeros_like(x0)
    for t in range(n_steps):
        w = shaped_words(bits.step_words(t), x0.shape)
        s_new = dc_sc_physics(c, k, s, 2.0 * uniform_from_bits(w["action"]) - 1.0)
        w_n = s_new[0] * k["inv_w_lim"]
        violated = torch.abs(s_new[1]) > k["i0_lim"]
        if not c.series:
            violated = violated | (torch.abs(s_new[2]) > k["i1_lim"])
        r = torch.where(violated, torch.full_like(w_n, k["violation_reward"]),
                        -torch.abs(w_n - ref["rv"]))
        s = [torch.where(violated, zero, x) for x in s_new]
        if t % 2 == 0:
            draw, zb = box_muller(k, w["u1"], w["u2"])
        else:
            draw = zb
        _ref_advance(k, ref, violated, draw, w, 0.0, k["margin"], 1.0, 0.0)
        reward = reward + r
        terms = terms + violated.to(torch.float32)
    return (*s, reward, terms, ref["rv"], ref["rk"], ref["rl"], ref["rs"])


def dc_sc_rollout_buffer_plain(c: DcScConsts, state0, actions):
    """Plain version of ``dc_sc_rollout_buffer``: the final state."""
    s = list(state0)
    for t in range(actions.shape[0]):
        s = dc_sc_physics(c, c.f, s, actions[t])
    return tuple(x.clone() for x in s)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_LIBS = {"permex": ("fused_permex", (len(CONST_NAMES), len(ROW_NAMES), len(FLAG_NAMES),
                                      len(PermexConsts.NAMES))),
         "dc_sc": ("fused_dc_sc", (len(DcScConsts.NAMES),))}


def _library(prefix):
    library, counts = _LIBS[prefix]
    return spec_library(library, prefix, [k for k in KERNELS if k.startswith(prefix)], counts)


def _launch(prefix, name, device, *args):
    launch_kernel(_library(prefix), prefix, name, device, LAUNCHES, *args)


def _px_consts(c: PermexConsts):
    """The DC family's constants and flags (the arrays dc_step.cuh loads),
    then the builder's own."""
    return c.dc.host.ctypes.data, c.dc.flags.ctypes.data, c.host.ctypes.data


def _empty(shape, device, n, int_at=()):
    return [torch.empty(shape, dtype=torch.int32 if j in int_at else torch.float32,
                        device=device) for j in range(n)]


def _buffer_steps(actions, R, dtype, device):
    """Validate a ``(T, R, 128)`` action buffer; returns T."""
    T = actions.shape[0] if isinstance(actions, torch.Tensor) and actions.dim() else 0
    check_tensor("actions", actions, (T, R, LANE), dtype, device)
    return T


def permex_rollout_random(c: PermexConsts, seed: int, i0, n_steps: int):
    """``(i, reward_sum, term_count, rv, rk, rl, rs)``, each ``(R, 128)``."""
    device, R = check_planes(c, (i0,))
    if device.type == "cpu":
        return permex_rollout_random_plain(c, seed, i0, n_steps)
    outs = _permex_random_launch(c, seed, i0, n_steps, R * LANE, LAUNCHES)
    return tuple(x.view(R, LANE) for x in outs)


def permex_record_random(c: PermexConsts, seed: int, i0, n_steps: int):
    """``(i, ref, action, reward, done)``, each ``(T, R, 128)``."""
    device, R = check_planes(c, (i0,))
    if device.type == "cpu":
        return permex_record_random_plain(c, seed, i0, n_steps)
    outs = _permex_record_random_launch(c, seed, i0, n_steps, R * LANE, LAUNCHES)
    return tuple(x.view(int(n_steps), R, LANE) for x in outs)


def permex_rollout_buffer(c: PermexConsts, i0, actions):
    """The current after the int32 ``(T, R, 128)`` action buffer, ``(R, 128)``."""
    device, R = check_planes(c, (i0,))
    T = _buffer_steps(actions, R, torch.int32, device)
    if device.type == "cpu":
        return permex_rollout_buffer_plain(c, i0, actions)
    (out,) = _empty((R, LANE), device, 1)
    _launch("permex", "permex_rollout_buffer", device, *_px_consts(c), R * LANE, T,
            ptr_array([i0]), actions.data_ptr(), ptr_array([out]))
    return out


def permex_record_buffer(c: PermexConsts, i0, actions):
    """The current after each step of the buffer, ``(T, R, 128)``."""
    device, R = check_planes(c, (i0,))
    T = _buffer_steps(actions, R, torch.int32, device)
    if device.type == "cpu":
        return permex_record_buffer_plain(c, i0, actions)
    (out,) = _empty((T, R, LANE), device, 1)
    _launch("permex", "permex_record_buffer", device, *_px_consts(c), R * LANE, T,
            ptr_array([i0]), actions.data_ptr(), ptr_array([out]))
    return out


def _permex_random_launch(c: PermexConsts, seed: int, i0, n_steps: int, n_envs: int,
                          launches=None):
    """permex_rollout_random's kernel on the first ``n_envs`` envs of the
    plane ``i0``: its 7 outputs, each ``(n_envs,)``; the launch counted in
    ``launches`` (none: not counted)."""
    device = i0.device
    outs = _empty((n_envs,), device, 7)
    launch_kernel(_library("permex"), "permex", "permex_rollout_random", device,
                  {"permex_rollout_random": 0} if launches is None else launches,
                  *_px_consts(c), seed_u64(seed), n_envs, int(n_steps), ptr_array([i0]),
                  ptr_array(outs))
    return outs


def _permex_record_random_launch(c: PermexConsts, seed: int, i0, n_steps: int, n_envs: int,
                                 launches=None):
    """permex_record_random's kernel on the first ``n_envs`` envs of the
    plane ``i0``: its 5 outputs, each ``(T, n_envs)`` (the action int32);
    the launch counted in ``launches`` (none: not counted)."""
    device = i0.device
    outs = _empty((int(n_steps), n_envs), device, 5, int_at=(2,))
    launch_kernel(_library("permex"), "permex", "permex_record_random", device,
                  {"permex_record_random": 0} if launches is None else launches,
                  *_px_consts(c), seed_u64(seed), n_envs, int(n_steps), ptr_array([i0]),
                  ptr_array(outs))
    return outs


def _permex_ring_layout(shape):
    K, P = shape
    return named_ring_layout((4, 4 * P, K, 2, PERMEX_RING_WORDS,
                              2 * K * PERMEX_RING_WORDS * 128 * 4, 0))


def permex_ring_layout():
    """The random rollout's ring (csrc/fused_permex.cu's PermexRing, in
    csrc/ring_pipe.cuh's RingLayout): consumer and producer warps, K steps a
    slot, slots, words a step, shared-memory bytes; computed here, without
    the library."""
    return _permex_ring_layout(PERMEX_RING)


def permex_record_ring_layout():
    """The random recorder's ring (csrc/fused_permex.cu's
    PermexRecordRing), as ``permex_ring_layout``."""
    return _permex_ring_layout(PERMEX_RECORD_RING)


def dc_sc_rollout_random(c: DcScConsts, seed: int, state0, n_steps: int):
    """``(*state, reward_sum, term_count, rv, rk, rl, rs)``, each ``(R, 128)``."""
    device, R = check_planes(c, state0)
    if device.type == "cpu":
        return dc_sc_rollout_random_plain(c, seed, state0, n_steps)
    outs = _empty((R, LANE), device, c.n_state + 6)
    _launch("dc_sc", "dc_sc_rollout_random", device, c.host.ctypes.data, seed_u64(seed),
            R * LANE, int(n_steps), ptr_array(state0), ptr_array(outs))
    return tuple(outs)


def _dc_sc_random_launch(c: DcScConsts, seed: int, state0, n_steps: int, n_envs: int):
    """dc_sc_rollout_random's kernel on the first ``n_envs`` envs of the
    planes: its outputs, each ``(n_envs,)``; not counted in ``LAUNCHES``."""
    device = state0[0].device
    outs = _empty((n_envs,), device, c.n_state + 6)
    launch_kernel(_library("dc_sc"), "dc_sc", "dc_sc_rollout_random", device,
                  {"dc_sc_rollout_random": 0}, c.host.ctypes.data, seed_u64(seed), n_envs,
                  int(n_steps), ptr_array(state0), ptr_array(outs))
    return outs


def dc_sc_ring_layout():
    """The random rollout's ring (csrc/fused_dc_sc.cu, the same for both
    motors; csrc/ring_pipe.cuh's RingLayout): consumer and producer warps,
    K steps a slot, slots, words a step, shared-memory bytes."""
    lib = _library("dc_sc")
    lib.dc_sc_ring_layout.argtypes = [ctypes.c_void_p]
    out = (ctypes.c_int * len(RING_LAYOUT_FIELDS))()
    lib.dc_sc_ring_layout(out)
    return named_ring_layout(out)


def dc_sc_rollout_buffer(c: DcScConsts, state0, actions):
    """The state after the float32 ``(T, R, 128)`` duty buffer."""
    device, R = check_planes(c, state0)
    T = _buffer_steps(actions, R, torch.float32, device)
    if device.type == "cpu":
        return dc_sc_rollout_buffer_plain(c, state0, actions)
    outs = _empty((R, LANE), device, c.n_state)
    _launch("dc_sc", "dc_sc_rollout_buffer", device, c.host.ctypes.data, R * LANE, T,
            ptr_array(state0), actions.data_ptr(), ptr_array(outs))
    return tuple(outs)


# ---------------------------------------------------------------------------
# builders (the JAX package's entry points)
# ---------------------------------------------------------------------------


def make_fused_permex_rollout(env, n_steps, n_envs, action_mode="random"):
    """Fused rollout of a Finite-CC-PermExDc-v0 env
    (``make_fused_permex_rollout``, pallas_dc.py:94): the 4QC table, RK4 on
    the armature current, the builder's Wiener current reference, WSE, the
    limit constraint and the in-kernel reset.

    ``rollout(seed, i0) -> (i, reward_sum, term_count, rv, rk, rl, rs)``,
    each ``(n_envs // 128, 128)`` float32; with ``action_mode='buffer'``
    ``rollout(i0, actions) -> i`` for an int32 ``(n_steps, n_envs // 128,
    128)`` buffer, deterministic physics only.  The device is that of the
    inputs."""
    require_specialised_defaults(env)
    R = require_lanes(n_envs)
    c = PermexConsts(env)
    if action_mode == "buffer":
        def rollout(i0, actions):
            check_rollout_inputs(R, n_steps, (i0,), actions)
            return permex_rollout_buffer(c, i0, actions)
    else:
        require(action_mode == "random", action_mode)

        def rollout(seed, i0):
            check_rollout_inputs(R, n_steps, (i0,))
            return permex_rollout_random(c, seed, i0, n_steps)
    rollout.consts = c
    return rollout


def make_fused_permex_record_rollout(env, n_steps, n_envs, chunk=None, action_mode="random"):
    """Trajectory-recording variant (``make_fused_permex_record_rollout``,
    pallas_dc.py:222).

    ``action_mode='random'``: ``rollout(seed, i0) -> (i, ref, action,
    reward, done)``, each ``(n_steps, n_envs // 128, 128)`` (``action``
    int32, the rest float32); ``i`` is the post-step, post-reset current,
    ``ref`` the reference the step's reward used.  ``action_mode='buffer'``:
    ``rollout(i0, actions) -> i`` per step.  ``chunk`` is checked as the
    JAX builder checks it (a divisor of ``n_steps``) and changes nothing
    else: each env's consumer thread of the recorder's ring records the
    whole trajectory."""
    require_specialised_defaults(env)
    R = require_lanes(n_envs)
    if chunk is None:
        chunk = default_record_chunk(n_steps, R)
    require(n_steps % chunk == 0, "n_steps must be a multiple of chunk")
    c = PermexConsts(env)
    if action_mode == "buffer":
        def rollout(i0, actions):
            check_rollout_inputs(R, n_steps, (i0,), actions)
            return permex_record_buffer(c, i0, actions)
    else:
        require(action_mode == "random", action_mode)

        def rollout(seed, i0):
            check_rollout_inputs(R, n_steps, (i0,))
            return permex_record_random(c, seed, i0, n_steps)
    rollout.consts, rollout.chunk = c, chunk
    return rollout


def default_record_chunk(n_steps, R):
    """The JAX recorder's default chunk (pallas_dc.py:240-246): about 12 *
    128 / R steps, snapped down to a divisor of ``n_steps``."""
    chunk = min(max(1, (12 * LANE) // R), n_steps)
    while chunk > 1 and n_steps % chunk:
        chunk -= 1
    return max(chunk, 1)


def make_fused_dc_sc_rollout(env, n_steps, n_envs, action_mode="random"):
    """Fused rollout of a Cont-SC-SeriesDc-v0 or Cont-SC-ShuntDc-v0 env
    (``make_fused_dc_sc_rollout``, pallas_dc.py:365): joint RK4 over the
    speed and the currents under the polynomial static load, the Cont-4QC
    duty, the Wiener omega reference on [0, nominal / limit], WSE and the
    current limits with the in-kernel reset.

    ``rollout(seed, *state0) -> (*state, reward_sum, term_count, rv, rk,
    rl, rs)`` with the state ``[omega, i]`` (SeriesDc) or ``[omega, i_a,
    i_e]`` (ShuntDc); with ``action_mode='buffer'`` ``rollout(*state0,
    actions) -> state`` for a float32 ``(n_steps, n_envs // 128, 128)``
    duty buffer."""
    require_specialised_defaults(env)
    R = require_lanes(n_envs)
    c = DcScConsts(env)
    if action_mode == "buffer":
        def rollout(*args):
            *state0, actions = args
            check_rollout_inputs(R, n_steps, state0, actions)
            return dc_sc_rollout_buffer(c, state0, actions)
    else:
        require(action_mode == "random", action_mode)

        def rollout(seed, *state0):
            check_rollout_inputs(R, n_steps, state0)
            return dc_sc_rollout_random(c, seed, state0, n_steps)
    rollout.consts = c
    return rollout
