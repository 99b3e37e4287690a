"""The specialised Finite-CC-EESM fused rollout, in a random-action and an
action-buffer mode.

Counterpart of ``make_fused_eesm_rollout`` in
``gym_electric_motor_tpu/ops/pallas_eesm.py`` (:58).  Two kernels written
in CUDA (``csrc/fused_eesm_cc.cu``) carry the work on the GPU:

==========================  ==================================================
``eesm_cc_rollout_random``  T steps of random B6 + 4QC actions, reduced to the
                            final state, reward sums, termination counts and
                            the three final Wiener references
``eesm_cc_rollout_buffer``  T steps of a given action buffer, deterministic
==========================  ==================================================

It serves an id the universal EESM kernels (``fused_eesm_family.py``) serve
too, and its step is theirs (``eesm_physics`` here and in
csrc/eesm_step.cuh, with the family's constants of the env), with the JAX
builder's own angle advance, reward, references, draw order and Wiener
scheme: one Box-Muller pair for i_sd* and i_sq* and a single draw for i_e*
each step; the random mode turns the Park rotation by a constant increment
with rsqrt renormalisation, the buffer mode takes cos and sin of the angle.
Each kernel has a plain PyTorch version here with the same arithmetic in
the same order and the same Philox bits; it takes ``bits=`` so that a test
replays the JAX interpret kernel's xorshift.  A wrapper runs the plain
version only for tensors on the CPU; for CUDA tensors it launches the
kernel, counts the launch in ``LAUNCHES``, or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .fused_common import (LANE, RING_LAYOUT_FIELDS, ROW_NAMES, SPEC_SLOT_EXTRA,
                           SPEC_SLOT_INIT_0, SPEC_SLOT_INIT_1, SPEC_SLOT_INIT_2, SPEC_SLOT_PARAMS,
                           SPEC_SLOT_RESET, SPEC_SLOT_STEP, SlotBits, TWO_PI, box_muller,
                           check_planes, check_rollout_inputs, check_tensor, fused_check_system,
                           launch_kernel, named_ring_layout, pack_consts, ptr_array,
                           require, require_lanes, require_specialised_defaults,
                           rotation_advance, seed_u64, shaped_words, spec_library, spec_params,
                           spec_row_walk, specialised_load, specialised_u_sup, uniform_from_bits)
from .fused_eesm_family import CONST_NAMES, FLAG_NAMES, EesmConsts, eesm_physics

KERNELS = ("eesm_cc_rollout_random", "eesm_cc_rollout_buffer")

# launches of each CUDA kernel since the last reset_launches()
LAUNCHES = dict.fromkeys(KERNELS, 0)


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# the bit layout of csrc/fused_eesm_cc.cu: role -> (slot, word), or one per
# reference row (i_sd*, i_sq*, i_e*)
_INIT_SLOTS = (SPEC_SLOT_INIT_0, SPEC_SLOT_INIT_1, SPEC_SLOT_INIT_2)
EESM_INIT_WORDS = {role: [(s, j) for s in _INIT_SLOTS]
                   for j, role in enumerate(("value", "len", "sig"))}
EESM_STEP_WORDS = {
    "action": (SPEC_SLOT_STEP, 0), "u1": (SPEC_SLOT_STEP, 1), "u2": (SPEC_SLOT_STEP, 2),
    "u3": (SPEC_SLOT_STEP, 3), "u4": (SPEC_SLOT_EXTRA, 0),
    "len": [(SPEC_SLOT_PARAMS, 0), (SPEC_SLOT_PARAMS, 2), (SPEC_SLOT_EXTRA, 1)],
    "sig": [(SPEC_SLOT_PARAMS, 1), (SPEC_SLOT_PARAMS, 3), (SPEC_SLOT_EXTRA, 2)],
    "reset": [(SPEC_SLOT_RESET, 0), (SPEC_SLOT_RESET, 1), (SPEC_SLOT_RESET, 2)],
}


class EesmCcConsts:
    """The baked constants of a Finite-CC-EESM env (pallas_eesm.py:72-157):
    ``ec`` the EESM family's physics constants of the env
    (``EesmConsts(env, physics_only=True)``, the arrays csrc/eesm_step.cuh's
    ``EesmConst`` takes: each prefix of the right-hand side formed from
    Python floats in double, as the JAX kernel forms it, the division by
    sigma a product with ``1 / float32(sigma)``), and the builder's own in
    ``EesmCcConstIndex`` order of csrc/fused_eesm_cc.cu (``host`` for the
    kernel, ``f`` as Python floats), among them the angle's advance tau p
    omega."""

    NAMES = ("d_eps", "w", "violation_reward", "m_sd", "ep_lo", "ep_span", "sig_base",
             "sig_span", "ln10", "u_min", "two_pi")

    state_names = ("i_sd", "i_sq", "i_e", "eps")
    n_state = 4

    def __init__(self, env):
        ps = env.physical_system
        fused_check_system(ps)
        omega = float(specialised_load(ps, ("ConstantSpeedLoad",)).omega_fixed)
        specialised_u_sup(ps)
        self.ec = EesmConsts(env, physics_only=True)
        if not self.ec.finite:
            raise NotImplementedError(
                "the specialised Finite-CC-EESM kernel takes finite B6 and 4QC actions; "
                "continuous converters run on make_fused_rollout (the universal dispatch)")
        names = list(ps.state_names)
        i_lim = float(np.asarray(ps.limits)[names.index("i_sd")])
        pack_consts(self, self.NAMES, dict(
            d_eps=float(ps.tau) * (float(ps.motor.parameter["p"]) * omega),
            w=(1.0 / 3.0) / 2.0, violation_reward=-1.0 / (1.0 - 0.9),
            m_sd=float(ps.nominal_state[names.index("i_sd")] / i_lim),
            ep_lo=500.0, ep_span=1500.0, sig_base=-3.0, sig_span=2.0, ln10=np.log(10.0),
            u_min=1e-12, two_pi=TWO_PI))
        m = self.f["m_sd"]
        # the windows of the three rows: i_sd*, i_sq* on [-m, m], i_e* on [0, 1]
        self.windows = ((-m, m), (-m, m), (0.0, 1.0))


def ec_physics(c: EesmCcConsts, x, cos, sin, b6, q4):
    """The B6 + 4QC voltages, Clarke, Park at (cos, sin), one RK4 step of
    (i_sd, i_sq, i_e): the EESM family's ``eesm_physics``, whose angle is
    not used (``_step_physics_cs``)."""
    keys = ("i_sd", "i_sq", "i_e")
    y = eesm_physics(c.ec, (b6, q4), cos, sin, dict(zip(keys, x), eps=torch.zeros_like(x[0])))
    return [y[key] for key in keys]


def _advance(c: EesmCcConsts, eps):
    """The angle's advance by tau p omega, wrapped to [0, 2 pi)."""
    a = eps + c.f["d_eps"]
    return a - c.ec.f["two_pi"] * torch.floor(a * c.ec.f["inv_two_pi"])


def _value(window, b):
    lo, hi = window
    return lo + (hi - lo) * uniform_from_bits(b)


def eesm_cc_rollout_random_plain(c: EesmCcConsts, seed, state0, n_steps, bits=None):
    """Plain version of ``eesm_cc_rollout_random``: ``(i_sd, i_sq, i_e,
    eps, reward_sum, term_count, rv, rk, rl, rs)``, the last four ``(3R,
    128)`` with the i_sd* rows first."""
    k = c.f
    x0 = state0[0]
    shape = x0.shape
    bits = bits or SlotBits(seed, x0.numel(), x0.device, EESM_INIT_WORDS, EESM_STEP_WORDS)
    w = shaped_words(bits.init_words(), shape)
    rows = []
    for r in range(3):
        rl, rs = spec_params(k, w["len"][r], w["sig"][r])
        rows.append({"rv": _value(c.windows[r], w["value"][r]), "rk": torch.zeros_like(x0),
                     "rl": rl, "rs": rs})
    x = [v.clone() for v in state0[:3]]
    eps = state0[3].clone()
    cs, sn = torch.cos(eps), torch.sin(eps)
    reward, terms = torch.zeros_like(x0), torch.zeros_like(x0)
    zero = torch.zeros_like(x0)
    wgt, kf = k["w"], c.ec.f
    for t in range(n_steps):
        w = shaped_words(bits.step_words(t), shape)
        isd, isq, ie = ec_physics(c, x, cs, sn, (w["action"] & 7).to(torch.int32),
                                  ((w["action"] >> 3) & 3).to(torch.int32))
        eps_new = _advance(c, eps)
        isd_n, isq_n, ie_n = isd * kf["inv_i_lim"], isq * kf["inv_i_lim"], ie * kf["inv_ie_lim"]
        violated = ((isd_n * isd_n + isq_n * isq_n) > 1.0) | (torch.abs(ie_n) > 1.0)
        wse = -((wgt * torch.abs(isd_n - rows[0]["rv"]) + wgt * torch.abs(isq_n - rows[1]["rv"]))
                + wgt * torch.abs(ie_n - rows[2]["rv"]))
        r_t = torch.where(violated, torch.full_like(wse, k["violation_reward"]), wse)
        x = [torch.where(violated, zero, v) for v in (isd, isq, ie)]
        eps = torch.where(violated, zero, eps_new)
        cs, sn = rotation_advance(kf, cs, sn, violated)
        z_d, z_q = box_muller(k, w["u1"], w["u2"])
        z_e = box_muller(k, w["u3"], w["u4"])[0]
        for r, draw in enumerate((z_d, z_q, z_e)):
            row = rows[r]
            regen = (row["rk"] >= row["rl"]) | violated
            new_rl, new_rs = spec_params(k, w["len"][r], w["sig"][r])
            spec_row_walk(row, regen, new_rl, new_rs, draw, *c.windows[r])
            row["rv"] = torch.where(violated, _value(c.windows[r], w["reset"][r]), row["rv"])
        reward = reward + r_t
        terms = terms + violated.to(torch.float32)
    return (*x, eps, reward, terms,
            *[torch.cat([row[key] for row in rows]) for key in ("rv", "rk", "rl", "rs")])


def eesm_cc_rollout_buffer_plain(c: EesmCcConsts, state0, actions):
    """Plain version of ``eesm_cc_rollout_buffer``: the final ``(i_sd, i_sq,
    i_e, eps)`` after the int32 ``(T, 2, R, 128)`` buffer (B6 bits, 4QC
    command), cos and sin of the angle taken each step."""
    x, eps = list(state0[:3]), state0[3]
    for t in range(actions.shape[0]):
        x = ec_physics(c, x, torch.cos(eps), torch.sin(eps), actions[t, 0], actions[t, 1])
        eps = _advance(c, eps)
    return (*[v.clone() for v in x], eps.clone())


# ---------------------------------------------------------------------------
# kernel wrappers and the builder
# ---------------------------------------------------------------------------


def _lib():
    return spec_library("fused_eesm_cc", "eesm_cc", KERNELS,
                        (len(CONST_NAMES), len(ROW_NAMES), len(FLAG_NAMES),
                         len(EesmCcConsts.NAMES)))


def _consts(c: EesmCcConsts):
    """The EESM family's constants and flags, then the builder's own."""
    return c.ec.host.ctypes.data, c.ec.flags.ctypes.data, c.host.ctypes.data


def eesm_cc_rollout_random(c: EesmCcConsts, seed: int, state0, n_steps: int):
    """``(i_sd, i_sq, i_e, eps, reward_sum, term_count, rv, rk, rl, rs)``:
    six ``(R, 128)`` and four ``(3R, 128)`` planes."""
    device, R = check_planes(c, state0)
    if device.type == "cpu":
        return eesm_cc_rollout_random_plain(c, seed, state0, n_steps)
    outs = _eesm_cc_random_launch(c, seed, state0, n_steps, R * LANE, LAUNCHES)
    return tuple(x.view(-1, LANE) for x in outs)


def _eesm_cc_random_launch(c: EesmCcConsts, seed: int, state0, n_steps: int, n_envs: int,
                           launches=None):
    """eesm_cc_rollout_random's kernel on the first ``n_envs`` envs of the
    planes: its outputs, six ``(n_envs,)`` and four ``(3 n_envs,)`` (row 0's
    envs, then row 1's, then row 2's); the launch counted in ``launches``
    (none: not counted)."""
    device = state0[0].device
    outs = [torch.empty((n_envs if j < 6 else 3 * n_envs,), dtype=torch.float32, device=device)
            for j in range(10)]
    launch_kernel(_lib(), "eesm_cc", "eesm_cc_rollout_random", device,
                  {"eesm_cc_rollout_random": 0} if launches is None else launches, *_consts(c),
                  seed_u64(seed), n_envs, int(n_steps), ptr_array(state0), ptr_array(outs))
    return outs


def eesm_cc_ring_layout():
    """The random rollout's ring (csrc/fused_eesm_cc.cu; csrc/ring_pipe.cuh's
    RingLayout): consumer and producer warps, K steps a slot, slots, words a
    step, shared-memory bytes."""
    lib = _lib()
    lib.eesm_cc_ring_layout.argtypes = [ctypes.c_void_p]
    out = (ctypes.c_int * len(RING_LAYOUT_FIELDS))()
    lib.eesm_cc_ring_layout(out)
    return named_ring_layout(out)


def eesm_cc_rollout_buffer(c: EesmCcConsts, state0, actions):
    """The state after the int32 ``(T, 2, R, 128)`` action buffer."""
    device, R = check_planes(c, state0)
    T = actions.shape[0] if isinstance(actions, torch.Tensor) and actions.dim() else 0
    check_tensor("actions", actions, (T, 2, R, LANE), torch.int32, device)
    if device.type == "cpu":
        return eesm_cc_rollout_buffer_plain(c, state0, actions)
    outs = [torch.empty((R, LANE), dtype=torch.float32, device=device) for _ in range(c.n_state)]
    launch_kernel(_lib(), "eesm_cc", "eesm_cc_rollout_buffer", device, LAUNCHES, *_consts(c),
                  R * LANE, T, ptr_array(state0), actions.data_ptr(), ptr_array(outs))
    return tuple(outs)


def make_fused_eesm_rollout(env, n_steps, n_envs, action_mode="random"):
    """Fused rollout of a Finite-CC-EESM-v0 env (``make_fused_eesm_rollout``,
    pallas_eesm.py:58): the 3-current dq ODE under B6 + 4QC actions, three
    Wiener references, WSE, the squared dq-current and i_e limit
    constraints and the in-kernel reset.

    ``rollout(seed, isd0, isq0, ie0, eps0) -> (isd, isq, ie, eps,
    reward_sum, term_count, rv, rk, rl, rs)``: ``(n_envs // 128, 128)``
    float32 planes, the reference planes ``(3 n_envs // 128, 128)``
    (i_sd*, i_sq*, i_e* rows); with ``action_mode='buffer'``
    ``rollout(isd0, isq0, ie0, eps0, actions) -> (isd, isq, ie, eps)`` for
    an int32 ``(n_steps, 2, n_envs // 128, 128)`` buffer (B6 bits, 4QC)."""
    require_specialised_defaults(env)
    R = require_lanes(n_envs)
    c = EesmCcConsts(env)

    if action_mode == "buffer":
        def rollout(isd0, isq0, ie0, eps0, actions):
            state0 = (isd0, isq0, ie0, eps0)
            check_rollout_inputs(R, n_steps, state0, actions)
            return eesm_cc_rollout_buffer(c, state0, actions)
    else:
        require(action_mode == "random", action_mode)

        def rollout(seed, isd0, isq0, ie0, eps0):
            state0 = (isd0, isq0, ie0, eps0)
            check_rollout_inputs(R, n_steps, state0)
            return eesm_cc_rollout_random(c, seed, state0, n_steps)
    rollout.consts = c
    return rollout
