"""The specialised Cont-CC-DFIM fused rollout, in a random-action and an
action-buffer mode.

Counterpart of ``make_fused_dfim_rollout`` in
``gym_electric_motor_tpu/ops/pallas_dfim.py`` (:53).  Two kernels written
in CUDA (``csrc/fused_dfim_cc.cu``) carry the work on the GPU:

==========================  ==================================================
``dfim_cc_rollout_random``  T steps of six random duties (stator and rotor B6),
                            reduced to the final state, reward sums,
                            termination counts and the two final Wiener
                            references
``dfim_cc_rollout_buffer``  T steps of a given duty buffer, deterministic
==========================  ==================================================

It serves an id the universal DFIM kernels (``fused_dfim_family.py``) serve
too, and its step is theirs (``dfim_physics`` here and in
csrc/dfim_step.cuh, with the family's constants of the env), with the JAX
builder's own angle advance, flux-direction guard, reward, references, draw
order and Wiener scheme (one Box-Muller pair feeds both references), the rotor voltage
turned by one rotation through the electrical angle, and the dq currents
taken from the post-step flux direction cosines.  The random mode turns the
rotation by a constant increment with rsqrt renormalisation, the buffer
mode takes cos and sin of the angle.  Each kernel has a plain PyTorch
version here with the same arithmetic in the same order and the same
Philox bits; it takes ``bits=`` so that a test replays the JAX interpret
kernel's xorshift.  A wrapper runs the plain version only for tensors on
the CPU; for CUDA tensors it launches the kernel, counts the launch in
``LAUNCHES``, or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .fused_common import (LANE, RING_LAYOUT_FIELDS, ROW_NAMES, SPEC_SLOT_EXTRA, SPEC_SLOT_INIT_0,
                           SPEC_SLOT_INIT_1, SPEC_SLOT_PARAMS, SPEC_SLOT_RESET, SPEC_SLOT_STEP,
                           SlotBits, TWO_PI, box_muller, check_planes, check_rollout_inputs,
                           check_tensor, fused_check_system, launch_kernel, named_ring_layout,
                           pack_consts, ptr_array, require, require_lanes,
                           require_specialised_defaults, rotation_advance, seed_u64, shaped_words,
                           spec_library, spec_params, spec_row_walk, specialised_load,
                           specialised_u_sup, uniform_from_bits)
from .fused_dfim_family import CONST_NAMES, FLAG_NAMES, DfimConsts, dfim_physics

KERNELS = ("dfim_cc_rollout_random", "dfim_cc_rollout_buffer")

# launches of each CUDA kernel since the last reset_launches()
LAUNCHES = dict.fromkeys(KERNELS, 0)


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# the bit layout of csrc/fused_dfim_cc.cu: role -> (slot, word), or one per
# reference row (i_sd*, i_sq*)
DFIM_INIT_WORDS = {role: [(SPEC_SLOT_INIT_0, j), (SPEC_SLOT_INIT_1, j)]
                   for j, role in enumerate(("value", "len", "sig"))}
DFIM_STEP_WORDS = {
    "duties": [(SPEC_SLOT_STEP, 0), (SPEC_SLOT_STEP, 1), (SPEC_SLOT_STEP, 2), (SPEC_SLOT_STEP, 3),
               (SPEC_SLOT_EXTRA, 0), (SPEC_SLOT_EXTRA, 1)],
    "u1": (SPEC_SLOT_EXTRA, 2), "u2": (SPEC_SLOT_EXTRA, 3),
    "len": [(SPEC_SLOT_PARAMS, 0), (SPEC_SLOT_PARAMS, 2)],
    "sig": [(SPEC_SLOT_PARAMS, 1), (SPEC_SLOT_PARAMS, 3)],
    "reset": [(SPEC_SLOT_RESET, 0), (SPEC_SLOT_RESET, 1)],
}


class DfimCcConsts:
    """The baked constants of a Cont-CC-DFIM env (pallas_dfim.py:67-148):
    ``df`` the DFIM family's physics constants of the env
    (``DfimConsts(env, physics_only=True)``, the arrays csrc/dfim_step.cuh's
    ``DfimConst`` takes; the divisions by tau_sig and tau_r are products
    with ``1 / float32(c)``, as XLA compiles them), and the builder's own in
    ``DfimCcConstIndex`` order of csrc/fused_dfim_cc.cu (``host`` for the
    kernel, ``f`` as Python floats), among them the angle's advance tau p
    omega and the flux-direction guard 1e-18."""

    NAMES = ("d_eps", "tiny", "inv_i_lim", "w", "violation_reward", "margin", "ep_lo", "ep_span",
             "sig_base", "sig_span", "ln10", "u_min", "two_pi")

    state_names = ("i_sa", "i_sb", "psi_ra", "psi_rb", "eps")
    n_state = 5

    def __init__(self, env):
        ps = env.physical_system
        fused_check_system(ps)
        omega = float(specialised_load(ps, ("ConstantSpeedLoad",)).omega_fixed)
        specialised_u_sup(ps)
        self.df = DfimConsts(env, physics_only=True)
        if self.df.finite:
            raise NotImplementedError(
                "the specialised Cont-CC-DFIM kernel takes continuous duties; finite bridges run "
                "on make_fused_rollout (the universal dispatch)")
        names = list(ps.state_names)
        i_lim = float(np.asarray(ps.limits)[names.index("i_sd")])
        pack_consts(self, self.NAMES, dict(
            d_eps=float(ps.tau) * (float(ps.motor.parameter["p"]) * omega), tiny=1e-18,
            inv_i_lim=1.0 / i_lim, w=0.5 / 2.0, violation_reward=-1.0 / (1.0 - 0.9),
            margin=float(ps.nominal_state[names.index("i_sd")] / i_lim),
            ep_lo=500.0, ep_span=1500.0, sig_base=-3.0, sig_span=2.0, ln10=np.log(10.0),
            u_min=1e-12, two_pi=TWO_PI))


def fc_physics(c: DfimCcConsts, x, cos, sin, duties):
    """Both bridges' voltages (duty times u_sup / 2), Clarke, the rotor
    voltage turned by (cos, sin), one RK4 step of (i_salpha, i_sbeta,
    psi_ralpha, psi_rbeta): the DFIM family's ``dfim_physics``, whose angle
    is not used (``_step_physics_cs``)."""
    keys = ("isa", "isb", "psa", "psb")
    y = dfim_physics(c.df, duties, cos, sin, dict(zip(keys, x), eps=torch.zeros_like(x[0])))
    return [y[key] for key in keys]


def _advance(c: DfimCcConsts, eps):
    """The angle's advance by tau p omega, wrapped to [0, 2 pi)."""
    a = eps + c.f["d_eps"]
    return a - c.df.f["two_pi"] * torch.floor(a * c.df.f["inv_two_pi"])


def _value(k, b):
    return (2.0 * uniform_from_bits(b) - 1.0) * k["margin"]


def dfim_cc_rollout_random_plain(c: DfimCcConsts, seed, state0, n_steps, bits=None):
    """Plain version of ``dfim_cc_rollout_random``: ``(i_sa, i_sb, psi_ra,
    psi_rb, eps, reward_sum, term_count, rv, rk, rl, rs)``, the last four
    ``(2R, 128)`` with the i_sd* rows first."""
    k = c.f
    x0 = state0[0]
    shape = x0.shape
    bits = bits or SlotBits(seed, x0.numel(), x0.device, DFIM_INIT_WORDS, DFIM_STEP_WORDS)
    w = shaped_words(bits.init_words(), shape)
    rows = []
    for r in range(2):
        rl, rs = spec_params(k, w["len"][r], w["sig"][r])
        rows.append({"rv": _value(k, w["value"][r]), "rk": torch.zeros_like(x0), "rl": rl,
                     "rs": rs})
    x = [v.clone() for v in state0[:4]]
    eps = state0[4].clone()
    cs, sn = torch.cos(eps), torch.sin(eps)
    reward, terms = torch.zeros_like(x0), torch.zeros_like(x0)
    zero, one = torch.zeros_like(x0), torch.ones_like(x0)
    m, wgt = k["margin"], k["w"]
    for t in range(n_steps):
        w = shaped_words(bits.step_words(t), shape)
        duties = [2.0 * uniform_from_bits(b) - 1.0 for b in w["duties"]]
        isa, isb, psa, psb = fc_physics(c, x, cs, sn, duties)
        eps_new = _advance(c, eps)
        pn2 = psa * psa + psb * psb
        inv_pn = torch.rsqrt(torch.clamp(pn2, min=k["tiny"]))
        safe = pn2 > k["tiny"]
        cf = torch.where(safe, psa * inv_pn, one)
        sf = torch.where(safe, psb * inv_pn, zero)
        i_sd = (cf * isa + sf * isb) * k["inv_i_lim"]
        i_sq = (-sf * isa + cf * isb) * k["inv_i_lim"]
        violated = (i_sd * i_sd + i_sq * i_sq) > 1.0
        wse = -(wgt * torch.abs(i_sd - rows[0]["rv"]) + wgt * torch.abs(i_sq - rows[1]["rv"]))
        r_t = torch.where(violated, torch.full_like(wse, k["violation_reward"]), wse)
        x = [torch.where(violated, zero, v) for v in (isa, isb, psa, psb)]
        eps = torch.where(violated, zero, eps_new)
        cs, sn = rotation_advance(c.df.f, cs, sn, violated)
        for r, draw in enumerate(box_muller(k, w["u1"], w["u2"])):
            row = rows[r]
            regen = (row["rk"] >= row["rl"]) | violated
            new_rl, new_rs = spec_params(k, w["len"][r], w["sig"][r])
            spec_row_walk(row, regen, new_rl, new_rs, draw, -m, m)
            row["rv"] = torch.where(violated, _value(k, w["reset"][r]), row["rv"])
        reward = reward + r_t
        terms = terms + violated.to(torch.float32)
    return (*x, eps, reward, terms,
            *[torch.cat([row[key] for row in rows]) for key in ("rv", "rk", "rl", "rs")])


def dfim_cc_rollout_buffer_plain(c: DfimCcConsts, state0, actions):
    """Plain version of ``dfim_cc_rollout_buffer``: the final ``(i_sa, i_sb,
    psi_ra, psi_rb, eps)`` after the float32 ``(T, 6, R, 128)`` duties, cos
    and sin of the angle taken each step."""
    x, eps = list(state0[:4]), state0[4]
    for t in range(actions.shape[0]):
        x = fc_physics(c, x, torch.cos(eps), torch.sin(eps), [actions[t, j] for j in range(6)])
        eps = _advance(c, eps)
    return (*[v.clone() for v in x], eps.clone())


# ---------------------------------------------------------------------------
# kernel wrappers and the builder
# ---------------------------------------------------------------------------


def _lib():
    return spec_library("fused_dfim_cc", "dfim_cc", KERNELS,
                        (len(CONST_NAMES), len(ROW_NAMES), len(FLAG_NAMES),
                         len(DfimCcConsts.NAMES)))


def _consts(c: DfimCcConsts):
    """The DFIM family's constants and flags, then the builder's own."""
    return c.df.host.ctypes.data, c.df.flags.ctypes.data, c.host.ctypes.data


def dfim_cc_rollout_random(c: DfimCcConsts, seed: int, state0, n_steps: int):
    """``(i_sa, i_sb, psi_ra, psi_rb, eps, reward_sum, term_count, rv, rk,
    rl, rs)``: seven ``(R, 128)`` and four ``(2R, 128)`` planes."""
    device, R = check_planes(c, state0)
    if device.type == "cpu":
        return dfim_cc_rollout_random_plain(c, seed, state0, n_steps)
    outs = _dfim_cc_random_launch(c, seed, state0, n_steps, R * LANE, LAUNCHES)
    return tuple(x.view(-1, LANE) for x in outs)


def _dfim_cc_random_launch(c: DfimCcConsts, seed: int, state0, n_steps: int, n_envs: int,
                           launches=None):
    """dfim_cc_rollout_random's kernel on the first ``n_envs`` envs of the
    planes: its outputs, seven ``(n_envs,)`` and four ``(2 n_envs,)`` (row
    0's envs, then row 1's); the launch counted in ``launches`` (none: not
    counted)."""
    device = state0[0].device
    outs = [torch.empty((n_envs if j < 7 else 2 * n_envs,), dtype=torch.float32, device=device)
            for j in range(11)]
    launch_kernel(_lib(), "dfim_cc", "dfim_cc_rollout_random", device,
                  {"dfim_cc_rollout_random": 0} if launches is None else launches, *_consts(c),
                  seed_u64(seed), n_envs, int(n_steps), ptr_array(state0), ptr_array(outs))
    return outs


def dfim_cc_ring_layout():
    """The random rollout's ring (csrc/fused_dfim_cc.cu; csrc/ring_pipe.cuh's
    RingLayout): consumer and producer warps, K steps a slot, slots, words a
    step, shared-memory bytes."""
    lib = _lib()
    lib.dfim_cc_ring_layout.argtypes = [ctypes.c_void_p]
    out = (ctypes.c_int * len(RING_LAYOUT_FIELDS))()
    lib.dfim_cc_ring_layout(out)
    return named_ring_layout(out)


def dfim_cc_rollout_buffer(c: DfimCcConsts, state0, actions):
    """The state after the float32 ``(T, 6, R, 128)`` duty buffer."""
    device, R = check_planes(c, state0)
    T = actions.shape[0] if isinstance(actions, torch.Tensor) and actions.dim() else 0
    check_tensor("actions", actions, (T, 6, R, LANE), torch.float32, device)
    if device.type == "cpu":
        return dfim_cc_rollout_buffer_plain(c, state0, actions)
    outs = [torch.empty((R, LANE), dtype=torch.float32, device=device) for _ in range(c.n_state)]
    launch_kernel(_lib(), "dfim_cc", "dfim_cc_rollout_buffer", device, LAUNCHES, *_consts(c),
                  R * LANE, T, ptr_array(state0), actions.data_ptr(), ptr_array(outs))
    return tuple(outs)


def make_fused_dfim_rollout(env, n_steps, n_envs, action_mode="random"):
    """Fused rollout of a Cont-CC-DFIM-v0 env (``make_fused_dfim_rollout``,
    pallas_dfim.py:53): stator and rotor B6 duty converters, the alpha-beta
    ODE at constant speed, two Wiener current references, WSE, the squared
    dq current constraint from the flux direction cosines and the in-kernel
    reset.

    ``rollout(seed, isa0, isb0, psa0, psb0, eps0) -> (isa, isb, psa, psb,
    eps, reward_sum, term_count, rv, rk, rl, rs)``: ``(n_envs // 128, 128)``
    float32 planes, the reference planes ``(2 n_envs // 128, 128)``; with
    ``action_mode='buffer'`` ``rollout(isa0, isb0, psa0, psb0, eps0,
    actions) -> (isa, isb, psa, psb, eps)`` for a float32 ``(n_steps, 6,
    n_envs // 128, 128)`` duty buffer."""
    require_specialised_defaults(env)
    R = require_lanes(n_envs)
    c = DfimCcConsts(env)

    if action_mode == "buffer":
        def rollout(isa0, isb0, psa0, psb0, eps0, actions):
            state0 = (isa0, isb0, psa0, psb0, eps0)
            check_rollout_inputs(R, n_steps, state0, actions)
            return dfim_cc_rollout_buffer(c, state0, actions)
    else:
        require(action_mode == "random", action_mode)

        def rollout(seed, isa0, isb0, psa0, psb0, eps0):
            state0 = (isa0, isb0, psa0, psb0, eps0)
            check_rollout_inputs(R, n_steps, state0)
            return dfim_cc_rollout_random(c, seed, state0, n_steps)
    rollout.consts = c
    return rollout
