"""The specialised Cont-TC-SCIM fused rollout, in a random-action and an
action-buffer mode.

Counterpart of ``make_fused_scim_rollout`` in
``gym_electric_motor_tpu/ops/pallas_induction.py`` (:53).  Two kernels
written in CUDA (``csrc/fused_scim_tc.cu``) carry the work on the GPU:

========================  ====================================================
``scim_rollout_random``   T steps of random continuous B6 duties, reduced to
                          the final state, reward sums, termination counts
                          and the final Wiener torque reference (producer
                          warps draw and consumer warps step,
                          ``scim_tc_ring_layout``)
``scim_rollout_buffer``   T steps of a given duty buffer, deterministic
========================  ====================================================

It serves an id the universal induction kernels
(``fused_induction_family.py``) serve too, and its step is theirs
(``induction_physics`` here and in csrc/induction_step.cuh, with the
family's constants of the env), with the JAX builder's own reward,
reference, draw order and Wiener scheme (one Box-Muller pair every second
step, its sine kept for the odd step).  Each kernel has a plain PyTorch
version here with the same arithmetic in the same order and the same
Philox bits; it takes ``bits=`` so that a test replays the JAX interpret
kernel's xorshift.  A wrapper runs the plain version only for tensors on
the CPU; for CUDA tensors it launches the kernel, counts the launch in
``LAUNCHES``, or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from .fused_common import (LANE, ROW_NAMES, SPEC_SLOT_EXTRA,
                           SPEC_SLOT_INIT_0, SPEC_SLOT_PARAMS, SPEC_SLOT_STEP, SlotBits, TWO_PI,
                           box_muller, check_planes,
                           check_rollout_inputs, check_tensor, fused_check_system, launch_kernel,
                           named_ring_layout, pack_consts, ptr_array, require, require_lanes,
                           require_specialised_defaults, seed_u64, shaped_words, spec_library,
                           spec_params, spec_row_walk, specialised_load, specialised_u_sup,
                           uniform_from_bits)
from .fused_induction_family import (CONST_NAMES, FLAG_NAMES, InductionConsts,
                                     induction_physics, induction_torque)

KERNELS = ("scim_rollout_random", "scim_rollout_buffer")

# launches of each CUDA kernel since the last reset_launches()
LAUNCHES = dict.fromkeys(KERNELS, 0)


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# the random rollout's ring (ScimRing in csrc/fused_scim_tc.cu): K steps a
# slot, producer warps per consumer warp; and the words of a step
SCIM_TC_RING = (8, 2)
SCIM_TC_RING_WORDS = 7

# the bit layout of csrc/fused_scim_tc.cu: role -> (slot, word); u1 and u2
# are read at even steps only
SCIM_INIT_WORDS = {"value": (SPEC_SLOT_INIT_0, 0), "len": (SPEC_SLOT_INIT_0, 1),
                   "sig": (SPEC_SLOT_INIT_0, 2)}
SCIM_STEP_WORDS = {"da": (SPEC_SLOT_STEP, 0), "db": (SPEC_SLOT_STEP, 1),
                   "dc": (SPEC_SLOT_STEP, 2), "u1": (SPEC_SLOT_EXTRA, 0),
                   "u2": (SPEC_SLOT_EXTRA, 1), "len": (SPEC_SLOT_PARAMS, 0),
                   "sig": (SPEC_SLOT_PARAMS, 1), "reset": (SPEC_SLOT_PARAMS, 2)}


class ScimConsts:
    """The baked constants of a Cont-TC-SCIM env (pallas_induction.py:67-92):
    ``ic`` the induction family's physics constants of the env
    (``InductionConsts(env, physics_only=True)``, the arrays
    csrc/induction_step.cuh's ``InductionConst`` takes; the divisions by
    tau_sig and tau_r are products with ``1 / float32(c)``, as XLA compiles
    the JAX kernel's divisions by constants), and the builder's own in
    ``ScimConstIndex`` order of csrc/fused_scim_tc.cu (``host`` for the
    kernel, ``f`` as Python floats)."""

    NAMES = ("inv_t_lim", "neg_w", "violation_reward", "margin", "ep_lo", "ep_span", "sig_base",
             "sig_span", "ln10", "u_min", "two_pi")

    state_names = ("i_sa", "i_sb", "psi_ra", "psi_rb")
    n_state = 4

    def __init__(self, env):
        ps = env.physical_system
        fused_check_system(ps)
        specialised_load(ps, ("ConstantSpeedLoad",))
        specialised_u_sup(ps)
        self.ic = InductionConsts(env, physics_only=True)
        if self.ic.finite:
            raise NotImplementedError(
                "the specialised Cont-TC-SCIM kernel takes continuous duties; a finite bridge "
                "runs on make_fused_rollout (the universal dispatch)")
        names = list(ps.state_names)
        t_lim = float(np.asarray(ps.limits)[names.index("torque")])
        pack_consts(self, self.NAMES, dict(
            inv_t_lim=1.0 / t_lim, neg_w=-1.0 / 2.0, violation_reward=-1.0 / (1.0 - 0.9),
            margin=float(ps.nominal_state[names.index("torque")] / t_lim),
            ep_lo=500.0, ep_span=1500.0, sig_base=-3.0, sig_span=2.0, ln10=np.log(10.0),
            u_min=1e-12, two_pi=TWO_PI))


def scim_physics(c: ScimConsts, x, da, db, dc):
    """The phase voltages (duty times u_sup / 2), Clarke, one RK4 step of
    (i_salpha, i_sbeta, psi_ralpha, psi_rbeta) at constant speed: the
    induction family's ``induction_physics``."""
    keys = ("isa", "isb", "psa", "psb")
    y = induction_physics(c.ic, (da, db, dc), dict(zip(keys, x)))
    return [y[key] for key in keys]


def _value(k, b):
    return (2.0 * uniform_from_bits(b) - 1.0) * k["margin"]


def scim_rollout_random_plain(c: ScimConsts, seed, state0, n_steps, bits=None):
    """Plain version of ``scim_rollout_random``: ``(i_sa, i_sb, psi_ra,
    psi_rb, reward_sum, term_count, rv, rk, rl, rs)``."""
    k = c.f
    x0 = state0[0]
    shape = x0.shape
    bits = bits or SlotBits(seed, x0.numel(), x0.device, SCIM_INIT_WORDS, SCIM_STEP_WORDS)
    w = shaped_words(bits.init_words(), shape)
    rl, rs = spec_params(k, w["len"], w["sig"])
    ref = {"rv": _value(k, w["value"]), "rk": torch.zeros_like(x0), "rl": rl, "rs": rs}
    x = [s.clone() for s in state0]
    reward, terms = torch.zeros_like(x0), torch.zeros_like(x0)
    zero = torch.zeros_like(x0)
    zb = None
    m = k["margin"]
    for t in range(n_steps):
        w = shaped_words(bits.step_words(t), shape)
        duties = [2.0 * uniform_from_bits(w[d]) - 1.0 for d in ("da", "db", "dc")]
        isa, isb, psa, psb = scim_physics(c, x, *duties)
        t_n = induction_torque(c.ic.f, isa, isb, psa, psb) * k["inv_t_lim"]
        violated = (isa * isa + isb * isb) * c.ic.f["inv_ilim2"] > 1.0
        r = torch.where(violated, torch.full_like(t_n, k["violation_reward"]),
                        k["neg_w"] * torch.abs(t_n - ref["rv"]))
        x = [torch.where(violated, zero, s) for s in (isa, isb, psa, psb)]
        if t % 2 == 0:
            draw, zb = box_muller(k, w["u1"], w["u2"])
        else:
            draw = zb
        regen = (ref["rk"] >= ref["rl"]) | violated
        new_rl, new_rs = spec_params(k, w["len"], w["sig"])
        spec_row_walk(ref, regen, new_rl, new_rs, draw, -m, m)
        ref["rv"] = torch.where(violated, _value(k, w["reset"]), ref["rv"])
        reward = reward + r
        terms = terms + violated.to(torch.float32)
    return (*x, reward, terms, ref["rv"], ref["rk"], ref["rl"], ref["rs"])


def scim_rollout_buffer_plain(c: ScimConsts, state0, actions):
    """Plain version of ``scim_rollout_buffer``: the final state after the
    float32 ``(T, 3, R, 128)`` duty buffer."""
    x = list(state0)
    for t in range(actions.shape[0]):
        x = scim_physics(c, x, actions[t, 0], actions[t, 1], actions[t, 2])
    return tuple(s.clone() for s in x)


# ---------------------------------------------------------------------------
# kernel wrappers and the builder
# ---------------------------------------------------------------------------


def _lib():
    return spec_library("fused_scim_tc", "scim", KERNELS,
                        (len(CONST_NAMES), len(ROW_NAMES), len(FLAG_NAMES), len(ScimConsts.NAMES)))


def _consts(c: ScimConsts):
    """The induction family's constants and flags, then the builder's own."""
    return c.ic.host.ctypes.data, c.ic.flags.ctypes.data, c.host.ctypes.data


def scim_rollout_random(c: ScimConsts, seed: int, state0, n_steps: int):
    """``(i_sa, i_sb, psi_ra, psi_rb, reward_sum, term_count, rv, rk, rl,
    rs)``, each ``(R, 128)``."""
    device, R = check_planes(c, state0)
    if device.type == "cpu":
        return scim_rollout_random_plain(c, seed, state0, n_steps)
    outs = _scim_random_launch(c, seed, state0, n_steps, R * LANE, LAUNCHES)
    return tuple(x.view(R, LANE) for x in outs)


def _scim_random_launch(c: ScimConsts, seed: int, state0, n_steps: int, n_envs: int,
                        launches=None):
    """scim_rollout_random's kernel on the first ``n_envs`` envs of the
    planes: its 10 outputs, each ``(n_envs,)``; the launch counted in
    ``launches`` (none: not counted)."""
    device = state0[0].device
    outs = [torch.empty((n_envs,), dtype=torch.float32, device=device) for _ in range(10)]
    launch_kernel(_lib(), "scim", "scim_rollout_random", device,
                  {"scim_rollout_random": 0} if launches is None else launches, *_consts(c),
                  seed_u64(seed), n_envs, int(n_steps), ptr_array(state0), ptr_array(outs))
    return outs


def scim_tc_ring_layout():
    """The random rollout's ring (csrc/fused_scim_tc.cu's ScimRing, in
    csrc/ring_pipe.cuh's RingLayout): consumer and producer warps, K steps a
    slot, slots, words a step, shared-memory bytes; computed here, without
    the library."""
    K, P = SCIM_TC_RING
    return named_ring_layout((4, 4 * P, K, 2, SCIM_TC_RING_WORDS,
                              2 * K * SCIM_TC_RING_WORDS * 128 * 4, 0))


def scim_rollout_buffer(c: ScimConsts, state0, actions):
    """The state after the float32 ``(T, 3, R, 128)`` duty buffer."""
    device, R = check_planes(c, state0)
    T = actions.shape[0] if isinstance(actions, torch.Tensor) and actions.dim() else 0
    check_tensor("actions", actions, (T, 3, R, LANE), torch.float32, device)
    if device.type == "cpu":
        return scim_rollout_buffer_plain(c, state0, actions)
    outs = [torch.empty((R, LANE), dtype=torch.float32, device=device) for _ in range(c.n_state)]
    launch_kernel(_lib(), "scim", "scim_rollout_buffer", device, LAUNCHES, *_consts(c),
                  R * LANE, T, ptr_array(state0), actions.data_ptr(), ptr_array(outs))
    return tuple(outs)


def make_fused_scim_rollout(env, n_steps, n_envs, action_mode="random"):
    """Fused rollout of a Cont-TC-SCIM-v0 env (``make_fused_scim_rollout``,
    pallas_induction.py:53): the alpha-beta ODE at constant speed under
    continuous B6 duties, the builder's Wiener torque reference, WSE, the
    squared current constraint and the in-kernel reset.

    ``rollout(seed, isa0, isb0, psa0, psb0) -> (isa, isb, psa, psb,
    reward_sum, term_count, rv, rk, rl, rs)``, each ``(n_envs // 128, 128)``
    float32; with ``action_mode='buffer'`` ``rollout(isa0, isb0, psa0,
    psb0, actions) -> (isa, isb, psa, psb)`` for a float32 ``(n_steps, 3,
    n_envs // 128, 128)`` duty buffer in [-1, 1]."""
    require_specialised_defaults(env)
    R = require_lanes(n_envs)
    c = ScimConsts(env)

    if action_mode == "buffer":
        def rollout(isa0, isb0, psa0, psb0, actions):
            state0 = (isa0, isb0, psa0, psb0)
            check_rollout_inputs(R, n_steps, state0, actions)
            return scim_rollout_buffer(c, state0, actions)
    else:
        require(action_mode == "random", action_mode)

        def rollout(seed, isa0, isb0, psa0, psb0):
            state0 = (isa0, isb0, psa0, psb0)
            check_rollout_inputs(R, n_steps, state0)
            return scim_rollout_random(c, seed, state0, n_steps)
    rollout.consts = c
    return rollout
