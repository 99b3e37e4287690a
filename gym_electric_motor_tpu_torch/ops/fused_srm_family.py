"""Universal switched reluctance (SRM) fused rollouts: the reducing rollout
and the trajectory recorder, each in a random-action and an action-buffer
mode, for the six ``{Finite, Cont} x {CC, TC, SC}`` SRM catalog ids at their
defaults, linear or with the opt-in saturating flux model
(``motor=dict(motor_parameter={"psi_s": ...})``).

Counterpart of ``_srm_family`` and ``make_fused_srm_rollout`` in
``gym_electric_motor_tpu/ops/pallas_srm.py`` and of the SRM family's part
of ``make_fused_record_rollout`` in ``ops/pallas_record.py``.  Four kernels
written in CUDA carry the work on the GPU, over the shared step of
``csrc/srm_step.cuh``:

======================= ================================================
``srm_rollout_random``   T random-action steps, reduced to the final state,
                         reward sums, termination counts and the final
                         reference rows (``csrc/fused_srm.cu``)
``srm_rollout_buffer``   T steps of a given action buffer, deterministic
                         (``csrc/fused_srm.cu``)
``srm_record_random``    the random step, every step recorded
                         (``csrc/fused_srm_record.cu``; on the continuous
                         ids with Wiener references producer warps draw and
                         consumer warps step, ``srm_record_ring_layout``)
``srm_record_buffer``    the buffer step, every state recorded
                         (``csrc/fused_srm_record.cu``)
======================= ================================================

Each kernel has a plain PyTorch version here (``*_plain``) with the same
arithmetic in the same order and the same Philox bits
(``fused_common.SyncBits`` with the three action words of a continuous B6
bridge, and the third reference row's slots for the three CC references).
A wrapper runs the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel (and counts the launch in ``LAUNCHES``) or
raises.

Public functions keep the JAX builder's layout: state planes ``(omega,)
i_a, i_b, i_c, eps`` (omega only under the polynomial load's dynamic speed)
are ``(n_envs // 128, 128)`` float32, per-step arrays ``(T, n_envs // 128,
128)``, an action buffer int32 ``(T, 3, n_envs // 128, 128)`` per-phase
commands (0 freewheel, 1 magnetise, 2 demagnetise) or float32 ``(T, 3,
n_envs // 128, 128)`` duties; the reference rows come out as ``(n_ref *
n_envs // 128, 128)``, row 0 first.

The inductance depends on the angle inside the step, so every RK4 stage
takes, per phase, sin and cos of ``eps - phi_k`` from one (cos eps, sin eps)
pair turned by the constant phase offsets, and divides by ``l0 - l1 c_k``
(a true division: the divisor is not a constant).  At constant speed in
random mode the pair rides the carried rotation and the stages take it
turned by the constant half- and full-step rotations; under the speed ODE
each stage takes cos and sin of its own integrated angle; in buffer mode the
pair is cos and sin of the cycle-start angle.  After the RK4 the currents
clamp at zero and the angle wraps to [-pi, pi) by a product with
float32(1 / (2 pi)) (where the env divides, so the two agree to float32
rounding); a torque reference takes cos and sin of the wrapped angle
afresh.

What raises ``NotImplementedError`` (naming the queue item that brings
it): everything ``fused_common.fused_check_system`` and
``fused_constraint_mode`` reject (the AC1 and RC supplies, dead time on the
three action planes, state noise, the OU and external-speed loads, other
constraint sets), ``randomize=`` (over r_s, l0, l1, j_rotor and u_sup),
other references than wiener and const on i_a, i_b, i_c, the torque or
(under a dynamic load) omega, and other counts of them than the catalog's
one (TC, SC) or three (CC).
"""

from __future__ import annotations

import ctypes
from types import SimpleNamespace
import math

import numpy as np
import torch

from .fused_common import (
    LANE,
    ROW_NAMES,
    TWO_PI,
    SyncBits,
    check_channel_actions,
    check_planes,
    check_rollout_inputs,
    family_library,
    fused_check_system,
    fused_constraint_mode,
    launch_kernel,
    named_ring_layout,
    policy_obs_spec,
    poly_load_rhs,
    ptr_array,
    ref_rows,
    reference_step,
    require,
    rotation_advance,
    seed_u64,
    system_limits,
    uniform_from_bits,
    wiener_init,
    wse_err,
)

_f32 = np.float32

# Order of the float constants, the same as SrmConstIndex in
# csrc/srm_step.cuh; then ROW_NAMES for each of three reference rows
# (RefRowIndex of csrc/common_step.cuh), and FLAG_NAMES as int32 (SrmFlag).
CONST_NAMES = (
    "u_sup", "half_tau", "tau", "sixth", "two_pi", "inv_two_pi", "pi", "p", "pw", "w_fixed",
    "r_s", "pl1", "l0", "l1", "sin_phi", "ch", "sh", "cos_d", "sin_d", "inv_psi_s", "psi_s2",
    "load_a", "load_b", "load_c", "omega_lin", "jt_over_td", "inv_jt",
    "inv_ilim", "bias", "violation_reward", "ln10", "u_min",
)
FLAG_NAMES = ("qty0", "qty1", "qty2", "all_const", "no_cons", "finite", "mech", "n_ref", "sat",
              "needs_torque")
QUANTITIES = ("i_a", "i_b", "i_c", "torque", "omega")
N_ROWS = 3  # reference rows the kernels carry constants for

KERNELS = ("srm_rollout_random", "srm_rollout_buffer", "srm_record_random", "srm_record_buffer")
# the controller-in-the-loop kernel (the SRM commutation cascade, csrc/fused_srm_cascade.cu)
CONTROL_KERNELS = ("srm_cascade_rollout",)
# the library of each kernel (csrc/<name>.cu)
LIBRARY = {"srm_rollout_random": "fused_srm", "srm_rollout_buffer": "fused_srm",
           "srm_record_random": "fused_srm_record", "srm_record_buffer": "fused_srm_record"}

# launches of each CUDA kernel since the last reset_launches()
LAUNCHES = dict.fromkeys(KERNELS + CONTROL_KERNELS, 0)

# the random recorder's ring (SrmRecordRing in csrc/fused_srm_record.cu): K
# steps a slot, producer warps per consumer warp
SRM_RECORD_RING = (8, 2)


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


class SrmConsts:
    """The baked constants of one env (``_srm_family``), as float32:
    ``host`` (floats) and ``flags`` (int32) are the arrays handed to the
    kernels, ``f`` and ``rows`` the same values as Python floats for the
    plain versions.  Raises ``NotImplementedError`` for what the kernels do
    not simulate (see the module docstring).

    The constants follow the JAX family (pallas_srm.py:121-143, :242-246):
    ``p l1``, the stage rotations ``cos``/``sin`` of ``0.5 tau p omega`` and
    ``tau p omega``, ``1 / psi_s`` and ``psi_s^2`` are formed in double and
    rounded once; the RK4's ``tau / 6`` is the float32 quotient of
    float32(tau), as the JAX kernel divides its float32 step."""

    def __init__(self, env):
        ps = fused_check_system(env.physical_system)
        if ps.motor.kind != "SRM":
            raise NotImplementedError(f"the SRM-family kernels need an SRM, got {ps.motor.kind!r}")
        if ps.converter.kind not in ("Finite-ASYM", "Cont-ASYM"):
            raise NotImplementedError(
                "the SRM-family kernels need the asymmetric bridge, got "
                f"{ps.converter.kind!r}")
        if ps.dtype != torch.float32:
            raise NotImplementedError("the fused kernels run in float32")
        self.no_cons = fused_constraint_mode(env, (("limit", ("i_a", "i_b", "i_c")),)) == "none"
        self.finite = ps.converter.action_type == "finite"
        self.mech = ps.load.kind == "PolynomialStaticLoad"
        self.rows = ref_rows(env)
        self.n_ref = len(self.rows)
        if self.n_ref not in (1, N_ROWS):
            raise NotImplementedError(
                f"the SRM-family kernels take the catalog's 1 or 3 references, got "
                f"{self.n_ref}; other counts arrive with queue 2, item 8 (_make_wiener's "
                "reference sets)")
        for row in self.rows:
            if row["name"] not in QUANTITIES or (row["name"] == "omega" and not self.mech):
                raise NotImplementedError(
                    f"a reference on {row['name']!r} is not fused for this system; the kernels "
                    "reference i_a, i_b, i_c, torque, and omega under a dynamic load")
        names = list(ps.state_names)
        rw = env.reward_function
        scored = {names[i] for i in np.flatnonzero(np.asarray(rw._weights))}
        if not scored <= {row["name"] for row in self.rows}:
            raise NotImplementedError(
                f"the fused kernels score the referenced states only; the reward weighs "
                f"{sorted(scored)}")
        self.all_const = all(row["kind"] == "const" for row in self.rows)
        self.needs_torque = any(row["name"] == "torque" for row in self.rows)
        # three action planes, and the three Philox words a random step
        # draws for them (a continuous B6 bridge's three duty words)
        self.n_act = self.n_words = 3
        self.state_names = (("omega",) if self.mech else ()) + ("i_a", "i_b", "i_c", "eps")
        self.n_state = len(self.state_names)
        self.act_names = ("action_a", "action_b", "action_c")

        mp = {key: float(v) for key, v in ps.motor.parameter.items()}
        r_s, l0, l1, p = mp["r_s"], mp["l0"], mp["l1"], mp["p"]
        psi_s = mp.get("psi_s")
        self.sat = psi_s is not None and psi_s > 0.0
        lim = np.asarray(ps.limits)
        omega = 0.0 if self.mech else float(ps.load.omega_fixed)
        tau = float(ps.tau)
        values = dict(
            u_sup=float(ps.supply.u_nominal), half_tau=_f32(0.5) * _f32(tau), tau=tau,
            sixth=_f32(tau) / _f32(6.0), two_pi=TWO_PI, inv_two_pi=1.0 / TWO_PI, pi=math.pi,
            p=p, pw=p * omega, w_fixed=omega, r_s=r_s, pl1=p * l1, l0=l0, l1=l1,
            sin_phi=math.sqrt(3.0) / 2.0,
            ch=np.cos(0.5 * tau * p * omega), sh=np.sin(0.5 * tau * p * omega),
            cos_d=np.cos(tau * p * omega), sin_d=np.sin(tau * p * omega),
            inv_psi_s=1.0 / psi_s if self.sat else 0.0, psi_s2=psi_s**2 if self.sat else 0.0,
            load_a=0.0, load_b=0.0, load_c=0.0, omega_lin=0.0, jt_over_td=0.0, inv_jt=0.0,
            inv_ilim=1.0 / float(lim[names.index("i_a")]),
            bias=rw._bias_value, violation_reward=rw._violation_value,
            ln10=np.log(10.0), u_min=1e-12,
        )
        if self.mech:
            lp = ps.load.parameter
            a, j_total = float(lp["a"]), float(ps.load.j_load) + mp["j_rotor"]
            tau_decay = 1e-3
            values.update(load_a=a, load_b=float(lp["b"]), load_c=float(lp["c"]),
                          omega_lin=a / j_total * tau_decay, jt_over_td=j_total / tau_decay,
                          inv_jt=1.0 / j_total)
        floats = [_f32(values[n]) for n in CONST_NAMES]
        for j in range(N_ROWS):
            floats += [_f32(self.rows[min(j, self.n_ref - 1)][n]) for n in ROW_NAMES]
        self.host = np.array(floats, dtype=np.float32)
        self.f = {n: float(v) for n, v in zip(CONST_NAMES, self.host)}
        codes = [QUANTITIES.index(row["name"]) for row in self.rows]
        codes += [codes[-1]] * (N_ROWS - len(codes))
        flags = dict(qty0=codes[0], qty1=codes[1], qty2=codes[2], all_const=int(self.all_const),
                     no_cons=int(self.no_cons), finite=int(self.finite), mech=int(self.mech),
                     n_ref=self.n_ref, sat=int(self.sat), needs_torque=int(self.needs_torque))
        self.flags = np.array([flags[n] for n in FLAG_NAMES], dtype=np.int32)


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def srm_phases(k, ce, se):
    """Per-phase ``sin`` and ``cos`` of ``eps - phi_k`` from one (cos eps,
    sin eps) pair and the constant offsets cos phi_k = (1, -1/2, -1/2), sin
    phi_k = (0, sqrt(3) / 2, -sqrt(3) / 2) (``_trig_cs``, pallas_srm.py:
    145-151; phase a is the pair itself)."""
    sp = k["sin_phi"]
    return ((se, se * -0.5 - ce * sp, se * -0.5 - ce * -sp),
            (ce, ce * -0.5 + se * sp, ce * -0.5 + se * -sp))


def srm_torque(c: SrmConsts, i3, s_k, l_k, x_e):
    """The reluctance torque from the phases' slope sines ``s_k`` and
    inductances ``l_k`` (``_tq``, pallas_srm.py:157-173): ``p l1 (1/2) sum
    i^2 s_k``, or the coenergy form with ``x_e`` = the phases' (x, e) when
    saturating."""
    k = c.f
    if not c.sat:
        return k["pl1"] * (0.5 * (i3[0] * i3[0] * s_k[0] + i3[1] * i3[1] * s_k[1]
                                  + i3[2] * i3[2] * s_k[2]))
    terms = [(k["pl1"] * s * k["psi_s2"] / (l * l)) * ((1.0 - e) - x * e)
             for s, l, (x, e) in zip(s_k, l_k, x_e)]
    return terms[0] + terms[1] + terms[2]


def _saturation(c, i3, l_k):
    """Per phase (x, e) = (i L_k / psi_s, exp(-x)) when saturating."""
    if not c.sat:
        return None
    out = []
    for i, l in zip(i3, l_k):
        x = i * l * c.f["inv_psi_s"]
        out.append((x, torch.exp(-x)))
    return out


def srm_torque_at(c: SrmConsts, i3, ce, se):
    """The torque at the angle whose (cos, sin) are given."""
    s_k, c_k = srm_phases(c.f, ce, se)
    l_k = [c.f["l0"] - c.f["l1"] * ck for ck in c_k]
    return srm_torque(c, i3, s_k, l_k, _saturation(c, i3, l_k))


def _rhs(c: SrmConsts, w, i3, ce, se, u3):
    """``(d omega or None, (d i_a, d i_b, d i_c))`` at one RK4 stage
    (``rhs``, pallas_srm.py:179-226)."""
    k = c.f
    s_k, c_k = srm_phases(k, ce, se)
    l_k = [k["l0"] - k["l1"] * ck for ck in c_k]
    x_e = _saturation(c, i3, l_k)
    wv = w if c.mech else k["w_fixed"]
    if c.sat:
        di = tuple(((u - k["r_s"] * i) - ((i * (k["pl1"] * s)) * wv) * e) / (l * e)
                   for u, i, s, l, (_x, e) in zip(u3, i3, s_k, l_k, x_e))
    else:
        di = tuple(((u - k["r_s"] * i) - (i * (k["pl1"] * s)) * wv) / l
                   for u, i, s, l in zip(u3, i3, s_k, l_k))
    dw = poly_load_rhs(k, w, srm_torque(c, i3, s_k, l_k, x_e)) if c.mech else None
    return dw, di


def srm_fractions(c: SrmConsts, action):
    """The phase voltages as fractions of the supply voltage (``fracs``,
    pallas_srm.py:228-235): finite ``(a == 1) - (a == 2)``, cont the duty
    clipped to [-1, 1]."""
    if c.finite:
        return tuple((a == 1).to(torch.float32) - (a == 2).to(torch.float32) for a in action)
    return tuple(torch.clamp(a, -1.0, 1.0) for a in action)


def srm_physics(c: SrmConsts, action, cs, st):
    """Fractions times the supply voltage -> RK4 over (omega?, i_a, i_b,
    i_c, eps) -> the currents clamped at zero -> eps wrapped to [-pi, pi)
    (``rk4``, ``physics_step`` and the kernels' wrap, pallas_srm.py:248-294,
    :460-462).  At
    constant speed ``cs`` is (cos, sin) of the cycle-start angle and the
    stages turn it by the half- and full-step rotations; under the speed ODE
    every stage takes cos and sin of its own angle.  ``st`` and the result
    are dicts of planes ``w`` (dynamic speed), ``ia``, ``ib``, ``ic``,
    ``eps``."""
    k = c.f
    u3 = tuple(f * k["u_sup"] for f in srm_fractions(c, action))
    h, dt, sixth = k["half_tau"], k["tau"], k["sixth"]
    w, eps = st.get("w"), st["eps"]
    i3 = (st["ia"], st["ib"], st["ic"])

    def trig(e):
        return torch.cos(e), torch.sin(e)

    if c.mech:
        cs1 = trig(eps)
    else:
        c0, s0 = cs
        cs1 = cs
        csh = (c0 * k["ch"] - s0 * k["sh"], s0 * k["ch"] + c0 * k["sh"])
        csf = (c0 * k["cos_d"] - s0 * k["sin_d"], s0 * k["cos_d"] + c0 * k["sin_d"])

    def axpy(x, d, step):
        return tuple(xi + step * di for xi, di in zip(x, d))

    k1w, k1 = _rhs(c, w, i3, *cs1, u3)
    if c.mech:
        p = k["p"]
        w2 = w + h * k1w
        k2w, k2 = _rhs(c, w2, axpy(i3, k1, h), *trig(eps + h * (p * w)), u3)
        w3 = w + h * k2w
        k3w, k3 = _rhs(c, w3, axpy(i3, k2, h), *trig(eps + h * (p * w2)), u3)
        w4 = w + dt * k3w
        k4w, k4 = _rhs(c, w4, axpy(i3, k3, dt), *trig(eps + dt * (p * w3)), u3)
    else:
        _, k2 = _rhs(c, None, axpy(i3, k1, h), *csh, u3)
        _, k3 = _rhs(c, None, axpy(i3, k2, h), *csh, u3)
        _, k4 = _rhs(c, None, axpy(i3, k3, dt), *csf, u3)
    out = {}
    if c.mech:
        eps = eps + sixth * (p * w + 2.0 * (p * w2 + p * w3) + p * w4)
        out["w"] = w + sixth * (k1w + 2.0 * (k2w + k3w) + k4w)
    else:
        de = _f32(k["pw"])
        eps = eps + float(_f32(sixth) * (de + _f32(2.0) * (de + de) + de))
    for key, x, a1, a2, a3, a4 in zip(("ia", "ib", "ic"), i3, k1, k2, k3, k4):
        x = x + sixth * (a1 + 2.0 * (a2 + a3) + a4)
        out[key] = torch.where(x < 0.0, torch.zeros_like(x), x)  # the ideal diodes
    out["eps"] = eps - k["two_pi"] * torch.floor((eps + k["pi"]) * k["inv_two_pi"])
    return out


def srm_quantity(c: SrmConsts, j, st):
    """Row ``j``'s referenced quantity over its limit (``ref_quantity``,
    pallas_srm.py:314-325): a torque takes cos and sin of the (wrapped)
    angle afresh."""
    name = c.rows[j]["name"]
    if name == "omega":
        q = st["w"]
    elif name == "torque":
        q = srm_torque_at(c, (st["ia"], st["ib"], st["ic"]), torch.cos(st["eps"]),
                          torch.sin(st["eps"]))
    else:
        q = st[{"i_a": "ia", "i_b": "ib", "i_c": "ic"}[name]]
    return q * c.rows[j]["inv_lim"]


def _state_keys(c):
    return (("w",) if c.mech else ()) + ("ia", "ib", "ic", "eps")


def srm_action_step(c: SrmConsts, st, action, cs):
    """One step under ``action``: physics, the limit constraint on the three
    phase currents (pallas_srm.py:387-393), the WSE reward against the
    pre-advance references, the reset of a violating env to zeros (the
    angle too) and, at constant speed, the incremental rotation.  Returns
    the new state dict (the reference rows carried over) and ``(action,
    reward, done, refs)``."""
    k = c.f
    y = srm_physics(c, action, cs, st)
    if c.no_cons:
        violated = torch.zeros_like(y["ia"], dtype=torch.bool)
    else:
        violated = ((torch.abs(y["ia"]) * k["inv_ilim"] > 1.0)
                    | (torch.abs(y["ib"]) * k["inv_ilim"] > 1.0)
                    | (torch.abs(y["ic"]) * k["inv_ilim"] > 1.0))
    wse = k["bias"] - wse_err(c.rows[0], srm_quantity(c, 0, y), st["rv"][0])
    for j in range(1, c.n_ref):
        wse = wse - wse_err(c.rows[j], srm_quantity(c, j, y), st["rv"][j])
    reward = torch.where(violated, torch.full_like(wse, k["violation_reward"]), wse)
    out = (action, reward, violated.to(torch.float32), list(st["rv"]))
    new = dict(st, rv=list(st["rv"]), rk=list(st["rk"]), rl=list(st["rl"]), rs=list(st["rs"]))
    zero = torch.zeros_like(y["ia"])
    for key in _state_keys(c):
        new[key] = torch.where(violated, zero, y[key])
    if not c.mech:
        new["c"], new["s"] = rotation_advance(k, cs[0], cs[1], violated)
    return new, out


def _random_init(c: SrmConsts, bits, states):
    shape, device = states[0].shape, states[0].device
    st = {key: x.clone() for key, x in zip(_state_keys(c), states)}
    if not c.mech:
        st["c"], st["s"] = torch.cos(st["eps"]), torch.sin(st["eps"])
    words = None if c.all_const else bits.init_words()
    st["rv"], st["rk"], st["rl"], st["rs"] = wiener_init(c.f, c.rows, c.all_const, words, shape,
                                                         device)
    st["zb"] = torch.zeros(shape, dtype=torch.float32, device=device)
    return st


def _random_action(c: SrmConsts, acts):
    """The action of a step's three words (``_sample_actions``,
    pallas_srm.py:327-335): finite, ``min(int(3 u), 2)`` per phase;
    continuous, three duties ``2 u - 1``."""
    if c.finite:
        return tuple(torch.clamp((uniform_from_bits(w) * 3.0).to(torch.int32), max=2)
                     for w in acts)
    return tuple(2.0 * uniform_from_bits(w) - 1.0 for w in acts)


def _random_step(c: SrmConsts, st, words, t):
    """One random-mode step (``make_fused_srm_rollout``'s ``body``,
    pallas_srm.py:494-544): the action, the action step at the carried
    rotation (constant speed), then the reference advance.  ``words`` =
    ``(actions, u1, u2, lengths, sigmas, resets)`` of the bit source."""
    shape = st["ia"].shape
    acts, *ref_words = words
    action = _random_action(c, [w.reshape(shape) for w in acts])
    new, out = srm_action_step(c, st, action, None if c.mech else (st["c"], st["s"]))
    reference_step(c.f, c.rows, c.all_const, st, new, ref_words, out[2] > 0.5, t)
    return new, out


def _bits(c, seed, states, bits):
    return bits or SyncBits(seed, states[0].numel(), states[0].device, c.n_ref, c.n_words)


def srm_rollout_random_plain(c: SrmConsts, seed, states, n_steps, bits=None):
    """Plain version of ``srm_rollout_random``: ``(*states, reward_sum,
    term_count, rv, rk, rl, rs)``.  ``bits`` replaces the Philox bit source
    (an object with ``init_words()`` and ``step_words(t)``, see
    ``fused_common.SyncBits``)."""
    bits = _bits(c, seed, states, bits)
    st = _random_init(c, bits, states)
    reward = torch.zeros_like(states[0])
    terms = torch.zeros_like(states[0])
    for t in range(n_steps):
        st, (_a, r, done, _refs) = _random_step(c, st, bits.step_words(t), t)
        reward = reward + r
        terms = terms + done
    return (tuple(st[key] for key in _state_keys(c)) + (reward, terms)
            + tuple(torch.cat(st[key]) for key in ("rv", "rk", "rl", "rs")))


def record_dtypes(c: SrmConsts):
    """The dtypes of the random recorder's signals, in order."""
    act = torch.int32 if c.finite else torch.float32
    return ((torch.float32,) * (c.n_state + c.n_ref) + (act,) * c.n_act
            + (torch.float32, torch.float32))


def srm_record_random_plain(c: SrmConsts, seed, states, n_steps, bits=None):
    """Plain version of ``srm_record_random``: per step the post-reset
    states, the references the reward was taken against, the three actions
    (int32 commands or float32 duties), the reward and the done flag, each
    ``(T, R, 128)``."""
    bits = _bits(c, seed, states, bits)
    st = _random_init(c, bits, states)
    rec = [[] for _ in record_dtypes(c)]
    for t in range(n_steps):
        st, (a, r, done, refs) = _random_step(c, st, bits.step_words(t), t)
        row = [st[key] for key in _state_keys(c)] + refs + list(a) + [r, done]
        for lst, x in zip(rec, row):
            lst.append(x)
    if n_steps == 0:
        return tuple(torch.empty((0,) + tuple(states[0].shape), dtype=dt, device=states[0].device)
                     for dt in record_dtypes(c))
    return tuple(torch.stack(lst) for lst in rec)


def _buffer_step(c, st, actions, t):
    """A buffer step: (cos, sin) of the cycle-start angle afresh, also at
    constant speed (pallas_srm.py:553-565)."""
    action = tuple(actions[t, j] for j in range(c.n_act))
    return srm_physics(c, action, (torch.cos(st["eps"]), torch.sin(st["eps"])), st)


def srm_rollout_buffer_plain(c: SrmConsts, states, actions):
    """Plain version of ``srm_rollout_buffer``: the final states (no
    references, no reset)."""
    st = dict(zip(_state_keys(c), states))
    for t in range(actions.shape[0]):
        st = _buffer_step(c, st, actions, t)
    return tuple(st[key].clone() for key in _state_keys(c))


def srm_record_buffer_plain(c: SrmConsts, states, actions):
    """Plain version of ``srm_record_buffer``: every step's states, each
    ``(T, R, 128)``."""
    st = dict(zip(_state_keys(c), states))
    T = actions.shape[0]
    out = torch.empty((c.n_state, T) + tuple(states[0].shape), dtype=torch.float32,
                      device=states[0].device)
    for t in range(T):
        st = _buffer_step(c, st, actions, t)
        for j, key in enumerate(_state_keys(c)):
            out[j, t] = st[key]
    return tuple(out[j] for j in range(c.n_state))


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    "srm_rollout_random": [_P, _P, ctypes.c_uint64, _I, _I, _P, _P, _P],
    "srm_rollout_buffer": [_P, _P, _I, _I, _P, _P, _P, _P, _P],
    "srm_record_random": [_P, _P, ctypes.c_uint64, _I, _I, _P, _P, _P],
    "srm_record_buffer": [_P, _P, _I, _I, _P, _P, _P, _P, _P],
}


def _launch(name, device, *args, launches=LAUNCHES):
    lib = family_library(LIBRARY[name], "srm", _ARGTYPES,
                         (len(CONST_NAMES), len(ROW_NAMES), len(FLAG_NAMES)))
    launch_kernel(lib, "srm", name, device, launches, *args)


def _with_omega(c, planes):
    """(omega or NULL, the four other planes)."""
    return ([] if c.mech else [None]) + list(planes)


def _buffer_args(c, actions):
    return (actions.data_ptr(), None) if c.finite else (None, actions.data_ptr())


def srm_rollout_random(c: SrmConsts, seed: int, states, n_steps: int):
    """``(*states, reward_sum, term_count, rv, rk, rl, rs)``."""
    device, R = check_planes(c, states)
    if device.type == "cpu":
        return srm_rollout_random_plain(c, seed, tuple(states), n_steps)

    def plane(rows=1):
        return torch.empty((rows * R, LANE), dtype=torch.float32, device=device)
    outs = [plane() for _ in range(c.n_state + 2)] + [plane(c.n_ref) for _ in range(4)]
    _launch("srm_rollout_random", device, c.host.ctypes.data, c.flags.ctypes.data,
            seed_u64(seed), R * LANE, int(n_steps), ptr_array(_with_omega(c, states)),
            ptr_array(_with_omega(c, outs)))
    return tuple(outs)


def srm_rollout_buffer(c: SrmConsts, states, actions):
    """The final states after the action buffer."""
    device, R = check_planes(c, states)
    T = check_channel_actions(c, actions, R, device)
    if device.type == "cpu":
        return srm_rollout_buffer_plain(c, tuple(states), actions)
    outs = [torch.empty((R, LANE), dtype=torch.float32, device=device) for _ in range(c.n_state)]
    _launch("srm_rollout_buffer", device, c.host.ctypes.data, c.flags.ctypes.data, R * LANE, T,
            ptr_array(_with_omega(c, states)), *_buffer_args(c, actions),
            ptr_array(_with_omega(c, outs)))
    return tuple(outs)


def srm_record_random(c: SrmConsts, seed: int, states, n_steps: int):
    """``(*states, *refs, *actions, reward, done)``, each ``(T, R, 128)``."""
    device, R = check_planes(c, states)
    if device.type == "cpu":
        return srm_record_random_plain(c, seed, tuple(states), n_steps)
    outs = _record_random_launch(c, seed, states, n_steps, R * LANE, LAUNCHES)
    return tuple(x.view(int(n_steps), R, LANE) for x in outs)


def _record_random_launch(c: SrmConsts, seed: int, states, n_steps: int, n_envs: int,
                          launches=None):
    """srm_record_random's kernel on the first ``n_envs`` envs of the
    planes: the recorded signals, each ``(T, n_envs)``; the launch counted
    in ``launches`` (none: not counted)."""
    outs, args = _record_random_args(c, seed, states, n_steps, n_envs)
    _launch("srm_record_random", states[0].device, *args,
            launches={"srm_record_random": 0} if launches is None else launches)
    return outs


def _record_random_args(c: SrmConsts, seed: int, states, n_steps: int, n_envs: int):
    """The recorder's output tensors, each ``(T, n_envs)``, and its C
    arguments before the stream."""
    outs = [torch.empty((int(n_steps), n_envs), dtype=dt, device=states[0].device)
            for dt in record_dtypes(c)]
    it = iter(outs)
    st = [next(it) for _ in range(c.n_state)]
    refs = [next(it) for _ in range(c.n_ref)]
    acts = [next(it) for _ in range(c.n_act)]
    reward, done = next(it), next(it)
    ptr_list = (_with_omega(c, st) + refs + [None] * (N_ROWS - c.n_ref)
                + (acts + [None] * 3 if c.finite else [None] * 3 + acts) + [reward, done])
    return outs, (c.host.ctypes.data, c.flags.ctypes.data, seed_u64(seed), n_envs,
                  int(n_steps), ptr_array(_with_omega(c, states)), ptr_array(ptr_list))


def srm_record_ring_layout(c: SrmConsts):
    """The random recorder's ring for ``c``'s instance (csrc/fused_srm_record.cu's
    SrmRecordRing, in csrc/ring_pipe.cuh's RingLayout): consumer and
    producer warps, K steps a slot, slots, words a step (the three duties,
    then four per reference row),
    shared-memory bytes; one thread per env with constant references and on
    the finite ids (``srm_record_on_ring``: only the continuous instances
    take the ring).  Computed here, without the library."""
    if c.all_const or c.finite:
        return named_ring_layout((0,) * 6 + (1,))
    K, P = SRM_RECORD_RING
    words = 3 + 4 * c.n_ref
    return named_ring_layout((4, 4 * P, K, 2, words, 2 * K * words * LANE * 4, 0))


def srm_record_buffer(c: SrmConsts, states, actions):
    """Every step's states, each ``(T, R, 128)``."""
    device, R = check_planes(c, states)
    T = check_channel_actions(c, actions, R, device)
    if device.type == "cpu":
        return srm_record_buffer_plain(c, tuple(states), actions)
    outs = [torch.empty((T, R, LANE), dtype=torch.float32, device=device)
            for _ in range(c.n_state)]
    _launch("srm_record_buffer", device, c.host.ctypes.data, c.flags.ctypes.data, R * LANE, T,
            ptr_array(_with_omega(c, states)), *_buffer_args(c, actions),
            ptr_array(_with_omega(c, outs)))
    return tuple(outs)


# ---------------------------------------------------------------------------
# builder (the JAX package's entry point)
# ---------------------------------------------------------------------------


def make_fused_srm_rollout(env, n_steps, n_envs, action_mode="random", randomize=None):
    """Universal fused rollout for the switched reluctance family: the six
    ``{Finite, Cont} x {CC, TC, SC}`` SRM catalog ids, linear or saturating.

    * random mode: ``rollout(seed, *state0) -> (*states, reward_sum,
      term_count, rv, rk, rl, rs)``; states = (omega?, i_a, i_b, i_c, eps),
      ``(n_envs // 128, 128)`` float32 planes, the reference rows
      ``(n_ref * n_envs // 128, 128)``.
    * buffer mode: ``rollout(*state0, actions) -> states`` with an int32
      ``(n_steps, 3, n_envs // 128, 128)`` (finite: per-phase 0 freewheel,
      1 magnetise, 2 demagnetise) or float32 ``(n_steps, 3, n_envs // 128,
      128)`` (cont duties) action buffer; deterministic physics only.

    The device is that of the inputs."""
    if randomize:
        raise NotImplementedError(
            "domain randomization (randomize=) is not fused yet; it arrives with queue 2, "
            "item 7 of the port (r_s, l0, l1, j_rotor and u_sup as per-env planes)")
    if n_envs % LANE:
        raise ValueError(f"n_envs must be a multiple of {LANE}")
    R = n_envs // LANE
    c = SrmConsts(env)
    if action_mode == "random":
        def rollout(seed, *state0):
            check_rollout_inputs(R, n_steps, state0)
            return srm_rollout_random(c, seed, state0, n_steps)
        rollout.consts = c
        return rollout
    if action_mode != "buffer":
        raise ValueError(f"action_mode must be 'random' or 'buffer', got {action_mode!r}")

    def rollout(*args):
        *state0, actions = args
        check_rollout_inputs(R, n_steps, state0, actions)
        return srm_rollout_buffer(c, state0, actions)
    rollout.consts = c
    return rollout


# ---------------------------------------------------------------------------
# the universal policy recorder's view of the family
# ---------------------------------------------------------------------------


def policy_surface(c: SrmConsts, env):
    """What ``ops.fused_policy.make_fused_policy_record_universal`` needs of
    the family (the policy-adapter surface of ``_srm_family``,
    pallas_srm.py:398-409): the observation spec (omega, the three phase
    currents over their limit, the angle as cos/sin), the heads (3, 3, 3)
    of the per-phase commands or three duties in [-1, 1], and the plain
    step.  ``aux`` gives (cos, sin) of the angle: the carried rotation at
    constant speed, of the angle under the speed ODE (where the step takes
    its own) or ``afresh``."""
    ps, names, lim = system_limits(env)
    i_lim, w_lim = float(lim[names.index("i_a")]), float(lim[names.index("omega")])
    off, i_eps = int(c.mech), c.n_state - 1
    obs_spec = policy_obs_spec(c.mech, w_lim, ps.load.omega_fixed, [
        ("state", off, 1.0 / i_lim), ("state", off + 1, 1.0 / i_lim),
        ("state", off + 2, 1.0 / i_lim), ("cos", i_eps), ("sin", i_eps)])

    def aux(st, afresh=False):
        if c.mech or afresh:
            return torch.cos(st["eps"]), torch.sin(st["eps"])
        return st["c"], st["s"]

    return SimpleNamespace(
        family="srm", consts=c, obs_spec=obs_spec, act_ns=(3, 3, 3) if c.finite else None,
        act_range=None if c.finite else (np.full(3, -1.0, _f32), np.ones(3, _f32)),
        state_keys=_state_keys(c), init=lambda bits, states: _random_init(c, bits, states),
        aux=aux, aux_cs=lambda a: a,
        quantities=lambda st, a: [srm_quantity(c, j, st) for j in range(c.n_ref)],
        action=tuple,
        step=lambda st, action, a: srm_action_step(c, st, action, None if c.mech else a),
        planes=lambda planes: _with_omega(c, planes))


# ---------------------------------------------------------------------------
# the commutation cascade in the loop (make_fused_srm_cascade_rollout)
# ---------------------------------------------------------------------------

# Order of the controller's float constants, the same as SrmCascadeIndex in
# csrc/control_laws.cuh.
CASCADE_CONST_NAMES = (
    "kp_w", "ki_w", "t_max", "neg_t_max", "w_lim", "inv_w_lim", "inv_i_lim", "t_lim", "ki_t",
    "tau_c", "trim_lo", "trim_hi", "pl1", "theta_on", "hyst", "kp_i", "ff_i", "i_max",
    "cph0", "cph1", "cph2", "sph0", "sph1", "sph2", "s_min", "i_star_min",
)
TASK_CODES = {"CC": 0, "TC": 1, "SC": 2}

class SrmCascadeConsts:
    """The baked constants of the SRM commutation cascade in the loop
    (``make_fused_srm_cascade_rollout``, pallas_srm.py:650-702): ``c`` the
    family's (``SrmConsts``), ``task`` the control task, ``host`` the tuned
    controller's constants in ``CASCADE_CONST_NAMES`` order as float32 and
    ``f`` the same as Python floats.  Each is formed by the JAX kernel's
    own expression over the same ``np.float32`` operands (``1.0 / I_LIM``,
    ``-0.3 * T_LIM``, ...), so it rounds as there."""

    def __init__(self, env, ctrl):
        from ..controllers.srm import SRMCommutationController

        require(isinstance(ctrl, SRMCommutationController),
                 "the SRM cascade kernel takes an SRMCommutationController")
        task = ctrl.control_task
        require(task in TASK_CODES, f"unknown control task {task!r}")
        c = SrmConsts(env)
        require(c.finite == (ctrl.action_type == "Finite"),
                 "the controller's converter is not the env's")
        names = [row["name"] for row in c.rows]
        if task == "SC":
            require(c.mech and c.n_ref == 1 and names == ["omega"],
                     "SC takes the speed ODE and one omega reference")
        elif task == "TC":
            require(c.n_ref == 1 and names == ["torque"], "TC takes one torque reference")
        else:
            require(names == ["i_a", "i_b", "i_c"], "CC takes the three phase currents")
        if c.mech != (task == "SC"):
            raise NotImplementedError(
                f"the SRM cascade kernel runs {task} at the catalog's "
                f"{'dynamic' if task == 'SC' else 'constant'} speed; run other loads on the "
                "general path (control_environment)")
        self.c, self.task = c, TASK_CODES[task]
        f32 = np.float32
        KP_W, KI_W, T_MAX = f32(ctrl.kp_w), f32(ctrl.ki_w), f32(ctrl.t_max)
        W_LIM, I_LIM, T_LIM = f32(ctrl.w_lim), f32(ctrl.i_lim), f32(ctrl.t_lim)
        cph = (1.0, -0.5, -0.5)
        sph = (0.0, float(np.sqrt(3.0) / 2.0), float(-np.sqrt(3.0) / 2.0))
        values = dict(
            kp_w=KP_W, ki_w=KI_W, t_max=T_MAX, neg_t_max=-T_MAX, w_lim=W_LIM,
            inv_w_lim=1.0 / W_LIM, inv_i_lim=1.0 / I_LIM, t_lim=T_LIM, ki_t=f32(ctrl.ki_t),
            tau_c=f32(ctrl.tau), trim_lo=-0.3 * T_LIM, trim_hi=0.3 * T_LIM,
            pl1=f32(ctrl.p * ctrl.l1), theta_on=f32(ctrl.theta_on), hyst=f32(ctrl.hysteresis),
            kp_i=f32(ctrl.kp_i), ff_i=f32(ctrl.r_s * ctrl.i_lim / ctrl.u_lim),
            i_max=f32((1.0 - ctrl.current_margin) * ctrl.i_lim),
            cph0=cph[0], cph1=cph[1], cph2=cph[2], sph0=sph[0], sph1=sph[1], sph2=sph[2],
            s_min=0.05, i_star_min=1e-6,
        )
        self.host = np.array([f32(values[n]) for n in CASCADE_CONST_NAMES], dtype=np.float32)
        self.f = {n: float(v) for n, v in zip(CASCADE_CONST_NAMES, self.host)}


def srm_commutate(q, t_ref, ce, se):
    """Single-pulse commutation with the sqrt linearization (``_commutate``,
    pallas_srm.py:718-735): the normalised per-phase setpoints for the
    torque ``t_ref`` at the cycle-start (cos, sin) of the angle.  Only the
    phase with the largest usable slope fires (a tie fires two)."""
    sign = torch.sign(t_ref)
    s_k = [se * q[f"cph{k}"] - ce * q[f"sph{k}"] for k in range(3)]
    gain = [s * sign for s in s_k]
    gmax = torch.maximum(gain[0], torch.maximum(gain[1], gain[2]))
    out = []
    for k in range(3):
        fire = (gain[k] > q["theta_on"]) & (gain[k] >= gmax)
        i_cmd = torch.sqrt(2.0 * torch.abs(t_ref)
                           / (q["pl1"] * torch.clamp(torch.abs(s_k[k]), min=q["s_min"])))
        i_star = torch.where(fire, torch.clamp(i_cmd, max=q["i_max"]), torch.zeros_like(i_cmd))
        out.append(i_star * q["inv_i_lim"])
    return out


def srm_regulate(q, finite, i3, i_star_n):
    """Per-phase regulation toward the normalised setpoints (``_regulate``,
    pallas_srm.py:703-716): a hysteresis band on a finite converter (1
    magnetise, 2 demagnetise, inside the band 0 while a setpoint exists and
    2 otherwise, int32), P plus the resistive feed-forward duty on a
    continuous one."""
    acts = []
    for i, i_star in zip(i3, i_star_n):
        i_n = i * q["inv_i_lim"]
        if finite:
            one, two, zero = (torch.full_like(i_n, v, dtype=torch.int32) for v in (1, 2, 0))
            mag = i_n < i_star - q["hyst"]
            dem = i_n > i_star + q["hyst"]
            hold = torch.where(i_star > q["i_star_min"], zero, two)
            acts.append(torch.where(mag, one, torch.where(dem, two, hold)))
        else:
            duty = q["kp_i"] * (i_star - i_n) + q["ff_i"] * i_star
            acts.append(torch.clamp(duty, -1.0, 1.0))
    return tuple(acts)


def srm_cascade_law(cc: SrmCascadeConsts, st, integ, ce, se):
    """One cycle of the commutation cascade (``control``, pallas_srm.py:
    737-758) on the state dict ``st``: CC regulates toward the three
    references; TC trims the torque command by the integral of the error
    against the measured coenergy torque (clipped to +-0.3 T_lim); SC runs
    the anti-windup PI speed loop (equality test); both then commutate.
    Returns the new integrator and the action."""
    q, c = cc.f, cc.c
    i3 = (st["ia"], st["ib"], st["ic"])
    if cc.task == 0:
        return integ, srm_regulate(q, c.finite, i3, st["rv"])
    if cc.task == 1:
        t_star = st["rv"][0] * q["t_lim"]
        t_meas = srm_quantity(c, 0, st) * q["t_lim"]
        integ = torch.clamp(integ + q["ki_t"] * (t_star - t_meas) * q["tau_c"],
                            q["trim_lo"], q["trim_hi"])
        t_ref = t_star + integ
    else:
        w_err = (st["rv"][0] - st["w"] * q["inv_w_lim"]) * q["w_lim"]
        t_raw = q["kp_w"] * w_err + integ
        t_ref = torch.clamp(t_raw, q["neg_t_max"], q["t_max"])
        integ = integ + torch.where(t_raw == t_ref, q["ki_w"] * w_err * q["tau_c"],
                                    torch.zeros_like(w_err))
    return integ, srm_regulate(q, c.finite, i3, srm_commutate(q, t_ref, ce, se))


def srm_cascade_rollout_plain(cc: SrmCascadeConsts, seed, states, n_steps, bits=None):
    """Plain version of ``srm_cascade_rollout``: ``(*states, reward_sum,
    term_count, rv, rk, rl, rs, integ)``.  The commutation takes cos and
    sin of the state's angle under the speed ODE (SC) and the carried
    rotation at constant speed (CC, TC); the reference advances as in
    ``srm_rollout_random`` (``bits`` replaces its Philox source; the step's
    action words are unused); the integrator starts at zero and persists
    across env resets."""
    c = cc.c
    bits = _bits(c, seed, states, bits)
    st = _random_init(c, bits, states)
    zero = torch.zeros_like(states[0])
    integ, reward, terms = zero.clone(), zero.clone(), zero.clone()
    for t in range(n_steps):
        if c.mech:
            ce, se = torch.cos(st["eps"]), torch.sin(st["eps"])
        else:
            ce, se = st["c"], st["s"]
        integ, action = srm_cascade_law(cc, st, integ, ce, se)
        new, (_a, r, done, _refs) = srm_action_step(c, st, action,
                                                    None if c.mech else (ce, se))
        if not c.all_const:
            _acts, *ref_words = bits.step_words(t)
            reference_step(c.f, c.rows, c.all_const, st, new, ref_words, done > 0.5, t)
        st = new
        reward = reward + r
        terms = terms + done
    return (tuple(st[key] for key in _state_keys(c)) + (reward, terms)
            + tuple(torch.cat(st[key]) for key in ("rv", "rk", "rl", "rs")) + (integ,))


_CONTROL_ARGTYPES = {
    "srm_cascade_rollout": [_P, _P, _P, ctypes.c_uint64, _I, _I, _P, _P, _P],
}


def srm_cascade_rollout(cc: SrmCascadeConsts, seed: int, states, n_steps: int):
    """``(*states, reward_sum, term_count, rv, rk, rl, rs, integ)`` of
    ``n_steps`` closed-loop steps: the plain version for CPU tensors, the
    kernel of ``csrc/fused_srm_cascade.cu`` for CUDA ones."""
    c = cc.c
    device, R = check_planes(c, states)
    if device.type == "cpu":
        return srm_cascade_rollout_plain(cc, seed, tuple(states), n_steps)
    lib = family_library("fused_srm_cascade", "srm_cascade", _CONTROL_ARGTYPES,
                         (len(CONST_NAMES), len(ROW_NAMES), len(FLAG_NAMES),
                          len(CASCADE_CONST_NAMES)))

    def plane(rows=1):
        return torch.empty((rows * R, LANE), dtype=torch.float32, device=device)
    outs = ([plane() for _ in range(c.n_state + 2)] + [plane(c.n_ref) for _ in range(4)]
            + [plane()])
    flags = np.concatenate([c.flags, np.array([cc.task], dtype=np.int32)])
    launch_kernel(lib, "srm_cascade", "srm_cascade_rollout", device, LAUNCHES,
                  c.host.ctypes.data, flags.ctypes.data, cc.host.ctypes.data, seed_u64(seed),
                  R * LANE, int(n_steps), ptr_array(_with_omega(c, states)),
                  ptr_array(_with_omega(c, outs)))
    return tuple(outs)


def make_fused_srm_cascade_rollout(env, ctrl, n_steps, n_envs):
    """Fused closed-loop commutation cascade of an SRM env
    (``make_fused_srm_cascade_rollout``, pallas_srm.py:622): the three
    tasks of ``SRMCommutationController`` (``ctrl``, from
    ``GemController.make(env, env_id)``) on either converter, linear or
    saturating, against the family physics, the env's references, the WSE
    reward, the limit constraint and the in-kernel reset.

    ``rollout(seed, *state0) -> (*states, reward_sum, term_count, rv, rk,
    rl, rs, integ)``; states = (omega?, i_a, i_b, i_c, eps), ``(n_envs //
    128, 128)`` float32 planes, the reference rows ``(n_ref * n_envs //
    128, 128)``.  Build the env with ``ConstReference`` for the
    deterministic closed loop, which follows ``ctrl.control_environment``.
    The device is that of the inputs."""
    if n_envs % LANE:
        raise ValueError(f"n_envs must be a multiple of {LANE}")
    R = n_envs // LANE
    cc = SrmCascadeConsts(env, ctrl)

    def rollout(seed, *state0):
        check_rollout_inputs(R, n_steps, state0)
        return srm_cascade_rollout(cc, seed, state0, n_steps)
    rollout.consts = cc
    return rollout
