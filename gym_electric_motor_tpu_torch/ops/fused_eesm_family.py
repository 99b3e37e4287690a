"""Universal externally excited synchronous (EESM) fused rollouts: the
reducing rollout and the trajectory recorder, each in a random-action and an
action-buffer mode, for the six ``{Finite, Cont} x {CC, TC, SC}`` EESM
catalog ids at their defaults.

Counterpart of ``_eesm_family`` and ``make_fused_eesm_family_rollout`` in
``gym_electric_motor_tpu/ops/pallas_eesm.py`` and of the EESM family's part
of ``make_fused_record_rollout`` in ``ops/pallas_record.py``.  Four kernels
written in CUDA carry the work on the GPU, over the shared step of
``csrc/eesm_step.cuh``:

======================= ================================================
``eesm_rollout_random``  T random-action steps, reduced to the final state,
                         reward sums, termination counts and the final
                         reference rows (``csrc/fused_eesm.cu``; with Wiener
                         references producer warps draw each step's
                         action and reference candidates into a
                         shared-memory ring, ``csrc/eesm_ring.cuh``, and
                         consumer warps run the step)
``eesm_rollout_buffer``  T steps of a given action buffer, deterministic
                         (``csrc/fused_eesm.cu``)
``eesm_record_random``   the random step, every step recorded
                         (``csrc/fused_eesm_record.cu``; with Wiener
                         references producer warps draw and consumer
                         warps step, as in the rollout,
                         ``eesm_record_ring_layout``)
``eesm_record_buffer``   the buffer step, every state recorded
                         (``csrc/fused_eesm_record.cu``)
======================= ================================================

Each kernel has a plain PyTorch version here (``*_plain``) with the same
arithmetic in the same order and the same Philox bits
(``fused_common.SyncBits``, with the third reference row's slots for the
three CC references).  A wrapper runs the plain version only for tensors on
the CPU; for CUDA tensors it launches the kernel (and counts the launch in
``LAUNCHES``) or raises.

Public functions keep the JAX builder's layout: state planes ``(omega,)
i_sd, i_sq, i_e, eps`` (omega only under the polynomial load's dynamic
speed; the angle is a state of the kernels) are ``(n_envs // 128, 128)``
float32, per-step arrays ``(T, n_envs // 128, 128)``, an action buffer
int32 ``(T, 2, n_envs // 128, 128)`` (B6 bits, 4QC action) or float32
``(T, 4, n_envs // 128, 128)`` (three B6 duties, the excitation duty); the
reference rows come out as ``(n_ref * n_envs // 128, 128)``, row 0 first.

The constants follow the JAX kernel's rounding (pallas_eesm.py:375-407):
its Python-float prefixes fold in double and round once, a division of a
plane by a constant is a product with the float32 reciprocal, and under the
speed ODE a product chain of omega with constants folds those constants in
float32 (XLA reassociates constant products), so each reaches the kernels
as one float32 that multiplies omega.

What raises ``NotImplementedError`` (naming the queue item that brings
it): everything ``fused_common.fused_check_system`` and
``fused_constraint_mode`` reject (NoConverter and the AC1, RC and AC3
supplies, the dq control space and the EESM's DqToAbc wrapper, dead time,
interlocking, state noise, other loads), ``randomize=``, other references
than wiener and const on i_sd, i_sq, i_e, the torque or (under a dynamic
load) omega, and other counts of them than the catalog's one (TC, SC) or
three (CC).
"""

from __future__ import annotations

import ctypes
from types import SimpleNamespace

import numpy as np
import torch

from .fused_common import (
    LANE,
    ROW_NAMES,
    TWO_PI,
    SyncBits,
    b6_fractions,
    check_channel_actions,
    check_planes,
    check_rollout_inputs,
    family_library,
    fused_check_system,
    fused_constraint_mode,
    launch_kernel,
    named_ring_layout,
    physics_rows,
    policy_obs_spec,
    poly_load_rhs,
    ptr_array,
    reciprocal_f32,
    ref_rows,
    reference_step,
    rotation_advance,
    seed_u64,
    system_limits,
    uniform_from_bits,
    wiener_init,
    wse_err,
)

_f32 = np.float32

# Order of the float constants, the same as EesmConstIndex in
# csrc/eesm_step.cuh; then ROW_NAMES for each of three reference rows
# (RefRowIndex of csrc/common_step.cuh), and FLAG_NAMES as int32 (EesmFlag).
CONST_NAMES = (
    "u_sup", "half_tau", "tau", "sixth", "two_thirds", "inv_sqrt3", "two_pi", "inv_two_pi", "p",
    "a_sd", "b_sd", "inv_sig", "c_sd", "w_sd", "inv_ld",
    "neg_r_s", "w_sq_d", "w_sq_e", "inv_lq",
    "d_e", "e_e", "f_e", "g_e", "w_e", "inv_le",
    "d_eps", "cos_d", "sin_d", "tq_gain", "lm_ikrs", "ld_minus_lq",
    "load_a", "load_b", "load_c", "omega_lin", "jt_over_td", "inv_jt",
    "inv_i_lim", "inv_ie_lim", "bias", "violation_reward", "ln10", "u_min",
)
FLAG_NAMES = ("qty0", "qty1", "qty2", "all_const", "no_cons", "finite", "mech", "n_ref")
QUANTITIES = ("i_sd", "i_sq", "i_e", "torque", "omega")
N_ROWS = 3  # reference rows the kernels carry constants for

KERNELS = ("eesm_rollout_random", "eesm_rollout_buffer", "eesm_record_random",
           "eesm_record_buffer")
# the library of each kernel (csrc/<name>.cu)
LIBRARY = {"eesm_rollout_random": "fused_eesm", "eesm_rollout_buffer": "fused_eesm",
           "eesm_record_random": "fused_eesm_record", "eesm_record_buffer": "fused_eesm_record"}

# launches of each CUDA kernel since the last reset_launches()
LAUNCHES = dict.fromkeys(KERNELS, 0)

# the random recorder's ring (EesmRecordRing in csrc/fused_eesm_record.cu):
# K steps a slot, producer warps per consumer warp
EESM_RECORD_RING = (8, 2)


def reset_launches():
    for name in KERNELS:
        LAUNCHES[name] = 0


class EesmConsts:
    """The baked constants of one env (``_eesm_family``), as float32:
    ``host`` (floats) and ``flags`` (int32) are the arrays handed to the
    kernels, ``f`` and ``rows`` the same values as Python floats for the
    plain versions.  Raises ``NotImplementedError`` for what the kernels do
    not simulate (see the module docstring).

    ``physics_only=True`` reads the motor, load, converter and supply
    alone, for a specialised builder that checks the system itself and
    bakes its own references, reward and constraint (``fused_eesm.py``): the env's
    reference generator, reward weights and constraints are not read, the
    rows are one zero constant row (``physics_rows``) and the flags the
    defaults."""

    def __init__(self, env, physics_only=False):
        ps = env.physical_system if physics_only else fused_check_system(env.physical_system)
        if ps.motor.kind != "EESM":
            raise NotImplementedError(
                f"the EESM-family kernels need an EESM, got {ps.motor.kind!r}")
        subs = tuple(getattr(ps.converter, "sub_kinds", None) or ())
        if subs not in (("Finite-B6C", "Finite-4QC"), ("Cont-B6C", "Cont-4QC")):
            raise NotImplementedError(
                "the EESM-family kernels need a B6 bridge beside a 4QC (the catalog's multi "
                f"converter), got {ps.converter.kind!r} {subs}")
        if ps.dtype != torch.float32:
            raise NotImplementedError("the fused kernels run in float32")
        self.no_cons = not physics_only and fused_constraint_mode(
            env, (("squared", ("i_sq", "i_sd")), ("limit", ("i_e",)))) == "none"
        self.finite = ps.converter.action_type == "finite"
        self.mech = ps.load.kind == "PolynomialStaticLoad"
        self.rows = physics_rows("torque") if physics_only else ref_rows(env)
        self.n_ref = len(self.rows)
        if self.n_ref not in (1, N_ROWS):
            raise NotImplementedError(
                f"the EESM-family kernels take the catalog's 1 or 3 references, got "
                f"{self.n_ref}; other counts arrive with queue 2, item 8 (_make_wiener's "
                "reference sets)")
        for row in self.rows:
            if row["name"] not in QUANTITIES or (row["name"] == "omega" and not self.mech):
                raise NotImplementedError(
                    f"a reference on {row['name']!r} is not fused for this system; the kernels "
                    "reference i_sd, i_sq, i_e, torque, and omega under a dynamic load")
        names = list(ps.state_names)
        rw = env.reward_function
        scored = {names[i] for i in np.flatnonzero(np.asarray(rw._weights))}
        if not physics_only and not scored <= {row["name"] for row in self.rows}:
            raise NotImplementedError(
                f"the fused kernels score the referenced states only; the reward weighs "
                f"{sorted(scored)}")
        self.all_const = all(row["kind"] == "const" for row in self.rows)
        # recorded action channels, and the Philox words a random step draws
        # for them (finite: one word holds both parts)
        self.n_act = 2 if self.finite else 4
        self.n_words = 1 if self.finite else 4
        self.state_names = (("omega",) if self.mech else ()) + ("i_sd", "i_sq", "i_e", "eps")
        self.n_state = len(self.state_names)
        self.act_names = (("action_b6", "action_e") if self.finite
                          else ("action_a", "action_b", "action_c", "action_e"))

        # the JAX kernel's Python floats (pallas_eesm.py:308-322)
        mp = {key: float(v) for key, v in ps.motor.parameter.items()}
        k_e = mp["k"]
        r_E = k_e**2 * 1.5 * mp["r_e"]
        l_M = k_e * 1.5 * mp["l_m"]
        l_E = k_e**2 * 1.5 * mp["l_e"]
        i_k_rs = 2.0 / 3.0 / k_e
        sig = 1.0 - l_M**2 / (mp["l_d"] * l_E)
        r_s, l_d, l_q, p = mp["r_s"], mp["l_d"], mp["l_q"], mp["p"]
        tau = float(ps.tau)
        lim = np.asarray(ps.limits)
        inv_sig = reciprocal_f32(sig)
        if self.mech:
            # (p omega) times constants: XLA folds the constants in float32
            omega = 0.0
            w_sd = (_f32(p) * _f32(l_q)) * inv_sig
            w_sq_d = _f32(p) * _f32(l_d)
            w_sq_e = (_f32(p) * _f32(l_M)) * _f32(i_k_rs)
            w_e = ((_f32(p) * _f32(l_M)) * _f32(l_q)) * reciprocal_f32(sig * l_d)
        else:
            # constant speed: Python floats, folded in double
            omega = float(ps.load.omega_fixed)
            pw = p * omega
            w_sd, w_sq_d = l_q * pw / sig, l_d * pw
            w_sq_e, w_e = pw * l_M * i_k_rs, pw * l_M * l_q / (sig * l_d)
        values = dict(
            u_sup=float(ps.supply.u_nominal), half_tau=0.5 * tau, tau=tau, sixth=tau / 6.0,
            two_thirds=2.0 / 3.0, inv_sqrt3=1.0 / np.sqrt(3.0), two_pi=TWO_PI,
            inv_two_pi=1.0 / TWO_PI, p=p,
            a_sd=-r_s / sig, b_sd=l_M * r_E / (sig * l_E) * i_k_rs, inv_sig=inv_sig,
            c_sd=l_M * k_e / (sig * l_E), w_sd=w_sd, inv_ld=1.0 / l_d,
            neg_r_s=-r_s, w_sq_d=w_sq_d, w_sq_e=w_sq_e, inv_lq=1.0 / l_q,
            d_e=l_M * r_s / (sig * l_d), e_e=r_E / sig * i_k_rs, f_e=l_M / (sig * l_d),
            g_e=k_e / sig, w_e=w_e, inv_le=1.0 / (l_E * i_k_rs),
            d_eps=p * omega, cos_d=np.cos(tau * p * omega), sin_d=np.sin(tau * p * omega),
            tq_gain=1.5 * p, lm_ikrs=_f32(l_M) * _f32(i_k_rs), ld_minus_lq=l_d - l_q,
            load_a=0.0, load_b=0.0, load_c=0.0, omega_lin=0.0, jt_over_td=0.0, inv_jt=0.0,
            inv_i_lim=1.0 / float(lim[names.index("i_sd")]),
            inv_ie_lim=1.0 / float(lim[names.index("i_e")]),
            bias=rw._bias_value, violation_reward=rw._violation_value,
            ln10=np.log(10.0), u_min=1e-12,
        )
        if self.mech:
            lp = ps.load.parameter
            a, j_total = float(lp["a"]), float(ps.load.j_load) + float(mp["j_rotor"])
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
                     n_ref=self.n_ref)
        self.flags = np.array([flags[n] for n in FLAG_NAMES], dtype=np.int32)


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def eesm_torque(k, i_sd, i_sq, i_e):
    """1.5 p (l_M i_e i_k_rs + (l_d - l_q) i_sd) i_sq (pallas_eesm.py:375-376)."""
    return k["tq_gain"] * (i_e * k["lm_ikrs"] + k["ld_minus_lq"] * i_sd) * i_sq


def eesm_fractions(c: EesmConsts, action):
    """The three phase and the excitation voltage as fractions of the supply
    voltage (``voltage_fracs`` on its no-interlock branch, pallas_eesm.py:
    436-447): the B6 bridge's, and the finite 4QC's ``(a == 1) - (a == 2)``
    or the excitation duty unclipped.  ``action`` is ``(b6 bits, 4QC)``
    (finite) or the four duties."""
    if c.finite:
        b6, a_e = action
        fe = (a_e == 1).to(torch.float32) - (a_e == 2).to(torch.float32)
        return b6_fractions(True, b6) + (fe,)
    return b6_fractions(False, action[:3]) + (action[3],)


def eesm_physics(c: EesmConsts, action, cos, sin, st):
    """B6 + 4QC fractions -> Clarke -> Park at the cycle-start angle (cos,
    sin), the excitation voltage straight through -> RK4 over (omega?, i_sd,
    i_sq, i_e, eps) -> wrap of eps to [0, 2 pi) (``_eesm_family``'s
    ``physics_step`` and ``step``).  ``st`` and the result are dicts of
    planes (``w`` under a dynamic load)."""
    k = c.f
    fa, fb, fc, fe = eesm_fractions(c, action)
    ua, ub, uc = fa * k["u_sup"], fb * k["u_sup"], fc * k["u_sup"]
    u_alpha = k["two_thirds"] * (ua - 0.5 * (ub + uc))
    u_beta = k["inv_sqrt3"] * (ub - uc)
    u_d = cos * u_alpha + sin * u_beta
    u_q = -sin * u_alpha + cos * u_beta
    u_e = fe * k["u_sup"]

    def rhs(w, d, q, e):
        if c.mech:
            w_sd, w_sq_d, w_sq_e, w_e = (w * k[n] for n in ("w_sd", "w_sq_d", "w_sq_e", "w_e"))
            dw = poly_load_rhs(k, w, eesm_torque(k, d, q, e))
        else:
            w_sd, w_sq_d, w_sq_e, w_e = (k[n] for n in ("w_sd", "w_sq_d", "w_sq_e", "w_e"))
            dw = None
        dd = ((((k["a_sd"] * d + k["b_sd"] * e) + u_d * k["inv_sig"]) - k["c_sd"] * u_e)
              + w_sd * q) * k["inv_ld"]
        dq = (((k["neg_r_s"] * q + u_q) - w_sq_d * d) - w_sq_e * e) * k["inv_lq"]
        de = ((((k["d_e"] * d - k["e_e"] * e) - k["f_e"] * u_d) + k["g_e"] * u_e)
              - w_e * q) * k["inv_le"]
        return dw, dd, dq, de

    h, dt, sixth = k["half_tau"], k["tau"], k["sixth"]
    w, d, q, e, eps = st.get("w"), st["i_sd"], st["i_sq"], st["i_e"], st["eps"]

    def stage(kk, step):
        w_s = w + step * kk[0] if c.mech else None
        return w_s, rhs(w_s, d + step * kk[1], q + step * kk[2], e + step * kk[3])

    k1 = rhs(w, d, q, e)
    w2, k2 = stage(k1, h)
    w3, k3 = stage(k2, h)
    w4, k4 = stage(k3, dt)
    out = {}
    if c.mech:
        p = k["p"]
        eps = eps + sixth * (p * w + 2.0 * (p * w2 + p * w3) + p * w4)
        out["w"] = w + sixth * (k1[0] + 2.0 * (k2[0] + k3[0]) + k4[0])
    else:
        de = _f32(k["d_eps"])
        eps = eps + float(_f32(sixth) * (de + _f32(2.0) * (de + de) + de))
    for j, key in enumerate(("i_sd", "i_sq", "i_e"), start=1):
        out[key] = st[key] + sixth * (k1[j] + 2.0 * (k2[j] + k3[j]) + k4[j])
    out["eps"] = eps - k["two_pi"] * torch.floor(eps * k["inv_two_pi"])
    return out


def eesm_quantity(c: EesmConsts, j, st):
    """Row ``j``'s referenced quantity over its limit (``ref_quantity``,
    pallas_eesm.py:585-593)."""
    row = c.rows[j]
    name = row["name"]
    if name == "omega":
        q = st["w"]
    elif name == "torque":
        q = eesm_torque(c.f, st["i_sd"], st["i_sq"], st["i_e"])
    else:
        q = st[name]
    return q * row["inv_lim"]


def _state_keys(c):
    return (("w",) if c.mech else ()) + ("i_sd", "i_sq", "i_e", "eps")


def eesm_action_step(c: EesmConsts, st, action, cos, sin):
    """One step under ``action``: physics, the squared stator-current and
    the excitation-current constraints (pallas_eesm.py:668-675), the WSE
    reward against the pre-advance references, reset of a violating env
    and, at constant speed, the incremental Park rotation.  Returns the new
    state dict (the reference rows carried over) and ``(action, reward,
    done, refs)``."""
    k = c.f
    y = eesm_physics(c, action, cos, sin, st)
    if c.no_cons:
        violated = torch.zeros_like(y["i_sd"], dtype=torch.bool)
    else:
        i_sd_n = y["i_sd"] * k["inv_i_lim"]
        i_sq_n = y["i_sq"] * k["inv_i_lim"]
        violated = ((i_sd_n * i_sd_n + i_sq_n * i_sq_n) > 1.0) \
            | (torch.abs(y["i_e"] * k["inv_ie_lim"]) > 1.0)
    wse = k["bias"] - wse_err(c.rows[0], eesm_quantity(c, 0, y), st["rv"][0])
    for j in range(1, c.n_ref):
        wse = wse - wse_err(c.rows[j], eesm_quantity(c, j, y), st["rv"][j])
    reward = torch.where(violated, torch.full_like(wse, k["violation_reward"]), wse)
    out = (action, reward, violated.to(torch.float32), list(st["rv"]))
    new = dict(st, rv=list(st["rv"]), rk=list(st["rk"]), rl=list(st["rl"]), rs=list(st["rs"]))
    zero = torch.zeros_like(y["i_sd"])
    for key in _state_keys(c):
        new[key] = torch.where(violated, zero, y[key])
    if not c.mech:
        new["c"], new["s"] = rotation_advance(k, cos, sin, violated)
    return new, out


def _random_init(c: EesmConsts, bits, states):
    shape, device = states[0].shape, states[0].device
    st = {key: x.clone() for key, x in zip(_state_keys(c), states)}
    if not c.mech:
        st["c"], st["s"] = torch.cos(st["eps"]), torch.sin(st["eps"])
    words = None if c.all_const else bits.init_words()
    st["rv"], st["rk"], st["rl"], st["rs"] = wiener_init(c.f, c.rows, c.all_const, words, shape,
                                                         device)
    st["zb"] = torch.zeros(shape, dtype=torch.float32, device=device)
    return st


def _random_action(c: EesmConsts, acts):
    """The action of a step's words (``_sample_actions``, pallas_eesm.py:
    595-601): finite, ``(b & 7, (b >> 3) & 3)`` of one word; continuous,
    four duties ``2 u - 1``."""
    if c.finite:
        b = acts[0]
        return (b & 7).to(torch.int32), ((b >> 3) & 3).to(torch.int32)
    return tuple(2.0 * uniform_from_bits(w) - 1.0 for w in acts)


def _random_step(c: EesmConsts, st, words, t):
    """One random-mode step (``make_fused_eesm_family_rollout``'s ``body``,
    pallas_eesm.py:781-824): returns the new state dict and ``(action,
    reward, done, refs)``.  ``words`` = ``(actions, u1, u2, lengths,
    sigmas, resets)`` of the bit source."""
    shape = st["i_sd"].shape
    acts, *ref_words = words
    action = _random_action(c, [w.reshape(shape) for w in acts])
    cos, sin = ((torch.cos(st["eps"]), torch.sin(st["eps"])) if c.mech else (st["c"], st["s"]))
    new, out = eesm_action_step(c, st, action, cos, sin)
    reference_step(c.f, c.rows, c.all_const, st, new, ref_words, out[2] > 0.5, t)
    return new, out


def _bits(c, seed, states, bits):
    return bits or SyncBits(seed, states[0].numel(), states[0].device, c.n_ref, c.n_words)


def eesm_rollout_random_plain(c: EesmConsts, seed, states, n_steps, bits=None):
    """Plain version of ``eesm_rollout_random``: ``(*states, reward_sum,
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


def record_dtypes(c: EesmConsts):
    """The dtypes of the random recorder's signals, in order."""
    act = torch.int32 if c.finite else torch.float32
    return ((torch.float32,) * (c.n_state + c.n_ref) + (act,) * c.n_act
            + (torch.float32, torch.float32))


def eesm_record_random_plain(c: EesmConsts, seed, states, n_steps, bits=None):
    """Plain version of ``eesm_record_random``: per step the post-reset
    states, the references the reward was taken against, the actions (two
    int32, or four float32 duty commands), the reward and the done flag,
    each ``(T, R, 128)``."""
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


def _buffer_action(c, actions, t):
    return tuple(actions[t, j] for j in range(c.n_act))


def _buffer_step(c, st, action):
    return eesm_physics(c, action, torch.cos(st["eps"]), torch.sin(st["eps"]), st)


def eesm_rollout_buffer_plain(c: EesmConsts, states, actions):
    """Plain version of ``eesm_rollout_buffer``: the final states (exact
    sin/cos of the angle every step, no references, no reset)."""
    st = dict(zip(_state_keys(c), states))
    for t in range(actions.shape[0]):
        st = _buffer_step(c, st, _buffer_action(c, actions, t))
    return tuple(st[key].clone() for key in _state_keys(c))


def eesm_record_buffer_plain(c: EesmConsts, states, actions):
    """Plain version of ``eesm_record_buffer``: every step's states, each
    ``(T, R, 128)``."""
    st = dict(zip(_state_keys(c), states))
    T = actions.shape[0]
    out = torch.empty((c.n_state, T) + tuple(states[0].shape), dtype=torch.float32,
                      device=states[0].device)
    for t in range(T):
        st = _buffer_step(c, st, _buffer_action(c, actions, t))
        for j, key in enumerate(_state_keys(c)):
            out[j, t] = st[key]
    return tuple(out[j] for j in range(c.n_state))


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    "eesm_rollout_random": [_P, _P, ctypes.c_uint64, _I, _I, _P, _P, _P],
    "eesm_rollout_buffer": [_P, _P, _I, _I, _P, _P, _P, _P, _P],
    "eesm_record_random": [_P, _P, ctypes.c_uint64, _I, _I, _P, _P, _P],
    "eesm_record_buffer": [_P, _P, _I, _I, _P, _P, _P, _P, _P],
}


def _launch(name, device, *args, launches=LAUNCHES):
    lib = family_library(LIBRARY[name], "eesm", _ARGTYPES,
                         (len(CONST_NAMES), len(ROW_NAMES), len(FLAG_NAMES)))
    launch_kernel(lib, "eesm", name, device, launches, *args)


def _with_omega(c, planes):
    """(omega or NULL, the four other planes)."""
    return ([] if c.mech else [None]) + list(planes)


def _buffer_args(c, actions):
    return (actions.data_ptr(), None) if c.finite else (None, actions.data_ptr())


def eesm_rollout_random(c: EesmConsts, seed: int, states, n_steps: int):
    """``(*states, reward_sum, term_count, rv, rk, rl, rs)``."""
    device, R = check_planes(c, states)
    if device.type == "cpu":
        return eesm_rollout_random_plain(c, seed, tuple(states), n_steps)

    def plane(rows=1):
        return torch.empty((rows * R, LANE), dtype=torch.float32, device=device)
    outs = [plane() for _ in range(c.n_state + 2)] + [plane(c.n_ref) for _ in range(4)]
    _launch("eesm_rollout_random", device, c.host.ctypes.data, c.flags.ctypes.data,
            seed_u64(seed), R * LANE, int(n_steps), ptr_array(_with_omega(c, states)),
            ptr_array(_with_omega(c, outs)))
    return tuple(outs)


def eesm_rollout_buffer(c: EesmConsts, states, actions):
    """The final states after the action buffer."""
    device, R = check_planes(c, states)
    T = check_channel_actions(c, actions, R, device)
    if device.type == "cpu":
        return eesm_rollout_buffer_plain(c, tuple(states), actions)
    outs = [torch.empty((R, LANE), dtype=torch.float32, device=device) for _ in range(c.n_state)]
    _launch("eesm_rollout_buffer", device, c.host.ctypes.data, c.flags.ctypes.data, R * LANE, T,
            ptr_array(_with_omega(c, states)), *_buffer_args(c, actions),
            ptr_array(_with_omega(c, outs)))
    return tuple(outs)


def eesm_record_random(c: EesmConsts, seed: int, states, n_steps: int):
    """``(*states, *refs, *actions, reward, done)``, each ``(T, R, 128)``."""
    device, R = check_planes(c, states)
    if device.type == "cpu":
        return eesm_record_random_plain(c, seed, tuple(states), n_steps)
    outs = _record_random_launch(c, seed, states, n_steps, R * LANE, LAUNCHES)
    return tuple(x.view(int(n_steps), R, LANE) for x in outs)


def _record_random_launch(c: EesmConsts, seed: int, states, n_steps: int, n_envs: int,
                          launches=None):
    """eesm_record_random's kernel on the first ``n_envs`` envs of the
    planes: the recorded signals, each ``(T, n_envs)``; the launch counted
    in ``launches`` (none: not counted)."""
    outs, args = _record_random_args(c, seed, states, n_steps, n_envs)
    _launch("eesm_record_random", states[0].device, *args,
            launches={"eesm_record_random": 0} if launches is None else launches)
    return outs


def _record_random_args(c: EesmConsts, seed: int, states, n_steps: int, n_envs: int):
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
                + (acts + [None] * 4 if c.finite else [None] * 2 + acts) + [reward, done])
    return outs, (c.host.ctypes.data, c.flags.ctypes.data, seed_u64(seed), n_envs,
                  int(n_steps), ptr_array(_with_omega(c, states)), ptr_array(ptr_list))


def eesm_record_ring_layout(c: EesmConsts):
    """The random recorder's ring for ``c``'s instance (csrc/fused_eesm_record.cu's
    EesmRecordRing, in csrc/ring_pipe.cuh's RingLayout): consumer and
    producer warps, K steps a slot, slots, words a step (finite: the B6 bits
    and the 4QC action; continuous: the four duties; then four per
    reference row), shared-memory bytes; one thread per env with constant
    references.  Computed here, without the library."""
    if c.all_const:
        return named_ring_layout((0,) * 6 + (1,))
    K, P = EESM_RECORD_RING
    words = c.n_act + 4 * c.n_ref
    return named_ring_layout((4, 4 * P, K, 2, words, 2 * K * words * LANE * 4, 0))


def eesm_record_buffer(c: EesmConsts, states, actions):
    """Every step's states, each ``(T, R, 128)``."""
    device, R = check_planes(c, states)
    T = check_channel_actions(c, actions, R, device)
    if device.type == "cpu":
        return eesm_record_buffer_plain(c, tuple(states), actions)
    outs = [torch.empty((T, R, LANE), dtype=torch.float32, device=device)
            for _ in range(c.n_state)]
    _launch("eesm_record_buffer", device, c.host.ctypes.data, c.flags.ctypes.data, R * LANE, T,
            ptr_array(_with_omega(c, states)), *_buffer_args(c, actions),
            ptr_array(_with_omega(c, outs)))
    return tuple(outs)


# ---------------------------------------------------------------------------
# builder (the JAX package's entry point)
# ---------------------------------------------------------------------------


def make_fused_eesm_family_rollout(env, n_steps, n_envs, action_mode="random", randomize=None):
    """Universal fused rollout for the externally excited synchronous
    family: the six ``{Finite, Cont} x {CC, TC, SC}`` EESM catalog ids.

    * random mode: ``rollout(seed, *state0) -> (*states, reward_sum,
      term_count, rv, rk, rl, rs)``; states = (omega?, i_sd, i_sq, i_e,
      eps), ``(n_envs // 128, 128)`` float32 planes, the reference rows
      ``(n_ref * n_envs // 128, 128)``.
    * buffer mode: ``rollout(*state0, actions) -> states`` with an int32
      ``(n_steps, 2, n_envs // 128, 128)`` (finite: B6, 4QC) or float32
      ``(n_steps, 4, n_envs // 128, 128)`` (cont duties) action buffer;
      deterministic physics only.

    The device is that of the inputs."""
    if randomize:
        raise NotImplementedError(
            "domain randomization (randomize=) is not fused yet; it arrives with queue 2, "
            "item 7 of the port (r_s, r_e, j_rotor and u_sup as per-env planes)")
    if n_envs % LANE:
        raise ValueError(f"n_envs must be a multiple of {LANE}")
    R = n_envs // LANE
    c = EesmConsts(env)
    if action_mode == "random":
        def rollout(seed, *state0):
            check_rollout_inputs(R, n_steps, state0)
            return eesm_rollout_random(c, seed, state0, n_steps)
        rollout.consts = c
        return rollout
    if action_mode != "buffer":
        raise ValueError(f"action_mode must be 'random' or 'buffer', got {action_mode!r}")

    def rollout(*args):
        *state0, actions = args
        check_rollout_inputs(R, n_steps, state0, actions)
        return eesm_rollout_buffer(c, state0, actions)
    rollout.consts = c
    return rollout


# ---------------------------------------------------------------------------
# the universal policy recorder's view of the family
# ---------------------------------------------------------------------------


def policy_surface(c: EesmConsts, env):
    """What ``ops.fused_policy.make_fused_policy_record_universal`` needs of
    the family (the policy-adapter surface of ``_eesm_family``,
    pallas_eesm.py:680-691): the observation spec (omega, i_sd, i_sq and
    i_e over their limits, the angle as cos/sin), the heads (8, 4) of the B6
    bits and the excitation 4QC or four duties in [-1, 1], and the plain
    step.  ``aux`` gives the step's (cos, sin), as the sync family's."""
    ps, names, lim = system_limits(env)
    i_lim, ie_lim = float(lim[names.index("i_sd")]), float(lim[names.index("i_e")])
    w_lim = float(lim[names.index("omega")])
    off, i_eps = int(c.mech), c.n_state - 1
    obs_spec = policy_obs_spec(c.mech, w_lim, ps.load.omega_fixed, [
        ("state", off, 1.0 / i_lim), ("state", off + 1, 1.0 / i_lim),
        ("state", off + 2, 1.0 / ie_lim), ("cos", i_eps), ("sin", i_eps)])

    def aux(st, afresh=False):
        if c.mech or afresh:
            return torch.cos(st["eps"]), torch.sin(st["eps"])
        return st["c"], st["s"]

    return SimpleNamespace(
        family="eesm", consts=c, obs_spec=obs_spec, act_ns=(8, 4) if c.finite else None,
        act_range=None if c.finite else (np.full(4, -1.0, _f32), np.ones(4, _f32)),
        state_keys=_state_keys(c), init=lambda bits, states: _random_init(c, bits, states),
        aux=aux, aux_cs=lambda a: a,
        quantities=lambda st, a: [eesm_quantity(c, j, st) for j in range(c.n_ref)],
        action=tuple, step=lambda st, action, a: eesm_action_step(c, st, action, *a),
        planes=lambda planes: _with_omega(c, planes))
