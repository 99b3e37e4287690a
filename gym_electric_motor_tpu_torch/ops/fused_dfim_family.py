"""Universal doubly fed induction (DFIM) fused rollouts: the reducing rollout
and the trajectory recorder, each in a random-action and an action-buffer
mode, for the six ``{Finite, Cont} x {CC, TC, SC}`` DFIM catalog ids at
their defaults.

Counterpart of ``_dfim_family`` and ``make_fused_dfim_family_rollout`` in
``gym_electric_motor_tpu/ops/pallas_dfim.py`` and of the DFIM family's part
of ``make_fused_record_rollout`` in ``ops/pallas_record.py``.  Four kernels
written in CUDA carry the work on the GPU, over the shared step of
``csrc/dfim_step.cuh``:

======================= ================================================
``dfim_rollout_random``  T random-action steps, reduced to the final state,
                         reward sums, termination counts and the final
                         reference rows (``csrc/fused_dfim.cu``)
``dfim_rollout_buffer``  T steps of a given action buffer, deterministic
                         (``csrc/fused_dfim.cu``)
``dfim_record_random``   the random step, every step recorded
                         (``csrc/fused_dfim_record.cu``; warp-specialised
                         with Wiener references,
                         ``dfim_record_ring_layout``)
``dfim_record_buffer``   the buffer step, every state recorded
                         (``csrc/fused_dfim_record.cu``)
======================= ================================================

Each kernel has a plain PyTorch version here (``*_plain``) with the same
arithmetic in the same order and the same Philox bits
(``fused_common.SyncBits`` with six action words for the six duties).  A
wrapper runs the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel (and counts the launch in ``LAUNCHES``) or
raises.

Public functions keep the JAX builder's layout: state planes ``(omega,)
i_salpha, i_sbeta, psi_ralpha, psi_rbeta, eps`` (omega only under the
polynomial load's dynamic speed; unlike the SCIM's, the rotor angle is a
state of the kernels, since it turns the rotor voltages into the stator
frame) are ``(n_envs // 128, 128)`` float32, per-step arrays ``(T, n_envs
// 128, 128)``, an action buffer int32 ``(T, 2, n_envs // 128, 128)``
(stator bits, rotor bits) or float32 ``(T, 6, n_envs // 128, 128)``
(stator duties a, b, c, rotor duties a, b, c); the reference rows come out
as ``(n_ref * n_envs // 128, 128)``, row 0 first.

The rotor voltages are Clarke'd and turned into the stator frame by one
rotation by the electrical angle, where the env takes two (def -> dq at the
field angle less the electrical angle, dq -> alpha/beta at the field
angle), as the JAX kernel collapses them (pallas_dfim.py:480-494); the env
and the kernels therefore agree to float32 rounding.  At constant speed the
rotation's (cos, sin) ride an incremental rotation, under the speed ODE (and
always in buffer mode) they are cos and sin of the angle.  The dq
quantities of the CC reward rotate the post-step stator current by the
rotor-flux direction from before the step, as for the SCIM.

What raises ``NotImplementedError`` (naming the queue item that brings
it): everything ``fused_common.fused_check_system`` and
``fused_constraint_mode`` reject (NoConverter and the AC1, RC and AC3
supplies, the dq control space, the DFIM's DqToAbc wrapper with its flux
observer, dead time, interlocking, state noise, the OU and external-speed
loads), ``randomize=``, other references than wiener and const on i_sd,
i_sq, the torque or (under a dynamic load) omega.
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
# the torque and the flux direction are the SCIM's expressions
# (pallas_dfim.py:391-392, :620-626)
from .fused_induction_family import flux_dir, induction_torque

_f32 = np.float32

# Order of the float constants, the same as DfimConstIndex in
# csrc/dfim_step.cuh; then ROW_NAMES for each of two reference rows
# (RefRowIndex of csrc/common_step.cuh), and FLAG_NAMES as int32 (DfimFlag).
CONST_NAMES = (
    "u_sup", "half_tau", "tau", "sixth", "two_thirds", "inv_sqrt3", "two_pi", "inv_two_pi",
    "inv_tau_sig", "c_psi", "c_w", "cw_w", "c_u", "c_ur", "l_m", "inv_tau_r", "p", "pw",
    "cos_d", "sin_d", "k_t",
    "load_a", "load_b", "load_c", "omega_lin", "jt_over_td", "inv_jt",
    "inv_ilim2", "tiny", "bias", "violation_reward", "ln10", "u_min",
)
FLAG_NAMES = ("qty0", "qty1", "all_const", "no_cons", "finite", "mech", "n_ref", "needs_dq")
QUANTITIES = ("i_sd", "i_sq", "torque", "omega")

KERNELS = ("dfim_rollout_random", "dfim_rollout_buffer", "dfim_record_random",
           "dfim_record_buffer")
# the library of each kernel (csrc/<name>.cu)
LIBRARY = {"dfim_rollout_random": "fused_dfim", "dfim_rollout_buffer": "fused_dfim",
           "dfim_record_random": "fused_dfim_record", "dfim_record_buffer": "fused_dfim_record"}

# launches of each CUDA kernel since the last reset_launches()
LAUNCHES = dict.fromkeys(KERNELS, 0)

# the random recorder's ring (DfimRecordRing in csrc/fused_dfim_record.cu):
# K steps a slot, producer warps per consumer warp
DFIM_RECORD_RING = (8, 2)


def reset_launches():
    for name in KERNELS:
        LAUNCHES[name] = 0


class DfimConsts:
    """The baked constants of one env (``_dfim_family``), as float32:
    ``host`` (floats) and ``flags`` (int32) are the arrays handed to the
    kernels, ``f`` and ``rows`` the same values as Python floats for the
    plain versions.  Raises ``NotImplementedError`` for what the kernels do
    not simulate (see the module docstring).

    The motor constants are formed in double precision in the JAX family's
    expression order (pallas_dfim.py:323-331, :356-368): sigma, c_w, c_u,
    c_ur, k_t, then tau_r, tau_sig = sigma l_s / (r_s + r_r l_m^2 / l_r^2)
    and c_psi = l_m r_r / (sigma l_s l_r^2); at constant speed ``c_w w`` and
    ``p w`` too, as the JAX kernel forms them from Python floats.

    ``physics_only=True`` reads the motor, load, converter and supply
    alone, for a specialised builder that checks the system itself and
    bakes its own references, reward and constraint (``fused_dfim.py``): the env's
    reference generator, reward weights and constraints are not read, the
    rows are one zero constant row (``physics_rows``) and the flags the
    defaults."""

    def __init__(self, env, physics_only=False):
        ps = env.physical_system if physics_only else fused_check_system(env.physical_system)
        if ps.motor.kind != "DFIM":
            raise NotImplementedError(
                f"the DFIM-family kernels need a DFIM, got {ps.motor.kind!r}")
        subs = tuple(getattr(ps.converter, "sub_kinds", None) or ())
        if subs not in (("Finite-B6C",) * 2, ("Cont-B6C",) * 2):
            raise NotImplementedError(
                "the DFIM-family kernels need a stator and a rotor B6 bridge (the catalog's "
                f"multi converter), got {ps.converter.kind!r} {subs}")
        if ps.dtype != torch.float32:
            raise NotImplementedError("the fused kernels run in float32")
        self.no_cons = not physics_only and fused_constraint_mode(
            env, (("squared", ("i_sq", "i_sd")),)) == "none"
        self.finite = ps.converter.action_type == "finite"
        self.mech = ps.load.kind == "PolynomialStaticLoad"
        self.rows = physics_rows("torque") if physics_only else ref_rows(env)
        self.n_ref = len(self.rows)
        if self.n_ref not in (1, 2):
            raise NotImplementedError(
                f"the DFIM-family kernels take 1 or 2 references, got {self.n_ref}")
        for row in self.rows:
            if row["name"] not in QUANTITIES or (row["name"] == "omega" and not self.mech):
                raise NotImplementedError(
                    f"a reference on {row['name']!r} is not fused for this system; the kernels "
                    "reference i_sd, i_sq, torque, and omega under a dynamic load")
        names = list(ps.state_names)
        rw = env.reward_function
        scored = {names[i] for i in np.flatnonzero(np.asarray(rw._weights))}
        if not physics_only and not scored <= {row["name"] for row in self.rows}:
            raise NotImplementedError(
                f"the fused kernels score the referenced states only; the reward weighs "
                f"{sorted(scored)}")
        self.all_const = all(row["kind"] == "const" for row in self.rows)
        self.needs_dq = any(row["name"] in ("i_sd", "i_sq") for row in self.rows)
        # recorded action channels, and the Philox words a random step draws
        # for them (finite: one word holds both bridges)
        self.n_act = 2 if self.finite else 6
        self.n_words = 1 if self.finite else 6
        self.state_names = (("omega",) if self.mech else ()) + (
            "i_salpha", "i_sbeta", "psi_ralpha", "psi_rbeta", "eps")
        self.n_state = len(self.state_names)
        self.act_names = (("action_stator", "action_rotor") if self.finite
                          else ("action_sa", "action_sb", "action_sc", "action_ra", "action_rb",
                                "action_rc"))

        # the JAX family's Python floats (pallas_dfim.py:323-331, :356-368)
        mp = {key: float(v) for key, v in ps.motor.parameter.items()}
        l_m = mp["l_m"]
        l_s = l_m + mp["l_sigs"]
        l_r = l_m + mp["l_sigr"]
        r_s, r_r, p = mp["r_s"], mp["r_r"], mp["p"]
        sg = (l_s * l_r - l_m**2) / (l_s * l_r)
        c_w = l_m * p / (sg * l_r * l_s)
        c_u = 1.0 / (sg * l_s)
        c_ur = l_m / (sg * l_r * l_s)
        k_t = 1.5 * p * l_m / l_r
        sg_ls, lm2_lr2, c_psi_den = sg * l_s, l_m**2 / l_r**2, sg * l_s * l_r**2
        tau_r = l_r / r_r
        tau_sig = sg_ls / (r_s + r_r * lm2_lr2)
        c_psi = l_m * r_r / c_psi_den
        lim = np.asarray(ps.limits)
        i_lim = float(lim[names.index("i_sd")])
        omega = 0.0 if self.mech else float(ps.load.omega_fixed)
        tau = float(ps.tau)
        values = dict(
            u_sup=float(ps.supply.u_nominal), half_tau=0.5 * tau, tau=tau, sixth=tau / 6.0,
            two_thirds=2.0 / 3.0, inv_sqrt3=1.0 / np.sqrt(3.0), two_pi=TWO_PI,
            inv_two_pi=1.0 / TWO_PI, inv_tau_sig=reciprocal_f32(tau_sig), c_psi=c_psi, c_w=c_w,
            cw_w=c_w * omega, c_u=c_u, c_ur=c_ur, l_m=l_m, inv_tau_r=reciprocal_f32(tau_r), p=p,
            pw=p * omega, cos_d=np.cos(tau * p * omega), sin_d=np.sin(tau * p * omega), k_t=k_t,
            load_a=0.0, load_b=0.0, load_c=0.0, omega_lin=0.0, jt_over_td=0.0, inv_jt=0.0,
            inv_ilim2=1.0 / (i_lim * i_lim), tiny=1e-24,
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
        for j in (0, self.n_ref - 1):
            floats += [_f32(self.rows[j][n]) for n in ROW_NAMES]
        self.host = np.array(floats, dtype=np.float32)
        self.f = {n: float(v) for n, v in zip(CONST_NAMES, self.host)}
        codes = [QUANTITIES.index(row["name"]) for row in self.rows]
        flags = dict(qty0=codes[0], qty1=codes[-1], all_const=int(self.all_const),
                     no_cons=int(self.no_cons), finite=int(self.finite), mech=int(self.mech),
                     n_ref=self.n_ref, needs_dq=int(self.needs_dq))
        self.flags = np.array([flags[n] for n in FLAG_NAMES], dtype=np.int32)


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def dfim_voltages(c: DfimConsts, action, cos, sin):
    """The stator voltage and the rotor voltage in the stator frame
    (``voltage_fracs`` and ``_us_of`` on the no-interlock branch,
    pallas_dfim.py:442-451, :480-493): both bridges' fractions times the supply
    voltage, Clarke'd, the rotor pair turned by the electrical angle (cos,
    sin).  ``action`` is ``(stator bits, rotor bits)`` (finite) or the six
    duties."""
    k = c.f
    if c.finite:
        f_s, f_r = b6_fractions(True, action[0]), b6_fractions(True, action[1])
    else:
        f_s, f_r = b6_fractions(False, action[:3]), b6_fractions(False, action[3:])
    ua, ub, uc = (f * k["u_sup"] for f in f_s)
    ra, rb, rc = (f * k["u_sup"] for f in f_r)
    u_sal = k["two_thirds"] * (ua - 0.5 * (ub + uc))
    u_sbe = k["inv_sqrt3"] * (ub - uc)
    u_ral0 = k["two_thirds"] * (ra - 0.5 * (rb + rc))
    u_rbe0 = k["inv_sqrt3"] * (rb - rc)
    return u_sal, u_sbe, cos * u_ral0 - sin * u_rbe0, sin * u_ral0 + cos * u_rbe0


def dfim_physics(c: DfimConsts, action, cos, sin, st):
    """Dual B6 -> Clarke, the rotor pair turned into the stator frame -> RK4
    over (omega?, i_salpha, i_sbeta, psi_ralpha, psi_rbeta, eps) -> wrap of
    eps to [0, 2 pi) (``el_rhs``, ``rhs``, ``rk4`` and ``physics_step`` on
    the no-interlock branch, then ``step``, pallas_dfim.py:394-420,
    :495-509, :597-601, :729-735).  ``st`` and the result are dicts of planes ``w``
    (dynamic speed), ``isa``, ``isb``, ``psa``, ``psb``, ``eps``; the
    divisions by tau_sig and tau_r are products with their float32
    reciprocals, as XLA compiles them."""
    k = c.f
    u_sal, u_sbe, u_ral, u_rbe = dfim_voltages(c, action, cos, sin)

    def rhs(w, isa, isb, psa, psb):
        cww, pw = (k["c_w"] * w, k["p"] * w) if c.mech else (k["cw_w"], k["pw"])
        d_isa = (-isa * k["inv_tau_sig"] + k["c_psi"] * psa + cww * psb + k["c_u"] * u_sal
                 - k["c_ur"] * u_ral)
        d_isb = (-isb * k["inv_tau_sig"] + k["c_psi"] * psb - cww * psa + k["c_u"] * u_sbe
                 - k["c_ur"] * u_rbe)
        d_psa = (k["l_m"] * isa - psa) * k["inv_tau_r"] - pw * psb + u_ral
        d_psb = (k["l_m"] * isb - psb) * k["inv_tau_r"] + pw * psa + u_rbe
        dw = poly_load_rhs(k, w, induction_torque(k, isa, isb, psa, psb)) if c.mech else None
        return dw, d_isa, d_isb, d_psa, d_psb

    def axpy(x, d, h):
        return None if x is None else x + h * d

    h, dt, sixth = k["half_tau"], k["tau"], k["sixth"]
    keys = ("w", "isa", "isb", "psa", "psb")
    x = tuple(st.get(key) for key in keys)
    k1 = rhs(*x)
    x2 = tuple(axpy(s, d, h) for s, d in zip(x, k1))
    k2 = rhs(*x2)
    x3 = tuple(axpy(s, d, h) for s, d in zip(x, k2))
    k3 = rhs(*x3)
    x4 = tuple(axpy(s, d, dt) for s, d in zip(x, k3))
    k4 = rhs(*x4)
    out = {key: s + sixth * (a1 + 2.0 * (a2 + a3) + a4)
           for key, s, a1, a2, a3, a4 in zip(keys, x, k1, k2, k3, k4) if s is not None}
    eps = st["eps"]
    if c.mech:
        p = k["p"]
        eps = eps + sixth * (p * x[0] + 2.0 * (p * x2[0] + p * x3[0]) + p * x4[0])
    else:
        de = _f32(k["pw"])
        eps = eps + float(_f32(sixth) * (de + _f32(2.0) * (de + de) + de))
    out["eps"] = eps - k["two_pi"] * torch.floor(eps * k["inv_two_pi"])
    return out


def dfim_quantity(c: DfimConsts, j, st, cs):
    """Row ``j``'s referenced quantity over its limit (``ref_quantities``,
    pallas_dfim.py:628-647): the dq currents rotate the post-step current by
    the pre-step flux direction ``cs``."""
    k = c.f
    name = c.rows[j]["name"]
    if name == "omega":
        q = st["w"]
    elif name == "torque":
        q = induction_torque(k, st["isa"], st["isb"], st["psa"], st["psb"])
    elif name == "i_sd":
        q = cs[0] * st["isa"] + cs[1] * st["isb"]
    else:
        q = cs[0] * st["isb"] - cs[1] * st["isa"]
    return q * c.rows[j]["inv_lim"]


def _state_keys(c):
    return (("w",) if c.mech else ()) + ("isa", "isb", "psa", "psb", "eps")


def dfim_action_step(c: DfimConsts, st, action, cos, sin, cs):
    """One step under ``action``: physics at the electrical angle (cos,
    sin), the squared-current constraint on |i_alphabeta|^2
    (rotation-invariant, pallas_dfim.py:740-745), the WSE reward against the
    pre-advance references with the flux direction ``cs``, the reset of a
    violating env to zeros (the angle too) and, at constant speed, the
    incremental rotation.  Returns the new state dict (the reference rows
    carried over) and ``(action, reward, done, refs)``."""
    k = c.f
    y = dfim_physics(c, action, cos, sin, st)
    if c.no_cons:
        violated = torch.zeros_like(y["isa"], dtype=torch.bool)
    else:
        violated = (y["isa"] * y["isa"] + y["isb"] * y["isb"]) * k["inv_ilim2"] > 1.0
    wse = k["bias"] - wse_err(c.rows[0], dfim_quantity(c, 0, y, cs), st["rv"][0])
    if c.n_ref == 2:
        wse = wse - wse_err(c.rows[1], dfim_quantity(c, 1, y, cs), st["rv"][1])
    reward = torch.where(violated, torch.full_like(wse, k["violation_reward"]), wse)
    out = (action, reward, violated.to(torch.float32), list(st["rv"]))
    new = dict(st, rv=list(st["rv"]), rk=list(st["rk"]), rl=list(st["rl"]), rs=list(st["rs"]))
    zero = torch.zeros_like(y["isa"])
    for key in _state_keys(c):
        new[key] = torch.where(violated, zero, y[key])
    if not c.mech:
        new["c"], new["s"] = rotation_advance(k, cos, sin, violated)
    return new, out


def _random_init(c: DfimConsts, bits, states):
    shape, device = states[0].shape, states[0].device
    st = {key: x.clone() for key, x in zip(_state_keys(c), states)}
    if not c.mech:
        st["c"], st["s"] = torch.cos(st["eps"]), torch.sin(st["eps"])
    words = None if c.all_const else bits.init_words()
    st["rv"], st["rk"], st["rl"], st["rs"] = wiener_init(c.f, c.rows, c.all_const, words, shape,
                                                         device)
    st["zb"] = torch.zeros(shape, dtype=torch.float32, device=device)
    return st


def _random_action(c: DfimConsts, acts):
    """The action of a step's words (``_sample_actions``, pallas_dfim.py:
    649-655): finite, ``(b & 7, (b >> 3) & 7)`` of one word; continuous, six
    duties ``2 u - 1``."""
    if c.finite:
        b = acts[0]
        return (b & 7).to(torch.int32), ((b >> 3) & 7).to(torch.int32)
    return tuple(2.0 * uniform_from_bits(w) - 1.0 for w in acts)


def _random_step(c: DfimConsts, st, words, t):
    """One random-mode step (``make_fused_dfim_family_rollout``'s ``body``,
    pallas_dfim.py:853-896): the action, the pre-step flux direction (CC
    only), the angle's (cos, sin), the action step, then the reference
    advance.  ``words`` = ``(actions, u1, u2, lengths, sigmas, resets)`` of
    the bit source."""
    shape = st["isa"].shape
    acts, *ref_words = words
    action = _random_action(c, [w.reshape(shape) for w in acts])
    cs = flux_dir(c, st) if c.needs_dq else None
    cos, sin = ((torch.cos(st["eps"]), torch.sin(st["eps"])) if c.mech else (st["c"], st["s"]))
    new, out = dfim_action_step(c, st, action, cos, sin, cs)
    reference_step(c.f, c.rows, c.all_const, st, new, ref_words, out[2] > 0.5, t)
    return new, out


def _bits(c, seed, states, bits):
    return bits or SyncBits(seed, states[0].numel(), states[0].device, c.n_ref, c.n_words)


def dfim_rollout_random_plain(c: DfimConsts, seed, states, n_steps, bits=None):
    """Plain version of ``dfim_rollout_random``: ``(*states, reward_sum,
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


def record_dtypes(c: DfimConsts):
    """The dtypes of the random recorder's signals, in order."""
    act = torch.int32 if c.finite else torch.float32
    return ((torch.float32,) * (c.n_state + c.n_ref) + (act,) * c.n_act
            + (torch.float32, torch.float32))


def dfim_record_random_plain(c: DfimConsts, seed, states, n_steps, bits=None):
    """Plain version of ``dfim_record_random``: per step the post-reset
    states, the references the reward was taken against, the actions (two
    int32 bridge words, or six float32 duty commands), the reward and the
    done flag, each ``(T, R, 128)``."""
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
    return dfim_physics(c, action, torch.cos(st["eps"]), torch.sin(st["eps"]), st)


def dfim_rollout_buffer_plain(c: DfimConsts, states, actions):
    """Plain version of ``dfim_rollout_buffer``: the final states (exact
    sin/cos of the angle every step, no references, no reset)."""
    st = dict(zip(_state_keys(c), states))
    for t in range(actions.shape[0]):
        st = _buffer_step(c, st, _buffer_action(c, actions, t))
    return tuple(st[key].clone() for key in _state_keys(c))


def dfim_record_buffer_plain(c: DfimConsts, states, actions):
    """Plain version of ``dfim_record_buffer``: every step's states, each
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
    "dfim_rollout_random": [_P, _P, ctypes.c_uint64, _I, _I, _P, _P, _P],
    "dfim_rollout_buffer": [_P, _P, _I, _I, _P, _P, _P, _P, _P],
    "dfim_record_random": [_P, _P, ctypes.c_uint64, _I, _I, _P, _P, _P],
    "dfim_record_buffer": [_P, _P, _I, _I, _P, _P, _P, _P, _P],
}


def _launch(name, device, *args, launches=LAUNCHES):
    lib = family_library(LIBRARY[name], "dfim", _ARGTYPES,
                         (len(CONST_NAMES), len(ROW_NAMES), len(FLAG_NAMES)))
    launch_kernel(lib, "dfim", name, device, launches, *args)


def _with_omega(c, planes):
    """(omega or NULL, the five other planes)."""
    return ([] if c.mech else [None]) + list(planes)


def _buffer_args(c, actions):
    return (actions.data_ptr(), None) if c.finite else (None, actions.data_ptr())


def dfim_rollout_random(c: DfimConsts, seed: int, states, n_steps: int):
    """``(*states, reward_sum, term_count, rv, rk, rl, rs)``."""
    device, R = check_planes(c, states)
    if device.type == "cpu":
        return dfim_rollout_random_plain(c, seed, tuple(states), n_steps)
    outs = _rollout_random_launch(c, seed, states, n_steps, R * LANE)
    return tuple(x.reshape(-1, LANE) for x in outs)


def _rollout_random_launch(c, seed, states, n_steps, n_envs):
    """The random rollout's kernel on the first ``n_envs`` envs of the
    planes, its outputs flat: each state plane, the reward sums and
    termination counts ``(n_envs,)``, the reference rows ``(n_ref *
    n_envs,)``, row 0 first."""
    device = states[0].device
    outs = ([torch.empty(n_envs, dtype=torch.float32, device=device)
             for _ in range(c.n_state + 2)]
            + [torch.empty(c.n_ref * n_envs, dtype=torch.float32, device=device)
               for _ in range(4)])
    _launch("dfim_rollout_random", device, c.host.ctypes.data, c.flags.ctypes.data,
            seed_u64(seed), n_envs, int(n_steps), ptr_array(_with_omega(c, states)),
            ptr_array(_with_omega(c, outs)))
    return outs


def dfim_rollout_buffer(c: DfimConsts, states, actions):
    """The final states after the action buffer."""
    device, R = check_planes(c, states)
    T = check_channel_actions(c, actions, R, device)
    if device.type == "cpu":
        return dfim_rollout_buffer_plain(c, tuple(states), actions)
    outs = [torch.empty((R, LANE), dtype=torch.float32, device=device) for _ in range(c.n_state)]
    _launch("dfim_rollout_buffer", device, c.host.ctypes.data, c.flags.ctypes.data, R * LANE, T,
            ptr_array(_with_omega(c, states)), *_buffer_args(c, actions),
            ptr_array(_with_omega(c, outs)))
    return tuple(outs)


def dfim_record_random(c: DfimConsts, seed: int, states, n_steps: int):
    """``(*states, *refs, *actions, reward, done)``, each ``(T, R, 128)``."""
    device, R = check_planes(c, states)
    if device.type == "cpu":
        return dfim_record_random_plain(c, seed, tuple(states), n_steps)
    outs = _record_random_launch(c, seed, states, n_steps, R * LANE, LAUNCHES)
    return tuple(x.view(int(n_steps), R, LANE) for x in outs)


def _record_random_launch(c: DfimConsts, seed: int, states, n_steps: int, n_envs: int,
                          launches=None):
    """dfim_record_random's kernel on the first ``n_envs`` envs of the
    planes: the recorded signals, each ``(T, n_envs)``; the launch counted
    in ``launches`` (none: not counted)."""
    outs, args = _record_random_args(c, seed, states, n_steps, n_envs)
    _launch("dfim_record_random", states[0].device, *args,
            launches={"dfim_record_random": 0} if launches is None else launches)
    return outs


def _record_random_args(c: DfimConsts, seed: int, states, n_steps: int, n_envs: int):
    """The recorder's output tensors, each ``(T, n_envs)``, and its C
    arguments before the stream."""
    outs = [torch.empty((int(n_steps), n_envs), dtype=dt, device=states[0].device)
            for dt in record_dtypes(c)]
    it = iter(outs)
    st = [next(it) for _ in range(c.n_state)]
    refs = [next(it) for _ in range(c.n_ref)]
    acts = [next(it) for _ in range(c.n_act)]
    reward, done = next(it), next(it)
    ptr_list = (_with_omega(c, st) + refs + [None] * (2 - c.n_ref)
                + (acts + [None] * 6 if c.finite else [None] * 2 + acts) + [reward, done])
    return outs, (c.host.ctypes.data, c.flags.ctypes.data, seed_u64(seed), n_envs,
                  int(n_steps), ptr_array(_with_omega(c, states)), ptr_array(ptr_list))


def dfim_record_ring_layout(c: DfimConsts):
    """The random recorder's ring for ``c``'s instance
    (csrc/fused_dfim_record.cu's DfimRecordRing, in csrc/ring_pipe.cuh's
    RingLayout): consumer and producer warps, K steps a slot, slots, words a
    step (finite: both bridges' bits in one word; continuous: the six
    duties; then four per reference row), shared-memory bytes; one thread
    per env with constant references.  Computed here, without the
    library."""
    if c.all_const:
        return named_ring_layout((0,) * 6 + (1,))
    K, P = DFIM_RECORD_RING
    words = c.n_words + 4 * c.n_ref
    return named_ring_layout((4, 4 * P, K, 2, words, 2 * K * words * LANE * 4, 0))


def dfim_record_buffer(c: DfimConsts, states, actions):
    """Every step's states, each ``(T, R, 128)``."""
    device, R = check_planes(c, states)
    T = check_channel_actions(c, actions, R, device)
    if device.type == "cpu":
        return dfim_record_buffer_plain(c, tuple(states), actions)
    outs = [torch.empty((T, R, LANE), dtype=torch.float32, device=device)
            for _ in range(c.n_state)]
    _launch("dfim_record_buffer", device, c.host.ctypes.data, c.flags.ctypes.data, R * LANE, T,
            ptr_array(_with_omega(c, states)), *_buffer_args(c, actions),
            ptr_array(_with_omega(c, outs)))
    return tuple(outs)


# ---------------------------------------------------------------------------
# builder (the JAX package's entry point)
# ---------------------------------------------------------------------------


def make_fused_dfim_family_rollout(env, n_steps, n_envs, action_mode="random", randomize=None):
    """Universal fused rollout for the doubly fed induction family: the six
    ``{Finite, Cont} x {CC, TC, SC}`` DFIM catalog ids.

    * random mode: ``rollout(seed, *state0) -> (*states, reward_sum,
      term_count, rv, rk, rl, rs)``; states = (omega?, i_salpha, i_sbeta,
      psi_ralpha, psi_rbeta, eps), ``(n_envs // 128, 128)`` float32 planes,
      the reference rows ``(n_ref * n_envs // 128, 128)``.
    * buffer mode: ``rollout(*state0, actions) -> states`` with an int32
      ``(n_steps, 2, n_envs // 128, 128)`` (finite: stator bits, rotor bits)
      or float32 ``(n_steps, 6, n_envs // 128, 128)`` (cont duties) action
      buffer; deterministic physics only.

    The device is that of the inputs."""
    if randomize:
        raise NotImplementedError(
            "domain randomization (randomize=) is not fused yet; it arrives with queue 2, "
            "item 7 of the port (r_s, r_r, j_rotor and u_sup as per-env planes)")
    if n_envs % LANE:
        raise ValueError(f"n_envs must be a multiple of {LANE}")
    R = n_envs // LANE
    c = DfimConsts(env)
    if action_mode == "random":
        def rollout(seed, *state0):
            check_rollout_inputs(R, n_steps, state0)
            return dfim_rollout_random(c, seed, state0, n_steps)
        rollout.consts = c
        return rollout
    if action_mode != "buffer":
        raise ValueError(f"action_mode must be 'random' or 'buffer', got {action_mode!r}")

    def rollout(*args):
        *state0, actions = args
        check_rollout_inputs(R, n_steps, state0, actions)
        return dfim_rollout_buffer(c, state0, actions)
    rollout.consts = c
    return rollout


# ---------------------------------------------------------------------------
# the universal policy recorder's view of the family
# ---------------------------------------------------------------------------


def policy_surface(c: DfimConsts, env):
    """What ``ops.fused_policy.make_fused_policy_record_universal`` needs of
    the family (the policy-adapter surface of ``_dfim_family``,
    pallas_dfim.py:750-764): the observation spec (omega, the stator
    currents over their limit, the rotor fluxes over ``l_m i_lim``, the
    angle as cos/sin), the heads (8, 8) of the stator's and the rotor's B6
    bits or six duties in [-1, 1], and the plain step.  ``aux`` is
    ``(flux direction or None, cos, sin)``: the pre-step flux direction
    where a row refers to the dq currents, then the step's (cos, sin) as the
    sync family's."""
    ps, names, lim = system_limits(env)
    i_lim, w_lim = float(lim[names.index("i_sd")]), float(lim[names.index("omega")])
    psi_lim = float(ps.motor.parameter["l_m"]) * i_lim
    off, i_eps = int(c.mech), c.n_state - 1
    obs_spec = policy_obs_spec(c.mech, w_lim, ps.load.omega_fixed, [
        ("state", off, 1.0 / i_lim), ("state", off + 1, 1.0 / i_lim),
        ("state", off + 2, 1.0 / psi_lim), ("state", off + 3, 1.0 / psi_lim),
        ("cos", i_eps), ("sin", i_eps)])

    def aux(st, afresh=False):
        cs = flux_dir(c, st) if c.needs_dq else None
        if c.mech or afresh:
            return cs, torch.cos(st["eps"]), torch.sin(st["eps"])
        return cs, st["c"], st["s"]

    return SimpleNamespace(
        family="dfim", consts=c, obs_spec=obs_spec, act_ns=(8, 8) if c.finite else None,
        act_range=None if c.finite else (np.full(6, -1.0, _f32), np.ones(6, _f32)),
        state_keys=_state_keys(c), init=lambda bits, states: _random_init(c, bits, states),
        aux=aux, aux_cs=lambda a: a[1:],
        quantities=lambda st, a: [dfim_quantity(c, j, st, a[0]) for j in range(c.n_ref)],
        action=tuple, step=lambda st, action, a: dfim_action_step(c, st, action, a[1], a[2], a[0]),
        planes=lambda planes: _with_omega(c, planes))
