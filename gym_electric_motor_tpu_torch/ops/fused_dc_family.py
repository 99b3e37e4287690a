"""Universal DC-family fused rollouts: the reducing rollout and the trajectory
recorder, each in a random-action and an action-buffer mode, for the 24
``{Finite, Cont} x {CC, TC, SC} x {PermExDc, SeriesDc, ShuntDc, ExtExDc}``
catalog ids at their defaults (and the finite and continuous 1QC and 2QC
converters passed as ``converter=``).

Counterpart of ``_dc_family`` and ``make_fused_dc_rollout`` in
``gym_electric_motor_tpu/ops/pallas_dc.py`` and of the DC family's part of
``make_fused_record_rollout`` in ``ops/pallas_record.py``.  Four kernels
written in CUDA carry the work on the GPU, over the shared step of
``csrc/dc_step.cuh``:

======================= ================================================
``dc_rollout_random``    T random-action steps, reduced to the final state,
                         reward sums, termination counts and the final
                         reference rows (``csrc/fused_dc.cu``; with Wiener
                         references producer warps draw each step's
                         action and reference candidates into a
                         shared-memory ring, ``csrc/dc_ring.cuh``, and
                         consumer warps run the step)
``dc_rollout_buffer``    T steps of a given action buffer, deterministic
                         (``csrc/fused_dc.cu``)
``dc_record_random``     the random step, every step recorded
                         (``csrc/fused_dc_record.cu``; with Wiener
                         references producer warps draw and consumer
                         warps step, as in the rollout,
                         ``dc_record_ring_layout``)
``dc_record_buffer``     the buffer step, every state recorded
                         (``csrc/fused_dc_record.cu``)
======================= ================================================

Each kernel has a plain PyTorch version here (``*_plain``) with the same
arithmetic in the same order and the same Philox bits
(``fused_common.DcBits``).  A wrapper runs the plain version only for
tensors on the CPU; for CUDA tensors it launches the kernel (and counts
the launch in ``LAUNCHES``) or raises.

Public functions keep the JAX builder's layout: state planes ``(omega,)
i`` or ``(omega,) i_a, i_e`` (omega only under the polynomial load's
dynamic speed) are ``(n_envs // 128, 128)`` float32, per-step arrays ``(T,
n_envs // 128, 128)``, an action buffer ``(T, [2,] n_envs // 128, 128)``
(the channel axis for ExtExDc only), int32 for a finite converter and
float32 for a continuous one; the reference rows come out as ``(n_ref *
n_envs // 128, 128)``, row 0 first.  The ShuntDc env's ``i_sum`` is an
observation of its ``CurrentSumProcessor`` and no state of the kernels.

What raises ``NotImplementedError`` (naming the queue item that brings it,
or pointing at ``VectorEnv`` where the JAX kernels do not fuse it either):
everything ``fused_common.fused_check_system`` and
``fused_constraint_mode`` reject, ``randomize=``, interlocking time, multi
converters other than the dual 4QC, other references than wiener and const
on a current, the torque or (under a dynamic load) omega.
"""

from __future__ import annotations

import ctypes
from types import SimpleNamespace

import numpy as np
import torch

from .fused_common import (
    LANE,
    RING_LAYOUT_FIELDS,
    ROW_NAMES,
    TWO_PI,
    DcBits,
    c2i,
    c2u,
    check_planes,
    check_rollout_inputs,
    check_tensor,
    family_library,
    fused_check_system,
    fused_constraint_mode,
    launch_kernel,
    named_ring_layout,
    physics_rows,
    policy_obs_spec,
    poly_load_rhs,
    ptr_array,
    ref_rows,
    reference_step,
    require,
    require_default_constraints,
    seed_u64,
    system_limits,
    uniform_from_bits,
    wiener_init,
    wse_err,
)

_f32 = np.float32

# Order of the float constants, the same as DcConstIndex in
# csrc/dc_step.cuh; then ROW_NAMES for each of two reference rows
# (RefRowIndex of csrc/common_step.cuh), and FLAG_NAMES as int32 (DcFlag).
CONST_NAMES = (
    "u_sup", "half_tau", "tau", "sixth",
    "neg_a", "neg_aw", "r", "b", "bw", "inv_l", "neg_re", "inv_le", "tq",
    "load_a", "load_b", "load_c", "omega_lin", "jt_over_td", "inv_jt",
    "lim0", "lim1", "bias", "violation_reward",
    "act_lo0", "act_span0", "act_lo1", "act_span1",
    "two_pi", "ln10", "u_min",
)
FLAG_NAMES = ("qty0", "qty1", "all_const", "no_cons", "finite", "mech", "n_ref", "mclass",
              "conv0", "conv1", "series")
# referenced quantities (DcQuantity): the first and second current, the
# torque, the speed
Q_EL0, Q_EL1, Q_TORQUE, Q_OMEGA = range(4)
# motor classes (DcMotorClass): one current (PermExDc, SeriesDc), two
# currents on one converter channel (ShuntDc), two channels (ExtExDc)
ONE, SHUNT, EXTEX = range(3)
# converter codes: the number of quadrants
CONV_CODES = {"1QC": 1, "2QC": 2, "4QC": 4}

KERNELS = ("dc_rollout_random", "dc_rollout_buffer", "dc_record_random", "dc_record_buffer")
# the controller-in-the-loop kernel (the DC speed cascade, csrc/fused_dc_cascade.cu)
CONTROL_KERNELS = ("dc_cascade_rollout",)
# the library of each kernel (csrc/<name>.cu)
LIBRARY = {"dc_rollout_random": "fused_dc", "dc_rollout_buffer": "fused_dc",
           "dc_record_random": "fused_dc_record", "dc_record_buffer": "fused_dc_record"}

# launches of each CUDA kernel since the last reset_launches()
LAUNCHES = dict.fromkeys(KERNELS + CONTROL_KERNELS, 0)

# the random recorder's ring (DcRecordRing in csrc/fused_dc_record.cu): K
# steps a slot, producer warps per consumer warp
DC_RECORD_RING = (8, 2)


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


_MCLASS = {"PermExDc": ONE, "SeriesDc": ONE, "ShuntDc": SHUNT, "ExtExDc": EXTEX}
_EL_NAMES = {ONE: ("i",), SHUNT: ("i_a", "i_e"), EXTEX: ("i_a", "i_e")}


def _converter_kinds(conv, mclass):
    """The kind of each converter channel, raising for the converters the
    kernels do not simulate (pallas_dc.py:642-656)."""
    if mclass == EXTEX:
        subs = tuple(conv.sub_kinds or ())
        if subs not in (("Finite-4QC", "Finite-4QC"), ("Cont-4QC", "Cont-4QC")):
            raise NotImplementedError(
                f"the DC-family kernels take the default dual-4QC multi converter for ExtExDc; "
                f"got {subs or conv.kind!r}: run other converters on VectorEnv")
        return subs
    kinds = [f"{a}-{q}" for a in ("Finite", "Cont") for q in CONV_CODES]
    if conv.kind not in kinds:
        raise NotImplementedError(
            f"the DC-family kernels take the 1QC, 2QC and 4QC converters; got {conv.kind!r}: "
            "run other converters on VectorEnv")
    return (conv.kind,)


class DcConsts:
    """The baked constants of one env (``_dc_family``), as float32:
    ``host`` (floats) and ``flags`` (int32) are the arrays handed to the
    kernels, ``f`` and ``rows`` the same values as Python floats for the
    plain versions.  Raises ``NotImplementedError`` for what the kernels do
    not simulate (see the module docstring).

    The motor laws of one class share one form with constants that are
    zero where a law lacks a term, so PermExDc and SeriesDc run the same
    instructions: ``di/dt = ((-A w - r i) - (B w) i + u) / l`` with
    ``(A, B) = (psi_e, 0)`` or ``(0, l_e')``; ``-(0 w) - r i`` and ``x -
    (0 w) i`` round exactly as ``-r i`` and ``x`` do.  At constant speed
    ``-A w`` and ``B w`` are host constants formed in double precision, as
    the JAX kernel forms them from the Python floats.

    ``physics_only=True`` reads the motor, load, converter and supply
    alone, for a specialised builder that checks the system itself and
    bakes its own references, reward and constraint (``fused_dc.py``): the env's
    reference generator, reward weights and constraints are not read, the
    rows are one zero constant row (``physics_rows``) and the flags the
    defaults."""

    def __init__(self, env, physics_only=False):
        ps = env.physical_system if physics_only else fused_check_system(env.physical_system)
        if ps.motor.kind not in _MCLASS:
            raise NotImplementedError(
                f"the DC-family kernels need a DC motor, got {ps.motor.kind!r}")
        if ps.dtype != torch.float32:
            raise NotImplementedError("the fused kernels run in float32")
        self.mclass = _MCLASS[ps.motor.kind]
        self.series = ps.motor.kind == "SeriesDc"
        self.el_names = _EL_NAMES[self.mclass]
        self.n_el = len(self.el_names)
        self.n_ch = 2 if self.mclass == EXTEX else 1
        conv = ps.converter
        self.conv_kinds = _converter_kinds(conv, self.mclass)
        self.conv = tuple(CONV_CODES[k.split("-")[1]] for k in self.conv_kinds)
        self.finite = conv.action_type == "finite"
        self.mech = ps.load.kind == "PolynomialStaticLoad"
        desc = tuple(("limit", (n,)) for n in self.el_names)
        self.no_cons = not physics_only and fused_constraint_mode(env, desc) == "none"
        self.rows = physics_rows(self.el_names[0]) if physics_only else ref_rows(env)
        self.n_ref = len(self.rows)
        if self.n_ref not in (1, 2) or (self.n_ref == 2 and (self.mclass != EXTEX or self.mech)):
            raise NotImplementedError(
                f"the DC-family kernels take one reference, or two on ExtExDc at constant speed "
                f"(the catalog's CC task); got {self.n_ref}")
        quantity = {n: j for j, n in enumerate(self.el_names)}
        quantity.update(torque=Q_TORQUE, omega=Q_OMEGA)
        for row in self.rows:
            if row["name"] not in quantity or (row["name"] == "omega" and not self.mech):
                raise NotImplementedError(
                    f"a reference on {row['name']!r} is not fused for this system; the kernels "
                    f"reference {self.el_names}, the torque, and omega under a dynamic load")
        names = list(ps.state_names)
        rw = env.reward_function
        wnames = list(env.physical_system.state_names)
        scored = {wnames[i] for i in np.flatnonzero(np.asarray(rw._weights))}
        if not physics_only and not scored <= {row["name"] for row in self.rows}:
            raise NotImplementedError(
                f"the fused kernels score the referenced states only; the reward weighs "
                f"{sorted(scored)}")
        self.all_const = all(row["kind"] == "const" for row in self.rows)
        self.n_act = self.n_ch if not self.finite else 1  # random words per step
        self.state_names = (("omega",) if self.mech else ()) + self.el_names
        self.n_state = len(self.state_names)
        self.act_names = ("action",) if self.n_ch == 1 else ("action_a", "action_e")
        if self.finite:
            self.act_ns = tuple(int(n) for n in np.atleast_1d(
                conv.action_space[1] if self.n_ch == 2 else [conv.action_space[1]]))
        else:
            act_lo = np.atleast_1d(np.asarray(conv.action_space[1], np.float32))
            act_hi = np.atleast_1d(np.asarray(conv.action_space[2], np.float32))

        mp = ps.motor.parameter
        lim = np.asarray(ps.limits)
        if ps.motor.kind == "PermExDc":
            a, b, r, l_inv, tq = float(mp["psi_e"]), 0.0, float(mp["r_a"]), 1.0 / float(mp["l_a"]), \
                float(mp["psi_e"])
        elif ps.motor.kind == "SeriesDc":
            a, b = 0.0, float(mp["l_e_prime"])
            r, l_inv = float(mp["r_a"]) + float(mp["r_e"]), 1.0 / (float(mp["l_a"]) + float(mp["l_e"]))
            tq = b
        else:
            a, b, r, l_inv, tq = 0.0, float(mp["l_e_prime"]), float(mp["r_a"]), \
                1.0 / float(mp["l_a"]), float(mp["l_e_prime"])
        omega = 0.0 if self.mech else float(ps.load.omega_fixed)
        tau = float(ps.tau)
        values = dict(
            u_sup=float(ps.supply.u_nominal), half_tau=0.5 * tau, tau=tau, sixth=tau / 6.0,
            neg_a=-a, neg_aw=-a * omega, r=r, b=b, bw=b * omega, inv_l=l_inv,
            neg_re=-float(mp.get("r_e", 0.0)) if self.n_el == 2 else 0.0,
            inv_le=1.0 / float(mp["l_e"]) if self.n_el == 2 else 0.0, tq=tq,
            load_a=0.0, load_b=0.0, load_c=0.0, omega_lin=0.0, jt_over_td=0.0, inv_jt=0.0,
            lim0=float(lim[names.index(self.el_names[0])]),
            lim1=float(lim[names.index(self.el_names[-1])]),
            bias=rw._bias_value, violation_reward=rw._violation_value,
            act_lo0=0.0, act_span0=0.0, act_lo1=0.0, act_span1=0.0,
            two_pi=TWO_PI, ln10=np.log(10.0), u_min=1e-12,
        )
        if not self.finite:
            for j in range(self.n_ch):
                values[f"act_lo{j}"] = act_lo[j]
                values[f"act_span{j}"] = _f32(act_hi[j] - act_lo[j])
        if self.mech:
            lp = ps.load.parameter
            load_a, j_total = float(lp["a"]), float(ps.load.j_load) + float(mp["j_rotor"])
            tau_decay = 1e-3
            values.update(load_a=load_a, load_b=float(lp["b"]), load_c=float(lp["c"]),
                          omega_lin=load_a / j_total * tau_decay, jt_over_td=j_total / tau_decay,
                          inv_jt=1.0 / j_total)
        floats = [_f32(values[n]) for n in CONST_NAMES]
        for j in (0, self.n_ref - 1):
            floats += [_f32(self.rows[j][n]) for n in ROW_NAMES]
        self.host = np.array(floats, dtype=np.float32)
        self.f = {n: float(v) for n, v in zip(CONST_NAMES, self.host)}
        self.qty = [quantity[row["name"]] for row in self.rows]
        flags = dict(qty0=self.qty[0], qty1=self.qty[-1], all_const=int(self.all_const),
                     no_cons=int(self.no_cons), finite=int(self.finite), mech=int(self.mech),
                     n_ref=self.n_ref, mclass=self.mclass, conv0=self.conv[0],
                     conv1=self.conv[-1], series=int(self.series))
        self.flags = np.array([flags[n] for n in FLAG_NAMES], dtype=np.int32)


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def dc_conv_frac(finite: bool, code: int, a, i):
    """One converter channel's voltage fraction from its action and the
    pre-step current (``conv_u`` without bridge planes, pallas_dc.py:
    682-715): finite 1QC conducts through its diode while i < 0, finite 2QC
    action 0 freewheels (1 while i < 0), finite 4QC maps 0..3 to 0, 1, -1,
    0; continuous duties clip to [0, 1] (1QC, 2QC) or [-1, 1] (4QC)."""
    if finite:
        if code == 1:
            return torch.where(i >= 0.0, a.to(torch.float32), 1.0)
        if code == 2:
            free = torch.where(i < 0.0, 1.0, 0.0)
            return torch.where(a == 1, 1.0, torch.where(a == 2, 0.0, free))
        return torch.where(a == 1, 1.0, 0.0) - torch.where(a == 2, 1.0, 0.0)
    if code == 1:
        return torch.where(i >= 0.0, torch.clamp(a, 0.0, 1.0), 1.0)
    if code == 2:
        return c2u(torch.clamp(a, 0.0, 1.0))
    return torch.clamp(a, -1.0, 1.0)


def dc_conv_i_sup(finite: bool, code: int, a, i):
    """One channel's supply current (``conv_i_sup`` without bridge planes,
    pallas_dc.py:717-743).  Only the non-ideal supplies read it, so the
    kernels, which take the ideal supply, never form it."""
    if finite:
        if code == 1:
            return torch.where(a == 1, i, 0.0)
        if code == 2:
            free = torch.where(i < 0.0, i, 0.0)
            return torch.where(a == 1, i, torch.where(a == 2, 0.0, free))
        return torch.where(a <= 1, i, 0.0) + torch.where((a == 0) | (a == 2), -i, 0.0)
    if code == 1:
        return torch.clamp(a, 0.0, 1.0) * i
    if code == 2:
        return c2i(torch.clamp(a, 0.0, 1.0), i)
    return torch.clamp(a, -1.0, 1.0) * i


def dc_torque(c: DcConsts, i0, i1):
    """psi_e i, l_e' i^2 or l_e' i_a i_e (``torque``, pallas_dc.py:794-833)."""
    t = c.f["tq"] * i0
    if c.mclass != ONE:
        return t * i1
    return t * i0 if c.series else t


def dc_physics(c: DcConsts, acts, st):
    """Voltage fractions from the actions and the pre-step current (i_a +
    i_e for ShuntDc), times the supply voltage, then RK4 over (omega?,
    currents) (``step_physics`` on its zero-interlock branch,
    pallas_dc.py:962-964, with ``rk4`` :878-892).  ``st`` and the result
    are dicts of planes ``w`` (dynamic speed), ``i0`` and ``i1`` (two
    currents)."""
    k = c.f
    w, i0, i1 = st.get("w"), st["i0"], st.get("i1")
    i_conv = i0 + i1 if c.mclass == SHUNT else i0
    u0 = dc_conv_frac(c.finite, c.conv[0], acts[0], i_conv) * k["u_sup"]
    u1 = dc_conv_frac(c.finite, c.conv[1], acts[1], i1) * k["u_sup"] if c.mclass == EXTEX else u0

    def rhs(w, i0, i1):
        aw, bw = (k["neg_a"] * w, k["b"] * w) if c.mech else (k["neg_aw"], k["bw"])
        d0 = (((aw - k["r"] * i0) - bw * (i0 if c.mclass == ONE else i1)) + u0) * k["inv_l"]
        d1 = (k["neg_re"] * i1 + u1) * k["inv_le"] if c.mclass != ONE else None
        dw = poly_load_rhs(k, w, dc_torque(c, i0, i1)) if c.mech else None
        return dw, d0, d1

    def axpy(x, d, h):
        return None if x is None else x + h * d

    h, dt, sixth = k["half_tau"], k["tau"], k["sixth"]
    x = (w, i0, i1)
    k1 = rhs(*x)
    k2 = rhs(*(axpy(s, d, h) for s, d in zip(x, k1)))
    k3 = rhs(*(axpy(s, d, h) for s, d in zip(x, k2)))
    k4 = rhs(*(axpy(s, d, dt) for s, d in zip(x, k3)))
    return {key: s + sixth * (a1 + 2.0 * (a2 + a3) + a4)
            for key, s, a1, a2, a3, a4 in zip(("w", "i0", "i1"), x, k1, k2, k3, k4)
            if s is not None}


def dc_quantity(c: DcConsts, j, st):
    """Row ``j``'s referenced quantity over its limit (``ref_quantity``,
    pallas_dc.py:987-997)."""
    q = {Q_EL0: lambda: st["i0"], Q_EL1: lambda: st["i1"], Q_OMEGA: lambda: st["w"],
         Q_TORQUE: lambda: dc_torque(c, st["i0"], st.get("i1"))}[c.qty[j]]()
    return q * c.rows[j]["inv_lim"]


def _state_keys(c):
    return (("w",) if c.mech else ()) + ("i0", "i1")[:c.n_el]


def dc_action_step(c: DcConsts, st, acts):
    """One step under ``acts``: physics, the limit constraint
    (``violated_fn``, pallas_dc.py:1003-1010), the WSE reward against the
    pre-advance references and the reset of a violating env to zeros (the
    polynomial load's speed too, pallas_common.py:688-689).  Returns the new
    state dict (the reference rows carried over) and ``(actions, reward,
    done, refs)``."""
    k = c.f
    y = dc_physics(c, acts, st)
    if c.no_cons:
        violated = torch.zeros_like(y["i0"], dtype=torch.bool)
    else:
        violated = torch.abs(y["i0"]) > k["lim0"]
        if c.n_el == 2:
            violated = violated | (torch.abs(y["i1"]) > k["lim1"])
    wse = k["bias"] - wse_err(c.rows[0], dc_quantity(c, 0, y), st["rv"][0])
    if c.n_ref == 2:
        wse = wse - wse_err(c.rows[1], dc_quantity(c, 1, y), st["rv"][1])
    reward = torch.where(violated, torch.full_like(wse, k["violation_reward"]), wse)
    out = (acts, reward, violated.to(torch.float32), list(st["rv"]))
    new = dict(st, rv=list(st["rv"]), rk=list(st["rk"]), rl=list(st["rl"]), rs=list(st["rs"]))
    zero = torch.zeros_like(y["i0"])
    for key in _state_keys(c):
        new[key] = torch.where(violated, zero, y[key])
    return new, out


def dc_sample_actions(c: DcConsts, words):
    """The random actions from the step's action words (``_sample_actions``,
    pallas_dc.py:1020-1042): a finite 4QC takes the low 2 bits (both ExtExDc
    channels from one word, bits 0-1 and 2-3), a 1QC the low bit, a 2QC
    min(floor(3 u), 2); a continuous channel lo + (hi - lo) u."""
    if not c.finite:
        return tuple(c.f[f"act_lo{j}"] + c.f[f"act_span{j}"] * uniform_from_bits(words[j])
                     for j in range(c.n_ch))
    b = words[0]
    if c.n_ch == 2:
        return ((b & 3).to(torch.int32), ((b >> 2) & 3).to(torch.int32))
    if c.conv[0] == 2:
        return (torch.clamp(torch.floor(uniform_from_bits(b) * 3.0).to(torch.int32), max=2),)
    return ((b & (c.act_ns[0] - 1)).to(torch.int32),)


def _random_init(c: DcConsts, bits, states):
    shape, device = states[0].shape, states[0].device
    st = {key: x.clone() for key, x in zip(_state_keys(c), states)}
    words = None if c.all_const else bits.init_words()
    st["rv"], st["rk"], st["rl"], st["rs"] = wiener_init(c.f, c.rows, c.all_const, words, shape,
                                                         device)
    st["zb"] = torch.zeros(shape, dtype=torch.float32, device=device)
    return st


def _random_step(c: DcConsts, st, words, t):
    """One random-mode step (``make_fused_dc_rollout``'s ``body``, pallas_dc.py:
    1166-1194): returns the new state dict and ``(actions, reward, done,
    refs)``.  ``words`` = ``(actions, u1, u2, lengths, sigmas, resets)``
    of the bit source."""
    shape = st["i0"].shape
    act_words, *ref_words = words
    acts = dc_sample_actions(c, [w.reshape(shape) for w in act_words])
    new, out = dc_action_step(c, st, acts)
    reference_step(c.f, c.rows, c.all_const, st, new, ref_words, out[2] > 0.5, t)
    return new, out


def _bits(c, seed, states, bits):
    return bits or DcBits(seed, states[0].numel(), states[0].device, c.n_ref, c.n_act)


def dc_rollout_random_plain(c: DcConsts, seed, states, n_steps, bits=None):
    """Plain version of ``dc_rollout_random``: ``(*states, reward_sum,
    term_count, rv, rk, rl, rs)``.  ``bits`` replaces the Philox bit source
    (an object with ``init_words()`` and ``step_words(t)``, see
    ``fused_common.DcBits``)."""
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


def record_dtypes(c: DcConsts):
    """The dtypes of the random recorder's signals, in order."""
    act = torch.int32 if c.finite else torch.float32
    return ((torch.float32,) * (c.n_state + c.n_ref) + (act,) * c.n_ch
            + (torch.float32, torch.float32))


def dc_record_random_plain(c: DcConsts, seed, states, n_steps, bits=None):
    """Plain version of ``dc_record_random``: per step the post-reset
    states, the references the reward was taken against, the actions (int32
    or float32, one per channel), the reward and the done flag, each ``(T,
    R, 128)``."""
    bits = _bits(c, seed, states, bits)
    st = _random_init(c, bits, states)
    rec = [[] for _ in record_dtypes(c)]
    for t in range(n_steps):
        st, (acts, r, done, refs) = _random_step(c, st, bits.step_words(t), t)
        row = [st[key] for key in _state_keys(c)] + refs + list(acts) + [r, done]
        for lst, x in zip(rec, row):
            lst.append(x)
    if n_steps == 0:
        return tuple(torch.empty((0,) + tuple(states[0].shape), dtype=dt, device=states[0].device)
                     for dt in record_dtypes(c))
    return tuple(torch.stack(lst) for lst in rec)


def _buffer_actions(c, actions, t):
    return (actions[t],) if c.n_ch == 1 else (actions[t, 0], actions[t, 1])


def dc_rollout_buffer_plain(c: DcConsts, states, actions):
    """Plain version of ``dc_rollout_buffer``: the final states (no
    references, no reset)."""
    st = dict(zip(_state_keys(c), states))
    for t in range(actions.shape[0]):
        st = dc_physics(c, _buffer_actions(c, actions, t), st)
    return tuple(st[key].clone() for key in _state_keys(c))


def dc_record_buffer_plain(c: DcConsts, states, actions):
    """Plain version of ``dc_record_buffer``: every step's states, each
    ``(T, R, 128)``."""
    st = dict(zip(_state_keys(c), states))
    T = actions.shape[0]
    out = torch.empty((c.n_state, T) + tuple(states[0].shape), dtype=torch.float32,
                      device=states[0].device)
    for t in range(T):
        st = dc_physics(c, _buffer_actions(c, actions, t), st)
        for j, key in enumerate(_state_keys(c)):
            out[j, t] = st[key]
    return tuple(out[j] for j in range(c.n_state))


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    "dc_rollout_random": [_P, _P, ctypes.c_uint64, _I, _I, _P, _P, _P],
    "dc_rollout_buffer": [_P, _P, _I, _I, _P, _P, _P, _P, _P],
    "dc_record_random": [_P, _P, ctypes.c_uint64, _I, _I, _P, _P, _P],
    "dc_record_buffer": [_P, _P, _I, _I, _P, _P, _P, _P, _P],
}


def _launch(name, device, *args, launches=LAUNCHES):
    lib = family_library(LIBRARY[name], "dc", _ARGTYPES,
                         (len(CONST_NAMES), len(ROW_NAMES), len(FLAG_NAMES)))
    launch_kernel(lib, "dc", name, device, launches, *args)


def _check_actions(c: DcConsts, actions, R, device):
    T = actions.shape[0] if isinstance(actions, torch.Tensor) and actions.dim() else 0
    shape = (T, R, LANE) if c.n_ch == 1 else (T, 2, R, LANE)
    check_tensor("actions", actions, shape, torch.int32 if c.finite else torch.float32, device)
    return T


def _in_ptrs(c, states):
    """(omega or NULL, i0, i1 or NULL)."""
    st = dict(zip(_state_keys(c), states))
    return ptr_array([st.get("w"), st["i0"], st.get("i1")])


def _out_state(c, outs):
    st = dict(zip(_state_keys(c), outs))
    return [st.get("w"), st["i0"], st.get("i1")]


def _buffer_args(c, actions):
    act_i, act_f = (actions, None) if c.finite else (None, actions)
    return (None if act_i is None else act_i.data_ptr(),
            None if act_f is None else act_f.data_ptr())


def dc_rollout_random(c: DcConsts, seed: int, states, n_steps: int):
    """``(*states, reward_sum, term_count, rv, rk, rl, rs)``."""
    device, R = check_planes(c, states)
    if device.type == "cpu":
        return dc_rollout_random_plain(c, seed, tuple(states), n_steps)

    def plane(rows=1):
        return torch.empty((rows * R, LANE), dtype=torch.float32, device=device)
    outs = [plane() for _ in range(c.n_state + 2)] + [plane(c.n_ref) for _ in range(4)]
    ptrs = _out_state(c, outs[:c.n_state]) + outs[c.n_state:]
    _launch("dc_rollout_random", device, c.host.ctypes.data, c.flags.ctypes.data, seed_u64(seed),
            R * LANE, int(n_steps), _in_ptrs(c, states), ptr_array(ptrs))
    return tuple(outs)


def dc_rollout_buffer(c: DcConsts, states, actions):
    """The final states after the action buffer."""
    device, R = check_planes(c, states)
    T = _check_actions(c, actions, R, device)
    if device.type == "cpu":
        return dc_rollout_buffer_plain(c, tuple(states), actions)
    outs = [torch.empty((R, LANE), dtype=torch.float32, device=device) for _ in range(c.n_state)]
    _launch("dc_rollout_buffer", device, c.host.ctypes.data, c.flags.ctypes.data, R * LANE, T,
            _in_ptrs(c, states), *_buffer_args(c, actions), ptr_array(_out_state(c, outs)))
    return tuple(outs)


def dc_record_random(c: DcConsts, seed: int, states, n_steps: int):
    """``(*states, *refs, *actions, reward, done)``, each ``(T, R, 128)``."""
    device, R = check_planes(c, states)
    if device.type == "cpu":
        return dc_record_random_plain(c, seed, tuple(states), n_steps)
    outs = _record_random_launch(c, seed, states, n_steps, R * LANE, LAUNCHES)
    return tuple(x.view(int(n_steps), R, LANE) for x in outs)


def _record_random_launch(c: DcConsts, seed: int, states, n_steps: int, n_envs: int,
                          launches=None):
    """dc_record_random's kernel on the first ``n_envs`` envs of the
    planes: the recorded signals, each ``(T, n_envs)``; the launch counted
    in ``launches`` (none: not counted)."""
    outs, args = _record_random_args(c, seed, states, n_steps, n_envs)
    _launch("dc_record_random", states[0].device, *args,
            launches={"dc_record_random": 0} if launches is None else launches)
    return outs


def _record_random_args(c: DcConsts, seed: int, states, n_steps: int, n_envs: int):
    """The recorder's output tensors, each ``(T, n_envs)``, and its C
    arguments before the stream."""
    outs = [torch.empty((int(n_steps), n_envs), dtype=dt, device=states[0].device)
            for dt in record_dtypes(c)]
    it = iter(outs)
    st = [next(it) for _ in range(c.n_state)]
    refs = [next(it) for _ in range(c.n_ref)]
    acts = [next(it) for _ in range(c.n_ch)]
    ptr_list = (_out_state(c, st) + refs + [None] * (2 - c.n_ref) + acts + [None] * (2 - c.n_ch)
                + list(it))
    return outs, (c.host.ctypes.data, c.flags.ctypes.data, seed_u64(seed), n_envs,
                  int(n_steps), _in_ptrs(c, states), ptr_array(ptr_list))


def dc_record_ring_layout(c: DcConsts):
    """The random recorder's ring for ``c``'s instance (csrc/fused_dc_record.cu's
    DcRecordRing, in csrc/ring_pipe.cuh's RingLayout): consumer and producer
    warps, K steps a slot, slots, words a step (one per converter channel,
    then four per reference row), shared-memory bytes; one thread per env
    with constant references.  Computed here, without the library."""
    if c.all_const:
        return named_ring_layout((0,) * 6 + (1,))
    K, P = DC_RECORD_RING
    words = c.n_ch + 4 * c.n_ref
    return named_ring_layout((4, 4 * P, K, 2, words, 2 * K * words * LANE * 4, 0))


def dc_record_buffer(c: DcConsts, states, actions):
    """Every step's states, each ``(T, R, 128)``."""
    device, R = check_planes(c, states)
    T = _check_actions(c, actions, R, device)
    if device.type == "cpu":
        return dc_record_buffer_plain(c, tuple(states), actions)
    outs = [torch.empty((T, R, LANE), dtype=torch.float32, device=device)
            for _ in range(c.n_state)]
    _launch("dc_record_buffer", device, c.host.ctypes.data, c.flags.ctypes.data, R * LANE, T,
            _in_ptrs(c, states), *_buffer_args(c, actions), ptr_array(_out_state(c, outs)))
    return tuple(outs)


# ---------------------------------------------------------------------------
# builder (the JAX package's entry point)
# ---------------------------------------------------------------------------


def make_fused_dc_rollout(env, n_steps, n_envs, action_mode="random", randomize=None):
    """Universal fused rollout for the DC family: the 24 ``{Finite, Cont} x
    {CC, TC, SC} x {PermExDc, SeriesDc, ShuntDc, ExtExDc}`` catalog ids.

    * random mode: ``rollout(seed, *state0) -> (*states, reward_sum,
      term_count, rv, rk, rl, rs)``; states = (omega?, i) or (omega?, i_a,
      i_e), ``(n_envs // 128, 128)`` float32 planes, the reference rows
      ``(n_ref * n_envs // 128, 128)``.
    * buffer mode: ``rollout(*state0, actions) -> states`` with an int32
      (finite) or float32 (cont) ``(n_steps, [2,] n_envs // 128, 128)``
      action buffer, the channel axis for ExtExDc only; deterministic
      physics only.

    The device is that of the inputs."""
    if randomize:
        raise NotImplementedError(
            "domain randomization (randomize=) is not fused yet; it arrives with queue 2, "
            "item 8 of the port (_param_reset_draws)")
    if n_envs % LANE:
        raise ValueError(f"n_envs must be a multiple of {LANE}")
    R = n_envs // LANE
    c = DcConsts(env)
    if action_mode == "random":
        def rollout(seed, *state0):
            check_rollout_inputs(R, n_steps, state0)
            return dc_rollout_random(c, seed, state0, n_steps)
        rollout.consts = c
        return rollout
    if action_mode != "buffer":
        raise ValueError(f"action_mode must be 'random' or 'buffer', got {action_mode!r}")

    def rollout(*args):
        *state0, actions = args
        check_rollout_inputs(R, n_steps, state0, actions)
        return dc_rollout_buffer(c, state0, actions)
    rollout.consts = c
    return rollout


# ---------------------------------------------------------------------------
# the universal policy recorder's view of the family
# ---------------------------------------------------------------------------


def policy_surface(c: DcConsts, env):
    """What ``ops.fused_policy.make_fused_policy_record_universal`` needs of
    the family (the policy-adapter surface of ``_dc_family``,
    pallas_dc.py:1014-1024, :1078-1087): the observation spec (omega and
    the currents over their limits), one head per converter channel (the
    1QC's 2, the 2QC's 3 or the 4QC's 4 actions; ExtExDc's dual 4QC (4, 4))
    or one duty per channel in the converter's range, and the plain step."""
    ps, names, lim = system_limits(env)
    w_lim = float(lim[names.index("omega")])
    off = int(c.mech)
    obs_spec = policy_obs_spec(c.mech, w_lim, ps.load.omega_fixed, [
        ("state", off + j, 1.0 / float(lim[names.index(n)])) for j, n in enumerate(c.el_names)])
    act_range = None
    if not c.finite:
        space = ps.converter.action_space
        act_range = (np.atleast_1d(np.asarray(space[1], _f32)),
                     np.atleast_1d(np.asarray(space[2], _f32)))
    return SimpleNamespace(
        family="dc", consts=c, obs_spec=obs_spec, act_ns=c.act_ns if c.finite else None,
        act_range=act_range, state_keys=_state_keys(c),
        init=lambda bits, states: _random_init(c, bits, states),
        aux=lambda st, afresh=False: None, aux_cs=None,
        quantities=lambda st, a: [dc_quantity(c, j, st) for j in range(c.n_ref)],
        action=tuple, step=lambda st, action, a: dc_action_step(c, st, action),
        planes=lambda planes: _out_state(c, planes))


# ---------------------------------------------------------------------------
# the DC speed cascade in the loop (make_fused_dc_cascade_rollout)
# ---------------------------------------------------------------------------

# Order of the controller's float constants, the same as DcCascadeIndex in
# csrc/control_laws.cuh.
CASCADE_CONST_NAMES = (
    "sc_p", "sc_i", "sc_lo", "sc_hi", "tc_lo", "tc_hi", "cc_p", "cc_i", "cc_lo", "cc_hi",
    "inv_out", "ref_lim", "l_emf", "psi_emf", "p_ff", "tau", "inv_psi", "inv_lp", "ie_limit",
    "ia_limit",
)
# the operating-point selections (DcOps): PermExDc i = T / psi, SeriesDc
# i = sqrt(max(T, 0) / l_e'), ShuntDc i_a = T / (l_e' i_e) with the i_e
# guards
OPS_CODES = {"permex": 0, "series": 1, "shunt": 2}

class DcCascadeConsts:
    """The baked constants of the DC speed cascade in the loop
    (``make_fused_dc_cascade_rollout``, pallas_dc.py:1300-1353): ``c`` the
    family's (``DcConsts``), ``host`` the tuned controller's constants in
    ``CASCADE_CONST_NAMES`` order as float32, ``f`` the same as Python
    floats and ``ops`` the operating-point code.  Each constant is
    rounded as the JAX kernel rounds it (``np.float32`` of the tuned value;
    the reciprocals ``1 / out_lim``, ``1 / psi_e`` and ``1 / l_e'`` in
    double first)."""

    def __init__(self, env, ctrl):
        kind = env.physical_system.motor.kind
        require(ctrl.control_task == "SC" and ctrl.output_kind == "cont",
                 "the DC cascade kernel takes the speed controller of a continuous converter")
        require(kind in ("PermExDc", "SeriesDc", "ShuntDc"),
                 f"in-kernel DC cascade covers PermExDc/SeriesDc/ShuntDc; got {kind!r} "
                 "(ExtExDc's dual-channel flux-weakening cascade runs on the general path)")
        c = DcConsts(env)
        desc = tuple(("limit", (n,)) for n in c.el_names)
        require_default_constraints(env, desc)
        require(c.mech and c.n_ch == 1 and not c.finite and c.n_ref == 1,
                 "the DC cascade kernel takes the speed ODE, one continuous channel and one "
                 "reference")
        require(c.rows[0]["name"] == "omega", "the DC cascade kernel references omega")
        self.c = c
        names = list(env.physical_system.state_names)
        pos = {nm: j for j, nm in enumerate(c.state_names)}
        ci = pos[names[int(np.asarray(ctrl.current_idx)[0])]]
        emf = pos[names[int(np.asarray(ctrl.emf_current_idx)[0])]]
        # the kernel reads the controlled current from i0 and the EMF
        # current from i0 (i for PermExDc and SeriesDc) or i1 (ShuntDc's i_e)
        require(ci == 1 and emf == (2 if kind == "ShuntDc" else 1),
                 "the DC cascade's current channels are not the family's planes")
        self.ops = OPS_CODES[ctrl.ops_kind]
        op = ctrl.ops_params
        tc = np.asarray(ctrl.tc_clip_limits, dtype=np.float64)
        cc = np.asarray(ctrl.cc_clip_limits, dtype=np.float64)
        values = dict(
            sc_p=ctrl.sc_p_gain[0], sc_i=ctrl.sc_i_gain[0],
            sc_lo=np.asarray(ctrl.sc_clip_range[0])[0], sc_hi=np.asarray(ctrl.sc_clip_range[1])[0],
            tc_lo=tc[0].min(), tc_hi=tc[1].max(), cc_p=ctrl.cc_p_gain[0], cc_i=ctrl.cc_i_gain[0],
            cc_lo=cc[0].min(), cc_hi=cc[1].max(), inv_out=1.0 / np.asarray(ctrl.output_limits)[0],
            ref_lim=np.asarray(ctrl.ref_limits)[0], l_emf=np.asarray(ctrl.l_emf)[0],
            psi_emf=np.asarray(ctrl.psi_emf)[0], p_ff=ctrl.pole_pairs,
            tau=env.physical_system.tau,
            inv_psi=1.0 / op["psi"] if self.ops == 0 else 0.0,
            inv_lp=1.0 / op["l_prime"] if self.ops != 0 else 0.0,
            ie_limit=op.get("i_e_limit", 0.0), ia_limit=op.get("i_a_limit", 0.0),
        )
        self.host = np.array([_f32(values[n]) for n in CASCADE_CONST_NAMES], dtype=np.float32)
        self.f = {n: float(v) for n, v in zip(CASCADE_CONST_NAMES, self.host)}


def dc_cascade_law(cc: DcCascadeConsts, st, sc_int, cc_int):
    """One cycle of the speed cascade (``cascade``, pallas_dc.py:1355-1384)
    on the state dict ``st``: PI speed control with the torque clip and
    anti-windup by exact equality, the operating point, the current clip,
    PI current control with the EMF feedforward and the voltage clip's
    anti-windup.  Returns the *unclipped* normalised voltage (the converter
    clips the duty) and the two integrators."""
    q = cc.f
    w, i0 = st["w"], st["i0"]
    err = st["rv"][0] * q["ref_lim"] - w
    t_ref = q["sc_p"] * err + q["sc_i"] * sc_int
    t_c = torch.clamp(t_ref, q["sc_lo"], q["sc_hi"])
    sc_int = sc_int + q["tau"] * err * (t_ref == t_c)
    if cc.ops == 0:
        i_ref = t_c * q["inv_psi"]
    elif cc.ops == 1:
        i_ref = torch.sqrt(torch.clamp(t_c, min=0.0) * q["inv_lp"])
    else:
        i_e = st["i1"]
        i_e_safe = torch.where(torch.abs(i_e) < 1e-4, torch.sign(i_e) * 1e-4 + (i_e == 0) * 1e-4,
                               i_e)
        i_ref = t_c * q["inv_lp"] / i_e_safe
        i_ref = torch.where(i_e > q["ie_limit"], torch.full_like(i_ref, -q["ia_limit"]), i_ref)
        i_ref = torch.where(i_e < -q["ie_limit"], torch.full_like(i_ref, q["ia_limit"]), i_ref)
    i_ref = torch.clamp(i_ref, q["tc_lo"], q["tc_hi"])
    err_i = i_ref - i0
    u = q["cc_p"] * err_i + q["cc_i"] * cc_int
    i_emf = st["i1"] if cc.ops == 2 else i0
    u = u + (q["l_emf"] * i_emf + q["psi_emf"]) * (w * q["p_ff"])
    u_c = torch.clamp(u, q["cc_lo"], q["cc_hi"])
    cc_int = cc_int + q["tau"] * err_i * (u == u_c)
    return u * q["inv_out"], sc_int, cc_int


def dc_cascade_rollout_plain(cc: DcCascadeConsts, seed, states, n_steps, bits=None):
    """Plain version of ``dc_cascade_rollout``: ``(*states, reward_sum,
    term_count, rv, rk, rl, rs, sc_int, cc_int)``.  The reference advances
    as in ``dc_rollout_random`` (``bits`` replaces its Philox source; the
    step's action words are unused); the integrators start at zero and
    persist across env resets, as ``control_environment`` carries the
    controller state."""
    c = cc.c
    bits = _bits(c, seed, states, bits)
    st = _random_init(c, bits, states)
    zero = torch.zeros_like(states[0])
    sc_int, cc_int = zero.clone(), zero.clone()
    reward, terms = zero.clone(), zero.clone()
    for t in range(n_steps):
        action, sc_int, cc_int = dc_cascade_law(cc, st, sc_int, cc_int)
        new, (_a, r, done, _refs) = dc_action_step(c, st, (action,))
        if not c.all_const:
            _acts, *ref_words = bits.step_words(t)
            reference_step(c.f, c.rows, c.all_const, st, new, ref_words, done > 0.5, t)
        st = new
        reward = reward + r
        terms = terms + done
    return (tuple(st[key] for key in _state_keys(c)) + (reward, terms)
            + tuple(torch.cat(st[key]) for key in ("rv", "rk", "rl", "rs")) + (sc_int, cc_int))


_CONTROL_ARGTYPES = {
    "dc_cascade_rollout": [_P, _P, _P, ctypes.c_uint64, _I, _I, _P, _P, _P],
}


def _cascade_library():
    return family_library("fused_dc_cascade", "dc_cascade", _CONTROL_ARGTYPES,
                          (len(CONST_NAMES), len(ROW_NAMES), len(FLAG_NAMES),
                           len(CASCADE_CONST_NAMES)))


def dc_cascade_rollout(cc: DcCascadeConsts, seed: int, states, n_steps: int):
    """``(*states, reward_sum, term_count, rv, rk, rl, rs, sc_int, cc_int)``
    of ``n_steps`` closed-loop steps: the plain version for CPU tensors, the
    kernel of ``csrc/fused_dc_cascade.cu`` for CUDA ones."""
    device, R = check_planes(cc.c, states)
    if device.type == "cpu":
        return dc_cascade_rollout_plain(cc, seed, tuple(states), n_steps)
    outs = _dc_cascade_launch(cc, seed, states, n_steps, R * LANE, LAUNCHES)
    return tuple(x.view(R, LANE) for x in outs)


def _dc_cascade_launch(cc: DcCascadeConsts, seed: int, states, n_steps: int, n_envs: int,
                       launches=None):
    """dc_cascade_rollout's kernel on the first ``n_envs`` envs of the
    planes: its outputs, each ``(n_envs,)``; the launch counted in
    ``launches`` (none: not counted)."""
    c = cc.c
    device = states[0].device
    outs = [torch.empty((n_envs,), dtype=torch.float32, device=device)
            for _ in range(c.n_state + 8)]
    ptrs = _out_state(c, outs[:c.n_state]) + outs[c.n_state:]
    launch_kernel(_cascade_library(), "dc_cascade", "dc_cascade_rollout", device,
                  {"dc_cascade_rollout": 0} if launches is None else launches,
                  c.host.ctypes.data, c.flags.ctypes.data, cc.host.ctypes.data, seed_u64(seed),
                  n_envs, int(n_steps), _in_ptrs(c, states), ptr_array(ptrs))
    return outs


def dc_cascade_ring_layout(cc: DcCascadeConsts):
    """The loop's design for ``cc``'s references (csrc/fused_dc_cascade.cu;
    csrc/ring_pipe.cuh's RingLayout): with Wiener references the ring
    (consumer and producer warps, K steps a slot, slots, words a step,
    shared-memory bytes), the same for the three motors; with constant ones
    one thread per env."""
    lib = _cascade_library()
    lib.dc_cascade_ring_layout.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    out = (ctypes.c_int * len(RING_LAYOUT_FIELDS))()
    if lib.dc_cascade_ring_layout(cc.c.flags.ctypes.data, out) != 0:
        raise ValueError("the flags are outside the DC cascade's configuration")
    return named_ring_layout(out)


def make_fused_dc_cascade_rollout(env, ctrl, n_steps, n_envs):
    """Fused closed-loop speed cascade of a Cont-SC-{PermExDc, SeriesDc,
    ShuntDc}-v0 env (``make_fused_dc_cascade_rollout``, pallas_dc.py:1276):
    the tuned three-stage chain of ``ctrl`` (from ``GemController.make(env,
    "Cont-SC-<motor>-v0")``) -- PI speed control, torque clip, the analytic
    operating point, current clip, PI current control with the EMF
    feedforward, voltage clip, the continuous output -- against the family
    physics with the polynomial load, the env's reference, the WSE reward,
    the limit constraint and the in-kernel reset to zero.

    ``rollout(seed, *state0) -> (*states, reward_sum, term_count, rv, rk,
    rl, rs, sc_int, cc_int)``; states = (omega, i) or (omega, i_a, i_e),
    ``(n_envs // 128, 128)`` float32 planes.  Build the env with
    ``ConstReference('omega', v)`` for the deterministic closed loop, which
    follows ``ctrl.control_environment``.  The device is that of the
    inputs."""
    if n_envs % LANE:
        raise ValueError(f"n_envs must be a multiple of {LANE}")
    R = n_envs // LANE
    cc = DcCascadeConsts(env, ctrl)

    def rollout(seed, *state0):
        check_rollout_inputs(R, n_steps, state0)
        return dc_cascade_rollout(cc, seed, state0, n_steps)
    rollout.consts = cc
    return rollout
