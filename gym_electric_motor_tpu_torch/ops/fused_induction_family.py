"""Universal squirrel-cage induction (SCIM) fused rollouts: the reducing
rollout and the trajectory recorder, each in a random-action and an
action-buffer mode, for the six ``{Finite, Cont} x {CC, TC, SC}`` SCIM
catalog ids at their defaults.

Counterpart of ``_induction_family`` and ``make_fused_induction_rollout`` in
``gym_electric_motor_tpu/ops/pallas_induction.py`` and of the induction
family's part of ``make_fused_record_rollout`` in ``ops/pallas_record.py``.
Four kernels written in CUDA carry the work on the GPU, over the shared
step of ``csrc/induction_step.cuh``:

============================ ============================================
``induction_rollout_random``  T random-action steps, reduced to the final
                              state, reward sums, termination counts and
                              the final reference rows
                              (``csrc/fused_induction.cu``; warp-specialised
                              with Wiener references)
``induction_rollout_buffer``  T steps of a given action buffer,
                              deterministic (``csrc/fused_induction.cu``)
``induction_record_random``   the random step, every step recorded
                              (``csrc/fused_induction_record.cu``;
                              warp-specialised with Wiener references,
                              ``induction_record_ring_layout``)
``induction_record_buffer``   the buffer step, every state recorded
                              (``csrc/fused_induction_record.cu``)
============================ ============================================

Each kernel has a plain PyTorch version here (``*_plain``) with the same
arithmetic in the same order and the same Philox bits
(``fused_common.SyncBits``: the SCIM draws what the synchronous family
draws).  A wrapper runs the plain version only for tensors on the CPU; for
CUDA tensors it launches the kernel (and counts the launch in
``LAUNCHES``) or raises.

Public functions keep the JAX builder's layout: state planes ``(omega,)
i_salpha, i_sbeta, psi_ralpha, psi_rbeta`` (omega only under the
polynomial load's dynamic speed; the env's rotor angle epsilon is no state
of the kernels) are ``(n_envs // 128, 128)`` float32, per-step arrays
``(T, n_envs // 128, 128)``, an action buffer int32 ``(T, n_envs // 128,
128)`` (finite) or float32 ``(T, 3, n_envs // 128, 128)`` (continuous);
the reference rows come out as ``(n_ref * n_envs // 128, 128)``, row 0
first.

The ODE is the stator-frame alpha/beta one under Clarke-only converter
voltages.  The dq quantities of the CC reward rotate the post-step stator
current by the rotor-flux direction from before the step, ``psi / |psi|``
with (1, 0) at zero flux, as the JAX kernel does in place of the env's
``atan2`` (pallas_induction.py:437-446, :557-583).

What raises ``NotImplementedError`` (naming the queue item that brings
it): everything ``fused_common.fused_check_system`` and
``fused_constraint_mode`` reject (NoConverter and the AC1, RC and AC3
supplies, the dq control space, the DqToAbc wrapper with its flux
observer, dead time, interlocking, state noise), ``randomize=``, other
references than wiener and const on i_sd, i_sq, the torque or (under a
dynamic load) omega.
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
    check_b6_actions,
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
    seed_u64,
    system_limits,
    uniform_from_bits,
    wiener_init,
    wse_err,
)

_f32 = np.float32

# Order of the float constants, the same as InductionConstIndex in
# csrc/induction_step.cuh; then ROW_NAMES for each of two reference rows
# (RefRowIndex of csrc/common_step.cuh), and FLAG_NAMES as int32
# (InductionFlag).
CONST_NAMES = (
    "u_sup", "half_tau", "tau", "sixth", "two_thirds", "inv_sqrt3",
    "inv_tau_sig", "c_psi", "c_w", "cw_w", "c_u", "l_m", "inv_tau_r", "p", "pw", "k_t",
    "load_a", "load_b", "load_c", "omega_lin", "jt_over_td", "inv_jt",
    "inv_ilim2", "tiny", "bias", "violation_reward", "two_pi", "ln10", "u_min",
)
FLAG_NAMES = ("qty0", "qty1", "all_const", "no_cons", "finite", "mech", "n_ref", "needs_dq")
QUANTITIES = ("i_sd", "i_sq", "torque", "omega")

KERNELS = ("induction_rollout_random", "induction_rollout_buffer", "induction_record_random",
           "induction_record_buffer")
# the library of each kernel (csrc/<name>.cu)
LIBRARY = {"induction_rollout_random": "fused_induction",
           "induction_rollout_buffer": "fused_induction",
           "induction_record_random": "fused_induction_record",
           "induction_record_buffer": "fused_induction_record"}

# launches of each CUDA kernel since the last reset_launches()
LAUNCHES = dict.fromkeys(KERNELS, 0)

# the random recorder's ring (IndRecordRing in
# csrc/fused_induction_record.cu): K steps a slot, producer warps per
# consumer warp
IND_RECORD_RING = (8, 2)


def reset_launches():
    for name in KERNELS:
        LAUNCHES[name] = 0


class InductionConsts:
    """The baked constants of one env (``_induction_family``), as float32:
    ``host`` (floats) and ``flags`` (int32) are the arrays handed to the
    kernels, ``f`` and ``rows`` the same values as Python floats for the
    plain versions.  Raises ``NotImplementedError`` for what the kernels do
    not simulate (see the module docstring).

    The motor constants are formed in double precision in the JAX
    expression order (pallas_induction.py:281-288, :336-343): sigma, c_w,
    c_u, k_t, then tau_r, tau_sig and c_psi; at constant speed ``c_w w``
    and ``p w`` too, as the JAX kernel forms them from Python floats.

    ``physics_only=True`` reads the motor, load, converter and supply
    alone, for a specialised builder that checks the system itself and
    bakes its own references, reward and constraint (``fused_induction.py``): the env's
    reference generator, reward weights and constraints are not read, the
    rows are one zero constant row (``physics_rows``) and the flags the
    defaults."""

    def __init__(self, env, physics_only=False):
        ps = env.physical_system if physics_only else fused_check_system(env.physical_system)
        if ps.motor.kind != "SCIM":
            raise NotImplementedError(
                f"the induction-family kernels need a SCIM, got {ps.motor.kind!r}")
        if ps.converter.kind not in ("Finite-B6C", "Cont-B6C"):
            raise NotImplementedError(
                f"the induction-family kernels need a B6 bridge, got {ps.converter.kind!r}")
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
                f"the induction-family kernels take 1 or 2 references, got {self.n_ref}")
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
        self.n_act = 1 if self.finite else 3
        self.state_names = (("omega",) if self.mech else ()) + (
            "i_salpha", "i_sbeta", "psi_ralpha", "psi_rbeta")
        self.n_state = len(self.state_names)
        self.act_names = ("action",) if self.finite else ("action_a", "action_b", "action_c")

        mp = ps.motor.parameter
        l_m = float(mp["l_m"])
        l_s = float(mp["l_m"] + mp["l_sigs"])
        l_r = float(mp["l_m"] + mp["l_sigr"])
        r_s, r_r, p = float(mp["r_s"]), float(mp["r_r"]), float(mp["p"])
        sigma = (l_s * l_r - l_m**2) / (l_s * l_r)
        c_w = l_m * p / (sigma * l_r * l_s)
        c_u = 1.0 / (sigma * l_s)
        k_t = 1.5 * p * l_m / l_r
        tau_r = l_r / r_r
        tau_sig = sigma * l_s / (r_s + r_r * (l_m**2 / l_r**2))
        c_psi = l_m * r_r / (sigma * l_s * l_r**2)
        lim = np.asarray(ps.limits)
        i_lim = float(lim[names.index("i_sd")])
        omega = 0.0 if self.mech else float(ps.load.omega_fixed)
        tau = float(ps.tau)
        values = dict(
            u_sup=float(ps.supply.u_nominal), half_tau=0.5 * tau, tau=tau, sixth=tau / 6.0,
            two_thirds=2.0 / 3.0, inv_sqrt3=1.0 / np.sqrt(3.0),
            inv_tau_sig=reciprocal_f32(tau_sig), c_psi=c_psi, c_w=c_w, cw_w=c_w * omega, c_u=c_u,
            l_m=l_m, inv_tau_r=reciprocal_f32(tau_r), p=p, pw=p * omega, k_t=k_t,
            load_a=0.0, load_b=0.0, load_c=0.0, omega_lin=0.0, jt_over_td=0.0, inv_jt=0.0,
            inv_ilim2=1.0 / (i_lim * i_lim), tiny=1e-24,
            bias=rw._bias_value, violation_reward=rw._violation_value,
            two_pi=TWO_PI, ln10=np.log(10.0), u_min=1e-12,
        )
        if self.mech:
            lp = ps.load.parameter
            a, j_total = float(lp["a"]), float(ps.load.j_load) + float(mp["j_rotor"])
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


def induction_torque(k, isa, isb, psa, psb):
    """k_t (psi_ralpha i_sbeta - psi_rbeta i_salpha) (pallas_induction.py:374-375)."""
    return k["k_t"] * (psa * isb - psb * isa)


def induction_physics(c: InductionConsts, action, st):
    """B6 fractions -> Clarke (no Park: the stator frame) -> RK4 over
    (omega?, i_salpha, i_sbeta, psi_ralpha, psi_rbeta) (``step_physics``
    on its no-interlock branch with ``el_rhs`` and ``rk4``,
    pallas_induction.py:364-435, :534-538).  ``st`` and the result are dicts
    of planes ``w`` (dynamic speed), ``isa``, ``isb``, ``psa``, ``psb``; the
    divisions by tau_sig and tau_r are products with their float32
    reciprocals, as XLA compiles them."""
    k = c.f
    fa, fb, fc = b6_fractions(c.finite, action)
    ua, ub, uc = fa * k["u_sup"], fb * k["u_sup"], fc * k["u_sup"]
    u_al = k["two_thirds"] * (ua - 0.5 * (ub + uc))
    u_be = k["inv_sqrt3"] * (ub - uc)

    def rhs(w, isa, isb, psa, psb):
        cww, pw = (k["c_w"] * w, k["p"] * w) if c.mech else (k["cw_w"], k["pw"])
        d_isa = -isa * k["inv_tau_sig"] + k["c_psi"] * psa + cww * psb + k["c_u"] * u_al
        d_isb = -isb * k["inv_tau_sig"] + k["c_psi"] * psb - cww * psa + k["c_u"] * u_be
        d_psa = (k["l_m"] * isa - psa) * k["inv_tau_r"] - pw * psb
        d_psb = (k["l_m"] * isb - psb) * k["inv_tau_r"] + pw * psa
        dw = poly_load_rhs(k, w, induction_torque(k, isa, isb, psa, psb)) if c.mech else None
        return dw, d_isa, d_isb, d_psa, d_psb

    def axpy(x, d, h):
        return None if x is None else x + h * d

    h, dt, sixth = k["half_tau"], k["tau"], k["sixth"]
    keys = ("w", "isa", "isb", "psa", "psb")
    x = tuple(st.get(key) for key in keys)
    k1 = rhs(*x)
    k2 = rhs(*(axpy(s, d, h) for s, d in zip(x, k1)))
    k3 = rhs(*(axpy(s, d, h) for s, d in zip(x, k2)))
    k4 = rhs(*(axpy(s, d, dt) for s, d in zip(x, k3)))
    return {key: s + sixth * (a1 + 2.0 * (a2 + a3) + a4)
            for key, s, a1, a2, a3, a4 in zip(keys, x, k1, k2, k3, k4) if s is not None}


def flux_dir(c: InductionConsts, st):
    """cos/sin of the rotor-flux field angle as psi / |psi| with an rsqrt,
    (1, 0) where |psi|^2 < 1e-24 (pallas_induction.py:437-446): the env's
    ``atan2(0, 0) = 0`` at zero flux."""
    psa, psb = st["psa"], st["psb"]
    mag2 = psa * psa + psb * psb
    tiny = mag2 < c.f["tiny"]
    inv = torch.rsqrt(torch.where(tiny, torch.ones_like(mag2), mag2))
    return (torch.where(tiny, torch.ones_like(psa), psa * inv),
            torch.where(tiny, torch.zeros_like(psb), psb * inv))


def induction_quantity(c: InductionConsts, j, st, cs):
    """Row ``j``'s referenced quantity over its limit (``ref_quantities``,
    pallas_induction.py:560-583): the dq currents rotate the post-step
    current by the pre-step flux direction ``cs``."""
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
    return (("w",) if c.mech else ()) + ("isa", "isb", "psa", "psb")


def induction_action_step(c: InductionConsts, st, action, cs):
    """One step under ``action``: physics, the squared-current constraint
    on |i_alphabeta|^2 (rotation-invariant, pallas_induction.py:656-661),
    the WSE reward against the pre-advance references and the reset of a
    violating env to zeros (the polynomial load's speed too).  Returns the
    new state dict (the reference rows carried over) and ``(action,
    reward, done, refs)``."""
    k = c.f
    y = induction_physics(c, action, st)
    if c.no_cons:
        violated = torch.zeros_like(y["isa"], dtype=torch.bool)
    else:
        violated = (y["isa"] * y["isa"] + y["isb"] * y["isb"]) * k["inv_ilim2"] > 1.0
    wse = k["bias"] - wse_err(c.rows[0], induction_quantity(c, 0, y, cs), st["rv"][0])
    if c.n_ref == 2:
        wse = wse - wse_err(c.rows[1], induction_quantity(c, 1, y, cs), st["rv"][1])
    reward = torch.where(violated, torch.full_like(wse, k["violation_reward"]), wse)
    out = (action, reward, violated.to(torch.float32), list(st["rv"]))
    new = dict(st, rv=list(st["rv"]), rk=list(st["rk"]), rl=list(st["rl"]), rs=list(st["rs"]))
    zero = torch.zeros_like(y["isa"])
    for key in _state_keys(c):
        new[key] = torch.where(violated, zero, y[key])
    return new, out


def _random_init(c: InductionConsts, bits, states):
    shape, device = states[0].shape, states[0].device
    st = {key: x.clone() for key, x in zip(_state_keys(c), states)}
    words = None if c.all_const else bits.init_words()
    st["rv"], st["rk"], st["rl"], st["rs"] = wiener_init(c.f, c.rows, c.all_const, words, shape,
                                                         device)
    st["zb"] = torch.zeros(shape, dtype=torch.float32, device=device)
    return st


def _random_step(c: InductionConsts, st, words, t):
    """One random-mode step (``make_fused_induction_rollout``'s ``body``,
    pallas_induction.py:763-784): the actions, the pre-step flux direction
    (CC only), the action step, then the reference advance.  ``words`` =
    ``(actions, u1, u2, lengths, sigmas, resets)`` of the bit source."""
    shape = st["isa"].shape
    acts, *ref_words = words
    acts = [w.reshape(shape) for w in acts]
    if c.finite:
        action = (acts[0] & 7).to(torch.int32)
    else:
        action = tuple(2.0 * uniform_from_bits(w) - 1.0 for w in acts)
    cs = flux_dir(c, st) if c.needs_dq else None
    new, out = induction_action_step(c, st, action, cs)
    reference_step(c.f, c.rows, c.all_const, st, new, ref_words, out[2] > 0.5, t)
    return new, out


def _bits(c, seed, states, bits):
    return bits or SyncBits(seed, states[0].numel(), states[0].device, c.n_ref, c.n_act)


def induction_rollout_random_plain(c: InductionConsts, seed, states, n_steps, bits=None):
    """Plain version of ``induction_rollout_random``: ``(*states,
    reward_sum, term_count, rv, rk, rl, rs)``.  ``bits`` replaces the
    Philox bit source (an object with ``init_words()`` and
    ``step_words(t)``, see ``fused_common.SyncBits``)."""
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


def record_dtypes(c: InductionConsts):
    """The dtypes of the random recorder's signals, in order."""
    act = torch.int32 if c.finite else torch.float32
    return ((torch.float32,) * (c.n_state + c.n_ref) + (act,) * c.n_act
            + (torch.float32, torch.float32))


def induction_record_random_plain(c: InductionConsts, seed, states, n_steps, bits=None):
    """Plain version of ``induction_record_random``: per step the
    post-reset states, the references the reward was taken against, the
    action (int32, or three float32 duty commands), the reward and the
    done flag, each ``(T, R, 128)``."""
    bits = _bits(c, seed, states, bits)
    st = _random_init(c, bits, states)
    rec = [[] for _ in record_dtypes(c)]
    for t in range(n_steps):
        st, (a, r, done, refs) = _random_step(c, st, bits.step_words(t), t)
        acts = [a] if c.finite else list(a)
        row = [st[key] for key in _state_keys(c)] + refs + acts + [r, done]
        for lst, x in zip(rec, row):
            lst.append(x)
    if n_steps == 0:
        return tuple(torch.empty((0,) + tuple(states[0].shape), dtype=dt, device=states[0].device)
                     for dt in record_dtypes(c))
    return tuple(torch.stack(lst) for lst in rec)


def _buffer_action(c, actions, t):
    return actions[t] if c.finite else tuple(actions[t, j] for j in range(3))


def induction_rollout_buffer_plain(c: InductionConsts, states, actions):
    """Plain version of ``induction_rollout_buffer``: the final states (no
    references, no reset)."""
    st = dict(zip(_state_keys(c), states))
    for t in range(actions.shape[0]):
        st = induction_physics(c, _buffer_action(c, actions, t), st)
    return tuple(st[key].clone() for key in _state_keys(c))


def induction_record_buffer_plain(c: InductionConsts, states, actions):
    """Plain version of ``induction_record_buffer``: every step's states,
    each ``(T, R, 128)``."""
    st = dict(zip(_state_keys(c), states))
    T = actions.shape[0]
    out = torch.empty((c.n_state, T) + tuple(states[0].shape), dtype=torch.float32,
                      device=states[0].device)
    for t in range(T):
        st = induction_physics(c, _buffer_action(c, actions, t), st)
        for j, key in enumerate(_state_keys(c)):
            out[j, t] = st[key]
    return tuple(out[j] for j in range(c.n_state))


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    "induction_rollout_random": [_P, _P, ctypes.c_uint64, _I, _I, _P, _P, _P],
    "induction_rollout_buffer": [_P, _P, _I, _I, _P, _P, _P, _P, _P],
    "induction_record_random": [_P, _P, ctypes.c_uint64, _I, _I, _P, _P, _P],
    "induction_record_buffer": [_P, _P, _I, _I, _P, _P, _P, _P, _P],
}


def _launch(name, device, *args, launches=LAUNCHES):
    lib = family_library(LIBRARY[name], "induction", _ARGTYPES,
                         (len(CONST_NAMES), len(ROW_NAMES), len(FLAG_NAMES)))
    launch_kernel(lib, "induction", name, device, launches, *args)


def _with_omega(c, planes):
    """(omega or NULL, the four electrical planes)."""
    return ([] if c.mech else [None]) + list(planes)


def _buffer_args(c, actions):
    return (actions.data_ptr(), None) if c.finite else (None, actions.data_ptr())


def induction_rollout_random(c: InductionConsts, seed: int, states, n_steps: int):
    """``(*states, reward_sum, term_count, rv, rk, rl, rs)``."""
    device, R = check_planes(c, states)
    if device.type == "cpu":
        return induction_rollout_random_plain(c, seed, tuple(states), n_steps)
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
    _launch("induction_rollout_random", device, c.host.ctypes.data, c.flags.ctypes.data,
            seed_u64(seed), n_envs, int(n_steps), ptr_array(_with_omega(c, states)),
            ptr_array(_with_omega(c, outs)))
    return outs


def induction_rollout_buffer(c: InductionConsts, states, actions):
    """The final states after the action buffer."""
    device, R = check_planes(c, states)
    T = check_b6_actions(c, actions, R, device)
    if device.type == "cpu":
        return induction_rollout_buffer_plain(c, tuple(states), actions)
    outs = [torch.empty((R, LANE), dtype=torch.float32, device=device) for _ in range(c.n_state)]
    _launch("induction_rollout_buffer", device, c.host.ctypes.data, c.flags.ctypes.data, R * LANE,
            T, ptr_array(_with_omega(c, states)), *_buffer_args(c, actions),
            ptr_array(_with_omega(c, outs)))
    return tuple(outs)


def induction_record_random(c: InductionConsts, seed: int, states, n_steps: int):
    """``(*states, *refs, *actions, reward, done)``, each ``(T, R, 128)``."""
    device, R = check_planes(c, states)
    if device.type == "cpu":
        return induction_record_random_plain(c, seed, tuple(states), n_steps)
    outs = _record_random_launch(c, seed, states, n_steps, R * LANE, LAUNCHES)
    return tuple(x.view(int(n_steps), R, LANE) for x in outs)


def _record_random_launch(c: InductionConsts, seed: int, states, n_steps: int, n_envs: int,
                          launches=None):
    """induction_record_random's kernel on the first ``n_envs`` envs of
    the planes: the recorded signals, each ``(T, n_envs)``; the launch
    counted in ``launches`` (none: not counted)."""
    outs, args = _record_random_args(c, seed, states, n_steps, n_envs)
    _launch("induction_record_random", states[0].device, *args,
            launches={"induction_record_random": 0} if launches is None else launches)
    return outs


def _record_random_args(c: InductionConsts, seed: int, states, n_steps: int, n_envs: int):
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
                + (acts + [None] * 3 if c.finite else [None] + acts) + [reward, done])
    return outs, (c.host.ctypes.data, c.flags.ctypes.data, seed_u64(seed), n_envs,
                  int(n_steps), ptr_array(_with_omega(c, states)), ptr_array(ptr_list))


def induction_record_ring_layout(c: InductionConsts):
    """The random recorder's ring for ``c``'s instance
    (csrc/fused_induction_record.cu's IndRecordRing, in
    csrc/ring_pipe.cuh's RingLayout): consumer and producer warps, K steps
    a slot, slots, words a step (finite: the B6 bits; continuous: the three
    duties; then four per reference row), shared-memory bytes; one thread
    per env with constant references.  Computed here, without the
    library."""
    if c.all_const:
        return named_ring_layout((0,) * 6 + (1,))
    K, P = IND_RECORD_RING
    words = c.n_act + 4 * c.n_ref
    return named_ring_layout((4, 4 * P, K, 2, words, 2 * K * words * LANE * 4, 0))


def induction_record_buffer(c: InductionConsts, states, actions):
    """Every step's states, each ``(T, R, 128)``."""
    device, R = check_planes(c, states)
    T = check_b6_actions(c, actions, R, device)
    if device.type == "cpu":
        return induction_record_buffer_plain(c, tuple(states), actions)
    outs = [torch.empty((T, R, LANE), dtype=torch.float32, device=device)
            for _ in range(c.n_state)]
    _launch("induction_record_buffer", device, c.host.ctypes.data, c.flags.ctypes.data, R * LANE,
            T, ptr_array(_with_omega(c, states)), *_buffer_args(c, actions),
            ptr_array(_with_omega(c, outs)))
    return tuple(outs)


# ---------------------------------------------------------------------------
# builder (the JAX package's entry point)
# ---------------------------------------------------------------------------


def make_fused_induction_rollout(env, n_steps, n_envs, action_mode="random", randomize=None):
    """Universal fused rollout for the squirrel-cage induction family: the
    six ``{Finite, Cont} x {CC, TC, SC}`` SCIM catalog ids.

    * random mode: ``rollout(seed, *state0) -> (*states, reward_sum,
      term_count, rv, rk, rl, rs)``; states = (omega?, i_salpha, i_sbeta,
      psi_ralpha, psi_rbeta), ``(n_envs // 128, 128)`` float32 planes, the
      reference rows ``(n_ref * n_envs // 128, 128)``.
    * buffer mode: ``rollout(*state0, actions) -> states`` with an int32
      ``(n_steps, n_envs // 128, 128)`` (finite) or float32 ``(n_steps, 3,
      n_envs // 128, 128)`` (cont) action buffer; deterministic physics
      only.

    The device is that of the inputs."""
    if randomize:
        raise NotImplementedError(
            "domain randomization (randomize=) is not fused yet; it arrives with queue 2, "
            "item 7 of the port (r_s, r_r, j_rotor and u_sup as per-env planes)")
    if n_envs % LANE:
        raise ValueError(f"n_envs must be a multiple of {LANE}")
    R = n_envs // LANE
    c = InductionConsts(env)
    if action_mode == "random":
        def rollout(seed, *state0):
            check_rollout_inputs(R, n_steps, state0)
            return induction_rollout_random(c, seed, state0, n_steps)
        rollout.consts = c
        return rollout
    if action_mode != "buffer":
        raise ValueError(f"action_mode must be 'random' or 'buffer', got {action_mode!r}")

    def rollout(*args):
        *state0, actions = args
        check_rollout_inputs(R, n_steps, state0, actions)
        return induction_rollout_buffer(c, state0, actions)
    rollout.consts = c
    return rollout


# ---------------------------------------------------------------------------
# the universal policy recorder's view of the family
# ---------------------------------------------------------------------------


def policy_surface(c: InductionConsts, env):
    """What ``ops.fused_policy.make_fused_policy_record_universal`` needs of
    the family (the policy-adapter surface of ``_induction_family``,
    pallas_induction.py:669-676): the observation spec (omega, the stator
    currents over their limit and the rotor fluxes over ``l_m i_lim``; the
    stator frame has no angle plane), one 8-way head for the B6 bits or
    three duties in [-1, 1], and the plain step.  ``aux`` is the pre-step
    flux direction where a row refers to the dq currents."""
    ps, names, lim = system_limits(env)
    i_lim, w_lim = float(lim[names.index("i_sd")]), float(lim[names.index("omega")])
    psi_lim = float(ps.motor.parameter["l_m"]) * i_lim
    off = int(c.mech)
    obs_spec = policy_obs_spec(c.mech, w_lim, ps.load.omega_fixed, [
        ("state", off, 1.0 / i_lim), ("state", off + 1, 1.0 / i_lim),
        ("state", off + 2, 1.0 / psi_lim), ("state", off + 3, 1.0 / psi_lim)])
    return SimpleNamespace(
        family="induction", consts=c, obs_spec=obs_spec, act_ns=(8,) if c.finite else None,
        act_range=None if c.finite else (np.full(3, -1.0, _f32), np.ones(3, _f32)),
        state_keys=_state_keys(c), init=lambda bits, states: _random_init(c, bits, states),
        aux=lambda st, afresh=False: flux_dir(c, st) if c.needs_dq else None, aux_cs=None,
        quantities=lambda st, a: [induction_quantity(c, j, st, a) for j in range(c.n_ref)],
        action=lambda xs: xs[0] if c.finite else tuple(xs),
        step=lambda st, action, a: induction_action_step(c, st, action, a),
        planes=lambda planes: _with_omega(c, planes))
