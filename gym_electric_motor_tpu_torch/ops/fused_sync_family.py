"""Universal synchronous-family (PMSM / SynRM) fused rollouts: the reducing
rollout and the trajectory recorder, each in a random-action and an
action-buffer mode, for the twelve ``{Finite, Cont} x {CC, TC, SC} x
{PMSM, SynRM}`` catalog ids at their defaults.

Counterpart of ``_sync_family`` and ``make_fused_sync_rollout`` in
``gym_electric_motor_tpu/ops/pallas_sync.py`` and of the sync family's
part of ``make_fused_record_rollout`` in ``ops/pallas_record.py``.  Four
kernels written in CUDA (``csrc/fused_sync.cu``, over the shared step of
``csrc/sync_step.cuh``) carry the work on the GPU:

======================= ================================================
``sync_rollout_random``  T random-action steps, reduced to the final state,
                         reward sums, termination counts and the final
                         reference rows
``sync_rollout_buffer``  T steps of a given action buffer, deterministic
``sync_record_random``   the random step, every step recorded (with
                         Wiener references producer warps draw each
                         step's action and reference candidates into a
                         shared-memory ring and consumer warps step,
                         ``sync_record_ring_layout``)
``sync_record_buffer``   the buffer step, every state recorded
======================= ================================================

Each kernel has a plain PyTorch version here (``*_plain``) with the same
arithmetic in the same order and the same Philox bits
(``fused_common.SyncBits``).  A wrapper runs the plain version only for
tensors on the CPU; for CUDA tensors it launches the kernel (and counts
the launch in ``LAUNCHES``) or raises.

Public functions keep the JAX builders' layout: state planes ``(omega,)
i_sd, i_sq, eps`` (omega only for the polynomial load's dynamic speed) are
``(n_envs // 128, 128)`` float32, per-step arrays ``(T, n_envs // 128,
128)``, a continuous action buffer ``(T, 3, n_envs // 128, 128)``; the
reference rows come out as ``(n_ref * n_envs // 128, 128)``, row 0 first.
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
    policy_obs_spec,
    poly_load_rhs,
    ref_rows,
    reference_step,
    rotation_advance,
    system_limits,
    uniform_from_bits,
    wiener_init,
    wse_err,
)
from .fused_common import ptr_array as _ptrs
from .fused_common import seed_u64 as _seed

_f32 = np.float32

# Order of the float constants, the same as SyncConstIndex in
# csrc/sync_step.cuh; then ROW_NAMES for each of two reference rows
# (RefRowIndex of csrc/common_step.cuh), and FLAG_NAMES as int32 (SyncFlag).
CONST_NAMES = (
    "u_sup", "half_tau", "tau", "sixth", "two_thirds", "inv_sqrt3", "two_pi", "inv_two_pi",
    "p", "neg_r_s", "r_s", "l_q", "l_d", "neg_psi_p", "inv_ld", "inv_lq",
    "lq_pw", "ld_pw", "neg_psi_pw", "d_eps", "cos_d", "sin_d",
    "tq_gain", "psi_p", "ld_minus_lq",
    "load_a", "load_b", "load_c", "omega_lin", "jt_over_td", "inv_jt",
    "inv_i_lim", "bias", "violation_reward", "ln10", "u_min",
)
FLAG_NAMES = ("qty0", "qty1", "all_const", "no_cons", "finite", "mech", "n_ref")
QUANTITIES = ("i_sd", "i_sq", "torque", "omega")

KERNELS = ("sync_rollout_random", "sync_rollout_buffer", "sync_record_random",
           "sync_record_buffer")

# launches of each CUDA kernel since the last reset_launches()
LAUNCHES = dict.fromkeys(KERNELS, 0)

# the random recorder's ring (SyncRecordRing in csrc/fused_sync.cu): K
# steps a slot, producer warps per consumer warp
SYNC_RECORD_RING = (8, 2)


def reset_launches():
    for name in KERNELS:
        LAUNCHES[name] = 0


class SyncConsts:
    """The baked constants of one env (``_sync_family``), as float32:
    ``host`` (floats) and ``flags`` (int32) are the arrays handed to the
    kernels, ``f`` and ``rows`` the same values as Python floats for the
    plain versions.  Raises ``NotImplementedError`` for what the kernels do
    not simulate (see ``fused_common.fused_check_system``)."""

    def __init__(self, env):
        ps = fused_check_system(env.physical_system)
        if ps.motor.kind not in ("PMSM", "SynRM"):
            raise NotImplementedError(
                f"the synchronous-family kernels need a PMSM or SynRM, got {ps.motor.kind!r}")
        if ps.converter.kind not in ("Finite-B6C", "Cont-B6C"):
            raise NotImplementedError(
                f"the synchronous-family kernels need a B6 bridge, got {ps.converter.kind!r}")
        if ps.dtype != torch.float32:
            raise NotImplementedError("the fused kernels run in float32")
        self.no_cons = fused_constraint_mode(env, (("squared", ("i_sq", "i_sd")),)) == "none"
        self.finite = ps.converter.action_type == "finite"
        self.mech = ps.load.kind == "PolynomialStaticLoad"
        self.rows = ref_rows(env)
        self.n_ref = len(self.rows)
        if self.n_ref not in (1, 2):
            raise NotImplementedError(
                f"the synchronous-family kernels take 1 or 2 references, got {self.n_ref}")
        for row in self.rows:
            if row["name"] not in QUANTITIES or (row["name"] == "omega" and not self.mech):
                raise NotImplementedError(
                    f"a reference on {row['name']!r} is not fused for this system; the kernels "
                    "reference i_sd, i_sq, torque, and omega under a dynamic load")
        names = list(ps.state_names)
        rw = env.reward_function
        scored = {names[i] for i in np.flatnonzero(np.asarray(rw._weights))}
        if not scored <= {row["name"] for row in self.rows}:
            raise NotImplementedError(
                f"the fused kernels score the referenced states only; the reward weighs "
                f"{sorted(scored)}")
        self.all_const = all(row["kind"] == "const" for row in self.rows)
        self.n_act = 1 if self.finite else 3
        self.state_names = (("omega",) if self.mech else ()) + ("i_sd", "i_sq", "eps")
        self.n_state = len(self.state_names)
        self.act_names = ("action",) if self.finite else ("action_a", "action_b", "action_c")

        mp = ps.motor.parameter
        p, r_s = float(mp["p"]), float(mp["r_s"])
        l_d, l_q, psi_p = float(mp["l_d"]), float(mp["l_q"]), float(mp.get("psi_p", 0.0))
        tau = float(ps.tau)
        lim = np.asarray(ps.limits)
        omega = 0.0 if self.mech else float(ps.load.omega_fixed)
        pw = p * omega
        values = dict(
            u_sup=float(ps.supply.u_nominal), half_tau=0.5 * tau, tau=tau, sixth=tau / 6.0,
            two_thirds=2.0 / 3.0, inv_sqrt3=1.0 / np.sqrt(3.0), two_pi=TWO_PI,
            inv_two_pi=1.0 / TWO_PI,
            p=p, neg_r_s=-r_s, r_s=r_s, l_q=l_q, l_d=l_d, neg_psi_p=-psi_p,
            inv_ld=1.0 / l_d, inv_lq=1.0 / l_q,
            lq_pw=l_q * pw, ld_pw=l_d * pw, neg_psi_pw=-psi_p * pw, d_eps=p * omega,
            cos_d=np.cos(tau * p * omega), sin_d=np.sin(tau * p * omega),
            tq_gain=1.5 * p, psi_p=psi_p, ld_minus_lq=l_d - l_q,
            load_a=0.0, load_b=0.0, load_c=0.0, omega_lin=0.0, jt_over_td=0.0, inv_jt=0.0,
            inv_i_lim=1.0 / float(lim[names.index("i_sd")]),
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
        for j in (0, self.n_ref - 1):
            floats += [_f32(self.rows[j][n]) for n in ROW_NAMES]
        self.host = np.array(floats, dtype=np.float32)
        self.f = {n: float(v) for n, v in zip(CONST_NAMES, self.host)}
        codes = [QUANTITIES.index(row["name"]) for row in self.rows]
        flags = dict(qty0=codes[0], qty1=codes[-1], all_const=int(self.all_const),
                     no_cons=int(self.no_cons), finite=int(self.finite), mech=int(self.mech),
                     n_ref=self.n_ref)
        self.flags = np.array([flags[n] for n in FLAG_NAMES], dtype=np.int32)


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def _torque(k, i_sd, i_sq):
    return k["tq_gain"] * (k["psi_p"] + k["ld_minus_lq"] * i_sd) * i_sq


def sync_physics(c: SyncConsts, action, cos, sin, st):
    """B6 fractions -> Clarke -> Park at the cycle-start angle (cos, sin)
    -> RK4 over (omega?, i_sd, i_sq, eps) -> wrap of eps to [0, 2 pi)
    (``_sync_family``'s ``physics_step`` and ``step``).  ``st`` and the
    result are dicts of planes (``w`` under a dynamic load)."""
    k = c.f
    fa, fb, fc = b6_fractions(c.finite, action)
    ua, ub, uc = fa * k["u_sup"], fb * k["u_sup"], fc * k["u_sup"]
    u_alpha = k["two_thirds"] * (ua - 0.5 * (ub + uc))
    u_beta = k["inv_sqrt3"] * (ub - uc)
    u_d = cos * u_alpha + sin * u_beta
    u_q = -sin * u_alpha + cos * u_beta

    def rhs(w, d, q):
        if c.mech:
            dw = poly_load_rhs(k, w, _torque(k, d, q))
            pw = k["p"] * w
            dd = (k["neg_r_s"] * d + k["l_q"] * pw * q + u_d) * k["inv_ld"]
            dq = (k["neg_psi_p"] * pw - k["r_s"] * q - k["l_d"] * pw * d + u_q) * k["inv_lq"]
            return dw, dd, dq
        dd = (k["neg_r_s"] * d + k["lq_pw"] * q + u_d) * k["inv_ld"]
        dq = (k["neg_psi_pw"] - k["r_s"] * q - k["ld_pw"] * d + u_q) * k["inv_lq"]
        return None, dd, dq

    h, dt, sixth = k["half_tau"], k["tau"], k["sixth"]
    w, d, q, eps = st.get("w"), st["i_sd"], st["i_sq"], st["eps"]
    k1 = rhs(w, d, q)
    w2 = w + h * k1[0] if c.mech else None
    k2 = rhs(w2, d + h * k1[1], q + h * k1[2])
    w3 = w + h * k2[0] if c.mech else None
    k3 = rhs(w3, d + h * k2[1], q + h * k2[2])
    w4 = w + dt * k3[0] if c.mech else None
    k4 = rhs(w4, d + dt * k3[1], q + dt * k3[2])
    out = {}
    if c.mech:
        p = k["p"]
        eps = eps + sixth * (p * w + 2.0 * (p * w2 + p * w3) + p * w4)
        out["w"] = w + sixth * (k1[0] + 2.0 * (k2[0] + k3[0]) + k4[0])
    else:
        de = _f32(k["d_eps"])
        eps = eps + float(_f32(sixth) * (de + _f32(2.0) * (de + de) + de))
    out["i_sd"] = d + sixth * (k1[1] + 2.0 * (k2[1] + k3[1]) + k4[1])
    out["i_sq"] = q + sixth * (k1[2] + 2.0 * (k2[2] + k3[2]) + k4[2])
    out["eps"] = eps - k["two_pi"] * torch.floor(eps * k["inv_two_pi"])
    return out


def sync_quantity(c: SyncConsts, j, st):
    """Row ``j``'s referenced quantity over its limit (``ref_quantity``)."""
    row = c.rows[j]
    q = {"i_sd": lambda: st["i_sd"], "i_sq": lambda: st["i_sq"], "omega": lambda: st["w"],
         "torque": lambda: _torque(c.f, st["i_sd"], st["i_sq"])}[row["name"]]()
    return q * row["inv_lim"]


def _state_keys(c):
    return (("w",) if c.mech else ()) + ("i_sd", "i_sq", "eps")


def sync_action_step(c: SyncConsts, st, action, cos, sin):
    """One step under ``action``: physics, constraint, WSE reward against
    the pre-advance references, reset of a violating env and, at constant
    speed, the incremental Park rotation.  Returns the new state dict (the
    reference rows carried over) and ``(action, reward, done, refs)``."""
    k = c.f
    y = sync_physics(c, action, cos, sin, st)
    if c.no_cons:
        violated = torch.zeros_like(y["i_sd"], dtype=torch.bool)
    else:
        i_sd_n = y["i_sd"] * k["inv_i_lim"]
        i_sq_n = y["i_sq"] * k["inv_i_lim"]
        violated = (i_sd_n * i_sd_n + i_sq_n * i_sq_n) > 1.0
    wse = k["bias"] - wse_err(c.rows[0], sync_quantity(c, 0, y), st["rv"][0])
    if c.n_ref == 2:
        wse = wse - wse_err(c.rows[1], sync_quantity(c, 1, y), st["rv"][1])
    reward = torch.where(violated, torch.full_like(wse, k["violation_reward"]), wse)
    out = (action, reward, violated.to(torch.float32), list(st["rv"]))
    new = dict(st, rv=list(st["rv"]), rk=list(st["rk"]), rl=list(st["rl"]), rs=list(st["rs"]))
    zero = torch.zeros_like(y["i_sd"])
    for key in _state_keys(c):
        new[key] = torch.where(violated, zero, y[key])
    if not c.mech:
        new["c"], new["s"] = rotation_advance(k, cos, sin, violated)
    return new, out


def _random_init(c: SyncConsts, bits, states):
    shape, device = states[0].shape, states[0].device
    st = {key: x.clone() for key, x in zip(_state_keys(c), states)}
    if not c.mech:
        st["c"], st["s"] = torch.cos(st["eps"]), torch.sin(st["eps"])
    words = None if c.all_const else bits.init_words()
    st["rv"], st["rk"], st["rl"], st["rs"] = wiener_init(c.f, c.rows, c.all_const, words, shape,
                                                         device)
    st["zb"] = torch.zeros(shape, dtype=torch.float32, device=device)
    return st


def _random_step(c: SyncConsts, st, words, t):
    """One random-mode step (``make_fused_sync_rollout``'s ``body``):
    returns the new state dict and ``(action, reward, done, refs)``.
    ``words`` = ``(actions, u1, u2, lengths, sigmas, resets)`` of the bit
    source; with one reference row, ``u1`` and ``u2`` are read at even
    steps only."""
    shape = st["i_sd"].shape
    acts, u1, u2, lens, sigs, resets = words
    acts = [w.reshape(shape) for w in acts]
    if c.finite:
        action = (acts[0] & 7).to(torch.int32)
    else:
        action = tuple(2.0 * uniform_from_bits(w) - 1.0 for w in acts)
    cos, sin = ((torch.cos(st["eps"]), torch.sin(st["eps"])) if c.mech else (st["c"], st["s"]))
    new, out = sync_action_step(c, st, action, cos, sin)
    reference_step(c.f, c.rows, c.all_const, st, new, (u1, u2, lens, sigs, resets), out[2] > 0.5,
                   t)
    return new, out


def _bits(c, seed, states, bits):
    return bits or SyncBits(seed, states[0].numel(), states[0].device, c.n_ref, c.n_act)


def sync_rollout_random_plain(c: SyncConsts, seed, states, n_steps, bits=None):
    """Plain version of ``sync_rollout_random``: ``(*states, reward_sum,
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


def sync_record_random_plain(c: SyncConsts, seed, states, n_steps, bits=None):
    """Plain version of ``sync_record_random``: per step the post-reset
    states, the references the reward was taken against, the action (int32,
    or three float32 duty commands), the reward and the done flag, each
    ``(T, R, 128)``."""
    bits = _bits(c, seed, states, bits)
    st = _random_init(c, bits, states)
    n_sig = c.n_state + c.n_ref + c.n_act + 2
    rec = [[] for _ in range(n_sig)]
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


def record_dtypes(c: SyncConsts):
    """The dtypes of the random recorder's signals, in order."""
    act = torch.int32 if c.finite else torch.float32
    return ((torch.float32,) * (c.n_state + c.n_ref) + (act,) * c.n_act
            + (torch.float32, torch.float32))


def _buffer_action(c, actions, t):
    return actions[t] if c.finite else tuple(actions[t, j] for j in range(3))


def _buffer_step(c, st, action):
    return sync_physics(c, action, torch.cos(st["eps"]), torch.sin(st["eps"]), st)


def sync_rollout_buffer_plain(c: SyncConsts, states, actions):
    """Plain version of ``sync_rollout_buffer``: the final states (exact
    sin/cos of the angle every step, no references, no reset)."""
    st = dict(zip(_state_keys(c), states))
    for t in range(actions.shape[0]):
        st = _buffer_step(c, st, _buffer_action(c, actions, t))
    return tuple(st[key].clone() for key in _state_keys(c))


def sync_record_buffer_plain(c: SyncConsts, states, actions):
    """Plain version of ``sync_record_buffer``: every step's states, each
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
    "sync_rollout_random": [_P, _P, ctypes.c_uint64, _I, _I, _P, _P, _P],
    "sync_rollout_buffer": [_P, _P, _I, _I, _P, _P, _P, _P, _P],
    "sync_record_random": [_P, _P, ctypes.c_uint64, _I, _I, _P, _P, _P],
    "sync_record_buffer": [_P, _P, _I, _I, _P, _P, _P, _P, _P],
}


def _in_ptrs(c, states):
    return _ptrs(((None,) if not c.mech else ()) + tuple(states))


def _out_state(c, outs):
    return ([None] if not c.mech else []) + list(outs)


def _launch(name, device, *args, launches=LAUNCHES):
    lib = family_library("fused_sync", "sync", _ARGTYPES,
                         (len(CONST_NAMES), len(ROW_NAMES), len(FLAG_NAMES)))
    launch_kernel(lib, "sync", name, device, launches, *args)


def sync_rollout_random(c: SyncConsts, seed: int, states, n_steps: int):
    """``(*states, reward_sum, term_count, rv, rk, rl, rs)``."""
    device, R = check_planes(c, states)
    if device.type == "cpu":
        return sync_rollout_random_plain(c, seed, tuple(states), n_steps)
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
    _launch("sync_rollout_random", device, c.host.ctypes.data, c.flags.ctypes.data, _seed(seed),
            n_envs, int(n_steps), _in_ptrs(c, states), _ptrs(_out_state(c, outs)))
    return outs


def sync_rollout_buffer(c: SyncConsts, states, actions):
    """The final states after the action buffer."""
    device, R = check_planes(c, states)
    T = check_b6_actions(c, actions, R, device)
    if device.type == "cpu":
        return sync_rollout_buffer_plain(c, tuple(states), actions)
    outs = [torch.empty((R, LANE), dtype=torch.float32, device=device) for _ in range(c.n_state)]
    act_i, act_f = (actions, None) if c.finite else (None, actions)
    _launch("sync_rollout_buffer", device, c.host.ctypes.data, c.flags.ctypes.data, R * LANE, T,
            _in_ptrs(c, states), None if act_i is None else act_i.data_ptr(),
            None if act_f is None else act_f.data_ptr(), _ptrs(_out_state(c, outs)))
    return tuple(outs)


def sync_record_random(c: SyncConsts, seed: int, states, n_steps: int):
    """``(*states, *refs, *actions, reward, done)``, each ``(T, R, 128)``."""
    device, R = check_planes(c, states)
    if device.type == "cpu":
        return sync_record_random_plain(c, seed, tuple(states), n_steps)
    outs = _record_random_launch(c, seed, states, n_steps, R * LANE, LAUNCHES)
    return tuple(x.view(int(n_steps), R, LANE) for x in outs)


def _record_random_launch(c: SyncConsts, seed: int, states, n_steps: int, n_envs: int,
                          launches=None):
    """sync_record_random's kernel on the first ``n_envs`` envs of the
    planes: the recorded signals, each ``(T, n_envs)``; the launch counted
    in ``launches`` (none: not counted)."""
    outs, args = _record_random_args(c, seed, states, n_steps, n_envs)
    _launch("sync_record_random", states[0].device, *args,
            launches={"sync_record_random": 0} if launches is None else launches)
    return outs


def _record_random_args(c: SyncConsts, seed: int, states, n_steps: int, n_envs: int):
    """The recorder's output tensors, each ``(T, n_envs)``, and its C
    arguments before the stream."""
    outs = [torch.empty((int(n_steps), n_envs), dtype=dt, device=states[0].device)
            for dt in record_dtypes(c)]
    it = iter(outs)
    st = [next(it) for _ in range(c.n_state)]
    refs = [next(it) for _ in range(c.n_ref)]
    acts = [next(it) for _ in range(c.n_act)]
    reward, done = next(it), next(it)
    ptr_list = (_out_state(c, st) + refs + [None] * (2 - c.n_ref)
                + (acts + [None] * 3 if c.finite else [None] + acts) + [reward, done])
    return outs, (c.host.ctypes.data, c.flags.ctypes.data, _seed(seed), n_envs, int(n_steps),
                  _in_ptrs(c, states), _ptrs(ptr_list))


def sync_record_ring_layout(c: SyncConsts):
    """The random recorder's ring for ``c``'s instance (csrc/fused_sync.cu's
    SyncRecordRing, in csrc/ring_pipe.cuh's RingLayout): consumer and
    producer warps, K steps a slot, slots, words a step (finite: the B6
    bits; continuous: the three duties; then four per reference row),
    shared-memory bytes; one thread per env with constant references.
    Computed here, without the library."""
    if c.all_const:
        return named_ring_layout((0,) * 6 + (1,))
    K, P = SYNC_RECORD_RING
    words = c.n_act + 4 * c.n_ref
    return named_ring_layout((4, 4 * P, K, 2, words, 2 * K * words * LANE * 4, 0))


def sync_record_buffer(c: SyncConsts, states, actions):
    """Every step's states, each ``(T, R, 128)``."""
    device, R = check_planes(c, states)
    T = check_b6_actions(c, actions, R, device)
    if device.type == "cpu":
        return sync_record_buffer_plain(c, tuple(states), actions)
    outs = [torch.empty((T, R, LANE), dtype=torch.float32, device=device)
            for _ in range(c.n_state)]
    act_i, act_f = (actions, None) if c.finite else (None, actions)
    _launch("sync_record_buffer", device, c.host.ctypes.data, c.flags.ctypes.data, R * LANE, T,
            _in_ptrs(c, states), None if act_i is None else act_i.data_ptr(),
            None if act_f is None else act_f.data_ptr(), _ptrs(_out_state(c, outs)))
    return tuple(outs)


# ---------------------------------------------------------------------------
# builder (the JAX package's entry point)
# ---------------------------------------------------------------------------


def make_fused_sync_rollout(env, n_steps, n_envs, action_mode="random", randomize=None):
    """Universal fused rollout for the synchronous family: the twelve
    ``{Finite, Cont} x {CC, TC, SC} x {PMSM, SynRM}`` catalog ids.

    * random mode: ``rollout(seed, *state0) -> (*states, reward_sum,
      term_count, rv, rk, rl, rs)``; states = (omega?, i_sd, i_sq, eps),
      ``(n_envs // 128, 128)`` float32 planes, the reference rows
      ``(n_ref * n_envs // 128, 128)``.
    * buffer mode: ``rollout(*state0, actions) -> states`` with an int32
      ``(n_steps, n_envs // 128, 128)`` (finite) or float32 ``(n_steps, 3,
      n_envs // 128, 128)`` (cont) action buffer; deterministic physics
      only.

    The device is that of the inputs."""
    if randomize:
        raise NotImplementedError(
            "domain randomization (randomize=) is not fused yet; it arrives with queue 2, "
            "item 7 of the port")
    if n_envs % LANE:
        raise ValueError(f"n_envs must be a multiple of {LANE}")
    R = n_envs // LANE
    c = SyncConsts(env)
    if action_mode == "random":
        def rollout(seed, *state0):
            check_rollout_inputs(R, n_steps, state0)
            return sync_rollout_random(c, seed, state0, n_steps)
        rollout.consts = c
        return rollout
    if action_mode != "buffer":
        raise ValueError(f"action_mode must be 'random' or 'buffer', got {action_mode!r}")

    def rollout(*args):
        *state0, actions = args
        check_rollout_inputs(R, n_steps, state0, actions)
        return sync_rollout_buffer(c, state0, actions)
    rollout.consts = c
    return rollout


# ---------------------------------------------------------------------------
# the universal policy recorder's view of the family
# ---------------------------------------------------------------------------


def policy_surface(c: SyncConsts, env):
    """What ``ops.fused_policy.make_fused_policy_record_universal`` needs of
    the family (the policy-adapter surface of ``_sync_family``,
    pallas_sync.py:881-892): the observation spec (omega, i_sd and i_sq
    over their limits, the angle as cos/sin), one 8-way head for the B6
    bits or three duties in [-1, 1], and the plain step.  ``aux`` gives the
    step's (cos, sin): the carried rotation at constant speed, of the angle
    under the speed ODE or ``afresh``."""
    ps, names, lim = system_limits(env)
    i_lim, w_lim = float(lim[names.index("i_sd")]), float(lim[names.index("omega")])
    off, i_eps = int(c.mech), c.n_state - 1
    obs_spec = policy_obs_spec(c.mech, w_lim, ps.load.omega_fixed, [
        ("state", off, 1.0 / i_lim), ("state", off + 1, 1.0 / i_lim), ("cos", i_eps),
        ("sin", i_eps)])

    def aux(st, afresh=False):
        if c.mech or afresh:
            return torch.cos(st["eps"]), torch.sin(st["eps"])
        return st["c"], st["s"]

    return SimpleNamespace(
        family="sync", consts=c, obs_spec=obs_spec, act_ns=(8,) if c.finite else None,
        act_range=None if c.finite else (np.full(3, -1.0, _f32), np.ones(3, _f32)),
        state_keys=_state_keys(c), init=lambda bits, states: _random_init(c, bits, states),
        aux=aux, aux_cs=lambda a: a,
        quantities=lambda st, a: [sync_quantity(c, j, st) for j in range(c.n_ref)],
        action=lambda xs: xs[0] if c.finite else tuple(xs),
        step=lambda st, action, a: sync_action_step(c, st, action, *a),
        planes=lambda planes: _out_state(c, planes))
