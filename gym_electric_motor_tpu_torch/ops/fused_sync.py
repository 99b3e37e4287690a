"""Fused Finite-CC-PMSM / SynRM rollouts: the reducing rollout and the
trajectory recorder, each in a random-action and an action-buffer mode.

Counterpart of ``_PmsmCtx``, ``make_fused_pmsm_rollout`` and
``make_fused_pmsm_record_rollout`` in
``gym_electric_motor_tpu/ops/pallas_sync.py``.  Four kernels written in CUDA
(``csrc/fused_pmsm.cu``, over the shared step of ``csrc/pmsm_step.cuh``)
carry the work on the GPU:

==================== ==================================================
``pmsm_rollout_random``  T random-action steps, reduced to the final state,
                         reward sums, termination counts and the final
                         Wiener state (warp-specialised: producer warps
                         draw each step's words into a shared-memory
                         ring, consumer warps step the envs)
``pmsm_rollout_buffer``  T steps of a given action buffer, deterministic
``pmsm_record_random``   the random step, every step recorded (on a ring
                         of its own, as the random rollout)
``pmsm_record_buffer``   the buffer step, every step recorded
==================== ==================================================

and the FOC closed loop of ``make_fused_foc_rollout`` (pallas_sync.py:1124,
site :1339), ``foc_rollout`` (``csrc/fused_foc.cu``): Cont-CC-PMSM under
the tuned PI current controller, over the same physics and references.

Each kernel has a plain PyTorch version here (``*_plain``) with the same
arithmetic in the same order and the same Philox bits.  A wrapper runs the
plain version only for tensors on the CPU; for CUDA tensors it launches
the kernel (and counts the launch in ``LAUNCHES``) or raises.

Public functions keep the JAX builders' layout: state planes are
``(n_envs // 128, 128)`` float32 and per-step arrays ``(T, n_envs // 128,
128)``; the Wiener outputs are ``(2 * n_envs // 128, 128)`` with the i_sd*
rows first.  Inside a kernel the planes are one flat array of N envs.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import cuda_build
from .fused_common import (LANE, RING_LAYOUT_FIELDS, TWO_PI, PhiloxBits, family_library,
                           launch_kernel, named_ring_layout, ptr_array, require, uniform_from_bits)

_f32 = np.float32

# Order of the float constants, the same as PmsmConstIndex in
# csrc/pmsm_step.cuh.
CONST_NAMES = (
    "u_sup", "k_a", "k_b", "k_c", "k_d", "k_e", "k_f", "k_g",
    "half_tau", "tau", "sixth", "d_eps",
    "two_thirds", "inv_sqrt3", "two_pi", "inv_two_pi", "cos_d", "sin_d",
    "inv_i_lim", "w_over_span", "violation_reward", "margin", "ln10", "u_min",
)

KERNELS = ("pmsm_rollout_random", "pmsm_rollout_buffer",
           "pmsm_record_random", "pmsm_record_buffer")
# the controller-in-the-loop kernel (the FOC closed loop, csrc/fused_foc.cu)
CONTROL_KERNELS = ("foc_rollout",)

# launches of each CUDA kernel since the last reset_launches()
LAUNCHES = dict.fromkeys(KERNELS + CONTROL_KERNELS, 0)

# the random rollout's ring (PmsmRing in csrc/fused_pmsm.cu): K steps a
# slot, producer warps per consumer warp; and the words of a step (the
# action code, then four per reference: kPmsmActionWords)
PMSM_RING = (8, 2)
PMSM_RING_WORDS = 9
# the random recorder's ring (PmsmRecordRing in csrc/fused_pmsm.cu), with
# the rollout's 9 words a step
PMSM_RECORD_RING = (8, 2)


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _require_fused_config(env, converter="Finite-B6C"):
    """The kernels bake the catalog defaults of Finite-CC-PMSM/SynRM (the
    FOC kernel those of Cont-CC-PMSM, ``converter="Cont-B6C"``): reject
    what they would silently simulate wrong."""
    ps = env.physical_system
    if ps.motor.kind not in ("PMSM", "SynRM"):
        raise NotImplementedError(f"the PMSM kernels need a PMSM or SynRM, got {ps.motor.kind!r}")
    if ps.supply.kind != "IdealVoltageSupply":
        raise NotImplementedError(
            f"the PMSM kernels support IdealVoltageSupply only; got {ps.supply.kind!r}")
    if ps.load.kind != "ConstantSpeedLoad":
        raise NotImplementedError(
            f"the PMSM kernels support ConstantSpeedLoad only; got {ps.load.kind!r}")
    if ps.converter.kind != converter:
        raise NotImplementedError(
            f"the PMSM kernels need the {converter} bridge; got {ps.converter.kind!r}")
    cm = env.constraint_monitor
    ok = (len(cm.constraints) == 1 and cm.merge_violations == "max"
          and type(cm.constraints[0]).__name__ == "SquaredConstraint"
          and set(cm.constraints[0].states) == {"i_sq", "i_sd"})
    if not ok:
        raise NotImplementedError(
            "the PMSM kernels hard-code the default squared (i_sd, i_sq) "
            "constraint; run other constraint sets on VectorEnv")


class PmsmConsts:
    """The baked constants of one env (``_PmsmCtx``), as float32: ``host``
    is the array handed to the kernels, ``f`` the same values as Python
    floats for the plain versions."""

    def __init__(self, env, converter="Finite-B6C"):
        _require_fused_config(env, converter)
        ps = env.physical_system
        mp = ps.motor.parameter
        names = list(ps.state_names)
        lim = np.asarray(ps.limits)
        r_s, l_d, l_q = float(mp["r_s"]), float(mp["l_d"]), float(mp["l_q"])
        psi_p, p = float(mp.get("psi_p", 0.0)), float(mp["p"])
        omega = float(ps.load.omega_fixed)
        tau = float(ps.tau)
        i_lim = float(lim[names.index("i_sd")])
        p_omega = p * omega
        values = dict(
            u_sup=float(ps.supply.u_nominal),
            k_a=-r_s, k_b=l_q * p_omega, k_c=1.0 / l_d,
            k_d=-psi_p * p_omega, k_e=r_s, k_f=l_d * p_omega, k_g=1.0 / l_q,
            half_tau=0.5 * tau, tau=tau, sixth=tau / 6.0, d_eps=tau * p_omega,
            two_thirds=2.0 / 3.0, inv_sqrt3=1.0 / np.sqrt(3.0),
            two_pi=TWO_PI, inv_two_pi=1.0 / TWO_PI,
            cos_d=np.cos(tau * p_omega), sin_d=np.sin(tau * p_omega),
            inv_i_lim=1.0 / i_lim,
            # WeightedSumOfErrors over the two referenced currents, span 2 each
            w_over_span=0.5 / 2.0,
            violation_reward=-1.0 / (1.0 - 0.9),  # r_min / (1 - gamma)
            # Wiener margins: nominal / limit ratio of the state-space bounds
            margin=float(ps.nominal_state[names.index("i_sd")] / i_lim),
            ln10=np.log(10.0), u_min=1e-12,
        )
        self.host = np.array([_f32(values[n]) for n in CONST_NAMES], dtype=np.float32)
        self.f = {n: float(v) for n, v in zip(CONST_NAMES, self.host)}


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def _rhs(k, i_sd, i_sq, u_d, u_q):
    d_sd = (k["k_a"] * i_sd + k["k_b"] * i_sq + u_d) * k["k_c"]
    d_sq = (k["k_d"] - k["k_e"] * i_sq - k["k_f"] * i_sd + u_q) * k["k_g"]
    return d_sd, d_sq


def pmsm_physics(k, action, c, s, i_sd, i_sq, eps):
    """B6 bridge -> Clarke -> Park at the cycle-start angle (c, s) -> RK4
    on (i_sd, i_sq) -> angle advance and wrap to [0, 2 pi)
    (``_PmsmCtx.physics_step_cs`` plus the callers' wrap)."""
    ua = (((action >> 2) & 1).to(torch.float32) - 0.5) * k["u_sup"]
    ub = (((action >> 1) & 1).to(torch.float32) - 0.5) * k["u_sup"]
    uc = ((action & 1).to(torch.float32) - 0.5) * k["u_sup"]
    return pmsm_physics_abc(k, ua, ub, uc, c, s, i_sd, i_sq, eps)


def pmsm_physics_abc(k, ua, ub, uc, c, s, i_sd, i_sq, eps):
    """``pmsm_physics`` from the three phase voltages on."""
    u_alpha = k["two_thirds"] * (ua - 0.5 * (ub + uc))
    u_beta = k["inv_sqrt3"] * (ub - uc)
    u_d = c * u_alpha + s * u_beta
    u_q = -s * u_alpha + c * u_beta

    h = k["half_tau"]
    k1d, k1q = _rhs(k, i_sd, i_sq, u_d, u_q)
    k2d, k2q = _rhs(k, i_sd + h * k1d, i_sq + h * k1q, u_d, u_q)
    k3d, k3q = _rhs(k, i_sd + h * k2d, i_sq + h * k2q, u_d, u_q)
    k4d, k4q = _rhs(k, i_sd + k["tau"] * k3d, i_sq + k["tau"] * k3q, u_d, u_q)
    i_sd = i_sd + k["sixth"] * (k1d + 2.0 * (k2d + k3d) + k4d)
    i_sq = i_sq + k["sixth"] * (k1q + 2.0 * (k2q + k3q) + k4q)

    eps = eps + k["d_eps"]
    eps = eps - k["two_pi"] * torch.floor(eps * k["inv_two_pi"])
    return i_sd, i_sq, eps


def _wiener_params(k, b_len, b_sig):
    rl = torch.floor(500.0 + 1500.0 * uniform_from_bits(b_len))
    rs = torch.exp(k["ln10"] * (-3.0 + 2.0 * uniform_from_bits(b_sig)))
    return rl, rs


def _random_init(k, words, i_sd0, i_sq0, eps0):
    """Drive state and both Wiener references at step 0 (``pmsm_init``)."""
    v_d, v_q, len_d, len_q, sig_d, sig_q = (w.reshape(i_sd0.shape) for w in words)
    m = k["margin"]
    rl_d, rs_d = _wiener_params(k, len_d, sig_d)
    rl_q, rs_q = _wiener_params(k, len_q, sig_q)
    zero = torch.zeros_like(i_sd0)
    return dict(i_sd=i_sd0.clone(), i_sq=i_sq0.clone(), eps=eps0.clone(),
                c=torch.cos(eps0), s=torch.sin(eps0),
                rv_d=(2.0 * uniform_from_bits(v_d) - 1.0) * m,
                rv_q=(2.0 * uniform_from_bits(v_q) - 1.0) * m,
                rk_d=zero, rk_q=zero.clone(), rl_d=rl_d, rs_d=rs_d, rl_q=rl_q, rs_q=rs_q)


def action_step(k, st, action):
    """One step under ``action`` (``pmsm_action_step``): physics, the
    incremental Park rotation, constraint, reward and the reset of the drive
    state.  Returns the new drive-state dict (the reference entries carried
    over) and ``(action, reward, done, ref_d, ref_q)``."""
    ua = (((action >> 2) & 1).to(torch.float32) - 0.5) * k["u_sup"]
    ub = (((action >> 1) & 1).to(torch.float32) - 0.5) * k["u_sup"]
    uc = ((action & 1).to(torch.float32) - 0.5) * k["u_sup"]
    new, out = voltage_step(k, st, ua, ub, uc)
    return new, (action,) + out


def voltage_step(k, st, ua, ub, uc):
    """``action_step`` under the phase voltages ``ua``, ``ub``, ``uc``
    (``pmsm_voltage_step``); returns the new drive-state dict and
    ``(reward, done, ref_d, ref_q)``."""
    c, s = st["c"], st["s"]
    i_sd, i_sq, eps = pmsm_physics_abc(k, ua, ub, uc, c, s, st["i_sd"], st["i_sq"], st["eps"])
    c_new = c * k["cos_d"] - s * k["sin_d"]
    s_new = s * k["cos_d"] + c * k["sin_d"]
    inv = torch.rsqrt(c_new * c_new + s_new * s_new)
    c_new = c_new * inv
    s_new = s_new * inv

    i_sd_n = i_sd * k["inv_i_lim"]
    i_sq_n = i_sq * k["inv_i_lim"]
    violated = (i_sd_n * i_sd_n + i_sq_n * i_sq_n) > 1.0
    w = k["w_over_span"]
    wse = -(w * torch.abs(i_sd_n - st["rv_d"]) + w * torch.abs(i_sq_n - st["rv_q"]))
    reward = torch.where(violated, torch.full_like(wse, k["violation_reward"]), wse)
    done = violated.to(torch.float32)
    out = (reward, done, st["rv_d"], st["rv_q"])

    zero = torch.zeros_like(i_sd)
    new = dict(st)
    new.update(i_sd=torch.where(violated, zero, i_sd), i_sq=torch.where(violated, zero, i_sq),
               eps=torch.where(violated, zero, eps),
               c=torch.where(violated, torch.ones_like(c_new), c_new),
               s=torch.where(violated, zero, s_new))
    return new, out


def wiener_advance(k, st, violated, draws, params, resets):
    """Advance both references in ``st`` in place (``wiener_advance``):
    ``draws``, ``params`` and ``resets`` map ``"d"``/``"q"`` to the normal
    draw, the (length, sigma) words and the reset-value word."""
    m = k["margin"]
    for x in ("d", "q"):
        rk, rl, rs = st["rk_" + x], st["rl_" + x], st["rs_" + x]
        regen = (rk >= rl) | violated
        new_len, new_sig = _wiener_params(k, *params[x])
        rl = torch.where(regen, new_len, rl)
        rs = torch.where(regen, new_sig, rs)
        rk = torch.where(regen, torch.zeros_like(rk), rk) + 1.0
        value = torch.clamp(st["rv_" + x] + rs * draws[x], -m, m)
        reset_value = (2.0 * uniform_from_bits(resets[x]) - 1.0) * m
        st.update({"rv_" + x: torch.where(violated, reset_value, value),
                   "rk_" + x: rk, "rl_" + x: rl, "rs_" + x: rs})


def wiener_advance_pair(k, st, violated, w_u1, w_u2, len_d, len_q, sig_d, sig_q, rst_d, rst_q):
    """The random step's Wiener advance: one Box-Muller pair from the
    step's words feeds both references."""
    u1 = uniform_from_bits(w_u1)
    u2 = uniform_from_bits(w_u2)
    rad = torch.sqrt(-2.0 * torch.log(torch.clamp(u1, min=k["u_min"])))
    theta = k["two_pi"] * u2
    wiener_advance(k, st, violated, {"d": rad * torch.cos(theta), "q": rad * torch.sin(theta)},
                   {"d": (len_d, sig_d), "q": (len_q, sig_q)}, {"d": rst_d, "q": rst_q})


def _random_step(k, words, st):
    """One random-mode step (``pmsm_random_step``): returns the new state
    dict and ``(action, reward, done, ref_d, ref_q)``."""
    words = [w.reshape(st["i_sd"].shape) for w in words]
    new, out = action_step(k, st, (words[0] & 7).to(torch.int32))
    wiener_advance_pair(k, new, out[2] > 0.5, *words[1:])
    return new, out


def pmsm_rollout_random_plain(consts, seed, i_sd0, i_sq0, eps0, n_steps, bits=None):
    """Plain version of ``pmsm_rollout_random``.  ``bits`` replaces the
    Philox bit source (an object with ``init_words()`` and
    ``step_words(t)``, see ``fused_common.PhiloxBits``)."""
    k = consts.f
    bits = bits or PhiloxBits(seed, i_sd0.numel(), i_sd0.device)
    st = _random_init(k, bits.init_words(), i_sd0, i_sq0, eps0)
    reward = torch.zeros_like(i_sd0)
    terms = torch.zeros_like(i_sd0)
    for t in range(n_steps):
        st, (_a, r, done, _rd, _rq) = _random_step(k, bits.step_words(t), st)
        reward = reward + r
        terms = terms + done
    return (st["i_sd"], st["i_sq"], st["eps"], reward, terms,
            torch.cat([st["rv_d"], st["rv_q"]]), torch.cat([st["rk_d"], st["rk_q"]]),
            torch.cat([st["rl_d"], st["rl_q"]]), torch.cat([st["rs_d"], st["rs_q"]]))


def pmsm_record_random_plain(consts, seed, i_sd0, i_sq0, eps0, n_steps, bits=None):
    """Plain version of ``pmsm_record_random``: per step the post-reset
    (i_sd, i_sq, eps), the references the reward was taken against, the
    action, the reward and the done flag."""
    k = consts.f
    bits = bits or PhiloxBits(seed, i_sd0.numel(), i_sd0.device)
    st = _random_init(k, bits.init_words(), i_sd0, i_sq0, eps0)
    rec = [[] for _ in range(8)]
    for t in range(n_steps):
        st, (a, r, done, ref_d, ref_q) = _random_step(k, bits.step_words(t), st)
        for lst, x in zip(rec, (st["i_sd"], st["i_sq"], st["eps"], ref_d, ref_q, a, r, done)):
            lst.append(x)
    if n_steps == 0:
        shape = (0,) + tuple(i_sd0.shape)
        return tuple(torch.empty(shape, dtype=torch.int32 if j == 5 else torch.float32,
                                 device=i_sd0.device) for j in range(8))
    return tuple(torch.stack(lst) for lst in rec)


def pmsm_rollout_buffer_plain(consts, i_sd0, i_sq0, eps0, actions):
    """Plain version of ``pmsm_rollout_buffer`` (exact sin/cos of the
    angle every step, no references, no reset)."""
    k = consts.f
    i_sd, i_sq, eps = i_sd0, i_sq0, eps0
    for t in range(actions.shape[0]):
        i_sd, i_sq, eps = pmsm_physics(k, actions[t], torch.cos(eps), torch.sin(eps),
                                       i_sd, i_sq, eps)
    zero = torch.zeros_like(i_sd0)
    return i_sd.clone(), i_sq.clone(), eps.clone(), zero, zero.clone()


def pmsm_record_buffer_plain(consts, i_sd0, i_sq0, eps0, actions):
    """Plain version of ``pmsm_record_buffer``."""
    k = consts.f
    i_sd, i_sq, eps = i_sd0, i_sq0, eps0
    out = torch.empty((3,) + tuple(actions.shape), dtype=torch.float32, device=i_sd0.device)
    for t in range(actions.shape[0]):
        i_sd, i_sq, eps = pmsm_physics(k, actions[t], torch.cos(eps), torch.sin(eps),
                                       i_sd, i_sq, eps)
        out[0, t], out[1, t], out[2, t] = i_sd, i_sq, eps
    return out[0], out[1], out[2]


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    "pmsm_rollout_random": [_P, ctypes.c_uint64, _I, _I] + [_P] * 12 + [_P],
    "pmsm_rollout_buffer": [_P, _I, _I] + [_P] * 9 + [_P],
    "pmsm_record_random": [_P, ctypes.c_uint64, _I, _I] + [_P] * 11 + [_P],
    "pmsm_record_buffer": [_P, _I, _I] + [_P] * 7 + [_P],
}


def _lib():
    lib = cuda_build.load("fused_pmsm")
    if not getattr(lib, "_gemx_typed", False):
        for name, argtypes in _ARGTYPES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.pmsm_n_const.restype = ctypes.c_int
        lib.gemx_error_string.argtypes = [ctypes.c_int]
        lib.gemx_error_string.restype = ctypes.c_char_p
        if lib.pmsm_n_const() != len(CONST_NAMES):
            raise RuntimeError("csrc/pmsm_step.cuh and CONST_NAMES disagree on the constants")
        lib._gemx_typed = True
    return lib


def _check(name, x, shape, dtype, device):
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(x).__name__}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, the other inputs on {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _planes(i_sd0, i_sq0, eps0):
    """Validate the three state planes; returns (device, R)."""
    if not isinstance(i_sd0, torch.Tensor) or i_sd0.dim() != 2 or i_sd0.shape[1] != LANE \
            or i_sd0.shape[0] < 1:
        raise ValueError(f"state planes must be (n_envs // {LANE}, {LANE}) tensors")
    device = i_sd0.device
    for nm, x in (("i_sd0", i_sd0), ("i_sq0", i_sq0), ("eps0", eps0)):
        _check(nm, x, i_sd0.shape, torch.float32, device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return device, i_sd0.shape[0]


def _launch(name, device, *args, launches=LAUNCHES):
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: {lib.gemx_error_string(rc).decode()}")
    launches[name] += 1


def _ptrs(*xs):
    return [x.data_ptr() for x in xs]


def pmsm_rollout_random(consts: PmsmConsts, seed: int, i_sd0, i_sq0, eps0, n_steps: int):
    """``(i_sd, i_sq, eps, reward_sum, term_count, rv, rk, rl, rs)``."""
    device, R = _planes(i_sd0, i_sq0, eps0)
    if device.type == "cpu":
        return pmsm_rollout_random_plain(consts, seed, i_sd0, i_sq0, eps0, n_steps)
    outs = _pmsm_random_launch(consts, seed, (i_sd0, i_sq0, eps0), n_steps, R * LANE, LAUNCHES)
    return tuple(x.view(-1, LANE) for x in outs)


def _pmsm_random_launch(consts: PmsmConsts, seed: int, planes, n_steps: int, n_envs: int,
                        launches=None):
    """pmsm_rollout_random's kernel on the first ``n_envs`` envs of the
    planes ``(i_sd0, i_sq0, eps0)``: its 9 outputs, five ``(n_envs,)`` and
    the four Wiener planes ``(2 n_envs,)`` (the d envs first); the launch
    counted in ``launches`` (none: not counted)."""
    device = planes[0].device
    outs = [torch.empty(((1 if j < 5 else 2) * n_envs,), dtype=torch.float32, device=device)
            for j in range(9)]
    _launch("pmsm_rollout_random", device, consts.host.ctypes.data,
            int(seed) & 0xFFFFFFFFFFFFFFFF, n_envs, int(n_steps), *_ptrs(*planes, *outs),
            launches={"pmsm_rollout_random": 0} if launches is None else launches)
    return outs


def _pmsm_ring_layout(shape):
    K, P = shape
    return named_ring_layout((4, 4 * P, K, 2, PMSM_RING_WORDS,
                              2 * K * PMSM_RING_WORDS * 128 * 4, 0))


def pmsm_ring_layout():
    """The random rollout's ring (csrc/fused_pmsm.cu's PmsmRing, in
    csrc/ring_pipe.cuh's RingLayout): consumer and producer warps, K steps a
    slot, slots, words a step, shared-memory bytes; computed here, without
    the library."""
    return _pmsm_ring_layout(PMSM_RING)


def pmsm_record_ring_layout():
    """The random recorder's ring (csrc/fused_pmsm.cu's PmsmRecordRing),
    as ``pmsm_ring_layout``."""
    return _pmsm_ring_layout(PMSM_RECORD_RING)


def pmsm_rollout_buffer(consts: PmsmConsts, i_sd0, i_sq0, eps0, actions):
    """``(i_sd, i_sq, eps, reward_sum, term_count)``; reward and terms are
    zero (no references, no reset in buffer mode)."""
    device, R = _planes(i_sd0, i_sq0, eps0)
    _check("actions", actions, (actions.shape[0], R, LANE), torch.int32, device)
    if device.type == "cpu":
        return pmsm_rollout_buffer_plain(consts, i_sd0, i_sq0, eps0, actions)
    outs = [torch.empty((R, LANE), dtype=torch.float32, device=device) for _ in range(5)]
    _launch("pmsm_rollout_buffer", device, consts.host.ctypes.data, R * LANE,
            int(actions.shape[0]), *_ptrs(i_sd0, i_sq0, eps0, actions, *outs))
    return tuple(outs)


def pmsm_record_random(consts: PmsmConsts, seed: int, i_sd0, i_sq0, eps0, n_steps: int):
    """``(i_sd, i_sq, eps, ref_d, ref_q, action, reward, done)``, each
    ``(T, R, 128)`` (action int32)."""
    device, R = _planes(i_sd0, i_sq0, eps0)
    if device.type == "cpu":
        return pmsm_record_random_plain(consts, seed, i_sd0, i_sq0, eps0, n_steps)
    outs = _pmsm_record_random_launch(consts, seed, (i_sd0, i_sq0, eps0), n_steps, R * LANE,
                                      LAUNCHES)
    return tuple(x.view(int(n_steps), R, LANE) for x in outs)


def _pmsm_record_random_launch(consts: PmsmConsts, seed: int, planes, n_steps: int,
                               n_envs: int, launches=None):
    """pmsm_record_random's kernel on the first ``n_envs`` envs of the
    planes ``(i_sd0, i_sq0, eps0)``: its 8 outputs, each ``(T, n_envs)``
    (the action int32); the launch counted in ``launches`` (none: not
    counted)."""
    device = planes[0].device
    outs = [torch.empty((int(n_steps), n_envs), dtype=torch.int32 if j == 5 else torch.float32,
                        device=device) for j in range(8)]
    _launch("pmsm_record_random", device, consts.host.ctypes.data,
            int(seed) & 0xFFFFFFFFFFFFFFFF, n_envs, int(n_steps), *_ptrs(*planes, *outs),
            launches={"pmsm_record_random": 0} if launches is None else launches)
    return outs


def pmsm_record_buffer(consts: PmsmConsts, i_sd0, i_sq0, eps0, actions):
    """``(i_sd, i_sq, eps)``, each ``(T, R, 128)``."""
    device, R = _planes(i_sd0, i_sq0, eps0)
    _check("actions", actions, (actions.shape[0], R, LANE), torch.int32, device)
    if device.type == "cpu":
        return pmsm_record_buffer_plain(consts, i_sd0, i_sq0, eps0, actions)
    outs = [torch.empty(tuple(actions.shape), dtype=torch.float32, device=device)
            for _ in range(3)]
    _launch("pmsm_record_buffer", device, consts.host.ctypes.data, R * LANE,
            int(actions.shape[0]), *_ptrs(i_sd0, i_sq0, eps0, actions, *outs))
    return tuple(outs)


# ---------------------------------------------------------------------------
# builders (the JAX package's entry points)
# ---------------------------------------------------------------------------


def make_fused_pmsm_rollout(env, n_steps, n_envs, action_mode="random"):
    """Fused rollout of a Finite-CC-PMSM-v0 (or Finite-CC-SynRM-v0) env.

    Returns ``rollout(seed, i_sd0, i_sq0, eps0) -> (i_sd, i_sq, eps,
    reward_sum, term_count, rv, rk, rl, rs)`` with ``(n_envs // 128, 128)``
    float32 planes and ``(2 * n_envs // 128, 128)`` Wiener planes.  With
    ``action_mode='buffer'`` the rollout is ``rollout(i_sd0, i_sq0, eps0,
    actions) -> (i_sd, i_sq, eps, reward_sum, term_count)`` for an int32
    ``(n_steps, n_envs // 128, 128)`` action buffer, with no reference noise
    and no reset.  The device is that of the inputs."""
    if n_envs % LANE:
        raise ValueError(f"n_envs must be a multiple of {LANE}")
    R = n_envs // LANE
    consts = PmsmConsts(env)
    if action_mode == "random":
        def rollout(seed, i_sd0, i_sq0, eps0):
            _check("i_sd0", i_sd0, (R, LANE), torch.float32, i_sd0.device)
            return pmsm_rollout_random(consts, seed, i_sd0, i_sq0, eps0, n_steps)
        return rollout
    if action_mode != "buffer":
        raise ValueError(f"action_mode must be 'random' or 'buffer', got {action_mode!r}")

    def rollout(i_sd0, i_sq0, eps0, actions):
        _check("i_sd0", i_sd0, (R, LANE), torch.float32, i_sd0.device)
        _check("actions", actions, (n_steps, R, LANE), torch.int32, i_sd0.device)
        return pmsm_rollout_buffer(consts, i_sd0, i_sq0, eps0, actions)
    return rollout


def make_fused_pmsm_record_rollout(env, n_steps, n_envs, action_mode="random"):
    """Fused rollout that records every step.

    ``action_mode='random'``: ``rollout(seed, i_sd0, i_sq0, eps0) -> (i_sd,
    i_sq, eps, ref_d, ref_q, action, reward, done)``, each ``(n_steps,
    n_envs // 128, 128)`` (``action`` int32).  ``i_sd``/``i_sq``/``eps`` are
    the post-step, post-reset values; ``ref_d``/``ref_q`` the references
    the step's reward was taken against.  With the same seed the steps are
    those of ``make_fused_pmsm_rollout``'s random mode.

    ``action_mode='buffer'``: ``rollout(i_sd0, i_sq0, eps0, actions) ->
    (i_sd, i_sq, eps)`` per step, deterministic physics only."""
    if n_envs % LANE:
        raise ValueError(f"n_envs must be a multiple of {LANE}")
    R = n_envs // LANE
    consts = PmsmConsts(env)
    if action_mode == "random":
        def rollout(seed, i_sd0, i_sq0, eps0):
            _check("i_sd0", i_sd0, (R, LANE), torch.float32, i_sd0.device)
            return pmsm_record_random(consts, seed, i_sd0, i_sq0, eps0, n_steps)
        return rollout
    if action_mode != "buffer":
        raise ValueError(f"action_mode must be 'random' or 'buffer', got {action_mode!r}")

    def rollout(i_sd0, i_sq0, eps0, actions):
        _check("i_sd0", i_sd0, (R, LANE), torch.float32, i_sd0.device)
        _check("actions", actions, (n_steps, R, LANE), torch.int32, i_sd0.device)
        return pmsm_record_buffer(consts, i_sd0, i_sq0, eps0, actions)
    return rollout


# ---------------------------------------------------------------------------
# the FOC closed loop: Cont-CC-PMSM under the tuned PI current controller
# ---------------------------------------------------------------------------

# Order of the controller's float constants, the same as FocIndex in
# csrc/control_laws.cuh; the physics takes CONST_NAMES (PmsmConstIndex).
FOC_CONST_NAMES = (
    "cc_p_d", "cc_p_q", "cc_i_d", "cc_i_q", "inv_clip_d", "inv_clip_q",
    "l_emf_d", "l_emf_q", "psi_emf_d", "psi_emf_q", "omega_el", "ref_lim_d", "ref_lim_q",
    "inv_out", "u_half", "cos_a", "sin_a", "half_sqrt3", "tau",
)

class FocConsts:
    """The baked constants of the FOC closed loop (``make_fused_foc_rollout``,
    pallas_sync.py:1142-1177): ``pm`` the PMSM physics of a Cont-CC-PMSM env
    (``PmsmConsts`` over the continuous B6 bridge), ``host`` the tuned
    controller's constants in ``FOC_CONST_NAMES`` order as float32 and
    ``f`` the same as Python floats.  Each constant is rounded as the JAX
    kernel rounds it: a gain, limit or flux once to float32; ``1 / out_lim``,
    ``omega p`` and ``u_sup / 2`` in double first; the voltage clip's
    division by its limit as XLA compiles it, a product with the float32
    reciprocal of the float32 limit."""

    def __init__(self, env, ctrl, ref_mode="wiener"):
        if ref_mode not in ("wiener", "const"):
            raise ValueError(f"ref_mode must be 'wiener' or 'const', got {ref_mode!r}")
        require(ctrl.control_task == "CC" and ctrl.output_kind == "cont",
                 "the FOC kernel takes the current controller of a continuous converter")
        self.pm = PmsmConsts(env, converter="Cont-B6C")
        self.wiener = ref_mode == "wiener"
        ps = env.physical_system
        omega, tau = float(ps.load.omega_fixed), float(ps.tau)
        cc_p_d, cc_p_q = (float(x) for x in ctrl.cc_p_gain)
        cc_i_d, cc_i_q = (float(x) for x in ctrl.cc_i_gain)
        clip_d, clip_q = (float(x) for x in np.asarray(ctrl.cc_clip_limits))
        l_emf_d, l_emf_q = (float(x) for x in ctrl.l_emf)
        psi_emf_d, psi_emf_q = (float(x) for x in ctrl.psi_emf)
        ref_lim_d, ref_lim_q = (float(x) for x in ctrl.ref_limits)
        out_lim = float(np.asarray(ctrl.output_limits)[0])
        # the advance angle takes the mechanical omega (controller.py:452-454)
        adv_dt = float(ctrl.advance_factor) * tau * omega
        values = dict(
            cc_p_d=cc_p_d, cc_p_q=cc_p_q, cc_i_d=cc_i_d, cc_i_q=cc_i_q,
            inv_clip_d=_f32(1.0) / _f32(clip_d), inv_clip_q=_f32(1.0) / _f32(clip_q),
            l_emf_d=l_emf_d, l_emf_q=l_emf_q, psi_emf_d=psi_emf_d, psi_emf_q=psi_emf_q,
            omega_el=omega * float(ctrl.pole_pairs), ref_lim_d=ref_lim_d, ref_lim_q=ref_lim_q,
            inv_out=1.0 / out_lim, u_half=0.5 * float(ps.supply.u_nominal),
            cos_a=np.cos(adv_dt), sin_a=np.sin(adv_dt), half_sqrt3=np.sqrt(3.0) / 2.0, tau=tau,
        )
        self.host = np.array([_f32(values[n]) for n in FOC_CONST_NAMES], dtype=np.float32)
        self.f = {n: float(v) for n, v in zip(FOC_CONST_NAMES, self.host)}


def foc_cycle(q, i_sd, i_sq, ce, se, integ_d, integ_q, ref_d_n, ref_q_n):
    """One FOC control cycle (``_cycle``'s controller half, pallas_sync.py:
    1186-1221): PI current control on the denormalised references, the EMF
    decoupling (the d voltage takes i_sq, the q voltage i_sd), the squared
    voltage clip's anti-windup, the dq -> abc transform of the *unclipped*
    voltage at the cycle-start rotation (ce, se) turned by the constant
    advance angle, and the continuous output stage with the converter's
    clip.  Returns the phase voltages and the two integrators."""
    err_d = ref_d_n * q["ref_lim_d"] - i_sd
    err_q = ref_q_n * q["ref_lim_q"] - i_sq
    u_d = q["cc_p_d"] * err_d + q["cc_i_d"] * integ_d
    u_q = q["cc_p_q"] * err_q + q["cc_i_q"] * integ_q
    u_d = u_d + (q["l_emf_d"] * i_sq + q["psi_emf_d"]) * q["omega_el"]
    u_q = u_q + (q["l_emf_q"] * i_sd + q["psi_emf_q"]) * q["omega_el"]
    rel_d = u_d * q["inv_clip_d"]
    rel_q = u_q * q["inv_clip_q"]
    not_clipped = ((rel_d * rel_d + rel_q * rel_q) < 1.0).to(torch.float32)
    integ_d = integ_d + q["tau"] * err_d * not_clipped
    integ_q = integ_q + q["tau"] * err_q * not_clipped
    c = ce * q["cos_a"] - se * q["sin_a"]
    s = se * q["cos_a"] + ce * q["sin_a"]
    u_al = c * u_d - s * u_q
    u_be = s * u_d + c * u_q
    ub = -0.5 * u_al + q["half_sqrt3"] * u_be
    uc = -0.5 * u_al - q["half_sqrt3"] * u_be
    phases = [torch.clamp(u * q["inv_out"], -1.0, 1.0) * q["u_half"] for u in (u_al, ub, uc)]
    return (*phases, integ_d, integ_q)


def foc_rollout_plain(fc: FocConsts, seed, i_sd0, i_sq0, eps0, ref_d, ref_q, n_steps, bits=None):
    """Plain version of ``foc_rollout``: ``(i_sd, i_sq, eps, reward_sum,
    term_count, rv, rk, rl, rs)``, the reference planes ``(2R, 128)`` with
    the d rows first.  Wiener mode draws the references as
    ``pmsm_rollout_random`` does (``bits`` replaces its Philox source; the
    step's action word is unused); const mode holds them at ``ref_d`` and
    ``ref_q``.  The integrators start at zero and persist across env
    resets, as ``control_environment`` carries the controller state."""
    k, q = fc.pm.f, fc.f
    zero = torch.zeros_like(i_sd0)
    if fc.wiener:
        bits = bits or PhiloxBits(seed, i_sd0.numel(), i_sd0.device)
        st = _random_init(k, bits.init_words(), i_sd0, i_sq0, eps0)
    else:
        st = dict(i_sd=i_sd0.clone(), i_sq=i_sq0.clone(), eps=eps0.clone(),
                  c=torch.cos(eps0), s=torch.sin(eps0), rv_d=ref_d.clone(), rv_q=ref_q.clone(),
                  rk_d=zero, rk_q=zero.clone(), rl_d=torch.full_like(zero, 1e9),
                  rl_q=torch.full_like(zero, 1e9), rs_d=zero.clone(), rs_q=zero.clone())
    integ_d, integ_q = zero.clone(), zero.clone()
    reward, terms = zero.clone(), zero.clone()
    for t in range(n_steps):
        ua, ub, uc, integ_d, integ_q = foc_cycle(q, st["i_sd"], st["i_sq"], st["c"], st["s"],
                                                 integ_d, integ_q, st["rv_d"], st["rv_q"])
        new, (r, done, _rd, _rq) = voltage_step(k, st, ua, ub, uc)
        if fc.wiener:
            words = [w.reshape(zero.shape) for w in bits.step_words(t)[1:]]
            wiener_advance_pair(k, new, done > 0.5, *words)
        st = new
        reward = reward + r
        terms = terms + done
    return (st["i_sd"], st["i_sq"], st["eps"], reward, terms,
            torch.cat([st["rv_d"], st["rv_q"]]), torch.cat([st["rk_d"], st["rk_q"]]),
            torch.cat([st["rl_d"], st["rl_q"]]), torch.cat([st["rs_d"], st["rs_q"]]))


_CONTROL_ARGTYPES = {
    "foc_rollout": [_P, _P, ctypes.c_uint64, _I, _I, _P, _P, _P],
}


def _foc_library():
    return family_library("fused_foc", "foc", _CONTROL_ARGTYPES,
                          (len(CONST_NAMES), 0, 1, len(FOC_CONST_NAMES)))


def _foc_flags(fc: FocConsts):
    return np.array([int(fc.wiener)], dtype=np.int32)


def foc_rollout(fc: FocConsts, seed: int, i_sd0, i_sq0, eps0, ref_d, ref_q, n_steps: int):
    """``(i_sd, i_sq, eps, reward_sum, term_count, rv, rk, rl, rs)`` of
    ``n_steps`` closed-loop FOC steps: the plain version for CPU tensors,
    the kernel of ``csrc/fused_foc.cu`` for CUDA ones."""
    device, R = _planes(i_sd0, i_sq0, eps0)
    _check("ref_d", ref_d, (R, LANE), torch.float32, device)
    _check("ref_q", ref_q, (R, LANE), torch.float32, device)
    if device.type == "cpu":
        return foc_rollout_plain(fc, seed, i_sd0, i_sq0, eps0, ref_d, ref_q, n_steps)
    outs = _foc_launch(fc, seed, (i_sd0, i_sq0, eps0, ref_d, ref_q), n_steps, R * LANE, LAUNCHES)
    return tuple(x.view(-1, LANE) for x in outs)


def _foc_launch(fc: FocConsts, seed: int, planes, n_steps: int, n_envs: int, launches=None):
    """foc_rollout's kernel on the first ``n_envs`` envs of ``planes``
    (``i_sd0, i_sq0, eps0, ref_d, ref_q``): its outputs, five ``(n_envs,)``
    and four ``(2 n_envs,)`` (the d rows' envs, then the q rows'); the launch
    counted in ``launches`` (none: not counted)."""
    device = planes[0].device
    outs = [torch.empty((n_envs if j < 5 else 2 * n_envs,), dtype=torch.float32, device=device)
            for j in range(9)]
    flags = _foc_flags(fc)
    launch_kernel(_foc_library(), "foc", "foc_rollout", device,
                  {"foc_rollout": 0} if launches is None else launches, fc.pm.host.ctypes.data,
                  flags.ctypes.data, fc.host.ctypes.data, int(seed) & 0xFFFFFFFFFFFFFFFF,
                  n_envs, int(n_steps), ptr_array(planes), ptr_array(outs))
    return outs


def foc_ring_layout(fc: FocConsts):
    """The loop's design for ``fc``'s references (csrc/fused_foc.cu;
    csrc/ring_pipe.cuh's RingLayout): with Wiener references the ring
    (consumer and producer warps, K steps a slot, slots, words a step,
    shared-memory bytes); with constant ones one thread per env."""
    lib = _foc_library()
    lib.foc_ring_layout.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    flags = _foc_flags(fc)
    out = (ctypes.c_int * len(RING_LAYOUT_FIELDS))()
    lib.foc_ring_layout(flags.ctypes.data, out)
    return named_ring_layout(out)


def make_fused_foc_rollout(env, ctrl, n_steps, n_envs, ref_mode="wiener"):
    """Fused closed-loop FOC rollout of a Cont-CC-PMSM-v0 env
    (``make_fused_foc_rollout``, pallas_sync.py:1124): the whole control
    cycle of the tuned PI current controller (``ctrl``, from
    ``GemController.make(env, "Cont-CC-PMSM-v0")``) fused with the PMSM
    physics, the Wiener current references, the WSE reward, the squared
    constraint and the in-kernel reset.

    Returns ``rollout(seed, i_sd0, i_sq0, eps0, ref_d=None, ref_q=None) ->
    (i_sd, i_sq, eps, reward_sum, term_count, rv, rk, rl, rs)`` with
    ``(n_envs // 128, 128)`` float32 planes and ``(2 * n_envs // 128,
    128)`` reference planes.  ``ref_mode='const'`` holds the normalised
    references at the ``ref_d`` and ``ref_q`` planes (zeros if omitted):
    the closed loop is then deterministic and follows
    ``ctrl.control_environment``.  The device is that of the inputs."""
    if n_envs % LANE:
        raise ValueError(f"n_envs must be a multiple of {LANE}")
    R = n_envs // LANE
    fc = FocConsts(env, ctrl, ref_mode)

    def rollout(seed, i_sd0, i_sq0, eps0, ref_d=None, ref_q=None):
        _check("i_sd0", i_sd0, (R, LANE), torch.float32, i_sd0.device)
        z = torch.zeros((R, LANE), dtype=torch.float32, device=i_sd0.device)
        return foc_rollout(fc, seed, i_sd0, i_sq0, eps0, z if ref_d is None else ref_d,
                           z if ref_q is None else ref_q, n_steps)
    rollout.consts = fc
    return rollout
