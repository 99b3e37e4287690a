"""DC, synchronous, induction and switched reluctance motor models
(counterpart of ``gym_electric_motor_tpu/models/motors.py``).

A *spec* (host side) carries default parameters, the completed limit and
nominal dicts and the initial-state description; the *functions*
``ode(mp, state, u_in, omega)``, ``torque(mp, state)`` and ``i_in(mp,
state)`` work on batched tensors with a leading env dimension: ``state`` is
the motor's ODE state (``(N, 1)`` = (i,) or ``(N, 2)`` = (i_a, i_e) for the
DC motors, ``(N, 3)`` = (i_sd, i_sq, epsilon) for the PMSM and SynRM,
``(N, 4)`` = (i_sd, i_sq, i_e, epsilon) for the EESM, ``(N, 5)`` =
(i_salpha, i_sbeta, psi_ralpha, psi_rbeta, epsilon) for the SCIM and the
DFIM, ``(N, 4)`` = (i_a, i_b, i_c, epsilon) for the SRM), ``u_in`` the ``(N, n_u)`` input voltages (the pair of stator and
rotor alpha/beta voltages for the induction ODE) and ``omega`` is
``(N,)``.

``mp`` holds every parameter as a Python float rounded to float32, and the
products of parameters are formed in float32 with numpy before they meet a
tensor, so each operation rounds where the JAX package's does.  The DC
Jacobians of the JAX package serve only its implicit solvers, which this
package does not port yet (``make_integrator`` raises for them), so they
are left out.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from ..utils.params import update_parameter_dict

_f32 = np.float32


@dataclasses.dataclass
class MotorSpec:
    """Host-side description of a configured motor instance."""

    kind: str
    ode_states: tuple  # the motor part of the integrated state vector
    currents: tuple
    voltages: tuple
    parameter: dict
    limits: dict
    nominal: dict
    initializer: dict  # {'states': {...}, 'interval', 'random_init', 'random_params'}
    ode: Callable = None
    torque: Callable = None
    i_in: Callable = None
    initial_limits: dict = None  # the induction motors' (electric_motor.py:199-213)

    @property
    def n_ode(self) -> int:
        return len(self.ode_states)

    def mp(self) -> dict:
        """Parameters as float32-valued numpy scalars."""
        return {k: _f32(v) for k, v in self.parameter.items()}


def _complete(limits, nominal, limits_agenda, nominal_agenda=None):
    """``ElectricMotor._update_limits`` (electric_motor.py:297-317 of the
    reference): unspecified (0-valued) limits take the physical maxima and
    missing nominal values default to the limits."""
    nominal_agenda = nominal_agenda or {}
    for qty, lim in limits_agenda.items():
        if limits.get(qty, 0) == 0:
            limits[qty] = lim
    for entry in list(limits.keys()):
        if nominal.get(entry, 0) == 0:
            nominal[entry] = nominal_agenda.get(entry, limits[entry])
    return limits, nominal


# ---------------------------------------------------------------------------
# DC motors (dc_*_motor.py of the reference)
# ---------------------------------------------------------------------------

_DC_DEFAULT_NOMINAL = dict(omega=300.0, torque=16.0, i=97.0, i_a=97.0, i_e=97.0, u=60.0,
                           u_a=60.0, u_e=60.0)
_DC_DEFAULT_LIMITS = dict(omega=400.0, torque=38.0, i=210.0, i_a=210.0, i_e=210.0, u=60.0,
                          u_a=60.0, u_e=60.0)


def permex_dc_ode(mp, state, u_in, omega):
    """d i / dt (dc_permanently_excited_motor.py:71-84 of the reference)."""
    i = state[..., 0]
    di = (float(-mp["psi_e"]) * omega - float(mp["r_a"]) * i + u_in[..., 0]) / float(mp["l_a"])
    return di[..., None]


def permex_dc_torque(mp, state):
    return float(mp["psi_e"]) * state[..., 0]


def series_dc_ode(mp, state, u_in, omega):
    """dc_series_motor.py:68-83 of the reference."""
    i = state[..., 0]
    di = (float(-(mp["r_a"] + mp["r_e"])) * i - float(mp["l_e_prime"]) * omega * i
          + u_in[..., 0]) / float(mp["l_a"] + mp["l_e"])
    return di[..., None]


def series_dc_torque(mp, state):
    return float(mp["l_e_prime"]) * state[..., 0] * state[..., 0]


def _two_current_ode(mp, i_a, i_e, u_a, u_e, omega):
    """Armature and excitation circuits (dc_motor.py:96-127 of the
    reference)."""
    di_a = (float(-mp["r_a"]) * i_a - float(mp["l_e_prime"]) * omega * i_e + u_a) / float(mp["l_a"])
    di_e = (float(-mp["r_e"]) * i_e + u_e) / float(mp["l_e"])
    return torch.stack([di_a, di_e], dim=-1)


def extex_dc_ode(mp, state, u_in, omega):
    return _two_current_ode(mp, state[..., 0], state[..., 1], u_in[..., 0], u_in[..., 1], omega)


def shunt_dc_ode(mp, state, u_in, omega):
    """Both circuits see the one input voltage (dc_shunt_motor.py:72-74)."""
    return _two_current_ode(mp, state[..., 0], state[..., 1], u_in[..., 0], u_in[..., 0], omega)


def extex_dc_torque(mp, state):
    return float(mp["l_e_prime"]) * state[..., 0] * state[..., 1]


def _dc_spec(kind, defaults, currents, voltages, ode, torque, i_in, motor_parameter=None,
             nominal_values=None, limit_values=None, motor_initializer=None):
    parameter = update_parameter_dict(defaults, motor_parameter or {})
    limits = dict(_DC_DEFAULT_LIMITS)
    limits.update(limit_values or {})
    nominal = dict(_DC_DEFAULT_NOMINAL)
    nominal.update(nominal_values or {})
    initializer = {"states": {c: 0.0 for c in currents}, "interval": None, "random_init": None,
                   "random_params": (None, None)}
    initializer.update(motor_initializer or {})

    # limit completion (dc_*_motor.py _update_limits)
    r_a = parameter.get("r_a", 1.0) or 1.0
    if kind == "PermExDc":
        agenda = {"u": _DC_DEFAULT_LIMITS["u"], "i": limits["u"] / r_a}
    elif kind == "SeriesDc":
        agenda = {"u": _DC_DEFAULT_LIMITS["u"], "i": limits["u"] / (r_a + parameter["r_e"])}
    else:
        agenda = ({"u": _DC_DEFAULT_LIMITS["u"]} if kind == "ShuntDc"
                  else {"u_a": _DC_DEFAULT_LIMITS["u"], "u_e": _DC_DEFAULT_LIMITS["u"]})
        agenda["i_a"] = limits.get("i", None) or limits["u"] / r_a
        agenda["i_e"] = limits.get("i", None) or limits["u"] / parameter["r_e"]
    # torque limit from the current limits (dc_motor.py:153-159)
    if kind == "PermExDc":
        agenda["torque"] = parameter["psi_e"] * limits["i"]
    elif kind == "SeriesDc":
        agenda["torque"] = parameter["l_e_prime"] * limits["i"] ** 2
    else:
        agenda["torque"] = parameter["l_e_prime"] * limits["i_a"] * limits["i_e"]
    agenda["omega"] = _DC_DEFAULT_LIMITS["omega"]
    limits, nominal = _complete(limits, nominal, agenda)
    return MotorSpec(kind=kind, ode_states=currents, currents=currents, voltages=voltages,
                     parameter=parameter, limits=limits, nominal=nominal, initializer=initializer,
                     ode=ode, torque=torque, i_in=i_in)


def permex_dc(**kwargs) -> MotorSpec:
    return _dc_spec("PermExDc", {"r_a": 16e-3, "l_a": 19e-6, "psi_e": 0.165, "j_rotor": 0.025},
                    ("i",), ("u",), permex_dc_ode, permex_dc_torque,
                    lambda mp, s: s[..., :1], **kwargs)


def series_dc(**kwargs) -> MotorSpec:
    return _dc_spec("SeriesDc", {"r_a": 16e-3, "r_e": 48e-3, "l_a": 19e-6, "l_e_prime": 1.7e-3,
                                 "l_e": 5.4e-3, "j_rotor": 0.0025},
                    ("i",), ("u",), series_dc_ode, series_dc_torque,
                    lambda mp, s: s[..., :1], **kwargs)


def shunt_dc(**kwargs) -> MotorSpec:
    """The converter feeds both circuits and sees i_a + i_e."""
    return _dc_spec("ShuntDc", {"r_a": 16e-3, "r_e": 4e-1, "l_a": 19e-6, "l_e_prime": 1.7e-3,
                                "l_e": 5.4e-3, "j_rotor": 0.0025},
                    ("i_a", "i_e"), ("u",), shunt_dc_ode, extex_dc_torque,
                    lambda mp, s: s[..., 0:1] + s[..., 1:2], **kwargs)


def extex_dc(**kwargs) -> MotorSpec:
    return _dc_spec("ExtExDc", {"r_a": 16e-3, "r_e": 16e-2, "l_a": 19e-6, "l_e_prime": 1.7e-3,
                                "l_e": 5.4e-3, "j_rotor": 0.0025},
                    ("i_a", "i_e"), ("u_a", "u_e"), extex_dc_ode, extex_dc_torque,
                    lambda mp, s: s[..., :2], **kwargs)


# ---------------------------------------------------------------------------
# Synchronous motors
# ---------------------------------------------------------------------------


def pmsm_ode(mp, state, u_dq, omega):
    """PMSM dq-frame ODE (permanent_magnet_synchronous_motor.py:107-119 of
    the reference)."""
    i_sd, i_sq = state[..., 0], state[..., 1]
    p = mp["p"]
    di_sd = (float(-mp["r_s"]) * i_sd + float(mp["l_q"] * p) * omega * i_sq
             + u_dq[..., 0]) / float(mp["l_d"])
    di_sq = (float(-mp["psi_p"] * p) * omega - float(mp["r_s"]) * i_sq
             - float(mp["l_d"] * p) * omega * i_sd + u_dq[..., 1]) / float(mp["l_q"])
    deps = float(p) * omega
    return torch.stack([di_sd, di_sq, deps], dim=-1)


def pmsm_torque(mp, state):
    """1.5 p (psi_p + (l_d - l_q) i_sd) i_sq (:134-139 of the reference)."""
    return (float(1.5 * mp["p"])
            * (float(mp["psi_p"]) + float(mp["l_d"] - mp["l_q"]) * state[..., 0])
            * state[..., 1])


def synrm_ode(mp, state, u_dq, omega):
    """SynRM = PMSM with psi_p = 0 (synchronous_reluctance_motor.py:117-130)."""
    i_sd, i_sq = state[..., 0], state[..., 1]
    p = mp["p"]
    di_sd = (float(-mp["r_s"]) * i_sd + float(mp["l_q"] * p) * omega * i_sq
             + u_dq[..., 0]) / float(mp["l_d"])
    di_sq = (float(-mp["r_s"]) * i_sq - float(mp["l_d"] * p) * omega * i_sd
             + u_dq[..., 1]) / float(mp["l_q"])
    deps = float(p) * omega
    return torch.stack([di_sd, di_sq, deps], dim=-1)


def synrm_torque(mp, state):
    return float(1.5 * mp["p"] * (mp["l_d"] - mp["l_q"])) * state[..., 0] * state[..., 1]


def _sync_spec(kind, defaults, default_limits, default_nominal, io_voltages, io_currents,
               currents, voltages, ode, torque, default_initializer, torque_limit_fn,
               motor_parameter=None, nominal_values=None, limit_values=None,
               motor_initializer=None):
    parameter = update_parameter_dict(defaults, motor_parameter or {})
    limits = dict(default_limits)
    limits.update(limit_values or {})
    nominal = dict(default_nominal)
    nominal.update(nominal_values or {})
    initializer = dict(default_initializer)
    initializer.update(motor_initializer or {})

    # synchronous_motor.py:174-188 — phase voltage/current completion
    voltage_limit = 0.5 * limits["u"]
    voltage_nominal = 0.5 * nominal["u"]
    limits_agenda, nominal_agenda = {}, {}
    for u, i in zip(io_voltages, io_currents):
        limits_agenda[u] = voltage_limit
        nominal_agenda[u] = voltage_nominal
        limits_agenda[i] = limits.get("i", None) or limits[u] / parameter["r_s"]
        nominal_agenda[i] = nominal.get("i", None) or nominal[u] / parameter["r_s"]
    limits_agenda["omega"] = default_limits["omega"]
    limits, nominal = _complete(limits, nominal, limits_agenda, nominal_agenda)
    # torque limit (three_phase_motor.py:127-133)
    tl = {"torque": torque_limit_fn(parameter, limits, nominal)}
    limits, nominal = _complete(limits, nominal, tl)

    return MotorSpec(
        kind=kind,
        ode_states=currents + ("epsilon",),
        currents=currents,
        voltages=voltages,
        parameter=parameter,
        limits=limits,
        nominal=nominal,
        initializer=initializer,
        ode=ode,
        torque=torque,
        i_in=lambda mp, s: s[..., : len(currents)],
    )


def _pmsm_torque_limit(mp, limits, nominal):
    """permanent_magnet_synchronous_motor.py:121-132 (MTPC point at the
    nominal current)."""
    if mp["l_d"] == mp["l_q"]:
        return 1.5 * mp["p"] * mp["psi_p"] * limits["i_sq"]
    i_n = nominal["i"]
    _p = mp["psi_p"] / (2 * (mp["l_d"] - mp["l_q"]))
    _q = -(i_n**2) / 2
    i_d_opt = -_p / 2 - math.sqrt((_p / 2) ** 2 - _q)
    i_q_opt = math.sqrt(i_n**2 - i_d_opt**2)
    return 1.5 * mp["p"] * (mp["psi_p"] + (mp["l_d"] - mp["l_q"]) * i_d_opt) * i_q_opt


_SYNC_INITIALIZER = {"states": {"i_sq": 0.0, "i_sd": 0.0, "epsilon": 0.0},
                     "interval": None, "random_init": None,
                     "random_params": (None, None)}


def pmsm(**kwargs) -> MotorSpec:
    return _sync_spec(
        "PMSM",
        {"p": 3.0, "l_d": 0.37e-3, "l_q": 1.2e-3, "j_rotor": 0.03883, "r_s": 18e-3, "psi_p": 66e-3},
        dict(omega=4e3 * np.pi / 30, torque=0.0, i=400.0, epsilon=math.pi, u=300.0),
        dict(omega=3e3 * np.pi / 30, torque=0.0, i=240.0, epsilon=math.pi, u=300.0),
        ["u_a", "u_b", "u_c", "u_sd", "u_sq"],
        ["i_a", "i_b", "i_c", "i_sd", "i_sq"],
        ("i_sd", "i_sq"),
        ("u_sd", "u_sq"),
        pmsm_ode,
        pmsm_torque,
        _SYNC_INITIALIZER,
        _pmsm_torque_limit,
        **kwargs,
    )


def _synrm_torque_limit(mp, limits, nominal):
    """synchronous_reluctance_motor.py:132-134 of the reference."""
    i_sd = limits["i_sd"] / math.sqrt(2)
    i_sq = limits["i_sq"] / math.sqrt(2)
    return 1.5 * mp["p"] * (mp["l_d"] - mp["l_q"]) * i_sd * i_sq


def synrm(**kwargs) -> MotorSpec:
    return _sync_spec(
        "SynRM",
        {"p": 4.0, "l_d": 10.1e-3, "l_q": 4.1e-3, "j_rotor": 0.8e-3, "r_s": 0.57},
        dict(omega=4.3e3 * np.pi / 30, torque=0.0, i=18.0, epsilon=math.pi, u=80.0),
        dict(omega=3e3 * np.pi / 30, torque=0.0, i=10.0, epsilon=math.pi, u=80.0),
        ["u_a", "u_b", "u_c", "u_sd", "u_sq"],
        ["i_a", "i_b", "i_c", "i_sd", "i_sq"],
        ("i_sd", "i_sq"),
        ("u_sd", "u_sq"),
        synrm_ode,
        synrm_torque,
        _SYNC_INITIALIZER,
        _synrm_torque_limit,
        **kwargs,
    )


# ---------------------------------------------------------------------------
# Externally excited synchronous motor
# (externally_excited_synchronous_motor.py of the reference)
# ---------------------------------------------------------------------------


def _eesm_derived(mp):
    """Stator-side transformed rotor parameters ``(r_E, l_M, l_E, i_k_rs,
    sigma)`` (externally_excited_synchronous_motor.py:125-135 of the
    reference), each operation rounded as the parameters' type rounds it."""
    r_E = mp["k"] ** 2 * 1.5 * mp["r_e"]
    l_M = mp["k"] * 1.5 * mp["l_m"]
    l_E = mp["k"] ** 2 * 1.5 * mp["l_e"]
    i_k_rs = 2.0 / 3.0 / mp["k"]
    sigma = 1.0 - l_M**2 / (mp["l_d"] * l_E)
    return r_E, l_M, l_E, i_k_rs, sigma


def eesm_ode(mp, state, u_dqe, omega):
    """The EESM ODE over ``(N, 4)`` = (i_sd, i_sq, i_e, epsilon) under the
    ``(N, 3)`` voltages (u_sd, u_sq, u_e)
    (externally_excited_synchronous_motor.py:139-182 of the reference)."""
    r_E, l_M, l_E, i_k_rs, sigma = _eesm_derived(mp)
    i_sd, i_sq, i_e = state[..., 0], state[..., 1], state[..., 2]
    p, r_s, l_d, l_q, k = mp["p"], mp["r_s"], mp["l_d"], mp["l_q"], mp["k"]
    u_d, u_q, u_e = u_dqe[..., 0], u_dqe[..., 1], u_dqe[..., 2]
    di_sd = (float(-r_s / sigma) * i_sd + float(l_M * r_E / (sigma * l_E) * i_k_rs) * i_e
             + u_d / float(sigma) - float(l_M * k / (sigma * l_E)) * u_e
             + float(l_q * p / sigma) * omega * i_sq) / float(l_d)
    di_sq = (float(-r_s) * i_sq + u_q - float(l_d * p) * omega * i_sd
             - float(p * l_M * i_k_rs) * omega * i_e) / float(l_q)
    di_e = (float(l_M * r_s / (sigma * l_d)) * i_sd - float(r_E / sigma * i_k_rs) * i_e
            - float(l_M / (sigma * l_d)) * u_d + float(k / sigma) * u_e
            - float(p * l_M * l_q / (sigma * l_d)) * omega * i_sq) / float(l_E * i_k_rs)
    deps = float(p) * omega
    return torch.stack([di_sd, di_sq, di_e, deps], dim=-1)


def eesm_torque(mp, state):
    """1.5 p (l_M i_e i_k_rs + (l_d - l_q) i_sd) i_sq
    (externally_excited_synchronous_motor.py:200-203 of the reference)."""
    _, l_M, _, i_k_rs, _ = _eesm_derived(mp)
    return (float(1.5 * mp["p"])
            * (float(l_M) * state[..., 2] * float(i_k_rs)
               + float(mp["l_d"] - mp["l_q"]) * state[..., 0]) * state[..., 1])


def _eesm_torque_limit(mp, limits, nominal):
    """externally_excited_synchronous_motor.py:184-198 of the reference: the
    MTPC point at the nominal current where l_d != l_q."""
    _r_E, l_M, _l_E, i_k_rs, _sigma = _eesm_derived({k: float(v) for k, v in mp.items()})
    if mp["l_d"] == mp["l_q"]:
        i_d_opt, i_q_opt = 0.0, limits["i_sq"]
    else:
        i_n = nominal["i"]
        _p = l_M * i_n / (2 * (mp["l_d"] - mp["l_q"]))
        _q = -(i_n**2) / 2
        if mp["l_d"] < mp["l_q"]:
            i_d_opt = -_p / 2 - math.sqrt((_p / 2) ** 2 - _q)
        else:
            i_d_opt = -_p / 2 + math.sqrt((_p / 2) ** 2 - _q)
        i_q_opt = math.sqrt(i_n**2 - i_d_opt**2)
    return (1.5 * mp["p"] * (l_M * limits["i_e"] * i_k_rs + (mp["l_d"] - mp["l_q"]) * i_d_opt)
            * i_q_opt)


def eesm(**kwargs) -> MotorSpec:
    return _sync_spec(
        "EESM",
        {"p": 3.0, "l_d": 1.66e-3, "l_q": 0.35e-3, "l_m": 1.589e-3, "l_e": 1.74e-3,
         "j_rotor": 0.3883, "r_s": 15.55e-3, "r_e": 7.2e-3, "k": 65.21},
        dict(omega=12e3 * np.pi / 30, torque=0.0, i=150.0, i_e=150.0, epsilon=math.pi, u=320.0),
        dict(omega=4.3e3 * np.pi / 30, torque=0.0, i=120.0, i_e=150.0, epsilon=math.pi, u=320.0),
        ["u_a", "u_b", "u_c", "u_sd", "u_sq", "u_e"],
        ["i_a", "i_b", "i_c", "i_sd", "i_sq", "i_e"],
        ("i_sd", "i_sq", "i_e"),
        ("u_sd", "u_sq", "u_e"),
        eesm_ode,
        eesm_torque,
        {"states": {"i_sq": 0.0, "i_sd": 0.0, "i_e": 0.0, "epsilon": 0.0}, "interval": None,
         "random_init": None, "random_params": (None, None)},
        _eesm_torque_limit,
        **kwargs,
    )


# ---------------------------------------------------------------------------
# Induction motors (induction_motor.py and squirrel_cage_induction_motor.py
# of the reference)
# ---------------------------------------------------------------------------


def _im_derived(mp):
    """``(l_s, l_r, sigma, tau_r, tau_sig)`` in float32, each operation
    rounded as the JAX package's numpy float32 parameters round it."""
    l_s = mp["l_m"] + mp["l_sigs"]
    l_r = mp["l_m"] + mp["l_sigr"]
    sigma = (l_s * l_r - mp["l_m"] ** 2) / (l_s * l_r)
    tau_r = l_r / mp["r_r"]
    tau_sig = sigma * l_s / (mp["r_s"] + mp["r_r"] * (mp["l_m"] ** 2) / (l_r**2))
    return l_s, l_r, sigma, tau_r, tau_sig


def induction_ode(mp, state, u_sr_alphabeta, omega):
    """The alpha/beta induction-machine ODE (induction_motor.py:287-313 of
    the reference): ``state`` is ``(N, 5)`` = (i_salpha, i_sbeta, psi_ralpha,
    psi_rbeta, epsilon), ``u_sr_alphabeta`` the pair of ``(N, 2)`` stator
    and rotor voltages, ``omega`` ``(N,)``.  The SCIM passes zero rotor
    voltages; the DFIM its rotor converter's, turned into the stator frame."""
    l_s, l_r, sigma, tau_r, tau_sig = _im_derived(mp)
    i_sa, i_sb, psi_ra, psi_rb = state[..., 0], state[..., 1], state[..., 2], state[..., 3]
    p = mp["p"]
    u_sal, u_sbe = u_sr_alphabeta[0][..., 0], u_sr_alphabeta[0][..., 1]
    u_ral, u_rbe = u_sr_alphabeta[1][..., 0], u_sr_alphabeta[1][..., 1]
    c_psi = float(mp["l_m"] * mp["r_r"] / (sigma * l_s * l_r**2))
    c_w = float(mp["l_m"] * p / (sigma * l_r * l_s))
    c_u = float(_f32(1.0) / (sigma * l_s))
    c_ur = float(mp["l_m"] / (sigma * l_r * l_s))
    tau_sig, tau_r, l_m_tau_r, p = float(tau_sig), float(tau_r), float(mp["l_m"] / tau_r), float(p)
    di_sa = (-i_sa / tau_sig + c_psi * psi_ra + c_w * omega * psi_rb + c_u * u_sal
             - c_ur * u_ral)
    di_sb = (-i_sb / tau_sig + c_psi * psi_rb - c_w * omega * psi_ra + c_u * u_sbe
             - c_ur * u_rbe)
    dpsi_ra = l_m_tau_r * i_sa - psi_ra / tau_r - p * omega * psi_rb + u_ral
    dpsi_rb = l_m_tau_r * i_sb - psi_rb / tau_r + p * omega * psi_ra + u_rbe
    deps = p * omega
    return torch.stack([di_sa, di_sb, dpsi_ra, dpsi_rb, deps], dim=-1)


def scim_ode(mp, state, u_salphabeta, omega):
    """The rotor windings are short-circuited: u_r = 0
    (squirrel_cage_induction_motor.py:121-129 of the reference)."""
    zero = torch.zeros_like(u_salphabeta)
    return induction_ode(mp, state, (u_salphabeta, zero), omega)


def induction_torque(mp, state):
    """1.5 p l_m / l_r (psi_ralpha i_sbeta - psi_rbeta i_salpha)
    (induction_motor.py:236-248 of the reference)."""
    l_r = mp["l_m"] + mp["l_sigr"]
    gain = float(1.5 * mp["p"] * mp["l_m"] / l_r)
    return gain * (state[..., 2] * state[..., 1] - state[..., 3] * state[..., 0])


def _im_torque_limit(mp, limits, nominal):
    """induction_motor.py:223-234 of the reference."""
    l_r = mp["l_m"] + mp["l_sigr"]
    return 1.5 * mp["p"] * mp["l_m"] ** 2 / l_r * limits["i_sd"] * limits["i_sq"] / 2


def _im_spec(kind, defaults, default_limits, default_nominal, io_voltages, io_currents, ode,
             motor_parameter=None, nominal_values=None, limit_values=None, motor_initializer=None,
             initial_limits=None):
    parameter = update_parameter_dict(defaults, motor_parameter or {})
    # the phase voltage limits are half the placeholder 'u'
    # (squirrel_cage_induction_motor.py:131-144 of the reference); limit
    # values the caller gives per quantity take precedence
    limits = dict(default_limits)
    limits.update(limit_values or {})
    nominal = dict(default_nominal)
    nominal.update(nominal_values or {})
    voltage_limit = 0.5 * limits["u"]
    voltage_nominal = 0.5 * nominal["u"]
    limits_agenda, nominal_agenda = {}, {}
    r_div = parameter["r_s"] if kind == "SCIM" else parameter["r_r"]
    for u, i in zip(io_voltages, io_currents):
        limits_agenda[u] = voltage_limit
        nominal_agenda[u] = voltage_nominal
        limits_agenda[i] = limits.get("i", None) or limits[u] / r_div
        nominal_agenda[i] = nominal.get("i", None) or nominal[u] / r_div
    limits_agenda["omega"] = default_limits["omega"]
    limits, nominal = _complete(limits, nominal, limits_agenda, nominal_agenda)
    tl = {"torque": _im_torque_limit(parameter, limits, nominal)}
    limits, nominal = _complete(limits, nominal, tl)

    initializer = {
        "states": {"i_salpha": 0.0, "i_sbeta": 0.0, "psi_ralpha": 0.0, "psi_rbeta": 0.0,
                   "epsilon": 0.0},
        "interval": None,
        "random_init": None,
        "random_params": (None, None),
    }
    initializer.update(motor_initializer or {})
    init_lims = dict(nominal)
    init_lims.update(initial_limits or {})
    return MotorSpec(
        kind=kind,
        ode_states=("i_salpha", "i_sbeta", "psi_ralpha", "psi_rbeta", "epsilon"),
        currents=("i_salpha", "i_sbeta"),
        voltages=("u_salpha", "u_sbeta"),
        parameter=parameter,
        limits=limits,
        nominal=nominal,
        initializer=initializer,
        ode=ode,
        torque=induction_torque,
        i_in=lambda mp, s: s[..., :2],
        initial_limits=init_lims,
    )


_IM_IO_VOLTAGES = ["u_sa", "u_sb", "u_sc", "u_salpha", "u_sbeta", "u_sd", "u_sq"]
_IM_IO_CURRENTS = ["i_sa", "i_sb", "i_sc", "i_salpha", "i_sbeta", "i_sd", "i_sq"]
_DFIM_IO_VOLTAGES = _IM_IO_VOLTAGES + ["u_ra", "u_rb", "u_rc", "u_rd", "u_rq", "u_ralpha",
                                       "u_rbeta"]
_DFIM_IO_CURRENTS = _IM_IO_CURRENTS + ["i_ra", "i_rb", "i_rc", "i_rd", "i_rq", "i_ralpha",
                                       "i_rbeta"]


def scim(**kwargs) -> MotorSpec:
    return _im_spec(
        "SCIM",
        {"p": 2.0, "l_m": 143.75e-3, "l_sigs": 5.87e-3, "l_sigr": 5.87e-3, "j_rotor": 1.1e-3,
         "r_s": 2.9338, "r_r": 1.355},
        dict(omega=4e3 * np.pi / 30, torque=0.0, i=5.5, epsilon=math.pi, u=560.0),
        dict(omega=3e3 * np.pi / 30, torque=0.0, i=3.9, epsilon=math.pi, u=560.0),
        _IM_IO_VOLTAGES,
        _IM_IO_CURRENTS,
        scim_ode,
        **kwargs,
    )


def dfim(**kwargs) -> MotorSpec:
    """The doubly fed induction motor (doubly_fed_induction_motor.py of the
    reference): the induction ODE with the rotor voltages as inputs."""
    return _im_spec(
        "DFIM",
        {"p": 2.0, "l_m": 297.5e-3, "l_sigs": 25.71e-3, "l_sigr": 25.71e-3, "j_rotor": 13.695e-3,
         "r_s": 4.42, "r_r": 3.51},
        dict(omega=1800 * np.pi / 30, torque=0.0, i=9.0, epsilon=math.pi, u=720.0),
        dict(omega=1650 * np.pi / 30, torque=0.0, i=7.5, epsilon=math.pi, u=720.0),
        _DFIM_IO_VOLTAGES,
        _DFIM_IO_CURRENTS,
        induction_ode,
        **kwargs,
    )


# ---------------------------------------------------------------------------
# Switched reluctance motor (an extension of the JAX package: the reference
# only stubs it).  Sinusoidal inductance profile per phase k,
#   L_k(eps) = l0 - l1 cos(eps - k 2 pi / 3),  dL_k / dtheta = p l1 sin(...),
# unipolar phase currents (the system clamps them at zero after a step) and,
# with ``psi_s`` set, the exponential saturating flux model
#   di_k / dt = (u - r_s i - i L'_k omega e) / (L_k e),  e = exp(-i L_k / psi_s),
#   T = sum_k (L'_k psi_s^2 / L_k^2) ((1 - e) - x e),  x = i L_k / psi_s.
# ---------------------------------------------------------------------------

_SRM_PHI = (0.0, 2.0 * math.pi / 3.0, 4.0 * math.pi / 3.0)


def _srm_sat(mp):
    v = mp.get("psi_s", None)
    return None if v is None or float(v) <= 0.0 else v


def _srm_phase(mp, state):
    """sin and cos of eps - phi_k, the inductances and their slopes:
    ``(N, 3)`` each."""
    phi = torch.tensor(_SRM_PHI, dtype=state.dtype, device=state.device)
    arg = state[..., 3:4] - phi
    s_k = torch.sin(arg)
    l_k = float(mp["l0"]) - float(mp["l1"]) * torch.cos(arg)
    dl_dth = float(mp["p"] * mp["l1"]) * s_k
    return l_k, dl_dth


def srm_ode(mp, state, u_in, omega):
    """The phase-current ODE and the angle rate (``srm_ode``)."""
    l_k, dl_dth = _srm_phase(mp, state)
    i = state[..., :3]
    w = omega[..., None]
    psi_s = _srm_sat(mp)
    if psi_s is None:
        di = (u_in - float(mp["r_s"]) * i - i * dl_dth * w) / l_k
    else:
        e = torch.exp(-i * l_k / float(psi_s))
        di = (u_in - float(mp["r_s"]) * i - i * dl_dth * w * e) / (l_k * e)
    return torch.cat([di, (float(mp["p"]) * omega)[..., None]], dim=-1)


def srm_torque(mp, state):
    """The reluctance torque, the coenergy form when saturating
    (``srm_torque``)."""
    l_k, dl_dth = _srm_phase(mp, state)
    i = state[..., :3]
    psi_s = _srm_sat(mp)
    if psi_s is None:
        return torch.sum(0.5 * i * i * dl_dth, dim=-1)
    x = i * l_k / float(psi_s)
    e = torch.exp(-x)
    return torch.sum((dl_dth * float(_f32(psi_s) ** 2) / (l_k * l_k)) * ((1.0 - e) - x * e),
                     dim=-1)


def switched_reluctance_motor(motor_parameter=None, nominal_values=None, limit_values=None,
                              motor_initializer=None) -> MotorSpec:
    """3-phase switched reluctance motor: ``r_s``, the unaligned and aligned
    inductances ``l_min`` and ``l_max`` (``l0`` and ``l1`` are their mean
    and half difference), ``p``, ``j_rotor`` and the optional saturation
    flux ``psi_s``.  The torque limit is the single-phase maximum
    0.5 i_lim^2 p l1."""
    defaults = {"p": 4.0, "r_s": 0.5, "l_min": 12e-3, "l_max": 60e-3, "j_rotor": 5e-3,
                "psi_s": None}
    parameter = update_parameter_dict(defaults, motor_parameter or {})
    if parameter.get("psi_s") is None:
        # an absent key selects the linear model (mp() would turn None into
        # nan)
        parameter.pop("psi_s", None)
    parameter["l0"] = 0.5 * (parameter["l_max"] + parameter["l_min"])
    parameter["l1"] = 0.5 * (parameter["l_max"] - parameter["l_min"])
    limits = dict(omega=500.0, torque=0.0, i=20.0, epsilon=math.pi, u=400.0)
    limits.update(limit_values or {})
    nominal = dict(omega=300.0, torque=0.0, i=16.0, epsilon=math.pi, u=400.0)
    nominal.update(nominal_values or {})
    limits_agenda, nominal_agenda = {}, {}
    for k in "abc":
        limits_agenda[f"u_{k}"] = limits["u"]  # the full DC link per phase
        nominal_agenda[f"u_{k}"] = nominal["u"]
        limits_agenda[f"i_{k}"] = limits["i"]
        nominal_agenda[f"i_{k}"] = nominal["i"]
    limits, nominal = _complete(limits, nominal, limits_agenda, nominal_agenda)
    tl = 0.5 * limits["i"] ** 2 * parameter["p"] * parameter["l1"]
    limits, nominal = _complete(limits, nominal, {"torque": tl})
    initializer = {"states": {"i_a": 0.0, "i_b": 0.0, "i_c": 0.0, "epsilon": 0.0},
                   "interval": None, "random_init": None, "random_params": (None, None)}
    initializer.update(motor_initializer or {})
    return MotorSpec(
        kind="SRM",
        ode_states=("i_a", "i_b", "i_c", "epsilon"),
        currents=("i_a", "i_b", "i_c"),
        voltages=("u_a", "u_b", "u_c"),
        parameter=parameter,
        limits=limits,
        nominal=nominal,
        initializer=initializer,
        ode=srm_ode,
        torque=srm_torque,
        i_in=lambda mp, s: s[..., :3],
        initial_limits=dict(nominal),
    )


MOTOR_FACTORIES = {
    "PermExDc": permex_dc,
    "SeriesDc": series_dc,
    "ShuntDc": shunt_dc,
    "ExtExDc": extex_dc,
    "PMSM": pmsm,
    "SynRM": synrm,
    "EESM": eesm,
    "SCIM": scim,
    "DFIM": dfim,
    "SRM": switched_reluctance_motor,
}
