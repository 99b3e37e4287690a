"""Synchronous motor models (counterpart of the PMSM and SynRM parts of
``gym_electric_motor_tpu/models/motors.py``).

A *spec* (host side) carries default parameters, the completed limit and
nominal dicts and the initial-state description; the *functions*
``ode(mp, state, u_dq, omega)`` and ``torque(mp, state)`` work on batched
tensors: ``state`` is ``(N, 3)`` = (i_sd, i_sq, epsilon), ``u_dq`` is
``(N, 2)`` and ``omega`` is ``(N,)``.

``mp`` holds every parameter as a Python float rounded to float32, and the
products of parameters are formed in float32 with numpy before they meet a
tensor, so each operation rounds where the JAX package's does.  The DC,
EESM, SCIM, DFIM and SRM families come with slice 3 of the port.
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


MOTOR_FACTORIES = {
    "PMSM": pmsm,
    "SynRM": synrm,
}
