"""Mechanical load models (counterpart of
``gym_electric_motor_tpu/models/loads.py``).

A load spec provides the mechanical ODE ``d(mech_state)/dt`` on batched
``(N, n_mech)`` tensors plus its initialisation.  The constant-speed and
polynomial static loads exist so far; the Ornstein-Uhlenbeck and
external-speed loads raise until the shared parts of queue 1, slice 3 of
the port bring them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..utils.params import update_parameter_dict

_f32 = np.float32


@dataclasses.dataclass
class LoadSpec:
    kind: str
    state_names: tuple
    j_load: float
    parameter: dict
    limits: dict
    nominal: dict
    initializer: dict
    # ode(lp, t, mech_state, torque, noise) -> d/dt mech_state
    ode: Callable = None
    omega_fixed: Optional[float] = None

    def lp(self, j_rotor: float) -> dict:
        """Load parameters incl. the total inertia (load + rotor)."""
        out = {k: float(v) for k, v in self.parameter.items()}
        out["j_total"] = float(self.j_load + j_rotor)
        return out


def constant_speed_load(omega_fixed=0.0, load_initializer=None) -> LoadSpec:
    """d omega/dt = 0 (constant_speed_load.py of the reference)."""

    def ode(lp, t, mech_state, torque, noise=None):
        return torch.zeros_like(mech_state)

    initializer = {"states": {"omega": float(omega_fixed)}, "interval": None,
                   "random_init": None, "random_params": (None, None)}
    initializer.update(load_initializer or {})
    return LoadSpec(
        kind="ConstantSpeedLoad",
        state_names=("omega",),
        j_load=0.0,
        parameter={},
        limits={},
        nominal={},
        initializer=initializer,
        ode=ode,
        omega_fixed=float(omega_fixed),
    )


def polynomial_static_load(load_parameter=None, limits=None, load_initializer=None) -> LoadSpec:
    """T_L = sign(w) c w^2 + b w + a sign(w), with the constant term
    linearised around zero speed for integrator stability
    (polynomial_static_load.py:87-107 of the reference).  ``torch.sign`` is
    0 at w = 0, as ``jnp.sign`` is.  ``lp`` holds Python floats; the
    threshold and gains are formed in float32 as the JAX package's float32
    parameters form them."""
    params = update_parameter_dict(dict(a=0.0, b=0.0, c=0.0, j_load=1e-5), load_parameter or {})
    tau_decay = 1e-3

    def ode(lp, t, mech_state, torque, noise=None):
        omega = mech_state[:, 0]
        a, j_total = _f32(lp["a"]), _f32(lp["j_total"])
        sign = torch.sign(omega)
        omega_lim = float(a / j_total * _f32(tau_decay))
        a_term = torch.where(torch.abs(omega) > omega_lim, sign * float(a),
                             float(j_total / _f32(tau_decay)) * omega)
        static_torque = (sign * float(_f32(lp["c"])) * omega * omega
                         + float(_f32(lp["b"])) * omega + a_term)
        return ((torque - static_torque) / float(j_total))[:, None]

    initializer = {"states": {"omega": 0.0}, "interval": None, "random_init": None,
                   "random_params": (None, None)}
    initializer.update(load_initializer or {})
    return LoadSpec(
        kind="PolynomialStaticLoad",
        state_names=("omega",),
        j_load=params["j_load"],
        parameter={k: params[k] for k in ("a", "b", "c")},
        limits=dict(limits or {}),
        nominal={},
        initializer=initializer,
        ode=ode,
    )


def _unported_load(kind):
    def factory(*args, **kwargs):
        raise NotImplementedError(
            f"{kind} is not ported yet; it arrives with the shared parts of "
            "queue 1, slice 3 of the port (the loads)")
    factory.__name__ = kind
    return factory


ornstein_uhlenbeck_load = _unported_load("OrnsteinUhlenbeckLoad")
external_speed_load = _unported_load("ExternalSpeedLoad")
