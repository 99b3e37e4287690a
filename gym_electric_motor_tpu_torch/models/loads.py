"""Mechanical load models (counterpart of
``gym_electric_motor_tpu/models/loads.py``).

A load spec provides the mechanical ODE ``d(mech_state)/dt`` on batched
``(N, n_mech)`` tensors plus its initialisation.  Only the constant-speed
load exists so far; the polynomial, Ornstein-Uhlenbeck and external-speed
loads come with slice 3 of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch


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
