"""Voltage supply models (counterpart of
``gym_electric_motor_tpu/models/supplies.py``).

A supply spec provides ``get_voltage(sp, sup_state, t, i_sup) -> (u_sup,
sup_state')`` on batched tensors: ``u_sup`` is ``(N, voltage_len)`` and
``sup_state`` is ``(N, n_state)``.  Only the ideal supply exists so far;
the RC, AC1 and AC3 supplies raise until the shared parts of queue 1,
slice 3 of the port bring them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass
class SupplySpec:
    kind: str
    u_nominal: float
    supply_range: tuple
    voltage_len: int
    parameter: dict
    # get_voltage(sp, sup_state, t, i_sup) -> ((N, voltage_len), sup_state')
    get_voltage: Callable = None
    # reset_u(sp, u, n, dtype, device) -> (u_sup0, sup_state0); consumes
    # n_reset_u uniforms (u is None when n_reset_u == 0)
    reset_u: Callable = None
    n_reset_u: int = 0
    n_state: int = 0  # float state entries carried in the env state

    def sp(self) -> dict:
        return {k: float(v) for k, v in self.parameter.items()}


def ideal_voltage_supply(u_nominal=600.0) -> SupplySpec:
    """Constant supply (voltage_supplies.py:60-72 of the reference)."""

    def get_voltage(sp, sup_state, t, i_sup):
        n = sup_state.shape[0]
        u = torch.full((n, 1), sp["u_nominal"], dtype=t.dtype, device=t.device)
        return u, sup_state

    def reset_u(sp, u, n, dtype, device):
        return (torch.full((n, 1), sp["u_nominal"], dtype=dtype, device=device),
                torch.zeros((n, 0), dtype=dtype, device=device))

    return SupplySpec(
        kind="IdealVoltageSupply",
        u_nominal=float(u_nominal),
        supply_range=(float(u_nominal), float(u_nominal)),
        voltage_len=1,
        parameter={"u_nominal": float(u_nominal)},
        get_voltage=get_voltage,
        reset_u=reset_u,
        n_state=0,
    )


def _unported_supply(kind):
    def factory(*args, **kwargs):
        raise NotImplementedError(
            f"{kind} is not ported yet; it arrives with the shared parts of "
            "queue 1, slice 3 of the port (the supplies)")
    factory.__name__ = kind
    return factory


rc_voltage_supply = _unported_supply("RCVoltageSupply")
ac_1_phase_supply = _unported_supply("AC1PhaseSupply")
ac_3_phase_supply = _unported_supply("AC3PhaseSupply")
