"""Power-electronic converters as branch-free functions on batched tensors
(counterpart of ``gym_electric_motor_tpu/models/converters.py``).

``conv_state`` is an ``(N, n_state)`` int32 tensor of persistent
half-bridge switching states (0 = both transistors off, 1 = upper on,
2 = lower on); a finite action is an ``(N,)`` integer tensor; phase
currents are ``(N, n_in)``.  Only the finite B6 bridge exists so far, with
zero interlocking time; the other converters and the dead-time schedule
come with slice 3 of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch


def _hb_u(state, i_out):
    """Half-bridge output voltage fraction (converters.py:277-287 of the
    reference): state 0 freewheels, the body diode conducts iff i < 0."""
    free = torch.where(i_out < 0, 1.0, 0.0).to(i_out.dtype)
    return torch.where(state == 1, 1.0, torch.where(state == 2, 0.0, free)).to(i_out.dtype)


def _hb_i_sup(state, i_out):
    """Half-bridge supply current (converters.py:289-298 of the reference)."""
    zero = torch.zeros_like(i_out)
    free = torch.where(i_out < 0, i_out, zero)
    return torch.where(state == 1, i_out, torch.where(state == 2, zero, free))


@dataclasses.dataclass
class ConverterSpec:
    """Host-side converter description + batched closures.

    ``bridge_actions(action) -> (N, n_state)`` int32 commanded half-bridge
    states; ``u_frac(bridge_states, action, i_out) -> (N, n_out)`` terminal
    voltage as a fraction of the supply voltage; ``i_sup(bridge_states,
    action, i_out) -> (N,)`` supply current."""

    kind: str
    action_type: str  # 'finite' | 'cont' | 'none'
    action_space: tuple  # ('discrete', n) | ('box', low, high) | ...
    n_state: int
    n_out: int
    n_in: int
    voltages: tuple  # (low, high) arrays, shape (n_out,)
    currents: tuple  # (low, high) arrays, shape (n_in,)
    interlocking_time: float
    tau: float
    bridge_actions: Optional[Callable] = None
    u_frac: Callable = None
    i_sup: Callable = None
    u_reset: np.ndarray = None  # converter.reset() output voltage fractions

    def __post_init__(self):
        if self.interlocking_time:
            raise NotImplementedError(
                "interlocking dead time is not ported yet; it arrives with "
                "slice 3 of the port")

    def interval_durations(self) -> tuple:
        return (self.tau,)

    def init_state(self, n: int, device):
        return torch.zeros((n, self.n_state), dtype=torch.int32, device=device)

    def interval_states(self, conv_state, action):
        """Half-bridge states of the single sub-interval."""
        if self.action_type != "finite" or self.n_state == 0:
            return (conv_state,)
        return (self.bridge_actions(action),)


def finite_b6_bridge_converter(tau=1e-5, interlocking_time=0.0) -> ConverterSpec:
    """Discrete(8) -> 3 half bridges (converters.py:743-839 of the
    reference).  Phase k is high iff bit (2 - k) of the action is set; the
    bridge states are computed arithmetically, not from a table."""

    def bridge_actions(action):
        a = action.to(torch.int32)
        return torch.stack([2 - ((a >> 2) & 1), 2 - ((a >> 1) & 1),
                            2 - (a & 1)], dim=-1)

    def u_frac(bridge_states, action, i_out):
        # each phase offset by -0.5 (converters.py:816-823)
        return _hb_u(bridge_states, i_out) - 0.5

    def i_sup(bridge_states, action, i_out):
        return torch.sum(_hb_i_sup(bridge_states, i_out), dim=-1)

    return ConverterSpec(
        kind="Finite-B6C",
        action_type="finite",
        action_space=("discrete", 8),
        n_state=3,
        n_out=3,
        n_in=3,
        voltages=(-np.ones(3), np.ones(3)),
        currents=(-np.ones(3), np.ones(3)),
        interlocking_time=interlocking_time,
        tau=tau,
        bridge_actions=bridge_actions,
        u_frac=u_frac,
        i_sup=i_sup,
        u_reset=np.full(3, -0.5),
    )

