"""Power-electronic converters as branch-free functions on batched tensors
(counterpart of ``gym_electric_motor_tpu/models/converters.py``).

``conv_state`` is an ``(N, n_state)`` int32 tensor of persistent
half-bridge switching states (0 = both transistors off, 1 = upper on,
2 = lower on); a finite action is an ``(N,)`` integer tensor (``(N,
n_subs)`` for a multi converter); phase currents are ``(N, n_in)``; a
continuous action is an ``(N, n_out)`` float tensor of duty commands.  The
DC converters (finite and continuous 1QC, 2QC and 4QC), the multi
converter, the finite and continuous B6 bridges and the SRM's finite and
continuous asymmetric bridges exist, at zero interlocking time; the
dead-time schedule comes with queue 2, item 8 of the port.
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
    subsignal_voltage_dims: tuple = None  # multi converters only
    sub_kinds: tuple = None  # multi converters only
    default_action: object = 0

    def __post_init__(self):
        if self.interlocking_time:
            raise NotImplementedError(
                "interlocking dead time is not ported yet; it arrives with "
                "queue 2, item 8 of the port (the interlock schedule)")

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


def cont_b6_bridge_converter(tau=1e-4, interlocking_time=0.0) -> ConverterSpec:
    """Box([-1, 1]^3) duty commands -> 3 half-bridge duty cycles
    (converters.py:842-911 of the reference): duty d = (a + 1) / 2, each
    phase offset by -0.5.  With zero interlocking time the half bridge's
    dead-time discount (converters.py:148-184) is zero, so the phase
    voltage is ``clip(d, 0, 1) - 0.5`` and the supply current ``sum d i``."""

    def u_frac(bridge_states, action, i_out):
        d = 0.5 * (torch.clamp(action, -1.0, 1.0) + 1.0)
        return torch.clamp(d, 0.0, 1.0) - 0.5

    def i_sup(bridge_states, action, i_out):
        d = 0.5 * (torch.clamp(action, -1.0, 1.0) + 1.0)
        return torch.sum(d * i_out, dim=-1)

    return ConverterSpec(
        kind="Cont-B6C",
        action_type="cont",
        action_space=("box", -np.ones(3), np.ones(3)),
        n_state=0,
        n_out=3,
        n_in=3,
        voltages=(-np.ones(3), np.ones(3)),
        currents=(-np.ones(3), np.ones(3)),
        interlocking_time=interlocking_time,
        tau=tau,
        u_frac=u_frac,
        i_sup=i_sup,
        u_reset=np.full(3, -0.5),
        default_action=np.zeros(3),
    )


# ---------------------------------------------------------------------------
# DC converters (converters.py:218-495 of the reference)
# ---------------------------------------------------------------------------


def finite_one_quadrant_converter(tau=1e-5, interlocking_time=0.0) -> ConverterSpec:
    """Discrete(2): one transistor and a diode; the diode conducts (u = 1)
    while the current is negative (converters.py:218-245)."""

    def u_frac(bridge_states, action, i_out):
        return torch.where(i_out[:, 0] >= 0, action.to(i_out.dtype), 1.0)[:, None]

    def i_sup(bridge_states, action, i_out):
        return torch.where(action == 1, i_out[:, 0], 0.0)

    return ConverterSpec(
        kind="Finite-1QC", action_type="finite", action_space=("discrete", 2), n_state=0,
        n_out=1, n_in=1, voltages=(np.zeros(1), np.ones(1)), currents=(np.zeros(1), np.ones(1)),
        interlocking_time=interlocking_time, tau=tau, u_frac=u_frac, i_sup=i_sup,
        u_reset=np.zeros(1))


def finite_two_quadrant_converter(tau=1e-5, interlocking_time=0.0) -> ConverterSpec:
    """Discrete(3): one half bridge, the action is its switching state;
    action 0 freewheels (converters.py:248-310)."""

    def bridge_actions(action):
        return action.to(torch.int32)[:, None]

    def u_frac(bridge_states, action, i_out):
        return _hb_u(bridge_states[:, 0], i_out[:, 0])[:, None]

    def i_sup(bridge_states, action, i_out):
        return _hb_i_sup(bridge_states[:, 0], i_out[:, 0])

    return ConverterSpec(
        kind="Finite-2QC", action_type="finite", action_space=("discrete", 3), n_state=1,
        n_out=1, n_in=1, voltages=(np.zeros(1), np.ones(1)), currents=(-np.ones(1), np.ones(1)),
        interlocking_time=interlocking_time, tau=tau, bridge_actions=bridge_actions,
        u_frac=u_frac, i_sup=i_sup, u_reset=np.zeros(1))


def finite_four_quadrant_converter(tau=1e-5, interlocking_time=0.0) -> ConverterSpec:
    """Discrete(4): two half bridges with the states 1 + (a >= 2) and
    1 + (a & 1), computed arithmetically; the second sees the negated
    current (converters.py:313-368)."""

    def bridge_actions(action):
        a = action.to(torch.int32)
        return torch.stack([1 + (a >= 2).to(torch.int32), 1 + (a & 1)], dim=-1)

    def u_frac(bridge_states, action, i_out):
        i = i_out[:, 0]
        return (_hb_u(bridge_states[:, 0], i) - _hb_u(bridge_states[:, 1], -i))[:, None]

    def i_sup(bridge_states, action, i_out):
        i = i_out[:, 0]
        return _hb_i_sup(bridge_states[:, 0], i) + _hb_i_sup(bridge_states[:, 1], -i)

    return ConverterSpec(
        kind="Finite-4QC", action_type="finite", action_space=("discrete", 4), n_state=2,
        n_out=1, n_in=1, voltages=(-np.ones(1), np.ones(1)), currents=(-np.ones(1), np.ones(1)),
        interlocking_time=interlocking_time, tau=tau, bridge_actions=bridge_actions,
        u_frac=u_frac, i_sup=i_sup, u_reset=np.zeros(1))


def cont_one_quadrant_converter(tau=1e-4, interlocking_time=0.0) -> ConverterSpec:
    """Box([0, 1]): the clipped duty, 1 while the current is negative
    (converters.py:371-401)."""

    def u_frac(bridge_states, action, i_out):
        a = torch.clamp(action[:, 0], 0.0, 1.0)
        return torch.where(i_out[:, 0] >= 0, a, 1.0)[:, None]

    def i_sup(bridge_states, action, i_out):
        return torch.clamp(action[:, 0], 0.0, 1.0) * i_out[:, 0]

    return ConverterSpec(
        kind="Cont-1QC", action_type="cont", action_space=("box", np.zeros(1), np.ones(1)),
        n_state=0, n_out=1, n_in=1, voltages=(np.zeros(1), np.ones(1)),
        currents=(np.zeros(1), np.ones(1)), interlocking_time=interlocking_time, tau=tau,
        u_frac=u_frac, i_sup=i_sup, u_reset=np.zeros(1), default_action=np.zeros(1))


def _cont_2qc_u(d):
    """A half bridge's duty minus the interlock discount, clipped
    (converters.py:148-184); the discount is zero without interlocking."""
    return torch.clamp(d, 0.0, 1.0)


def _cont_2qc_i_sup(d, i):
    """converters.py:429-435 without interlocking."""
    return d * i


def cont_two_quadrant_converter(tau=1e-4, interlocking_time=0.0) -> ConverterSpec:
    """Box([0, 1]): one half bridge at the clipped duty (converters.py:404-435)."""

    def u_frac(bridge_states, action, i_out):
        return _cont_2qc_u(torch.clamp(action[:, 0], 0.0, 1.0))[:, None]

    def i_sup(bridge_states, action, i_out):
        return _cont_2qc_i_sup(torch.clamp(action[:, 0], 0.0, 1.0), i_out[:, 0])

    return ConverterSpec(
        kind="Cont-2QC", action_type="cont", action_space=("box", np.zeros(1), np.ones(1)),
        n_state=0, n_out=1, n_in=1, voltages=(np.zeros(1), np.ones(1)),
        currents=(-np.ones(1), np.ones(1)), interlocking_time=interlocking_time, tau=tau,
        u_frac=u_frac, i_sup=i_sup, u_reset=np.zeros(1), default_action=np.zeros(1))


def cont_four_quadrant_converter(tau=1e-4, interlocking_time=0.0) -> ConverterSpec:
    """Box([-1, 1]): two half bridges at the duties (a + 1) / 2 and
    (1 - a) / 2, both seeing the same current (converters.py:438-495)."""

    def duties(action):
        a = torch.clamp(action[:, 0], -1.0, 1.0)
        return 0.5 * (a + 1.0), -0.5 * (a - 1.0)

    def u_frac(bridge_states, action, i_out):
        d1, d2 = duties(action)
        return (_cont_2qc_u(d1) - _cont_2qc_u(d2))[:, None]

    def i_sup(bridge_states, action, i_out):
        d1, d2 = duties(action)
        i = i_out[:, 0]
        return _cont_2qc_i_sup(d1, i) + _cont_2qc_i_sup(d2, -i)

    return ConverterSpec(
        kind="Cont-4QC", action_type="cont", action_space=("box", -np.ones(1), np.ones(1)),
        n_state=0, n_out=1, n_in=1, voltages=(-np.ones(1), np.ones(1)),
        currents=(-np.ones(1), np.ones(1)), interlocking_time=interlocking_time, tau=tau,
        u_frac=u_frac, i_sup=i_sup, u_reset=np.zeros(1), default_action=np.zeros(1))


def _multi(subs, finite: bool, tau, interlocking_time) -> ConverterSpec:
    """Sub-converters side by side (converters.py:498-740): a finite action
    is ``(N, n_subs)``, one column per sub-converter (a ``multidiscrete``
    space); a continuous one concatenates the subs' duty commands."""
    state_off = np.cumsum([0] + [s.n_state for s in subs])
    in_off = np.cumsum([0] + [s.n_in for s in subs])
    act_off = np.cumsum([0] + [1 if finite else s.action_space[1].shape[0] for s in subs])

    def sub_action(action, k):
        return action[:, k] if finite else action[:, act_off[k]:act_off[k + 1]]

    def parts(bridge_states, action, i_out):
        for k, s in enumerate(subs):
            bs = None if bridge_states is None else bridge_states[:, state_off[k]:state_off[k + 1]]
            yield s, bs, sub_action(action, k), i_out[:, in_off[k]:in_off[k + 1]]

    def bridge_actions(action):
        return torch.cat([s.bridge_actions(action[:, k]) for k, s in enumerate(subs)
                          if s.n_state > 0], dim=-1)

    def u_frac(bridge_states, action, i_out):
        return torch.cat([s.u_frac(*p) for s, *p in parts(bridge_states, action, i_out)], dim=-1)

    def i_sup(bridge_states, action, i_out):
        total = 0.0
        for s, *p in parts(bridge_states, action, i_out):
            total = total + s.i_sup(*p)
        return total

    if finite:
        action_space = ("multidiscrete", tuple(s.action_space[1] for s in subs))
        default_action = np.zeros(len(subs), dtype=np.int64)
    else:
        action_space = ("box", np.concatenate([s.action_space[1] for s in subs]),
                        np.concatenate([s.action_space[2] for s in subs]))
        default_action = np.concatenate([np.atleast_1d(s.default_action) for s in subs])
    return ConverterSpec(
        kind="Finite-Multi" if finite else "Cont-Multi",
        action_type="finite" if finite else "cont", action_space=action_space,
        n_state=int(state_off[-1]), n_out=sum(s.n_out for s in subs), n_in=int(in_off[-1]),
        voltages=(np.concatenate([s.voltages[0] for s in subs]),
                  np.concatenate([s.voltages[1] for s in subs])),
        currents=(np.concatenate([s.currents[0] for s in subs]),
                  np.concatenate([s.currents[1] for s in subs])),
        interlocking_time=interlocking_time, tau=tau,
        bridge_actions=bridge_actions if finite and state_off[-1] else None,
        u_frac=u_frac, i_sup=i_sup, u_reset=np.concatenate([s.u_reset for s in subs]),
        subsignal_voltage_dims=tuple(s.n_out for s in subs),
        sub_kinds=tuple(s.kind for s in subs), default_action=default_action)


def finite_multi_converter(subconverters, tau=1e-5, interlocking_time=0.0) -> ConverterSpec:
    return _multi(list(subconverters), True, tau, interlocking_time)


def cont_multi_converter(subconverters, tau=1e-4, interlocking_time=0.0) -> ConverterSpec:
    return _multi(list(subconverters), False, tau, interlocking_time)


def _no_interlock(interlocking_time):
    if interlocking_time:
        raise ValueError("the asymmetric bridge has no shoot-through path: interlocking dead "
                         "time does not apply")


def finite_asymmetric_bridge_converter(tau=1e-5, n_phases=3,
                                       interlocking_time=0.0) -> ConverterSpec:
    """The SRM's per-phase asymmetric half bridge, ``(N, n_phases)``
    actions: 0 freewheels (u = 0), 1 magnetises (+u_sup), 2 demagnetises
    (-u_sup, the current returns to the link).  No switching state: the
    supply current takes the current action."""
    _no_interlock(interlocking_time)

    def fracs(action, dtype):
        return (action == 1).to(dtype) - (action == 2).to(dtype)

    def u_frac(bridge_states, action, i_out):
        return fracs(action, i_out.dtype)

    def i_sup(bridge_states, action, i_out):
        return torch.sum(fracs(action, i_out.dtype) * i_out, dim=-1)

    return ConverterSpec(
        kind="Finite-ASYM", action_type="finite", action_space=("multidiscrete", [3] * n_phases),
        n_state=0, n_out=n_phases, n_in=n_phases,
        voltages=(-np.ones(n_phases), np.ones(n_phases)),
        currents=(np.zeros(n_phases), np.ones(n_phases)), interlocking_time=0.0, tau=tau,
        u_frac=u_frac, i_sup=i_sup, u_reset=np.zeros(n_phases),
        default_action=np.zeros(n_phases, dtype=int))


def cont_asymmetric_bridge_converter(tau=1e-4, n_phases=3,
                                     interlocking_time=0.0) -> ConverterSpec:
    """The dynamically averaged asymmetric bridge: the duty in [-1, 1] per
    phase (clipped) gives u = d u_sup, the supply current sum(d_k i_k)."""
    _no_interlock(interlocking_time)

    def u_frac(bridge_states, action, i_out):
        return torch.clamp(action, -1.0, 1.0)

    def i_sup(bridge_states, action, i_out):
        return torch.sum(torch.clamp(action, -1.0, 1.0) * i_out, dim=-1)

    return ConverterSpec(
        kind="Cont-ASYM", action_type="cont",
        action_space=("box", -np.ones(n_phases), np.ones(n_phases)), n_state=0, n_out=n_phases,
        n_in=n_phases, voltages=(-np.ones(n_phases), np.ones(n_phases)),
        currents=(np.zeros(n_phases), np.ones(n_phases)), interlocking_time=0.0, tau=tau,
        u_frac=u_frac, i_sup=i_sup, u_reset=np.zeros(n_phases),
        default_action=np.zeros(n_phases))


# the factory of each converter kind this package has, for the catalog's
# dict overrides (``converter=dict(tau=..., ...)``)
CONVERTER_FACTORIES = {
    "Finite-1QC": finite_one_quadrant_converter,
    "Finite-2QC": finite_two_quadrant_converter,
    "Finite-4QC": finite_four_quadrant_converter,
    "Finite-B6C": finite_b6_bridge_converter,
    "Cont-1QC": cont_one_quadrant_converter,
    "Cont-2QC": cont_two_quadrant_converter,
    "Cont-4QC": cont_four_quadrant_converter,
    "Cont-B6C": cont_b6_bridge_converter,
    "Finite-Multi": finite_multi_converter,
    "Cont-Multi": cont_multi_converter,
    "Finite-ASYM": finite_asymmetric_bridge_converter,
    "Cont-ASYM": cont_asymmetric_bridge_converter,
}
