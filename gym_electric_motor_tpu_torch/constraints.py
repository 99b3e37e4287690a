"""Constraints and the constraint monitor (counterpart of
``gym_electric_motor_tpu/constraints.py``).

Every check reduces the normalised ``(N, S)`` state to an ``(N,)``
violation degree in [0, 1]; the monitor merges the degrees ('max' |
'product' | callable) and a merged degree >= 1 terminates the episode.  A
bare callable constraint and a callable merge act on one env, as under the
JAX package's ``jax.vmap`` of ``env.step``: the monitor maps them over the
batch with ``torch.vmap``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class LimitConstraint:
    """1.0 if any observed |state_i| > 1 (constraints.py:32-68 of the reference)."""

    observed_state_names: object = "all_states"
    _mask: np.ndarray = None

    def bind(self, state_names, limits, state_space_high):
        names = self.observed_state_names
        if names == "all_states" or "all_states" in names:
            names = list(state_names)
        mask = np.zeros(len(state_names), dtype=bool)
        for n in names or []:
            mask[list(state_names).index(n)] = True
        return dataclasses.replace(self, _mask=mask)

    def __call__(self, state):
        mask = torch.as_tensor(self._mask, device=state.device)
        violated = torch.any(mask & (torch.abs(state) > 1.0), dim=-1)
        return violated.to(state.dtype)


@dataclasses.dataclass
class SquaredConstraint:
    """1.0 if sum_i (s_i / s_max)^2 > 1 over the observed states
    (constraints.py:71-98 of the reference): the dq current circle."""

    states: tuple = ()
    _indices: np.ndarray = None
    _limits: np.ndarray = None
    _normalized: bool = True

    def bind(self, state_names, limits, state_space_high):
        idx = np.array([list(state_names).index(s) for s in self.states], dtype=np.int64)
        lims = np.asarray(limits)[idx]
        normalized = not np.all(np.asarray(state_space_high)[idx] == lims)
        return dataclasses.replace(self, _indices=idx, _limits=lims, _normalized=normalized)

    def __call__(self, state):
        s = state[:, list(self._indices)]
        if not self._normalized:
            s = s / torch.as_tensor(self._limits, dtype=state.dtype, device=state.device)
        return (torch.sum(s * s, dim=-1) > 1.0).to(state.dtype)


@dataclasses.dataclass
class ConstraintMonitor:
    """Merges per-constraint violation degrees (core.py:756-844 of the reference)."""

    constraints: tuple = ()
    merge_violations: object = "max"  # 'max' | 'product' | callable

    def bind(self, state_names, limits, state_space_high):
        bound = []
        for c in self.constraints:
            if isinstance(c, str):
                c = LimitConstraint((c,))
            if hasattr(c, "bind"):
                c = c.bind(state_names, limits, state_space_high)
            bound.append(c)
        return dataclasses.replace(self, constraints=tuple(bound))

    def check_constraints(self, state):
        if not self.constraints:
            return torch.zeros(state.shape[:1], dtype=state.dtype, device=state.device)
        degrees = torch.stack([_degrees(c, state) for c in self.constraints], dim=-1)
        if self.merge_violations == "max":
            return torch.max(degrees, dim=-1).values
        if self.merge_violations == "product":
            return 1.0 - torch.prod(1.0 - degrees, dim=-1)
        return torch.vmap(self.merge_violations)(degrees)


def _degrees(constraint, state):
    """The ``(N,)`` violation degrees of one constraint: the batched checks
    above take the whole ``(N, S)`` state, a bare callable one env's
    ``(S,)`` state at a time."""
    if isinstance(constraint, (LimitConstraint, SquaredConstraint)):
        return constraint(state)
    return torch.vmap(constraint)(state).to(state.dtype)
