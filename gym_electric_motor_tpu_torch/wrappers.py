"""Physical-system wrappers (counterpart of the base wrapper and
``CurrentSumProcessor`` of ``gym_electric_motor_tpu/wrappers.py``).

A wrapper composes around a physical system: it rewrites the state-vector
metadata on the host and the batched ``reset_from_u`` / ``simulate``
functions.  The physics state passes through unchanged (``CurrentSumProcessor``
carries no state of its own).  The other wrappers (CosSin, DeadTime,
FluxObserver, StateNoise, DqToAbc) come with slice 4 of the port.
"""

from __future__ import annotations

import numpy as np
import torch


class PhysicalSystemWrapper:
    """Base delegating wrapper (physical_system_wrapper.py:6-129 of the
    reference)."""

    def __init__(self, physical_system=None):
        self.inner = None
        if physical_system is not None:
            self.set_physical_system(physical_system)

    def set_physical_system(self, physical_system):
        self.inner = physical_system
        self.state_names = list(physical_system.state_names)
        self.state_positions = {n: i for i, n in enumerate(self.state_names)}
        self.limits = np.asarray(physical_system.limits)
        self.nominal_state = np.asarray(physical_system.nominal_state)
        self.state_space_low = np.asarray(physical_system.state_space_low)
        self.state_space_high = np.asarray(physical_system.state_space_high)
        return self

    # -- delegated metadata --

    @property
    def tau(self):
        return self.inner.tau

    @property
    def action_space(self):
        return self.inner.action_space

    @property
    def load(self):
        return self.inner.load

    @property
    def motor(self):
        return self.inner.motor

    @property
    def converter(self):
        return self.inner.converter

    @property
    def supply(self):
        return self.inner.supply

    @property
    def dtype(self):
        return self.inner.dtype

    @property
    def unwrapped(self):
        return self.inner.unwrapped if isinstance(self.inner, PhysicalSystemWrapper) else self.inner

    @property
    def reset_n_u(self):
        return self.inner.reset_n_u

    # -- batched functions (default: passthrough) --

    def _transform(self, system_state):
        return system_state

    def reset_from_u(self, u, n: int, device):
        state, system_state = self.inner.reset_from_u(u, n, device)
        return state, self._transform(system_state)

    def simulate(self, state, action, noise=None):
        state, system_state = self.inner.simulate(state, action, noise)
        return state, self._transform(system_state)


class CurrentSumProcessor(PhysicalSystemWrapper):
    """Appends ``i_sum``, the sum of the named (normalised) currents, with
    the largest (``limit="max"``) or the summed limit of those currents
    (current_sum_processor.py:7-66 of the reference)."""

    def __init__(self, currents, limit="max", physical_system=None):
        self._currents = tuple(currents)
        if limit not in ("max", "sum"):
            raise ValueError(f"limit must be 'max' or 'sum', got {limit!r}")
        self._limit = max if limit == "max" else np.sum
        super().__init__(physical_system)

    def set_physical_system(self, physical_system):
        super().set_physical_system(physical_system)
        self._idx = [physical_system.state_positions[c] for c in self._currents]
        lim = self._limit(self.limits[self._idx])
        nom = self._limit(self.nominal_state[self._idx])
        self.limits = np.concatenate([self.limits, [lim]])
        self.nominal_state = np.concatenate([self.nominal_state, [nom]])
        self.state_space_low = np.concatenate([self.state_space_low, [-1.0]])
        self.state_space_high = np.concatenate([self.state_space_high, [1.0]])
        self.state_names = self.state_names + ["i_sum"]
        self.state_positions = {n: i for i, n in enumerate(self.state_names)}
        return self

    def _transform(self, system_state):
        s = torch.sum(system_state[:, self._idx], dim=1, keepdim=True)
        return torch.cat([system_state, s], dim=1)


def apply_wrappers(physical_system, wrappers):
    """Wrap ``physical_system`` in ``wrappers``, innermost first."""
    for w in wrappers:
        physical_system = w.set_physical_system(physical_system)
    return physical_system
