"""Reward functions (counterpart of ``gym_electric_motor_tpu/rewards.py``).

``WeightedSumOfErrors`` reproduces weighted_sum_of_errors.py of the
reference as one elementwise expression over the normalised ``(N, S)``
state.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .utils.params import set_state_array


@dataclasses.dataclass
class WeightedSumOfErrors:
    reward_weights: Optional[object] = None  # dict | array | None
    normed_reward_weights: bool = False
    violation_reward: Optional[float] = None
    gamma: float = 0.9
    reward_power: object = 1
    bias: object = 0.0
    # bound at build time:
    _weights: np.ndarray = None
    _n: np.ndarray = None
    _state_length: np.ndarray = None
    _bias_value: float = None
    _violation_value: float = None
    reward_range: tuple = None

    def bind(self, state_names, state_space_low, state_space_high, referenced_states):
        """Resolve weights and powers against the physical system
        (weighted_sum_of_errors.py:88-123 of the reference)."""
        state_names = list(state_names)
        n_states = len(state_names)
        if self.reward_weights is None:
            if referenced_states.any():
                names = np.array(state_names)[referenced_states]
                weights = dict.fromkeys(names, 1.0 / len(names))
            else:
                weights = dict.fromkeys(state_names, 1.0 / n_states)
        else:
            weights = self.reward_weights
        w = set_state_array(weights, state_names)
        n = set_state_array(self.reward_power, state_names)
        state_length = np.asarray(state_space_high) - np.asarray(state_space_low)
        rw_sum = float(w.sum())
        bias = self.bias
        if self.normed_reward_weights:
            bias = 1.0 if bias == "positive" else bias
            w = w / rw_sum
            reward_range = (-1.0 + bias, bias)
        else:
            bias = rw_sum if bias == "positive" else bias
            reward_range = (-rw_sum + bias, bias)
        violation = self.violation_reward
        if violation is None:
            violation = min(reward_range[0] / (1.0 - self.gamma), 0.0)
        return dataclasses.replace(
            self, _weights=w, _n=n, _state_length=state_length,
            _bias_value=float(bias), _violation_value=float(violation),
            reward_range=reward_range)

    def reward(self, state, reference, k=None, action=None, violation_degree=0.0):
        """(1 - d) * r_wse + d * r_violation (weighted_sum_of_errors.py:125-129)."""
        w = torch.as_tensor(self._weights, dtype=state.dtype, device=state.device)
        length = torch.as_tensor(self._state_length, dtype=state.dtype, device=state.device)
        err = torch.abs(state - reference) / length
        if np.all(self._n == 1):
            powed = err
        elif np.all(self._n == 2):
            powed = err * err
        else:
            powed = err ** torch.as_tensor(self._n, dtype=state.dtype, device=state.device)
        wse = -torch.sum(w * powed, dim=-1) + self._bias_value
        return (1.0 - violation_degree) * wse + violation_degree * self._violation_value
