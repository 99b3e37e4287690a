"""Parameter-dict utilities: strict-key merging and mapping of
``{state_name: value}`` dicts onto state-ordered arrays (the port's own copy
of ``gym_electric_motor_tpu/utils/params.py``)."""

from __future__ import annotations

import numpy as np


def update_parameter_dict(source: dict, update: dict) -> dict:
    """Merge ``update`` into ``source``; unknown keys raise ``KeyError``."""
    unknown = set(update.keys()) - set(source.keys())
    if unknown:
        raise KeyError(f"Invalid parameter keys: {sorted(unknown)}")
    merged = dict(source)
    merged.update(update)
    return merged


def set_state_array(input_values, state_names) -> np.ndarray:
    """Build a state-ordered numpy array from a dict / scalar / sequence:
    dict entries land at the positions of their state names, scalars
    broadcast, sequences must match the state count."""
    state_names = list(state_names)
    if isinstance(input_values, dict):
        out = np.zeros(len(state_names), dtype=np.float64)
        for key, value in input_values.items():
            key = key.lower()
            if key not in state_names:
                raise KeyError(f"Unknown state name {key!r}; valid: {state_names}")
            out[state_names.index(key)] = value
        return out
    if np.isscalar(input_values):
        return np.full(len(state_names), float(input_values), dtype=np.float64)
    arr = np.asarray(input_values, dtype=np.float64)
    if arr.shape != (len(state_names),):
        raise ValueError(
            f"State array shape {arr.shape} does not match state count {len(state_names)}"
        )
    return arr
