"""Reference generators as batched stochastic processes (counterpart of the
Wiener and const parts of ``gym_electric_motor_tpu/references.py``).

A Wiener generator is a one-draw-per-step recurrence carried in the env
state, ``value' = clip(value + sigma * N(0, 1), margin)``
(wiener_process_reference_generator.py:30-49 of the reference), with the
sub-episode re-randomisation (length 500..2000, new sigma) applied where
``k`` reaches the sub-episode length.  The state of one scalar generator is
a dict of ``(N,)`` tensors ``value``, ``k``, ``ep_len``, ``mlo``, ``mhi``,
an ``(N, 6)`` parameter block ``p`` (``p[:, 0]`` = sigma) and an ``(N, 2)``
Philox key.  The other kinds (laplace, waveforms, switched) come with
slice 3 of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .utils import rng

P_SIGMA = 0
N_P = 6


@dataclasses.dataclass
class ScalarRefSpec:
    """One generator referencing one state variable."""

    kind: str  # 'wiener' | 'const'
    reference_state: str
    sigma_range: tuple = (1e-3, 1e-1)
    episode_lengths: tuple = (500, 2000)
    limit_margin: Optional[object] = None  # float | (lo, hi) | None
    initial_range: Optional[tuple] = None  # wiener only
    reference_value: float = 0.5  # const only
    # resolved at bind time:
    tau: float = None
    margin: tuple = None  # (lo, hi) floats
    state_index: int = None

    def __post_init__(self):
        if self.kind not in ("wiener", "const"):
            raise NotImplementedError(
                f"reference kind {self.kind!r} is not ported yet (wiener and "
                "const only); it arrives with slice 3 of the port")

    def bind(self, state_names, limits, nominal, state_space_low, state_space_high, tau):
        """Resolve limit margins against the physical system
        (subepisoded_reference_generator.py:46-66 of the reference)."""
        idx = list(state_names).index(self.reference_state)
        lo_s, hi_s = float(state_space_low[idx]), float(state_space_high[idx])
        if self.limit_margin is None:
            ratio = float(nominal[idx] / limits[idx])
            margin = (ratio * lo_s, ratio * hi_s)
        elif isinstance(self.limit_margin, (float, int)):
            margin = (float(self.limit_margin) * lo_s, float(self.limit_margin) * hi_s)
        else:
            margin = (float(self.limit_margin[0]) * lo_s, float(self.limit_margin[1]) * hi_s)
        bound = dataclasses.replace(self, tau=tau, margin=margin, state_index=idx)
        if bound.kind == "wiener" and bound.initial_range is None:
            bound = dataclasses.replace(bound, initial_range=margin)
        return bound

    @property
    def reset_n_u(self):
        """Uniforms one reset consumes."""
        return 0 if self.kind == "const" else 8

    def _draw_params(self, u):
        """Sub-episode length and sigma from uniforms ``u[:, 0]``, ``u[:, 1]``."""
        lo, hi = self.episode_lengths
        ep_len = torch.floor(float(lo) + (float(hi) - float(lo)) * u[:, 0]).to(torch.int32)
        log_r = np.log(np.asarray(self.sigma_range, dtype=np.float64))
        sigma = torch.exp(float(log_r[0]) + (float(log_r[1]) - float(log_r[0])) * u[:, 1])
        p = torch.zeros((u.shape[0], N_P), dtype=u.dtype, device=u.device)
        p[:, P_SIGMA] = sigma
        return ep_len, p

    def reset_from(self, key_state, u, n: int, device):
        """Reset from a pre-minted carried key ``(n, 2)`` and uniform block
        ``u: (n, reset_n_u)`` (None for const).  Returns (state, initial
        value, first observation)."""
        if self.kind == "const":
            value = torch.full((n,), float(self.reference_value), device=device)
            state = dict(value=value, k=torch.zeros((n,), dtype=torch.int32, device=device),
                         ep_len=torch.zeros((n,), dtype=torch.int32, device=device),
                         p=torch.zeros((n, N_P), device=device), key=key_state,
                         mlo=value.clone(), mhi=value.clone())
            return state, value, value
        mlo = torch.full((n,), float(self.margin[0]), device=device)
        mhi = torch.full((n,), float(self.margin[1]), device=device)
        lo, hi = self.initial_range
        value0 = (float(hi) - float(lo)) * u[:, 7] + float(lo)
        ep_len, p = self._draw_params(u)
        draw = p[:, P_SIGMA] * rng.normal_from_u(u[:, 6])
        obs = torch.clamp(value0 + draw, mlo, mhi)
        state = dict(value=obs, k=torch.ones((n,), dtype=torch.int32, device=device),
                     ep_len=ep_len, p=p, key=key_state, mlo=mlo, mhi=mhi)
        return state, value0, obs

    def advance(self, state):
        """One ``get_reference_observation`` step
        (subepisoded_reference_generator.py:96-105 of the reference):
        regenerate where the sub-episode ended, then emit the next value and
        increment ``k``.  One Philox pass per step gives the successor key
        and the 7 uniforms (u[0:2] for the regeneration, u[6] for the draw)."""
        if self.kind == "const":
            return state, state["value"]
        key_next, u = rng.split_and_uniforms(state["key"], 7)
        regen = state["k"] >= state["ep_len"]
        ep_len_new, p_new = self._draw_params(u)
        k = torch.where(regen, torch.zeros_like(state["k"]), state["k"])
        ep_len = torch.where(regen, ep_len_new, state["ep_len"])
        p = torch.where(regen[:, None], p_new, state["p"])
        draw = p[:, P_SIGMA] * rng.normal_from_u(u[:, 6])
        value = torch.clamp(state["value"] + draw, state["mlo"], state["mhi"])
        new = dict(value=value, k=k + 1, ep_len=ep_len, p=p, key=key_next,
                   mlo=state["mlo"], mhi=state["mhi"])
        return new, value


@dataclasses.dataclass
class ReferenceSpec:
    """Composite reference generator (``MultipleReferenceGenerator`` of the
    reference for more than one sub-generator)."""

    subs: list  # list[ScalarRefSpec]
    n_states: int = None
    ref_indices: np.ndarray = None

    @property
    def reference_names(self):
        return [s.reference_state for s in self.subs]

    @property
    def n_refs(self):
        return len(self.subs)

    def bind(self, state_names, limits, nominal, low, high, tau):
        subs = [s.bind(state_names, limits, nominal, low, high, tau) for s in self.subs]
        return dataclasses.replace(
            self, subs=subs, n_states=len(state_names),
            ref_indices=np.array([s.state_index for s in subs], dtype=np.int64))

    def referenced_states(self):
        mask = np.zeros(self.n_states, dtype=bool)
        if len(self.ref_indices):
            mask[self.ref_indices] = True
        return mask

    def reference_space(self):
        lo = np.array([s.margin[0] if s.kind != "const" else s.reference_value for s in self.subs])
        hi = np.array([s.margin[1] if s.kind != "const" else s.reference_value for s in self.subs])
        return lo, hi

    @property
    def reset_n_u(self):
        return sum(s.reset_n_u for s in self.subs)

    def reset_from(self, sub_keys, u, n: int, device):
        """Reset every sub from pre-minted keys and one uniform block (each
        sub's ``reset_n_u`` columns in order)."""
        states, values0, obs = [], [], []
        o = 0
        for s, k in zip(self.subs, sub_keys):
            m = s.reset_n_u
            st, v0, ob = s.reset_from(k, u[:, o:o + m] if m else None, n, device)
            o += m
            states.append(st)
            values0.append(v0)
            obs.append(ob)
        ref_array = self.to_reference_array(torch.stack(values0, dim=1))
        return tuple(states), ref_array, torch.stack(obs, dim=1)

    def advance(self, states):
        new_states, obs = [], []
        for s, st in zip(self.subs, states):
            st2, v = s.advance(st)
            new_states.append(st2)
            obs.append(v)
        return tuple(new_states), torch.stack(obs, dim=1)

    def current_values(self, states):
        return torch.stack([st["value"] for st in states], dim=1)

    def to_reference_array(self, values):
        """Place the ``(N, n_refs)`` values at their state positions of an
        ``(N, n_states)`` array, zeros elsewhere."""
        pos = {int(i): j for j, i in enumerate(self.ref_indices)}
        perm = [pos.get(i, len(self.subs)) for i in range(self.n_states)]
        padded = torch.cat([values, torch.zeros_like(values[:, :1])], dim=1)
        return padded[:, perm]


def WienerProcessReference(reference_state="omega", sigma_range=(1e-3, 1e-1),
                           initial_range=None, episode_lengths=(500, 2000),
                           limit_margin=None) -> ScalarRefSpec:
    return ScalarRefSpec("wiener", reference_state, sigma_range=sigma_range,
                         initial_range=initial_range, episode_lengths=episode_lengths,
                         limit_margin=limit_margin)


def ConstReference(reference_state="omega", reference_value=0.5) -> ScalarRefSpec:
    return ScalarRefSpec("const", reference_state, reference_value=reference_value)
