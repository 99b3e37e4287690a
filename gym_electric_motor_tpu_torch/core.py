"""Environment core on batched tensors.

Counterpart of ``gym_electric_motor_tpu/core.py``: ``ElectricMotorEnvironment``
wires a physical system, reference generator, reward function and
constraint monitor into

* ``reset(keys) -> (EnvState, obs)``
* ``step(EnvState, action) -> (EnvState, obs, reward, terminated)``

for a batch of envs: every tensor carries a leading env dimension (where
the JAX package vmaps a per-env function), and ``obs = (normalised state
(N, S), next reference observation (N, n_refs))``.  ``VectorEnv`` loops
these over time (where the JAX package scans).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .constraints import ConstraintMonitor
from .physical_systems import PhysicsState
from .references import ReferenceSpec, ScalarRefSpec
from .rewards import WeightedSumOfErrors
from .utils import rng

# ---------------------------------------------------------------------------
# Minimal space descriptors (gymnasium-compatible but dependency-free)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Discrete:
    n: int

    def sample(self, rng=None):
        rng = rng or np.random.default_rng()
        return int(rng.integers(self.n))

    def contains(self, x):
        return 0 <= int(x) < self.n

    @property
    def shape(self):
        return ()


@dataclasses.dataclass
class Box:
    low: np.ndarray
    high: np.ndarray

    def sample(self, rng=None):
        rng = rng or np.random.default_rng()
        u = rng.uniform(size=np.asarray(self.low).shape)
        low = np.nan_to_num(self.low, neginf=-1.0)
        high = np.nan_to_num(self.high, posinf=1.0)
        return low + u * (high - low)

    def contains(self, x):
        return bool(np.all(x >= self.low - 1e-9) and np.all(x <= self.high + 1e-9))

    @property
    def shape(self):
        return np.asarray(self.low).shape


def make_space(descriptor):
    kind = descriptor[0]
    if kind == "discrete":
        return Discrete(descriptor[1])
    if kind == "box":
        return Box(np.asarray(descriptor[1]), np.asarray(descriptor[2]))
    raise ValueError(descriptor)


# ---------------------------------------------------------------------------
# Env state
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class EnvState:
    phys: PhysicsState
    refs: tuple  # per-sub-generator state dicts
    system_state: torch.Tensor  # (N, S) normalised full state
    key: torch.Tensor  # (N, 2) per-env Philox key (seeds the next reset)
    step_count: torch.Tensor  # (N,) int32 steps in the current episode
    episode: torch.Tensor  # (N,) int32 episode counter


def _select(mask, a, b):
    """``where(mask, a, b)`` over matching nests of dataclasses, dicts,
    tuples and tensors; ``mask`` is ``(N,)`` and broadcasts along the
    trailing dimensions."""
    if isinstance(a, torch.Tensor):
        m = mask.reshape(mask.shape + (1,) * (a.dim() - 1))
        return torch.where(m, a, b)
    if isinstance(a, dict):
        return {k: _select(mask, a[k], b[k]) for k in a}
    if isinstance(a, tuple):
        return tuple(_select(mask, x, y) for x, y in zip(a, b))
    return type(a)(**{f.name: _select(mask, getattr(a, f.name), getattr(b, f.name))
                      for f in dataclasses.fields(a)})


class ElectricMotorEnvironment:
    """Functional environment: host-side wiring, batched tensor functions."""

    def __init__(
        self,
        physical_system,
        reference_generator,
        reward_function: Optional[WeightedSumOfErrors] = None,
        constraints=(),
        state_filter=None,
        constraint_monitor: Optional[ConstraintMonitor] = None,
        device=None,
    ):
        self.physical_system = ps = physical_system
        self.device = torch.device(device) if device is not None else None
        if isinstance(reference_generator, ScalarRefSpec):
            reference_generator = ReferenceSpec([reference_generator])
        self.reference_generator = reference_generator.bind(
            ps.state_names, ps.limits, ps.nominal_state, ps.state_space_low,
            ps.state_space_high, ps.tau,
        )
        self.reward_function = (reward_function or WeightedSumOfErrors()).bind(
            ps.state_names, ps.state_space_low, ps.state_space_high,
            self.reference_generator.referenced_states(),
        )
        if constraint_monitor is None:
            constraint_monitor = ConstraintMonitor(constraints=tuple(constraints))
        self.constraint_monitor = constraint_monitor.bind(
            ps.state_names, ps.limits, ps.state_space_high
        )
        self.state_names = list(ps.state_names)
        if state_filter is None:
            self._state_filter = np.arange(len(self.state_names))
        else:
            self._state_filter = np.array(
                [self.state_names.index(s) for s in state_filter], dtype=np.int64
            )
        self.tau = ps.tau
        self.limits = np.asarray(ps.limits)[self._state_filter]
        self.action_space = make_space(ps.action_space)
        lo, hi = self.reference_generator.reference_space()
        self.observation_space = (
            Box(np.asarray(ps.state_space_low)[self._state_filter],
                np.asarray(ps.state_space_high)[self._state_filter]),
            Box(lo, hi),
        )
        self.reference_names = self.reference_generator.reference_names

    def _observe(self, system_state, ref_obs):
        return system_state[:, list(self._state_filter)], ref_obs

    def reset(self, key):
        """core.py:300-319 of the reference.  ``key`` is ``(N, 2)``: ONE
        Philox pass mints the successor key, one key per reference
        generator and every module's uniform block."""
        n, device = key.shape[0], key.device
        rg = self.reference_generator
        n_phys, n_ref, n_subs = self.physical_system.reset_n_u, rg.reset_n_u, rg.n_refs
        words = rng.philox_words(key, 2 + 2 * n_subs + n_phys + n_ref, rng.TAG_RESET)
        k_next = words[:, :2]
        sub_keys = [words[:, 2 + 2 * i: 4 + 2 * i] for i in range(n_subs)]
        u = rng.bits_to_uniform(words[:, 2 + 2 * n_subs:])
        phys, system_state = self.physical_system.reset_from_u(u[:, :n_phys], n, device)
        refs, _ref_array, ref_obs = rg.reset_from(sub_keys, u[:, n_phys:], n, device)
        zeros = torch.zeros((n,), dtype=torch.int32, device=device)
        state = EnvState(phys=phys, refs=refs, system_state=system_state,
                         key=k_next, step_count=zeros, episode=zeros.clone())
        return state, self._observe(system_state, ref_obs)

    def step(self, state: EnvState, action):
        """core.py:328-371 of the reference: simulate, reference,
        constraints, reward, termination, next reference observation."""
        phys, system_state = self.physical_system.simulate(state.phys, action)
        ref_values = self.reference_generator.current_values(state.refs)
        reference = self.reference_generator.to_reference_array(ref_values)
        violation = self.constraint_monitor.check_constraints(system_state)
        reward = self.reward_function.reward(
            system_state, reference, state.phys.k, action, violation)
        terminated = violation >= 1.0
        refs, ref_obs = self.reference_generator.advance(state.refs)
        new_state = EnvState(phys=phys, refs=refs, system_state=system_state,
                             key=state.key, step_count=state.step_count + 1,
                             episode=state.episode)
        return new_state, self._observe(system_state, ref_obs), reward, terminated

    def step_autoreset(self, state: EnvState, action):
        """Step with episode auto-reset: a terminated env re-initialises
        from its key, and each reset mints its successor key (the
        per-episode reseeding of random_component.py:85-87)."""
        merged, obs, reward, terminated, _final = self.step_autoreset_full(state, action)
        return merged, obs, reward, terminated

    def step_autoreset_full(self, state: EnvState, action):
        """``step_autoreset`` that also returns the terminal observation
        the reset replaces.  Every step computes the reset and selects it
        where an env terminated, as the JAX package does; it reads nothing
        back to the host."""
        new_state, obs, reward, terminated = self.step(state, action)
        episode = state.episode + terminated.to(torch.int32)
        reset_state, reset_obs = self.reset(state.key)
        reset_state = dataclasses.replace(reset_state, episode=episode)
        merged = _select(terminated, reset_state, dataclasses.replace(new_state, episode=episode))
        return merged, _select(terminated, reset_obs, obs), reward, terminated, obs


def state_from_numpy(fields: dict, device, seed: int = 0) -> EnvState:
    """Build an ``EnvState`` from JAX ``EnvState`` fields taken out as numpy
    arrays (``jax.tree.map(np.asarray, state)``):

    ``ode_state``, ``conv_state``, ``sup_state``, ``t``, ``k`` (the
    ``phys`` fields), ``refs`` (a tuple of per-generator dicts),
    ``system_state``, ``step_count`` and ``episode``.

    The JAX env key is not carried over: the env keys come from ``seed``.
    A reference generator's two-word key is taken as its Philox key."""
    def f32(x):
        return torch.tensor(np.asarray(x, dtype=np.float32), device=device)

    def i32(x):
        return torch.tensor(np.asarray(x, dtype=np.int32), device=device)

    phys = PhysicsState(ode_state=f32(fields["ode_state"]), conv_state=i32(fields["conv_state"]),
                        sup_state=f32(fields["sup_state"]), t=f32(fields["t"]), k=i32(fields["k"]))
    n = phys.ode_state.shape[0]
    refs = []
    for r in fields["refs"]:
        refs.append(dict(
            value=f32(r["value"]), k=i32(r["k"]), ep_len=i32(r["ep_len"]), p=f32(r["p"]),
            key=torch.tensor(np.asarray(r["key"], dtype=np.uint32).astype(np.int64),
                             device=device),
            mlo=f32(r["mlo"]), mhi=f32(r["mhi"])))
    return EnvState(phys=phys, refs=tuple(refs), system_state=f32(fields["system_state"]),
                    key=rng.env_keys(seed, n, device), step_count=i32(fields["step_count"]),
                    episode=i32(fields["episode"]))


# ---------------------------------------------------------------------------
# Vectorized env
# ---------------------------------------------------------------------------


def random_policy(n_actions: int):
    """``policy_fn(obs, generator) -> (N,) int64`` uniform over ``n_actions``."""
    def policy_fn(obs, generator):
        state = obs[0]
        return torch.randint(0, n_actions, (state.shape[0],), generator=generator,
                             device=state.device)

    return policy_fn


class VectorEnv:
    """``n_envs`` independent envs stepped in lockstep on one device."""

    def __init__(self, env: ElectricMotorEnvironment, n_envs: int):
        self.env = env
        self.n_envs = n_envs
        self.device = env.device

    def reset(self, seed: int = 0):
        return self.env.reset(rng.env_keys(seed, self.n_envs, self.device))

    def step(self, state, actions):
        return self.env.step_autoreset(state, actions)

    def rollout(self, state, policy_fn, n_steps: int, generator: Optional[torch.Generator] = None):
        """Run ``n_steps`` with ``policy_fn(obs, generator) -> actions``;
        returns the final state plus the per-step reward sums and
        termination counts, both ``(n_steps,)`` tensors on the device."""
        rewards = torch.zeros((n_steps,), dtype=torch.float32, device=self.device)
        terms = torch.zeros((n_steps,), dtype=torch.int64, device=self.device)
        rg = self.env.reference_generator
        for t in range(n_steps):
            obs = (state.system_state[:, list(self.env._state_filter)],
                   rg.current_values(state.refs))
            actions = policy_fn(obs, generator)
            state, _obs, reward, terminated = self.step(state, actions)
            rewards[t] = reward.sum()
            terms[t] = terminated.sum()
        return state, rewards, terms
