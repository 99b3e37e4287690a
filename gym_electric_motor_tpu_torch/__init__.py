"""gym_electric_motor_tpu_torch — the PyTorch/CUDA port of
``gym_electric_motor_tpu``.

A batched functional env on torch tensors (a leading env dimension where
the JAX package vmaps) plus hand-written CUDA kernels for the fused
rollouts, built with nvcc for Hopper (sm_90a) at first use.  Entry points
run on ``cuda`` unless the caller passes ``device="cpu"``.  The package
imports neither ``jax`` nor ``gym_electric_motor_tpu``.
"""

__version__ = "0.1.0"

from . import constraints, core, ops, physical_systems, references, rewards, wrappers
from .core import (ElectricMotorEnvironment, VectorEnv, random_box_policy, random_cont_policy,
                   random_multidiscrete_policy, random_policy, random_policy_for,
                   state_from_numpy)
from .envs import (DC_ENV_IDS, DFIM_ENV_IDS, EESM_ENV_IDS, ENV_IDS, SCIM_ENV_IDS,
                   SRM_ENV_IDS, SYNC_ENV_IDS, make, make_functional)

__all__ = [
    "DC_ENV_IDS",
    "DFIM_ENV_IDS",
    "EESM_ENV_IDS",
    "ENV_IDS",
    "SCIM_ENV_IDS",
    "SRM_ENV_IDS",
    "SYNC_ENV_IDS",
    "ElectricMotorEnvironment",
    "VectorEnv",
    "constraints",
    "core",
    "make",
    "make_functional",
    "ops",
    "physical_systems",
    "random_box_policy",
    "random_cont_policy",
    "random_multidiscrete_policy",
    "random_policy",
    "random_policy_for",
    "references",
    "rewards",
    "state_from_numpy",
    "wrappers",
]
