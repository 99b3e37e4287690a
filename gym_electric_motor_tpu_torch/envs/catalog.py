"""Environment catalog (counterpart of ``gym_electric_motor_tpu/envs/catalog.py``).

The env-id grammar is ``{Finite|Cont}-{CC|TC|SC}-{Motor}-v0``.  This
package serves the Finite-CC synchronous ids so far; every other id of the
JAX catalog raises ``NotImplementedError`` naming the slice of the port
that brings it.  The defaults in ``make_functional`` are this package's
own copy of the PMSM and SynRM rows of the JAX package's tables.
"""

from __future__ import annotations

import torch

from .. import references as rg
from ..constraints import SquaredConstraint
from ..core import ElectricMotorEnvironment, VectorEnv
from ..models import converters as cv
from ..models import loads as ld
from ..models import motors as mt
from ..models import supplies as sp
from ..physical_systems import SynchronousMotorSystem
from ..rewards import WeightedSumOfErrors

_MOTORS = ["PermExDc", "ExtExDc", "SeriesDc", "ShuntDc", "PMSM", "EESM", "SynRM", "SCIM", "DFIM", "SRM"]
_TASKS = ["CC", "TC", "SC"]
_ACTIONS = ["Finite", "Cont"]

ENV_IDS = ["Finite-CC-PMSM-v0", "Finite-CC-SynRM-v0"]


def _parse_env_id(env_id):
    """The motor name of a served env id."""
    parts = env_id.split("-")
    if len(parts) != 4 or parts[0] not in _ACTIONS or parts[1] not in _TASKS \
            or parts[2] not in _MOTORS or parts[3] != "v0":
        raise KeyError(f"Unknown env id {env_id!r}; valid ids: {{Finite|Cont}}-{{CC|TC|SC}}-"
                       f"{{{'|'.join(_MOTORS)}}}-v0")
    if env_id not in ENV_IDS:
        raise NotImplementedError(
            f"{env_id!r} is not ported yet: this package serves {ENV_IDS}; the "
            "rest of the catalog arrives with slice 3 of the port")
    return parts[2]


def resolve_device(device):
    """The device an entry point runs on: ``cuda`` unless the caller names
    one.  Without a GPU and without an explicit device this raises; it
    never falls back to the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' explicitly to "
            "run this package on the CPU")
    return torch.device("cuda")


def make_functional(
    env_id: str,
    supply=None,
    converter=None,
    motor=None,
    load=None,
    reference_generator=None,
    reward_function=None,
    constraints=None,
    state_filter=None,
    tau=None,
    solver="rk4",
    substeps=1,
    dtype=torch.float32,
    device=None,
) -> ElectricMotorEnvironment:
    """Build the functional environment for a catalog env id on ``device``
    (default ``cuda``).  Components may be overridden with spec instances,
    or with dicts of keyword overrides for the supply, motor and load (the
    env-arg pattern of utils.py:5-16 of the reference)."""
    motor_name = _parse_env_id(env_id)
    device = resolve_device(device)
    tau = tau if tau is not None else 1e-5

    if isinstance(supply, dict):
        supply = sp.ideal_voltage_supply(**{"u_nominal": 420.0, **supply})
    else:
        supply = supply or sp.ideal_voltage_supply(420.0)
    converter = converter or cv.finite_b6_bridge_converter(tau)
    if isinstance(motor, dict):
        motor_spec = mt.MOTOR_FACTORIES[motor_name](**motor)
    else:
        motor_spec = motor or mt.MOTOR_FACTORIES[motor_name]()
    if isinstance(load, dict):
        load = ld.constant_speed_load(**load)
    elif load is None:
        load = ld.constant_speed_load(omega_fixed=100.0)
    reference_generator = reference_generator or rg.ReferenceSpec(
        [rg.WienerProcessReference("i_sd"), rg.WienerProcessReference("i_sq")])
    reward_function = reward_function or WeightedSumOfErrors(reward_weights=dict(i_sd=0.5, i_sq=0.5))
    if constraints is None:
        constraints = (SquaredConstraint(("i_sq", "i_sd")),)

    system = SynchronousMotorSystem(supply=supply, converter=converter, motor=motor_spec,
                                    load=load, tau=tau, solver=solver, substeps=substeps,
                                    dtype=dtype)
    return ElectricMotorEnvironment(
        physical_system=system,
        reference_generator=reference_generator,
        reward_function=reward_function,
        constraints=constraints,
        state_filter=state_filter,
        device=device,
    )


def make(env_id: str, n_envs=None, **kwargs):
    """``VectorEnv`` of ``n_envs`` envs around :func:`make_functional`.

    The single-env gymnasium adapter comes with slice 7 of the port."""
    if not n_envs:
        raise NotImplementedError(
            "make() without n_envs returns the single-env gymnasium adapter, "
            "which arrives with slice 7 of the port; pass n_envs")
    env = make_functional(env_id, **kwargs)
    return VectorEnv(env, n_envs)
