"""Environment catalog (counterpart of ``gym_electric_motor_tpu/envs/catalog.py``).

The env-id grammar is ``{Finite|Cont}-{CC|TC|SC}-{Motor}-v0``.  This
package serves the twelve synchronous ids (``{Finite, Cont} x {CC, TC, SC}
x {PMSM, SynRM}``) so far; every other id of the JAX catalog raises
``NotImplementedError`` naming the step of queue 1, slice 3 of the port
that brings it.  The default tables below are this package's own copy of
the PMSM and SynRM rows of the JAX package's tables.
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
_SYNC_MOTORS = ["PMSM", "SynRM"]

ENV_IDS = [f"{a}-{t}-{m}-v0" for m in _SYNC_MOTORS for t in _TASKS for a in _ACTIONS]

# the step of queue 1, slice 3 that brings each family not served yet
_FAMILY_STEP = {"PermExDc": "DC", "ExtExDc": "DC", "SeriesDc": "DC", "ShuntDc": "DC",
                "SCIM": "SCIM", "EESM": "EESM", "DFIM": "DFIM", "SRM": "SRM"}

# supply voltage exceptions of the synchronous rows (the rest: 420 V)
_SUPPLY_U = {("Cont", "CC", "PMSM"): 300.0}
# PolynomialStaticLoad of the SC tasks (no synchronous row in the JAX
# package's table, so its default applies)
_SC_LOAD = dict(a=0.01, b=0.01, c=0.0, j_load=1e-5)
# Wiener sigma ranges the reference envs set (else (1e-3, 1e-1))
_REF_SIGMA = {("SC", "SynRM"): (1e-3, 1e-2)}


def _parse_env_id(env_id):
    """``(action, task, motor)`` of a served env id."""
    parts = env_id.split("-")
    if len(parts) != 4 or parts[0] not in _ACTIONS or parts[1] not in _TASKS \
            or parts[2] not in _MOTORS or parts[3] != "v0":
        raise KeyError(f"Unknown env id {env_id!r}; valid ids: {{Finite|Cont}}-{{CC|TC|SC}}-"
                       f"{{{'|'.join(_MOTORS)}}}-v0")
    if env_id not in ENV_IDS:
        raise NotImplementedError(
            f"{env_id!r} is not ported yet: this package serves the 12 synchronous "
            f"ids; the {_FAMILY_STEP[parts[2]]} family arrives with its step of "
            "queue 1, slice 3 of the port")
    return parts[0], parts[1], parts[2]


def _default_converter(action, tau):
    return (cv.finite_b6_bridge_converter(tau) if action == "Finite"
            else cv.cont_b6_bridge_converter(tau))


def _default_references(task, motor):
    sig = _REF_SIGMA.get((task, motor), (1e-3, 1e-1))
    if task == "SC":
        return rg.ReferenceSpec([rg.WienerProcessReference("omega", sigma_range=sig)])
    if task == "TC":
        return rg.ReferenceSpec([rg.WienerProcessReference("torque", sigma_range=sig)])
    return rg.ReferenceSpec([rg.WienerProcessReference("i_sd"), rg.WienerProcessReference("i_sq")])


def _default_reward(task):
    if task == "SC":
        return WeightedSumOfErrors(reward_weights=dict(omega=1.0))
    if task == "TC":
        return WeightedSumOfErrors(reward_weights=dict(torque=1.0))
    return WeightedSumOfErrors(reward_weights=dict(i_sd=0.5, i_sq=0.5))


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
    control_space="abc",
    dtype=torch.float32,
    physical_system_wrappers=(),
    device=None,
) -> ElectricMotorEnvironment:
    """Build the functional environment for a catalog env id on ``device``
    (default ``cuda``).  Components may be overridden with spec instances,
    or with dicts of keyword overrides for the supply, motor and load (the
    env-arg pattern of utils.py:5-16 of the reference).  ``control_space``
    must be ``"abc"`` and ``physical_system_wrappers`` empty: the dq
    control space and the wrappers are not ported yet."""
    action, task, motor_name = _parse_env_id(env_id)
    if physical_system_wrappers:
        names = [type(w).__name__ for w in physical_system_wrappers]
        raise NotImplementedError(
            f"physical-system wrappers {names} are not ported yet; they arrive "
            "with slice 4 of the port")
    device = resolve_device(device)
    tau = tau if tau is not None else (1e-5 if action == "Finite" else 1e-4)

    u_sup = _SUPPLY_U.get((action, task, motor_name), 420.0)
    if isinstance(supply, dict):
        supply = sp.ideal_voltage_supply(**{"u_nominal": u_sup, **supply})
    else:
        supply = supply or sp.ideal_voltage_supply(u_sup)
    converter = converter or _default_converter(action, tau)
    if isinstance(motor, dict):
        motor_spec = mt.MOTOR_FACTORIES[motor_name](**motor)
    else:
        motor_spec = motor or mt.MOTOR_FACTORIES[motor_name]()
    if isinstance(load, dict):
        if task == "SC":
            load = ld.polynomial_static_load({**_SC_LOAD, **load.get("load_parameter", load)})
        else:
            load = ld.constant_speed_load(**load)
    elif load is None:
        load = (ld.polynomial_static_load(dict(_SC_LOAD)) if task == "SC"
                else ld.constant_speed_load(omega_fixed=100.0))
    reference_generator = reference_generator or _default_references(task, motor_name)
    reward_function = reward_function or _default_reward(task)
    if constraints is None:
        constraints = (SquaredConstraint(("i_sq", "i_sd")),)

    system = SynchronousMotorSystem(supply=supply, converter=converter, motor=motor_spec,
                                    load=load, tau=tau, solver=solver, substeps=substeps,
                                    dtype=dtype, control_space=control_space)
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
