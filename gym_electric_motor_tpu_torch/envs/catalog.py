"""Environment catalog (counterpart of ``gym_electric_motor_tpu/envs/catalog.py``).

The env-id grammar is ``{Finite|Cont}-{CC|TC|SC}-{Motor}-v0``.  This
package serves all 60 ids of the JAX catalog: the DC, synchronous,
externally excited synchronous, squirrel-cage induction, doubly fed
induction and switched reluctance families (``{Finite, Cont} x {CC, TC, SC} x {PermExDc,
SeriesDc, ShuntDc, ExtExDc, PMSM, SynRM, EESM, SCIM, DFIM, SRM}``).  The
default tables below are this package's own copy of the JAX package's
tables.
"""

from __future__ import annotations

import torch

from .. import references as rg
from ..constraints import LimitConstraint, SquaredConstraint
from ..core import ElectricMotorEnvironment, VectorEnv
from ..models import converters as cv
from ..models import loads as ld
from ..models import motors as mt
from ..models import supplies as sp
from ..physical_systems import (DcMotorSystem, DFIMSystem, EESMSystem, SCIMSystem, SRMSystem,
                                SynchronousMotorSystem)
from ..rewards import WeightedSumOfErrors
from ..utils.device import resolve_device
from ..wrappers import CurrentSumProcessor, apply_wrappers

_MOTORS = ["PermExDc", "ExtExDc", "SeriesDc", "ShuntDc", "PMSM", "EESM", "SynRM", "SCIM", "DFIM", "SRM"]
_TASKS = ["CC", "TC", "SC"]
_ACTIONS = ["Finite", "Cont"]
_DC_MOTORS = ["PermExDc", "ExtExDc", "SeriesDc", "ShuntDc"]
_SYNC_MOTORS = ["PMSM", "SynRM"]
# the motors on one B6 bridge
_B6_MOTORS = _SYNC_MOTORS + ["SCIM"]
# the motors with Wiener references on (i_sd, i_sq) at their default sigma
# for CC: the DFIM takes them too, on its own dual-B6 converter
_DQ_CC_MOTORS = _B6_MOTORS + ["DFIM"]

DC_ENV_IDS = [f"{a}-{t}-{m}-v0" for m in _DC_MOTORS for t in _TASKS for a in _ACTIONS]
SYNC_ENV_IDS = [f"{a}-{t}-{m}-v0" for m in _SYNC_MOTORS for t in _TASKS for a in _ACTIONS]
SCIM_ENV_IDS = [f"{a}-{t}-SCIM-v0" for t in _TASKS for a in _ACTIONS]
EESM_ENV_IDS = [f"{a}-{t}-EESM-v0" for t in _TASKS for a in _ACTIONS]
DFIM_ENV_IDS = [f"{a}-{t}-DFIM-v0" for t in _TASKS for a in _ACTIONS]
SRM_ENV_IDS = [f"{a}-{t}-SRM-v0" for t in _TASKS for a in _ACTIONS]
ENV_IDS = DC_ENV_IDS + SYNC_ENV_IDS + SCIM_ENV_IDS + EESM_ENV_IDS + DFIM_ENV_IDS + SRM_ENV_IDS

# supply voltage exceptions (the rest: 60 V for DC, 400 V for the SRM, 420 V
# otherwise)
_SUPPLY_U = {("Finite", "CC", "SeriesDc"): 420.0, ("Finite", "TC", "SeriesDc"): 420.0,
             ("Cont", "CC", "PMSM"): 300.0, ("Cont", "CC", "EESM"): 300.0}
# PolynomialStaticLoad of the SC tasks (else _SC_LOAD_DEFAULT)
_SC_LOAD = {
    ("Finite", "PermExDc"): dict(a=0.0, b=0.0, c=0.0, j_load=1e-3),
    ("Cont", "PermExDc"): dict(a=0.0, b=0.0, c=0.0, j_load=1e-4),
    ("Finite", "ExtExDc"): dict(a=0.0, b=0.0, c=0.0, j_load=1e-4),
    ("Cont", "ExtExDc"): dict(a=0.0, b=0.0, c=0.0, j_load=1e-4),
    ("Finite", "SeriesDc"): dict(a=0.15, b=0.05, c=0.0, j_load=1e-4),
    ("Cont", "SeriesDc"): dict(a=0.01, b=0.05, c=0.0, j_load=1e-4),
    ("Finite", "ShuntDc"): dict(a=0.05, b=0.01, c=0.0, j_load=1e-4),
    ("Cont", "ShuntDc"): dict(a=0.05, b=0.01, c=0.0, j_load=1e-4),
}
_SC_LOAD_DEFAULT = dict(a=0.01, b=0.01, c=0.0, j_load=1e-5)
# Wiener sigma ranges the reference envs set (else (1e-3, 1e-1))
_REF_SIGMA = {
    ("CC", "PermExDc"): (1e-2, 1e-1),
    ("TC", "PermExDc"): (1e-2, 1e-1),
    ("SC", "PermExDc", "Cont"): (1e-3, 5e-2),
    ("SC", "PermExDc", "Finite"): (1e-3, 5e-3),
    ("SC", "SeriesDc", "Cont"): (1e-3, 2e-2),
    ("SC", "SeriesDc", "Finite"): (1e-3, 5e-3),
    ("SC", "ShuntDc", "Cont"): (1e-3, 3e-2),
    ("SC", "ShuntDc", "Finite"): (1e-3, 5e-3),
    ("SC", "SynRM"): (1e-3, 1e-2),
    ("SC", "SCIM"): (1e-3, 1e-2),
    ("SC", "DFIM"): (1e-3, 1e-2),
}


def _parse_env_id(env_id):
    """``(action, task, motor)`` of a catalog env id."""
    parts = env_id.split("-")
    if len(parts) != 4 or parts[0] not in _ACTIONS or parts[1] not in _TASKS \
            or parts[2] not in _MOTORS or parts[3] != "v0":
        raise KeyError(f"Unknown env id {env_id!r}; valid ids: {{Finite|Cont}}-{{CC|TC|SC}}-"
                       f"{{{'|'.join(_MOTORS)}}}-v0")
    return parts[0], parts[1], parts[2]


def _supply_u(action, task, motor):
    if (action, task, motor) in _SUPPLY_U:
        return _SUPPLY_U[(action, task, motor)]
    if motor in _DC_MOTORS:
        return 60.0
    return 400.0 if motor == "SRM" else 420.0


def _sigma_for(task, motor, action):
    for key in ((task, motor, action), (task, motor)):
        if key in _REF_SIGMA:
            return _REF_SIGMA[key]
    return (1e-3, 1e-1)


def _default_converter(action, motor, tau):
    b6 = cv.finite_b6_bridge_converter if action == "Finite" else cv.cont_b6_bridge_converter
    if motor in _B6_MOTORS:
        return b6(tau)
    if motor == "SRM":
        return (cv.finite_asymmetric_bridge_converter(tau) if action == "Finite"
                else cv.cont_asymmetric_bridge_converter(tau))
    multi = cv.finite_multi_converter if action == "Finite" else cv.cont_multi_converter
    if motor == "DFIM":
        # the stator and the rotor B6 bridge
        return multi([b6(tau), b6(tau)], tau)
    four_qc = (cv.finite_four_quadrant_converter if action == "Finite"
               else cv.cont_four_quadrant_converter)
    if motor not in ("ExtExDc", "EESM"):
        return four_qc(tau)
    # ExtExDc: armature and excitation 4QC; EESM: the stator B6 bridge and
    # the excitation 4QC
    return multi([b6(tau) if motor == "EESM" else four_qc(tau), four_qc(tau)], tau)


def _default_references(task, motor, action):
    sig = _sigma_for(task, motor, action)
    if task == "SC":
        return rg.ReferenceSpec([rg.WienerProcessReference("omega", sigma_range=sig)])
    if task == "TC":
        margin = (0, 0.8) if (motor, action) == ("ShuntDc", "Cont") else None
        return rg.ReferenceSpec([rg.WienerProcessReference("torque", sigma_range=sig,
                                                           limit_margin=margin)])
    if motor == "EESM":
        return rg.ReferenceSpec([rg.WienerProcessReference("i_sd"),
                                 rg.WienerProcessReference("i_sq"),
                                 rg.WienerProcessReference("i_e", limit_margin=(0, 1))])
    if motor == "SRM":
        # unipolar phase currents: the references live in [0, 1]
        return rg.ReferenceSpec([rg.WienerProcessReference(n, sigma_range=sig,
                                                           limit_margin=(0, 1))
                                 for n in ("i_a", "i_b", "i_c")])
    names = {"PermExDc": ["i"], "SeriesDc": ["i"], "ShuntDc": ["i_a"],
             "ExtExDc": ["i_a", "i_e"]}.get(motor, ["i_sd", "i_sq"])
    if motor in _DQ_CC_MOTORS:
        return rg.ReferenceSpec([rg.WienerProcessReference(n) for n in names])
    return rg.ReferenceSpec([rg.WienerProcessReference(n, sigma_range=sig) for n in names])


def _default_reward(task, motor):
    if task == "SC":
        return WeightedSumOfErrors(reward_weights=dict(omega=1.0))
    if task == "TC":
        return WeightedSumOfErrors(reward_weights=dict(torque=1.0))
    weights = {"PermExDc": dict(i=1.0), "SeriesDc": dict(i=1.0), "ShuntDc": dict(i_a=1.0),
               "ExtExDc": dict(i_a=0.5, i_e=0.5),
               "EESM": dict(i_sd=1 / 3, i_sq=1 / 3, i_e=1 / 3),
               "SRM": dict(i_a=1 / 3, i_b=1 / 3, i_c=1 / 3)}.get(motor, dict(i_sd=0.5, i_sq=0.5))
    return WeightedSumOfErrors(reward_weights=weights)


def _default_constraints(motor):
    if motor in ("PermExDc", "SeriesDc"):
        return (LimitConstraint(("i",)),)
    if motor in ("ShuntDc", "ExtExDc"):
        return (LimitConstraint(("i_a",)), LimitConstraint(("i_e",)))
    if motor == "EESM":
        return (SquaredConstraint(("i_sq", "i_sd")), LimitConstraint(("i_e",)))
    if motor == "SRM":
        return (LimitConstraint(("i_a", "i_b", "i_c")),)
    return (SquaredConstraint(("i_sq", "i_sd")),)


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
    or with dicts of keyword overrides for the supply, converter, motor and
    load (the env-arg pattern of utils.py:5-16 of the reference; a
    converter dict is merged into the default converter's factory, and a
    multi converter keeps its default, as in the JAX package).  ``control_space``
    must be ``"abc"``, and ``physical_system_wrappers`` may hold
    ``CurrentSumProcessor`` only: the dq control space and the other
    wrappers are not ported yet.  A ShuntDc env appends its default
    ``CurrentSumProcessor(("i_a", "i_e"))``, as the JAX package does."""
    action, task, motor_name = _parse_env_id(env_id)
    wrappers = tuple(physical_system_wrappers)
    unported = [type(w).__name__ for w in wrappers if not isinstance(w, CurrentSumProcessor)]
    if unported:
        raise NotImplementedError(
            f"physical-system wrappers {unported} are not ported yet (CurrentSumProcessor "
            "only); they arrive with slice 4 of the port")
    device = resolve_device(device)
    tau = tau if tau is not None else (1e-5 if action == "Finite" else 1e-4)

    u_sup = _supply_u(action, task, motor_name)
    if isinstance(supply, dict):
        supply = sp.ideal_voltage_supply(**{"u_nominal": u_sup, **supply})
    else:
        supply = supply or sp.ideal_voltage_supply(u_sup)
    if isinstance(converter, dict):
        # merged into the default converter's factory; a multi converter
        # keeps its default (catalog.py:256-260 of the JAX package)
        default_conv = _default_converter(action, motor_name, tau)
        converter = (default_conv if "Multi" in default_conv.kind
                     else cv.CONVERTER_FACTORIES[default_conv.kind](tau=tau, **converter))
    else:
        converter = converter or _default_converter(action, motor_name, tau)
    if isinstance(motor, dict):
        motor_spec = mt.MOTOR_FACTORIES[motor_name](**motor)
    else:
        motor_spec = motor or mt.MOTOR_FACTORIES[motor_name]()
    sc_load = _SC_LOAD.get((action, motor_name), _SC_LOAD_DEFAULT)
    if isinstance(load, dict):
        if task == "SC":
            load = ld.polynomial_static_load({**sc_load, **load.get("load_parameter", load)})
        else:
            load = ld.constant_speed_load(**load)
    elif load is None:
        omega_fixed = 230.0 if (motor_name, task, action) == ("ShuntDc", "TC", "Cont") else 100.0
        load = (ld.polynomial_static_load(dict(sc_load)) if task == "SC"
                else ld.constant_speed_load(omega_fixed=omega_fixed))
    reference_generator = reference_generator or _default_references(task, motor_name, action)
    reward_function = reward_function or _default_reward(task, motor_name)
    if constraints is None:
        constraints = _default_constraints(motor_name)

    if motor_name in _B6_MOTORS or motor_name in ("EESM", "DFIM"):
        system_cls = {"SCIM": SCIMSystem, "EESM": EESMSystem, "DFIM": DFIMSystem}.get(
            motor_name, SynchronousMotorSystem)
        system = system_cls(supply=supply, converter=converter, motor=motor_spec, load=load,
                            tau=tau, solver=solver, substeps=substeps, dtype=dtype,
                            control_space=control_space)
    else:
        if control_space != "abc":
            raise ValueError(f"control_space={control_space!r} is not supported for {motor_name} "
                             "(three-phase systems only)")
        system_cls = SRMSystem if motor_name == "SRM" else DcMotorSystem
        system = system_cls(supply=supply, converter=converter, motor=motor_spec, load=load,
                            tau=tau, solver=solver, substeps=substeps, dtype=dtype)
    if motor_name == "ShuntDc":
        # every reference ShuntDc env appends a CurrentSumProcessor
        wrappers = wrappers + (CurrentSumProcessor(("i_a", "i_e")),)
    system = apply_wrappers(system, wrappers)
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
