"""Fused rollouts — the import facade and the universal dispatch
(counterpart of ``gym_electric_motor_tpu/ops/pallas_rollout.py``).

``make_fused_rollout`` routes an env to its family's universal builder:
the DC family (the 24 PermExDc, SeriesDc, ShuntDc and ExtExDc ids), the
synchronous family (the twelve PMSM / SynRM ids), the induction family (the
six SCIM ids), the EESM family (the six EESM ids), the DFIM family (the six
DFIM ids) and the SRM family (the six SRM ids).  The universal policy
recorder is ``fused_policy.make_fused_policy_record_universal``; the sharded
``make_sharded_fused_rollout`` comes with a later slice of the port.  The
controller-in-the-loop builders are re-exported here as the JAX package
re-exports them: ``make_fused_foc_rollout`` (``fused_sync.py``),
``make_fused_dc_cascade_rollout`` (``fused_dc_family.py``) and
``make_fused_srm_cascade_rollout`` (``fused_srm_family.py``).  So are the
specialised builders, each with kernels of its own, which the dispatch
never reaches (``pallas_rollout.py:179-187``): ``make_fused_permex_rollout``,
``make_fused_permex_record_rollout`` and ``make_fused_dc_sc_rollout``
(``fused_dc.py``), ``make_fused_scim_rollout`` (``fused_induction.py``),
``make_fused_eesm_rollout`` (``fused_eesm.py``) and
``make_fused_dfim_rollout`` (``fused_dfim.py``).
"""

from __future__ import annotations

from .fused_common import LANE, TWO_PI  # noqa: F401
from .fused_dc import (  # noqa: F401
    make_fused_dc_sc_rollout,
    make_fused_permex_record_rollout,
    make_fused_permex_rollout,
)
from .fused_dc_family import make_fused_dc_cascade_rollout, make_fused_dc_rollout  # noqa: F401
from .fused_dfim import make_fused_dfim_rollout  # noqa: F401
from .fused_dfim_family import make_fused_dfim_family_rollout
from .fused_eesm import make_fused_eesm_rollout  # noqa: F401
from .fused_eesm_family import make_fused_eesm_family_rollout
from .fused_induction import make_fused_scim_rollout  # noqa: F401
from .fused_induction_family import make_fused_induction_rollout
from .fused_policy import (  # noqa: F401
    flatten_policy_params,
    make_fused_policy_record_rollout,
    make_fused_policy_rollout,
    make_fused_reinforce_rollout,
    make_fused_reinforce_trainer,
    policy_obs_host,
    unflatten_policy_grads,
)
from .fused_sync import (  # noqa: F401
    LAUNCHES,
    make_fused_foc_rollout,
    make_fused_pmsm_record_rollout,
    make_fused_pmsm_rollout,
    reset_launches,
)
from .fused_srm_family import make_fused_srm_cascade_rollout, make_fused_srm_rollout  # noqa: F401
from .fused_sync_family import make_fused_sync_rollout

FUSED_FAMILY_BUILDERS = {
    "PermExDc": "dc", "SeriesDc": "dc", "ShuntDc": "dc", "ExtExDc": "dc",
    "PMSM": "sync", "SynRM": "sync",
    "SCIM": "induction",
    "EESM": "eesm", "DFIM": "dfim",
    "SRM": "srm",
}
PORTED_FAMILIES = {"dc": make_fused_dc_rollout, "sync": make_fused_sync_rollout,
                   "induction": make_fused_induction_rollout,
                   "eesm": make_fused_eesm_family_rollout,
                   "dfim": make_fused_dfim_family_rollout, "srm": make_fused_srm_rollout}

# state planes of each motor (pallas_rollout.py:144-146), before the speed;
# the EESM's are i_sd, i_sq, i_e and the angle eps, the DFIM's i_sa, i_sb,
# psi_ra, psi_rb and the angle eps (unlike the SCIM's, a kernel state: it
# turns the rotor voltages into the stator frame), the SRM's i_a, i_b, i_c
# and the angle eps
_BASE_ARITY = {"PermExDc": 1, "SeriesDc": 1, "ShuntDc": 2, "ExtExDc": 2, "PMSM": 3, "SynRM": 3,
               "SCIM": 4, "EESM": 4, "DFIM": 5, "SRM": 4}


def _system(env):
    ps = env.physical_system
    while hasattr(ps, "inner"):  # a physical-system wrapper chain
        ps = ps.inner
    return ps


def family_of(env):
    """The env's family (a key of ``PORTED_FAMILIES``)."""
    return FUSED_FAMILY_BUILDERS[_system(env).motor.kind]


def fused_state_arity(env):
    """Number of ``(R, LANE)`` state planes the universal fused rollout for
    ``env`` takes and returns (``pallas_rollout.py:135-158``): the motor's
    (PermExDc and SeriesDc 1, ShuntDc and ExtExDc 2, PMSM and SynRM 3, SCIM,
    EESM and SRM 4, DFIM 5), plus omega first under a dynamic-speed load.  The supply, randomized-parameter
    and flux-observer planes come with their kernels."""
    family_of(env)
    ps = _system(env)
    return _BASE_ARITY[ps.motor.kind] + int(ps.load.omega_fixed is None)


def make_fused_rollout(env, n_steps, n_envs, action_mode="random", randomize=None):
    """Universal fused-rollout dispatch (``pallas_rollout.py:161-192``):
    returns the family rollout (see ``make_fused_dc_rollout``,
    ``make_fused_sync_rollout``, ``make_fused_induction_rollout``,
    ``make_fused_eesm_family_rollout``, ``make_fused_dfim_family_rollout``
    and ``make_fused_srm_rollout`` for the signatures); the number of state
    planes is ``fused_state_arity(env)``.  Raises ``NotImplementedError``
    for the options not ported yet."""
    return PORTED_FAMILIES[family_of(env)](env, n_steps, n_envs, action_mode=action_mode,
                                           randomize=randomize)
