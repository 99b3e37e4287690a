"""Fused rollouts — the import facade and the universal dispatch
(counterpart of ``gym_electric_motor_tpu/ops/pallas_rollout.py``).

``make_fused_rollout`` routes an env to its family's universal builder:
the synchronous family (the twelve PMSM / SynRM ids) so far; every other
family raises ``NotImplementedError`` naming the queue-2 item that brings
its kernels.  The sharded ``make_sharded_fused_rollout`` and the universal
policy recorder come with later slices of the port.
"""

from __future__ import annotations

from .fused_common import LANE, TWO_PI  # noqa: F401
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
    make_fused_pmsm_record_rollout,
    make_fused_pmsm_rollout,
    reset_launches,
)
from .fused_sync_family import make_fused_sync_rollout

FUSED_FAMILY_BUILDERS = {
    "PermExDc": "dc", "SeriesDc": "dc", "ShuntDc": "dc", "ExtExDc": "dc",
    "PMSM": "sync", "SynRM": "sync",
    "SCIM": "induction",
    "EESM": "eesm", "DFIM": "dfim",
    "SRM": "srm",
}

# the queue-2 item of the port that brings each family's universal kernels
_FAMILY_ITEM = {"dc": 15, "induction": 18, "eesm": 20, "dfim": 22, "srm": 23}


def _system(env):
    ps = env.physical_system
    while hasattr(ps, "inner"):  # a physical-system wrapper chain
        ps = ps.inner
    return ps


def family_of(env):
    """The env's family, raising ``NotImplementedError`` for a family whose
    kernels are not ported yet."""
    family = FUSED_FAMILY_BUILDERS[_system(env).motor.kind]
    if family != "sync":
        raise NotImplementedError(
            f"the {family} family's fused kernels are not ported yet; they arrive with "
            f"queue 2, item {_FAMILY_ITEM[family]} of the port")
    return family


def fused_state_arity(env):
    """Number of ``(R, LANE)`` state planes the universal fused rollout for
    ``env`` takes and returns (``pallas_rollout.py:135-158``): i_sd, i_sq
    and eps, with omega first under a dynamic-speed load.  The other
    families' planes, and the supply, randomized-parameter and
    flux-observer planes, come with their kernels."""
    family_of(env)
    return 3 + int(_system(env).load.omega_fixed is None)


def make_fused_rollout(env, n_steps, n_envs, action_mode="random", randomize=None):
    """Universal fused-rollout dispatch (``pallas_rollout.py:161-192``):
    returns the family rollout (see ``make_fused_sync_rollout`` for the
    signatures); the number of state planes is ``fused_state_arity(env)``.
    Raises ``NotImplementedError`` for the families and options not ported
    yet."""
    family_of(env)
    return make_fused_sync_rollout(env, n_steps, n_envs, action_mode=action_mode,
                                   randomize=randomize)
