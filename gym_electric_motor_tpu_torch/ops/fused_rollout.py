"""Fused rollouts — the import facade (counterpart of
``gym_electric_motor_tpu/ops/pallas_rollout.py``, limited to the PMSM
rollouts, plain and with the policy in the loop).  The universal dispatch
``make_fused_rollout``, the sharded ``make_sharded_fused_rollout`` and the
universal policy recorder come with later slices of the port."""

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
