"""Fused rollouts — the import facade (counterpart of
``gym_electric_motor_tpu/ops/pallas_rollout.py``, limited to the PMSM
builders).  The universal dispatch ``make_fused_rollout`` and the sharded
``make_sharded_fused_rollout`` come with later slices of the port."""

from .fused_common import LANE, TWO_PI  # noqa: F401
from .fused_sync import (  # noqa: F401
    LAUNCHES,
    make_fused_pmsm_record_rollout,
    make_fused_pmsm_rollout,
    reset_launches,
)
