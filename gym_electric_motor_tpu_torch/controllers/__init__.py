"""Auto-tuned classical controllers on batched tensors.

Counterpart of ``gym_electric_motor_tpu/controllers/``: a host-side tuner
computes the gains and limits in numpy float64, and a batched
``control(ctrl_state, state, reference) -> (ctrl_state', action)`` runs
the law for N envs on their device; ``control_environment`` closes the
loop on the general path, and the fused closed loops of
``ops.fused_rollout`` (``make_fused_foc_rollout``,
``make_fused_dc_cascade_rollout``, ``make_fused_srm_cascade_rollout``) run
it inside CUDA kernels.  ``ReferencePlotter`` and ``block_diagram`` are
not ported yet.
"""

from . import readers
from .controller import GemController
from .srm import SRMCommutationController

__all__ = ["GemController", "SRMCommutationController", "readers"]
