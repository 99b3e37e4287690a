"""Universal trajectory-recording fused rollouts (counterpart of
``gym_electric_motor_tpu/ops/pallas_record.py``, for all six families:
DC, synchronous, induction, EESM, DFIM and SRM).

``make_fused_record_rollout(env, T, N)`` returns ``rollout(seed, *state0)
-> dict`` mapping signal names (the family's state names, ``ref_*``,
``action*``, ``reward``, ``done``) to ``(T, N // 128, 128)`` tensors;
``rollout.signals`` lists them in order.  ``action_mode='buffer'`` gives
the deterministic validation path: ``rollout(*state0, actions) -> dict``
of per-step states.  The kernels are ``dc_record_random`` and
``dc_record_buffer`` of ``csrc/fused_dc_record.cu`` (see
``ops/fused_dc_family.py``) and ``sync_record_random`` and
``sync_record_buffer`` of ``csrc/fused_sync.cu`` (see
``ops/fused_sync_family.py``) and ``induction_record_random`` and
``induction_record_buffer`` of ``csrc/fused_induction_record.cu`` (see
``ops/fused_induction_family.py``) and ``eesm_record_random`` and
``eesm_record_buffer`` of ``csrc/fused_eesm_record.cu`` (see
``ops/fused_eesm_family.py``) and ``dfim_record_random`` and
``dfim_record_buffer`` of ``csrc/fused_dfim_record.cu`` (see
``ops/fused_dfim_family.py``) and ``srm_record_random`` and
``srm_record_buffer`` of ``csrc/fused_srm_record.cu`` (see
``ops/fused_srm_family.py``); the TPU recorder's chunk grid and per-chunk
reseed (pallas_record.py:206-211) are TPU-only, so there is no ``chunk``
argument.
"""

from __future__ import annotations

from . import fused_dc_family as dcf
from . import fused_dfim_family as dff
from . import fused_eesm_family as ef
from . import fused_induction_family as indf
from . import fused_srm_family as srf
from . import fused_sync_family as sf
from .fused_common import LANE, check_rollout_inputs
from .fused_rollout import family_of

# family -> (constants, random recorder, buffer recorder)
_FAMILIES = {
    "dc": (dcf.DcConsts, dcf.dc_record_random, dcf.dc_record_buffer),
    "sync": (sf.SyncConsts, sf.sync_record_random, sf.sync_record_buffer),
    "induction": (indf.InductionConsts, indf.induction_record_random,
                  indf.induction_record_buffer),
    "eesm": (ef.EesmConsts, ef.eesm_record_random, ef.eesm_record_buffer),
    "dfim": (dff.DfimConsts, dff.dfim_record_random, dff.dfim_record_buffer),
    "srm": (srf.SrmConsts, srf.srm_record_random, srf.srm_record_buffer),
}


def make_fused_record_rollout(env, n_steps, n_envs, action_mode="random"):
    """Build the trajectory-recording rollout for a catalog env (see the
    module docstring).  With one seed, the random recorder takes the steps
    of ``make_fused_rollout``'s random mode."""
    consts, record_random, record_buffer = _FAMILIES[family_of(env)]
    if n_envs % LANE:
        raise ValueError(f"n_envs must be a multiple of {LANE}")
    R = n_envs // LANE
    c = consts(env)
    if action_mode == "buffer":
        def rollout(*args):
            *state0, actions = args
            check_rollout_inputs(R, n_steps, state0, actions)
            return dict(zip(c.state_names, record_buffer(c, state0, actions)))

        rollout.signals = c.state_names
        rollout.consts = c
        return rollout
    if action_mode != "random":
        raise ValueError(f"action_mode must be 'random' or 'buffer', got {action_mode!r}")
    names = (c.state_names + tuple("ref_" + row["name"] for row in c.rows) + c.act_names
             + ("reward", "done"))

    def rollout(seed, *state0):
        check_rollout_inputs(R, n_steps, state0)
        return dict(zip(names, record_random(c, seed, state0, n_steps)))

    rollout.signals = names
    rollout.consts = c
    return rollout
