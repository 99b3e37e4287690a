"""The port's universal trajectory recorder (``make_fused_record_rollout``,
plain PyTorch versions on the CPU) for the synchronous family against the
JAX package's ``ops/pallas_record.py`` (interpret mode, one chunk).

* Buffer mode: for finite/cont x constant speed/SC, the recorded states of
  one numpy action buffer against the JAX interpret recorder, every step,
  rtol 1e-5 / atol 1e-4 (as the reducing rollout's buffer test); angles
  modulo 2 pi.
* Random mode, replay: the plain recorder driven by the test-only xorshift
  copy of the interpret bit source (tests/test_torch_sync_universal.py),
  against the JAX interpret recorder: every signal of an env at every step
  at rtol 1e-4 / atol 1e-4, in at least 99% of envs.
* The recorder and the reducing rollout share the step; signal names and
  types match the JAX recorder's for all 12 ids; constant references are
  recorded exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_electric_motor_tpu as gemx
from gym_electric_motor_tpu.ops.pallas_record import make_fused_record_rollout as jax_record
import gym_electric_motor_tpu_torch as gt
from gym_electric_motor_tpu_torch import references as trg
from gym_electric_motor_tpu_torch.ops import fused_record as frec
from gym_electric_motor_tpu_torch.ops import fused_rollout as fr
from gym_electric_motor_tpu_torch.ops import fused_sync_family as sf
from test_torch_sync_universal import (
    REPLAY_IDS,
    BUF,
    XorshiftSyncBits,
    action_buffer,
    assert_angle,
    const_envs,
    env_share,
    start_planes,
)

torch.set_num_threads(1)

# (env_id, finite, mech, const-ref names): finite/cont x constant speed/SC
RECORD_CASES = [
    ("Finite-TC-PMSM-v0", True, False, ["torque"]),
    ("Cont-CC-SynRM-v0", False, False, ["i_sd", "i_sq"]),
    ("Finite-SC-SynRM-v0", True, True, ["omega"]),
    ("Cont-SC-PMSM-v0", False, True, ["omega"]),
]


@pytest.mark.parametrize("env_id,finite,mech,ref_names", RECORD_CASES,
                         ids=[c[0] for c in RECORD_CASES])
def test_buffer_recorder_matches_jax_interpret(env_id, finite, mech, ref_names):
    jenv, tenv = const_envs(env_id, [(n, 0.0) for n in ref_names])
    N, T = 128, 40
    n_state = 4 if mech else 3
    start = start_planes(n_state, 1, 8)
    acts = action_buffer(finite, T, 1, 9)
    jroll = jax_record(jenv, T, N, chunk=T, action_mode="buffer", interpret=True)
    want = jroll(*map(jnp.asarray, start), jnp.asarray(acts))
    troll = frec.make_fused_record_rollout(tenv, T, N, action_mode="buffer")
    got = troll(*map(torch.as_tensor, start), torch.as_tensor(acts))
    assert troll.signals == tuple(jroll.signals)
    for j, name in enumerate(troll.signals):
        g, w = got[name].numpy(), np.asarray(want[name])
        assert g.shape == w.shape == (T, 1, 128)
        if j == n_state - 1:
            assert_angle(g, w)
        else:
            np.testing.assert_allclose(g, w, **BUF, err_msg=f"{env_id} {name}")


@pytest.mark.parametrize("env_id", REPLAY_IDS)
def test_random_recorder_replays_jax_interpret(env_id):
    jenv = gemx.make_functional(env_id)
    tenv = gt.make_functional(env_id, device="cpu")
    c = sf.SyncConsts(tenv)
    N, T, seed = 256, 64, 5
    start = start_planes(c.n_state, 2, 10, amp=1.0 / c.f["inv_i_lim"])  # a fifth start outside
    jroll = jax_record(jenv, T, N, chunk=T, interpret=True)
    want = jroll(seed, *map(jnp.asarray, start))
    got = sf.sync_record_random_plain(c, seed, tuple(map(torch.as_tensor, start)), T,
                                      bits=XorshiftSyncBits(seed, N, c.n_ref, c.n_act))
    names = frec.make_fused_record_rollout(tenv, T, N).signals
    assert names == tuple(jroll.signals)
    assert float(np.asarray(want["done"]).sum()) > 0  # the replay crosses resets
    assert env_share([g.numpy() for g in got], [want[n] for n in names], c.n_state, N) >= 0.99


def test_record_and_rollout_share_the_step():
    """Same seed: the recorder's last step is the rollout's final state and
    its rewards sum to the rollout's reward sums."""
    tenv = gt.make_functional("Cont-SC-SynRM-v0", device="cpu")
    N, T = 128, 60
    start = tuple(map(torch.as_tensor, start_planes(4, 1, 7)))
    roll = fr.make_fused_rollout(tenv, T, N)(11, *start)
    rec = frec.make_fused_record_rollout(tenv, T, N)(11, *start)
    assert list(rec) == ["omega", "i_sd", "i_sq", "eps", "ref_omega", "action_a", "action_b",
                         "action_c", "reward", "done"]
    for j, name in enumerate(("omega", "i_sd", "i_sq", "eps")):
        torch.testing.assert_close(rec[name][-1], roll[j], rtol=0, atol=0)
    torch.testing.assert_close(rec["reward"].sum(0), roll[4], rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(rec["done"].sum(0), roll[5], rtol=0, atol=0)
    for k in ("action_a", "action_b", "action_c"):
        a = rec[k]
        assert a.dtype == torch.float32 and float(a.min()) >= -1.0 and float(a.max()) < 1.0


@pytest.mark.parametrize("env_id", gt.ENV_IDS)
def test_record_signals_match_jax(env_id):
    tenv = gt.make_functional(env_id, device="cpu")
    jroll = jax_record(gemx.make_functional(env_id), 4, 128, chunk=4, interpret=True)
    troll = frec.make_fused_record_rollout(tenv, 4, 128)
    assert troll.signals == tuple(jroll.signals)
    n = fr.fused_state_arity(tenv)
    out = troll(2, *([torch.zeros((1, 128))] * n))
    for name, dt in zip(troll.signals, sf.record_dtypes(troll.consts)):
        assert out[name].dtype == dt and out[name].shape == (4, 1, 128)
        assert bool(torch.isfinite(out[name].double()).all())
    if env_id.startswith("Finite"):
        assert out["action"].dtype == torch.int32 and int(out["action"].max()) <= 7


def test_const_references_recorded_exactly():
    """Constant references ride the reference machinery with no draws: the
    recorded reference is the constant every step and the reward recomputes
    against it from the recorded torque."""
    tenv = gt.make_functional("Cont-TC-PMSM-v0", device="cpu",
                              reference_generator=trg.ConstReference("torque", 0.25))
    N, T = 128, 128
    z = torch.zeros((1, 128))
    out = frec.make_fused_record_rollout(tenv, T, N)(9, z, z, z)
    assert torch.all(out["ref_torque"] == np.float32(0.25))
    c = sf.SyncConsts(tenv)
    torque = sf._torque(c.f, out["i_sd"], out["i_sq"]) * c.rows[0]["inv_lim"]
    ok = out["done"] < 0.5
    want = c.f["bias"] - c.rows[0]["coef"] * torch.abs(torque - 0.25)
    torch.testing.assert_close(out["reward"][ok], want[ok], rtol=1e-6, atol=1e-7)
