"""The port's universal policy-in-the-loop recorder
(``make_fused_policy_record_universal``, plain PyTorch versions on the CPU)
against the JAX package's ``ops/pallas_policy.py`` (interpret mode, one
chunk), and against the port's own buffer recorder.

* Replay: the plain recorder driven by the test-only copy of the interpret
  bit source, in the JAX kernel's draw order (the policy's draws, one per
  head or a Box-Muller pair per two duties, then the reference advance's),
  against the JAX interpret recorder: every signal of an env at every step
  at rtol 1e-4 / atol 1e-4, angles modulo 2 pi, in at least 99% of envs, on
  one finite and one continuous id per family and with joint heads on
  Finite-CC-DFIM-v0 and Finite-CC-EESM-v0.  H 8, 128 envs x 64 steps, the
  weights of tests/test_fused_policy_universal.py:40-53.
* Buffer replay: the recorded actions (the squashed duties of a continuous
  id) through ``make_fused_record_rollout(..., action_mode="buffer")`` give
  the recorded states up to an env's first reset, rtol 1e-4 / atol 2e-3
  (tests/test_fused_policy_universal.py:89-125, :205-236).
* Alignment: on the port's recordings, the observation rebuilt by
  ``policy_obs_host`` and the recorded actions give E[log pi(a|s)] = -E[H]
  within 0.03 (finite) and 0.08 (continuous), the JAX tests' bounds.
"""

import numpy as np
import pytest
import torch

import gym_electric_motor_tpu as gemx
from gym_electric_motor_tpu.ops.pallas_policy import (
    make_fused_policy_record_universal as jax_record_universal,
)
import gym_electric_motor_tpu_torch as gt
from gym_electric_motor_tpu_torch.ops import fused_policy as fp
from gym_electric_motor_tpu_torch.ops.fused_record import make_fused_record_rollout
from gym_electric_motor_tpu_torch.parallel import sharded as tsh
from test_torch_eesm_universal import XorshiftEesmBits
from test_torch_sync_universal import env_share

torch.set_num_threads(1)

T, N, H, SEED = 64, 128, 8, 3

# one finite and one continuous id per family
REPLAY_IDS = ["Finite-CC-PMSM-v0", "Cont-SC-SynRM-v0", "Finite-CC-ExtExDc-v0",
              "Cont-SC-ShuntDc-v0", "Finite-CC-SCIM-v0", "Cont-TC-SCIM-v0",
              "Finite-CC-EESM-v0", "Cont-SC-EESM-v0", "Finite-TC-DFIM-v0", "Cont-CC-DFIM-v0",
              "Finite-CC-SRM-v0", "Cont-SC-SRM-v0"]
REPLAY_CASES = [(e, False) for e in REPLAY_IDS] + [("Finite-CC-DFIM-v0", True),
                                                   ("Finite-CC-EESM-v0", True)]


def weights(roll, hidden=H):
    """The JAX suite's weights: N(0, 0.5^2) (0.3 for a continuous id), zero
    biases, log-stds -0.5."""
    rng = np.random.default_rng(0)
    scale = 0.3 if roll.cont else 0.5
    w1 = rng.normal(0, scale, roll.obs_dim * hidden).astype(np.float32)
    w2 = rng.normal(0, scale, hidden * roll.n_out).astype(np.float32)
    ls = np.full(len(roll.act_names), -0.5, np.float32) if roll.cont else None
    return w1, np.zeros(hidden, np.float32), w2, np.zeros(roll.n_out, np.float32), ls


@pytest.mark.parametrize("env_id,joint", REPLAY_CASES,
                         ids=[e + ("-joint" if j else "") for e, j in REPLAY_CASES])
def test_plain_recorder_replays_jax_interpret(env_id, joint):
    jenv = gemx.make_functional(env_id)
    tenv = gt.make_functional(env_id, device="cpu")
    jroll = jax_record_universal(jenv, T, N, hidden=H, interpret=True, joint_heads=joint)
    troll = fp.make_fused_policy_record_universal(tenv, T, N, hidden=H, joint_heads=joint)
    assert troll.signals == tuple(jroll.signals) and troll.n_out == jroll.n_out
    w1, b1, w2, b2, ls = weights(troll)
    extra = (ls,) if troll.cont else ()
    planes = [np.zeros((N // 128, 128), np.float32) for _ in range(troll.n_state)]
    want = jroll(SEED, w1, b1, w2, b2, *extra, *planes)
    pol = troll.policy
    c = pol.consts
    bits = XorshiftEesmBits(SEED, N, c.n_ref, pol.n_words, all_const=c.all_const)
    got = fp.policy_record_universal_plain(
        pol, SEED, *map(torch.as_tensor, (w1, b1, w2, b2)),
        None if ls is None else torch.as_tensor(ls), tuple(map(torch.as_tensor, planes)), T,
        bits=bits)
    for name, g in zip(troll.signals, got):
        assert str(g.dtype) == f"torch.{np.asarray(want[name]).dtype.name}", name
    assert env_share([g.numpy() for g in got], [want[n] for n in troll.signals], c.n_state,
                     N) >= 0.99


BUFFER_IDS = ["Finite-CC-PermExDc-v0", "Finite-CC-DFIM-v0", "Cont-CC-PermExDc-v0",
              "Cont-CC-DFIM-v0"]


@pytest.mark.parametrize("env_id", BUFFER_IDS)
def test_policy_physics_matches_buffer_replay(env_id):
    tenv = gt.make_functional(env_id, device="cpu")
    steps = 32
    roll = fp.make_fused_policy_record_universal(tenv, steps, N, hidden=H)
    w1, b1, w2, b2, ls = weights(roll)
    planes = fp.fused_policy_init_planes(tenv, N, device="cpu")
    extra = (torch.as_tensor(ls),) if roll.cont else ()
    out = roll(SEED, *map(torch.as_tensor, (w1, b1, w2, b2)), *extra, *planes)
    acts = [out[an] for an in roll.act_names]
    if roll.cont:
        lo, hi = roll.act_range
        acts = [float(0.5 * (lo[j] + hi[j])) + float(0.5 * (hi[j] - lo[j])) * torch.tanh(a)
                for j, a in enumerate(acts)]
    buf = acts[0] if len(acts) == 1 else torch.stack(acts, 1).contiguous()
    rep = make_fused_record_rollout(tenv, steps, N, action_mode="buffer")(*planes, buf)
    valid = torch.cumsum(out["done"], 0) == 0
    assert float(valid.float().mean()) > 0.05
    for nm in roll.state_names:
        x, y = out[nm][valid].double(), rep[nm][valid].double()
        d = (x - y).abs()
        if nm == "eps":
            d = torch.remainder(d, 2 * np.pi)
            d = torch.minimum(d, 2 * np.pi - d)
        assert bool((d <= 2e-3 + 1e-4 * y.abs()).all()), (env_id, nm, float(d.max()))


ALIGN_IDS = REPLAY_IDS


@pytest.mark.parametrize("env_id", ALIGN_IDS)
def test_alignment_identity(env_id):
    """tests/test_fused_policy_universal.py:55-86, :182-202 on the port's
    own recordings."""
    tenv = gt.make_functional(env_id, device="cpu")
    roll = fp.make_fused_policy_record_universal(tenv, T, N, hidden=H)
    w1, b1, w2, b2, ls = weights(roll)
    planes = fp.fused_policy_init_planes(tenv, N, device="cpu")
    lst = None if ls is None else torch.as_tensor(ls)
    out = roll(SEED, *map(torch.as_tensor, (w1, b1, w2, b2)), *((lst,) if roll.cont else ()),
               *planes)

    def tn(x):
        return x.reshape(T, N)

    prev = {nm: torch.cat([planes[i].reshape(1, N), tn(out[nm])[:-1]])
            for i, nm in enumerate(roll.state_names)}
    obs = fp.policy_obs_host(roll, prev, {nm: tn(out[nm]) for nm in roll.ref_names})
    assert obs.shape == (T, N, roll.obs_dim)
    h = torch.tanh(obs @ torch.as_tensor(w1).reshape(roll.obs_dim, H) + torch.as_tensor(b1))
    logits = h @ torch.as_tensor(w2).reshape(H, roll.n_out) + torch.as_tensor(b2)
    act = torch.stack([tn(out[an]) for an in roll.act_names], dim=-1)
    if not roll.cont:
        for j, n in enumerate(roll.act_ns):
            assert int(act[..., j].min()) >= 0 and int(act[..., j].max()) < n
    lp, ent = tsh.heads_logp_ent(logits, act, roll.act_ns, lst)
    bound = 0.08 if roll.cont else 0.03
    assert abs(float(lp.double().mean() + ent.double().mean())) < bound


def test_plain_recorder_draws_its_own_words():
    """The recorder's Philox words: six policy uniforms from their own
    slots, distinct streams, and the reference advance's words those of
    the families' bit source (``SyncBits``), so that the references follow
    the random recorders' draws."""
    from gym_electric_motor_tpu_torch.ops.fused_common import PolicyBits, SyncBits

    pb = PolicyBits(7, 256, "cpu", 3, 6)
    sb = SyncBits(7, 256, "cpu", 3, 1)
    for t in (0, 5, 17):
        words, *ref = pb.step_words(t)
        _acts, *ref_s = sb.step_words(t)
        assert len(words) == 6
        for a, b in zip(ref, ref_s):
            for x, y in zip(a if isinstance(a, list) else [a], b if isinstance(b, list) else [b]):
                assert torch.equal(x, y)
    # the six words are distinct streams
    w = torch.stack(pb.step_words(3)[0])
    assert len({tuple(x[:4].tolist()) for x in w}) == 6
    with pytest.raises(ValueError):
        PolicyBits(7, 256, "cpu", 1, 7)
