"""The port's universal trajectory recorder (``make_fused_record_rollout``,
plain PyTorch versions on the CPU) for the SRM family against the JAX
package's ``ops/pallas_record.py`` (interpret mode, one chunk).

* Buffer mode: for finite/cont x constant speed/SC (and the saturating
  model on Cont-SC-SRM-v0), the recorded states of one numpy action buffer
  against the JAX interpret recorder, every step, rtol 1e-4 / atol 2e-3
  with the angle modulo 2 pi (as the reducing rollout's buffer test).
* Random mode, replay: the plain recorder driven by the test-only copy of
  the interpret bit source, against the JAX interpret recorder: every
  signal of an env at every step (the three action planes among them) at
  rtol 1e-4 / atol 1e-4, in at least 99% of envs, with three references
  (Finite-CC-SRM-v0), the torque at the wrapped angle (Cont-TC-SRM-v0) and
  the speed (Cont-SC-SRM-v0).
* With one seed the recorder and the reducing rollout take the same steps;
  signal names and types match the JAX recorder's for all six ids; the
  finite actions are per-phase commands in {0, 1, 2}.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_electric_motor_tpu as gemx
from gym_electric_motor_tpu.ops.pallas_record import make_fused_record_rollout as jax_record
import gym_electric_motor_tpu_torch as gt
from gym_electric_motor_tpu_torch.ops import fused_record as frec
from gym_electric_motor_tpu_torch.ops import fused_rollout as fr
from gym_electric_motor_tpu_torch.ops import fused_srm_family as srf
from test_torch_eesm_universal import XorshiftEesmBits
from test_torch_srm import SAT, const_envs
from test_torch_srm_universal import BUF, action_buffer, assert_angle, start_planes
from test_torch_sync_universal import env_share

torch.set_num_threads(1)

# finite/cont x constant speed/SC, and the saturating model
RECORD_CASES = [("Finite-CC-SRM-v0", {}), ("Cont-TC-SRM-v0", {}), ("Finite-SC-SRM-v0", {}),
                ("Cont-SC-SRM-v0", SAT)]


@pytest.mark.parametrize("env_id,kw", RECORD_CASES,
                         ids=[e + ("-psi_s" if kw else "") for e, kw in RECORD_CASES])
def test_buffer_recorder_matches_jax_interpret(env_id, kw):
    jenv, tenv = const_envs(env_id, **kw)
    N, T = 128, 40
    c = srf.SrmConsts(tenv)
    start = start_planes(c, 1, 8)
    acts = action_buffer(c.finite, T, 1, 9)
    jroll = jax_record(jenv, T, N, chunk=T, action_mode="buffer", interpret=True)
    want = jroll(*map(jnp.asarray, start), jnp.asarray(acts))
    troll = frec.make_fused_record_rollout(tenv, T, N, action_mode="buffer")
    got = troll(*map(torch.as_tensor, start), torch.as_tensor(acts))
    assert troll.signals == tuple(jroll.signals)
    for name in troll.signals:
        g, w = got[name].numpy(), np.asarray(want[name])
        assert g.shape == w.shape == (T, 1, 128)
        if name == "eps":
            assert_angle(g, w)
        else:
            np.testing.assert_allclose(g, w, **BUF, err_msg=f"{env_id} {name}")


@pytest.mark.parametrize("env_id", ["Finite-CC-SRM-v0", "Cont-TC-SRM-v0", "Cont-SC-SRM-v0"])
def test_random_recorder_replays_jax_interpret(env_id):
    jenv = gemx.make_functional(env_id)
    tenv = gt.make_functional(env_id, device="cpu")
    c = srf.SrmConsts(tenv)
    N, T, seed = 256, 64, 5
    start = start_planes(c, 2, 10, i_max=22.0)
    jroll = jax_record(jenv, T, N, chunk=T, interpret=True)
    want = jroll(seed, *map(jnp.asarray, start))
    got = srf.srm_record_random_plain(c, seed, tuple(map(torch.as_tensor, start)), T,
                                      bits=XorshiftEesmBits(seed, N, c.n_ref, c.n_words))
    names = frec.make_fused_record_rollout(tenv, T, N).signals
    assert names == tuple(jroll.signals)
    assert float(np.asarray(want["done"]).sum()) > 0  # the replay crosses resets
    assert env_share([g.numpy() for g in got], [want[n] for n in names], c.n_state, N) >= 0.99
    for k, name in enumerate(c.act_names):  # the three action planes, as recorded
        g = got[c.n_state + c.n_ref + k]
        assert g.dtype == (torch.int32 if c.finite else torch.float32)
        assert np.mean(g.numpy() == np.asarray(want[name])) >= 0.99


def test_record_and_rollout_share_the_step():
    """Same seed: the recorder's last step is the rollout's final state and
    its rewards sum to the rollout's reward sums."""
    tenv = gt.make_functional("Finite-CC-SRM-v0", device="cpu")
    N, T = 128, 60
    c = srf.SrmConsts(tenv)
    start = tuple(torch.as_tensor(x) for x in start_planes(c, 1, 7, i_max=22.0))
    roll = fr.make_fused_rollout(tenv, T, N)(11, *start)
    rec = frec.make_fused_record_rollout(tenv, T, N)(11, *start)
    states = ("i_a", "i_b", "i_c", "eps")
    assert list(rec) == list(states) + ["ref_i_a", "ref_i_b", "ref_i_c", "action_a",
                                        "action_b", "action_c", "reward", "done"]
    for j, name in enumerate(states):
        torch.testing.assert_close(rec[name][-1], roll[j], rtol=0, atol=0)
    torch.testing.assert_close(rec["reward"].sum(0), roll[4], rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(rec["done"].sum(0), roll[5], rtol=0, atol=0)
    assert float(roll[5].sum()) > 0
    for name in ("action_a", "action_b", "action_c"):
        a = rec[name]
        assert a.dtype == torch.int32 and int(a.min()) == 0 and int(a.max()) == 2


@pytest.mark.parametrize("env_id", gt.SRM_ENV_IDS)
def test_record_signals_match_jax(env_id):
    tenv = gt.make_functional(env_id, device="cpu")
    jroll = jax_record(gemx.make_functional(env_id), 4, 128, chunk=4, interpret=True)
    troll = frec.make_fused_record_rollout(tenv, 4, 128)
    assert troll.signals == tuple(jroll.signals)
    n = fr.fused_state_arity(tenv)
    out = troll(2, *([torch.zeros((1, 128))] * n))
    for name, dt in zip(troll.signals, srf.record_dtypes(troll.consts)):
        assert out[name].dtype == dt and out[name].shape == (4, 1, 128)
        assert bool(torch.isfinite(out[name].double()).all())
    if env_id.startswith("Cont"):
        for k in troll.consts.act_names:
            assert float(out[k].min()) >= -1.0 and float(out[k].max()) < 1.0


@pytest.mark.parametrize("env_id,refs", [(i, "wiener") for i in gt.SRM_ENV_IDS]
                         + [("Finite-CC-SRM-v0", "const"), ("Cont-SC-SRM-v0", "const")],
                         ids=[f"{i}-wiener" for i in gt.SRM_ENV_IDS]
                         + ["Finite-CC-SRM-v0-const", "Cont-SC-SRM-v0-const"])
def test_record_ring_layout_is_the_kernels_ring(env_id, refs):
    """srm_record_ring_layout, computed without the library, is the ring of
    csrc/fused_srm_record.cu (SrmRecordRing; words a step: the three
    duties, then four per reference row)
    for the continuous instances (srm_record_on_ring): 4 consumer warps, P
    producer warps per consumer warp, two slots of K steps, each producer's
    steps pairing an even step with the odd one that takes its sine half; on
    the finite ids and with constant references one thread per env."""
    from pathlib import Path

    tenv = const_envs(env_id)[1] if refs == "const" else gt.make_functional(env_id, device="cpu")
    c = srf.SrmConsts(tenv)
    assert c.all_const == (refs == "const") and c.mech == env_id.split("-")[1].startswith("SC")
    lay = srf.srm_record_ring_layout(c)
    source = (Path(srf.__file__).resolve().parent.parent / "csrc"
              / "fused_srm_record.cu").read_text()
    assert ("__host__ __device__ constexpr bool srm_record_on_ring() {\n  return !FINITE;\n}"
            in source)
    if refs == "const" or c.finite:
        assert lay == {"consumer_warps": 0, "producer_warps": 0, "K": 0, "slots": 0, "words": 0,
                       "smem_bytes": 0, "design": "one thread per env"}
        return
    K, P = srf.SRM_RECORD_RING
    words = 3 + 4 * c.n_ref
    assert not c.finite and words == {1: 7, 3: 15}[c.n_ref]
    assert lay == {"consumer_warps": 4, "producer_warps": 4 * P, "K": K, "slots": 2,
                   "words": words, "smem_bytes": 2 * K * words * 128 * 4,
                   "design": "warp-specialised"}
    assert (K // P) % 2 == 0 and lay["smem_bytes"] <= 227 * 1024
    assert f"using SrmRecordRing = RingShape<{K}, {P}>;" in source
    assert "return 3 + kRefWords * NREF;" in source
    assert "ring_layout<SrmRecordRing>(3 + kRefWords * flags[SF_NREF], out);" in source
