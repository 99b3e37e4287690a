"""The port's universal trajectory recorder (``make_fused_record_rollout``,
plain PyTorch versions on the CPU) for the EESM family against the JAX
package's ``ops/pallas_record.py`` (interpret mode, one chunk).

* Buffer mode: for finite/cont x constant speed/SC, the recorded states of
  one numpy action buffer against the JAX interpret recorder, every step,
  rtol 1e-4 / atol 2e-3 with the angle modulo 2 pi (as the reducing
  rollout's buffer test).
* Random mode, replay: the plain recorder driven by the test-only copy of
  the interpret bit source, against the JAX interpret recorder: every
  signal of an env at every step at rtol 1e-4 / atol 1e-4, in at least 99%
  of envs, with three references (Finite-CC-EESM-v0) and with the speed
  (Cont-SC-EESM-v0).
* With one seed the recorder and the reducing rollout take the same steps;
  signal names and types match the JAX recorder's for all six ids; the
  finite actions are the B6 bits and the 4QC's 0..3 of one word.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_electric_motor_tpu as gemx
from gym_electric_motor_tpu.ops.pallas_record import make_fused_record_rollout as jax_record
import gym_electric_motor_tpu_torch as gt
from gym_electric_motor_tpu_torch.ops import fused_eesm_family as ef
from gym_electric_motor_tpu_torch.ops import fused_record as frec
from gym_electric_motor_tpu_torch.ops import fused_rollout as fr
from test_torch_eesm import const_envs
from test_torch_eesm_universal import (BUF, XorshiftEesmBits, action_buffer, assert_angle,
                                       start_planes)
from test_torch_sync_universal import env_share

torch.set_num_threads(1)

# (env_id, const-ref names): finite/cont x constant speed/SC
RECORD_CASES = [
    ("Finite-CC-EESM-v0", ["i_sd", "i_sq", "i_e"]),
    ("Cont-TC-EESM-v0", ["torque"]),
    ("Finite-SC-EESM-v0", ["omega"]),
    ("Cont-SC-EESM-v0", ["omega"]),
]


@pytest.mark.parametrize("env_id,ref_names", RECORD_CASES, ids=[c[0] for c in RECORD_CASES])
def test_buffer_recorder_matches_jax_interpret(env_id, ref_names):
    jenv, tenv = const_envs(env_id, [(n, 0.0) for n in ref_names])
    N, T = 128, 40
    c = ef.EesmConsts(tenv)
    start = start_planes(c, 1, 8, frac=0.5)
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


@pytest.mark.parametrize("env_id", ["Finite-CC-EESM-v0", "Cont-SC-EESM-v0"])
def test_random_recorder_replays_jax_interpret(env_id):
    jenv = gemx.make_functional(env_id)
    tenv = gt.make_functional(env_id, device="cpu")
    c = ef.EesmConsts(tenv)
    N, T, seed = 256, 64, 5
    start = start_planes(c, 2, 10, frac=1.1)
    jroll = jax_record(jenv, T, N, chunk=T, interpret=True)
    want = jroll(seed, *map(jnp.asarray, start))
    got = ef.eesm_record_random_plain(c, seed, tuple(map(torch.as_tensor, start)), T,
                                      bits=XorshiftEesmBits(seed, N, c.n_ref, c.n_words))
    names = frec.make_fused_record_rollout(tenv, T, N).signals
    assert names == tuple(jroll.signals)
    assert float(np.asarray(want["done"]).sum()) > 0  # the replay crosses resets
    assert env_share([g.numpy() for g in got], [want[n] for n in names], c.n_state, N) >= 0.99


def test_record_and_rollout_share_the_step():
    """Same seed: the recorder's last step is the rollout's final state and
    its rewards sum to the rollout's reward sums."""
    tenv = gt.make_functional("Finite-CC-EESM-v0", device="cpu")
    N, T = 128, 60
    c = ef.EesmConsts(tenv)
    start = tuple(torch.as_tensor(x) for x in start_planes(c, 1, 7, frac=1.0))
    roll = fr.make_fused_rollout(tenv, T, N)(11, *start)
    rec = frec.make_fused_record_rollout(tenv, T, N)(11, *start)
    states = ("i_sd", "i_sq", "i_e", "eps")
    assert list(rec) == list(states) + ["ref_i_sd", "ref_i_sq", "ref_i_e", "action_b6",
                                        "action_e", "reward", "done"]
    for j, name in enumerate(states):
        torch.testing.assert_close(rec[name][-1], roll[j], rtol=0, atol=0)
    torch.testing.assert_close(rec["reward"].sum(0), roll[4], rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(rec["done"].sum(0), roll[5], rtol=0, atol=0)
    assert float(roll[5].sum()) > 0
    b6, a_e = rec["action_b6"], rec["action_e"]
    assert b6.dtype == a_e.dtype == torch.int32
    assert int(b6.min()) == 0 and int(b6.max()) == 7 and int(a_e.min()) == 0 and int(a_e.max()) == 3
    # the recorded references of the last step are the rows the rollout carried into it
    assert float(rec["ref_i_e"].min()) >= 0.0  # i_e's margin is (0, 1)


@pytest.mark.parametrize("env_id", gt.EESM_ENV_IDS)
def test_record_signals_match_jax(env_id):
    tenv = gt.make_functional(env_id, device="cpu")
    jroll = jax_record(gemx.make_functional(env_id), 4, 128, chunk=4, interpret=True)
    troll = frec.make_fused_record_rollout(tenv, 4, 128)
    assert troll.signals == tuple(jroll.signals)
    n = fr.fused_state_arity(tenv)
    out = troll(2, *([torch.zeros((1, 128))] * n))
    for name, dt in zip(troll.signals, ef.record_dtypes(troll.consts)):
        assert out[name].dtype == dt and out[name].shape == (4, 1, 128)
        assert bool(torch.isfinite(out[name].double()).all())
    if env_id.startswith("Cont"):
        for k in ("action_a", "action_b", "action_c", "action_e"):
            assert float(out[k].min()) >= -1.0 and float(out[k].max()) < 1.0


RING_CASES = [(i, "wiener") for i in gt.EESM_ENV_IDS] + [("Finite-CC-EESM-v0", "const")]


@pytest.mark.parametrize("env_id,refs", RING_CASES, ids=[f"{i}-{r}" for i, r in RING_CASES])
def test_record_ring_layout_is_the_kernels_ring(env_id, refs):
    """eesm_record_ring_layout, computed without the library, is the ring of
    csrc/fused_eesm_record.cu (EesmRecordRing; words a step: the B6 bits and
    the 4QC action, or the four duties, then four per reference row,
    eesm_ring.cuh's eesm_ring_words) with Wiener references: 4 consumer
    warps, P producer warps per consumer warp, two slots of K steps, each
    producer's steps pairing an even step with the odd one that takes its
    sine half; with constant references one thread per env."""
    from pathlib import Path

    tenv = const_envs(env_id)[1] if refs == "const" else gt.make_functional(env_id, device="cpu")
    c = ef.EesmConsts(tenv)
    assert c.all_const == (refs == "const") and c.mech == env_id.split("-")[1].startswith("SC")
    lay = ef.eesm_record_ring_layout(c)
    csrc = Path(ef.__file__).resolve().parent.parent / "csrc"
    source = (csrc / "fused_eesm_record.cu").read_text()
    if refs == "const":
        assert lay == {"consumer_warps": 0, "producer_warps": 0, "K": 0, "slots": 0, "words": 0,
                       "smem_bytes": 0, "design": "one thread per env"}
        assert "  if (k.flag[EF_ALL_CONST]) {\n    eesm_record_random_kernel<F, M, NR>" in source
        return
    K, P = ef.EESM_RECORD_RING
    words = (2 if c.finite else 4) + 4 * c.n_ref
    assert words == {(True, 1): 6, (True, 3): 14, (False, 1): 8, (False, 3): 16}[
        (c.finite, c.n_ref)]
    assert lay == {"consumer_warps": 4, "producer_warps": 4 * P, "K": K, "slots": 2,
                   "words": words, "smem_bytes": 2 * K * words * 128 * 4,
                   "design": "warp-specialised"}
    assert (K // P) % 2 == 0 and lay["smem_bytes"] <= 227 * 1024
    assert f"using EesmRecordRing = RingShape<{K}, {P}>;" in source
    assert "return (FINITE ? 2 : 4) + kRefWords * NREF;" in (csrc / "eesm_ring.cuh").read_text()
    assert ("ring_layout<EesmRecordRing>((flags[EF_FINITE] ? 2 : 4) + kRefWords * "
            "flags[EF_NREF], out);") in source
