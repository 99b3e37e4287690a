"""The port's universal trajectory recorder (``make_fused_record_rollout``,
plain PyTorch versions on the CPU) for the DC family against the JAX
package's ``ops/pallas_record.py`` (interpret mode, one chunk).

* Buffer mode: for finite/cont x constant speed/SC (one of them ExtExDc,
  with its ``(T, 2, R, 128)`` buffer), the recorded states of one numpy
  action buffer against the JAX interpret recorder, every step, rtol 1e-5 /
  atol 1e-4 (as the reducing rollout's buffer test).
* Random mode, replay: the plain recorder driven by the test-only xorshift
  copy of the interpret bit source (tests/test_torch_dc_universal.py),
  against the JAX interpret recorder: every signal of an env at every step
  at rtol 1e-4 / atol 1e-4, in at least 99% of envs.
* The recorder and the reducing rollout share the step; signal names and
  types match the JAX recorder's for all 24 ids; constant references are
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
from gym_electric_motor_tpu_torch.ops import fused_dc_family as dcf
from gym_electric_motor_tpu_torch.ops import fused_record as frec
from gym_electric_motor_tpu_torch.ops import fused_rollout as fr
from test_torch_dc_universal import (
    BUF,
    REPLAY_IDS,
    XorshiftDcBits,
    _replay_start,
    action_buffer,
    const_envs,
    start_planes,
)
from test_torch_sync_universal import env_share

torch.set_num_threads(1)

# (env_id, const-ref names): finite/cont x constant speed/SC, four of the
# PHYSICS_CASES of tests/test_pallas_dc_universal.py
RECORD_CASES = [
    ("Finite-TC-PermExDc-v0", ["torque"]),
    ("Cont-CC-SeriesDc-v0", ["i"]),
    ("Finite-SC-ShuntDc-v0", ["omega"]),
    ("Cont-SC-ExtExDc-v0", ["omega"]),
]


@pytest.mark.parametrize("env_id,ref_names", RECORD_CASES, ids=[c[0] for c in RECORD_CASES])
def test_buffer_recorder_matches_jax_interpret(env_id, ref_names):
    jenv, tenv = const_envs(env_id, [(n, 0.0) for n in ref_names])
    N, T = 128, 40
    c = dcf.DcConsts(tenv)
    start = start_planes(c, 1, 8)
    acts = action_buffer(c, T, 1, 9)
    jroll = jax_record(jenv, T, N, chunk=T, action_mode="buffer", interpret=True)
    want = jroll(*map(jnp.asarray, start), jnp.asarray(acts))
    troll = frec.make_fused_record_rollout(tenv, T, N, action_mode="buffer")
    got = troll(*map(torch.as_tensor, start), torch.as_tensor(acts))
    assert troll.signals == tuple(jroll.signals)
    for name in troll.signals:
        g, w = got[name].numpy(), np.asarray(want[name])
        assert g.shape == w.shape == (T, 1, 128)
        np.testing.assert_allclose(g, w, **BUF, err_msg=f"{env_id} {name}")


@pytest.mark.parametrize("env_id", REPLAY_IDS)
def test_random_recorder_replays_jax_interpret(env_id):
    jenv = gemx.make_functional(env_id)
    tenv = gt.make_functional(env_id, device="cpu")
    c = dcf.DcConsts(tenv)
    N, T, seed = 256, 64, 5
    start = _replay_start(c, 10)
    jroll = jax_record(jenv, T, N, chunk=T, interpret=True)
    want = jroll(seed, *map(jnp.asarray, start))
    got = dcf.dc_record_random_plain(c, seed, tuple(map(torch.as_tensor, start)), T,
                                     bits=XorshiftDcBits(seed, N, c.n_ref, c.n_act))
    names = frec.make_fused_record_rollout(tenv, T, N).signals
    assert names == tuple(jroll.signals)
    assert float(np.asarray(want["done"]).sum()) > 0  # the replay crosses resets
    assert env_share([g.numpy() for g in got], [want[n] for n in names], len(got) + 1, N) >= 0.99


def test_record_and_rollout_share_the_step():
    """Same seed: the recorder's last step is the rollout's final state and
    its rewards sum to the rollout's reward sums."""
    tenv = gt.make_functional("Cont-SC-ExtExDc-v0", device="cpu")
    c = dcf.DcConsts(tenv)
    N, T = 128, 60
    start = tuple(map(torch.as_tensor, start_planes(c, 1, 7)))
    roll = fr.make_fused_rollout(tenv, T, N)(11, *start)
    rec = frec.make_fused_record_rollout(tenv, T, N)(11, *start)
    assert list(rec) == ["omega", "i_a", "i_e", "ref_omega", "action_a", "action_e", "reward",
                         "done"]
    for j, name in enumerate(("omega", "i_a", "i_e")):
        torch.testing.assert_close(rec[name][-1], roll[j], rtol=0, atol=0)
    torch.testing.assert_close(rec["reward"].sum(0), roll[3], rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(rec["done"].sum(0), roll[4], rtol=0, atol=0)
    for k in ("action_a", "action_e"):
        a = rec[k]
        assert a.dtype == torch.float32 and float(a.min()) >= -1.0 and float(a.max()) < 1.0


@pytest.mark.parametrize("env_id", gt.DC_ENV_IDS)
def test_record_signals_match_jax(env_id):
    tenv = gt.make_functional(env_id, device="cpu")
    jroll = jax_record(gemx.make_functional(env_id), 4, 128, chunk=4, interpret=True)
    troll = frec.make_fused_record_rollout(tenv, 4, 128)
    assert troll.signals == tuple(jroll.signals)
    n = fr.fused_state_arity(tenv)
    out = troll(2, *([torch.zeros((1, 128))] * n))
    for name, dt in zip(troll.signals, dcf.record_dtypes(troll.consts)):
        assert out[name].dtype == dt and out[name].shape == (4, 1, 128)
        assert bool(torch.isfinite(out[name].double()).all())
    if env_id.startswith("Finite"):
        for name in troll.consts.act_names:
            assert out[name].dtype == torch.int32 and 0 <= int(out[name].min()) <= int(
                out[name].max()) <= 3


def test_const_references_recorded_exactly():
    """Constant references ride the reference machinery with no draws: the
    recorded reference is the constant every step and the reward recomputes
    against it from the recorded current (SeriesDc's torque is l_e' i^2)."""
    tenv = gt.make_functional("Cont-TC-SeriesDc-v0", device="cpu",
                              reference_generator=trg.ConstReference("torque", 0.25))
    N, T = 128, 128
    z = torch.zeros((1, 128))
    out = frec.make_fused_record_rollout(tenv, T, N)(9, z)
    assert torch.all(out["ref_torque"] == np.float32(0.25))
    c = dcf.DcConsts(tenv)
    torque = dcf.dc_torque(c, out["i"], None) * c.rows[0]["inv_lim"]
    ok = out["done"] < 0.5
    want = c.f["bias"] - c.rows[0]["coef"] * torch.abs(torque - 0.25)
    torch.testing.assert_close(out["reward"][ok], want[ok], rtol=1e-6, atol=1e-7)


RING_CASES = [(i, "wiener") for i in gt.DC_ENV_IDS] + [("Finite-CC-PermExDc-v0", "const")]


@pytest.mark.parametrize("env_id,refs", RING_CASES, ids=[f"{i}-{r}" for i, r in RING_CASES])
def test_record_ring_layout_is_the_kernels_ring(env_id, refs):
    """dc_record_ring_layout, computed without the library, is the ring of
    csrc/fused_dc_record.cu (DcRecordRing; words a step: one per converter
    channel, then four per reference row, dc_ring.cuh's dc_ring_words) with
    Wiener references: 4 consumer warps, P producer warps per consumer warp,
    two slots of K steps, each producer's steps pairing an even step with
    the odd one that takes its sine half; with constant references one
    thread per env."""
    from pathlib import Path

    tenv = const_envs(env_id)[1] if refs == "const" else gt.make_functional(env_id, device="cpu")
    c = dcf.DcConsts(tenv)
    assert c.all_const == (refs == "const")
    lay = dcf.dc_record_ring_layout(c)
    csrc = Path(dcf.__file__).resolve().parent.parent / "csrc"
    source = (csrc / "fused_dc_record.cu").read_text()
    if refs == "const":
        assert lay == {"consumer_warps": 0, "producer_warps": 0, "K": 0, "slots": 0, "words": 0,
                       "smem_bytes": 0, "design": "one thread per env"}
        assert "  if (k.ref.all_const) {\n    dc_record_random_kernel<F, M, MC, NR>" in source
        return
    K, P = dcf.DC_RECORD_RING
    words = c.n_ch + 4 * c.n_ref
    assert words == {(1, 1): 5, (2, 1): 6, (2, 2): 10}[(c.n_ch, c.n_ref)]
    assert lay == {"consumer_warps": 4, "producer_warps": 4 * P, "K": K, "slots": 2,
                   "words": words, "smem_bytes": 2 * K * words * 128 * 4,
                   "design": "warp-specialised"}
    assert (K // P) % 2 == 0 and lay["smem_bytes"] <= 227 * 1024
    assert f"using DcRecordRing = RingShape<{K}, {P}>;" in source
    ring_header = (csrc / "dc_ring.cuh").read_text()
    assert "return (MC == MC_EXTEX ? 2 : 1) + kRefWords * NREF;" in ring_header
    assert ("ring_layout<DcRecordRing>((flags[DF_MCLASS] == MC_EXTEX ? 2 : 1) + kRefWords * "
            "flags[DF_NREF],") in source
