"""The port's universal trajectory recorder (``make_fused_record_rollout``,
plain PyTorch versions on the CPU) for the induction family against the JAX
package's ``ops/pallas_record.py`` (interpret mode, one chunk).

* Buffer mode: for finite/cont x constant speed/SC, the recorded states of
  one numpy action buffer against the JAX interpret recorder, every step,
  rtol 1e-5 / atol 1e-4 (as the reducing rollout's buffer test).
* Random mode, replay: the plain recorder driven by the test-only xorshift
  copy of the interpret bit source, against the JAX interpret recorder:
  every signal of an env at every step at rtol 1e-4 / atol 1e-4, in at
  least 99% of envs.
* With one seed the recorder and the reducing rollout take the same steps;
  signal names and types match the JAX recorder's for all six ids; the
  CC reward recomputes from the recorded currents and the flux of the step
  before (the stale field angle).
* The random recorder's ring (csrc/fused_induction_record.cu's
  ``induction_record_ws_kernel``, computed here without the library) and
  the partial-width launcher's arguments; the kernel itself runs only on a
  CUDA card (tests/test_torch_cuda_kernels.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_electric_motor_tpu as gemx
from gym_electric_motor_tpu.ops.pallas_record import make_fused_record_rollout as jax_record
import gym_electric_motor_tpu_torch as gt
from gym_electric_motor_tpu_torch.ops import fused_induction_family as indf
from gym_electric_motor_tpu_torch.ops import fused_record as frec
from gym_electric_motor_tpu_torch.ops import fused_rollout as fr
from test_torch_induction_universal import BUF, action_buffer, replay_start
from test_torch_scim import const_envs
from test_torch_sync_universal import XorshiftSyncBits, env_share

torch.set_num_threads(1)

# (env_id, const-ref names): finite/cont x constant speed/SC
RECORD_CASES = [
    ("Finite-CC-SCIM-v0", ["i_sd", "i_sq"]),
    ("Cont-TC-SCIM-v0", ["torque"]),
    ("Finite-SC-SCIM-v0", ["omega"]),
    ("Cont-SC-SCIM-v0", ["omega"]),
]


@pytest.mark.parametrize("env_id,ref_names", RECORD_CASES, ids=[c[0] for c in RECORD_CASES])
def test_buffer_recorder_matches_jax_interpret(env_id, ref_names):
    jenv, tenv = const_envs(env_id, [(n, 0.0) for n in ref_names])
    N, T = 128, 40
    c = indf.InductionConsts(tenv)
    start = [x[:1] for x in replay_start(c, 8)]
    acts = action_buffer(c.finite, T, 1, 9)
    jroll = jax_record(jenv, T, N, chunk=T, action_mode="buffer", interpret=True)
    want = jroll(*map(jnp.asarray, start), jnp.asarray(acts))
    troll = frec.make_fused_record_rollout(tenv, T, N, action_mode="buffer")
    got = troll(*map(torch.as_tensor, start), torch.as_tensor(acts))
    assert troll.signals == tuple(jroll.signals)
    for name in troll.signals:
        g, w = got[name].numpy(), np.asarray(want[name])
        assert g.shape == w.shape == (T, 1, 128)
        np.testing.assert_allclose(g, w, **BUF, err_msg=f"{env_id} {name}")


@pytest.mark.parametrize("env_id", ["Finite-CC-SCIM-v0", "Cont-SC-SCIM-v0"])
def test_random_recorder_replays_jax_interpret(env_id):
    jenv = gemx.make_functional(env_id)
    tenv = gt.make_functional(env_id, device="cpu")
    c = indf.InductionConsts(tenv)
    N, T, seed = 256, 64, 5
    start = replay_start(c, 10)
    jroll = jax_record(jenv, T, N, chunk=T, interpret=True)
    want = jroll(seed, *map(jnp.asarray, start))
    got = indf.induction_record_random_plain(c, seed, tuple(map(torch.as_tensor, start)), T,
                                             bits=XorshiftSyncBits(seed, N, c.n_ref, c.n_act))
    names = frec.make_fused_record_rollout(tenv, T, N).signals
    assert names == tuple(jroll.signals)
    assert float(np.asarray(want["done"]).sum()) > 0  # the replay crosses resets
    assert env_share([g.numpy() for g in got], [want[n] for n in names], len(got) + 1, N) >= 0.99


def test_record_and_rollout_share_the_step():
    """Same seed: the recorder's last step is the rollout's final state and
    its rewards sum to the rollout's reward sums."""
    tenv = gt.make_functional("Cont-SC-SCIM-v0", device="cpu")
    N, T = 128, 60
    start = tuple(torch.as_tensor(x[:1]) for x in replay_start(indf.InductionConsts(tenv), 7))
    roll = fr.make_fused_rollout(tenv, T, N)(11, *start)
    rec = frec.make_fused_record_rollout(tenv, T, N)(11, *start)
    states = ("omega", "i_salpha", "i_sbeta", "psi_ralpha", "psi_rbeta")
    assert list(rec) == list(states) + ["ref_omega", "action_a", "action_b", "action_c", "reward",
                                        "done"]
    for j, name in enumerate(states):
        torch.testing.assert_close(rec[name][-1], roll[j], rtol=0, atol=0)
    torch.testing.assert_close(rec["reward"].sum(0), roll[5], rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(rec["done"].sum(0), roll[6], rtol=0, atol=0)
    assert float(roll[6].sum()) > 0
    for k in ("action_a", "action_b", "action_c"):
        a = rec[k]
        assert a.dtype == torch.float32 and float(a.min()) >= -1.0 and float(a.max()) < 1.0


@pytest.mark.parametrize("env_id", gt.SCIM_ENV_IDS)
def test_record_signals_match_jax(env_id):
    tenv = gt.make_functional(env_id, device="cpu")
    jroll = jax_record(gemx.make_functional(env_id), 4, 128, chunk=4, interpret=True)
    troll = frec.make_fused_record_rollout(tenv, 4, 128)
    assert troll.signals == tuple(jroll.signals)
    n = fr.fused_state_arity(tenv)
    out = troll(2, *([torch.zeros((1, 128))] * n))
    for name, dt in zip(troll.signals, indf.record_dtypes(troll.consts)):
        assert out[name].dtype == dt and out[name].shape == (4, 1, 128)
        assert bool(torch.isfinite(out[name].double()).all())
    if env_id.startswith("Finite"):
        a = out["action"]
        assert a.dtype == torch.int32 and 0 <= int(a.min()) <= int(a.max()) <= 7


def test_cc_reward_takes_the_stale_flux_angle():
    """Cont-CC-SCIM: the reward of step t rotates the current recorded at t
    by the flux recorded at t - 1 (``test_record_random_scim_stale_flux_angle``
    of the JAX suite), on steps with no reset at t - 1 or t."""
    tenv = gt.make_functional("Cont-CC-SCIM-v0", device="cpu")
    c = indf.InductionConsts(tenv)
    N, T = 256, 200
    z = torch.zeros((N // 128, 128))
    out = {k: v.double().numpy() for k, v in frec.make_fused_record_rollout(tenv, T, N)(
        17, *([z] * 4)).items()}
    ps_a, ps_b = out["psi_ralpha"][:-1], out["psi_rbeta"][:-1]
    mag = np.sqrt(ps_a**2 + ps_b**2)
    safe = mag > 1e-9
    cos = np.where(safe, ps_a / np.where(safe, mag, 1.0), 1.0)
    sin = np.where(safe, ps_b / np.where(safe, mag, 1.0), 0.0)
    i_sa, i_sb = out["i_salpha"][1:], out["i_sbeta"][1:]
    inv_lim = c.rows[0]["inv_lim"]
    i_sd, i_sq = (cos * i_sa + sin * i_sb) * inv_lim, (cos * i_sb - sin * i_sa) * inv_lim
    expect = -(c.rows[0]["coef"] * np.abs(i_sd - out["ref_i_sd"][1:])
               + c.rows[1]["coef"] * np.abs(i_sq - out["ref_i_sq"][1:]))
    ok = (out["done"][1:] < 0.5) & (out["done"][:-1] < 0.5) & safe
    assert ok.mean() > 0.8
    np.testing.assert_allclose(out["reward"][1:][ok], expect[ok], rtol=1e-4, atol=1e-5)


RING_CASES = [(i, "wiener") for i in gt.SCIM_ENV_IDS] + [("Finite-CC-SCIM-v0", "const")]


@pytest.mark.parametrize("env_id,refs", RING_CASES, ids=[f"{i}-{r}" for i, r in RING_CASES])
def test_record_ring_layout_is_the_kernels_ring(env_id, refs):
    """induction_record_ring_layout is the ring of
    csrc/fused_induction_record.cu (IndRecordRing; words a step: the B6 bits
    or the three duties, then four per reference row, draw_ring.cuh's
    b6_draw_words) with Wiener references: 4 consumer warps, P producer
    warps per consumer warp, two slots of K steps, each producer's steps
    pairing an even step with the odd one that takes its sine half; with
    constant references one thread per env."""
    from pathlib import Path

    tenv = const_envs(env_id)[1] if refs == "const" else gt.make_functional(env_id, device="cpu")
    c = indf.InductionConsts(tenv)
    assert c.all_const == (refs == "const")
    lay = indf.induction_record_ring_layout(c)
    csrc = Path(indf.__file__).resolve().parent.parent / "csrc"
    source = (csrc / "fused_induction_record.cu").read_text()
    if refs == "const":
        assert lay == {"consumer_warps": 0, "producer_warps": 0, "K": 0, "slots": 0, "words": 0,
                       "smem_bytes": 0, "design": "one thread per env"}
        assert ("  if (k.flag[IF_ALL_CONST]) {\n    induction_record_random_kernel<F, M, NR>"
                in source)
        return
    K, P = indf.IND_RECORD_RING
    words = c.n_act + 4 * c.n_ref
    assert words == {(1, 1): 5, (3, 1): 7, (1, 2): 9, (3, 2): 11}[(c.n_act, c.n_ref)]
    assert lay == {"consumer_warps": 4, "producer_warps": 4 * P, "K": K, "slots": 2,
                   "words": words, "smem_bytes": 2 * K * words * 128 * 4,
                   "design": "warp-specialised"}
    assert (K // P) % 2 == 0 and lay["smem_bytes"] <= 227 * 1024
    assert f"using IndRecordRing = RingShape<{K}, {P}>;" in source
    ring_header = (csrc / "draw_ring.cuh").read_text()
    assert "  return b6_ring_words<FINITE>() + kRefWords * NREF;" in ring_header
    assert ("ring_layout<IndRecordRing>((flags[IF_FINITE] ? 1 : 3) + kRefWords * "
            "flags[IF_NREF], out);") in source


@pytest.mark.parametrize("env_id", ["Finite-CC-SCIM-v0", "Cont-SC-SCIM-v0"])
def test_record_random_args_follow_the_record_out_order(env_id):
    """The partial-width launcher's arguments: one ``(T, n_envs)`` tensor
    per recorded signal, of the recorder's types, and the C entry's output
    array (omega or NULL, the four electrical planes, ref row 0, ref row 1
    or NULL, int32 action or NULL, action a, b, c or NULL, reward, done)
    pointing at them; the envs and steps as given."""
    c = indf.InductionConsts(gt.make_functional(env_id, device="cpu"))
    T, n = 9, 37
    states = [torch.zeros((1, 128)) for _ in range(c.n_state)]
    outs, args = indf._record_random_args(c, 7, states, T, n)
    assert [x.dtype for x in outs] == list(indf.record_dtypes(c))
    assert all(x.shape == (T, n) for x in outs)
    assert args[3:5] == (n, T) and args[2] == 7
    it = iter(x.data_ptr() for x in outs)
    st = [next(it) for _ in range(c.n_state)]
    refs = [next(it) for _ in range(c.n_ref)]
    acts = [next(it) for _ in range(c.n_act)]
    want = (([] if c.mech else [None]) + st + refs + [None] * (2 - c.n_ref)
            + (acts + [None] * 3 if c.finite else [None] + acts) + list(it))
    assert list(args[6]) == want and len(want) == 13
