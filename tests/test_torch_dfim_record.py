"""The port's universal trajectory recorder (``make_fused_record_rollout``,
plain PyTorch versions on the CPU) for the DFIM family against the JAX
package's ``ops/pallas_record.py`` (interpret mode, one chunk).

* Buffer mode: for finite/cont x constant speed/SC, the recorded states of
  one numpy action buffer against the JAX interpret recorder, every step,
  rtol 1e-4 / atol 2e-3 with the angle modulo 2 pi (as the reducing
  rollout's buffer test).
* Random mode, replay: the plain recorder driven by the test-only copy of
  the interpret bit source, against the JAX interpret recorder: every
  signal of an env at every step at rtol 1e-4 / atol 1e-4, in at least 99%
  of envs, with two references and the flux direction (Finite-CC-DFIM-v0)
  and with six duties and the speed (Cont-SC-DFIM-v0).
* With one seed the recorder and the reducing rollout take the same steps;
  signal names and types match the JAX recorder's for all six ids; the
  finite actions are the stator's and the rotor's B6 bits of one word.
* The random recorder's ring layout, computed without the library, is the
  ring of csrc/fused_dfim_record.cu, and its partial-width launcher hands
  the C entry the planes in the order of the recorder's RecordOut (the
  kernel itself runs only on a CUDA card; its card test is
  ``test_cuda_dfim_record_random_equals_plain_version_bit_for_bit`` in
  tests/test_torch_cuda_kernels.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_electric_motor_tpu as gemx
from gym_electric_motor_tpu.ops.pallas_record import make_fused_record_rollout as jax_record
import gym_electric_motor_tpu_torch as gt
from gym_electric_motor_tpu_torch.ops import fused_dfim_family as dff
from gym_electric_motor_tpu_torch.ops import fused_record as frec
from gym_electric_motor_tpu_torch.ops import fused_rollout as fr
from test_torch_dfim import const_envs
from test_torch_dfim_universal import BUF, action_buffer, assert_angle, start_planes
from test_torch_sync_universal import XorshiftSyncBits, env_share

torch.set_num_threads(1)

# (env_id, const-ref names): finite/cont x constant speed/SC
RECORD_CASES = [
    ("Finite-CC-DFIM-v0", ["i_sd", "i_sq"]),
    ("Cont-TC-DFIM-v0", ["torque"]),
    ("Finite-SC-DFIM-v0", ["omega"]),
    ("Cont-SC-DFIM-v0", ["omega"]),
]


@pytest.mark.parametrize("env_id,ref_names", RECORD_CASES, ids=[c[0] for c in RECORD_CASES])
def test_buffer_recorder_matches_jax_interpret(env_id, ref_names):
    jenv, tenv = const_envs(env_id, [(n, 0.0) for n in ref_names])
    N, T = 128, 40
    c = dff.DfimConsts(tenv)
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


@pytest.mark.parametrize("env_id", ["Finite-CC-DFIM-v0", "Cont-SC-DFIM-v0"])
def test_random_recorder_replays_jax_interpret(env_id):
    jenv = gemx.make_functional(env_id)
    tenv = gt.make_functional(env_id, device="cpu")
    c = dff.DfimConsts(tenv)
    N, T, seed = 256, 64, 5
    start = start_planes(c, 2, 10, frac=1.1)
    jroll = jax_record(jenv, T, N, chunk=T, interpret=True)
    want = jroll(seed, *map(jnp.asarray, start))
    got = dff.dfim_record_random_plain(c, seed, tuple(map(torch.as_tensor, start)), T,
                                       bits=XorshiftSyncBits(seed, N, c.n_ref, c.n_words))
    names = frec.make_fused_record_rollout(tenv, T, N).signals
    assert names == tuple(jroll.signals)
    assert float(np.asarray(want["done"]).sum()) > 0  # the replay crosses resets
    assert env_share([g.numpy() for g in got], [want[n] for n in names], c.n_state, N) >= 0.99


def test_record_and_rollout_share_the_step():
    """Same seed: the recorder's last step is the rollout's final state and
    its rewards sum to the rollout's reward sums."""
    tenv = gt.make_functional("Finite-CC-DFIM-v0", device="cpu")
    N, T = 128, 60
    c = dff.DfimConsts(tenv)
    start = tuple(torch.as_tensor(x) for x in start_planes(c, 1, 7, frac=1.0))
    roll = fr.make_fused_rollout(tenv, T, N)(11, *start)
    rec = frec.make_fused_record_rollout(tenv, T, N)(11, *start)
    states = ("i_salpha", "i_sbeta", "psi_ralpha", "psi_rbeta", "eps")
    assert list(rec) == list(states) + ["ref_i_sd", "ref_i_sq", "action_stator",
                                        "action_rotor", "reward", "done"]
    for j, name in enumerate(states):
        torch.testing.assert_close(rec[name][-1], roll[j], rtol=0, atol=0)
    torch.testing.assert_close(rec["reward"].sum(0), roll[5], rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(rec["done"].sum(0), roll[6], rtol=0, atol=0)
    assert float(roll[6].sum()) > 0
    a_s, a_r = rec["action_stator"], rec["action_rotor"]
    assert a_s.dtype == a_r.dtype == torch.int32
    assert int(a_s.min()) == int(a_r.min()) == 0 and int(a_s.max()) == int(a_r.max()) == 7


@pytest.mark.parametrize("env_id", gt.DFIM_ENV_IDS)
def test_record_signals_match_jax(env_id):
    tenv = gt.make_functional(env_id, device="cpu")
    jroll = jax_record(gemx.make_functional(env_id), 4, 128, chunk=4, interpret=True)
    troll = frec.make_fused_record_rollout(tenv, 4, 128)
    assert troll.signals == tuple(jroll.signals)
    n = fr.fused_state_arity(tenv)
    out = troll(2, *([torch.zeros((1, 128))] * n))
    for name, dt in zip(troll.signals, dff.record_dtypes(troll.consts)):
        assert out[name].dtype == dt and out[name].shape == (4, 1, 128)
        assert bool(torch.isfinite(out[name].double()).all())
    if env_id.startswith("Cont"):
        for k in troll.consts.act_names:
            assert float(out[k].min()) >= -1.0 and float(out[k].max()) < 1.0


RING_CASES = [(i, "wiener") for i in gt.DFIM_ENV_IDS] + [("Finite-CC-DFIM-v0", "const")]


@pytest.mark.parametrize("env_id,refs", RING_CASES, ids=[f"{i}-{r}" for i, r in RING_CASES])
def test_record_ring_layout_is_the_kernels_ring(env_id, refs):
    """dfim_record_ring_layout is the ring of csrc/fused_dfim_record.cu
    (DfimRecordRing; words a step: both bridges' bits in one word or the six
    duties, then four per reference row, dfim_ring.cuh's dfim_ring_words)
    with Wiener references: 4 consumer warps, P producer warps per consumer
    warp, two slots of K steps, each producer's steps pairing an even step
    with the odd one that takes its sine half; with constant references one
    thread per env."""
    from pathlib import Path

    tenv = const_envs(env_id)[1] if refs == "const" else gt.make_functional(env_id, device="cpu")
    c = dff.DfimConsts(tenv)
    assert c.all_const == (refs == "const")
    lay = dff.dfim_record_ring_layout(c)
    csrc = Path(dff.__file__).resolve().parent.parent / "csrc"
    source = (csrc / "fused_dfim_record.cu").read_text()
    if refs == "const":
        assert lay == {"consumer_warps": 0, "producer_warps": 0, "K": 0, "slots": 0, "words": 0,
                       "smem_bytes": 0, "design": "one thread per env"}
        assert ("  if (k.flag[DF_ALL_CONST]) {\n    dfim_record_random_kernel<F, M, NR>"
                in source)
        return
    K, P = dff.DFIM_RECORD_RING
    words = c.n_words + 4 * c.n_ref
    assert words == {(1, 1): 5, (6, 1): 10, (1, 2): 9, (6, 2): 14}[(c.n_words, c.n_ref)]
    assert lay == {"consumer_warps": 4, "producer_warps": 4 * P, "K": K, "slots": 2,
                   "words": words, "smem_bytes": 2 * K * words * 128 * 4,
                   "design": "warp-specialised"}
    assert (K // P) % 2 == 0 and lay["smem_bytes"] <= 227 * 1024
    assert f"using DfimRecordRing = RingShape<{K}, {P}>;" in source
    ring_header = (csrc / "dfim_ring.cuh").read_text()
    assert "  return (FINITE ? 1 : 6) + kRefWords * NREF;" in ring_header
    assert ("ring_layout<DfimRecordRing>((flags[DF_FINITE] ? 1 : 6) + kRefWords * "
            "flags[DF_NREF], out);") in source


@pytest.mark.parametrize("env_id", ["Finite-CC-DFIM-v0", "Cont-SC-DFIM-v0"])
def test_record_random_args_follow_the_record_out_order(env_id):
    """The partial-width launcher's arguments: one ``(T, n_envs)`` tensor
    per recorded signal, of the recorder's types, and the C entry's output
    array (omega or NULL, the five other state planes, ref row 0, ref row 1
    or NULL, int32 stator and rotor bits or NULL, the six duties or NULL,
    reward, done) pointing at them; the envs and steps as given."""
    c = dff.DfimConsts(gt.make_functional(env_id, device="cpu"))
    T, n = 9, 37
    states = [torch.zeros((1, 128)) for _ in range(c.n_state)]
    outs, args = dff._record_random_args(c, 7, states, T, n)
    assert [x.dtype for x in outs] == list(dff.record_dtypes(c))
    assert all(x.shape == (T, n) for x in outs)
    assert args[3:5] == (n, T) and args[2] == 7
    it = iter(x.data_ptr() for x in outs)
    st = [next(it) for _ in range(c.n_state)]
    refs = [next(it) for _ in range(c.n_ref)]
    acts = [next(it) for _ in range(c.n_act)]
    want = (([] if c.mech else [None]) + st + refs + [None] * (2 - c.n_ref)
            + (acts + [None] * 6 if c.finite else [None] * 2 + acts) + list(it))
    assert list(args[6]) == want and len(want) == 18
