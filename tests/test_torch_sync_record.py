"""The synchronous family's random recorder on its ring, checked on the
CPU (the kernel itself runs only on a CUDA card; its card test is
``test_cuda_sync_record_random_equals_plain_version_bit_for_bit`` in
tests/test_torch_cuda_kernels.py).

* ``sync_record_ring_layout``, computed without the library, is the ring of
  csrc/fused_sync.cu's ``sync_record_ws_kernel`` on every id with the
  catalog's Wiener references, and one thread per env with constant ones.
* ``_record_random_args`` hands the C entry the planes the recorder
  returns, in the order of csrc/fused_sync.cu's RecordOut, NULL where an
  instance records no such signal.
"""

from pathlib import Path

import pytest
import torch

import gym_electric_motor_tpu_torch as gt
from gym_electric_motor_tpu_torch import references as rg
from gym_electric_motor_tpu_torch.ops import fused_sync_family as sf

CONST_REFS = {"CC": [("i_sd", 0.1), ("i_sq", -0.2)], "TC": [("torque", 0.3)],
              "SC": [("omega", 0.2)]}
CSRC = Path(sf.__file__).resolve().parent.parent / "csrc"


def consts(env_id, refs="wiener"):
    kw = {}
    if refs == "const":
        kw["reference_generator"] = rg.ReferenceSpec(
            [rg.ConstReference(n, v) for n, v in CONST_REFS[env_id.split("-")[1]]])
    c = sf.SyncConsts(gt.make_functional(env_id, device="cpu", **kw))
    assert c.all_const == (refs == "const")
    return c


RING_CASES = [(i, "wiener") for i in gt.SYNC_ENV_IDS] + [("Finite-CC-PMSM-v0", "const")]


@pytest.mark.parametrize("env_id,refs", RING_CASES, ids=[f"{i}-{r}" for i, r in RING_CASES])
def test_record_ring_layout_is_the_kernels_ring(env_id, refs):
    """sync_record_ring_layout is the ring of csrc/fused_sync.cu
    (SyncRecordRing; words a step: the B6 bits or the three duties, then
    four per reference row, draw_ring.cuh's b6_draw_words) with Wiener
    references: 4 consumer warps, P producer warps per consumer warp, two
    slots of K steps, each producer's steps pairing an even step with the
    odd one that takes its sine half; with constant references one thread
    per env."""
    c = consts(env_id, refs)
    lay = sf.sync_record_ring_layout(c)
    source = (CSRC / "fused_sync.cu").read_text()
    if refs == "const":
        assert lay == {"consumer_warps": 0, "producer_warps": 0, "K": 0, "slots": 0, "words": 0,
                       "smem_bytes": 0, "design": "one thread per env"}
        assert "  if (k.flag[F_ALL_CONST]) {\n    sync_record_random_kernel<F, M, NR>" in source
        return
    K, P = sf.SYNC_RECORD_RING
    words = c.n_act + 4 * c.n_ref
    assert words == {(1, 1): 5, (3, 1): 7, (1, 2): 9, (3, 2): 11}[(c.n_act, c.n_ref)]
    assert lay == {"consumer_warps": 4, "producer_warps": 4 * P, "K": K, "slots": 2,
                   "words": words, "smem_bytes": 2 * K * words * 128 * 4,
                   "design": "warp-specialised"}
    assert (K // P) % 2 == 0 and lay["smem_bytes"] <= 227 * 1024
    assert f"using SyncRecordRing = RingShape<{K}, {P}>;" in source
    ring_header = (CSRC / "draw_ring.cuh").read_text()
    assert "  return FINITE ? 1 : 3;" in ring_header
    assert "  return b6_ring_words<FINITE>() + kRefWords * NREF;" in ring_header
    assert ("ring_layout<SyncRecordRing>((flags[F_FINITE] ? 1 : 3) + kRefWords * flags[F_NREF], "
            "out);") in source


ARG_CASES = ["Finite-CC-PMSM-v0", "Cont-SC-SynRM-v0", "Cont-TC-PMSM-v0", "Finite-SC-SynRM-v0"]


@pytest.mark.parametrize("env_id", ARG_CASES)
def test_record_random_args_follow_the_record_out_order(env_id):
    """The partial-width launcher's arguments: one ``(T, n_envs)`` tensor
    per recorded signal, of the recorder's types, and the C entry's output
    array (omega or NULL, i_sd, i_sq, eps, ref row 0, ref row 1 or NULL,
    int32 action or NULL, action a, b, c or NULL, reward, done) pointing at
    them; the envs and steps as given."""
    c = consts(env_id)
    T, n = 9, 37
    states = [torch.zeros((1, 128)) for _ in range(c.n_state)]
    outs, args = sf._record_random_args(c, 7, states, T, n)
    assert [x.dtype for x in outs] == list(sf.record_dtypes(c))
    assert all(x.shape == (T, n) for x in outs)
    assert args[3:5] == (n, T) and args[2] == 7
    ptrs = list(args[6])
    it = iter(x.data_ptr() for x in outs)
    st = [next(it) for _ in range(c.n_state)]
    refs = [next(it) for _ in range(c.n_ref)]
    acts = [next(it) for _ in range(c.n_act)]
    want = (([] if c.mech else [None]) + st + refs + [None] * (2 - c.n_ref)
            + (acts + [None] * 3 if c.finite else [None] + acts) + list(it))
    assert len(ptrs) == 12 and ptrs == want
