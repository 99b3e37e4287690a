"""The port's specialised AC builders (``ops/fused_induction.py``:
Cont-TC-SCIM; ``ops/fused_eesm.py``: Finite-CC-EESM; ``ops/fused_dfim.py``:
Cont-CC-DFIM) against the JAX package's Pallas kernels, run in interpret
mode on the CPU as tests/test_pallas_rollout.py runs them.

* Buffer modes: the same numpy action buffer through both packages'
  builders, at the JAX suite's tolerances against the env
  (tests/test_pallas_rollout.py:96-117, :262-300, :302-320), here kernel
  against kernel at rtol 1e-5 / atol 1e-4, angles modulo 2 pi.
* Random modes, replay: the plain version driven by a copy of the
  interpret-mode xorshift in the JAX kernels' draw order against the JAX
  interpret kernel, at least 99% of envs within rtol 1e-4 / atol 1e-4.  The
  EESM's rng scratch is (3R, 128) and the DFIM's (2R, 128): every draw steps
  the whole scratch, the (R, 128) action draws too (pallas_eesm.py:285-289).
* Random modes, in distribution: the Wiener state, mean reward and
  termination rate against the XLA env within the JAX suite's bounds
  (tests/test_pallas_rollout.py:234-255, :322-350, :352-373), at 1000 steps.
* Each builder raises where the JAX builder raises, with the same type.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_electric_motor_tpu as gemx
from gym_electric_motor_tpu.ops import pallas_rollout as jpr
import gym_electric_motor_tpu_torch as gt
from gym_electric_motor_tpu_torch.ops import fused_dfim as ff
from gym_electric_motor_tpu_torch.ops import fused_eesm as fe
from gym_electric_motor_tpu_torch.ops import fused_induction as fi
from gym_electric_motor_tpu_torch.ops import fused_rollout as fr
from test_pallas_rollout import _check_wiener_state, _xla_random_rollout
from test_torch_dc_specialised import XorshiftBits, _envs, _planes, _raises, _replay_share

torch.set_num_threads(1)

BUF = dict(rtol=1e-5, atol=1e-4)
TWO_PI = 2 * np.pi


def _assert_angle(got, want):
    d = np.remainder(got - want, TWO_PI)
    np.testing.assert_allclose(np.minimum(d, TWO_PI - d), 0.0, atol=1e-4)


class ScimXorshift(XorshiftBits):
    """The SCIM kernel's draw order (pallas_induction.py:138-201): init
    (value, length, sigma); per step three duties, at even steps the
    Box-Muller pair, then length, sigma and reset value."""

    def init_words(self):
        return {"value": self.next(), "len": self.next(), "sig": self.next()}

    def step_words(self, t):
        w = {"da": self.next(), "db": self.next(), "dc": self.next()}
        w["u1"], w["u2"] = (self.next(), self.next()) if t % 2 == 0 else (None, None)
        w["len"], w["sig"], w["reset"] = self.next(), self.next(), self.next()
        return w


class RowsXorshift(XorshiftBits):
    """The EESM (three rows) and DFIM (two rows) kernels' draw order on their
    (rows R, 128) rng scratch: an (R, 128) draw takes the first R rows, a
    row-plane draw all of them, one slice per reference row."""

    def __init__(self, seed, n, n_rows, step_roles):
        super().__init__(seed, n, rows=n_rows * n // 128)
        self.n_rows, self.step_roles = n_rows, step_roles

    def rows_draw(self):
        v = self.next(self.n_rows * self.n)
        return [v[j * self.n:(j + 1) * self.n] for j in range(self.n_rows)]

    def init_words(self):
        return {"value": self.rows_draw(), "len": self.rows_draw(), "sig": self.rows_draw()}

    def step_words(self, t):
        w = {}
        for role in self.step_roles:
            if role == "duties":
                w[role] = [self.next() for _ in range(6)]
            else:
                w[role] = self.next()
        w["len"], w["sig"], w["reset"] = self.rows_draw(), self.rows_draw(), self.rows_draw()
        return w


def eesm_xorshift(seed, n):
    """pallas_eesm.py:176-250: the action word, u1, u2, u3, u4, then the
    (3R, 128) length, sigma and reset draws."""
    return RowsXorshift(seed, n, 3, ("action", "u1", "u2", "u3", "u4"))


def dfim_xorshift(seed, n):
    """pallas_dfim.py:174-258: six duties, u1, u2, then the (2R, 128)
    length, sigma and reset draws."""
    return RowsXorshift(seed, n, 2, ("duties", "u1", "u2"))


CASES = {
    "scim": dict(env_id="Cont-TC-SCIM-v0", n_state=4, angle=None,
                 jax=jpr.make_fused_scim_rollout, torch=fr.make_fused_scim_rollout,
                 consts=fi.ScimConsts, plain=fi.scim_rollout_random_plain, bits=ScimXorshift,
                 start=[(-5, 5), (-5, 5), (-1, 1), (-1, 1)]),
    "eesm": dict(env_id="Finite-CC-EESM-v0", n_state=4, angle=3,
                 jax=jpr.make_fused_eesm_rollout, torch=fr.make_fused_eesm_rollout,
                 consts=fe.EesmCcConsts, plain=fe.eesm_cc_rollout_random_plain,
                 bits=eesm_xorshift, start=[(-5, 5), (-5, 5), (-5, 5), (0, TWO_PI)]),
    "dfim": dict(env_id="Cont-CC-DFIM-v0", n_state=5, angle=4,
                 jax=jpr.make_fused_dfim_rollout, torch=fr.make_fused_dfim_rollout,
                 consts=ff.DfimCcConsts, plain=ff.dfim_cc_rollout_random_plain,
                 bits=dfim_xorshift, start=[(-5, 5), (-5, 5), (-1, 1), (-1, 1), (0, TWO_PI)]),
}


def _actions(name, rng, T):
    if name == "scim":
        return rng.uniform(-1.0, 1.0, (T, 3, 1, 128)).astype(np.float32)
    if name == "eesm":
        return np.stack([rng.integers(0, 8, (T, 1, 128)), rng.integers(0, 4, (T, 1, 128))],
                        axis=1).astype(np.int32)
    return rng.uniform(-1.0, 1.0, (T, 6, 1, 128)).astype(np.float32)


@pytest.mark.parametrize("name", sorted(CASES))
def test_buffer_matches_jax_interpret(name):
    case = CASES[name]
    jenv, tenv = _envs(case["env_id"])
    N, T = 128, 50
    rng = np.random.default_rng(3)
    acts = _actions(name, rng, T)
    start = _planes(rng, case["start"])
    want = case["jax"](jenv, T, N, action_mode="buffer", interpret=True)(
        *map(jnp.asarray, start), jnp.asarray(acts))
    got = case["torch"](tenv, T, N, action_mode="buffer")(
        *map(torch.as_tensor, start), torch.as_tensor(acts))
    assert len(got) == len(want) == case["n_state"]
    for j, (g, w) in enumerate(zip(got, want)):
        if j == case["angle"]:
            _assert_angle(g.numpy(), np.asarray(w))
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **BUF)


@pytest.mark.parametrize("name", sorted(CASES))
def test_random_mode_replays_jax_interpret_kernel(name):
    case = CASES[name]
    jenv, tenv = _envs(case["env_id"])
    N, T, seed = 256, 60, 3
    start = _planes(np.random.default_rng(6), case["start"], rows=2)
    want = case["jax"](jenv, T, N, interpret=True)(seed, *map(jnp.asarray, start))
    got = case["plain"](case["consts"](tenv), seed, [torch.as_tensor(x) for x in start], T,
                        bits=case["bits"](seed, N))
    assert len(got) == len(want)
    assert _replay_share(got, want, N) >= 0.99


N_STAT, T_STAT = 256, 1000


@pytest.mark.parametrize("name", sorted(CASES))
def test_random_mode_statistics_match_xla_env(name):
    case = CASES[name]
    tenv = gt.make_functional(case["env_id"], device="cpu")
    z = torch.zeros((2, 128))
    out = case["torch"](tenv, T_STAT, N_STAT)(3, *[z] * case["n_state"])
    n = case["n_state"]
    reward, terms, rv, rk, rl, rs = (x.numpy() for x in out[n:])
    c = case["consts"](tenv).f
    if name == "eesm":
        # symmetric i_sd*, i_sq* bands, the one-sided (0, 1) i_e* band
        R = N_STAT // 128
        assert np.all(np.abs(rv[:2 * R]) <= c["m_sd"] * 1.001)
        assert rv[2 * R:].min() >= 0.0 and rv[2 * R:].max() <= 1.001
        assert rl.min() >= 500.0 and rl.max() < 2000.0
        assert rs.min() >= 1e-3 * 0.999 and rs.max() <= 1e-1 * 1.001
        assert np.all(rk >= 1.0) and np.all(rk <= rl)
    else:
        _check_wiener_state(rv, rk, rl, rs, c["margin"], 1e-3, 1e-1)
    mean_r = float(reward.sum()) / (N_STAT * T_STAT)
    term_rate = float(terms.sum()) / (N_STAT * T_STAT)
    xla_mean_r, xla_term_rate = _xla_random_rollout(case["env_id"], N_STAT, T_STAT)
    assert abs(mean_r - xla_mean_r) < 0.08
    assert abs(term_rate - xla_term_rate) < max(0.5 * max(term_rate, xla_term_rate), 2e-3)
    for x in out[:n]:
        assert np.all(np.isfinite(x.numpy()))
    if case["angle"] is not None:
        eps = out[case["angle"]].numpy()
        assert np.all(eps >= 0.0) and np.all(eps <= TWO_PI)


@pytest.mark.parametrize("name,mod", [("scim", fi), ("eesm", fe), ("dfim", ff)])
def test_wrappers_take_plain_path_on_cpu_and_validate(name, mod):
    case = CASES[name]
    tenv = gt.make_functional(case["env_id"], device="cpu")
    c = case["consts"](tenv)
    z = torch.zeros((1, 128))
    mod.reset_launches()
    random = getattr(mod, mod.KERNELS[0])
    out = random(c, 1, [z] * case["n_state"], 5)
    for a, b in zip(out, case["plain"](c, 1, [z] * case["n_state"], 5)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert all(v == 0 for v in mod.LAUNCHES.values()) and set(mod.LAUNCHES) == set(mod.KERNELS)
    with pytest.raises(TypeError):
        random(c, 1, [z.double()] + [z] * (case["n_state"] - 1), 5)
    with pytest.raises(ValueError):
        random(c, 1, [z] * (case["n_state"] - 1), 5)
    buffer = getattr(mod, mod.KERNELS[1])
    acts = torch.as_tensor(_actions(name, np.random.default_rng(0), 5))
    wrong = acts.float() if acts.dtype == torch.int32 else acts.int()
    with pytest.raises(TypeError):
        buffer(c, [z] * case["n_state"], wrong)
    with pytest.raises(ValueError):
        buffer(c, [z] * case["n_state"], acts[:, :1])


@pytest.mark.parametrize("name,env_id,n_envs,kw,want", [
    ("scim", "Cont-TC-SCIM-v0", 256, dict(constraints=()), NotImplementedError),
    ("scim", "Cont-TC-SCIM-v0", 300, {}, AssertionError),
    ("scim", "Cont-SC-SCIM-v0", 256, {}, NotImplementedError),
    ("eesm", "Finite-CC-EESM-v0", 256, dict(constraints=()), NotImplementedError),
    ("eesm", "Finite-CC-EESM-v0", 129, {}, AssertionError),
    ("eesm", "Finite-SC-EESM-v0", 256, {}, NotImplementedError),
    ("dfim", "Cont-CC-DFIM-v0", 256, dict(constraints=()), NotImplementedError),
    ("dfim", "Cont-CC-DFIM-v0", 64, {}, AssertionError),
    ("dfim", "Cont-SC-DFIM-v0", 256, {}, NotImplementedError),
])
def test_builders_raise_where_jax_raises(name, env_id, n_envs, kw, want):
    case = CASES[name]
    assert _raises(case["jax"], case["torch"], env_id, n_envs, **kw) is want


@pytest.mark.parametrize("name,converter", [
    ("scim", lambda cv: cv.finite_b6_bridge_converter(1e-4)),
    ("eesm", lambda cv: cv.cont_multi_converter([cv.cont_b6_bridge_converter(1e-5),
                                                 cv.cont_four_quadrant_converter(1e-5)], 1e-5)),
    ("dfim", lambda cv: cv.finite_multi_converter([cv.finite_b6_bridge_converter(1e-4)] * 2,
                                                  1e-4)),
])
def test_builders_reject_an_action_kind_they_do_not_take(name, converter):
    """Each kernel steps its family's physics for the action kind its id
    has (continuous duties for Cont-TC-SCIM and Cont-CC-DFIM, B6 bits and a
    4QC command for Finite-CC-EESM): a converter of the other kind raises,
    where the JAX builder would draw its own kind regardless."""
    from gym_electric_motor_tpu_torch.models import converters as tcv

    case = CASES[name]
    tenv = gt.make_functional(case["env_id"], device="cpu", converter=converter(tcv))
    with pytest.raises(NotImplementedError, match="make_fused_rollout"):
        case["torch"](tenv, 8, 256)


@pytest.mark.parametrize("name", sorted(CASES))
def test_buffer_matches_the_universal_buffer_kernel(name):
    """On the same id and buffer, the specialised buffer rollout against the
    universal family kernel's plain version, reached through the dispatch,
    at rtol 1e-5 / atol 1e-4 (angles modulo 2 pi)."""
    case = CASES[name]
    tenv = gt.make_functional(case["env_id"], device="cpu")
    N, T = 128, 64
    rng = np.random.default_rng(12)
    acts = torch.as_tensor(_actions(name, rng, T))
    start = [torch.as_tensor(x) for x in _planes(rng, case["start"])]
    got = case["torch"](tenv, T, N, action_mode="buffer")(*start, acts)
    want = fr.make_fused_rollout(tenv, T, N, action_mode="buffer")(*start, acts)
    assert len(got) == len(want) == case["n_state"]
    for j, (g, w) in enumerate(zip(got, want)):
        if j == case["angle"]:
            _assert_angle(g.numpy(), w.numpy())
        else:
            torch.testing.assert_close(g, w, **BUF)


def test_scim_tc_ring_layout_is_the_kernels_ring():
    """scim_tc_ring_layout, computed without the library, is the ring of
    csrc/fused_scim_tc.cu (ScimRing, 7 words a step): 4 consumer warps, P
    producer warps per consumer warp, two slots of K steps, each producer's
    steps pairing an even step with the odd one that takes its sine half."""
    lay = fi.scim_tc_ring_layout()
    K, P = fi.SCIM_TC_RING
    assert lay == {"consumer_warps": 4, "producer_warps": 4 * P, "K": K, "slots": 2, "words": 7,
                   "smem_bytes": 2 * K * 7 * 128 * 4, "design": "warp-specialised"}
    assert (K // P) % 2 == 0 and lay["smem_bytes"] <= 227 * 1024
    source = (Path(fi.__file__).resolve().parent.parent / "csrc" / "fused_scim_tc.cu").read_text()
    assert f"using ScimRing = RingShape<{K}, {P}>;" in source
    assert f"constexpr int kScimWords = {fi.SCIM_TC_RING_WORDS};" in source
