"""The port's universal EESM-family rollout (``make_fused_eesm_family_rollout``
and the dispatch ``make_fused_rollout``, plain PyTorch versions on the CPU)
against the JAX package.

* Buffer mode: the same numpy action buffer from seeded start states with
  constant references through both packages' ``make_fused_eesm_family_rollout``
  (the JAX kernel in interpret mode, as tests/test_pallas_families.py runs
  it) for its five ``EESM_CASES``: rtol 1e-4 / atol 2e-3 (A, rad/s), the
  angle modulo 2 pi at atol 1e-4 (tests/test_pallas_families.py:61-72; XLA
  on the CPU contracts multiply-adds, so the two agree to a few ulps, not
  bit for bit).
* Random mode, replay: the plain random rollout driven by a test-only copy
  of the interpret bit source in the EESM kernel's draw order (the action
  words, nothing for the polynomial load's reset, the Box-Muller pairs, two
  with the three CC references, then the length, sigma and reset planes),
  against the JAX interpret kernel, in at least 99% of envs, on
  Finite-CC-EESM-v0 (three rows) and Cont-SC-EESM-v0.
* Random mode, statistics: the Philox plain version against the XLA env
  (``test_fused_eesm_family_stats``' bounds), and the three rows of
  Finite-CC-EESM-v0 each a Wiener process inside its margins.
* The dispatch of all six ids, their state arity (4, or 5 with the speed),
  the Philox words of the third row and the fourth duty, and the wrappers'
  CPU path.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_electric_motor_tpu as gemx
from gym_electric_motor_tpu.ops.pallas_rollout import (
    fused_state_arity as jax_arity,
    make_fused_eesm_family_rollout as jax_eesm_rollout,
)
import gym_electric_motor_tpu_torch as gt
from gym_electric_motor_tpu_torch.ops import fused_common as fc
from gym_electric_motor_tpu_torch.ops import fused_eesm_family as ef
from gym_electric_motor_tpu_torch.ops import fused_rollout as fr
from test_pallas_families import EESM_CASES
from test_pallas_rollout import N_STAT, T_STAT, _check_wiener_state, _xla_random_rollout
from test_torch_eesm import const_envs
from test_torch_sync_universal import XorshiftSyncBits, env_share

torch.set_num_threads(1)

BUF = dict(rtol=1e-4, atol=2e-3)


def action_buffer(finite, T, R, seed):
    """int32 (T, 2, R, 128) (B6 bits, 4QC) or float32 (T, 4, R, 128)."""
    rng = np.random.default_rng(seed)
    if finite:
        return np.stack([rng.integers(0, 8, (T, R, 128)), rng.integers(0, 4, (T, R, 128))],
                        axis=1).astype(np.int32)
    return rng.uniform(-1.0, 1.0, (T, 4, R, 128)).astype(np.float32)


def start_planes(c, R, seed, frac=0.85):
    """Speed (under a dynamic load) in [0, 100) rad/s, the three currents
    within ``frac`` times their limits, the angle in [0, 2 pi)."""
    rng = np.random.default_rng(seed)
    i_lim, ie_lim = 1.0 / c.f["inv_i_lim"], 1.0 / c.f["inv_ie_lim"]
    w = [rng.uniform(0, 100, (R, 128))] if c.mech else []
    cur = [rng.uniform(-frac * lim, frac * lim, (R, 128)) for lim in (i_lim, i_lim, ie_lim)]
    eps = [rng.uniform(0, 2 * np.pi, (R, 128))]
    return [x.astype(np.float32) for x in w + cur + eps]


def assert_angle(got, want, atol=1e-4):
    d = np.remainder(got - want, 2 * np.pi)
    np.testing.assert_allclose(np.minimum(d, 2 * np.pi - d), 0.0, atol=atol)


@pytest.mark.parametrize("env_id,finite,mech,ref_names", EESM_CASES,
                         ids=[c[0] for c in EESM_CASES])
def test_buffer_rollout_matches_jax_interpret(env_id, finite, mech, ref_names):
    jenv, tenv = const_envs(env_id, [(n, 0.0) for n in ref_names])
    N, T = 128, 50
    c = ef.EesmConsts(tenv)
    start = start_planes(c, 1, 3, frac=0.5)
    acts = action_buffer(finite, T, 1, 31)
    want = jax_eesm_rollout(jenv, T, N, action_mode="buffer", interpret=True)(
        *map(jnp.asarray, start), jnp.asarray(acts))
    got = fr.make_fused_rollout(tenv, T, N, action_mode="buffer")(
        *map(torch.as_tensor, start), torch.as_tensor(acts))
    assert len(got) == len(want) == c.n_state == (5 if mech else 4)
    for j, (g, w) in enumerate(zip(got, want)):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape == (1, 128)
        if j == c.n_state - 1:
            assert_angle(g, w)
        else:
            np.testing.assert_allclose(g, w, **BUF, err_msg=f"{env_id} state {j}")
    assert float(np.abs(got[-2].numpy() - start[-2]).max()) > 1.0  # i_e moved


class XorshiftEesmBits(XorshiftSyncBits):
    """The interpret bit source in the EESM kernel's order: as the
    synchronous family's, but three reference rows draw two Box-Muller pairs
    every step (u1, u2 of the first, then of the second,
    pallas_common.py:1379-1389), returned as lists as ``SyncBits`` does."""

    def step_words(self, t):
        if self.n_rows != 3 or self.all_const:
            return super().step_words(t)
        acts = [self._next()[:self.n] for _ in range(self.n_act)]
        u1a, u2a, u1b, u2b = (self._next()[:self.n] for _ in range(4))
        ln, sg, rs = self._next(), self._next(), self._next()
        return acts, [u1a, u1b], [u2a, u2b], self._rows(ln), self._rows(sg), self._rows(rs)


@pytest.mark.parametrize("env_id", ["Finite-CC-EESM-v0", "Cont-SC-EESM-v0"])
def test_random_rollout_replays_jax_interpret(env_id):
    jenv = gemx.make_functional(env_id)
    tenv = gt.make_functional(env_id, device="cpu")
    c = ef.EesmConsts(tenv)
    N, T, seed = 256, 64, 3
    start = start_planes(c, 2, 4, frac=1.1)  # some envs start outside the limits
    want = jax_eesm_rollout(jenv, T, N, interpret=True)(seed, *map(jnp.asarray, start))
    got = ef.eesm_rollout_random_plain(c, seed, tuple(map(torch.as_tensor, start)), T,
                                       bits=XorshiftEesmBits(seed, N, c.n_ref, c.n_words))
    assert len(got) == len(want) == c.n_state + 6
    assert got[c.n_state + 2].shape == (2 * c.n_ref, 128)
    assert float(np.asarray(want[c.n_state + 1]).sum()) > 0  # the replay crosses resets
    assert env_share([g.numpy() for g in got], want, c.n_state, N) >= 0.99


def _random_stats(env_id, n_state):
    tenv = gt.make_functional(env_id, device="cpu")
    z = torch.zeros((N_STAT // 128, 128))
    out = fr.make_fused_rollout(tenv, T_STAT, N_STAT)(3, *([z] * n_state))
    states, reward, terms = out[:n_state], out[n_state], out[n_state + 1]
    assert all(bool(torch.isfinite(s).all()) for s in states)
    return (tenv, [x.numpy() for x in out[n_state + 2:]],
            float(reward.sum()) / (N_STAT * T_STAT), float(terms.sum()) / (N_STAT * T_STAT))


@pytest.mark.parametrize("env_id,n_state", [("Finite-SC-EESM-v0", 5), ("Cont-TC-EESM-v0", 4),
                                            ("Finite-CC-EESM-v0", 4)],
                         ids=["Finite-SC-EESM-v0", "Cont-TC-EESM-v0", "Finite-CC-EESM-v0"])
def test_random_rollout_statistics_match_jax_env(env_id, n_state):
    """``test_fused_eesm_family_stats`` for the Philox plain version; with
    three references each row's Wiener state is checked on its own rows of
    the ``(3 R, 128)`` planes."""
    tenv, (rv, rk, rl, rs), mean_r, term_rate = _random_stats(env_id, n_state)
    R = N_STAT // 128
    for j, sub in enumerate(tenv.reference_generator.subs):
        margin = max(abs(sub.margin[0]), abs(sub.margin[1]))
        rows = slice(j * R, (j + 1) * R)
        _check_wiener_state(rv[rows], rk[rows], rl[rows], rs[rows], margin, *sub.sigma_range)
    xla_mean_r, xla_term_rate = _xla_random_rollout(env_id, N_STAT, T_STAT)
    assert abs(mean_r - xla_mean_r) < 0.08
    assert abs(term_rate - xla_term_rate) < max(0.5 * max(term_rate, xla_term_rate), 2e-3)


@pytest.mark.parametrize("env_id", gt.EESM_ENV_IDS)
def test_dispatch_routes_each_eesm_id(env_id):
    tenv = gt.make_functional(env_id, device="cpu")
    n_state = fr.fused_state_arity(tenv)
    assert n_state == jax_arity(gemx.make_functional(env_id)) == (5 if "-SC-" in env_id else 4)
    assert fr.family_of(tenv) == "eesm"
    roll = fr.make_fused_rollout(tenv, 3, 128)
    assert isinstance(roll.consts, ef.EesmConsts) and roll.consts.n_state == n_state
    assert roll.consts.n_ref == (3 if "-CC-" in env_id else 1)
    out = roll(1, *([torch.zeros((1, 128))] * n_state))
    assert len(out) == n_state + 6 and all(bool(torch.isfinite(x).all()) for x in out)


def test_philox_words_of_the_third_row_and_the_fourth_duty():
    """Three rows and four duties: the second Box-Muller pair and row 2's
    length and sigma from SLOT_ROW2, its reset value from SLOT_RESET's third
    word, its initial draws from SLOT_INIT_C, the excitation duty from
    SLOT_ACTION_C's second word; rows 0 and 1 keep the two-row words."""
    bits = fc.SyncBits(9, 256, "cpu", 3, 4)
    env = torch.arange(256, dtype=torch.int64)

    def call(t, slot):
        return fc.philox4x32(env, torch.tensor(t), torch.tensor(slot), torch.tensor(0),
                             *fc.seed_key(9))
    step, params, reset = call(7, fc.SLOT_STEP), call(7, fc.SLOT_PARAMS), call(7, fc.SLOT_RESET)
    row2, act_c = call(7, fc.SLOT_ROW2), call(7, fc.SLOT_ACTION_C)
    acts, u1, u2, lens, sigs, resets = bits.step_words(7)
    for got, want in ((acts, [step[0], step[3], act_c[0], act_c[1]]), (u1, [step[1], row2[0]]),
                      (u2, [step[2], row2[1]]), (lens, [params[0], params[1], row2[2]]),
                      (sigs, [params[2], params[3], row2[3]]),
                      (resets, [reset[0], reset[1], reset[2]])):
        assert len(got) == len(want) and all(torch.equal(g, w) for g, w in zip(got, want))
    vals, lens0, sigs0 = bits.init_words()
    init_c = call(0, fc.SLOT_INIT_C)
    assert torch.equal(vals[2], init_c[0]) and torch.equal(lens0[2], init_c[1])
    assert torch.equal(sigs0[2], init_c[2])
    two = fc.SyncBits(9, 256, "cpu", 2, 3)
    assert all(torch.equal(a, b) for a, b in zip(two.init_words()[0], vals[:2]))


def test_wrappers_take_plain_path_on_cpu_and_validate():
    tenv = gt.make_functional("Cont-SC-EESM-v0", device="cpu")
    c = ef.EesmConsts(tenv)
    z = torch.zeros((1, 128))
    ef.reset_launches()
    out = ef.eesm_rollout_random(c, 1, (z,) * 5, 5)
    ref = ef.eesm_rollout_random_plain(c, 1, (z,) * 5, 5)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert all(v == 0 for v in ef.LAUNCHES.values())
    assert c.host.dtype == np.float32
    assert len(c.host) == len(ef.CONST_NAMES) + ef.N_ROWS * len(fc.ROW_NAMES)
    assert c.f["two_thirds"] == float(np.float32(2.0 / 3.0))
    with pytest.raises(ValueError, match="5 state planes"):
        ef.eesm_rollout_random(c, 1, (z,) * 4, 5)
    with pytest.raises(TypeError):
        ef.eesm_rollout_random(c, 1, (z, z, z, z, z.double()), 5)
    with pytest.raises(ValueError):  # continuous takes (T, 4, R, 128)
        ef.eesm_rollout_buffer(c, (z,) * 5, torch.zeros((5, 3, 1, 128)))
    fin = ef.EesmConsts(gt.make_functional("Finite-CC-EESM-v0", device="cpu"))
    with pytest.raises(TypeError):  # finite takes int32 (T, 2, R, 128)
        ef.eesm_rollout_buffer(fin, (z,) * 4, torch.zeros((5, 2, 1, 128)))
    with pytest.raises(ValueError, match="action buffer"):
        fr.make_fused_rollout(tenv, 6, 128, action_mode="buffer")(
            *(z,) * 5, torch.zeros((5, 4, 1, 128)))


def test_constants_follow_the_jax_kernel_rounding():
    """At constant speed the omega products are host constants formed in
    double precision, as the JAX kernel forms them from Python floats;
    under the speed ODE they are float32 products of float32 constants that
    multiply omega, as XLA folds them; divisions by sigma are products with
    its float32 reciprocal."""
    env = gt.make_functional("Finite-CC-EESM-v0", device="cpu")
    cc = ef.EesmConsts(env)
    sc = ef.EesmConsts(gt.make_functional("Cont-SC-EESM-v0", device="cpu"))
    mp = {k: float(v) for k, v in env.physical_system.motor.parameter.items()}
    f32 = np.float32
    assert cc.f["w_sq_d"] == float(f32(mp["l_d"] * mp["p"] * 100.0))
    assert sc.f["w_sq_d"] == float(f32(mp["p"]) * f32(mp["l_d"]))
    assert cc.f["inv_sig"] == sc.f["inv_sig"] == float(f32(1.0) / f32(
        1.0 - (mp["k"] * 1.5 * mp["l_m"]) ** 2 / (mp["l_d"] * mp["k"] ** 2 * 1.5 * mp["l_e"])))
    assert not cc.mech and sc.mech and cc.n_ref == 3 and sc.n_ref == 1
    assert cc.f["d_eps"] == 300.0 and sc.f["d_eps"] == 0.0
    assert [r["name"] for r in cc.rows] == ["i_sd", "i_sq", "i_e"]
    assert (cc.rows[2]["mlo"], cc.rows[2]["mhi"]) == (0.0, 1.0)  # i_e's limit margin (0, 1)
