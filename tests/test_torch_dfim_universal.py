"""The port's universal DFIM-family rollout (``make_fused_dfim_family_rollout``
and the dispatch ``make_fused_rollout``, plain PyTorch versions on the CPU)
against the JAX package.

* Buffer mode: the same numpy action buffer from seeded start states with
  constant references through both packages' ``make_fused_dfim_family_rollout``
  (the JAX kernel in interpret mode, as tests/test_pallas_families.py runs
  it) on all six ids, Cont-CC-DFIM-v0 besides the JAX suite's five
  ``DFIM_CASES``: rtol 1e-4 / atol 2e-3 (A, Wb, rad/s), the angle modulo
  2 pi at atol 1e-4 (tests/test_pallas_families.py:61-72; XLA on the CPU
  contracts multiply-adds, so the two agree to a few ulps, not bit for
  bit).
* Random mode, replay: the plain random rollout driven by the test-only
  xorshift copy of the interpret bit source (tests/test_torch_sync_universal.py;
  the DFIM draws the action words, one finite or six continuous, nothing
  for the polynomial load's reset, then the reference draws), against the
  JAX interpret kernel, in at least 99% of envs, on Finite-CC-DFIM-v0 (two
  references, the flux direction, the incremental rotation) and
  Cont-SC-DFIM-v0 (six duties, the speed ODE).
* Random mode, statistics: the Philox plain version against the XLA env
  (``test_fused_dfim_family_stats``' bounds).
* The dispatch of all six ids, their state arity (5, or 6 with the speed),
  the Philox words of the six duties, the wrappers' CPU path and the
  constants' rounding.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_electric_motor_tpu as gemx
from gym_electric_motor_tpu.ops.pallas_rollout import (
    fused_state_arity as jax_arity,
    make_fused_dfim_family_rollout as jax_dfim_rollout,
)
import gym_electric_motor_tpu_torch as gt
from gym_electric_motor_tpu_torch.models import motors as tmt
from gym_electric_motor_tpu_torch.ops import fused_common as fc
from gym_electric_motor_tpu_torch.ops import fused_dfim_family as dff
from gym_electric_motor_tpu_torch.ops import fused_rollout as fr
from test_pallas_families import DFIM_CASES
from test_pallas_rollout import N_STAT, T_STAT, _check_wiener_state, _xla_random_rollout
from test_torch_dfim import const_envs
from test_torch_sync_universal import XorshiftSyncBits, env_share

torch.set_num_threads(1)

BUF = dict(rtol=1e-4, atol=2e-3)
BUFFER_CASES = [(c[0], c[1], c[2], c[3]) for c in DFIM_CASES] + [
    ("Cont-CC-DFIM-v0", False, False, ["i_sd", "i_sq"])]


def action_buffer(finite, T, R, seed):
    """int32 (T, 2, R, 128) (stator bits, rotor bits) or float32
    (T, 6, R, 128) duties."""
    rng = np.random.default_rng(seed)
    if finite:
        return rng.integers(0, 8, (T, 2, R, 128)).astype(np.int32)
    return rng.uniform(-1.0, 1.0, (T, 6, R, 128)).astype(np.float32)


def start_planes(c, R, seed, frac=0.85):
    """Speed (under a dynamic load) in [0, 100) rad/s, the stator currents
    within ``frac`` times the limit, the fluxes within 1 Wb, the angle in
    [0, 2 pi)."""
    rng = np.random.default_rng(seed)
    i_lim = 1.0 / np.sqrt(c.f["inv_ilim2"])
    w = [rng.uniform(0, 100, (R, 128))] if c.mech else []
    cur = [rng.uniform(-frac * i_lim, frac * i_lim, (R, 128)) for _ in range(2)]
    flux = [rng.uniform(-1.0, 1.0, (R, 128)) for _ in range(2)]
    eps = [rng.uniform(0, 2 * np.pi, (R, 128))]
    return [x.astype(np.float32) for x in w + cur + flux + eps]


def assert_angle(got, want, atol=1e-4):
    d = np.remainder(got - want, 2 * np.pi)
    np.testing.assert_allclose(np.minimum(d, 2 * np.pi - d), 0.0, atol=atol)


@pytest.mark.parametrize("env_id,finite,mech,ref_names", BUFFER_CASES,
                         ids=[c[0] for c in BUFFER_CASES])
def test_buffer_rollout_matches_jax_interpret(env_id, finite, mech, ref_names):
    jenv, tenv = const_envs(env_id, [(n, 0.0) for n in ref_names])
    N, T = 128, 50
    c = dff.DfimConsts(tenv)
    start = start_planes(c, 1, 3, frac=0.5)
    acts = action_buffer(finite, T, 1, 31)
    want = jax_dfim_rollout(jenv, T, N, action_mode="buffer", interpret=True)(
        *map(jnp.asarray, start), jnp.asarray(acts))
    got = fr.make_fused_rollout(tenv, T, N, action_mode="buffer")(
        *map(torch.as_tensor, start), torch.as_tensor(acts))
    assert len(got) == len(want) == c.n_state == (6 if mech else 5)
    for j, (g, w) in enumerate(zip(got, want)):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape == (1, 128)
        if j == c.n_state - 1:
            assert_angle(g, w)
        else:
            np.testing.assert_allclose(g, w, **BUF, err_msg=f"{env_id} state {j}")
    # the rotor flux moved under the rotor voltages
    assert float(np.abs(got[-2].numpy() - start[-2]).max()) > 0.05


@pytest.mark.parametrize("env_id", ["Finite-CC-DFIM-v0", "Cont-SC-DFIM-v0"])
def test_random_rollout_replays_jax_interpret(env_id):
    jenv = gemx.make_functional(env_id)
    tenv = gt.make_functional(env_id, device="cpu")
    c = dff.DfimConsts(tenv)
    N, T, seed = 256, 64, 3
    start = start_planes(c, 2, 4, frac=1.1)  # some envs start outside the limit
    want = jax_dfim_rollout(jenv, T, N, interpret=True)(seed, *map(jnp.asarray, start))
    got = dff.dfim_rollout_random_plain(c, seed, tuple(map(torch.as_tensor, start)), T,
                                        bits=XorshiftSyncBits(seed, N, c.n_ref, c.n_words))
    assert len(got) == len(want) == c.n_state + 6
    assert got[c.n_state + 2].shape == (2 * c.n_ref, 128)
    assert float(np.asarray(want[c.n_state + 1]).sum()) > 0  # the replay crosses resets
    assert env_share([g.numpy() for g in got], want, c.n_state, N) >= 0.99


@pytest.mark.parametrize("env_id,n_state", [("Finite-TC-DFIM-v0", 5), ("Cont-SC-DFIM-v0", 6)],
                         ids=["Finite-TC-DFIM-v0", "Cont-SC-DFIM-v0"])
def test_random_rollout_statistics_match_jax_env(env_id, n_state):
    """``test_fused_dfim_family_stats`` for the Philox plain version."""
    tenv = gt.make_functional(env_id, device="cpu")
    sub = tenv.reference_generator.subs[0]
    z = torch.zeros((N_STAT // 128, 128))
    out = fr.make_fused_rollout(tenv, T_STAT, N_STAT)(3, *([z] * n_state))
    states, reward, terms = out[:n_state], out[n_state], out[n_state + 1]
    rv, rk, rl, rs = (x.numpy() for x in out[n_state + 2:])
    margin = max(abs(sub.margin[0]), abs(sub.margin[1]))
    _check_wiener_state(rv, rk, rl, rs, margin, *sub.sigma_range)
    mean_r = float(reward.sum()) / (N_STAT * T_STAT)
    term_rate = float(terms.sum()) / (N_STAT * T_STAT)
    xla_mean_r, xla_term_rate = _xla_random_rollout(env_id, N_STAT, T_STAT)
    assert abs(mean_r - xla_mean_r) < 0.08
    assert abs(term_rate - xla_term_rate) < max(0.5 * max(term_rate, xla_term_rate), 2e-3)
    assert all(bool(torch.isfinite(s).all()) for s in states)


@pytest.mark.parametrize("env_id", gt.DFIM_ENV_IDS)
def test_dispatch_routes_each_dfim_id(env_id):
    tenv = gt.make_functional(env_id, device="cpu")
    n_state = fr.fused_state_arity(tenv)
    assert n_state == jax_arity(gemx.make_functional(env_id)) == (6 if "-SC-" in env_id else 5)
    assert fr.family_of(tenv) == "dfim"
    roll = fr.make_fused_rollout(tenv, 3, 128)
    assert isinstance(roll.consts, dff.DfimConsts) and roll.consts.n_state == n_state
    assert roll.consts.n_ref == (2 if "-CC-" in env_id else 1)
    out = roll(1, *([torch.zeros((1, 128))] * n_state))
    assert len(out) == n_state + 6 and all(bool(torch.isfinite(x).all()) for x in out)


def test_philox_words_of_the_six_duties():
    """Six duties: the stator's from SLOT_STEP's words 0 and 3 and
    SLOT_ACTION_C's word 0, the rotor's from SLOT_ACTION_C's words 1 to 3;
    the one-, three- and four-duty sources keep the words they drew
    before."""
    env = torch.arange(256, dtype=torch.int64)

    def call(t, slot):
        return fc.philox4x32(env, torch.tensor(t), torch.tensor(slot), torch.tensor(0),
                             *fc.seed_key(9))
    step, act_c = call(7, fc.SLOT_STEP), call(7, fc.SLOT_ACTION_C)
    want = [step[0], step[3], act_c[0], act_c[1], act_c[2], act_c[3]]
    for n_act in (1, 3, 4, 6):
        acts = fc.SyncBits(9, 256, "cpu", 1, n_act).step_words(7)[0]
        assert len(acts) == n_act
        assert all(torch.equal(a, w) for a, w in zip(acts, want[:1] if n_act == 1 else want))
    assert all(torch.equal(a, w)
               for a, w in zip(fc.SyncBits(9, 256, "cpu", 1, 2).step_words(7)[0], want[:2]))


def test_wrappers_take_plain_path_on_cpu_and_validate():
    tenv = gt.make_functional("Cont-SC-DFIM-v0", device="cpu")
    c = dff.DfimConsts(tenv)
    z = torch.zeros((1, 128))
    dff.reset_launches()
    out = dff.dfim_rollout_random(c, 1, (z,) * 6, 5)
    ref = dff.dfim_rollout_random_plain(c, 1, (z,) * 6, 5)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert all(v == 0 for v in dff.LAUNCHES.values())
    assert c.host.dtype == np.float32
    assert len(c.host) == len(dff.CONST_NAMES) + 2 * len(fc.ROW_NAMES)
    assert c.f["two_thirds"] == float(np.float32(2.0 / 3.0))
    with pytest.raises(ValueError, match="6 state planes"):
        dff.dfim_rollout_random(c, 1, (z,) * 5, 5)
    with pytest.raises(TypeError):
        dff.dfim_rollout_random(c, 1, (z,) * 5 + (z.double(),), 5)
    with pytest.raises(ValueError):  # continuous takes (T, 6, R, 128)
        dff.dfim_rollout_buffer(c, (z,) * 6, torch.zeros((5, 3, 1, 128)))
    fin = dff.DfimConsts(gt.make_functional("Finite-CC-DFIM-v0", device="cpu"))
    with pytest.raises(TypeError):  # finite takes int32 (T, 2, R, 128)
        dff.dfim_rollout_buffer(fin, (z,) * 5, torch.zeros((5, 2, 1, 128)))
    with pytest.raises(ValueError, match="action buffer"):
        fr.make_fused_rollout(tenv, 6, 128, action_mode="buffer")(
            *(z,) * 6, torch.zeros((5, 6, 1, 128)))
    with pytest.raises(NotImplementedError, match="need a DFIM"):
        dff.DfimConsts(gt.make_functional("Cont-SC-SCIM-v0", device="cpu"))


def test_constants_follow_the_jax_family_order():
    """The motor constants in double precision in _dfim_family's order,
    rounded once; at constant speed c_w omega and p omega are host constants
    (and p omega the angle rate), under the speed ODE the kernels multiply
    the plane; the rotation increment is cos/sin of tau p omega."""
    cc = dff.DfimConsts(gt.make_functional("Finite-CC-DFIM-v0", device="cpu"))
    sc = dff.DfimConsts(gt.make_functional("Cont-SC-DFIM-v0", device="cpu"))
    mp = {k: float(v) for k, v in tmt.dfim().parameter.items()}
    l_m, r_s, r_r, p = mp["l_m"], mp["r_s"], mp["r_r"], mp["p"]
    l_s, l_r = l_m + mp["l_sigs"], l_m + mp["l_sigr"]
    sg = (l_s * l_r - l_m**2) / (l_s * l_r)
    f32 = np.float32
    assert cc.f["c_ur"] == float(f32(l_m / (sg * l_r * l_s)))
    assert cc.f["inv_tau_sig"] == float(f32(1.0) / f32(sg * l_s / (r_s + r_r * (l_m**2 / l_r**2))))
    assert cc.f["c_psi"] == float(f32(l_m * r_r / (sg * l_s * l_r**2)))
    assert cc.f["cw_w"] == float(f32(l_m * p / (sg * l_r * l_s) * 100.0))
    assert cc.f["pw"] == 200.0 and sc.f["pw"] == 0.0 and sc.f["cw_w"] == 0.0
    assert cc.f["cos_d"] == float(f32(np.cos(1e-5 * 200.0)))
    assert not cc.mech and sc.mech and cc.needs_dq and not sc.needs_dq
    assert cc.n_act == cc.n_words * 2 == 2 and sc.n_act == sc.n_words == 6
    assert sc.f["inv_jt"] == float(np.float32(1.0 / (1e-5 + 13.695e-3)))
