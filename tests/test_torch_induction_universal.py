"""The port's universal induction-family rollout (``make_fused_induction_rollout``
and the dispatch ``make_fused_rollout``, plain PyTorch versions on the CPU)
against the JAX package.

* Buffer mode: the same numpy action buffer from zero start states with
  constant references through both packages' ``make_fused_induction_rollout``
  (the JAX kernel in interpret mode, as tests/test_pallas_families.py runs
  it) for its five ``SCIM_CASES`` and Cont-TC-SCIM, rtol 1e-5 / atol 1e-4
  (A, Wb, rad/s; float32 RK4 in the same order).
* Random mode, replay: the plain random rollout driven by the test-only
  xorshift copy of the interpret bit source (tests/test_torch_sync_universal.py;
  the SCIM draws as the synchronous family does: the actions, nothing for
  the polynomial load's reset, then the reference draws), against the JAX
  interpret kernel, in at least 99% of envs.
* Random mode, statistics: the Philox plain version against the XLA env
  (``test_fused_scim_family_stats``' bounds).
* The dispatch of all six ids, their state arity (4, or 5 with the speed),
  the flux direction at zero flux, and the wrappers' CPU path.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_electric_motor_tpu as gemx
from gym_electric_motor_tpu.ops.pallas_rollout import (
    fused_state_arity as jax_arity,
    make_fused_induction_rollout as jax_induction_rollout,
)
import gym_electric_motor_tpu_torch as gt
from gym_electric_motor_tpu_torch.ops import fused_common as fc
from gym_electric_motor_tpu_torch.ops import fused_induction_family as indf
from gym_electric_motor_tpu_torch.ops import fused_rollout as fr
from test_pallas_families import SCIM_CASES
from test_pallas_rollout import N_STAT, T_STAT, _check_wiener_state, _xla_random_rollout
from test_torch_scim import const_envs
from test_torch_sync_universal import XorshiftSyncBits, env_share

torch.set_num_threads(1)

BUF = dict(rtol=1e-5, atol=1e-4)
BUFFER_CASES = [(c[0], c[1], c[2], c[3]) for c in SCIM_CASES] + [
    ("Cont-TC-SCIM-v0", False, False, ["torque"])]


def action_buffer(finite, T, R, seed):
    rng = np.random.default_rng(seed)
    if finite:
        return rng.integers(0, 8, (T, R, 128)).astype(np.int32)
    return rng.uniform(-1.0, 1.0, (T, 3, R, 128)).astype(np.float32)


@pytest.mark.parametrize("env_id,finite,mech,ref_names", BUFFER_CASES,
                         ids=[c[0] for c in BUFFER_CASES])
def test_buffer_rollout_matches_jax_interpret(env_id, finite, mech, ref_names):
    jenv, tenv = const_envs(env_id, [(n, 0.0) for n in ref_names])
    N, T = 128, 60
    n_state = 5 if mech else 4
    start = [np.zeros((1, 128), np.float32)] * n_state
    acts = action_buffer(finite, T, 1, 21)
    want = jax_induction_rollout(jenv, T, N, action_mode="buffer", interpret=True)(
        *map(jnp.asarray, start), jnp.asarray(acts))
    got = fr.make_fused_rollout(tenv, T, N, action_mode="buffer")(
        *map(torch.as_tensor, start), torch.as_tensor(acts))
    assert len(got) == len(want) == n_state
    for g, w in zip(got, want):
        assert g.shape == w.shape == (1, 128)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **BUF)
    assert float(np.abs(got[-1].numpy()).max()) > 1e-3  # the flux moved


def replay_start(c, seed):
    """Starts of which a fifth or so lie outside the current limit, so that
    the replay crosses resets: speed in [0, 100) rad/s, currents within 1.2
    times the limit, fluxes within 0.5 Wb."""
    rng = np.random.default_rng(seed)
    i_lim = 1.0 / np.sqrt(c.f["inv_ilim2"])
    w = [rng.uniform(0, 100, (2, 128)).astype(np.float32)] if c.mech else []
    cur = [rng.uniform(-0.85 * i_lim, 0.85 * i_lim, (2, 128)).astype(np.float32)
           for _ in range(2)]
    flux = [rng.uniform(-0.5, 0.5, (2, 128)).astype(np.float32) for _ in range(2)]
    return w + cur + flux


REPLAY_IDS = ["Finite-CC-SCIM-v0", "Cont-TC-SCIM-v0", "Cont-SC-SCIM-v0"]


@pytest.mark.parametrize("env_id", REPLAY_IDS)
def test_random_rollout_replays_jax_interpret(env_id):
    jenv = gemx.make_functional(env_id)
    tenv = gt.make_functional(env_id, device="cpu")
    c = indf.InductionConsts(tenv)
    N, T, seed = 256, 64, 3
    start = replay_start(c, 4)
    want = jax_induction_rollout(jenv, T, N, interpret=True)(seed, *map(jnp.asarray, start))
    got = indf.induction_rollout_random_plain(c, seed, tuple(map(torch.as_tensor, start)), T,
                                              bits=XorshiftSyncBits(seed, N, c.n_ref, c.n_act))
    assert len(got) == len(want) == c.n_state + 6
    assert got[c.n_state + 2].shape == (2 * c.n_ref, 128)
    assert float(np.asarray(want[c.n_state + 1]).sum()) > 0  # the replay crosses resets
    # no state is an angle: env_share's angle column is past the last output
    assert env_share([g.numpy() for g in got], want, len(got) + 1, N) >= 0.99


@pytest.mark.parametrize("env_id,n_state", [("Finite-CC-SCIM-v0", 4), ("Cont-SC-SCIM-v0", 5)],
                         ids=["Finite-CC-SCIM-v0", "Cont-SC-SCIM-v0"])
def test_random_rollout_statistics_match_jax_env(env_id, n_state):
    """``test_fused_scim_family_stats`` for the Philox plain version."""
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


@pytest.mark.parametrize("env_id", gt.SCIM_ENV_IDS)
def test_dispatch_routes_each_scim_id(env_id):
    tenv = gt.make_functional(env_id, device="cpu")
    n_state = fr.fused_state_arity(tenv)
    assert n_state == jax_arity(gemx.make_functional(env_id)) == (5 if "-SC-" in env_id else 4)
    assert fr.family_of(tenv) == "induction"
    roll = fr.make_fused_rollout(tenv, 3, 128)
    assert isinstance(roll.consts, indf.InductionConsts) and roll.consts.n_state == n_state
    out = roll(1, *([torch.zeros((1, 128))] * n_state))
    assert len(out) == n_state + 6 and all(bool(torch.isfinite(x).all()) for x in out)


def test_flux_direction_agrees_with_the_env_field_angle():
    """psi / |psi| with an rsqrt against the env's cos/sin of atan2, and
    (1, 0) at zero flux, where atan2(0, 0) = 0."""
    c = indf.InductionConsts(gt.make_functional("Cont-CC-SCIM-v0", device="cpu"))
    rng = np.random.default_rng(1)
    psa = torch.as_tensor(rng.uniform(-1, 1, 256).astype(np.float32))
    psb = torch.as_tensor(rng.uniform(-1, 1, 256).astype(np.float32))
    psa[:3] = 0.0
    psb[:3] = torch.tensor([0.0, 1e-13, 0.0])
    cos, sin = indf.flux_dir(c, {"psa": psa, "psb": psb})
    eps = torch.atan2(psb, psa)
    torch.testing.assert_close(cos[3:], torch.cos(eps)[3:], rtol=0, atol=1e-6)
    torch.testing.assert_close(sin[3:], torch.sin(eps)[3:], rtol=0, atol=1e-6)
    assert cos[:3].tolist() == [1.0, 1.0, 1.0] and sin[:3].tolist() == [0.0, 0.0, 0.0]


def test_wrappers_take_plain_path_on_cpu_and_validate():
    tenv = gt.make_functional("Cont-SC-SCIM-v0", device="cpu")
    c = indf.InductionConsts(tenv)
    z = torch.zeros((1, 128))
    indf.reset_launches()
    out = indf.induction_rollout_random(c, 1, (z,) * 5, 5)
    ref = indf.induction_rollout_random_plain(c, 1, (z,) * 5, 5)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert all(v == 0 for v in indf.LAUNCHES.values())
    assert c.host.dtype == np.float32
    assert len(c.host) == len(indf.CONST_NAMES) + 2 * len(fc.ROW_NAMES)
    assert c.f["two_thirds"] == float(np.float32(2.0 / 3.0))
    assert c.f["inv_sqrt3"] == float(np.float32(1.0 / np.sqrt(3.0)))
    with pytest.raises(ValueError, match="5 state planes"):
        indf.induction_rollout_random(c, 1, (z,) * 4, 5)
    with pytest.raises(TypeError):
        indf.induction_rollout_random(c, 1, (z, z, z, z, z.double()), 5)
    with pytest.raises(ValueError):  # continuous takes (T, 3, R, 128)
        indf.induction_rollout_buffer(c, (z,) * 5, torch.zeros((5, 1, 128)))
    with pytest.raises(ValueError, match="action buffer"):
        fr.make_fused_rollout(tenv, 6, 128, action_mode="buffer")(
            *(z,) * 5, torch.zeros((5, 3, 1, 128)))


def test_constant_speed_products_are_host_constants():
    """At constant speed c_w omega and p omega are formed in double
    precision on the host, as the JAX kernel forms them from Python
    floats; under the speed ODE the kernels multiply the plane."""
    cc = indf.InductionConsts(gt.make_functional("Finite-CC-SCIM-v0", device="cpu"))
    sc = indf.InductionConsts(gt.make_functional("Finite-SC-SCIM-v0", device="cpu"))
    assert abs(cc.f["cw_w"] / (cc.f["c_w"] * 100.0) - 1.0) < 1e-7
    assert cc.f["pw"] == 200.0 and sc.f["pw"] == 0.0 and sc.f["cw_w"] == 0.0
    assert not cc.mech and sc.mech and cc.needs_dq and not sc.needs_dq
    assert sc.f["inv_jt"] == float(np.float32(1.0 / (1e-5 + 1.1e-3)))
