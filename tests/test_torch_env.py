"""The port's batched env (``gym_electric_motor_tpu_torch``) against the JAX
env on the CPU.

* Deterministic physics: the same numpy action buffer with const
  references, step for step.  ode_state: rtol 1e-5 / atol 1e-4 (A, rad),
  the tolerance of tests/test_pallas_rollout.py:54-59 — both run float32
  RK4 in the same order, but XLA fuses and reorders some constant
  products, so currents of ~100 A differ by a few ulp (1 ulp = 7.6e-6).
  Normalised observations and rewards: rtol 1e-5 / atol 1e-6 (the same
  ulps over the 400 A limit).  Terminations must be equal.
* A mid-episode JAX state carried across with ``state_from_numpy``.
* A forced violation: the autoreset step and the reset state.
* Wiener statistics against the bounds of tests/test_pallas_rollout.py
  (:164-182 and :202-204): the two packages draw different random streams,
  so they are compared in distribution.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_electric_motor_tpu as gemx
from gym_electric_motor_tpu import references as jrg
import gym_electric_motor_tpu_torch as gt
from gym_electric_motor_tpu_torch import references as trg
from gym_electric_motor_tpu_torch.utils import rng as trng
from test_pallas_rollout import _check_wiener_state, _xla_random_rollout

torch.set_num_threads(1)

ENV_IDS = ["Finite-CC-PMSM-v0", "Finite-CC-SynRM-v0"]
PHYS = dict(rtol=1e-5, atol=1e-4)
NORM = dict(rtol=1e-5, atol=1e-6)


def _const_envs(env_id, d=0.0, q=0.0):
    jenv = gemx.make_functional(env_id, reference_generator=jrg.ReferenceSpec(
        [jrg.ConstReference("i_sd", d), jrg.ConstReference("i_sq", q)]))
    tenv = gt.make_functional(env_id, device="cpu", reference_generator=trg.ReferenceSpec(
        [trg.ConstReference("i_sd", d), trg.ConstReference("i_sq", q)]))
    return jenv, tenv


def _jax_fields(state):
    s = jax.tree.map(np.asarray, state)
    return dict(ode_state=s.phys.ode_state, conv_state=s.phys.conv_state,
                sup_state=s.phys.sup_state, t=s.phys.t, k=s.phys.k, refs=s.refs,
                system_state=s.system_state, step_count=s.step_count, episode=s.episode)


def _assert_step(jout, tout):
    (js, jobs, jr, jterm), (ts, tobs, tr, tterm) = jout, tout
    np.testing.assert_allclose(ts.phys.ode_state.numpy(), np.asarray(js.phys.ode_state), **PHYS)
    np.testing.assert_allclose(tobs[0].numpy(), np.asarray(jobs[0]), **NORM)
    np.testing.assert_allclose(tobs[1].numpy(), np.asarray(jobs[1]), **NORM)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), **NORM)
    np.testing.assert_array_equal(tterm.numpy(), np.asarray(jterm))
    np.testing.assert_array_equal(ts.phys.conv_state.numpy(), np.asarray(js.phys.conv_state))
    np.testing.assert_array_equal(ts.step_count.numpy(), np.asarray(js.step_count))


@pytest.mark.parametrize("env_id", ENV_IDS)
def test_action_buffer_matches_jax_every_step(env_id):
    jenv, tenv = _const_envs(env_id)
    N, T = 128, 40
    actions = np.random.default_rng(0).integers(0, 8, size=(T, N)).astype(np.int32)
    js, jobs = jax.vmap(jenv.reset)(jax.random.split(jax.random.PRNGKey(0), N))
    ts, tobs = tenv.reset(trng.env_keys(0, N, "cpu"))
    np.testing.assert_array_equal(tobs[0].numpy(), np.asarray(jobs[0]))
    step = jax.jit(jax.vmap(jenv.step_autoreset))
    for t in range(T):
        jout = step(js, jnp.asarray(actions[t]))
        tout = tenv.step_autoreset(ts, torch.as_tensor(actions[t]))
        _assert_step(jout, tout)
        js, ts = jout[0], tout[0]


@pytest.mark.parametrize("refs", ["const", "wiener"])
def test_state_from_numpy_mid_episode(refs):
    """A JAX state after 25 random steps goes across; both packages then
    step 20 more.  With Wiener references the carried reference values
    feed the first reward; later draws differ, so from then on only the
    physics is compared."""
    env_id = "Finite-CC-PMSM-v0"
    if refs == "const":
        jenv, tenv = _const_envs(env_id, 0.1, -0.2)
    else:
        jenv = gemx.make_functional(env_id)
        tenv = gt.make_functional(env_id, device="cpu")
    N = 128
    rng = np.random.default_rng(1)
    js, _ = jax.vmap(jenv.reset)(jax.random.split(jax.random.PRNGKey(1), N))
    step = jax.jit(jax.vmap(jenv.step_autoreset))
    for _ in range(25):
        js, *_ = step(js, jnp.asarray(rng.integers(0, 8, N)))
    ts = gt.state_from_numpy(_jax_fields(js), "cpu")
    np.testing.assert_array_equal(tenv.reference_generator.current_values(ts.refs).numpy(),
                                  np.asarray(jax.vmap(jenv.reference_generator.current_values)(js.refs)))
    for t in range(20):
        a = rng.integers(0, 8, N).astype(np.int32)
        jout = step(js, jnp.asarray(a))
        tout = tenv.step_autoreset(ts, torch.as_tensor(a))
        if refs == "const":
            _assert_step(jout, tout)
        elif t == 0:
            np.testing.assert_allclose(tout[2].numpy(), np.asarray(jout[2]), **NORM)
        np.testing.assert_allclose(tout[0].phys.ode_state.numpy(), np.asarray(jout[0].phys.ode_state),
                                   **PHYS)
        np.testing.assert_allclose(tout[1][0].numpy(), np.asarray(jout[1][0]), **NORM)
        np.testing.assert_array_equal(tout[3].numpy(), np.asarray(jout[3]))
        js, ts = jout[0], tout[0]


@pytest.mark.parametrize("env_id", ENV_IDS)
def test_forced_violation_autoreset_matches_jax(env_id):
    jenv, tenv = _const_envs(env_id, 0.3, 0.1)
    N = 128
    i_lim = float(jenv.physical_system.limits[jenv.physical_system.state_names.index("i_sd")])
    js, _ = jax.vmap(jenv.reset)(jax.random.split(jax.random.PRNGKey(2), N))
    step = jax.jit(jax.vmap(jenv.step_autoreset))
    rng = np.random.default_rng(2)
    for _ in range(5):
        js, *_ = step(js, jnp.asarray(rng.integers(0, 8, N)))
    ode = np.asarray(js.phys.ode_state).copy()
    ode[::2, 1] = 1.2 * i_lim  # every other env starts the step outside the circle
    js = js.replace(phys=js.phys.replace(ode_state=jnp.asarray(ode)))
    ts = gt.state_from_numpy(_jax_fields(js), "cpu")
    a = rng.integers(0, 8, N).astype(np.int32)
    jout = step(js, jnp.asarray(a))
    tout = tenv.step_autoreset(ts, torch.as_tensor(a))
    assert np.asarray(jout[3])[::2].all() and not np.asarray(jout[3])[1::2].any()
    _assert_step(jout, tout)
    (jn, tn) = jout[0], tout[0]
    np.testing.assert_allclose(tn.system_state.numpy(), np.asarray(jn.system_state), **NORM)
    np.testing.assert_array_equal(tn.episode.numpy(), np.asarray(jn.episode))
    np.testing.assert_array_equal(tn.phys.k.numpy(), np.asarray(jn.phys.k))
    np.testing.assert_allclose(tn.phys.t.numpy(), np.asarray(jn.phys.t), rtol=1e-6)
    # the reset envs restart from the default initial state
    assert np.all(tn.phys.ode_state.numpy()[::2, 1:] == 0.0)
    assert np.all(tout[2].numpy()[::2] == jenv.reward_function._violation_value)


def test_wiener_statistics_match_jax_env():
    env_id = "Finite-CC-PMSM-v0"
    N, T = 256, 1000
    tenv = gt.make_functional(env_id, device="cpu")
    venv = gt.VectorEnv(tenv, N)
    state, _ = venv.reset(3)
    gen = torch.Generator().manual_seed(4)
    state, rewards, terms = venv.rollout(state, gt.random_policy(8), T, gen)
    ps = tenv.physical_system
    names = list(ps.state_names)
    margin = float(ps.nominal_state[names.index("i_sd")] / ps.limits[names.index("i_sd")])
    rv = torch.cat([s["value"] for s in state.refs]).numpy()
    rk = torch.cat([s["k"] for s in state.refs]).numpy().astype(np.float32)
    rl = torch.cat([s["ep_len"] for s in state.refs]).numpy().astype(np.float32)
    rs = torch.cat([s["p"][:, 0] for s in state.refs]).numpy()
    _check_wiener_state(rv, rk, rl, rs, margin, 1e-3, 1e-1)

    mean_r = float(rewards.sum()) / (N * T)
    term_rate = float(terms.sum()) / (N * T)
    jax_mean_r, jax_term_rate = _xla_random_rollout(env_id, N, T)
    assert abs(mean_r - jax_mean_r) < 0.05
    assert abs(term_rate - jax_term_rate) < max(0.5 * max(term_rate, jax_term_rate), 2e-3)
    assert np.all(np.isfinite(state.phys.ode_state.numpy()))


def test_entry_points_need_a_device_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gt.make_functional("Finite-CC-PMSM-v0")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gt.make("Finite-CC-PMSM-v0", n_envs=128)


def test_make_returns_vector_env():
    venv = gt.make("Finite-CC-SynRM-v0", n_envs=128, device="cpu")
    state, obs = venv.reset(0)
    assert isinstance(venv, gt.VectorEnv) and obs[0].shape == (128, 14) and obs[1].shape == (128, 2)
    with pytest.raises(NotImplementedError, match="slice 7"):
        gt.make("Finite-CC-PMSM-v0", device="cpu")
