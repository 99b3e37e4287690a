"""The port's actor-critic and fused-collection PPO against the JAX
package's ``parallel/sharded.py`` on the CPU.

Each comparison feeds both sides one batch recorded by the JAX recorder in
interpret mode (``make_fused_policy_record_rollout``, N = 256, T = 32) and
the same weights (JAX's, carried across with ``params_from_numpy``):

* the port's batch preparation (observation rebuild, GAE, population-std
  advantage normalisation) and loss gradient against ``jax.grad`` of a
  test-side copy of ``sharded.py:642-701`` over the whole batch, rtol 1e-4
  with an atol of 1e-4 of each parameter's largest gradient entry (float32
  sums in another order; entries near zero have no relative scale); Adam's
  first step is about
  ``lr * sign(g)``, so only the gradient shows a wrong std, GAE cut or
  bootstrap;
* one PPO iteration (``n_minibatches=1``, ``n_epochs=2``, so the minibatch
  permutation cannot matter) against the JAX trainer's ``train(...,
  n_iters=1)``: every parameter within 2 lr of JAX's, at least 99% within
  0.05 lr, and the same mean reward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_electric_motor_tpu as gemx
from gym_electric_motor_tpu.ops.pallas_policy import (
    make_fused_policy_record_rollout as jax_record,
    make_fused_policy_record_universal as jax_record_universal,
    policy_act_ns as jax_policy_act_ns,
    policy_n_cont as jax_policy_n_cont,
    policy_obs_dim as jax_policy_obs_dim,
    policy_obs_host as jax_obs_host,
)
from gym_electric_motor_tpu.parallel.sharded import (
    actor_critic as jax_actor_critic,
    init_actor_critic_params as jax_init_ac,
    make_fused_ppo_trainer as jax_make_ppo,
)
import gym_electric_motor_tpu_torch as gt
from gym_electric_motor_tpu_torch.ops import fused_policy as fp
from gym_electric_motor_tpu_torch.parallel import (
    actor_critic,
    init_actor_critic_params,
    make_fused_ppo_trainer,
    params_from_numpy,
)
from gym_electric_motor_tpu_torch.parallel import sharded as tsh

torch.set_num_threads(1)

SF = ("omega", "i_sd", "i_sq", "epsilon")
T, N, H, SEED = 32, 256, 16, 3
CFG = dict(gamma=0.9, lam=0.95, clip_eps=0.2, vf_coef=0.1, ent_coef=0.01)


def _envs():
    return (gemx.make_functional("Finite-CC-PMSM-v0", state_filter=SF),
            gt.make_functional("Finite-CC-PMSM-v0", state_filter=SF, device="cpu"))


def _jax_batch(jenv, params):
    """One JAX interpret recorder launch under ``params``."""
    roll = jax_record(jenv, T, N, hidden=H, interpret=True)
    z = jnp.zeros((N // 128, 128), jnp.float32)
    out = roll(SEED, params["w1"].reshape(-1), params["b1"], params["wp"].reshape(-1),
               params["bp"], z, z, z)
    return roll, {k: np.asarray(v) for k, v in out.items()}


def _jax_loss_fn(roll, out, gamma, lam, clip_eps, vf_coef, ent_coef):
    """Test-side copy of sharded.py:642-701 (finite heads, one minibatch
    holding the whole batch): the loss as a function of the parameters."""
    def tn(x):
        return jnp.asarray(x).reshape(T, N)

    z = jnp.zeros((1, N), jnp.float32)
    prev = {nm: jnp.concatenate([z, tn(out[nm])[:-1]]) for nm in roll.state_names}
    refs = {nm: tn(out[nm]) for nm in roll.ref_names}
    obs_t = jax_obs_host(roll, prev, refs)
    act = tn(out["action"])
    rew_t, done_t = tn(out["reward"]), tn(out["done"])

    def logp_ent(logits, a):
        logp = jax.nn.log_softmax(logits)
        oh = jax.nn.one_hot(a, 8, dtype=logp.dtype)
        return jnp.sum(logp * oh, -1), -jnp.sum(jax.nn.softmax(logits) * logp, -1)

    def loss_fn(params):
        logits_t, val_t = jax_actor_critic(params, obs_t)
        logp_t = jax.lax.stop_gradient(logp_ent(logits_t, act)[0])
        val_t = jax.lax.stop_gradient(val_t)
        obs_last = jax_obs_host(roll, {nm: tn(out[nm])[-1] for nm in roll.state_names},
                                {nm: refs[nm][-1] for nm in roll.ref_names})
        last_val = jax.lax.stop_gradient(jax_actor_critic(params, obs_last)[1])

        def gae_body(carry, x):
            adv_next, v_next = carry
            v, r, d = x
            delta = r + gamma * v_next * (1.0 - d) - v
            adv = delta + gamma * lam * (1.0 - d) * adv_next
            return (adv, v), adv

        _, adv_t = jax.lax.scan(gae_body, (jnp.zeros_like(last_val), last_val),
                                (val_t, rew_t, done_t), reverse=True)
        ret_t = adv_t + val_t
        adv_t = (adv_t - jnp.mean(adv_t)) / (jnp.std(adv_t) + 1e-8)
        logits, value = jax_actor_critic(params, obs_t)
        logp, ent_all = logp_ent(logits, act)
        ratio = jnp.exp(logp - logp_t)
        pg = -jnp.mean(jnp.minimum(ratio * adv_t,
                                   jnp.clip(ratio, 1.0 - clip_eps, 1.0 + clip_eps) * adv_t))
        vf = jnp.mean((value - ret_t) ** 2)
        return pg + vf_coef * vf - ent_coef * jnp.mean(ent_all)

    return loss_fn


def _torch_out(out):
    return {k: torch.as_tensor(np.array(v)) for k, v in out.items()}


@pytest.mark.parametrize("separate_critic", [False, True])
def test_actor_critic_matches_jax(separate_critic):
    params = jax.tree.map(np.asarray, jax_init_ac(jax.random.PRNGKey(1), 7, 8, H,
                                                  separate_critic=separate_critic))
    model = params_from_numpy(params, device="cpu")
    assert model.separate_critic == separate_critic
    obs = np.random.default_rng(2).normal(size=(5, 11, 7)).astype(np.float32)
    want_l, want_v = jax_actor_critic(params, jnp.asarray(obs))
    with torch.no_grad():
        got_l, got_v = actor_critic(model, torch.as_tensor(obs))
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=1e-5, atol=1e-6)


def test_separate_critic_trunk_routes():
    """tests/test_fused_ppo.py:135-163 on the port: the critic trunk moves
    values only, the actor trunk logits only, and training moves the
    critic trunk."""
    model = init_actor_critic_params(1, 7, 8, H, separate_critic=True, device="cpu")
    assert {n for n, _ in model.named_parameters()} == {"w1", "b1", "wp", "bp", "wv", "bv",
                                                        "w1v", "b1v"}
    obs = torch.randn((5, 7), generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        logits0, value0 = model(obs)
        model.w1v += 1.0
        logits1, value1 = model(obs)
        torch.testing.assert_close(logits1, logits0, rtol=0, atol=0)
        assert not torch.allclose(value1, value0)
        model.w1 += 1.0
        logits2, value2 = model(obs)
        torch.testing.assert_close(value2, value1, rtol=0, atol=0)
        assert not torch.allclose(logits2, logits1)
    _jenv, tenv = _envs()
    init_opt, train = make_fused_ppo_trainer(tenv, hidden=H, horizon=T, n_envs=N,
                                             n_minibatches=4, gamma=0.99, lr=3e-4, vf_coef=0.5)
    w1v = model.w1v.detach().clone()
    z = torch.zeros((2, 128))
    _m, _opt, _planes, rs = train(model, init_opt(model), (z, z, z), 3, 2)
    assert bool(torch.isfinite(rs).all())
    assert not torch.allclose(model.w1v.detach(), w1v)


def test_ppo_loss_gradient_matches_jax():
    jenv, tenv = _envs()
    params = jax.tree.map(np.asarray, jax_init_ac(jax.random.PRNGKey(1), 7, 8, H))
    roll_j, out = _jax_batch(jenv, params)
    g_jax = jax.grad(_jax_loss_fn(roll_j, out, **CFG))(jax.tree.map(jnp.asarray, params))

    model = params_from_numpy(params, device="cpu")
    roll = fp.make_fused_policy_record_rollout(tenv, T, N, hidden=H)
    z = torch.zeros((N // 128, 128))
    batch = tsh.ppo_batch(model, roll, _torch_out(out), (z, z, z), CFG["gamma"], CFG["lam"])
    assert [tuple(x.shape) for x in batch] == [(T, N, 7), (T, N, 1), (T, N), (T, N), (T, N)]
    loss = tsh.ppo_loss(model, *batch, roll.act_ns, CFG["clip_eps"], CFG["vf_coef"],
                        CFG["ent_coef"])
    loss.backward()
    for name, p in model.named_parameters():
        want = np.asarray(g_jax[name])
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max(), err_msg=name)


def _universal_case(env_id):
    """The JAX and port envs of a universal-recorder id, the JAX
    actor-critic parameters (with ``ls`` for a continuous id) and one JAX
    interpret recorder launch under them, with its initial planes."""
    jenv = gemx.make_functional(env_id)
    tenv = gt.make_functional(env_id, device="cpu")
    F, cont = jax_policy_obs_dim(jenv), jax_policy_n_cont(jenv)
    A = cont or int(sum(jax_policy_act_ns(jenv)))
    params = jax_init_ac(jax.random.PRNGKey(1), F, A, H, n_cont=cont)
    roll = jax_record_universal(jenv, T, N, hidden=H, interpret=True)
    z = jnp.zeros((N // 128, 128), jnp.float32)
    planes = (z,) * roll.n_state
    extra = (params["ls"],) if cont else ()
    out = roll(SEED, params["w1"].reshape(-1), params["b1"], params["wp"].reshape(-1),
               params["bp"], *extra, *planes)
    return jenv, tenv, params, roll, {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("env_id", ["Finite-CC-PMSM-v0", "Finite-CC-PermExDc-v0",
                                    "Cont-CC-PermExDc-v0"])
def test_one_ppo_iteration_matches_jax_train(env_id):
    """The PMSM recorder's batch (Finite-CC-PMSM-v0, the state filter) and
    the universal recorder's (Finite- and Cont-CC-PermExDc-v0, the latter
    with the log-stds ``ls``): one update on the same JAX-recorded batch and
    parameters."""
    lr = 1e-3
    cfg = dict(hidden=H, lr=lr, horizon=T, n_envs=N, n_epochs=2, n_minibatches=1, **CFG)
    if env_id == "Finite-CC-PMSM-v0":
        jenv, tenv = _envs()
        params = jax_init_ac(jax.random.PRNGKey(1), 7, 8, H)
        params_np = jax.tree.map(np.asarray, params)
        _roll_j, out = _jax_batch(jenv, params_np)
        state_names = ("i_sd", "i_sq", "eps")
    else:
        jenv, tenv, params, roll_j, out = _universal_case(env_id)
        params_np = jax.tree.map(np.asarray, params)
        state_names = roll_j.state_names
    init_opt_j, train_j = jax_make_ppo(jenv, interpret=True, **cfg)
    z = jnp.zeros((N // 128, 128), jnp.float32)
    p_jax, _opt, _planes, rs_jax = train_j(params, init_opt_j(params),
                                           (z,) * len(state_names), SEED, 1)

    model = params_from_numpy(params_np, device="cpu")
    init_opt, train = make_fused_ppo_trainer(tenv, **cfg)
    assert tuple(train.roll.state_names) == tuple(state_names)
    zt = torch.zeros((N // 128, 128))
    planes, mean_r = train.ppo_update(model, init_opt(model), _torch_out(out),
                                      (zt,) * len(state_names), SEED)
    np.testing.assert_allclose(float(mean_r), float(rs_jax[0]), rtol=1e-6)
    for j, nm in enumerate(state_names):
        np.testing.assert_array_equal(planes[j].numpy(), out[nm][-1])
    assert {n for n, _ in model.named_parameters()} == set(params_np)
    for name, p in model.named_parameters():
        d = np.abs(p.detach().numpy() - np.asarray(p_jax[name]))
        assert d.max() <= 2 * lr, (name, d.max())
        assert (d <= 0.05 * lr).mean() >= 0.99, (name, (d <= 0.05 * lr).mean())
        assert not np.allclose(p.detach().numpy(), params_np[name]), name


def test_fused_ppo_trainer_runs():
    _jenv, tenv = _envs()
    init_opt, train = make_fused_ppo_trainer(tenv, hidden=8, horizon=T, n_envs=N,
                                             n_minibatches=4, lr=1e-3)
    model = init_actor_critic_params(1, 7, 8, 8, device="cpu")
    w1 = model.w1.detach().clone()
    z = torch.zeros((N // 128, 128))
    model, _opt, planes, rs = train(model, init_opt(model), (z, z, z), 3, 3)
    assert rs.shape == (3,) and bool(torch.isfinite(rs).all())
    assert -0.5 < float(rs.mean()) < 0.0
    assert not torch.allclose(model.w1.detach(), w1)
    assert all(bool(torch.isfinite(p).all()) for p in planes)


def test_unported_options_raise():
    """mesh= (slice 6) and randomize= (queue 2, item 8) raise; the
    universal recorder builds (kernel='universal', and 'auto' where the PMSM
    recorder does not apply); 'pmsm' keeps its state-filter check."""
    _jenv, tenv = _envs()
    with pytest.raises(NotImplementedError, match="slice 6"):
        make_fused_ppo_trainer(tenv, n_envs=256, mesh=object())
    with pytest.raises(NotImplementedError, match="item 8"):
        make_fused_ppo_trainer(tenv, n_envs=256, randomize=("r_s",))
    _init, train = make_fused_ppo_trainer(tenv, n_envs=256, kernel="universal")
    assert train.roll.policy.kernel == "sync_policy_record"
    _init, train = make_fused_ppo_trainer(tenv, n_envs=256, kernel="auto")
    assert getattr(train.roll, "policy", None) is None  # the PMSM recorder
    unfiltered = gt.make_functional("Finite-CC-PMSM-v0", device="cpu")
    _init, train = make_fused_ppo_trainer(unfiltered, n_envs=256, kernel="auto")
    assert train.roll.policy.kernel == "sync_policy_record"
    with pytest.raises(ValueError, match="state_filter"):
        make_fused_ppo_trainer(unfiltered, n_envs=256, kernel="pmsm")
    with pytest.raises(ValueError, match="kernel"):
        make_fused_ppo_trainer(unfiltered, n_envs=256, kernel="other")


@pytest.mark.parametrize("n_cont", [1, 6])
def test_gaussian_heads_match_jax(n_cont):
    """``init_actor_critic_params(n_cont=)`` adds ``ls`` at -0.5 as JAX's
    does; ``params_from_numpy`` carries a JAX ``ls`` across; the port's
    continuous ``heads_logp_ent`` and its gradient in ``ls`` match a
    test-side copy of sharded.py:598-616 on the same parameters."""
    model = init_actor_critic_params(1, 5, n_cont, H, device="cpu", n_cont=n_cont)
    torch.testing.assert_close(model.ls.detach(), torch.full((n_cont,), -0.5))
    params = jax.tree.map(np.asarray, jax_init_ac(jax.random.PRNGKey(4), 5, n_cont, H,
                                                  n_cont=n_cont, log_std_init=-0.3))
    params["ls"] = params["ls"] + np.linspace(-0.2, 0.2, n_cont).astype(np.float32)
    model = params_from_numpy(params, device="cpu")
    rng = np.random.default_rng(3)
    obs = rng.normal(size=(7, 11, 5)).astype(np.float32)
    raw = rng.normal(size=(7, 11, n_cont)).astype(np.float32)
    log_2pi = float(np.log(2.0 * np.pi))

    def jax_lp_ent(p):
        logits, _v = jax_actor_critic(p, jnp.asarray(obs))
        z = (jnp.asarray(raw) - logits) / jnp.exp(p["ls"])
        lp = jnp.sum(-0.5 * z * z - p["ls"] - 0.5 * log_2pi, axis=-1)
        ent = jnp.sum(p["ls"] + 0.5 * (log_2pi + 1.0)) * jnp.ones(lp.shape, lp.dtype)
        return lp, ent

    want_lp, want_ent = jax_lp_ent(jax.tree.map(jnp.asarray, params))
    logits, _v = model(torch.as_tensor(obs))
    lp, ent = tsh.heads_logp_ent(logits, torch.as_tensor(raw), None, model.ls)
    np.testing.assert_allclose(lp.detach().numpy(), np.asarray(want_lp), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ent.detach().numpy(), np.asarray(want_ent), rtol=1e-6)
    g_jax = jax.grad(lambda p: jnp.mean(jax_lp_ent(p)[0]))(jax.tree.map(jnp.asarray, params))
    lp.mean().backward()
    np.testing.assert_allclose(model.ls.grad.numpy(), np.asarray(g_jax["ls"]), rtol=1e-4,
                               atol=1e-6)
