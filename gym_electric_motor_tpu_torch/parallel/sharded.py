"""Policies and the fused-collection PPO trainer on one device.

Counterpart of the single-device parts of
``gym_electric_motor_tpu/parallel/sharded.py``: the policy MLP
(``init_policy_params``, ``policy_logits``, ``_policy_obs``), the
actor-critic (``init_actor_critic_params``, ``actor_critic``) and
``make_fused_ppo_trainer``.  The parameter pytrees become ``nn.Module``s
whose parameters keep the JAX names, shapes and orientation (``obs @ w1``),
so that the kernels' flat layout ``w1[f*H + j]`` needs no transpose;
``params_from_numpy`` and ``policy_params_from_numpy`` carry a JAX
parameter dict (taken out as numpy arrays) across.  The sharded env, the
XLA trainers and the ``mesh=`` layouts come with slice 6 of the port.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import resolve_device
from ..ops.fused_policy import (
    flatten_policy_params,
    make_fused_policy_record_rollout,
    make_fused_policy_record_universal,
    policy_obs_host,
)

LOG_2PI = float(np.log(2.0 * np.pi))


def policy_obs(env, state):
    """The trainers' flat observation (``_policy_obs``): the filtered
    normalised state followed by the current reference values, ``(N,
    S + n_refs)``."""
    filt = list(env._state_filter)
    return torch.cat([state.system_state[:, filt],
                      env.reference_generator.current_values(state.refs)], dim=-1)


def _randn(generator, shape, device):
    return (torch.randn(shape, generator=generator, dtype=torch.float32) * 0.1).to(device)


class Policy(nn.Module):
    """The 2-layer tanh MLP policy: ``tanh(obs @ w1 + b1) @ w2 + b2``."""

    def __init__(self, w1, b1, w2, b2):
        super().__init__()
        self.w1, self.b1 = nn.Parameter(w1), nn.Parameter(b1)
        self.w2, self.b2 = nn.Parameter(w2), nn.Parameter(b2)

    def forward(self, obs):
        return torch.tanh(obs @ self.w1 + self.b1) @ self.w2 + self.b2


def init_policy_params(seed, obs_dim, n_actions, hidden=32, device=None):
    """A ``Policy`` with N(0, 0.1^2) weights drawn from a CPU
    ``torch.Generator`` seeded with ``seed``, and zero biases."""
    g = torch.Generator().manual_seed(int(seed))
    device = resolve_device(device)
    w1 = _randn(g, (obs_dim, hidden), device)
    w2 = _randn(g, (hidden, n_actions), device)
    return Policy(w1, torch.zeros(hidden, device=device), w2, torch.zeros(n_actions, device=device))


def policy_logits(policy, obs):
    return policy(obs)


class ActorCritic(nn.Module):
    """Actor-critic MLP: a tanh trunk, a policy head (``wp``, ``bp``) and a
    value head (``wv``, ``bv``).  With ``w1v``/``b1v`` (``separate_critic``)
    the value head has its own trunk: with a shared trunk, the value
    regression repurposes the policy's features on torque tasks at
    gamma = 0.99 (``init_actor_critic_params`` in the JAX package).  With
    ``ls`` the policy is squashed-Gaussian: the policy head gives the means
    and ``ls`` the learned per-channel log-stds."""

    def __init__(self, w1, b1, wp, bp, wv, bv, w1v=None, b1v=None, ls=None):
        super().__init__()
        self.w1, self.b1 = nn.Parameter(w1), nn.Parameter(b1)
        self.wp, self.bp = nn.Parameter(wp), nn.Parameter(bp)
        self.wv, self.bv = nn.Parameter(wv), nn.Parameter(bv)
        self.separate_critic = w1v is not None
        if self.separate_critic:
            self.w1v, self.b1v = nn.Parameter(w1v), nn.Parameter(b1v)
        self.ls = None if ls is None else nn.Parameter(ls)

    def forward(self, obs):
        """``(logits, value)``."""
        h = torch.tanh(obs @ self.w1 + self.b1)
        logits = h @ self.wp + self.bp
        hv = torch.tanh(obs @ self.w1v + self.b1v) if self.separate_critic else h
        return logits, (hv @ self.wv + self.bv)[..., 0]


def init_actor_critic_params(seed, obs_dim, n_actions, hidden=32, separate_critic=False,
                             device=None, n_cont=0, log_std_init=-0.5):
    """An ``ActorCritic`` with N(0, 0.1^2) weights drawn from a CPU
    ``torch.Generator`` seeded with ``seed``, and zero biases.
    ``n_actions`` is the number of policy outputs (the summed logits of a
    finite policy, the means of a continuous one); ``n_cont > 0`` adds the
    ``ls`` log-std vector of the squashed-Gaussian policy, ``log_std_init``
    each."""
    g = torch.Generator().manual_seed(int(seed))
    device = resolve_device(device)
    w = dict(w1=_randn(g, (obs_dim, hidden), device), wp=_randn(g, (hidden, n_actions), device),
             wv=_randn(g, (hidden, 1), device))
    if separate_critic:
        w["w1v"] = _randn(g, (obs_dim, hidden), device)
        w["b1v"] = torch.zeros(hidden, device=device)
    if n_cont:
        w["ls"] = torch.full((n_cont,), float(log_std_init), device=device)
    return ActorCritic(b1=torch.zeros(hidden, device=device),
                       bp=torch.zeros(n_actions, device=device),
                       bv=torch.zeros(1, device=device), **w)


def actor_critic(model, obs):
    return model(obs)


def _tensors(params, names, device):
    device = resolve_device(device)
    return {k: torch.tensor(np.asarray(params[k], dtype=np.float32), device=device)
            for k in names if k in params}


def params_from_numpy(params, device=None) -> ActorCritic:
    """An ``ActorCritic`` holding a JAX actor-critic parameter dict taken out
    as numpy arrays (``jax.tree.map(np.asarray, params)``), with or without
    the separate critic trunk and the log-stds ``ls``."""
    return ActorCritic(**_tensors(params, ("w1", "b1", "wp", "bp", "wv", "bv", "w1v", "b1v",
                                           "ls"), device))


def policy_params_from_numpy(params, device=None) -> Policy:
    """A ``Policy`` holding a JAX policy dict (``w1``, ``b1``, ``w2``,
    ``b2``) taken out as numpy arrays."""
    return Policy(**_tensors(params, ("w1", "b1", "w2", "b2"), device))


# ---------------------------------------------------------------------------
# fused-collection PPO
# ---------------------------------------------------------------------------


def heads_logp_ent(logits, acts, act_ns, ls=None):
    """Log-prob of the taken actions and the policy entropy.  Finite
    (``act_ns``): a factorised categorical policy, sums over the heads, one
    softmax slice each.  Continuous (``act_ns`` None): the diagonal Gaussian
    of the recorded raw samples about the means ``logits`` with log-stds
    ``ls``, and the Gaussian entropy; the tanh squash's correction depends on
    the raw sample only, so it cancels in the PPO ratio and is left out
    (sharded.py:598-616)."""
    if act_ns is None:
        z = (acts - logits) / torch.exp(ls)
        lp = torch.sum(-0.5 * z * z - ls - 0.5 * LOG_2PI, dim=-1)
        ent = torch.sum(ls + 0.5 * (LOG_2PI + 1.0)) * torch.ones_like(lp)
        return lp, ent
    lp = ent = 0.0
    off = 0
    for h, n in enumerate(act_ns):
        sl = logits[..., off:off + n]
        off += n
        logp = torch.log_softmax(sl, dim=-1)
        oh = F.one_hot(acts[..., h].long(), n).to(logp.dtype)
        lp = lp + torch.sum(logp * oh, dim=-1)
        ent = ent - torch.sum(torch.softmax(sl, dim=-1) * logp, dim=-1)
    return lp, ent


def gae(values, rewards, dones, last_value, gamma, lam):
    """Generalised advantage estimates over ``(T, N)`` tensors, backwards in
    time, bootstrapped from ``last_value``.  The TD errors and decays are
    taken for all steps at once; only ``adv_t = delta_t + decay_t *
    adv_{t+1}`` runs step by step, one launch per step."""
    not_done = 1.0 - dones
    v_next = torch.cat([values[1:], last_value[None]])
    delta = rewards + gamma * v_next * not_done - values
    decay = gamma * lam * not_done
    adv = torch.empty_like(values)
    adv_next = torch.zeros_like(last_value)
    for t in range(values.shape[0] - 1, -1, -1):
        adv_next = torch.addcmul(delta[t], decay[t], adv_next, out=adv[t])
    return adv


def ppo_batch(model, roll, out, planes, gamma, lam):
    """A recorded launch -> the time-major training batch ``(obs, act,
    logp_old, adv, ret)``: the observations rebuilt from the shifted
    states and recorded references, behaviour log-probs and values under
    the collecting parameters, GAE bootstrapped from the last recorded
    state and references, and the advantages normalised by the population
    std."""
    T = out[roll.signals[0]].shape[0]

    def tn(x):
        return x.reshape(T, -1)

    prev = {nm: torch.cat([planes[i].reshape(1, -1), tn(out[nm])[:-1]])
            for i, nm in enumerate(roll.state_names)}
    refs = {nm: tn(out[nm]) for nm in roll.ref_names}
    obs_t = policy_obs_host(roll, prev, refs)
    act = torch.stack([tn(out[an]) for an in roll.act_names], dim=-1)
    with torch.no_grad():
        logits_t, val_t = model(obs_t)
        logp_t, _ = heads_logp_ent(logits_t, act, roll.act_ns, model.ls)
        obs_last = policy_obs_host(roll, {nm: tn(out[nm])[-1] for nm in roll.state_names},
                                   {nm: refs[nm][-1] for nm in roll.ref_names})
        _, last_val = model(obs_last)
        adv_t = gae(val_t, tn(out["reward"]), tn(out["done"]), last_val, gamma, lam)
        ret_t = adv_t + val_t
        adv_t = (adv_t - adv_t.mean()) / (adv_t.std(correction=0) + 1e-8)
    return obs_t, act, logp_t, adv_t, ret_t


def ppo_loss(model, obs, act, logp_old, adv, ret, act_ns, clip_eps, vf_coef, ent_coef):
    """Clipped surrogate + ``vf_coef`` x value MSE - ``ent_coef`` x entropy."""
    logits, value = model(obs)
    logp, ent_all = heads_logp_ent(logits, act, act_ns, model.ls)
    ratio = torch.exp(logp - logp_old)
    pg = -torch.mean(torch.minimum(ratio * adv,
                                   torch.clamp(ratio, 1.0 - clip_eps, 1.0 + clip_eps) * adv))
    vf = torch.mean((value - ret) ** 2)
    return pg + vf_coef * vf - ent_coef * torch.mean(ent_all)


def make_fused_ppo_trainer(env, hidden=16, lr=3e-4, horizon=256, n_envs=8192, n_epochs=2,
                           n_minibatches=8, clip_eps=0.2, gamma=0.99, lam=0.95, vf_coef=0.5,
                           ent_coef=0.0, mesh=None, kernel="auto", randomize=None):
    """PPO with fused on-policy collection on any catalog id
    (``make_fused_ppo_trainer``, sharded.py:511-760): each iteration is one
    recorder launch (the actor trunk of the ``ActorCritic`` samples in the
    kernel, every step recorded), then GAE and minibatch Adam on the
    recorded batch in PyTorch.

    ``kernel`` picks the recorder: ``'pmsm'`` the Finite-CC-PMSM one
    (``policy_record``; the env needs ``state_filter=('omega', 'i_sd',
    'i_sq', 'epsilon')`` and the model ``obs_dim=7, n_actions=8``);
    ``'universal'`` the universal one (``make_fused_policy_record_universal``,
    every id: the model takes ``obs_dim=policy_obs_dim(env)`` and
    ``n_actions=sum(policy_act_ns(env))``, or ``policy_n_cont(env)`` means
    with ``n_cont`` log-stds); ``'auto'`` the PMSM recorder where it applies
    and the universal one otherwise.  Returns ``(init_opt, train)``:
    ``init_opt(model)`` is a ``torch.optim.Adam`` with optax's defaults, and
    ``train(model, opt, planes, seed, n_iters) -> (model, opt, planes,
    mean_reward (n_iters,))`` updates ``model`` in place; ``planes`` are the
    recorder's ``(n_envs // 128, 128)`` state planes
    (``fused_policy_init_planes`` builds the universal recorder's) and
    iteration i collects with seed ``seed + i``.  ``train.ppo_update(model,
    opt, out, planes, seed)`` is one iteration's update on a recorded batch
    ``out``, ``train.collect(model, planes, seed)`` one collection and
    ``train.roll`` the recorder.  Minibatches are whole envs over the full
    horizon, drawn by a permutation per epoch from a generator seeded with
    (17, seed).  ``mesh=`` (slice 6 of the port) and ``randomize=`` (queue
    2, item 8) raise."""
    if mesh is not None:
        raise NotImplementedError("mesh= lays the env batch over several devices; it comes "
                                  "with slice 6 of the port")
    if randomize:
        raise NotImplementedError("randomize= (per-env motor parameters as state planes) is not "
                                  "fused yet; it arrives with queue 2, item 8 of the port")
    if kernel not in ("auto", "pmsm", "universal"):
        raise ValueError(f"kernel must be 'auto', 'pmsm' or 'universal', got {kernel!r}")
    if n_envs % n_minibatches:
        raise ValueError(f"n_envs ({n_envs}) must split into {n_minibatches} equal minibatches")
    roll = None
    if kernel != "universal":
        try:
            roll = make_fused_policy_record_rollout(env, horizon, n_envs, hidden=hidden)
        except (NotImplementedError, ValueError):
            if kernel == "pmsm":
                raise
    if roll is None:
        roll = make_fused_policy_record_universal(env, horizon, n_envs, hidden=hidden)
    cont = bool(getattr(roll, "cont", False))
    mb_envs = n_envs // n_minibatches

    def init_opt(model):
        return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)

    def ppo_update(model, opt, out, planes, seed=0):
        obs_t, act, logp_t, adv_t, ret_t = ppo_batch(model, roll, out, planes, gamma, lam)
        batch = [x.transpose(0, 1) for x in (obs_t, act, logp_t, adv_t, ret_t)]  # env-major
        device = obs_t.device
        gen = torch.Generator(device=device).manual_seed((17 << 32) | (int(seed) & 0xFFFFFFFF))
        for _epoch in range(n_epochs):
            perm = torch.randperm(n_envs, generator=gen, device=device)
            for m in range(n_minibatches):
                idx = perm[m * mb_envs:(m + 1) * mb_envs]
                obs, a, lp_old, adv, ret = (x[idx].reshape((-1,) + x.shape[2:]) for x in batch)
                loss = ppo_loss(model, obs, a, lp_old, adv, ret, roll.act_ns, clip_eps, vf_coef,
                                ent_coef)
                opt.zero_grad(set_to_none=True)
                loss.backward()
                opt.step()
        planes = tuple(out[nm][-1] for nm in roll.state_names)
        return planes, out["reward"].mean()

    def collect(model, planes, seed):
        w1, b1, wp, bp = flatten_policy_params(
            {"w1": model.w1, "b1": model.b1, "w2": model.wp, "b2": model.bp})
        extra = (model.ls.detach().contiguous(),) if cont else ()
        return roll(seed, w1, b1, wp, bp, *extra, *planes)

    def train(model, opt, planes, seed, n_iters):
        rs = []
        for i in range(n_iters):
            out = collect(model, planes, seed + i)
            planes, mean_r = ppo_update(model, opt, out, planes, seed + i)
            rs.append(mean_r.detach())
        return model, opt, planes, torch.stack(rs) if rs else torch.zeros(0)

    train.roll = roll
    train.collect = collect
    train.ppo_update = ppo_update
    return init_opt, train
