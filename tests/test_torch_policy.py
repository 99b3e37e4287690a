"""The port's policy-in-the-loop kernels (plain PyTorch versions) against
the JAX package's Pallas kernels in interpret mode, against the port's env,
and against torch autograd.

* Deterministic modes (greedy actions, constant references): the reducing
  policy rollout and REINFORCE against ``make_fused_policy_rollout`` and
  ``make_fused_reinforce_rollout`` (interpret mode), N = 128, T = 150:
  rtol 1e-5 / atol 1e-4 on the state (A, rad; the tolerance of
  tests/test_pallas_rollout.py:474-479) and 1e-4 of the largest entry on
  the gradient block (float32 sums in another order).  The JAX weights
  come across through ``policy_params_from_numpy`` and
  ``flatten_policy_params``.
* Replay: the plain recorder driven by the interpret kernel's xorshift bits
  in its draw order matches the JAX recorder (N = 256, T = 32, one chunk)
  at rtol 1e-4 / atol 1e-4 in at least 99% of envs.
* The alignment invariant E[log pi(a|s)] = -E[H] on the plain recorder
  (tests/test_fused_ppo.py:40-77), within 0.02.
* REINFORCE against autograd: the gradient block equals the gradient of
  the REINFORCE surrogate on the port's VectorEnv trajectory
  (tests/test_pallas_rollout.py:565-609), relative error below 1e-4.

The CUDA kernels run only on a GPU: ``chip_smoke.py`` and
tests/test_torch_cuda_kernels.py hold them against these plain versions.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_electric_motor_tpu as gemx
from gym_electric_motor_tpu import references as jrg
from gym_electric_motor_tpu.ops.pallas_policy import (
    flatten_policy_params as jax_flatten,
    make_fused_policy_record_rollout as jax_record,
    make_fused_policy_rollout as jax_rollout,
    make_fused_reinforce_rollout as jax_reinforce,
)
from gym_electric_motor_tpu.parallel.sharded import (
    init_actor_critic_params as jax_init_ac,
    init_policy_params as jax_init_policy,
)
import gym_electric_motor_tpu_torch as gt
from gym_electric_motor_tpu_torch import references as rg
from gym_electric_motor_tpu_torch.ops import fused_policy as fp
from gym_electric_motor_tpu_torch.parallel import (
    params_from_numpy,
    policy_logits,
    policy_obs,
    policy_params_from_numpy,
)
from test_torch_fused_sync import _XorshiftBits

torch.set_num_threads(1)

SF = ("omega", "i_sd", "i_sq", "epsilon")
REF_D, REF_Q = -0.1, 0.2
STATE = dict(rtol=1e-5, atol=1e-4)


def _const_envs():
    jenv = gemx.make_functional("Finite-CC-PMSM-v0", state_filter=SF,
                                reference_generator=jrg.ReferenceSpec(
                                    [jrg.ConstReference("i_sd", REF_D),
                                     jrg.ConstReference("i_sq", REF_Q)]))
    tenv = gt.make_functional("Finite-CC-PMSM-v0", state_filter=SF, device="cpu",
                              reference_generator=rg.ReferenceSpec(
                                  [rg.ConstReference("i_sd", REF_D),
                                   rg.ConstReference("i_sq", REF_Q)]))
    return jenv, tenv


def _policy(hidden=16):
    """JAX policy weights as numpy, and the same weights in the port."""
    params = jax.tree.map(np.asarray, jax_init_policy(jax.random.PRNGKey(5), 6, 8, hidden=hidden))
    return params, policy_params_from_numpy(params, device="cpu")


def _planes(R):
    z = np.zeros((R, 128), np.float32)
    return z, np.full_like(z, REF_D), np.full_like(z, REF_Q)


def _assert_state(got, want):
    g, w = got.numpy(), np.asarray(want)
    np.testing.assert_allclose(g, w, **STATE)


def _assert_angle(got, want):
    d = np.remainder(got.numpy() - np.asarray(want), 2 * np.pi)
    np.testing.assert_allclose(np.minimum(d, 2 * np.pi - d), 0.0, atol=1e-4)


def test_greedy_const_policy_rollout_matches_jax_interpret():
    jenv, tenv = _const_envs()
    params, policy = _policy(16)
    T, N = 150, 128
    z, rd, rq = _planes(1)
    want = jax_rollout(jenv, T, N, hidden=16, sample="greedy", ref_mode="const", interpret=True)(
        0, *jax_flatten(params), *[jnp.asarray(z)] * 3, jnp.asarray(rd), jnp.asarray(rq))
    got = fp.make_fused_policy_rollout(tenv, T, N, hidden=16, sample="greedy", ref_mode="const")(
        0, *fp.flatten_policy_params(policy), *[torch.as_tensor(z)] * 3, torch.as_tensor(rd),
        torch.as_tensor(rq))
    assert len(got) == 5
    _assert_state(got[0], want[0])
    _assert_state(got[1], want[1])
    _assert_angle(got[2], want[2])
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))


def test_greedy_const_reinforce_matches_jax_interpret():
    jenv, tenv = _const_envs()
    params, policy = _policy(16)
    T, N, base = 150, 128, -0.07
    z, rd, rq = _planes(1)
    want = jax_reinforce(jenv, T, N, hidden=16, gamma=0.97, sample="greedy", ref_mode="const",
                         block_rows=1, interpret=True)(
        0, base, *jax_flatten(params), *[jnp.asarray(z)] * 3, jnp.asarray(rd), jnp.asarray(rq))
    got = fp.make_fused_reinforce_rollout(tenv, T, N, hidden=16, gamma=0.97, sample="greedy",
                                          ref_mode="const")(
        0, base, *fp.flatten_policy_params(policy), *[torch.as_tensor(z)] * 3,
        torch.as_tensor(rd), torch.as_tensor(rq))
    _assert_state(got[0], want[0])
    _assert_state(got[1], want[1])
    _assert_angle(got[2], want[2])
    g, w = got[5].numpy(), np.asarray(want[5])
    assert g.shape == w.shape == (fp.n_policy_params(6, 16), 128)
    assert np.abs(g - w).max() / np.abs(w).max() < 1e-4


def _xla_greedy_trajectory(tenv, policy, T, N):
    """(obs, action, reward) of the port's VectorEnv under argmax actions."""
    venv = gt.VectorEnv(tenv, N)
    state, _obs = venv.reset(0)
    obs_l, act_l, rew_l = [], [], []
    with torch.no_grad():
        for _ in range(T):
            o = policy_obs(tenv, state)
            a = torch.argmax(policy_logits(policy, o), dim=-1)
            state, _obs, r, _term = venv.step(state, a)
            obs_l.append(o), act_l.append(a), rew_l.append(r)
    return torch.stack(obs_l), torch.stack(act_l), torch.stack(rew_l), state


def test_greedy_policy_rollout_matches_port_env():
    """The greedy policy kernel tracks the port's env driven by the same
    MLP's argmax, step for step (tests/test_pallas_rollout.py:439-479)."""
    _jenv, tenv = _const_envs()
    _params, policy = _policy(8)
    T, N = 100, 128
    z, rd, rq = (torch.as_tensor(x) for x in _planes(1))
    got = fp.make_fused_policy_rollout(tenv, T, N, hidden=8, sample="greedy", ref_mode="const")(
        0, *fp.flatten_policy_params(policy), z, z, z, rd, rq)
    _obs, _act, rew, state = _xla_greedy_trajectory(tenv, policy, T, N)
    ode = state.phys.ode_state
    torch.testing.assert_close(got[0].reshape(N), ode[:, 1], **STATE)
    torch.testing.assert_close(got[1].reshape(N), ode[:, 2], **STATE)
    np.testing.assert_allclose(float(got[3].sum()) / (N * T), float(rew.sum()) / (N * T),
                               rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("gamma", [0.0, 0.97])
def test_reinforce_gradient_matches_autograd_oracle(gamma):
    """The eligibility-trace gradient equals autograd of the REINFORCE
    surrogate sum_t w_t log pi(a_t | s_t) with discounted return-to-go
    weights w (r_t - b at gamma = 0) on the env's greedy trajectory."""
    _jenv, tenv = _const_envs()
    _params, policy = _policy(16)
    T, N, base = 150, 128, -0.07
    z, rd, rq = (torch.as_tensor(x) for x in _planes(1))
    out = fp.make_fused_reinforce_rollout(tenv, T, N, hidden=16, gamma=gamma, sample="greedy",
                                          ref_mode="const")(
        0, base, *fp.flatten_policy_params(policy), z, z, z, rd, rq)
    g_kernel = fp.unflatten_policy_grads(out[5], 6, 8, 16)

    obs, act, rew, _state = _xla_greedy_trajectory(tenv, policy, T, N)
    assert not bool((rew < -5).any()), "config must stay violation-free"
    adv = rew.double() - base
    w = torch.zeros((T, N), dtype=torch.float64)
    acc = torch.zeros(N, dtype=torch.float64)
    for t in range(T - 1, -1, -1):
        acc = adv[t] + gamma * acc
        w[t] = acc
    policy.zero_grad()
    logp = torch.log_softmax(policy_logits(policy, obs.reshape(T * N, 6)), dim=-1)
    surrogate = torch.sum(w.float().reshape(-1) * logp[torch.arange(T * N), act.reshape(-1)])
    surrogate.backward()
    for k in ("w1", "b1", "w2", "b2"):
        a, b = g_kernel[k], getattr(policy, k).grad
        rel = float((a - b).abs().max() / (b.abs().max() + 1e-9))
        assert rel < 1e-4, (k, rel)


def test_policy_record_replays_jax_interpret_kernel():
    jenv = gemx.make_functional("Finite-CC-PMSM-v0", state_filter=SF)
    tenv = gt.make_functional("Finite-CC-PMSM-v0", state_filter=SF, device="cpu")
    params = jax.tree.map(np.asarray, jax_init_ac(jax.random.PRNGKey(1), 7, 8, 8))
    T, N, seed = 32, 256, 5
    z = np.zeros((2, 128), np.float32)
    want = jax_record(jenv, T, N, hidden=8, interpret=True)(
        seed, params["w1"].reshape(-1), params["b1"], params["wp"].reshape(-1), params["bp"],
        *[jnp.asarray(z)] * 3)
    model = params_from_numpy(params, device="cpu")
    w = fp.flatten_policy_params({"w1": model.w1, "b1": model.b1, "w2": model.wp, "b2": model.bp})
    zt = torch.zeros((2, 128))
    got = fp.policy_record_plain(fp.PolicyConsts(tenv), seed, *w, zt, zt, zt, T,
                                 bits=_XorshiftBits(seed, N))
    ok = np.ones(N, bool)
    for name, g in zip(fp.make_fused_policy_record_rollout(tenv, T, N, hidden=8).signals, got):
        g, x = g.numpy(), np.asarray(want[name])
        assert g.shape == x.shape == (T, 2, 128) and g.dtype == x.dtype
        ok &= np.isclose(g, x, rtol=1e-4, atol=1e-4).reshape(-1, N).all(axis=0)
    assert ok.mean() >= 0.99


def test_policy_record_obs_alignment():
    """E[log pi(a | s_rebuilt)] = -E[H(pi)] on the plain recorder: the
    sampled actions follow the softmax of the logits recomputed from the
    rebuilt observations (state shift, reference pairing, cos/sin)."""
    tenv = gt.make_functional("Finite-CC-PMSM-v0", state_filter=SF, device="cpu")
    params = jax.tree.map(np.asarray, jax_init_ac(jax.random.PRNGKey(1), 7, 8, 16))
    model = params_from_numpy(params, device="cpu")
    T, N = 128, 256
    roll = fp.make_fused_policy_record_rollout(tenv, T, N, hidden=16)
    z = torch.zeros((2, 128))
    out = roll(5, *fp.flatten_policy_params(
        {"w1": model.w1, "b1": model.b1, "w2": model.wp, "b2": model.bp}), z, z, z)
    prev = {nm: torch.cat([z.reshape(1, -1), out[nm].reshape(T, N)[:-1]])
            for nm in roll.state_names}
    refs = {nm: out[nm].reshape(T, N) for nm in roll.ref_names}
    obs = fp.policy_obs_host(roll, prev, refs)
    with torch.no_grad():
        logits, _value = model(obs)
    logp = torch.log_softmax(logits, dim=-1)
    lp_a = torch.gather(logp, -1, out["action"].reshape(T, N, 1).long())[..., 0]
    ent = -(torch.softmax(logits, dim=-1) * logp).sum(-1)
    assert abs(float(lp_a.mean() + ent.mean())) < 0.02, (float(lp_a.mean()), -float(ent.mean()))
    # rewards recompute from the recorded signals
    i_lim = 1.0 / roll.consts.f["inv_i_lim"]
    isd_n, isq_n = out["i_sd"] / i_lim, out["i_sq"] / i_lim
    viol = (isd_n ** 2 + isq_n ** 2) > 1.0
    wse = -(0.25 * (isd_n - out["ref_d"]).abs() + 0.25 * (isq_n - out["ref_q"]).abs())
    torch.testing.assert_close(out["reward"], torch.where(viol, torch.full_like(wse, -10.0), wse),
                               rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(out["done"], viol.float(), rtol=0, atol=0)


def test_random_modes_repeat_and_stay_in_range():
    """Categorical + Wiener: one seed gives the same result twice, the
    reward lies at the tracking scale, and the REINFORCE rollout stays
    finite with a nonzero gradient block."""
    tenv = gt.make_functional("Finite-CC-PMSM-v0", state_filter=SF, device="cpu")
    _params, policy = _policy(8)
    T, N = 200, 256
    z = torch.zeros((2, 128))
    w = fp.flatten_policy_params(policy)
    out = fp.make_fused_policy_rollout(tenv, T, N, hidden=8)(3, *w, z, z, z)
    again = fp.make_fused_policy_rollout(tenv, T, N, hidden=8)(3, *w, z, z, z)
    for a, b in zip(out, again):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    mean_r = float(out[3].sum()) / (N * T)
    assert -0.5 < mean_r < 0.0
    assert all(bool(torch.isfinite(x).all()) for x in out)
    assert bool(((out[2] >= 0) & (out[2] < 2 * np.pi)).all())
    rein = fp.make_fused_reinforce_rollout(tenv, 50, N, hidden=8, gamma=0.9)(3, -0.1, *w, z, z, z)
    assert all(bool(torch.isfinite(x).all()) for x in rein)
    assert float(rein[5].abs().max()) > 0
    assert -0.5 < float(rein[3].sum()) / (N * 50) < 0.0


def test_reinforce_trainer_runs_and_updates():
    tenv = gt.make_functional("Finite-CC-PMSM-v0", state_filter=SF, device="cpu")
    params, policy = _policy(8)
    train = fp.make_fused_reinforce_trainer(tenv, 40, 256, hidden=8, gamma=0.95, lr=40.0)
    p2, rs = train(0, policy, 3)
    assert rs.shape == (3,) and bool(torch.isfinite(rs).all())
    assert -0.5 < float(rs.mean()) < 0.0
    for k in ("w1", "b1", "w2", "b2"):
        assert bool(torch.isfinite(getattr(p2, k)).all())
        assert not np.allclose(getattr(p2, k).detach().numpy(), params[k])


def test_reinforce_reduce_sums_rows_in_order():
    acc = torch.as_tensor(np.random.default_rng(3).normal(size=(5, 4 * 128)).astype(np.float32))
    got = fp.reinforce_reduce_plain(acc)
    want = ((acc[:, :128] + acc[:, 128:256]) + acc[:, 256:384]) + acc[:, 384:]
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_wrappers_validate_and_take_plain_path_on_cpu():
    tenv = gt.make_functional("Finite-CC-PMSM-v0", state_filter=SF, device="cpu")
    consts = fp.PolicyConsts(tenv)
    _params, policy = _policy(8)
    w = fp.flatten_policy_params(policy)
    z = torch.zeros((1, 128))
    fp.reset_launches()
    out = fp.policy_rollout(consts, 1, *w, z, z, z, None, None, 3)
    ref = fp.policy_rollout_plain(consts, 1, *w, z, z, z, None, None, 3)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert all(v == 0 for v in fp.LAUNCHES.values())
    _p12, p12 = _policy(12)
    with pytest.raises(ValueError, match="H in"):
        fp.policy_rollout(consts, 1, *fp.flatten_policy_params(p12), z, z, z, None, None, 3)
    with pytest.raises(ValueError, match="H in"):
        fp.make_fused_reinforce_rollout(tenv, 3, 128, hidden=12)
    with pytest.raises(ValueError):
        fp.policy_record(consts, 1, *w, z, z, z, 3)  # 6-feature weights to the 7-feature kernel
    with pytest.raises(TypeError):
        fp.policy_rollout(consts, 1, w[0].double(), *w[1:], z, z, z, None, None, 3)
    const = fp.policy_rollout(consts, 1, *w, z, z, z, None, None, 3, "greedy", "const")
    zero_refs = fp.policy_rollout(consts, 1, *w, z, z, z, z, z, 3, "greedy", "const")
    for a, b in zip(const, zero_refs):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="ref_mode"):
        fp.policy_rollout(consts, 1, *w, z, z, z, None, None, 3, ref_mode="constant")
    with pytest.raises(ValueError, match="state_filter"):
        fp.PolicyConsts(gt.make_functional("Finite-CC-PMSM-v0", device="cpu"))
    with pytest.raises(NotImplementedError):
        fp.PolicyConsts(gt.make_functional("Finite-CC-PMSM-v0", device="cpu", state_filter=SF,
                                           constraints=()))


@pytest.mark.parametrize("hidden", fp.HIDDEN_SIZES)
def test_reinforce_layout_gives_every_parameter_to_one_trace_thread(hidden):
    """reinforce_layout (csrc/reinforce_split.cuh's role split): trace
    thread w owns the hidden units j = w + T m, each with its 6 w1 entries,
    b1 and 8 w2 entries, and b2[w + T m]; over the T trace warps every
    packed parameter is owned exactly once.  The ring's words and the shared
    memory of the ring and G, the threads and the setmaxnreg budgets follow
    from the shape, which is the source's."""
    lay = fp.reinforce_layout(hidden, 16384)
    H, T = hidden, lay["trace_warps"]
    assert lay["params"] == fp.n_policy_params(6, H)
    owned = []
    for w in range(T):
        mine = []
        for m in range(H // T):
            j = w + T * m
            mine += [f * H + j for f in range(6)] + [6 * H + j]
            mine += [7 * H + j * 8 + a for a in range(8)]
        mine += [15 * H + w + T * m for m in range(8 // T)]
        assert len(mine) == lay["params_per_trace_thread"]
        owned += mine
    assert sorted(owned) == list(range(lay["params"]))
    assert lay["words"] == H + 17
    E, SW = lay["envs_per_block"], lay["step_warps"]
    assert E == 32 * SW and SW in (1, 4)
    ring = 2 * lay["K"] * lay["words"] * E * 4
    assert lay["smem_bytes"] == ring + 4 * E * lay["params"]
    assert lay["smem_bytes"] * lay["min_blocks_per_sm"] <= 227 * 1024
    assert lay["threads"] == E * (1 + T) <= 1024
    assert lay["blocks"] == 16384 // E and fp.reinforce_layout(H, 200)["blocks"] == -(-200 // E)
    if SW > 1:  # setmaxnreg: the step warpgroup gives registers to the trace warps
        assert lay["min_blocks_per_sm"] == 1
        assert E * (lay["setmaxnreg_step"] + T * lay["setmaxnreg_trace"]) < 65536
        assert lay["params_per_trace_thread"] < lay["setmaxnreg_trace"]
    source = (Path(fp.__file__).resolve().parent.parent / "csrc"
              / "reinforce_split.cuh").read_text()
    shape = re.search(rf"struct ReinforceShape<{H}> {{\s*static constexpr int SW = (\d+), "
                      rf"T = (\d+), B = (\d+);", source)
    assert shape and tuple(map(int, shape.groups())) == (SW, T, lay["min_blocks_per_sm"])
    assert f"constexpr int kReinforceK = {lay['K']};" in source
    regs = re.findall(r"constexpr int k(?:Step|Trace)Regs = (\d+);", source)
    assert tuple(map(int, regs)) == fp.REINFORCE_REGS


def test_reinforce_layout_refuses_other_widths():
    with pytest.raises(ValueError, match="H in"):
        fp.reinforce_layout(12, 128)
