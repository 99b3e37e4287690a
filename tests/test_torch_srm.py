"""The port's switched reluctance motor (SRM), its asymmetric bridges and its
six env ids against the JAX package.

* The ``switched_reluctance_motor()`` spec (parameters with the derived
  ``l0`` and ``l1``, limits with the torque limit 0.5 i_lim^2 p l1, nominal
  values, the initializer) equals the JAX one, with and without ``psi_s``;
  ``psi_s=None`` leaves no key.
* ``srm_ode`` and ``srm_torque``, linear and saturating, on seeded numpy
  states, voltages and speeds: rtol 1e-6 / atol 1e-3 (A/s, N m; the same
  float32 expressions), atol 4e-3 A/s for the saturating ODE, whose
  numerator cancels terms of up to 3e4 A/s (one float32 ulp is 2e-3 there)
  and whose exp differs by an ulp between XLA and PyTorch.
* Both asymmetric bridges: action spaces, ``u_frac`` and ``i_sup`` for
  every finite action and for duties beyond [-1, 1]; interlocking raises
  in both packages.
* ``SRMSystem.reset_from_u`` on the same uniforms: ode state and
  normalised system state at rtol 1e-5 / atol 1e-6.
* The general path: the port's env against ``jax.vmap(env.step_autoreset)``
  under one action buffer and constant references on all six ids (and the
  saturating model on two), half of the envs magnetising every phase so
  that they pass 20 A and reset: ``ode_state`` and the observation at
  rtol 1e-4 / atol 1e-3 with the angle modulo 2 pi (the env wraps it to
  [-pi, pi)), reward at rtol 1e-4 / atol 1e-5, termination exactly; no
  phase current ever below zero (the diode clamp).
* The catalog's SRM defaults (400 V, the asymmetric bridge, three Wiener
  references on i_a, i_b, i_c with margin (0, 1), weights 1/3 and the
  three-phase limit constraint), a ``converter=dict(...)`` override, the
  dq control space; ``make`` serves the six ids, 60 in all.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_electric_motor_tpu as gemx
from gym_electric_motor_tpu import references as jrg
from gym_electric_motor_tpu.models import converters as jcv
from gym_electric_motor_tpu.models import motors as jmt
import gym_electric_motor_tpu_torch as gt
from gym_electric_motor_tpu_torch import references as trg
from gym_electric_motor_tpu_torch.models import converters as tcv
from gym_electric_motor_tpu_torch.models import motors as tmt
from gym_electric_motor_tpu_torch.physical_systems import SRMSystem
from gym_electric_motor_tpu_torch.utils import rng as trng

torch.set_num_threads(1)

ENV_TOL = dict(rtol=1e-4, atol=1e-3)
CONST_REFS = {"CC": [("i_a", 0.2), ("i_b", 0.3), ("i_c", 0.1)], "TC": [("torque", 0.3)],
              "SC": [("omega", 0.2)]}
SAT = dict(motor=dict(motor_parameter={"psi_s": 1.2}))


def const_envs(env_id, refs=None, **kw):
    """The JAX and the port env of ``env_id`` with constant references
    (``refs``: (state, value) pairs, by default the task's)."""
    refs = refs or CONST_REFS[env_id.split("-")[1]]
    jenv = gemx.make_functional(env_id, reference_generator=jrg.ReferenceSpec(
        [jrg.ConstReference(n, v) for n, v in refs]), **kw)
    tenv = gt.make_functional(env_id, device="cpu", reference_generator=trg.ReferenceSpec(
        [trg.ConstReference(n, v) for n, v in refs]), **kw)
    return jenv, tenv


@pytest.mark.parametrize("kw", [{}, dict(motor_parameter={"psi_s": 0.4, "r_s": 0.6},
                                         limit_values={"i": 25.0}),
                                dict(motor_parameter={"psi_s": None})],
                         ids=["default", "saturating", "psi_s_none"])
def test_srm_spec_matches_jax(kw):
    j, t = jmt.switched_reluctance_motor(**kw), tmt.switched_reluctance_motor(**kw)
    assert t.kind == j.kind == "SRM"
    assert t.parameter == j.parameter
    assert ("psi_s" in t.parameter) == (kw.get("motor_parameter", {}).get("psi_s") is not None)
    assert t.parameter["l0"] == 0.5 * (t.parameter["l_max"] + t.parameter["l_min"])
    assert t.limits == j.limits and t.nominal == j.nominal
    lim_i = t.limits["i"]
    assert t.limits["torque"] == 0.5 * lim_i**2 * t.parameter["p"] * t.parameter["l1"]
    assert t.limits["u_a"] == t.limits["u"] and t.limits["i_c"] == lim_i
    assert t.initializer == j.initializer and t.initial_limits == j.initial_limits
    assert (t.ode_states, t.currents, t.voltages) == (j.ode_states, j.currents, j.voltages)
    assert tmt.MOTOR_FACTORIES["SRM"] is tmt.switched_reluctance_motor
    assert all(np.isfinite(float(v)) for v in t.mp().values())


@pytest.mark.parametrize("psi_s", [None, 1.2, 0.4])
def test_srm_ode_and_torque_match_jax(psi_s):
    kw = dict(motor_parameter={"psi_s": psi_s})
    spec, jspec = tmt.switched_reluctance_motor(**kw), jmt.switched_reluctance_motor(**kw)
    rng = np.random.default_rng(11)
    n = 64
    state = np.concatenate([rng.uniform(0, 20, (n, 3)), rng.uniform(-np.pi, np.pi, (n, 1))],
                           axis=1).astype(np.float32)
    u = rng.uniform(-400, 400, (n, 3)).astype(np.float32)
    omega = rng.uniform(-300, 300, n).astype(np.float32)
    jmp = jspec.mp()
    jode = jax.vmap(lambda s, v, w: jmt.srm_ode(jmp, s, v, w))
    jtq = jax.vmap(lambda s: jmt.srm_torque(jmp, s))
    args = [torch.as_tensor(x) for x in (state, u, omega)]
    got = spec.ode(spec.mp(), *args).numpy()
    np.testing.assert_allclose(got, np.asarray(jode(state, u, omega)), rtol=1e-6,
                               atol=1e-3 if psi_s is None else 4e-3)
    got_t = tmt.srm_torque(spec.mp(), args[0]).numpy()
    np.testing.assert_allclose(got_t, np.asarray(jtq(state)), rtol=1e-6, atol=1e-3)


def test_asymmetric_bridges_match_jax():
    jf, tf = jcv.finite_asymmetric_bridge_converter(), tcv.finite_asymmetric_bridge_converter()
    assert tf.kind == jf.kind == "Finite-ASYM"
    assert tf.action_space == ("multidiscrete", [3, 3, 3]) == jf.action_space
    acts = np.array([[a, b, c] for a in range(3) for b in range(3) for c in range(3)])
    i_out = np.random.default_rng(2).uniform(0, 20, (27, 3)).astype(np.float32)
    got = tf.u_frac(None, torch.as_tensor(acts), torch.as_tensor(i_out)).numpy()
    got_i = tf.i_sup(None, torch.as_tensor(acts), torch.as_tensor(i_out)).numpy()
    np.testing.assert_array_equal(got, (acts == 1).astype(np.float32) - (acts == 2))
    for k in range(27):
        np.testing.assert_array_equal(got[k], np.asarray(jf.u_frac(None, jnp.asarray(acts[k]),
                                                                   jnp.asarray(i_out[k]))))
        np.testing.assert_allclose(got_i[k], float(jf.i_sup(None, jnp.asarray(acts[k]),
                                                            jnp.asarray(i_out[k]))),
                                   rtol=1e-6, atol=1e-5)
    jc, tc = jcv.cont_asymmetric_bridge_converter(), tcv.cont_asymmetric_bridge_converter()
    assert tc.kind == jc.kind == "Cont-ASYM"
    np.testing.assert_array_equal(tc.action_space[1], jc.action_space[1])
    np.testing.assert_array_equal(tc.action_space[2], jc.action_space[2])
    duty = np.random.default_rng(3).uniform(-1.5, 1.5, (16, 3)).astype(np.float32)
    got = tc.u_frac(None, torch.as_tensor(duty), torch.as_tensor(i_out[:16])).numpy()
    np.testing.assert_array_equal(got, np.clip(duty, -1, 1))
    got_i = tc.i_sup(None, torch.as_tensor(duty), torch.as_tensor(i_out[:16])).numpy()
    for k in range(16):
        np.testing.assert_allclose(got_i[k], float(jc.i_sup(None, jnp.asarray(duty[k]),
                                                            jnp.asarray(i_out[k]))),
                                   rtol=1e-6, atol=1e-5)
    for conv in (tf, tc):
        assert conv.n_state == 0 and conv.n_out == 3
        np.testing.assert_array_equal(conv.currents[0], np.zeros(3))
    for jfac, tfac in ((jcv.finite_asymmetric_bridge_converter,
                        tcv.finite_asymmetric_bridge_converter),
                       (jcv.cont_asymmetric_bridge_converter,
                        tcv.cont_asymmetric_bridge_converter)):
        with pytest.raises(AssertionError, match="shoot-through"):
            jfac(interlocking_time=1e-6)
        with pytest.raises(ValueError, match="shoot-through"):
            tfac(interlocking_time=1e-6)


@pytest.mark.parametrize("env_id,init", [
    ("Finite-CC-SRM-v0", None),
    ("Cont-SC-SRM-v0", {"random_init": "uniform"}),
])
def test_reset_from_u_matches_jax(env_id, init):
    kw = dict(motor=dict(motor_initializer=init)) if init else {}
    jps = gemx.make_functional(env_id, **kw).physical_system
    tps = gt.make_functional(env_id, device="cpu", **kw).physical_system
    assert isinstance(tps, SRMSystem)
    assert tps.reset_n_u == jps.reset_n_u
    assert tps.state_names == list(jps.state_names)
    n = 16
    if tps.reset_n_u:
        u = np.random.default_rng(3).uniform(size=(n, tps.reset_n_u)).astype(np.float32)
        jstate, jsys = jax.vmap(jps.reset_from_u)(jnp.asarray(u))
        jode, jsys = np.asarray(jstate.ode_state), np.asarray(jsys)
        ps, sys_state = tps.reset_from_u(torch.as_tensor(u), n, "cpu")
        assert float(ps.ode_state[:, 1:4].min()) >= 0.0  # unipolar draws
        assert float(ps.ode_state[:, 1:4].max()) > 0.0
    else:
        jstate, jsys = jps.reset_from_u(None)
        jode = np.asarray(jstate.ode_state)[None].repeat(n, 0)
        jsys = np.asarray(jsys)[None].repeat(n, 0)
        ps, sys_state = tps.reset_from_u(torch.zeros((n, 0)), n, "cpu")
    np.testing.assert_allclose(ps.ode_state.numpy(), jode, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(sys_state.numpy(), jsys, rtol=1e-5, atol=1e-6)


def _actions(env_id, T, N, rng):
    """Half of the envs magnetise every phase, which drives the currents
    past 20 A (about 11 kA/s) and through resets; the other half take
    random actions: ``(T, N, 3)`` commands or duties."""
    if env_id.startswith("Finite"):
        acts = rng.integers(0, 3, (T, N, 3)).astype(np.int32)
        acts[:, : N // 2] = 1
        return acts
    acts = rng.uniform(-1, 1, (T, N, 3)).astype(np.float32)
    acts[:, : N // 2] = 1.0
    return acts


def _assert_angle_cols(got, want, cols, period, msg):
    """Columns ``cols`` equal modulo ``period``, the others at ENV_TOL."""
    other = [j for j in range(got.shape[1]) if j not in cols]
    np.testing.assert_allclose(got[:, other], want[:, other], **ENV_TOL, err_msg=msg)
    d = np.remainder(got[:, cols] - want[:, cols], period)
    np.testing.assert_allclose(np.minimum(d, period - d), 0.0, atol=1e-4, err_msg=msg)


GENERAL_CASES = [(e, {}) for e in gt.SRM_ENV_IDS] + [
    ("Finite-TC-SRM-v0", SAT), ("Cont-SC-SRM-v0", SAT)]


@pytest.mark.parametrize("env_id,kw", GENERAL_CASES,
                         ids=[e + ("-psi_s" if kw else "") for e, kw in GENERAL_CASES])
def test_general_path_matches_jax_env(env_id, kw):
    jenv, tenv = const_envs(env_id, **kw)
    # the finite ids step at tau = 1e-5: the forced envs pass the limit
    # after about 180 steps
    N, T = 8, (230 if env_id.startswith("Finite") else 40)
    acts = _actions(env_id, T, N, np.random.default_rng(0))
    js, _ = jax.vmap(jenv.reset)(jax.random.split(jax.random.PRNGKey(0), N))
    ts, _ = tenv.reset(trng.env_keys(0, N, "cpu"))
    step = jax.jit(jax.vmap(jenv.step_autoreset))
    ps = tenv.physical_system
    eps_ode = [ps.eps_idx]
    eps_obs = [list(tenv.state_names).index("epsilon")]
    n_term = 0
    for t in range(T):
        js, jo, jr, jterm = step(js, jnp.asarray(acts[t]))
        ts, to, tr, tterm = tenv.step_autoreset(ts, torch.as_tensor(acts[t]))
        msg = f"{env_id} step {t}"
        ode = ts.phys.ode_state.numpy()
        _assert_angle_cols(ode, np.asarray(js.phys.ode_state), eps_ode, 2 * np.pi, msg)
        _assert_angle_cols(to[0].numpy(), np.asarray(jo[0]), eps_obs, 2.0, msg)
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-4, atol=1e-5, err_msg=msg)
        np.testing.assert_array_equal(tterm.numpy(), np.asarray(jterm), err_msg=msg)
        assert ode[:, ps.n_mech:ps.n_mech + 3].min() >= 0.0  # the diode clamp
        assert np.all(np.abs(ode[:, ps.eps_idx]) <= np.float32(np.pi))
        n_term += int(tterm.sum())
    assert n_term > 0  # the forced envs reset


def test_catalog_defaults_match_jax():
    """The five SRM rows where every other default table would fall
    through to a wrong value."""
    for env_id in gt.SRM_ENV_IDS:
        jenv = gemx.make_functional(env_id)
        tenv = gt.make_functional(env_id, device="cpu")
        tps, jps = tenv.physical_system, jenv.physical_system
        task = env_id.split("-")[1]
        assert float(tps.supply.u_nominal) == float(jps.supply.u_nominal) == 400.0
        assert tps.converter.kind == jps.converter.kind == (
            "Finite-ASYM" if env_id.startswith("Finite") else "Cont-ASYM")
        subs = tenv.reference_generator.subs
        want = {"CC": ["i_a", "i_b", "i_c"], "TC": ["torque"], "SC": ["omega"]}[task]
        assert [s.reference_state for s in subs] == want == list(jenv.reference_names)
        assert all(s.kind == "wiener" for s in subs)
        if task == "CC":
            assert all(tuple(s.margin) == (0.0, 1.0) for s in subs)
            assert all(tuple(s.sigma_range) == (1e-3, 1e-1) for s in subs)
        w = np.asarray(tenv.reward_function._weights)
        np.testing.assert_array_equal(w, np.asarray(jenv.reward_function._weights))
        if task == "CC":
            names = list(tps.state_names)
            assert all(w[names.index(n)] == pytest.approx(1 / 3) for n in want)
        (con,) = tenv.constraint_monitor.constraints
        assert type(con).__name__ == "LimitConstraint"
        assert tuple(con.observed_state_names) == ("i_a", "i_b", "i_c")


@pytest.mark.parametrize("env_id", ["Finite-TC-SRM-v0", "Cont-SC-SRM-v0"])
def test_converter_dict_merges_into_the_asymmetric_bridge(env_id):
    tenv = gt.make_functional(env_id, device="cpu", converter=dict(n_phases=3))
    jenv = gemx.make_functional(env_id, converter=dict(n_phases=3))
    conv = tenv.physical_system.converter
    assert conv.kind == jenv.physical_system.converter.kind
    assert conv.tau == tenv.physical_system.tau
    with pytest.raises(ValueError, match="shoot-through"):
        gt.make_functional(env_id, device="cpu", converter=dict(interlocking_time=1e-6))


def test_control_space_dq_raises_value_error():
    with pytest.raises(ValueError, match="SRM"):
        gt.make_functional("Cont-CC-SRM-v0", device="cpu", control_space="dq")
    with pytest.raises(ValueError, match="SRM"):
        gemx.make_functional("Cont-CC-SRM-v0", control_space="dq")


@pytest.mark.parametrize("env_id", gt.SRM_ENV_IDS)
def test_make_steps_each_srm_id(env_id):
    """``make`` serves the id at 256 envs on the CPU: reset, a few random
    steps, finite states and rewards; the catalog holds all 60 ids."""
    assert len(gt.ENV_IDS) == 60 == len(set(gt.ENV_IDS)) and env_id in gt.ENV_IDS
    venv = gt.make(env_id, n_envs=256, device="cpu")
    state, obs = venv.reset(3)
    assert obs[0].shape == (256, len(venv.env.state_names))
    state, rewards, terms = venv.rollout(state, gt.random_policy_for(venv.env), 5,
                                         torch.Generator().manual_seed(1))
    assert bool(torch.isfinite(state.phys.ode_state).all()) and bool(torch.isfinite(rewards).all())
    assert state.phys.ode_state.shape == (256, 5)  # omega, i_a, i_b, i_c, epsilon
