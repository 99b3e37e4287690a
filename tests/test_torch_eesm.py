"""The port's externally excited synchronous motor (EESM) and its six env
ids against the JAX package, and the catalog's converter overrides.

* The ``eesm()`` spec (parameters, limits, nominal values, the torque limit
  of ``_eesm_torque_limit`` on its l_d != l_q branch, the initializer)
  equals the JAX one.
* ``eesm_ode`` and ``eesm_torque`` on seeded numpy states, voltages and
  speeds: rtol 1e-6 / atol 1e-2 (A/s, N m; the same float32 expressions,
  as tests/test_torch_scim.py holds the SCIM; XLA may turn a division by a
  constant into a product; the excitation current's rate reaches 1e7 A/s).
* ``EESMSystem.reset_from_u`` for the default initializer and a uniform
  one: ode state and normalised system state at rtol 1e-5 / atol 1e-6.
* The general path: the port's env against ``jax.vmap(env.step_autoreset)``
  under one action buffer and constant references on all six ids, half of
  the envs driven past the current limits so that they reset:
  ``ode_state`` and the observation at rtol 1e-4 / atol 1e-3 (the JAX
  suite's tolerance for env against kernel, tests/test_pallas_families.py:
  70-72), reward at rtol 1e-4 / atol 1e-5, termination exactly.
* A ``converter=dict(...)`` override merges into the default converter's
  factory, as the JAX catalog does (catalog.py:256-260), and a multi
  converter keeps its default.
* Every EESM option the port does not simulate raises, naming its queue
  item; ``make`` serves the six ids, 60 in all (with the DFIM's and the
  SRM's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_electric_motor_tpu as gemx
from gym_electric_motor_tpu.models import motors as jmt
import gym_electric_motor_tpu_torch as gt
from gym_electric_motor_tpu_torch import references as trg
from gym_electric_motor_tpu_torch.constraints import LimitConstraint, SquaredConstraint
from gym_electric_motor_tpu_torch.models import motors as tmt
from gym_electric_motor_tpu_torch.ops import fused_rollout as fr
from gym_electric_motor_tpu_torch.physical_systems import EESMSystem
from gym_electric_motor_tpu_torch.utils import rng as trng
from test_torch_scim import ENV_TOL, _fused, _wrapped
from test_torch_scim import const_envs as _const_envs

torch.set_num_threads(1)

CONST_REFS = {"CC": [("i_sd", 0.1), ("i_sq", -0.2), ("i_e", 0.3)], "TC": [("torque", 0.3)],
              "SC": [("omega", 0.2)]}


def const_envs(env_id, refs=None, **kw):
    """The JAX and the port env of ``env_id`` with constant references (by
    default the task's: three rows for CC)."""
    return _const_envs(env_id, refs or CONST_REFS[env_id.split("-")[1]], **kw)


def test_eesm_spec_matches_jax():
    for kw in ({}, dict(motor_parameter={"r_e": 9e-3}, limit_values={"i_e": 120.0},
                        nominal_values={"i": 100.0})):
        j, t = jmt.eesm(**kw), tmt.eesm(**kw)
        assert t.kind == j.kind == "EESM"
        assert t.parameter == j.parameter
        assert t.limits == pytest.approx(j.limits) and set(t.limits) == set(j.limits)
        assert t.nominal == pytest.approx(j.nominal) and set(t.nominal) == set(j.nominal)
        assert t.limits["torque"] == pytest.approx(j.limits["torque"], rel=1e-15)
        assert t.initializer == j.initializer
        assert (t.ode_states, t.currents, t.voltages) == (j.ode_states, j.currents, j.voltages)
    # the torque limit takes the l_d != l_q branch with the nominal current
    p = tmt.eesm().parameter
    assert p["l_d"] > p["l_q"]
    tl = tmt._eesm_torque_limit(p, tmt.eesm().limits, tmt.eesm().nominal)
    assert tl == jmt._eesm_torque_limit(p, jmt.eesm().limits, jmt.eesm().nominal) > 0


def test_eesm_ode_and_torque_match_jax():
    spec, jspec = tmt.eesm(), jmt.eesm()
    rng = np.random.default_rng(6)
    n = 64
    state = np.concatenate([rng.uniform(-150, 150, (n, 3)),
                            rng.uniform(-np.pi, np.pi, (n, 1))], axis=1).astype(np.float32)
    u = rng.uniform(-300, 300, (n, 3)).astype(np.float32)
    omega = rng.uniform(-400, 400, n).astype(np.float32)
    jmp = jspec.mp()
    jode = jax.vmap(lambda s, u_, w: jmt.eesm_ode(jmp, s, u_, w))
    jtq = jax.vmap(lambda s: jmt.eesm_torque(jmp, s))
    args = [torch.as_tensor(x) for x in (state, u, omega)]
    got = tmt.eesm_ode(spec.mp(), *args).numpy()
    np.testing.assert_allclose(got, np.asarray(jode(state, u, omega)), rtol=1e-6, atol=1e-2)
    got = tmt.eesm_torque(spec.mp(), args[0]).numpy()
    np.testing.assert_allclose(got, np.asarray(jtq(state)), rtol=1e-6, atol=1e-4)
    np.testing.assert_array_equal(spec.i_in(spec.mp(), args[0]).numpy(), state[:, :3])


@pytest.mark.parametrize("env_id,init", [
    ("Finite-CC-EESM-v0", None),
    ("Cont-SC-EESM-v0", {"random_init": "uniform"}),
])
def test_reset_from_u_matches_jax(env_id, init):
    """The same uniforms through both resets."""
    kw = dict(motor=dict(motor_initializer=init)) if init else {}
    jps = gemx.make_functional(env_id, **kw).physical_system
    tps = gt.make_functional(env_id, device="cpu", **kw).physical_system
    assert isinstance(tps, EESMSystem) and tps.state_names == list(jps.state_names)
    assert tps.reset_n_u == jps.reset_n_u
    n = 16
    if tps.reset_n_u:
        u = np.random.default_rng(2).uniform(size=(n, tps.reset_n_u)).astype(np.float32)
        jstate, jsys = jax.vmap(jps.reset_from_u)(jnp.asarray(u))
        jode, jsys = np.asarray(jstate.ode_state), np.asarray(jsys)
        ps, sys_state = tps.reset_from_u(torch.as_tensor(u), n, "cpu")
        assert float(ps.ode_state[:, 1:4].abs().min()) > 0.0  # the currents were drawn
    else:
        jstate, jsys = jps.reset_from_u(None)
        jode = np.asarray(jstate.ode_state)[None].repeat(n, 0)
        jsys = np.asarray(jsys)[None].repeat(n, 0)
        ps, sys_state = tps.reset_from_u(torch.zeros((n, 0)), n, "cpu")
    np.testing.assert_allclose(ps.ode_state.numpy(), jode, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(sys_state.numpy(), jsys, rtol=1e-5, atol=1e-6)


def _actions(env_id, T, N, rng):
    """Half of the envs hold one bridge state (finite: phase c high,
    continuous: phase a) and the excitation at +u_sup, which drives them past
    the current limits and through resets; the other half take random
    actions: (T, N, 2) or (T, N, 4)."""
    if env_id.startswith("Finite"):
        acts = np.stack([rng.integers(0, 8, (T, N)), rng.integers(0, 4, (T, N))], -1)
        acts[:, : N // 2] = (1, 1)
        return acts.astype(np.int32)
    acts = rng.uniform(-1, 1, (T, N, 4)).astype(np.float32)
    acts[:, : N // 2] = (1.0, -1.0, -1.0, 1.0)
    return acts


@pytest.mark.parametrize("env_id", gt.EESM_ENV_IDS)
def test_general_path_matches_jax_env(env_id):
    jenv, tenv = const_envs(env_id)
    N, T = 8, 50
    acts = _actions(env_id, T, N, np.random.default_rng(0))
    js, _ = jax.vmap(jenv.reset)(jax.random.split(jax.random.PRNGKey(0), N))
    ts, _ = tenv.reset(trng.env_keys(0, N, "cpu"))
    step = jax.jit(jax.vmap(jenv.step_autoreset))
    n_term = 0
    for t in range(T):
        js, jo, jr, jterm = step(js, jnp.asarray(acts[t]))
        ts, to, tr, tterm = tenv.step_autoreset(ts, torch.as_tensor(acts[t]))
        msg = f"{env_id} step {t}"
        np.testing.assert_allclose(ts.phys.ode_state.numpy(), np.asarray(js.phys.ode_state),
                                   **ENV_TOL, err_msg=msg)
        np.testing.assert_allclose(to[0].numpy(), np.asarray(jo[0]), **ENV_TOL, err_msg=msg)
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-4, atol=1e-5, err_msg=msg)
        np.testing.assert_array_equal(tterm.numpy(), np.asarray(jterm), err_msg=msg)
        n_term += int(tterm.sum())
    assert n_term > 0  # the forced envs reset


@pytest.mark.parametrize("env_id,kind", [("Finite-CC-PMSM-v0", "Finite-B6C"),
                                         ("Cont-CC-PermExDc-v0", "Cont-4QC")])
def test_converter_dict_merges_into_the_default_factory(env_id, kind):
    """``converter=dict(...)`` builds the default converter's kind through
    its factory with the env's tau, as the JAX catalog does; ``tau`` itself
    comes from the env (a ``tau`` key meets the factory's own and raises
    TypeError in both packages)."""
    kw = dict(converter=dict(interlocking_time=0.0), tau=2e-5)
    jc = gemx.make_functional(env_id, **kw).physical_system.converter
    tc = gt.make_functional(env_id, device="cpu", **kw).physical_system.converter
    assert tc.kind == jc.kind == kind
    assert tc.tau == jc.tau == 2e-5 and tc.interlocking_time == jc.interlocking_time == 0.0
    assert (tc.action_type, tc.n_state, tc.n_out, tc.n_in) == (jc.action_type, jc.n_state,
                                                               jc.n_out, jc.n_in)
    np.testing.assert_array_equal(tc.u_reset, jc.u_reset)
    for pkg, kwargs in ((gemx, {}), (gt, dict(device="cpu"))):
        with pytest.raises(TypeError, match="tau"):
            pkg.make_functional(env_id, converter=dict(tau=2e-5), **kwargs)


def test_converter_dict_interlocking_raises_queue_item_8():
    with pytest.raises(NotImplementedError, match="queue 2, item 8"):
        gt.make_functional("Finite-CC-PMSM-v0", device="cpu",
                           converter=dict(interlocking_time=1e-6))


@pytest.mark.parametrize("env_id", ["Finite-CC-EESM-v0", "Cont-SC-EESM-v0"])
def test_converter_dict_leaves_the_eesm_multi_converter_at_its_default(env_id):
    """The JAX catalog keeps a multi converter's default whatever the dict
    holds (here an interlocking time that would otherwise raise)."""
    kw = dict(converter=dict(interlocking_time=1e-6))
    jc = gemx.make_functional(env_id, **kw).physical_system.converter
    tc = gt.make_functional(env_id, device="cpu", **kw).physical_system.converter
    assert tc.kind == jc.kind and tc.sub_kinds == jc.sub_kinds
    assert tc.interlocking_time == jc.interlocking_time == 0.0
    assert tc.action_space[0] == jc.action_space[0]
    np.testing.assert_array_equal(np.asarray(tc.action_space[1]), np.asarray(jc.action_space[1]))


UNFUSED = {
    "control_space_dq": lambda: gt.make_functional("Cont-CC-EESM-v0", device="cpu",
                                                   control_space="dq"),
    "fused_control_space_dq": _fused("Cont-CC-EESM-v0", mutate=lambda e: setattr(
        e.physical_system, "control_space", "dq")),
    "eesm_dq_to_abc_wrapper": _fused("Cont-CC-EESM-v0", mutate=lambda e: setattr(
        e, "physical_system", _wrapped("_EESMDqToAbcActionProcessor", e.physical_system))),
    "dead_time": _fused("Finite-CC-EESM-v0", mutate=lambda e: setattr(
        e, "physical_system", _wrapped("DeadTimeProcessor", e.physical_system))),
    "state_noise": _fused("Cont-TC-EESM-v0", mutate=lambda e: setattr(
        e, "physical_system", _wrapped("StateNoiseProcessor", e.physical_system))),
    "interlocking_fused": _fused("Finite-TC-EESM-v0", mutate=lambda e: setattr(
        e.physical_system.converter, "interlocking_time", 1e-6)),
    "randomize": lambda: fr.make_fused_rollout(
        gt.make_functional("Cont-CC-EESM-v0", device="cpu"), 8, 128,
        randomize={"r_e": (0.9, 1.1)}),
    "sinusoidal_reference": lambda: trg.ScalarRefSpec("sinusoidal", "torque"),
    "limit_constraint_only": _fused("Cont-CC-EESM-v0", constraints=(LimitConstraint(("i_e",)),)),
    "squared_constraint_only": _fused("Cont-CC-EESM-v0",
                                      constraints=(SquaredConstraint(("i_sq", "i_sd")),)),
    "omega_reference_const_speed": _fused("Cont-CC-EESM-v0",
                                          reference_generator=trg.ConstReference("omega", 0.1)),
    "four_references": _fused("Cont-SC-EESM-v0", reference_generator=trg.ReferenceSpec(
        [trg.ConstReference(n, 0.0) for n in ("i_sd", "i_sq", "i_e", "omega")])),
    "two_references": _fused("Cont-CC-EESM-v0", reference_generator=trg.ReferenceSpec(
        [trg.ConstReference(n, 0.0) for n in ("i_sd", "i_sq")]),
        reward_function=gt.rewards.WeightedSumOfErrors(reward_weights=dict(i_sd=0.5, i_sq=0.5))),
    "euler_solver": _fused("Cont-TC-EESM-v0", solver="euler"),
    "eesm_kernels_on_pmsm": lambda: fr.make_fused_eesm_family_rollout(
        gt.make_functional("Cont-CC-PMSM-v0", device="cpu"), 8, 128),
}
# what the JAX kernels do not fuse either: the message points at VectorEnv
NEVER_FUSED = {"limit_constraint_only", "squared_constraint_only", "omega_reference_const_speed",
               "euler_solver", "eesm_kernels_on_pmsm"}


@pytest.mark.parametrize("option", list(UNFUSED))
def test_unported_options_raise(option):
    """Each raises NotImplementedError, naming the queue item or slice that
    brings it where the JAX kernels fuse it."""
    with pytest.raises(NotImplementedError,
                       match=None if option in NEVER_FUSED else r"(queue|slice) \d"):
        UNFUSED[option]()


@pytest.mark.parametrize("env_id", gt.EESM_ENV_IDS)
def test_make_steps_each_eesm_id(env_id):
    """``make`` serves the id at 256 envs on the CPU: reset, a few random
    steps, finite states and rewards; the catalog now holds 60 ids."""
    assert len(gt.ENV_IDS) == 60 and env_id in gt.ENV_IDS
    venv = gt.make(env_id, n_envs=256, device="cpu")
    state, obs = venv.reset(3)
    assert obs[0].shape == (256, len(venv.env.state_names))
    state, rewards, terms = venv.rollout(state, gt.random_policy_for(venv.env), 5,
                                         torch.Generator().manual_seed(1))
    assert bool(torch.isfinite(state.phys.ode_state).all()) and bool(torch.isfinite(rewards).all())
    assert state.phys.ode_state.shape == (256, 5)  # omega, i_sd, i_sq, i_e, epsilon
