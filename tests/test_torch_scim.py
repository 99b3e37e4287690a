"""The port's squirrel-cage induction motor (SCIM) and its six env ids
against the JAX package.

* The ``scim()`` spec (parameters, limits, nominal values, the torque limit
  of ``_im_torque_limit``, the initializer) equals the JAX one.
* ``induction_ode``, ``scim_ode`` and ``induction_torque`` on seeded numpy
  states, voltages and speeds: rtol 1e-6 / atol 1e-3 (A/s, Wb/s, N m; the
  same float32 expressions, as tests/test_torch_dc_universal.py holds the
  DC motors; XLA may turn a division by a constant into a product).
* ``SCIMSystem.reset_from_u`` on the same uniforms, for the constant
  default initializer and a uniform one (the random field angle that
  rotates the initial flux): ode state and normalised system state at
  rtol 1e-5 / atol 1e-6.
* The general path: the port's env against ``jax.vmap(env.step_autoreset)``
  under one action buffer and constant references on all six ids, half of
  the envs driven past the current limit so that they reset: ``ode_state``
  and the observation at rtol 1e-4 / atol 1e-3 (the JAX suite's tolerance
  for env against kernel, tests/test_pallas_families.py:70-72), reward at
  rtol 1e-4 / atol 1e-5, termination exactly.
* Every SCIM option the port does not simulate raises, naming its queue
  item; ``make`` serves the six ids (60 ids in all, with the EESM's,
  the DFIM's and the SRM's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_electric_motor_tpu as gemx
from gym_electric_motor_tpu import references as jrg
from gym_electric_motor_tpu.models import motors as jmt
import gym_electric_motor_tpu_torch as gt
from gym_electric_motor_tpu_torch import references as trg
from gym_electric_motor_tpu_torch.constraints import LimitConstraint
from gym_electric_motor_tpu_torch.models import converters as tcv
from gym_electric_motor_tpu_torch.models import motors as tmt
from gym_electric_motor_tpu_torch.models import supplies as tsp
from gym_electric_motor_tpu_torch.ops import fused_rollout as fr
from gym_electric_motor_tpu_torch.physical_systems import SCIMSystem
from gym_electric_motor_tpu_torch.utils import rng as trng

torch.set_num_threads(1)

ENV_TOL = dict(rtol=1e-4, atol=1e-3)
CONST_REFS = {"CC": [("i_sd", 0.1), ("i_sq", -0.2)], "TC": [("torque", 0.3)],
              "SC": [("omega", 0.2)]}


def const_envs(env_id, refs=None, **kw):
    """The JAX and the port env of ``env_id`` with constant references
    (``refs``: (state, value) pairs, by default the task's)."""
    refs = refs or CONST_REFS[env_id.split("-")[1]]
    jenv = gemx.make_functional(env_id, reference_generator=jrg.ReferenceSpec(
        [jrg.ConstReference(n, v) for n, v in refs]), **kw)
    tenv = gt.make_functional(env_id, device="cpu", reference_generator=trg.ReferenceSpec(
        [trg.ConstReference(n, v) for n, v in refs]), **kw)
    return jenv, tenv


def test_scim_spec_matches_jax():
    for kw in ({}, dict(motor_parameter={"r_r": 1.5}, limit_values={"i": 7.0},
                        nominal_values={"u": 400.0})):
        j, t = jmt.scim(**kw), tmt.scim(**kw)
        assert t.kind == j.kind == "SCIM"
        assert t.parameter == j.parameter
        assert t.limits == pytest.approx(j.limits) and set(t.limits) == set(j.limits)
        assert t.nominal == pytest.approx(j.nominal) and set(t.nominal) == set(j.nominal)
        assert t.limits["torque"] == pytest.approx(j.limits["torque"], rel=1e-15)
        assert t.limits["u_sa"] == 0.5 * t.limits["u"]  # half the placeholder 'u'
        assert t.initializer == j.initializer and t.initial_limits == j.initial_limits
        assert (t.ode_states, t.currents, t.voltages) == (j.ode_states, j.currents, j.voltages)


def test_induction_ode_and_torque_match_jax():
    spec, jspec = tmt.scim(), jmt.scim()
    rng = np.random.default_rng(5)
    n = 64
    state = np.concatenate([rng.uniform(-8, 8, (n, 2)), rng.uniform(-0.8, 0.8, (n, 2)),
                            rng.uniform(-np.pi, np.pi, (n, 1))], axis=1).astype(np.float32)
    u_s = rng.uniform(-300, 300, (n, 2)).astype(np.float32)
    u_r = rng.uniform(-50, 50, (n, 2)).astype(np.float32)
    omega = rng.uniform(-400, 400, n).astype(np.float32)
    jmp = jspec.mp()
    jode = jax.vmap(lambda s, us, ur, w: jmt.induction_ode(jmp, s, (us, ur), w))
    jscim = jax.vmap(lambda s, us, w: jmt.scim_ode(jmp, s, us, w))
    jtq = jax.vmap(lambda s: jmt.induction_torque(jmp, s))
    args = [torch.as_tensor(x) for x in (state, u_s, u_r, omega)]
    got = tmt.induction_ode(spec.mp(), args[0], (args[1], args[2]), args[3]).numpy()
    want = np.asarray(jode(state, u_s, u_r, omega))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-3)
    got = tmt.scim_ode(spec.mp(), args[0], args[1], args[3]).numpy()
    np.testing.assert_allclose(got, np.asarray(jscim(state, u_s, omega)), rtol=1e-6, atol=1e-3)
    got = tmt.induction_torque(spec.mp(), args[0]).numpy()
    np.testing.assert_allclose(got, np.asarray(jtq(state)), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(spec.i_in(spec.mp(), args[0]).numpy(), state[:, :2])


@pytest.mark.parametrize("env_id,init", [
    ("Finite-CC-SCIM-v0", None),
    ("Cont-SC-SCIM-v0", {"random_init": "uniform"}),
    ("Finite-TC-SCIM-v0", {"random_init": "uniform",
                           "states": {"i_salpha": 0.0, "psi_ralpha": 0.0, "psi_rbeta": 0.0}}),
])
def test_reset_from_u_matches_jax(env_id, init):
    """The same uniforms through both resets.  A uniform initializer draws
    one more uniform, the field angle that rotates the drawn flux
    magnitude into its alpha/beta parts."""
    kw = dict(motor=dict(motor_initializer=init)) if init else {}
    jps = gemx.make_functional(env_id, **kw).physical_system
    tps = gt.make_functional(env_id, device="cpu", **kw).physical_system
    assert isinstance(tps, SCIMSystem)
    assert tps.reset_n_u == jps.reset_n_u
    n = 16
    if tps.reset_n_u:
        n_states = len(init.get("states") or jps.motor.ode_states)
        assert tps.reset_n_u == n_states + 1
        u = np.random.default_rng(2).uniform(size=(n, tps.reset_n_u)).astype(np.float32)
        jstate, jsys = jax.vmap(jps.reset_from_u)(jnp.asarray(u))
        jode, jsys = np.asarray(jstate.ode_state), np.asarray(jsys)
        ps, sys_state = tps.reset_from_u(torch.as_tensor(u), n, "cpu")
        flux = ps.ode_state[:, 3:5]
        assert float(flux.norm(dim=1).min()) > 0.0  # the drawn flux is rotated, not zeroed
    else:
        jstate, jsys = jps.reset_from_u(None)
        jode = np.asarray(jstate.ode_state)[None].repeat(n, 0)
        jsys = np.asarray(jsys)[None].repeat(n, 0)
        ps, sys_state = tps.reset_from_u(torch.zeros((n, 0)), n, "cpu")
    np.testing.assert_allclose(ps.ode_state.numpy(), jode, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(sys_state.numpy(), jsys, rtol=1e-5, atol=1e-6)


def _actions(env_id, T, N, rng):
    """Half of the envs hold the bridge at its largest alpha voltage (phase
    a high, b and c low: 280 V), which drives them past the current limit
    and through resets; the other half take random actions."""
    if env_id.startswith("Finite"):
        acts = rng.integers(0, 8, (T, N)).astype(np.int32)
        acts[:, : N // 2] = 4
        return acts
    acts = rng.uniform(-1, 1, (T, N, 3)).astype(np.float32)
    acts[:, : N // 2] = (1.0, -1.0, -1.0)
    return acts


@pytest.mark.parametrize("env_id", gt.SCIM_ENV_IDS)
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


class _Wrapper:
    """A stand-in physical-system wrapper: the check reads the class name
    and the ``inner`` chain only."""

    def __init__(self, inner):
        self.inner = inner


def _wrapped(name, ps):
    return type(name, (_Wrapper,), {})(ps)


def _fused(env_id="Cont-CC-SCIM-v0", mutate=None, **kw):
    def build():
        env = gt.make_functional(env_id, device="cpu", **kw)
        if mutate:
            mutate(env)
        return fr.make_fused_rollout(env, 8, 128)
    return build


UNFUSED = {
    "control_space_dq": lambda: gt.make_functional("Cont-CC-SCIM-v0", device="cpu",
                                                   control_space="dq"),
    "fused_control_space_dq": _fused(mutate=lambda e: setattr(
        e.physical_system, "control_space", "dq")),
    "dq_to_abc_wrapper": _fused(mutate=lambda e: setattr(
        e, "physical_system", _wrapped("DqToAbcActionProcessor", e.physical_system))),
    "flux_observer_with_dq_to_abc": _fused(mutate=lambda e: setattr(
        e, "physical_system", _wrapped("DqToAbcActionProcessor",
                                       _wrapped("FluxObserver", e.physical_system)))),
    "dead_time": _fused(mutate=lambda e: setattr(
        e, "physical_system", _wrapped("DeadTimeProcessor", e.physical_system))),
    "state_noise": _fused(mutate=lambda e: setattr(
        e, "physical_system", _wrapped("StateNoiseProcessor", e.physical_system))),
    "catalog_wrapper": lambda: gt.make_functional(
        "Finite-CC-SCIM-v0", device="cpu", physical_system_wrappers=(_Wrapper(None),)),
    "interlocking": lambda: tcv.finite_b6_bridge_converter(1e-5, interlocking_time=1e-7),
    "interlocking_fused": _fused("Finite-TC-SCIM-v0", mutate=lambda e: setattr(
        e.physical_system.converter, "interlocking_time", 1e-6)),
    "no_converter": _fused(mutate=lambda e: setattr(
        e.physical_system.converter, "action_type", "none")),
    "ac3_supply": lambda: tsp.ac_3_phase_supply(),
    "ac1_supply": lambda: tsp.ac_1_phase_supply(),
    "rc_supply": lambda: tsp.rc_voltage_supply(),
    "handmade_ac3_supply": _fused(supply=tsp.SupplySpec(
        kind="AC3PhaseSupply", u_nominal=420.0, supply_range=(420.0, 420.0), voltage_len=1,
        parameter={"u_nominal": 420.0}, get_voltage=tsp.ideal_voltage_supply(420.0).get_voltage,
        reset_u=tsp.ideal_voltage_supply(420.0).reset_u)),
    "randomize": lambda: fr.make_fused_rollout(
        gt.make_functional("Cont-TC-SCIM-v0", device="cpu"), 8, 128,
        randomize={"r_r": (0.9, 1.1)}),
    "limit_constraint": _fused(constraints=(LimitConstraint(("i_sd",)),)),
    "unreferenced_weight": _fused(reward_function=gt.rewards.WeightedSumOfErrors(
        reward_weights=dict(i_sd=0.5, i_sq=0.4, torque=0.1))),
    "omega_reference_const_speed": _fused(reference_generator=trg.ConstReference("omega", 0.1)),
    "euler_solver": _fused(solver="euler"),
    "sync_kernels_on_scim": lambda: fr.make_fused_sync_rollout(
        gt.make_functional("Cont-CC-SCIM-v0", device="cpu"), 8, 128),
    "induction_kernels_on_pmsm": lambda: fr.make_fused_induction_rollout(
        gt.make_functional("Cont-CC-PMSM-v0", device="cpu"), 8, 128),
}
# what the JAX kernels do not fuse either: the message points at VectorEnv
NEVER_FUSED = {"limit_constraint", "unreferenced_weight", "omega_reference_const_speed",
               "euler_solver", "sync_kernels_on_scim", "induction_kernels_on_pmsm"}


@pytest.mark.parametrize("option", list(UNFUSED))
def test_unported_options_raise(option):
    """Each raises NotImplementedError, naming the queue item or slice that
    brings it where the JAX kernels fuse it."""
    with pytest.raises(NotImplementedError,
                       match=None if option in NEVER_FUSED else r"(queue|slice) \d"):
        UNFUSED[option]()


@pytest.mark.parametrize("env_id", gt.SCIM_ENV_IDS)
def test_make_steps_each_scim_id(env_id):
    """``make`` serves the id at 256 envs on the CPU: reset, a few random
    steps, finite states and rewards; the catalog now holds 60 ids."""
    assert len(gt.ENV_IDS) == 60 and env_id in gt.ENV_IDS
    venv = gt.make(env_id, n_envs=256, device="cpu")
    state, obs = venv.reset(3)
    assert obs[0].shape == (256, len(venv.env.state_names))
    state, rewards, terms = venv.rollout(state, gt.random_policy_for(venv.env), 5,
                                         torch.Generator().manual_seed(1))
    assert bool(torch.isfinite(state.phys.ode_state).all()) and bool(torch.isfinite(rewards).all())
    assert state.phys.ode_state.shape == (256, 6)  # omega, 4 alpha/beta states, epsilon
