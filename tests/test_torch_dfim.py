"""The port's doubly fed induction motor (DFIM) and its six env ids against
the JAX package.

* The ``dfim()`` spec (parameters, limits, nominal values, the torque limit
  of ``_im_torque_limit`` with the rotor resistance dividing the voltage
  limits, the initializer) equals the JAX one.
* ``induction_ode`` with rotor voltages and ``induction_torque`` on seeded
  numpy states, voltages and speeds at the DFIM's parameters: rtol 1e-6 /
  atol 1e-3 (A/s, Wb/s; the same float32 expressions; XLA may turn a
  division by a constant into a product).
* ``DFIMSystem.reset_from_u`` on the same uniforms, for the constant
  default initializer and a uniform one: ode state and normalised system
  state, with the rotor dq current at the field angle less the electrical
  angle, at rtol 1e-5 / atol 1e-6.
* The general path: the port's env against ``jax.vmap(env.step_autoreset)``
  under one action buffer and constant references on all six ids, half of
  the envs driven past the current limit so that they reset: ``ode_state``
  and the observation (the rotor dq current after a step at the field
  angle, the rotor "def" currents never rotated) at rtol 1e-4 / atol 1e-3
  (the JAX suite's tolerance for env against kernel,
  tests/test_pallas_families.py:70-72), reward at rtol 1e-4 / atol 1e-5,
  termination exactly.
* ``control_space="dq"`` raises ``ValueError`` naming the DFIM; a
  ``converter=dict(...)`` keeps the dual-B6 multi converter; every DFIM
  option the port does not simulate raises, naming its queue item; ``make``
  serves the six ids, 60 in all (with the SRM's).
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
from gym_electric_motor_tpu_torch.models import motors as tmt
from gym_electric_motor_tpu_torch.ops import fused_rollout as fr
from gym_electric_motor_tpu_torch.physical_systems import DFIMSystem
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


def test_dfim_spec_matches_jax():
    for kw in ({}, dict(motor_parameter={"r_r": 3.0}, limit_values={"i": 10.0},
                        nominal_values={"u": 600.0})):
        j, t = jmt.dfim(**kw), tmt.dfim(**kw)
        assert t.kind == j.kind == "DFIM"
        assert t.parameter == j.parameter
        assert t.limits == pytest.approx(j.limits) and set(t.limits) == set(j.limits)
        assert t.nominal == pytest.approx(j.nominal) and set(t.nominal) == set(j.nominal)
        assert t.limits["torque"] == pytest.approx(j.limits["torque"], rel=1e-15)
        assert t.limits["u_ra"] == t.limits["u_sa"] == 0.5 * t.limits["u"]
        assert t.initializer == j.initializer and t.initial_limits == j.initial_limits
        assert (t.ode_states, t.currents, t.voltages) == (j.ode_states, j.currents, j.voltages)
    assert tmt.MOTOR_FACTORIES["DFIM"] is tmt.dfim


def test_induction_ode_with_rotor_voltages_matches_jax():
    spec, jspec = tmt.dfim(), jmt.dfim()
    rng = np.random.default_rng(7)
    n = 64
    state = np.concatenate([rng.uniform(-12, 12, (n, 2)), rng.uniform(-2.5, 2.5, (n, 2)),
                            rng.uniform(-np.pi, np.pi, (n, 1))], axis=1).astype(np.float32)
    u_s = rng.uniform(-300, 300, (n, 2)).astype(np.float32)
    u_r = rng.uniform(-300, 300, (n, 2)).astype(np.float32)
    omega = rng.uniform(-180, 180, n).astype(np.float32)
    jmp = jspec.mp()
    jode = jax.vmap(lambda s, us, ur, w: jmt.induction_ode(jmp, s, (us, ur), w))
    jtq = jax.vmap(lambda s: jmt.induction_torque(jmp, s))
    args = [torch.as_tensor(x) for x in (state, u_s, u_r, omega)]
    got = spec.ode(spec.mp(), args[0], (args[1], args[2]), args[3]).numpy()
    want = np.asarray(jode(state, u_s, u_r, omega))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-3)
    # the rotor voltages enter the currents and the fluxes
    got0 = spec.ode(spec.mp(), args[0], (args[1], torch.zeros_like(args[2])), args[3]).numpy()
    assert np.abs(got - got0)[:, :4].min() > 0.0
    got = tmt.induction_torque(spec.mp(), args[0]).numpy()
    np.testing.assert_allclose(got, np.asarray(jtq(state)), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("env_id,init", [
    ("Finite-CC-DFIM-v0", None),
    ("Cont-SC-DFIM-v0", {"random_init": "uniform"}),
    ("Finite-TC-DFIM-v0", {"random_init": "uniform",
                           "states": {"i_salpha": 0.0, "psi_ralpha": 0.0, "psi_rbeta": 0.0,
                                      "epsilon": 0.0}}),
])
def test_reset_from_u_matches_jax(env_id, init):
    """The same uniforms through both resets.  A uniform initializer draws
    the states, the field angle that rotates the drawn flux, and (where it
    is drawn) the electrical angle, so both rotor dq frames differ."""
    kw = dict(motor=dict(motor_initializer=init)) if init else {}
    jps = gemx.make_functional(env_id, **kw).physical_system
    tps = gt.make_functional(env_id, device="cpu", **kw).physical_system
    assert isinstance(tps, DFIMSystem)
    assert tps.reset_n_u == jps.reset_n_u
    assert tps.state_names == list(jps.state_names)
    n = 16
    if tps.reset_n_u:
        u = np.random.default_rng(3).uniform(size=(n, tps.reset_n_u)).astype(np.float32)
        jstate, jsys = jax.vmap(jps.reset_from_u)(jnp.asarray(u))
        jode, jsys = np.asarray(jstate.ode_state), np.asarray(jsys)
        ps, sys_state = tps.reset_from_u(torch.as_tensor(u), n, "cpu")
        assert float(ps.ode_state[:, -4:-2].norm(dim=1).min()) > 0.0  # the drawn flux
    else:
        jstate, jsys = jps.reset_from_u(None)
        jode = np.asarray(jstate.ode_state)[None].repeat(n, 0)
        jsys = np.asarray(jsys)[None].repeat(n, 0)
        ps, sys_state = tps.reset_from_u(torch.zeros((n, 0)), n, "cpu")
    np.testing.assert_allclose(ps.ode_state.numpy(), jode, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(sys_state.numpy(), jsys, rtol=1e-5, atol=1e-6)


def _actions(env_id, T, N, rng):
    """Half of the envs hold the stator bridge at its largest alpha voltage
    (phase a high, b and c low) and the rotor bridge at its opposite, which
    drives the stator current past the limit (about 11 kA/s) and through
    resets; the other half
    take random actions: ``(T, N, 2)`` bridge actions or ``(T, N, 6)``
    duties."""
    if env_id.startswith("Finite"):
        acts = rng.integers(0, 8, (T, N, 2)).astype(np.int32)
        acts[:, : N // 2] = (4, 3)
        return acts
    acts = rng.uniform(-1, 1, (T, N, 6)).astype(np.float32)
    acts[:, : N // 2] = (1.0, -1.0, -1.0, -1.0, 1.0, 1.0)
    return acts


@pytest.mark.parametrize("env_id", gt.DFIM_ENV_IDS)
def test_general_path_matches_jax_env(env_id):
    jenv, tenv = const_envs(env_id)
    # the finite ids step at tau = 1e-5: the forced envs pass the limit
    # after about 80 steps
    N, T = 8, (120 if env_id.startswith("Finite") else 50)
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


def test_control_space_dq_raises_value_error():
    """The reference's DFIM system takes no control space (as
    tests/test_control_space_dq.py pins for the JAX package): a ValueError
    naming the DFIM, not the SCIM's NotImplementedError."""
    with pytest.raises(ValueError, match="DFIM"):
        gt.make_functional("Cont-CC-DFIM-v0", device="cpu", control_space="dq")
    with pytest.raises(ValueError, match="DFIM"):
        gemx.make_functional("Cont-CC-DFIM-v0", control_space="dq")


@pytest.mark.parametrize("env_id", ["Finite-TC-DFIM-v0", "Cont-SC-DFIM-v0"])
def test_converter_dict_keeps_the_dual_b6_converter(env_id):
    """A converter dict merges into the default converter; the dual-B6 multi
    converter keeps its default, as in the JAX package."""
    tenv = gt.make_functional(env_id, device="cpu", converter=dict(tau=1e-5))
    jenv = gemx.make_functional(env_id, converter=dict(tau=1e-5))
    conv = tenv.physical_system.converter
    finite = env_id.startswith("Finite")
    assert conv.kind == jenv.physical_system.converter.kind == (
        "Finite-Multi" if finite else "Cont-Multi")
    assert conv.sub_kinds == (("Finite-B6C",) * 2 if finite else ("Cont-B6C",) * 2)
    assert conv.n_out == 6 and len(conv.u_reset) == 6
    if finite:
        assert conv.action_space == ("multidiscrete", (8, 8))
    else:
        assert conv.action_space[1].shape == (6,)


def _fused(env_id="Cont-CC-DFIM-v0", mutate=None, **kw):
    def build():
        env = gt.make_functional(env_id, device="cpu", **kw)
        if mutate:
            mutate(env)
        return fr.make_fused_rollout(env, 8, 128)
    return build


UNFUSED = {
    "dead_time": _fused(mutate=lambda e: setattr(
        e, "physical_system", type("DeadTimeProcessor", (), {"inner": e.physical_system})())),
    "dq_to_abc_wrapper": _fused(mutate=lambda e: setattr(
        e, "physical_system",
        type("_DFIMDqToAbcActionProcessor", (), {"inner": e.physical_system})())),
    "interlocking": _fused("Finite-TC-DFIM-v0", mutate=lambda e: setattr(
        e.physical_system.converter, "interlocking_time", 1e-6)),
    "randomize": lambda: fr.make_fused_rollout(
        gt.make_functional("Cont-TC-DFIM-v0", device="cpu"), 8, 128,
        randomize={"r_r": (0.9, 1.1)}),
    "fused_control_space_dq": _fused(mutate=lambda e: setattr(
        e.physical_system, "control_space", "dq")),
}


@pytest.mark.parametrize("option", list(UNFUSED))
def test_unported_options_raise(option):
    with pytest.raises(NotImplementedError, match=r"queue 2, item \d"):
        UNFUSED[option]()


@pytest.mark.parametrize("env_id", gt.DFIM_ENV_IDS)
def test_make_steps_each_dfim_id(env_id):
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
