"""The port's PMSM / SynRM models (and the SRM's ODE and torque), B6
converter and assembled system against the JAX package.

Inputs are drawn with numpy from fixed seeds and go through both packages
on the CPU.  ODE and torque: rtol 1e-6 / atol 1e-3 (A/s, N m): both
evaluate the same float32 expressions in the same order; XLA may fuse or
reorder a product of constants, and the derivatives reach 1e6 A/s, where
one float32 ulp is 0.06.
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_electric_motor_tpu as gemx
from gym_electric_motor_tpu.models import converters as jcv
from gym_electric_motor_tpu.models import loads as jld
from gym_electric_motor_tpu.models import motors as jmt
import gym_electric_motor_tpu_torch as gt
from gym_electric_motor_tpu_torch.models import converters as tcv
from gym_electric_motor_tpu_torch.models import loads as tld
from gym_electric_motor_tpu_torch.models import motors as tmt

torch.set_num_threads(1)

MOTORS = [("pmsm", "pmsm_ode", "pmsm_torque"), ("synrm", "synrm_ode", "synrm_torque"),
          ("switched_reluctance_motor", "srm_ode", "srm_torque")]


def _batch(seed, n=64):
    rng = np.random.default_rng(seed)
    state = np.stack([rng.uniform(-300, 300, n), rng.uniform(-300, 300, n),
                      rng.uniform(-10, 10, n)], axis=1).astype(np.float32)
    u_dq = rng.uniform(-250, 250, (n, 2)).astype(np.float32)
    omega = rng.uniform(-400, 400, n).astype(np.float32)
    return state, u_dq, omega


def _srm_batch(seed, n=64):
    """Unipolar phase currents up to 20 A, the angle in [-pi, pi), three
    phase voltages and a speed."""
    rng = np.random.default_rng(seed)
    state = np.concatenate([rng.uniform(0, 20, (n, 3)), rng.uniform(-np.pi, np.pi, (n, 1))],
                           axis=1).astype(np.float32)
    u_abc = rng.uniform(-400, 400, (n, 3)).astype(np.float32)
    omega = rng.uniform(-400, 400, n).astype(np.float32)
    return state, u_abc, omega


@pytest.mark.parametrize("factory,ode,torque", MOTORS)
def test_ode_and_torque_match_jax(factory, ode, torque):
    jspec, tspec = getattr(jmt, factory)(), getattr(tmt, factory)()
    state, u_dq, omega = (_srm_batch if ode == "srm_ode" else _batch)(len(factory))
    jmp = jspec.mp()
    want_d = np.stack([np.asarray(getattr(jmt, ode)(jmp, jnp.asarray(s), jnp.asarray(u), jnp.asarray(w)))
                       for s, u, w in zip(state, u_dq, omega)])
    got_d = getattr(tmt, ode)(tspec.mp(), torch.as_tensor(state), torch.as_tensor(u_dq),
                              torch.as_tensor(omega)).numpy()
    np.testing.assert_allclose(got_d, want_d, rtol=1e-6, atol=1e-3)
    want_t = np.array([float(getattr(jmt, torque)(jmp, jnp.asarray(s))) for s in state])
    got_t = getattr(tmt, torque)(tspec.mp(), torch.as_tensor(state)).numpy()
    np.testing.assert_allclose(got_t, want_t, rtol=1e-6, atol=1e-3)


@pytest.mark.parametrize("factory", ["pmsm", "synrm", "permex_dc", "series_dc", "shunt_dc",
                                     "extex_dc", "switched_reluctance_motor"])
@pytest.mark.parametrize("field", ["parameter", "limits", "nominal", "initializer",
                                   "ode_states", "currents", "voltages"])
def test_motor_spec_matches_jax(factory, field):
    assert getattr(getattr(tmt, factory)(), field) == getattr(getattr(jmt, factory)(), field)


def test_b6_u_frac_all_actions_match_jax():
    jb6, tb6 = jcv.finite_b6_bridge_converter(), tcv.finite_b6_bridge_converter()
    actions = np.arange(8)
    i_out = np.random.default_rng(0).normal(size=(8, 3)).astype(np.float32)
    t_states = tb6.bridge_actions(torch.as_tensor(actions))
    got = tb6.u_frac(t_states, torch.as_tensor(actions), torch.as_tensor(i_out)).numpy()
    got_isup = tb6.i_sup(t_states, torch.as_tensor(actions), torch.as_tensor(i_out)).numpy()
    for a in actions:
        j_states = jb6.bridge_actions(jnp.asarray(a))
        np.testing.assert_array_equal(t_states[a].numpy(), np.asarray(j_states))
        np.testing.assert_array_equal(got[a], np.asarray(jb6.u_frac(j_states, a, jnp.asarray(i_out[a]))))
        np.testing.assert_allclose(got_isup[a], float(jb6.i_sup(j_states, a, jnp.asarray(i_out[a]))),
                                   rtol=1e-6, atol=1e-6)
    # phase k is high iff bit (2 - k) of the action is set
    expect = np.array([[(a >> (2 - k)) & 1 for k in range(3)] for a in actions]) - 0.5
    np.testing.assert_array_equal(got, expect)


def test_cont_b6_u_frac_matches_jax():
    """Duty commands inside and outside [-1, 1]: the clipped duty minus 1/2
    and the supply current, against the JAX converter at zero interlock."""
    jb6, tb6 = jcv.cont_b6_bridge_converter(), tcv.cont_b6_bridge_converter()
    rng = np.random.default_rng(3)
    acts = rng.uniform(-1.5, 1.5, (32, 3)).astype(np.float32)
    i_out = rng.normal(size=(32, 3)).astype(np.float32)
    got = tb6.u_frac(None, torch.as_tensor(acts), torch.as_tensor(i_out)).numpy()
    got_isup = tb6.i_sup(None, torch.as_tensor(acts), torch.as_tensor(i_out)).numpy()
    for k in range(len(acts)):
        a, i = jnp.asarray(acts[k]), jnp.asarray(i_out[k])
        np.testing.assert_array_equal(got[k], np.asarray(jb6.u_frac(None, a, i)))
        np.testing.assert_allclose(got_isup[k], float(jb6.i_sup(None, a, i)), rtol=1e-6, atol=1e-6)
    assert (tb6.n_state, tb6.action_type, tb6.kind) == (jb6.n_state, jb6.action_type, jb6.kind)
    np.testing.assert_array_equal(tb6.default_action, jb6.default_action)


@pytest.mark.parametrize("params", [dict(a=0.01, b=0.01, c=0.0, j_load=1e-5),
                                    dict(a=0.5, b=0.2, c=0.1, j_load=1e-3)])
def test_polynomial_static_load_matches_jax(params):
    """d omega / dt at zero speed (sign 0), on both sides of the linearised
    band around it, and at random speeds and torques."""
    jl, tl = jld.polynomial_static_load(params), tld.polynomial_static_load(params)
    j_rotor = float(tmt.pmsm().parameter["j_rotor"])
    jlp, tlp = jl.lp(j_rotor), tl.lp(j_rotor)
    w_lin = params["a"] / (params["j_load"] + j_rotor) * 1e-3
    rng = np.random.default_rng(4)
    omega = np.concatenate([[0.0, 0.5 * w_lin, -0.5 * w_lin, 2 * w_lin, -2 * w_lin],
                            rng.uniform(-400, 400, 27)]).astype(np.float32)
    torque = rng.uniform(-5, 5, omega.shape).astype(np.float32)
    got = tl.ode(tlp, 0.0, torch.as_tensor(omega)[:, None], torch.as_tensor(torque)).numpy()
    want = np.stack([np.asarray(jl.ode(jlp, 0.0, jnp.asarray(w)[None], jnp.asarray(t)))
                     for w, t in zip(omega, torque)])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-3)
    assert tl.initializer == jl.initializer and tl.parameter == jl.parameter


@pytest.mark.parametrize("env_id", gt.ENV_IDS)
def test_system_layout_matches_jax(env_id):
    jenv = gemx.make_functional(env_id)
    tenv = gt.make_functional(env_id, device="cpu")
    jps, tps = jenv.physical_system, tenv.physical_system
    assert tps.state_names == list(jps.state_names)
    np.testing.assert_array_equal(tps.limits, np.asarray(jps.limits))
    np.testing.assert_array_equal(tps.nominal_state, np.asarray(jps.nominal_state))
    np.testing.assert_array_equal(tps.state_space_low, np.asarray(jps.state_space_low))
    np.testing.assert_array_equal(tps.state_space_high, np.asarray(jps.state_space_high))
    assert tenv.tau == jenv.tau
    if hasattr(jenv.action_space, "nvec"):  # the ExtExDc multi converter
        assert tenv.action_space.nvec == jenv.action_space.nvec
    elif env_id.startswith("Finite"):
        assert tenv.action_space.n == jenv.action_space.n
    else:
        np.testing.assert_array_equal(tenv.action_space.low, np.asarray(jenv.action_space.low))
        np.testing.assert_array_equal(tenv.action_space.high, np.asarray(jenv.action_space.high))
    assert float(tps.supply.u_nominal) == float(jps.supply.u_nominal)
    assert tps.load.kind == jps.load.kind
    assert tenv.reference_names == jenv.reference_names
    np.testing.assert_array_equal(tenv.observation_space[1].low, jenv.observation_space[1].low)
    assert tenv.reward_function._violation_value == jenv.reward_function._violation_value
    np.testing.assert_array_equal(tenv.reward_function._weights, jenv.reward_function._weights)


def test_port_imports_without_jax():
    """The port and chip_smoke.py import with ``jax`` and the JAX package
    blocked in ``sys.modules``."""
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['gym_electric_motor_tpu'] = None\n"
        "import gym_electric_motor_tpu_torch as gt\n"
        "for m in pkgutil.walk_packages(gt.__path__, 'gym_electric_motor_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "assert not any(k == 'jax' or k.startswith('jax.') for k, v in sys.modules.items() if v)\n"
    )
    root = __file__.rsplit("/tests/", 1)[0]
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
