"""The port's ConstraintMonitor against ``jax.vmap`` of the JAX package's
monitor (``gym_electric_motor_tpu/constraints.py:80-88``): a callable
``merge_violations`` and a bare callable constraint act on one env at a
time, as ``VectorEnv`` runs ``env.step`` under ``jax.vmap``; ``'max'`` and
``'product'`` merge per env too.  The degrees are exact (0 or 1, or a
callable's own value), so the two packages agree to float32 rounding.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_electric_motor_tpu as gemx
from gym_electric_motor_tpu import constraints as jc
import gym_electric_motor_tpu_torch as gt
from gym_electric_motor_tpu_torch import constraints as tc

STATE_NAMES = ["omega", "torque", "i_sd", "i_sq", "u_sup"]
LIMITS = np.array([100.0, 50.0, 10.0, 10.0, 400.0])
HIGH = np.ones(5)


def _bare(state):
    """A bare callable constraint on one env's (S,) state: the squared
    normalised current, a degree in [0, inf)."""
    return state[2] * state[2] + state[3] * state[3]


CASES = {
    "callable_merge": dict(constraints=lambda m: (m.LimitConstraint(("i_sd",)),
                                                  m.SquaredConstraint(("i_sd", "i_sq"))),
                           merge_violations=lambda d: d.max()),
    "bare_callable": dict(constraints=lambda m: (_bare, m.LimitConstraint(("omega",))),
                          merge_violations="max"),
    "product": dict(constraints=lambda m: (m.LimitConstraint(("i_sd",)),
                                           m.LimitConstraint(("omega",))),
                    merge_violations="product"),
    "max": dict(constraints=lambda m: (m.SquaredConstraint(("i_sd", "i_sq")),
                                       m.LimitConstraint(("omega",))),
                merge_violations="max"),
}


def _monitor(pkg, case):
    spec = CASES[case]
    mon = pkg.ConstraintMonitor(constraints=spec["constraints"](pkg),
                                merge_violations=spec["merge_violations"])
    return mon.bind(STATE_NAMES, LIMITS, HIGH)


@pytest.mark.parametrize("case", sorted(CASES))
def test_monitor_matches_jax_vmap(case):
    rng = np.random.default_rng(3)
    state = rng.uniform(-1.4, 1.4, (64, 5)).astype(np.float32)
    want = np.asarray(jax.vmap(_monitor(jc, case).check_constraints)(jnp.asarray(state)))
    got = _monitor(tc, case).check_constraints(torch.as_tensor(state)).numpy()
    assert got.shape == want.shape == (64,)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert 0 < (got >= 1.0).sum() < 64


def _probe_envs(merge):
    jenv = gemx.make_functional("Finite-CC-PMSM-v0")
    tenv = gt.make_functional("Finite-CC-PMSM-v0", device="cpu")
    jenv.constraint_monitor = dataclasses.replace(jenv.constraint_monitor, merge_violations=merge)
    tenv.constraint_monitor = dataclasses.replace(tenv.constraint_monitor, merge_violations=merge)
    return jenv, tenv


@pytest.mark.parametrize("merge", ["callable", "max"])
def test_one_env_over_its_limit_terminates_alone(merge):
    """The 4-env probe on Finite-CC-PMSM-v0: only env 1 starts far beyond
    its current limit, so only env 1 terminates and takes the violation
    reward -10, with a callable merge as with ``'max'``."""
    jenv, tenv = _probe_envs((lambda d: d.max()) if merge == "callable" else "max")
    n = 4
    lim = float(np.asarray(jenv.physical_system.limits)[
        list(jenv.physical_system.state_names).index("i_sd")])
    i_sd = 1  # the ode state is [omega, i_sd, i_sq, eps]
    actions = np.zeros(n, np.int32)

    jstate, _ = jax.vmap(jenv.reset)(jax.random.split(jax.random.PRNGKey(0), n))
    ode = jstate.phys.ode_state.at[1, i_sd].set(3.0 * lim)
    jstate = dataclasses.replace(jstate, phys=dataclasses.replace(jstate.phys, ode_state=ode))
    _s, _o, j_reward, j_term = jax.vmap(jenv.step)(jstate, jnp.asarray(actions))

    tstate, _ = gt.VectorEnv(tenv, n).reset(0)
    tstate.phys.ode_state[1, i_sd] = 3.0 * lim
    _s, _o, t_reward, t_term = tenv.step(tstate, torch.as_tensor(actions))

    assert t_term.shape == (n,) and t_reward.shape == (n,)
    assert t_term.tolist() == [False, True, False, False] == np.asarray(j_term).tolist()
    assert float(t_reward[1]) == float(j_reward[1]) == -10.0
    assert int((t_reward == -10.0).sum()) == 1
