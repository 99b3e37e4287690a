"""The port's ``SRMCommutationController`` against the JAX package's.

* The control law: ``control`` on 256 envs for 50 steps, each side carrying
  its own integrator, from numpy-seeded normalised states and references,
  on the six SRM ids (CC, TC and SC on the finite and the continuous
  converter), against ``jax.jit(jax.vmap(ctrl.control))``: continuous
  duties and the integrator rtol 1e-5 / atol 1e-6, the finite per-phase
  commands equal, except in an env whose current lies within 1e-5 of a
  hysteresis edge or whose commutation lies within 1e-5 of a firing edge.
* ``control_environment`` with constant references (T 200, N 4) on
  Finite-SC-SRM-v0 and Cont-TC-SRM-v0 against the JAX one: states and
  rewards rtol 1e-4 / atol 2e-3, terminations equal.

The tuning against JAX is in tests/test_torch_controllers.py (all 34 ids),
the commutation cascade kernel in tests/test_torch_control_kernels.py.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_electric_motor_tpu as gemx
from gym_electric_motor_tpu import references as jrg
from gym_electric_motor_tpu.controllers import GemController as JaxController
import gym_electric_motor_tpu_torch as gt
from gym_electric_motor_tpu_torch import references as trg
from gym_electric_motor_tpu_torch.controllers import GemController, SRMCommutationController

torch.set_num_threads(1)

ENV_TOL = dict(rtol=1e-4, atol=2e-3)


def _edge_margin(ctrl, obs, ref, cs):
    """Per env, the least relative distance of a decision of the finite law
    to its edge, in float64 from the port's own internals: a phase current
    to i* -+ the hysteresis band, i* to 1e-6, and under TC and SC the
    firing test of each phase's slope gain against theta_on and the largest
    gain."""
    _cs, _a, ints = ctrl.control(cs, obs, ref, True)
    i_star = ints["i_star"].double() / ctrl.i_lim
    i_n = obs[:, torch.as_tensor(ctrl.current_idx)].double()
    dists = [torch.abs(i_n - (i_star - ctrl.hysteresis)),
             torch.abs(i_n - (i_star + ctrl.hysteresis)), torch.abs(i_star - 1e-6)]
    if ctrl.control_task != "CC":
        eps = obs[:, ctrl.eps_idx].double() * math.pi
        phis = torch.tensor([0.0, 2.0 * math.pi / 3.0, 4.0 * math.pi / 3.0], dtype=torch.float64)
        gain = torch.sin(eps[:, None] - phis) * torch.sign(ints["torque_star"].double())[:, None]
        gmax = gain.max(dim=1, keepdim=True).values
        dists += [torch.abs(gain - ctrl.theta_on), torch.abs(gain - gmax) + (gain == gmax) * 1.0]
    return torch.stack([d.amin(dim=1) for d in dists]).amin(dim=0).numpy()


@pytest.mark.parametrize("env_id", gt.SRM_ENV_IDS)
def test_control_law_matches_jax(env_id):
    jctrl = JaxController.make(gemx.make_functional(env_id), env_id)
    tctrl = GemController.make(gt.make_functional(env_id, device="cpu"), env_id)
    assert isinstance(tctrl, SRMCommutationController)
    N, T = 256, 50
    tenv = gt.make_functional(env_id, device="cpu")
    n_state, n_ref = len(tenv.state_names), len(tenv.reference_names)
    rng = np.random.default_rng(4)
    law = jax.jit(jax.vmap(jctrl.control))
    jcs = jnp.zeros((N,), jnp.float32)
    tcs = tctrl.reset(N, "cpu")
    finite = env_id.startswith("Finite")
    for _ in range(T):
        obs = rng.uniform(-1.0, 1.0, (N, n_state)).astype(np.float32)
        obs[:, list(tctrl.current_idx)] = np.abs(obs[:, list(tctrl.current_idx)])
        ref = rng.uniform(-1.0, 1.0, (N, n_ref)).astype(np.float32)
        if n_ref == 3:
            ref = np.abs(ref)
        ob, rf = torch.as_tensor(obs), torch.as_tensor(ref)
        margin = _edge_margin(tctrl, ob, rf, tcs)
        jcs, ja = law(jcs, jnp.asarray(obs), jnp.asarray(ref))
        tcs, ta = tctrl.control(tcs, ob, rf)
        ja, ta = np.asarray(ja), ta.numpy()
        assert ja.shape == ta.shape == (N, 3)
        differ = ~np.isclose(ta, ja, rtol=1e-5, atol=1e-6).all(axis=1)
        assert np.all(margin[differ] < 1e-5), f"{int(differ.sum())} envs differ off an edge"
        if finite:
            assert ta.dtype == np.int32
        np.testing.assert_allclose(tcs.numpy(), np.asarray(jcs), rtol=1e-5, atol=1e-6)


def test_reset_and_state_from_numpy():
    env_id = "Finite-TC-SRM-v0"
    tctrl = GemController.make(gt.make_functional(env_id, device="cpu"), env_id)
    assert tctrl.reset(5, "cpu").shape == (5,)
    cs = SRMCommutationController.state_from_numpy(np.arange(4.0), "cpu")
    assert cs.dtype == torch.float32 and cs.tolist() == [0.0, 1.0, 2.0, 3.0]
    jctrl = JaxController.make(gemx.make_functional(env_id), env_id)
    carried = SRMCommutationController.from_numpy(vars(jctrl))
    for name, value in vars(tctrl).items():
        np.testing.assert_array_equal(np.asarray(getattr(carried, name)), np.asarray(value))


@pytest.mark.parametrize("env_id,ref", [
    ("Finite-SC-SRM-v0", ("omega", 0.4)),
    ("Cont-TC-SRM-v0", ("torque", 0.3)),
])
def test_control_environment_matches_jax(env_id, ref):
    jenv = gemx.make_functional(env_id, reference_generator=jrg.ConstReference(*ref))
    tenv = gt.make_functional(env_id, device="cpu", reference_generator=trg.ConstReference(*ref))
    T, N = 200, 4
    want = JaxController.make(jenv, env_id).control_environment(jenv, T, n_envs=N)
    got = GemController.make(tenv, env_id).control_environment(tenv, T, n_envs=N,
                                                              collect_internals=True)
    np.testing.assert_allclose(got["states"].numpy(), np.asarray(want["states"]), **ENV_TOL)
    np.testing.assert_allclose(got["rewards"].numpy(), np.asarray(want["rewards"]), **ENV_TOL)
    np.testing.assert_array_equal(got["terminations"].numpy(), np.asarray(want["terminations"]))
    ints = got["cascade_references"]
    assert set(ints) == {"torque_star", "i_star"}
    assert ints["i_star"].shape == (N, T, 3)
