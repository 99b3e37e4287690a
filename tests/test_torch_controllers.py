"""The port's classical controllers (``gym_electric_motor_tpu_torch.
controllers``) against the JAX package's.

* Tuning: ``GemController.make`` on each of the 34 ids the port serves (the
  24 DC ids, the four synchronous CC ids, the six SRM ids) gives every
  numeric field of the JAX controller, rtol 1e-12 (both sides tune in numpy
  float64); the other 26 ids raise the JAX package's ``ValueError`` (SCIM,
  DFIM: the flux observer) or a ``NotImplementedError`` naming the module
  still to port.
* The control law: ``control`` on 256 envs for 50 steps, each side carrying
  its own controller state, from numpy-seeded normalised states and
  references, against ``jax.jit(jax.vmap(ctrl.control))`` on one id per
  output stage (cont, disc, b6, multidiscrete), on Cont-CC-PMSM (the
  squared clip and the abc transform) and with the P and three-point base
  current controllers: continuous actions within atol 1e-6
  plus rtol 1e-5 of the env's largest channel (the phases of one rotated
  vector share its rounding), discrete ones equal except where the voltage
  lies within 1e-5 of a switching level; the controller states alike (a
  B6 stage's accumulators at rtol 1e-5 of the voltages they add up).
* ``control_environment`` with constant references (T 200, N 4) against the
  JAX one (one case with the PID base current controller): states and
  rewards rtol 1e-4 / atol 2e-3, terminations equal.
* Closed-loop convergence of two of the JAX suite's cases
  (tests/test_controllers.py:79, :89), at their step counts and tolerances.

The SRM controller's law and loop are in tests/test_torch_srm_controller.py,
the three controller-in-the-loop kernels in
tests/test_torch_control_kernels.py.
"""

import dataclasses

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

SERVED = (gt.DC_ENV_IDS + [f"{a}-CC-{m}-v0" for m in ("PMSM", "SynRM") for a in ("Finite", "Cont")]
          + gt.SRM_ENV_IDS)
UNSERVED = [i for i in gt.ENV_IDS if i not in SERVED]
ENV_TOL = dict(rtol=1e-4, atol=2e-3)


def _assert_fields_equal(got, want, path):
    """Every numeric entry of two controller fields equal at rtol 1e-12;
    strings, flags and None equal exactly."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for key in want:
            _assert_fields_equal(got[key], want[key], f"{path}.{key}")
    elif isinstance(want, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(got) == len(want), path
        for j, (g, w) in enumerate(zip(got, want)):
            _assert_fields_equal(g, w, f"{path}[{j}]")
    elif want is None or isinstance(want, (str, bool)):
        assert got == want, path
    else:
        np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                                   np.asarray(want, dtype=np.float64), rtol=1e-12, atol=0,
                                   err_msg=path)
        assert np.shape(got) == np.shape(want), path


@pytest.mark.parametrize("env_id", SERVED)
def test_tuning_matches_jax(env_id):
    jctrl = JaxController.make(gemx.make_functional(env_id), env_id)
    tctrl = GemController.make(gt.make_functional(env_id, device="cpu"), env_id)
    assert type(tctrl).__name__ == type(jctrl).__name__
    want = vars(jctrl)
    got = vars(tctrl)
    for name, value in want.items():
        _assert_fields_equal(got[name], value, name)


@pytest.mark.parametrize("env_id", UNSERVED)
def test_unported_ids_raise(env_id):
    tenv = gt.make_functional(env_id, device="cpu")
    motor, task = env_id.split("-")[2], env_id.split("-")[1]
    if motor in ("SCIM", "DFIM"):
        # the JAX package's own error (tests/test_controllers.py:58)
        with pytest.raises(ValueError, match="FluxObserver"):
            JaxController.make(gemx.make_functional(env_id), env_id)
        with pytest.raises(ValueError, match="FluxObserver"):
            GemController.make(tenv, env_id)
    else:
        module = "induction_eesm_ops.py" if motor == "EESM" else "pmsm_ops.py"
        assert motor == "EESM" or task in ("TC", "SC")
        with pytest.raises(NotImplementedError, match=module):
            GemController.make(tenv, env_id)


def test_env_id_is_detected_from_the_env():
    for env_id in ("Cont-SC-PermExDc-v0", "Finite-CC-PMSM-v0", "Finite-TC-ExtExDc-v0",
                   "Cont-TC-SRM-v0"):
        ctrl = GemController.make(gt.make_functional(env_id, device="cpu"))
        assert ctrl.env_id == env_id
    assert isinstance(GemController.make(gt.make_functional("Finite-SC-SRM-v0", device="cpu")),
                      SRMCommutationController)


def test_from_numpy_carries_the_jax_tuning():
    env_id = "Finite-TC-ExtExDc-v0"
    jctrl = JaxController.make(gemx.make_functional(env_id), env_id)
    tctrl = GemController.from_numpy(vars(jctrl))
    for name, value in vars(jctrl).items():
        _assert_fields_equal(getattr(tctrl, name), value, name)
    cs = GemController.state_from_numpy({"cc_integrator": np.ones((3, 2))}, "cpu")
    assert cs["cc_integrator"].dtype == torch.float32 and cs["cc_integrator"].shape == (3, 2)


@pytest.mark.parametrize("env_id", ["Finite-TC-ExtExDc-v0", "Cont-SC-SRM-v0"])
def test_reset_runs_on_the_named_device_and_defaults_to_cuda(env_id):
    """``reset`` resolves its device as every entry point does: the named
    one, else ``cuda``, and without a GPU it raises instead of falling back
    to the CPU."""
    ctrl = GemController.make(gt.make_functional(env_id, device="cpu"), env_id)
    cs = ctrl.reset(4, device="cpu")
    for plane in (cs.values() if isinstance(cs, dict) else [cs]):
        assert plane.device.type == "cpu" and plane.shape[0] == 4
    if torch.cuda.is_available():
        default = ctrl.reset(4)
        for plane in (default.values() if isinstance(default, dict) else [default]):
            assert plane.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ctrl.reset(4)


def _switch_margin(tctrl, cs, state, ref):
    """Per env, the least distance (relative to the level) of the output
    stage's voltage (plus the sigma-delta accumulator of a B6 stage) to a
    switching level of a finite output, from a continuous copy of the
    controller on the same inputs; and the largest voltage magnitude, which
    a B6 stage's accumulators add up."""
    cont = dataclasses.replace(tctrl, output_kind="cont", action_pad=0)
    _cs, a = cont.control(dict(cs), state, ref)
    u = a / cont._consts(a.device)["inv_out"]
    k = tctrl._consts(a.device)
    if tctrl.output_kind == "b6":
        u = u[:, :3] + cs["b6_acc"]
        levels = [k["disc_mid"][:3]]
    else:
        levels = [k["disc_lo"], k["disc_hi"]]
    margins = [(torch.abs(u - lv) / torch.clamp(torch.abs(lv), min=1.0)) for lv in levels]
    return torch.stack(margins).amin(dim=(0, 2)), torch.abs(u).amax(dim=1).numpy()


def _assert_close_per_env(got, want, what="", scale=0.0):
    """Within atol 1e-6 plus rtol 1e-5 of the env's largest entry (or of
    ``scale``, per env, where that is larger): the three phase voltages come
    from one rotated dq vector (and a B6 stage's accumulators add them up),
    so where a phase cancels to near zero its rounding error (XLA contracts
    ``c x - s y`` into an FMA and rounds its own cos and sin) scales with
    the vector, not with the phase."""
    got, want = got.reshape(len(want), -1), want.reshape(len(want), -1)
    scale = np.maximum(np.abs(want).max(axis=1), scale)[:, None]
    bad = np.abs(got - want) > 1e-6 + 1e-5 * scale
    assert not bad.any(), f"{what}: {int(bad.sum())} entries off, e.g. {got[bad][:3]} vs {want[bad][:3]}"


LAW_CASES = [("Cont-SC-PermExDc-v0", "PI"), ("Cont-CC-PMSM-v0", "PI"),
             ("Finite-SC-ShuntDc-v0", "PI"), ("Finite-CC-PMSM-v0", "PI"),
             ("Finite-TC-ExtExDc-v0", "PI"), ("Cont-CC-SeriesDc-v0", "P"),
             ("Cont-TC-PermExDc-v0", "ThreePoint")]


@pytest.mark.parametrize("env_id,base", LAW_CASES, ids=[f"{i}-{b}" for i, b in LAW_CASES])
def test_control_law_matches_jax(env_id, base):
    """50 cycles on 256 envs, each side carrying its own controller state:
    one id for each output stage (cont, disc, b6, multidiscrete), the
    synchronous current controller's squared clip and abc transform, and
    the P and three-point base current controllers (the PID's derivative of
    a random sequence cancels terms far larger than the action, so it is
    held in the closed loop below)."""
    jctrl = JaxController.make(gemx.make_functional(env_id), env_id,
                               base_current_controller=base)
    tctrl = GemController.make(gt.make_functional(env_id, device="cpu"), env_id,
                               base_current_controller=base)
    N, T = 256, 50
    n_state, n_ref = len(jctrl.limits), len(jctrl.ref_limits)
    rng = np.random.default_rng(3)
    law = jax.jit(jax.vmap(jctrl.control))
    jcs = jax.vmap(lambda _: jctrl.reset())(jnp.arange(N))
    tcs = tctrl.reset(N, "cpu")
    assert set(tcs) == set(jcs)
    finite = tctrl.output_kind != "cont"
    for _ in range(T):
        state = rng.uniform(-1.0, 1.0, (N, n_state)).astype(np.float32)
        ref = rng.uniform(-1.0, 1.0, (N, n_ref)).astype(np.float32)
        st, rf = torch.as_tensor(state), torch.as_tensor(ref)
        margin, u_scale = _switch_margin(tctrl, tcs, st, rf) if finite else (None, 0.0)
        jcs, ja = law(jcs, jnp.asarray(state), jnp.asarray(ref))
        tcs, ta = tctrl.control(tcs, st, rf)
        ja, ta = np.asarray(ja), ta.numpy()
        assert ja.shape == ta.shape
        if finite:
            assert ta.dtype == np.int32
            differ = (ja != ta).reshape(N, -1).any(axis=1)
            assert np.all(margin.numpy()[differ] < 1e-5)
        else:
            _assert_close_per_env(ta, ja)
        for key in jcs:
            # a B6 stage's accumulators integrate the phase voltages
            scale = u_scale if key == "b6_acc" else 0.0
            _assert_close_per_env(tcs[key].numpy(), np.asarray(jcs[key]), key, scale)


def _const_envs(env_id, refs):
    jenv = gemx.make_functional(env_id, reference_generator=jrg.ReferenceSpec(
        [jrg.ConstReference(n, v) for n, v in refs]))
    tenv = gt.make_functional(env_id, device="cpu", reference_generator=trg.ReferenceSpec(
        [trg.ConstReference(n, v) for n, v in refs]))
    return jenv, tenv


@pytest.mark.parametrize("env_id,refs,base", [
    ("Cont-CC-PermExDc-v0", [("i", 0.3)], "PI"),
    ("Cont-SC-ShuntDc-v0", [("omega", 0.5)], "PI"),
    ("Finite-CC-PMSM-v0", [("i_sd", -0.1), ("i_sq", 0.2)], "PI"),
    ("Cont-CC-PMSM-v0", [("i_sd", -0.1), ("i_sq", 0.3)], "PI"),
    ("Cont-CC-SeriesDc-v0", [("i", 0.3)], "PID"),
])
def test_control_environment_matches_jax(env_id, refs, base):
    jenv, tenv = _const_envs(env_id, refs)
    T, N = 200, 4
    want = JaxController.make(jenv, env_id, base_current_controller=base).control_environment(
        jenv, T, n_envs=N)
    got = GemController.make(tenv, env_id, base_current_controller=base).control_environment(
        tenv, T, n_envs=N)
    assert got["states"].shape == np.asarray(want["states"]).shape == (N, T, len(tenv.state_names))
    np.testing.assert_allclose(got["states"].numpy(), np.asarray(want["states"]), **ENV_TOL)
    np.testing.assert_allclose(got["references"].numpy(), np.asarray(want["references"]),
                               **ENV_TOL)
    np.testing.assert_allclose(got["rewards"].numpy(), np.asarray(want["rewards"]), **ENV_TOL)
    np.testing.assert_array_equal(got["terminations"].numpy(), np.asarray(want["terminations"]))


def test_collect_internals_gives_the_cascade_setpoints():
    env_id = "Cont-SC-PermExDc-v0"
    _jenv, tenv = _const_envs(env_id, [("omega", 0.5)])
    out = GemController.make(tenv, env_id).control_environment(tenv, 20, collect_internals=True)
    ints = out["cascade_references"]
    assert set(ints) == {"torque", "currents"}
    assert ints["torque"].shape == (20,) and ints["currents"].shape == (20, 1)
    assert out["states"].shape == (20, len(tenv.state_names))


def test_cont_speed_control_converges():
    """tests/test_controllers.py:79: Cont-SC-PermExDc-v0, omega to 0.5
    within 0.02 in 8000 steps, no termination."""
    env_id = "Cont-SC-PermExDc-v0"
    env = gt.make_functional(env_id, device="cpu", reference_generator=trg.ConstReference(
        "omega", reference_value=0.5))
    out = GemController.make(env, env_id).control_environment(env, 8000)
    idx = env.state_names.index("omega")
    final = float(out["states"][-100:, idx].mean())
    assert not bool(out["terminations"].any())
    assert abs(final - 0.5) < 0.02


def test_finite_current_control_converges():
    """tests/test_controllers.py:89: Finite-CC-PMSM-v0, i_sq to 0.2 within
    0.05 in 2000 steps (the sigma-delta B6 output stage)."""
    env_id = "Finite-CC-PMSM-v0"
    env = gt.make_functional(env_id, device="cpu", reference_generator=trg.ReferenceSpec(
        [trg.ConstReference("i_sd", reference_value=0.0),
         trg.ConstReference("i_sq", reference_value=0.2)]))
    out = GemController.make(env, env_id).control_environment(env, 2000)
    idx = env.state_names.index("i_sq")
    final = float(out["states"][-200:, idx].mean())
    assert abs(final - 0.2) < 0.05
