"""The plain PyTorch versions of the three controller-in-the-loop kernels
(``make_fused_foc_rollout``, ``make_fused_dc_cascade_rollout``,
``make_fused_srm_cascade_rollout``) against the JAX package's Pallas
kernels, run in interpret mode on the CPU as tests/test_pallas_rollout.py
(:382-424, :780-831) and tests/test_srm.py (:205-362) run them, and against
the port's own ``control_environment``.

* Const mode (the FOC with ``ref_mode="const"``, the cascades with
  ``ConstReference``): every output at rtol 1e-5 / atol 1e-4.
* Wiener mode: the plain version replays the JAX interpret-mode xorshift
  bits in the JAX draw order (no action words: the controller acts), at
  T 64, N 256: at least 99% of envs agree in every output and the mean
  reward within 1e-4 relative.
* The kernels' oracle on the port, const mode, with the JAX suite's
  tolerances: the FOC's currents at rtol 1e-5 / atol 1e-3 and its mean
  reward at rtol 1e-4 (tests/test_pallas_rollout.py:405-415), the DC
  cascade's omega at rtol 1e-5 / atol 1e-2 (:811-812), the SRM cascade's
  mean reward at atol 2e-5 (tests/test_srm.py:228-233); no termination.
  Through the plain FOC the steady state: Cont-CC-PMSM-v0 reaches -0.1 and
  0.3 times 400 A within 0.05 A (tests/test_pallas_rollout.py:408-409).

The CUDA kernels run on a GPU only: tests/test_torch_cuda_kernels.py and
``chip_smoke.py`` hold them against these plain versions there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_electric_motor_tpu as gemx
from gym_electric_motor_tpu import references as jrg
from gym_electric_motor_tpu.controllers import GemController as JaxController
from gym_electric_motor_tpu.ops.pallas_rollout import (
    make_fused_dc_cascade_rollout as jax_dc_cascade,
    make_fused_foc_rollout as jax_foc,
    make_fused_srm_cascade_rollout as jax_srm_cascade,
)
import gym_electric_motor_tpu_torch as gt
from gym_electric_motor_tpu_torch import references as trg
from gym_electric_motor_tpu_torch.controllers import GemController
from gym_electric_motor_tpu_torch.ops import fused_dc_family as dcf
from gym_electric_motor_tpu_torch.ops import fused_srm_family as srf
from gym_electric_motor_tpu_torch.ops import fused_sync as fs
from gym_electric_motor_tpu_torch.ops.fused_rollout import (
    make_fused_dc_cascade_rollout,
    make_fused_foc_rollout,
    make_fused_srm_cascade_rollout,
)
from test_torch_eesm_universal import XorshiftEesmBits
from test_torch_fused_sync import _XorshiftBits
from test_torch_sync_universal import XorshiftSyncBits

torch.set_num_threads(1)

CONST = dict(rtol=1e-5, atol=1e-4)
SRM_SAT = dict(motor=dict(motor_parameter={"psi_s": 1.2}))
SRM_REFS = {"CC": [("i_a", 0.3), ("i_b", 0.15), ("i_c", 0.0)], "TC": [("torque", 0.3)],
            "SC": [("omega", 0.4)]}


def _envs(env_id, refs=None, **kw):
    """The JAX and the port env (constant references ``refs``, or the
    catalog's) and their tuned controllers."""
    jkw, tkw = dict(kw), dict(kw)
    if refs:
        jkw["reference_generator"] = jrg.ReferenceSpec([jrg.ConstReference(n, v) for n, v in refs])
        tkw["reference_generator"] = trg.ReferenceSpec([trg.ConstReference(n, v) for n, v in refs])
    jenv = gemx.make_functional(env_id, **jkw)
    tenv = gt.make_functional(env_id, device="cpu", **tkw)
    return jenv, tenv, JaxController.make(jenv, env_id), GemController.make(tenv, env_id)


def _assert_outputs(got, want):
    assert len(got) == len(want)
    for j, (g, w) in enumerate(zip(got, want)):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape, j
        np.testing.assert_allclose(g, w, err_msg=f"output {j}", **CONST)


def _env_share(got, want, N):
    """Share of envs (the trailing N elements) whose every output agrees at
    rtol 1e-4 / atol 1e-4."""
    ok = np.ones(N, bool)
    for g, w in zip(got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape
        ok &= np.isclose(g, w, rtol=1e-4, atol=1e-4).reshape(-1, N).all(axis=0)
    return ok.mean()


def _assert_replay(got, want, r_idx, N):
    assert _env_share(got, want, N) >= 0.99
    mean_g, mean_w = float(got[r_idx].double().mean()), float(np.asarray(want[r_idx]).mean())
    assert abs(mean_g - mean_w) <= 1e-4 * abs(mean_w)


def _planes(rng, bounds, R):
    return [rng.uniform(lo, hi, (R, 128)).astype(np.float32) for lo, hi in bounds]


# ---------------------------------------------------------------------------
# FOC
# ---------------------------------------------------------------------------


class XorshiftFocBits(_XorshiftBits):
    """The interpret-mode bit source in the FOC kernel's draw order
    (pallas_sync.py:1253-1315): the PMSM kernel's, without its action word."""

    def step_words(self, t):
        n = self.n
        u1, u2 = self._next()[:n], self._next()[:n]
        ln, sg, r = self._next(), self._next(), self._next()
        return None, u1, u2, ln[:n], ln[n:], sg[:n], sg[n:], r[:n], r[n:]


def test_foc_const_mode_matches_jax_interpret():
    jenv, tenv, jctrl, tctrl = _envs("Cont-CC-PMSM-v0", [("i_sd", -0.1), ("i_sq", 0.3)])
    N, T = 128, 100
    rng = np.random.default_rng(11)
    start = _planes(rng, [(-50, 50), (-50, 50), (0, 2 * np.pi)], 1)
    refs = _planes(rng, [(-0.3, 0.3), (-0.3, 0.3)], 1)
    want = jax_foc(jenv, jctrl, T, N, ref_mode="const", interpret=True)(
        0, *map(jnp.asarray, start + refs))
    got = make_fused_foc_rollout(tenv, tctrl, T, N, ref_mode="const")(
        0, *map(torch.as_tensor, start + refs))
    _assert_outputs(got, want)


def test_foc_wiener_mode_replays_jax_interpret():
    jenv, tenv, jctrl, tctrl = _envs("Cont-CC-PMSM-v0")
    N, T, seed = 256, 64, 3
    want = jax_foc(jenv, jctrl, T, N, interpret=True)(seed, *[jnp.zeros((2, 128))] * 3)
    z = torch.zeros((2, 128))
    got = fs.foc_rollout_plain(fs.FocConsts(tenv, tctrl), seed, z, z, z, z, z, T,
                               bits=XorshiftFocBits(seed, N))
    _assert_replay(got, want, 3, N)


def test_foc_follows_control_environment_and_converges():
    _jenv, tenv, _jctrl, tctrl = _envs("Cont-CC-PMSM-v0", [("i_sd", -0.1), ("i_sq", 0.3)])
    T, N = 400, 128
    z = torch.zeros((1, 128))
    isd, isq, _eps, rew, terms, *_ = make_fused_foc_rollout(tenv, tctrl, T, N, ref_mode="const")(
        0, z, z, z, torch.full((1, 128), -0.1), torch.full((1, 128), 0.3))
    out = tctrl.control_environment(tenv, T)
    names, lim = tenv.state_names, tenv.physical_system.limits
    isd_x = float(out["states"][-1, names.index("i_sd")]) * lim[names.index("i_sd")]
    isq_x = float(out["states"][-1, names.index("i_sq")]) * lim[names.index("i_sq")]
    np.testing.assert_allclose(float(isd[0, 0]), isd_x, rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(float(isq[0, 0]), isq_x, rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(float(isd[0, 0]), -0.1 * 400.0, atol=0.05)
    np.testing.assert_allclose(float(isq[0, 0]), 0.3 * 400.0, atol=0.05)
    np.testing.assert_allclose(float(rew.sum()) / (N * T), float(out["rewards"].mean()),
                               rtol=1e-4, atol=1e-6)
    assert float(terms.sum()) == 0.0


# ---------------------------------------------------------------------------
# DC speed cascade
# ---------------------------------------------------------------------------

DC_IDS = ["Cont-SC-PermExDc-v0", "Cont-SC-SeriesDc-v0", "Cont-SC-ShuntDc-v0"]


def _dc_start(c, R, seed):
    rng = np.random.default_rng(seed)
    return _planes(rng, [(0, 100)] + [(-5, 5)] * (c.n_state - 1), R)


@pytest.mark.parametrize("env_id", DC_IDS)
def test_dc_cascade_const_mode_matches_jax_interpret(env_id):
    jenv, tenv, jctrl, tctrl = _envs(env_id, [("omega", 0.5)])
    N, T = 128, 100
    cc = dcf.DcCascadeConsts(tenv, tctrl)
    start = _dc_start(cc.c, 1, 12)
    want = jax_dc_cascade(jenv, jctrl, T, N, interpret=True)(0, *map(jnp.asarray, start))
    got = make_fused_dc_cascade_rollout(tenv, tctrl, T, N)(0, *map(torch.as_tensor, start))
    _assert_outputs(got, want)


@pytest.mark.parametrize("env_id", DC_IDS)
def test_dc_cascade_wiener_mode_replays_jax_interpret(env_id):
    jenv, tenv, jctrl, tctrl = _envs(env_id)
    N, T, seed = 256, 64, 3
    cc = dcf.DcCascadeConsts(tenv, tctrl)
    start = _dc_start(cc.c, 2, 13)
    want = jax_dc_cascade(jenv, jctrl, T, N, interpret=True)(seed, *map(jnp.asarray, start))
    got = dcf.dc_cascade_rollout_plain(cc, seed, tuple(map(torch.as_tensor, start)), T,
                                       bits=XorshiftSyncBits(seed, N, 1, 0))
    _assert_replay(got, want, cc.c.n_state, N)


@pytest.mark.parametrize("env_id", DC_IDS)
def test_dc_cascade_follows_control_environment(env_id):
    _jenv, tenv, _jctrl, tctrl = _envs(env_id, [("omega", 0.5)])
    T, N = 800, 128
    n_state = dcf.DcCascadeConsts(tenv, tctrl).c.n_state
    out = make_fused_dc_cascade_rollout(tenv, tctrl, T, N)(0, *[torch.zeros((1, 128))] * n_state)
    assert float(out[n_state + 1].sum()) == 0.0
    res = tctrl.control_environment(tenv, T)
    names = tenv.state_names
    w_lim = float(np.asarray(tenv.physical_system.limits)[names.index("omega")])
    omega_x = float(res["states"][-1, names.index("omega")]) * w_lim
    np.testing.assert_allclose(float(out[0][0, 0]), omega_x, rtol=1e-5, atol=1e-2)
    np.testing.assert_allclose(float(out[n_state].sum()) / (N * T), float(res["rewards"].mean()),
                               rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# SRM commutation cascade
# ---------------------------------------------------------------------------

SRM_CASES = [("Finite-SC-SRM-v0", {}), ("Cont-TC-SRM-v0", {}), ("Cont-SC-SRM-v0", {}),
             ("Finite-CC-SRM-v0", {}), ("Finite-TC-SRM-v0", SRM_SAT)]
SRM_IDS = [f"{i}{'-sat' if kw else ''}" for i, kw in SRM_CASES]


def _srm_start(c, R, seed):
    """Speed (SC) in [0, 100) rad/s, the phase currents in [0, 22) A (the
    limit is 20 A, so some envs reset at once), the angle in [-pi, pi)."""
    rng = np.random.default_rng(seed)
    return _planes(rng, ([(0, 100)] if c.mech else []) + [(0, 22)] * 3 + [(-np.pi, np.pi)], R)


@pytest.mark.parametrize("env_id,kw", SRM_CASES, ids=SRM_IDS)
def test_srm_cascade_const_mode_matches_jax_interpret(env_id, kw):
    jenv, tenv, jctrl, tctrl = _envs(env_id, SRM_REFS[env_id.split("-")[1]], **kw)
    N, T = 128, 100
    cc = srf.SrmCascadeConsts(tenv, tctrl)
    start = _srm_start(cc.c, 1, 14)
    want = jax_srm_cascade(jenv, jctrl, T, N, interpret=True)(0, *map(jnp.asarray, start))
    got = make_fused_srm_cascade_rollout(tenv, tctrl, T, N)(0, *map(torch.as_tensor, start))
    _assert_outputs(got, want)


@pytest.mark.parametrize("env_id,kw", SRM_CASES, ids=SRM_IDS)
def test_srm_cascade_wiener_mode_replays_jax_interpret(env_id, kw):
    jenv, tenv, jctrl, tctrl = _envs(env_id, **kw)
    N, T, seed = 256, 64, 3
    cc = srf.SrmCascadeConsts(tenv, tctrl)
    start = _srm_start(cc.c, 2, 15)
    want = jax_srm_cascade(jenv, jctrl, T, N, interpret=True)(seed, *map(jnp.asarray, start))
    got = srf.srm_cascade_rollout_plain(cc, seed, tuple(map(torch.as_tensor, start)), T,
                                        bits=XorshiftEesmBits(seed, N, cc.c.n_ref, 0))
    assert float(np.asarray(want[cc.c.n_state + 1]).sum()) > 0  # the replay crosses resets
    _assert_replay(got, want, cc.c.n_state, N)


@pytest.mark.parametrize("env_id", ["Finite-SC-SRM-v0", "Cont-TC-SRM-v0"])
def test_srm_cascade_follows_control_environment(env_id):
    _jenv, tenv, _jctrl, tctrl = _envs(env_id, SRM_REFS[env_id.split("-")[1]])
    T, N = 800, 128
    n_state = srf.SrmCascadeConsts(tenv, tctrl).c.n_state
    out = make_fused_srm_cascade_rollout(tenv, tctrl, T, N)(5, *[torch.zeros((1, 128))] * n_state)
    assert float(out[n_state + 1].sum()) == 0.0
    oc = tctrl.control_environment(tenv, T)
    np.testing.assert_allclose(float(out[n_state].mean()) / T, float(oc["rewards"].mean()),
                               atol=2e-5)


# ---------------------------------------------------------------------------
# the builders' checks
# ---------------------------------------------------------------------------


def test_builders_reject_what_the_kernels_do_not_simulate():
    _j, tenv, _jc, tctrl = _envs("Cont-SC-ExtExDc-v0")
    with pytest.raises(AssertionError, match="ExtExDc's dual-channel"):
        make_fused_dc_cascade_rollout(tenv, tctrl, 10, 128)
    _j, tenv, _jc, tctrl = _envs("Cont-TC-PermExDc-v0")
    with pytest.raises(AssertionError):
        make_fused_dc_cascade_rollout(tenv, tctrl, 10, 128)
    tenv = gt.make_functional("Cont-SC-PermExDc-v0", device="cpu", constraints=())
    with pytest.raises(NotImplementedError, match="catalog-default constraints"):
        make_fused_dc_cascade_rollout(tenv, GemController.make(tenv), 10, 128)
    _j, tenv, _jc, tctrl = _envs("Finite-CC-PMSM-v0")
    with pytest.raises(AssertionError):
        make_fused_foc_rollout(tenv, tctrl, 10, 128)
    _j, tenv, _jc, tctrl = _envs("Cont-CC-PMSM-v0")
    with pytest.raises(AssertionError, match="SRMCommutationController"):
        make_fused_srm_cascade_rollout(tenv, tctrl, 10, 128)
    with pytest.raises(ValueError, match="ref_mode"):
        make_fused_foc_rollout(tenv, tctrl, 10, 128, ref_mode="sine")
    with pytest.raises(ValueError, match="multiple of 128"):
        make_fused_foc_rollout(tenv, tctrl, 10, 100)


def test_wrappers_take_the_plain_path_on_cpu_and_count_no_launch():
    for mod in (fs, dcf, srf):
        mod.reset_launches()
    _j, tenv, _jc, tctrl = _envs("Finite-TC-SRM-v0")
    out = make_fused_srm_cascade_rollout(tenv, tctrl, 5, 128)(1, *[torch.zeros((1, 128))] * 4)
    assert len(out) == 4 + 7 and out[-1].shape == (1, 128)
    assert not any(any(m.LAUNCHES.values()) for m in (fs, dcf, srf))
