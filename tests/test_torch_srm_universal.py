"""The port's universal SRM-family rollout (``make_fused_srm_rollout`` and
the dispatch ``make_fused_rollout``, plain PyTorch versions on the CPU)
against the JAX package.

* Buffer mode: the same numpy action buffer from seeded start states with
  constant references through both packages' ``make_fused_srm_rollout`` (the
  JAX kernel in interpret mode, as tests/test_srm.py runs it) on all six
  ids, and with ``psi_s = 1.2`` on Finite-TC-SRM-v0 and Cont-SC-SRM-v0
  (tests/test_srm.py:145-178, :265-305): rtol 1e-4 / atol 2e-3 (A, rad/s),
  the angle modulo 2 pi at atol 1e-4.
* Random mode, replay: the plain random rollout driven by the test-only
  copy of the interpret bit source in the SRM kernel's draw order (three
  action planes, nothing for the polynomial load's reset, then the
  reference draws: two Box-Muller pairs with the three CC references)
  against the JAX interpret kernel, in at least 99% of envs, on
  Finite-CC-SRM-v0 (three rows, the carried rotation), Cont-TC-SRM-v0 (the
  torque reward at the wrapped angle, asserted on the reward output) and
  Finite-SC-SRM-v0 (the speed ODE's per-stage angles).
* Random mode, statistics: the Philox plain version against the XLA env
  (the bounds of ``test_fused_eesm_family_stats``), each CC row a Wiener
  process inside its margins (0, 1).
* The dispatch of all six ids, their state arity (4, or 5 with the speed),
  the Philox words of the three actions, the wrappers' CPU path, the
  constants' rounding, and the options that raise, each naming its queue
  item.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_electric_motor_tpu as gemx
from gym_electric_motor_tpu.ops.pallas_rollout import fused_state_arity as jax_arity
from gym_electric_motor_tpu.ops.pallas_srm import make_fused_srm_rollout as jax_srm_rollout
import gym_electric_motor_tpu_torch as gt
from gym_electric_motor_tpu_torch.ops import fused_common as fc
from gym_electric_motor_tpu_torch.ops import fused_rollout as fr
from gym_electric_motor_tpu_torch.ops import fused_srm_family as srf
from test_pallas_rollout import N_STAT, T_STAT, _check_wiener_state, _xla_random_rollout
from test_torch_eesm_universal import XorshiftEesmBits
from test_torch_srm import SAT, const_envs
from test_torch_sync_universal import env_share

torch.set_num_threads(1)

BUF = dict(rtol=1e-4, atol=2e-3)
BUFFER_CASES = [(e, {}) for e in gt.SRM_ENV_IDS] + [
    ("Finite-TC-SRM-v0", SAT), ("Cont-SC-SRM-v0", SAT)]


def action_buffer(finite, T, R, seed):
    """int32 (T, 3, R, 128) per-phase commands or float32 (T, 3, R, 128)
    duties."""
    rng = np.random.default_rng(seed)
    if finite:
        return rng.integers(0, 3, (T, 3, R, 128)).astype(np.int32)
    return rng.uniform(-1.0, 1.0, (T, 3, R, 128)).astype(np.float32)


def start_planes(c, R, seed, i_max=15.0):
    """Speed (under a dynamic load) in [0, 100) rad/s, the three phase
    currents in [0, i_max) A, the angle in [-pi, pi)."""
    rng = np.random.default_rng(seed)
    w = [rng.uniform(0, 100, (R, 128))] if c.mech else []
    cur = [rng.uniform(0, i_max, (R, 128)) for _ in range(3)]
    eps = [rng.uniform(-np.pi, np.pi, (R, 128))]
    return [x.astype(np.float32) for x in w + cur + eps]


def assert_angle(got, want, atol=1e-4):
    d = np.remainder(got - want, 2 * np.pi)
    np.testing.assert_allclose(np.minimum(d, 2 * np.pi - d), 0.0, atol=atol)


@pytest.mark.parametrize("env_id,kw", BUFFER_CASES,
                         ids=[e + ("-psi_s" if kw else "") for e, kw in BUFFER_CASES])
def test_buffer_rollout_matches_jax_interpret(env_id, kw):
    jenv, tenv = const_envs(env_id, **kw)
    N, T = 128, 50
    c = srf.SrmConsts(tenv)
    assert c.sat == bool(kw)
    start = start_planes(c, 1, 3)
    acts = action_buffer(c.finite, T, 1, 31)
    want = jax_srm_rollout(jenv, T, N, action_mode="buffer", interpret=True)(
        *map(jnp.asarray, start), jnp.asarray(acts))
    got = fr.make_fused_rollout(tenv, T, N, action_mode="buffer")(
        *map(torch.as_tensor, start), torch.as_tensor(acts))
    assert len(got) == len(want) == c.n_state == (5 if c.mech else 4)
    for j, (g, w) in enumerate(zip(got, want)):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape == (1, 128)
        if j == c.n_state - 1:
            assert_angle(g, w)
            assert np.all(np.abs(g) <= np.float32(np.pi))
        else:
            np.testing.assert_allclose(g, w, **BUF, err_msg=f"{env_id} state {j}")
    i3 = np.stack([g.numpy() for g in got[c.n_state - 4:c.n_state - 1]])
    assert i3.min() >= 0.0 and (i3 == 0.0).any()  # the diodes clamp some phases


@pytest.mark.parametrize("env_id", ["Finite-CC-SRM-v0", "Cont-TC-SRM-v0", "Finite-SC-SRM-v0"])
def test_random_rollout_replays_jax_interpret(env_id):
    jenv = gemx.make_functional(env_id)
    tenv = gt.make_functional(env_id, device="cpu")
    c = srf.SrmConsts(tenv)
    N, T, seed = 256, 64, 3
    start = start_planes(c, 2, 4, i_max=22.0)  # some envs start past 20 A
    want = jax_srm_rollout(jenv, T, N, interpret=True)(seed, *map(jnp.asarray, start))
    got = srf.srm_rollout_random_plain(c, seed, tuple(map(torch.as_tensor, start)), T,
                                       bits=XorshiftEesmBits(seed, N, c.n_ref, c.n_words))
    assert len(got) == len(want) == c.n_state + 6
    assert got[c.n_state + 2].shape == (2 * c.n_ref, 128)
    assert float(np.asarray(want[c.n_state + 1]).sum()) > 0  # the replay crosses resets
    assert env_share([g.numpy() for g in got], want, c.n_state, N) >= 0.99
    if c.needs_torque:  # the reward output itself, not only the states
        r_got, r_want = got[c.n_state].numpy(), np.asarray(want[c.n_state])
        close = np.isclose(r_got, r_want, rtol=1e-4, atol=1e-4).reshape(-1)
        assert close.mean() >= 0.99 and float(np.abs(r_want).max()) > 0.0


@pytest.mark.parametrize("env_id,n_state", [("Finite-SC-SRM-v0", 5), ("Cont-TC-SRM-v0", 4),
                                            ("Cont-CC-SRM-v0", 4)],
                         ids=["Finite-SC-SRM-v0", "Cont-TC-SRM-v0", "Cont-CC-SRM-v0"])
def test_random_rollout_statistics_match_jax_env(env_id, n_state):
    """``test_fused_eesm_family_stats``' bounds for the Philox plain
    version; with three references each row's Wiener state is checked on
    its own rows of the ``(3 R, 128)`` planes."""
    tenv = gt.make_functional(env_id, device="cpu")
    z = torch.zeros((N_STAT // 128, 128))
    out = fr.make_fused_rollout(tenv, T_STAT, N_STAT)(3, *([z] * n_state))
    states, reward, terms = out[:n_state], out[n_state], out[n_state + 1]
    assert all(bool(torch.isfinite(s).all()) for s in states)
    assert all(float(s.min()) >= 0.0 for s in states[n_state - 4:n_state - 1])
    mean_r = float(reward.sum()) / (N_STAT * T_STAT)
    term_rate = float(terms.sum()) / (N_STAT * T_STAT)
    rv, rk, rl, rs = (x.numpy() for x in out[n_state + 2:])
    R = N_STAT // 128
    for j, sub in enumerate(tenv.reference_generator.subs):
        margin = max(abs(sub.margin[0]), abs(sub.margin[1]))
        rows = slice(j * R, (j + 1) * R)
        _check_wiener_state(rv[rows], rk[rows], rl[rows], rs[rows], margin, *sub.sigma_range)
        assert rv[rows].min() >= np.float32(sub.margin[0])
    xla_mean_r, xla_term_rate = _xla_random_rollout(env_id, N_STAT, T_STAT)
    assert abs(mean_r - xla_mean_r) < 0.08
    assert abs(term_rate - xla_term_rate) < max(0.5 * max(term_rate, xla_term_rate), 2e-3)


@pytest.mark.parametrize("env_id", gt.SRM_ENV_IDS)
def test_dispatch_routes_each_srm_id(env_id):
    tenv = gt.make_functional(env_id, device="cpu")
    n_state = fr.fused_state_arity(tenv)
    assert n_state == jax_arity(gemx.make_functional(env_id)) == (5 if "-SC-" in env_id else 4)
    assert fr.family_of(tenv) == "srm"
    roll = fr.make_fused_rollout(tenv, 3, 128)
    assert isinstance(roll.consts, srf.SrmConsts) and roll.consts.n_state == n_state
    assert roll.consts.n_ref == (3 if "-CC-" in env_id else 1)
    assert roll.consts.needs_torque == ("-TC-" in env_id) and not roll.consts.sat
    out = roll(1, *([torch.zeros((1, 128))] * n_state))
    assert len(out) == n_state + 6 and all(bool(torch.isfinite(x).all()) for x in out)


def test_philox_words_of_the_three_actions():
    """The three actions take a continuous B6 bridge's three duty words
    (SLOT_STEP's first and last, SLOT_ACTION_C's first), finite or not; a
    finite phase command is min(int(3 u), 2)."""
    bits = fc.SyncBits(9, 256, "cpu", 3, 3)
    env = torch.arange(256, dtype=torch.int64)

    def call(t, slot):
        return fc.philox4x32(env, torch.tensor(t), torch.tensor(slot), torch.tensor(0),
                             *fc.seed_key(9))
    step, act_c = call(7, fc.SLOT_STEP), call(7, fc.SLOT_ACTION_C)
    acts = bits.step_words(7)[0]
    assert len(acts) == 3
    assert all(torch.equal(g, w) for g, w in zip(acts, [step[0], step[3], act_c[0]]))
    c = srf.SrmConsts(gt.make_functional("Finite-CC-SRM-v0", device="cpu"))
    words = torch.tensor([0, 0x55555500, 0x55555600, 0xAAAAAA00, 0xAAAAAB00, 0xFFFFFF00],
                         dtype=torch.int64)
    a = srf._random_action(c, [words])[0]
    assert a.dtype == torch.int32 and a.tolist() == [0, 0, 1, 1, 2, 2]
    cont = srf.SrmConsts(gt.make_functional("Cont-CC-SRM-v0", device="cpu"))
    d = srf._random_action(cont, [words])[0]
    assert d.dtype == torch.float32 and float(d.min()) == -1.0 and float(d.max()) < 1.0


def test_wrappers_take_plain_path_on_cpu_and_validate():
    tenv = gt.make_functional("Cont-SC-SRM-v0", device="cpu")
    c = srf.SrmConsts(tenv)
    z = torch.zeros((1, 128))
    srf.reset_launches()
    out = srf.srm_rollout_random(c, 1, (z,) * 5, 5)
    ref = srf.srm_rollout_random_plain(c, 1, (z,) * 5, 5)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert all(v == 0 for v in srf.LAUNCHES.values())
    assert c.host.dtype == np.float32
    assert len(c.host) == len(srf.CONST_NAMES) + srf.N_ROWS * len(fc.ROW_NAMES)
    with pytest.raises(ValueError, match="5 state planes"):
        srf.srm_rollout_random(c, 1, (z,) * 4, 5)
    with pytest.raises(TypeError):
        srf.srm_rollout_random(c, 1, (z, z, z, z, z.double()), 5)
    with pytest.raises(ValueError):  # three duty planes, not two
        srf.srm_rollout_buffer(c, (z,) * 5, torch.zeros((5, 2, 1, 128)))
    fin = srf.SrmConsts(gt.make_functional("Finite-CC-SRM-v0", device="cpu"))
    with pytest.raises(TypeError):  # finite takes int32 (T, 3, R, 128)
        srf.srm_rollout_buffer(fin, (z,) * 4, torch.zeros((5, 3, 1, 128)))
    with pytest.raises(ValueError, match="action buffer"):
        fr.make_fused_rollout(tenv, 6, 128, action_mode="buffer")(
            *(z,) * 5, torch.zeros((5, 3, 1, 128)))


def test_constants_follow_the_jax_kernel_rounding():
    """p l1, the stage rotations, 1 / psi_s and psi_s^2 round once from
    double (pallas_srm.py:121-143, :242-246); tau / 6 is the float32
    quotient of float32(tau)."""
    f32 = np.float32
    env = gt.make_functional("Finite-TC-SRM-v0", device="cpu", **SAT)
    c = srf.SrmConsts(env)
    mp = {k: float(v) for k, v in env.physical_system.motor.parameter.items()}
    tau, p, w = 1e-5, mp["p"], 100.0
    assert c.sat and not c.mech and c.n_ref == 1 and c.needs_torque
    assert c.f["pl1"] == float(f32(p * mp["l1"]))
    assert c.f["ch"] == float(f32(np.cos(0.5 * tau * p * w)))
    assert c.f["sin_d"] == float(f32(np.sin(tau * p * w)))
    assert c.f["inv_psi_s"] == float(f32(1.0 / 1.2)) and c.f["psi_s2"] == float(f32(1.2**2))
    assert c.f["sixth"] == float(f32(tau) / f32(6.0))
    assert c.f["pw"] == float(f32(p * w)) and c.f["inv_ilim"] == float(f32(1.0 / 20.0))
    cc = srf.SrmConsts(gt.make_functional("Cont-CC-SRM-v0", device="cpu"))
    assert [r["name"] for r in cc.rows] == ["i_a", "i_b", "i_c"]
    assert all((r["mlo"], r["mhi"]) == (0.0, 1.0) for r in cc.rows)
    assert not cc.sat and cc.f["inv_psi_s"] == 0.0


def _fused(env_id="Cont-CC-SRM-v0", mutate=None, **kw):
    def build():
        env = gt.make_functional(env_id, device="cpu", **kw)
        if mutate:
            mutate(env)
        return fr.make_fused_rollout(env, 8, 128)
    return build


def _wrap(name):
    return lambda e: setattr(e, "physical_system",
                             type(name, (), {"inner": e.physical_system})())


UNFUSED = {
    "randomize": lambda: fr.make_fused_rollout(
        gt.make_functional("Cont-TC-SRM-v0", device="cpu"), 8, 128,
        randomize={"l0": (0.9, 1.1)}),
    "dead_time": _fused(mutate=_wrap("DeadTimeProcessor")),
    "state_noise": _fused(mutate=_wrap("StateNoiseProcessor")),
    "rc_supply": _fused(mutate=lambda e: setattr(
        e.physical_system.supply, "kind", "RCVoltageSupply")),
    "ou_load": _fused("Cont-SC-SRM-v0", mutate=lambda e: setattr(
        e.physical_system.load, "kind", "OrnsteinUhlenbeckLoad")),
}


@pytest.mark.parametrize("option", list(UNFUSED))
def test_unported_options_raise(option):
    with pytest.raises(NotImplementedError, match=r"queue 2, item \d"):
        UNFUSED[option]()
