"""The port's universal synchronous-family rollout (``make_fused_sync_rollout``
and the dispatch ``make_fused_rollout``, plain PyTorch versions on the CPU)
and its twelve env ids against the JAX package.

* Buffer mode: the same numpy action buffer through both packages'
  ``make_fused_sync_rollout`` (the JAX kernel in interpret mode, as
  tests/test_pallas_sync_universal.py runs it) for its 6 ``PHYSICS_CASES``,
  rtol 1e-5 / atol 1e-4 (A, rad/s, rad; float32 RK4 in the same order, the
  libraries' sin/cos differ in the last ulp); angles modulo 2 pi.
* The general path: the port's env against ``jax.vmap(env.step)`` under
  one action buffer and constant references for all 12 ids, on
  ``ode_state`` at rtol 1e-4 / atol 1e-3 (the JAX test's tolerance for env
  against kernel, tests/test_pallas_sync_universal.py:75-77; the SC speed
  ODE reorders no product but XLA may fuse), reward at rtol 1e-4 /
  atol 1e-5 and termination exactly.
* Random mode, replay: the plain random rollout driven by a copy of the
  interpret-mode xorshift bit source in the JAX kernel's draw order
  (pallas_common.py:885-901), against the JAX interpret kernel: rtol 1e-4
  in at least 99% of envs (an ulp of a transcendental can flip a
  constraint threshold in an env).
* Random mode, statistics: the Philox plain version against the XLA env
  (``test_fused_sync_stochastic_stats``' bounds).
* The dispatch and every option the port does not fuse yet.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_electric_motor_tpu as gemx
from gym_electric_motor_tpu import references as jrg
from gym_electric_motor_tpu.ops.pallas_rollout import (
    fused_state_arity as jax_arity,
    make_fused_sync_rollout as jax_sync_rollout,
)
import gym_electric_motor_tpu_torch as gt
from gym_electric_motor_tpu_torch import references as trg
from gym_electric_motor_tpu_torch.constraints import LimitConstraint, SquaredConstraint
from gym_electric_motor_tpu_torch.models import converters as tcv
from gym_electric_motor_tpu_torch.models import loads as tld
from gym_electric_motor_tpu_torch.models import supplies as tsp
from gym_electric_motor_tpu_torch.ops import fused_common as fc
from gym_electric_motor_tpu_torch.ops import fused_rollout as fr
from gym_electric_motor_tpu_torch.ops import fused_sync_family as sf
from gym_electric_motor_tpu_torch.utils import rng as trng
from test_pallas_rollout import N_STAT, T_STAT, _check_wiener_state, _xla_random_rollout
from test_pallas_sync_universal import PHYSICS_CASES, STAT_CASES

torch.set_num_threads(1)

BUF = dict(rtol=1e-5, atol=1e-4)
CONST_REFS = {"CC": [("i_sd", 0.1), ("i_sq", -0.2)], "TC": [("torque", 0.3)],
              "SC": [("omega", 0.2)]}


def const_envs(env_id, refs=None):
    """The JAX and the port env of ``env_id`` with constant references
    (``refs``: (state, value) pairs, by default ``CONST_REFS`` of the task)."""
    refs = refs or CONST_REFS[env_id.split("-")[1]]
    jenv = gemx.make_functional(env_id, reference_generator=jrg.ReferenceSpec(
        [jrg.ConstReference(n, v) for n, v in refs]))
    tenv = gt.make_functional(env_id, device="cpu", reference_generator=trg.ReferenceSpec(
        [trg.ConstReference(n, v) for n, v in refs]))
    return jenv, tenv


def start_planes(n_state, R, seed, amp=50.0):
    """Initial planes from numpy: currents in +-amp A, angles in [0, 2 pi),
    speed (first, if any) in +-50 rad/s."""
    rng = np.random.default_rng(seed)
    cur = [rng.uniform(-amp, amp, (R, 128)).astype(np.float32) for _ in range(2)]
    eps = rng.uniform(0, 2 * np.pi, (R, 128)).astype(np.float32)
    w = [rng.uniform(-50, 50, (R, 128)).astype(np.float32)] if n_state == 4 else []
    return w + cur + [eps]


def action_buffer(finite, T, R, seed):
    rng = np.random.default_rng(seed)
    if finite:
        return rng.integers(0, 8, (T, R, 128)).astype(np.int32)
    return rng.uniform(-1.0, 1.0, (T, 3, R, 128)).astype(np.float32)


def assert_angle(got, want, atol=1e-4):
    d = np.remainder(got - want, 2 * np.pi)
    np.testing.assert_allclose(np.minimum(d, 2 * np.pi - d), 0.0, atol=atol)


@pytest.mark.parametrize("env_id,finite,mech,ref_names", PHYSICS_CASES,
                         ids=[c[0] for c in PHYSICS_CASES])
def test_buffer_rollout_matches_jax_interpret(env_id, finite, mech, ref_names):
    jenv, tenv = const_envs(env_id, [(n, 0.0) for n in ref_names])
    N, T = 128, 50
    n_state = 4 if mech else 3
    start = start_planes(n_state, 1, 6)
    acts = action_buffer(finite, T, 1, 5)
    want = jax_sync_rollout(jenv, T, N, action_mode="buffer", interpret=True)(
        *map(jnp.asarray, start), jnp.asarray(acts))
    got = sf.make_fused_sync_rollout(tenv, T, N, action_mode="buffer")(
        *map(torch.as_tensor, start), torch.as_tensor(acts))
    assert len(got) == len(want) == n_state
    for j, (g, w) in enumerate(zip(got, want)):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape == (1, 128)
        if j == n_state - 1:
            assert_angle(g, w)
        else:
            np.testing.assert_allclose(g, w, **BUF)


@pytest.mark.parametrize("env_id", gt.SYNC_ENV_IDS)
def test_general_path_matches_jax_env(env_id):
    jenv, tenv = const_envs(env_id)
    finite = env_id.startswith("Finite")
    N, T = 8, 50
    rng = np.random.default_rng(0)
    acts = (rng.integers(0, 8, (T, N)).astype(np.int32) if finite
            else rng.uniform(-1, 1, (T, N, 3)).astype(np.float32))
    js, _ = jax.vmap(jenv.reset)(jax.random.split(jax.random.PRNGKey(0), N))
    ts, _ = tenv.reset(trng.env_keys(0, N, "cpu"))
    step = jax.jit(jax.vmap(jenv.step))
    for t in range(T):
        js, _jo, jr, jterm = step(js, jnp.asarray(acts[t]))
        ts, _to, tr, tterm = tenv.step(ts, torch.as_tensor(acts[t]))
        np.testing.assert_allclose(ts.phys.ode_state.numpy(), np.asarray(js.phys.ode_state),
                                   rtol=1e-4, atol=1e-3, err_msg=f"{env_id} step {t}")
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-4, atol=1e-5)
        np.testing.assert_array_equal(tterm.numpy(), np.asarray(jterm))


class XorshiftSyncBits:
    """Test-only copy of the interpret-mode bit source of
    ``pallas_common._make_rng`` (:885-901): one xorshift32 state per lane of
    an (n_rows R, 128) plane; a draw steps the whole plane and returns its
    first rows when it asks for an (R, 128) shape.  Consumed in the JAX
    kernels' order: the init value, length and sigma planes; per step the
    action words, the Box-Muller pair (with one reference row, at even
    steps only), then the length, sigma and reset planes.  All-constant
    references draw nothing but the actions."""

    def __init__(self, seed, n, n_rows, n_act, all_const=False):
        flat = np.arange(n_rows * n, dtype=np.uint32)
        with np.errstate(over="ignore"):
            v = ((flat + np.uint32(1)) * np.uint32(2654435761)) ^ (np.uint32(seed) * np.uint32(0x9E3779B9))
        self.s, self.n, self.n_rows, self.n_act = v | np.uint32(1), n, n_rows, n_act
        self.all_const = all_const

    def _next(self):
        s = self.s
        s = s ^ (s << np.uint32(13))
        s = s ^ (s >> np.uint32(17))
        s = s ^ (s << np.uint32(5))
        self.s = s
        return torch.as_tensor(s.astype(np.int64))

    def _rows(self, w):
        return [w[j * self.n:(j + 1) * self.n] for j in range(self.n_rows)]

    def init_words(self):
        return self._rows(self._next()), self._rows(self._next()), self._rows(self._next())

    def step_words(self, t):
        acts = [self._next()[:self.n] for _ in range(self.n_act)]
        if self.all_const:
            return acts, None, None, [], [], []
        u1 = u2 = None
        if self.n_rows == 2 or t % 2 == 0:
            u1, u2 = self._next()[:self.n], self._next()[:self.n]
        ln, sg, rs = self._next(), self._next(), self._next()
        return acts, u1, u2, self._rows(ln), self._rows(sg), self._rows(rs)


def env_share(got, want, n_state, N):
    """Share of envs whose every output agrees at rtol 1e-4 / atol 1e-4 (A,
    rad/s; currents reach hundreds of amperes, where an ulp is 3e-5, and a
    recorded current near zero keeps that error), angles modulo 2 pi; envs
    are the trailing N elements."""
    ok = np.ones(N, bool)
    for j, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape
        if j == n_state - 1:
            d = np.remainder(g - w, 2 * np.pi)
            close = np.minimum(d, 2 * np.pi - d) <= 1e-4
        else:
            close = np.isclose(g, w, rtol=1e-4, atol=1e-4)
        ok &= close.reshape(-1, N).all(axis=0)
    return ok.mean()


REPLAY_IDS = ["Cont-CC-SynRM-v0", "Cont-TC-PMSM-v0", "Finite-SC-PMSM-v0"]


@pytest.mark.parametrize("env_id", REPLAY_IDS)
def test_random_rollout_replays_jax_interpret(env_id):
    jenv = gemx.make_functional(env_id)
    tenv = gt.make_functional(env_id, device="cpu")
    c = sf.SyncConsts(tenv)
    N, T, seed = 256, 64, 3
    start = start_planes(c.n_state, 2, 4, amp=1.0 / c.f["inv_i_lim"])  # a fifth start outside
    want = jax_sync_rollout(jenv, T, N, interpret=True)(seed, *map(jnp.asarray, start))
    got = sf.sync_rollout_random_plain(c, seed, tuple(map(torch.as_tensor, start)), T,
                                       bits=XorshiftSyncBits(seed, N, c.n_ref, c.n_act))
    assert len(got) == len(want) == c.n_state + 6
    assert got[c.n_state + 2].shape == (2 * c.n_ref, 128)
    assert float(np.asarray(want[c.n_state + 1]).sum()) > 0  # the replay crosses resets
    assert env_share([g.numpy() for g in got], want, c.n_state, N) >= 0.99


@pytest.mark.parametrize("env_id,n_state", STAT_CASES, ids=[c[0] for c in STAT_CASES])
def test_random_rollout_statistics_match_jax_env(env_id, n_state):
    """``test_fused_sync_stochastic_stats`` for the Philox plain version."""
    tenv = gt.make_functional(env_id, device="cpu")
    sub = tenv.reference_generator.subs[0]
    z = torch.zeros((N_STAT // 128, 128))
    out = fr.make_fused_rollout(tenv, T_STAT, N_STAT)(3, *([z] * n_state))
    states, reward, terms = out[:n_state], out[n_state], out[n_state + 1]
    rv, rk, rl, rs = (x.numpy() for x in out[n_state + 2:])
    margin = max(abs(sub.margin[0]), abs(sub.margin[1]))
    _check_wiener_state(rv, rk, rl, rs, margin, *sub.sigma_range)
    mean_r = float(reward.sum()) / (N_STAT * T_STAT)
    term_rate = float(terms.sum()) / (N_STAT * T_STAT)
    xla_mean_r, xla_term_rate = _xla_random_rollout(env_id, N_STAT, T_STAT)
    assert abs(mean_r - xla_mean_r) < 0.08
    assert abs(term_rate - xla_term_rate) < max(0.5 * max(term_rate, xla_term_rate), 2e-3)
    assert all(bool(torch.isfinite(s).all()) for s in states)


@pytest.mark.parametrize("env_id", gt.SYNC_ENV_IDS)
def test_fused_state_arity_matches_jax(env_id):
    tenv = gt.make_functional(env_id, device="cpu")
    assert fr.fused_state_arity(tenv) == jax_arity(gemx.make_functional(env_id))
    assert sf.SyncConsts(tenv).n_state == fr.fused_state_arity(tenv)


class _Wrapper:
    """A stand-in physical-system wrapper: the check reads the class name
    and the ``inner`` chain only."""

    def __init__(self, inner):
        self.inner = inner


def _wrapped(name, ps):
    return type(name, (_Wrapper,), {})(ps)


def _catalog(env_id="Cont-CC-PMSM-v0", **kw):
    return lambda: gt.make_functional(env_id, device="cpu", **kw)


def _fused(env_id="Cont-CC-PMSM-v0", mutate=None, **kw):
    def build():
        env = gt.make_functional(env_id, device="cpu", **kw)
        if mutate:
            mutate(env)
        return fr.make_fused_rollout(env, 8, 128)
    return build


UNFUSED = {
    "ac1_supply": lambda: tsp.ac_1_phase_supply(),
    "rc_supply": lambda: tsp.rc_voltage_supply(),
    "ac3_supply": lambda: tsp.ac_3_phase_supply(),
    "handmade_rc_supply": _fused(supply=tsp.SupplySpec(
        kind="RCVoltageSupply", u_nominal=300.0, supply_range=(300.0, 300.0), voltage_len=1,
        parameter={"u_nominal": 300.0}, get_voltage=tsp.ideal_voltage_supply(300.0).get_voltage,
        reset_u=tsp.ideal_voltage_supply(300.0).reset_u)),
    "ou_load": lambda: tld.ornstein_uhlenbeck_load(),
    "external_speed_load": lambda: tld.external_speed_load(lambda t: 0.0),
    "interlocking": lambda: tcv.cont_b6_bridge_converter(1e-4, interlocking_time=1e-6),
    "dead_time_wrapper": _catalog(physical_system_wrappers=(_Wrapper(None),)),
    "fused_dead_time": _fused(mutate=lambda e: setattr(
        e, "physical_system", _wrapped("DeadTimeProcessor", e.physical_system))),
    "fused_state_noise": _fused(mutate=lambda e: setattr(
        e, "physical_system", _wrapped("StateNoiseProcessor", e.physical_system))),
    "fused_dq_to_abc": _fused(mutate=lambda e: setattr(
        e, "physical_system", _wrapped("DqToAbcActionProcessor", e.physical_system))),
    "control_space_dq": _catalog(control_space="dq"),
    "fused_control_space_dq": _fused(mutate=lambda e: setattr(
        e.physical_system, "control_space", "dq")),
    "randomize": lambda: fr.make_fused_rollout(
        gt.make_functional("Cont-CC-PMSM-v0", device="cpu"), 8, 128, randomize={"r_s": (0.9, 1.1)}),
    "laplace_reference": lambda: trg.ScalarRefSpec("laplace", "i_sd"),
    "sinusoidal_reference": lambda: trg.ScalarRefSpec("sinusoidal", "i_sd"),
    "switched_reference": lambda: trg.ScalarRefSpec("switched", "i_sd"),
    "limit_constraint": _fused(constraints=(LimitConstraint(("i_sd",)),)),
    "extra_constraint": _fused(constraints=(SquaredConstraint(("i_sq", "i_sd")),
                                            LimitConstraint(("omega",)))),
    "reward_power_2": _fused(reward_function=gt.rewards.WeightedSumOfErrors(
        reward_weights=dict(i_sd=0.5, i_sq=0.5), reward_power=2)),
    "unreferenced_weight": _fused(reward_function=gt.rewards.WeightedSumOfErrors(
        reward_weights=dict(i_sd=0.5, i_sq=0.4, torque=0.1))),
    "omega_reference_const_speed": _fused(reference_generator=trg.ConstReference("omega", 0.1)),
    "euler_solver": _fused(solver="euler"),
}


# what the JAX kernels do not fuse either: the message points at VectorEnv
NEVER_FUSED = {"limit_constraint", "extra_constraint", "unreferenced_weight",
               "omega_reference_const_speed", "euler_solver"}


@pytest.mark.parametrize("option", list(UNFUSED))
def test_unported_options_raise(option):
    """Each raises NotImplementedError naming the queue item or slice that
    brings it."""
    with pytest.raises(NotImplementedError,
                       match=None if option in NEVER_FUSED else r"(queue|slice) \d"):
        UNFUSED[option]()


def test_no_constraints_never_terminate():
    """``constraints=()``: the kernels' 'none' mode (pallas_common.py:
    134-136), so a drive pushed past the current limit never resets."""
    tenv = gt.make_functional("Finite-CC-PMSM-v0", device="cpu", constraints=())
    z = torch.zeros((1, 128))
    big = torch.full((1, 128), 1000.0)
    out = fr.make_fused_rollout(tenv, 20, 128)(1, big, big, z)
    assert float(out[4].sum()) == 0.0


def test_wrappers_take_plain_path_on_cpu_and_validate():
    tenv = gt.make_functional("Cont-SC-PMSM-v0", device="cpu")
    c = sf.SyncConsts(tenv)
    z = torch.zeros((1, 128))
    sf.reset_launches()
    out = sf.sync_rollout_random(c, 1, (z, z, z, z), 5)
    ref = sf.sync_rollout_random_plain(c, 1, (z, z, z, z), 5)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert all(v == 0 for v in sf.LAUNCHES.values())
    assert c.host.dtype == np.float32 and len(c.host) == len(sf.CONST_NAMES) + 2 * len(sf.ROW_NAMES)
    with pytest.raises(ValueError, match="4 state planes"):
        sf.sync_rollout_random(c, 1, (z, z, z), 5)
    with pytest.raises(TypeError):
        sf.sync_rollout_random(c, 1, (z, z, z.double(), z), 5)
    with pytest.raises(ValueError):
        sf.sync_rollout_buffer(c, (z, z, z, z), torch.zeros((5, 1, 128)))
    with pytest.raises(TypeError):
        sf.sync_rollout_buffer(c, (z, z, z, z), torch.zeros((5, 3, 1, 128), dtype=torch.float64))
    with pytest.raises(ValueError, match="action buffer"):
        fr.make_fused_rollout(tenv, 6, 128, action_mode="buffer")(
            z, z, z, z, torch.zeros((5, 3, 1, 128)))


def test_philox_sync_bits_follow_the_slots():
    bits = fc.SyncBits(9, 256, "cpu", 2, 3)
    env = torch.arange(256, dtype=torch.int64)
    words = fc.philox4x32(env, torch.tensor(7), torch.tensor(fc.SLOT_STEP), torch.tensor(0),
                          *fc.seed_key(9))
    acts, u1, u2, lens, sigs, resets = bits.step_words(7)
    assert torch.equal(acts[0], words[0]) and torch.equal(acts[1], words[3])
    assert torch.equal(u1, words[1]) and torch.equal(u2, words[2])
    c_word = fc.philox4x32(env, torch.tensor(7), torch.tensor(fc.SLOT_ACTION_C), torch.tensor(0),
                           *fc.seed_key(9))[0]
    assert torch.equal(acts[2], c_word)
    assert len(lens) == len(sigs) == len(resets) == 2
    vals, lens0, sigs0 = bits.init_words()
    init_a = fc.philox4x32(env, torch.tensor(0), torch.tensor(fc.SLOT_INIT_A), torch.tensor(0),
                           *fc.seed_key(9))
    assert torch.equal(vals[1], init_a[1]) and torch.equal(lens0[0], init_a[2])
