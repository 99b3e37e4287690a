"""The port's universal DC-family rollout (``make_fused_dc_rollout`` and the
dispatch ``make_fused_rollout``, plain PyTorch versions on the CPU) and its
24 env ids against the JAX package.

* Buffer mode: the same numpy action buffer through both packages'
  ``make_fused_dc_rollout`` (the JAX kernel in interpret mode, as
  tests/test_pallas_dc_universal.py runs it) for its 8 ``PHYSICS_CASES``
  and for PermExDc under each of the finite and continuous 1QC and 2QC
  converters, rtol 1e-5 / atol 1e-4 (A, rad/s; float32 RK4 in the same
  order).
* The general path: the port's env against ``jax.vmap(env.step)`` under
  one action buffer and constant references for all 24 ids and the four
  1QC/2QC overrides, on ``ode_state``, the observation and the reward at
  rtol 1e-4 / atol 1e-3 (the JAX suite's tolerance for env against kernel,
  tests/test_pallas_dc_universal.py:83-85; XLA may fuse a product of
  constants) and termination exactly.
* Random mode, replay: the plain random rollout driven by the test-only
  xorshift copy of the interpret bit source in the JAX kernel's draw order,
  against the JAX interpret kernel, in at least 99% of envs.
* Random mode, statistics: the Philox plain version against the XLA env
  (``test_fused_dc_stochastic_stats``' bounds).
* The dispatch, the state arity of all 36 ids, every option that raises,
  and a mid-episode JAX state carried over by ``state_from_numpy``.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_electric_motor_tpu as gemx
from gym_electric_motor_tpu import references as jrg
from gym_electric_motor_tpu.models import converters as jcv
from gym_electric_motor_tpu.models import motors as jmt
from gym_electric_motor_tpu.ops.pallas_rollout import (
    fused_state_arity as jax_arity,
    make_fused_dc_rollout as jax_dc_rollout,
)
import gym_electric_motor_tpu_torch as gt
from gym_electric_motor_tpu_torch import references as trg
from gym_electric_motor_tpu_torch.constraints import LimitConstraint
from gym_electric_motor_tpu_torch.models import converters as tcv
from gym_electric_motor_tpu_torch.models import loads as tld
from gym_electric_motor_tpu_torch.models import motors as tmt
from gym_electric_motor_tpu_torch.ops import fused_common as fc
from gym_electric_motor_tpu_torch.ops import fused_dc_family as dcf
from gym_electric_motor_tpu_torch.ops import fused_rollout as fr
from gym_electric_motor_tpu_torch.utils import rng as trng
from gym_electric_motor_tpu_torch.wrappers import CurrentSumProcessor
from test_pallas_dc_universal import PHYSICS_CASES, STAT_CASES
from test_pallas_rollout import N_STAT, T_STAT, _check_wiener_state, _xla_random_rollout
from test_torch_sync_universal import XorshiftSyncBits, env_share

torch.set_num_threads(1)

BUF = dict(rtol=1e-5, atol=1e-4)
ENV_TOL = dict(rtol=1e-4, atol=1e-3)
CONST_REFS = {"CC": {"PermExDc": [("i", 0.2)], "SeriesDc": [("i", 0.2)], "ShuntDc": [("i_a", 0.2)],
                     "ExtExDc": [("i_a", 0.2), ("i_e", 0.1)]},
              "TC": [("torque", 0.3)], "SC": [("omega", 0.2)]}
# (name, JAX factory, port factory): the 1QC/2QC converters passed as converter=
OVERRIDES = [(f"{a}-{q}", getattr(jcv, f"{f}_{n}_quadrant_converter"),
              getattr(tcv, f"{f}_{n}_quadrant_converter"))
             for a, f in (("Finite", "finite"), ("Cont", "cont"))
             for q, n in (("1QC", "one"), ("2QC", "two"))]


def _refs(env_id):
    _a, task, motor, _v = env_id.split("-")
    refs = CONST_REFS[task]
    return refs[motor] if task == "CC" else refs


def const_envs(env_id, refs=None, converter=None):
    """The JAX and the port env of ``env_id`` with constant references
    (``refs``: (state, value) pairs, by default the task's), and
    ``converter`` = (JAX factory, port factory) in place of the default."""
    refs = refs or _refs(env_id)
    tau = 1e-5 if env_id.startswith("Finite") else 1e-4
    jkw, tkw = {}, {}
    if converter:
        jkw["converter"], tkw["converter"] = converter[0](tau), converter[1](tau)
    jenv = gemx.make_functional(env_id, reference_generator=jrg.ReferenceSpec(
        [jrg.ConstReference(n, v) for n, v in refs]), **jkw)
    tenv = gt.make_functional(env_id, device="cpu", reference_generator=trg.ReferenceSpec(
        [trg.ConstReference(n, v) for n, v in refs]), **tkw)
    return jenv, tenv


def start_planes(c, R, seed, amp=50.0):
    """Initial planes from numpy: speed (first, if any) in [0, 100) rad/s
    (SeriesDc and ShuntDc run forward only), currents in +-amp A."""
    rng = np.random.default_rng(seed)
    w = [rng.uniform(0, 100, (R, 128)).astype(np.float32)] if c.mech else []
    return w + [rng.uniform(-amp, amp, (R, 128)).astype(np.float32) for _ in range(c.n_el)]


def action_buffer(c, T, R, seed):
    """Finite actions in 0..n-1, continuous ones uniform over the box (and
    a little beyond it, so that the clips are exercised)."""
    rng = np.random.default_rng(seed)
    ch = (2,) if c.n_ch == 2 else ()
    if c.finite:
        return rng.integers(0, min(c.act_ns), (T,) + ch + (R, 128)).astype(np.int32)
    lo = c.f["act_lo0"]
    hi = lo + c.f["act_span0"]
    return rng.uniform(lo - 0.2, hi + 0.2, (T,) + ch + (R, 128)).astype(np.float32)


DC_MOTORS = [("permex_dc", "permex_dc_ode", "permex_dc_torque"),
             ("series_dc", "series_dc_ode", "series_dc_torque"),
             ("shunt_dc", "shunt_dc_ode", "extex_dc_torque"),
             ("extex_dc", "extex_dc_ode", "extex_dc_torque")]


@pytest.mark.parametrize("factory,ode,torque", DC_MOTORS, ids=[m[0] for m in DC_MOTORS])
def test_dc_ode_torque_and_i_in_match_jax(factory, ode, torque):
    """The DC ODEs, torques and converter currents on random states, inputs
    and speeds: rtol 1e-6 / atol 1e-3 (A/s, N m; the same float32
    expressions, as tests/test_torch_models.py holds the synchronous ones)."""
    jspec, tspec = getattr(jmt, factory)(), getattr(tmt, factory)()
    n_el, n_u = len(tspec.currents), len(tspec.voltages)
    rng = np.random.default_rng(len(factory))
    state = rng.uniform(-300, 300, (64, n_el)).astype(np.float32)
    u_in = rng.uniform(-60, 60, (64, n_u)).astype(np.float32)
    omega = rng.uniform(-400, 400, 64).astype(np.float32)
    jmp = jspec.mp()
    for fn, want_fn, args in (
            (getattr(tmt, ode), getattr(jmt, ode), (u_in, omega)),
            (getattr(tmt, torque), getattr(jmt, torque), ()),
            (lambda mp, s: tspec.i_in(mp, s), lambda mp, s: jspec.i_in(mp, s), ())):
        want = np.stack([np.asarray(want_fn(jmp, jnp.asarray(s), *(jnp.asarray(a[k]) for a in args)))
                         for k, s in enumerate(state)])
        got = fn(tspec.mp(), torch.as_tensor(state), *map(torch.as_tensor, args)).numpy()
        np.testing.assert_allclose(got, want.reshape(got.shape), rtol=1e-6, atol=1e-3)


BUFFER_CASES = [(c[0], c[5], None) for c in PHYSICS_CASES] + [
    ("Finite-CC-PermExDc-v0" if name.startswith("Finite") else "Cont-CC-PermExDc-v0", ["i"], name)
    for name, _j, _t in OVERRIDES]


@pytest.mark.parametrize("env_id,ref_names,override", BUFFER_CASES,
                         ids=[c[0] + ("/" + c[2] if c[2] else "") for c in BUFFER_CASES])
def test_buffer_rollout_matches_jax_interpret(env_id, ref_names, override):
    conv = next((o[1:] for o in OVERRIDES if o[0] == override), None)
    jenv, tenv = const_envs(env_id, [(n, 0.0) for n in ref_names], conv)
    N, T = 128, 50
    c = dcf.DcConsts(tenv)
    start = start_planes(c, 1, 6)
    acts = action_buffer(c, T, 1, 5)
    want = jax_dc_rollout(jenv, T, N, action_mode="buffer", interpret=True)(
        *map(jnp.asarray, start), jnp.asarray(acts))
    want = want if isinstance(want, tuple) else (want,)
    got = fr.make_fused_rollout(tenv, T, N, action_mode="buffer")(
        *map(torch.as_tensor, start), torch.as_tensor(acts))
    assert len(got) == len(want) == c.n_state
    for g, w in zip(got, want):
        assert g.shape == w.shape == (1, 128)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **BUF)


GENERAL_CASES = [(e, None) for e in gt.DC_ENV_IDS] + [
    ("Finite-SC-PermExDc-v0" if name.startswith("Finite") else "Cont-TC-PermExDc-v0", name)
    for name, _j, _t in OVERRIDES]


@pytest.mark.parametrize("env_id,override", GENERAL_CASES,
                         ids=[c[0] + ("/" + c[1] if c[1] else "") for c in GENERAL_CASES])
def test_general_path_matches_jax_env(env_id, override):
    conv = next((o[1:] for o in OVERRIDES if o[0] == override), None)
    jenv, tenv = const_envs(env_id, converter=conv)
    c = dcf.DcConsts(tenv)
    N, T = 8, 50
    acts = action_buffer(c, T, 1, 0)[..., :N]  # (T, [2,] 1, N)
    acts = acts.reshape((T, 2, N) if c.n_ch == 2 else (T, N))
    if c.n_ch == 2:
        acts = acts.transpose(0, 2, 1)  # (T, N, 2)
    elif not c.finite:
        acts = acts[..., None]  # (T, N, 1)
    js, _ = jax.vmap(jenv.reset)(jax.random.split(jax.random.PRNGKey(0), N))
    ts, _ = tenv.reset(trng.env_keys(0, N, "cpu"))
    step = jax.jit(jax.vmap(jenv.step))
    for t in range(T):
        js, jo, jr, jterm = step(js, jnp.asarray(acts[t]))
        ts, to, tr, tterm = tenv.step(ts, torch.as_tensor(acts[t]))
        msg = f"{env_id} step {t}"
        np.testing.assert_allclose(ts.phys.ode_state.numpy(), np.asarray(js.phys.ode_state),
                                   **ENV_TOL, err_msg=msg)
        np.testing.assert_allclose(to[0].numpy(), np.asarray(jo[0]), **ENV_TOL, err_msg=msg)
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-4, atol=1e-5, err_msg=msg)
        np.testing.assert_array_equal(tterm.numpy(), np.asarray(jterm), err_msg=msg)
        np.testing.assert_array_equal(ts.phys.conv_state.numpy(), np.asarray(js.phys.conv_state))


class XorshiftDcBits(XorshiftSyncBits):
    """The interpret-mode bit source in the DC kernel's draw order (the
    actions, then the reference draws, pallas_dc.py:1166-1188): one action
    word per continuous channel, one for the finite converter."""


REPLAY_IDS = ["Finite-SC-PermExDc-v0", "Cont-CC-ExtExDc-v0", "Finite-CC-ExtExDc-v0",
              "Finite-TC-SeriesDc-v0"]


def _replay_start(c, seed):
    """Starts of which about a fifth lie outside the current limit, so that
    the replay crosses resets."""
    rng = np.random.default_rng(seed)
    w = [rng.uniform(0, 100, (2, 128)).astype(np.float32)] if c.mech else []
    lims = [c.f["lim0"], c.f["lim1"]][:c.n_el]
    return w + [rng.uniform(-1.2 * lim, 1.2 * lim, (2, 128)).astype(np.float32) for lim in lims]


@pytest.mark.parametrize("env_id", REPLAY_IDS)
def test_random_rollout_replays_jax_interpret(env_id):
    jenv = gemx.make_functional(env_id)
    tenv = gt.make_functional(env_id, device="cpu")
    c = dcf.DcConsts(tenv)
    N, T, seed = 256, 64, 3
    start = _replay_start(c, 4)
    want = jax_dc_rollout(jenv, T, N, interpret=True)(seed, *map(jnp.asarray, start))
    got = dcf.dc_rollout_random_plain(c, seed, tuple(map(torch.as_tensor, start)), T,
                                      bits=XorshiftDcBits(seed, N, c.n_ref, c.n_act))
    assert len(got) == len(want) == c.n_state + 6
    assert got[c.n_state + 2].shape == (2 * c.n_ref, 128)
    assert float(np.asarray(want[c.n_state + 1]).sum()) > 0  # the replay crosses resets
    # no state is an angle: env_share's angle column is past the last state
    assert env_share([g.numpy() for g in got], want, len(got) + 1, N) >= 0.99


@pytest.mark.parametrize("env_id,n_state", STAT_CASES, ids=[c[0] for c in STAT_CASES])
def test_random_rollout_statistics_match_jax_env(env_id, n_state):
    """``test_fused_dc_stochastic_stats`` for the Philox plain version."""
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


@pytest.mark.parametrize("env_id", gt.ENV_IDS)
def test_fused_state_arity_matches_jax_all_ids(env_id):
    tenv = gt.make_functional(env_id, device="cpu")
    assert fr.fused_state_arity(tenv) == jax_arity(gemx.make_functional(env_id))
    if env_id in gt.DC_ENV_IDS:
        assert dcf.DcConsts(tenv).n_state == fr.fused_state_arity(tenv)


class _Wrapper:
    """A stand-in physical-system wrapper: the check reads the class name
    and the ``inner`` chain only."""

    def __init__(self, inner):
        self.inner = inner


def _fused(env_id="Cont-CC-PermExDc-v0", mutate=None, **kw):
    def build():
        env = gt.make_functional(env_id, device="cpu", **kw)
        if mutate:
            mutate(env)
        return fr.make_fused_rollout(env, 8, 128)
    return build


UNFUSED = {
    "randomize": lambda: fr.make_fused_rollout(
        gt.make_functional("Cont-CC-PermExDc-v0", device="cpu"), 8, 128,
        randomize={"r_a": (0.9, 1.1)}),
    "interlocking": lambda: tcv.finite_four_quadrant_converter(1e-5, interlocking_time=1e-7),
    "interlocking_fused": _fused(mutate=lambda e: setattr(
        e.physical_system.converter, "interlocking_time", 1e-6)),
    "single_4qc_multi": _fused("Finite-CC-ExtExDc-v0", converter=tcv.finite_multi_converter(
        [tcv.finite_four_quadrant_converter(), tcv.finite_two_quadrant_converter()])),
    "b6_on_dc": _fused("Cont-CC-PermExDc-v0", converter=tcv.cont_b6_bridge_converter()),
    "ou_load": lambda: tld.ornstein_uhlenbeck_load(),
    "external_speed_load": lambda: tld.external_speed_load(lambda t: 0.0),
    "other_wrapper": lambda: gt.make_functional(
        "Finite-CC-ShuntDc-v0", device="cpu", physical_system_wrappers=(_Wrapper(None),)),
    "fused_dead_time": _fused("Finite-CC-ShuntDc-v0", mutate=lambda e: setattr(
        e, "physical_system", type("DeadTimeProcessor", (_Wrapper,), {})(e.physical_system))),
    "fused_state_noise": _fused(mutate=lambda e: setattr(
        e, "physical_system", type("StateNoiseProcessor", (_Wrapper,), {})(e.physical_system))),
    "laplace_reference": lambda: trg.ScalarRefSpec("laplace", "i"),
    "extra_constraint": _fused(constraints=(LimitConstraint(("i",)), LimitConstraint(("omega",)))),
    "reward_power_2": _fused(reward_function=gt.rewards.WeightedSumOfErrors(
        reward_weights=dict(i=1.0), reward_power=2)),
    "unreferenced_weight": _fused(reward_function=gt.rewards.WeightedSumOfErrors(
        reward_weights=dict(i=0.9, torque=0.1))),
    "omega_reference_const_speed": _fused(reference_generator=trg.ConstReference("omega", 0.1)),
    "voltage_reference": _fused(reference_generator=trg.ConstReference("u", 0.1)),
    "two_references_permex": _fused(reference_generator=trg.ReferenceSpec(
        [trg.ConstReference("i", 0.1), trg.ConstReference("torque", 0.1)])),
    "euler_solver": _fused(solver="euler"),
    "sync_kernels_on_dc": lambda: fr.make_fused_sync_rollout(
        gt.make_functional("Cont-CC-PermExDc-v0", device="cpu"), 8, 128),
    "dc_kernels_on_sync": lambda: fr.make_fused_dc_rollout(
        gt.make_functional("Cont-CC-PMSM-v0", device="cpu"), 8, 128),
}
# what the JAX kernels do not fuse either: the message points at VectorEnv
NEVER_FUSED = {"single_4qc_multi", "b6_on_dc", "extra_constraint", "unreferenced_weight",
               "omega_reference_const_speed", "voltage_reference", "two_references_permex",
               "euler_solver", "sync_kernels_on_dc", "dc_kernels_on_sync"}


@pytest.mark.parametrize("option", list(UNFUSED))
def test_unported_options_raise(option):
    """Each raises NotImplementedError, naming the queue item or slice that
    brings it where the JAX kernels fuse it."""
    with pytest.raises(NotImplementedError,
                       match=None if option in NEVER_FUSED else r"(queue|slice) \d"):
        UNFUSED[option]()


def test_shunt_current_sum_and_state_space():
    """ShuntDc's default CurrentSumProcessor appends i_sum with the larger
    of the two current limits; the polarity-aware state space gives omega a
    lower bound of 0 for SeriesDc and ShuntDc and a 1QC current one of 0."""
    env = gt.make_functional("Finite-CC-ShuntDc-v0", device="cpu")
    ps = env.physical_system
    assert isinstance(ps, CurrentSumProcessor) and ps.state_names[-1] == "i_sum"
    names = ps.state_names
    assert ps.limits[-1] == max(ps.limits[names.index("i_a")], ps.limits[names.index("i_e")])
    state, obs = env.reset(trng.env_keys(0, 4, "cpu"))
    state, obs, _r, _t = env.step(state, torch.tensor([1, 2, 1, 2]))
    s = obs[0]
    torch.testing.assert_close(s[:, -1], s[:, names.index("i_a")] + s[:, names.index("i_e")])
    assert ps.state_space_low[names.index("omega")] == 0.0
    one_q = gt.make_functional("Cont-CC-PermExDc-v0", device="cpu",
                               converter=tcv.cont_one_quadrant_converter())
    low = one_q.physical_system.state_space_low
    assert low[one_q.physical_system.state_names.index("i")] == 0.0


def test_wrappers_take_plain_path_on_cpu_and_validate():
    tenv = gt.make_functional("Cont-SC-ExtExDc-v0", device="cpu")
    c = dcf.DcConsts(tenv)
    z = torch.zeros((1, 128))
    dcf.reset_launches()
    out = dcf.dc_rollout_random(c, 1, (z, z, z), 5)
    ref = dcf.dc_rollout_random_plain(c, 1, (z, z, z), 5)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert all(v == 0 for v in dcf.LAUNCHES.values())
    assert c.host.dtype == np.float32
    assert len(c.host) == len(dcf.CONST_NAMES) + 2 * len(fc.ROW_NAMES)
    with pytest.raises(ValueError, match="3 state planes"):
        dcf.dc_rollout_random(c, 1, (z, z), 5)
    with pytest.raises(TypeError):
        dcf.dc_rollout_random(c, 1, (z, z, z.double()), 5)
    with pytest.raises(ValueError):  # ExtExDc takes (T, 2, R, 128)
        dcf.dc_rollout_buffer(c, (z, z, z), torch.zeros((5, 1, 128)))
    with pytest.raises(ValueError, match="action buffer"):
        fr.make_fused_rollout(tenv, 6, 128, action_mode="buffer")(
            z, z, z, torch.zeros((5, 2, 1, 128)))


def test_dc_bits_follow_the_slots():
    """Continuous ExtExDc: one action word per channel, SLOT_STEP's words 0
    and 3; a finite converter draws one word."""
    bits = fc.DcBits(9, 256, "cpu", 1, 2)
    env = torch.arange(256, dtype=torch.int64)
    words = fc.philox4x32(env, torch.tensor(5), torch.tensor(fc.SLOT_STEP), torch.tensor(0),
                          *fc.seed_key(9))
    acts, u1, u2, *_ = bits.step_words(5)
    assert len(acts) == 2 and torch.equal(acts[0], words[0]) and torch.equal(acts[1], words[3])
    assert torch.equal(u1, words[1]) and torch.equal(u2, words[2])
    assert len(fc.DcBits(9, 256, "cpu", 2, 1).step_words(5)[0]) == 1
    with pytest.raises(ValueError):
        fc.DcBits(9, 256, "cpu", 1, 3)


def test_random_actions_follow_the_converter():
    """Finite ExtExDc takes both channels from one word (bits 0-1, 2-3),
    a finite 2QC min(floor(3 u), 2), a continuous 1QC/2QC [0, 1)."""
    w = torch.tensor([0b1110, 0b0111, 0xFFFFFFFF, 0], dtype=torch.int64)
    ext = dcf.DcConsts(gt.make_functional("Finite-CC-ExtExDc-v0", device="cpu"))
    a0, a1 = dcf.dc_sample_actions(ext, [w])
    assert a0.tolist() == [2, 3, 3, 0] and a1.tolist() == [3, 1, 3, 0]
    two = dcf.DcConsts(gt.make_functional("Finite-CC-PermExDc-v0", device="cpu",
                                          converter=tcv.finite_two_quadrant_converter()))
    (a,) = dcf.dc_sample_actions(two, [w])
    assert a.tolist() == [0, 0, 2, 0]
    one = dcf.DcConsts(gt.make_functional("Cont-CC-PermExDc-v0", device="cpu",
                                          converter=tcv.cont_one_quadrant_converter()))
    (a,) = dcf.dc_sample_actions(one, [w])
    assert float(a.min()) >= 0.0 and float(a.max()) < 1.0


@pytest.mark.parametrize("kind", ["Finite-1QC", "Finite-2QC", "Finite-4QC", "Cont-1QC",
                                  "Cont-2QC", "Cont-4QC"])
def test_kernel_converter_laws_match_the_env_converters(kind):
    """The kernels' per-channel fraction and supply current against the
    env converter's u_frac and i_sup, over every finite action or duties
    beyond the box, at currents of both signs and zero."""
    action, q = kind.split("-")
    factory = {"1QC": "one", "2QC": "two", "4QC": "four"}[q]
    conv = getattr(tcv, f"{action.lower()}_{factory}_quadrant_converter")()
    finite = action == "Finite"
    if finite:
        n = conv.action_space[1]
        a = torch.arange(n, dtype=torch.int32).repeat_interleave(3)
        i = torch.tensor([-3.0, 0.0, 2.0]).repeat(n)
        bs, env_a = (conv.bridge_actions(a) if conv.bridge_actions else None), a
    else:
        a = torch.linspace(-1.5, 1.5, 24)
        i = torch.tensor([-3.0, 0.0, 2.0]).repeat(8)
        bs, env_a = None, a[:, None]
    code = dcf.CONV_CODES[q]
    torch.testing.assert_close(dcf.dc_conv_frac(finite, code, a, i),
                               conv.u_frac(bs, env_a, i[:, None])[:, 0], rtol=0, atol=2e-7)
    torch.testing.assert_close(dcf.dc_conv_i_sup(finite, code, a, i),
                               conv.i_sup(bs, env_a, i[:, None]), rtol=0, atol=1e-6)


def test_state_from_numpy_carries_a_dc_state():
    """A JAX ExtExDc SC state 30 steps into an episode (four int32 bridge
    columns), carried over: the next 20 steps agree."""
    env_id = "Finite-SC-ExtExDc-v0"
    jenv, tenv = const_envs(env_id)
    N = 8
    rng = np.random.default_rng(1)
    acts = rng.integers(0, 4, (50, N, 2)).astype(np.int32)
    js, _ = jax.vmap(jenv.reset)(jax.random.split(jax.random.PRNGKey(2), N))
    step = jax.jit(jax.vmap(jenv.step))
    for t in range(30):
        js, *_ = step(js, jnp.asarray(acts[t]))
    assert np.asarray(js.phys.conv_state).shape == (N, 4)
    fields = dict(ode_state=js.phys.ode_state, conv_state=js.phys.conv_state,
                  sup_state=js.phys.sup_state, t=js.phys.t, k=js.phys.k,
                  refs=jax.tree.map(np.asarray, js.refs), system_state=js.system_state,
                  step_count=js.step_count, episode=js.episode)
    ts = gt.state_from_numpy(jax.tree.map(np.asarray, fields), "cpu")
    for t in range(30, 50):
        js, jo, jr, _ = step(js, jnp.asarray(acts[t]))
        ts, to, tr, _ = tenv.step(ts, torch.as_tensor(acts[t]))
        np.testing.assert_allclose(ts.phys.ode_state.numpy(), np.asarray(js.phys.ode_state),
                                   **ENV_TOL)
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-4, atol=1e-5)
        np.testing.assert_array_equal(ts.phys.conv_state.numpy(), np.asarray(js.phys.conv_state))


def test_env_without_device_raises_without_a_gpu():
    """The default device is cuda, also for a directly built env: without a
    GPU and without device= the constructor raises, never falls back."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    cpu = gt.make_functional("Finite-CC-PermExDc-v0", device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gt.ElectricMotorEnvironment(cpu.physical_system, cpu.reference_generator)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gt.make_functional("Finite-CC-PermExDc-v0")
