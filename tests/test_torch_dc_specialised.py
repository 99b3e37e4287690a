"""The port's specialised DC builders (``ops/fused_dc.py``:
Finite-CC-PermExDc rollout and recorder, Cont-SC-SeriesDc / ShuntDc) against
the JAX package's Pallas kernels, run in interpret mode on the CPU as
tests/test_pallas_rollout.py and tests/test_pallas_record.py run them.

* Buffer modes: the same numpy action buffer through both packages' builders,
  rtol 1e-5 / atol 1e-4 (tests/test_pallas_rollout.py:71-87, :645-677;
  tests/test_pallas_record.py:132-158, per step).
* Random modes, replay: the plain version driven by a copy of the
  interpret-mode xorshift (pallas_common.py:885-901) in the JAX kernels'
  draw order (one Box-Muller pair at even steps; the recorder a fresh pair
  each step and a reseed at every chunk, pallas_dc.py:293-296) against the
  JAX interpret kernel: rtol 1e-4 / atol 1e-4 (the random-mode rule of
  ``chip_smoke.py``) in at least 99% of envs.  XLA on the CPU contracts
  multiply-adds into FMAs, so a current that crosses zero inside an RK4
  step can differ by a few ulps of the stage values (3e-6 A).
* Random modes, in distribution: the Wiener state, mean reward and
  termination rate against the XLA env, within the JAX suite's bounds
  (tests/test_pallas_rollout.py:210-232, :680-697), at 1000 steps.
* Each builder raises where the JAX builder raises, with the same type.

The CUDA kernels run only on a GPU: tests/test_torch_cuda_kernels.py and
``chip_smoke.py`` hold them against these plain versions there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_electric_motor_tpu as gemx
from gym_electric_motor_tpu.ops import pallas_rollout as jpr
import gym_electric_motor_tpu_torch as gt
from gym_electric_motor_tpu_torch.ops import fused_dc as fd
from gym_electric_motor_tpu_torch.ops import fused_rollout as fr
from test_pallas_rollout import _check_wiener_state, _xla_random_rollout

torch.set_num_threads(1)

BUF = dict(rtol=1e-5, atol=1e-4)
SC_IDS = [("Cont-SC-SeriesDc-v0", 2), ("Cont-SC-ShuntDc-v0", 3)]


def _envs(env_id, **kw):
    return gemx.make_functional(env_id, **kw), gt.make_functional(env_id, device="cpu", **kw)


def _planes(rng, bounds, rows=1):
    return [rng.uniform(lo, hi, (rows, 128)).astype(np.float32) for lo, hi in bounds]


class XorshiftBits:
    """Test-only copy of the interpret-mode bit source (``_make_rng``,
    pallas_common.py:885-901): one xorshift32 state per lane of the
    ``(rows, 128)`` rng scratch; a draw steps the whole scratch and returns
    its first ``n`` lanes.  Subclasses consume it in a kernel's order."""

    def __init__(self, seed, n, rows=None):
        self.n = n
        self.rows = rows or n // 128
        self.reseed(seed)

    def reseed(self, seed):
        flat = np.arange(self.rows * 128, dtype=np.uint32)
        with np.errstate(over="ignore"):
            v = ((flat + np.uint32(1)) * np.uint32(2654435761)) ^ (
                np.uint32(seed) * np.uint32(0x9E3779B9))
        self.s = v | np.uint32(1)

    def next(self, n=None):
        s = self.s
        s = s ^ (s << np.uint32(13))
        s = s ^ (s >> np.uint32(17))
        s = s ^ (s << np.uint32(5))
        self.s = s
        return torch.as_tensor(s[: n or self.n].astype(np.int64))


class DcXorshift(XorshiftBits):
    """The draw order of the PermExDc and DC SC rollouts (pallas_dc.py:
    121-171, :487-531): init (value, length, sigma); per step the action,
    at even steps the Box-Muller pair, then length, sigma and reset value.
    ``pair_every_step``: the recorder's fresh pair each step, and with
    ``chunk`` its reseed ``seed * n_chunks + pid`` at every chunk, the
    initial draws in the first chunk only."""

    def __init__(self, seed, n, pair_every_step=False, chunk=None, n_steps=None):
        super().__init__(seed * (n_steps // chunk) if chunk else seed, n)
        self.seed, self.every, self.chunk = seed, pair_every_step, chunk
        self.n_chunks = n_steps // chunk if chunk else 1

    def init_words(self):
        return {"value": self.next(), "len": self.next(), "sig": self.next()}

    def step_words(self, t):
        if self.chunk and t and t % self.chunk == 0:
            self.reseed(self.seed * self.n_chunks + t // self.chunk)
        w = {"action": self.next()}
        pair = self.every or t % 2 == 0
        w["u1"], w["u2"] = (self.next(), self.next()) if pair else (None, None)
        w["len"], w["sig"], w["reset"] = self.next(), self.next(), self.next()
        return w


def _replay_share(got, want, n):
    ok = np.ones(n, bool)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape
        ok &= np.isclose(g, w, rtol=1e-4, atol=1e-4).reshape(-1, n).all(axis=0)
    return ok.mean()


# ---------------------------------------------------------------------------
# buffer modes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("builder", ["rollout", "record"])
def test_permex_buffer_matches_jax_interpret(builder):
    jenv, tenv = _envs("Finite-CC-PermExDc-v0")
    N, T = 128, 48
    rng = np.random.default_rng(1)
    acts = rng.integers(0, 4, (T, 1, 128)).astype(np.int32)
    (i0,) = _planes(rng, [(-100, 100)])
    if builder == "rollout":
        want = jpr.make_fused_permex_rollout(jenv, T, N, action_mode="buffer", interpret=True)(
            jnp.asarray(i0), jnp.asarray(acts))
        got = fr.make_fused_permex_rollout(tenv, T, N, action_mode="buffer")(
            torch.as_tensor(i0), torch.as_tensor(acts))
    else:
        want = jpr.make_fused_permex_record_rollout(jenv, T, N, chunk=8, action_mode="buffer",
                                                    interpret=True)(
            jnp.asarray(i0), jnp.asarray(acts))
        got = fr.make_fused_permex_record_rollout(tenv, T, N, chunk=8, action_mode="buffer")(
            torch.as_tensor(i0), torch.as_tensor(acts))
        assert got.shape == (T, 1, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BUF)


@pytest.mark.parametrize("env_id,n_state", SC_IDS)
def test_dc_sc_buffer_matches_jax_interpret(env_id, n_state):
    jenv, tenv = _envs(env_id)
    N, T = 128, 60
    rng = np.random.default_rng(4)
    acts = rng.uniform(-1.0, 1.0, (T, 1, 128)).astype(np.float32)
    start = _planes(rng, [(0, 100)] + [(-5, 5)] * (n_state - 1))
    want = jpr.make_fused_dc_sc_rollout(jenv, T, N, action_mode="buffer", interpret=True)(
        *map(jnp.asarray, start), jnp.asarray(acts))
    got = fr.make_fused_dc_sc_rollout(tenv, T, N, action_mode="buffer")(
        *map(torch.as_tensor, start), torch.as_tensor(acts))
    assert len(got) == len(want) == n_state
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **BUF)


# ---------------------------------------------------------------------------
# random modes: the JAX interpret kernels' bits replayed
# ---------------------------------------------------------------------------


def test_permex_rollout_replays_jax_interpret_kernel():
    jenv, tenv = _envs("Finite-CC-PermExDc-v0")
    N, T, seed = 256, 60, 3
    start = _planes(np.random.default_rng(2), [(-100, 100)], rows=2)
    want = jpr.make_fused_permex_rollout(jenv, T, N, interpret=True)(seed, jnp.asarray(start[0]))
    got = fd.permex_rollout_random_plain(fd.PermexConsts(tenv), seed, torch.as_tensor(start[0]),
                                         T, bits=DcXorshift(seed, N))
    assert _replay_share(got, want, N) >= 0.99


def test_permex_record_replays_jax_interpret_kernel():
    jenv, tenv = _envs("Finite-CC-PermExDc-v0")
    N, T, seed, chunk = 256, 48, 9, 8
    z = np.zeros((2, 128), np.float32)
    want = jpr.make_fused_permex_record_rollout(jenv, T, N, chunk=chunk, interpret=True)(
        seed, jnp.asarray(z))
    got = fd.permex_record_random_plain(fd.PermexConsts(tenv), seed, torch.as_tensor(z), T,
                                        bits=DcXorshift(seed, N, True, chunk, T))
    assert got[2].dtype == torch.int32
    assert _replay_share(got, want, N) >= 0.99


def test_permex_record_default_chunk_is_the_jax_one():
    """The default chunk (pallas_dc.py:240-246) decides the JAX recorder's
    reseeds, so the replay needs it: about 12 * 128 / R steps, snapped down
    to a divisor of n_steps."""
    tenv = gt.make_functional("Finite-CC-PermExDc-v0", device="cpu")
    for n_envs, n_steps, want in ((256, 48, 48), (16384, 1024, 8), (4096, 100, 25), (512, 7, 7)):
        roll = fr.make_fused_permex_record_rollout(tenv, n_steps, n_envs)
        assert roll.chunk == want


@pytest.mark.parametrize("env_id,n_state", SC_IDS)
def test_dc_sc_rollout_replays_jax_interpret_kernel(env_id, n_state):
    jenv, tenv = _envs(env_id)
    N, T, seed = 256, 60, 5
    z = np.zeros((2, 128), np.float32)
    want = jpr.make_fused_dc_sc_rollout(jenv, T, N, interpret=True)(seed, *[jnp.asarray(z)] * n_state)
    got = fd.dc_sc_rollout_random_plain(fd.DcScConsts(tenv), seed,
                                        [torch.as_tensor(z)] * n_state, T,
                                        bits=DcXorshift(seed, N))
    assert len(got) == n_state + 6
    assert _replay_share(got, want, N) >= 0.99


# ---------------------------------------------------------------------------
# random modes: statistics against the XLA env (Philox bits)
# ---------------------------------------------------------------------------

N_STAT, T_STAT = 256, 1000


def test_permex_statistics_match_xla_env():
    tenv = gt.make_functional("Finite-CC-PermExDc-v0", device="cpu")
    z = torch.zeros((2, 128))
    i, reward, terms, rv, rk, rl, rs = fr.make_fused_permex_rollout(tenv, T_STAT, N_STAT)(3, z)
    c = fd.PermexConsts(tenv)
    _check_wiener_state(rv.numpy(), rk.numpy(), rl.numpy(), rs.numpy(), c.f["margin"], 1e-2, 1e-1)
    mean_r = float(reward.sum()) / (N_STAT * T_STAT)
    term_rate = float(terms.sum()) / (N_STAT * T_STAT)
    xla_mean_r, xla_term_rate = _xla_random_rollout("Finite-CC-PermExDc-v0", N_STAT, T_STAT)
    assert abs(mean_r - xla_mean_r) < 0.08
    assert abs(term_rate - xla_term_rate) < max(0.5 * max(term_rate, xla_term_rate), 2e-3)
    assert np.all(np.isfinite(i.numpy()))


@pytest.mark.parametrize("env_id,n_state,sig_lo,sig_hi", [
    ("Cont-SC-SeriesDc-v0", 2, 1e-3, 2e-2), ("Cont-SC-ShuntDc-v0", 3, 1e-3, 3e-2)])
def test_dc_sc_statistics_match_xla_env(env_id, n_state, sig_lo, sig_hi):
    tenv = gt.make_functional(env_id, device="cpu")
    z = torch.zeros((2, 128))
    out = fr.make_fused_dc_sc_rollout(tenv, T_STAT, N_STAT)(3, *[z] * n_state)
    reward, terms, rv, rk, rl, rs = out[n_state:]
    c = fd.DcScConsts(tenv)
    _check_wiener_state(rv.numpy(), rk.numpy(), rl.numpy(), rs.numpy(), c.f["margin"], sig_lo,
                        sig_hi)
    assert float(rv.min()) >= 0.0
    mean_r = float(reward.sum()) / (N_STAT * T_STAT)
    term_rate = float(terms.sum()) / (N_STAT * T_STAT)
    xla_mean_r, xla_term_rate = _xla_random_rollout(env_id, N_STAT, T_STAT)
    assert abs(mean_r - xla_mean_r) < 0.08
    assert abs(term_rate - xla_term_rate) < max(0.5 * max(term_rate, xla_term_rate), 2e-3)
    assert all(np.all(np.isfinite(x.numpy())) for x in out[:n_state])


# ---------------------------------------------------------------------------
# the recorder and the rollout, wrappers, the builders' checks
# ---------------------------------------------------------------------------


def test_permex_record_is_internally_consistent():
    """tests/test_pallas_record.py:161-183 on the plain recorder."""
    tenv = gt.make_functional("Finite-CC-PermExDc-v0", device="cpu")
    c = fd.PermexConsts(tenv)
    i_lim = 1.0 / c.f["inv_i_lim"]
    N, T = 256, 256
    i, ref, act, rew, done = (x.numpy() for x in fr.make_fused_permex_record_rollout(
        tenv, T, N)(9, torch.zeros((2, 128))))
    assert act.min() >= 0 and act.max() <= 3
    assert np.all(np.abs(ref) <= c.f["margin"] + 1e-6) and np.std(ref) > 1e-3
    ok = done < 0.5
    np.testing.assert_allclose(rew[ok], -0.5 * np.abs(i[ok] / i_lim - ref[ok]), rtol=1e-5,
                               atol=1e-6)
    assert done.sum() > 0
    np.testing.assert_allclose(rew[~ok], -10.0, rtol=1e-6)
    assert np.all(i[~ok] == 0.0)


def test_wrappers_take_plain_path_on_cpu_and_validate():
    tenv = gt.make_functional("Finite-CC-PermExDc-v0", device="cpu")
    c = fd.PermexConsts(tenv)
    z = torch.zeros((1, 128))
    fd.reset_launches()
    out = fd.permex_rollout_random(c, 1, z, 5)
    for a, b in zip(out, fd.permex_rollout_random_plain(c, 1, z, 5)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert all(v == 0 for v in fd.LAUNCHES.values()) and set(fd.LAUNCHES) == set(fd.KERNELS)
    with pytest.raises(TypeError):
        fd.permex_rollout_random(c, 1, z.double(), 5)
    with pytest.raises(ValueError):
        fd.permex_rollout_random(c, 1, torch.zeros((2, 64)), 5)
    with pytest.raises(TypeError):
        fd.permex_rollout_buffer(c, z, torch.zeros((5, 1, 128)))
    with pytest.raises(ValueError):
        fr.make_fused_permex_rollout(tenv, 6, 128, action_mode="buffer")(
            z, torch.zeros((5, 1, 128), dtype=torch.int32))
    sc = fd.DcScConsts(gt.make_functional("Cont-SC-ShuntDc-v0", device="cpu"))
    with pytest.raises(ValueError):
        fd.dc_sc_rollout_random(sc, 1, [z, z], 5)


def _raises(jax_build, torch_build, env_id, n_envs=256, **kw):
    jenv, tenv = _envs(env_id, **kw)
    with pytest.raises(Exception) as jerr:
        jax_build(jenv, 8, n_envs, interpret=True)
    with pytest.raises(type(jerr.value)):
        torch_build(tenv, 8, n_envs)
    return type(jerr.value)


@pytest.mark.parametrize("name,env_id,n_envs,kw,want", [
    ("permex", "Finite-CC-PermExDc-v0", 256, dict(constraints=()), NotImplementedError),
    ("permex", "Finite-CC-PermExDc-v0", 200, {}, AssertionError),
    ("permex", "Cont-SC-PermExDc-v0", 256, {}, NotImplementedError),
    ("permex_record", "Finite-CC-PermExDc-v0", 256, dict(constraints=()), NotImplementedError),
    ("permex_record", "Finite-CC-PermExDc-v0", 100, {}, AssertionError),
    ("dc_sc", "Cont-SC-ShuntDc-v0", 256, dict(constraints=()), NotImplementedError),
    ("dc_sc", "Cont-SC-SeriesDc-v0", 64, {}, AssertionError),
    ("dc_sc", "Cont-SC-PermExDc-v0", 256, {}, AssertionError),
    ("dc_sc", "Cont-CC-SeriesDc-v0", 256, {}, NotImplementedError),
])
def test_builders_raise_where_jax_raises(name, env_id, n_envs, kw, want):
    jb, tb = {"permex": (jpr.make_fused_permex_rollout, fr.make_fused_permex_rollout),
              "permex_record": (jpr.make_fused_permex_record_rollout,
                                fr.make_fused_permex_record_rollout),
              "dc_sc": (jpr.make_fused_dc_sc_rollout, fr.make_fused_dc_sc_rollout)}[name]
    assert _raises(jb, tb, env_id, n_envs, **kw) is want


@pytest.mark.parametrize("builder", ["rollout", "record"])
@pytest.mark.parametrize("factory", ["finite_two_quadrant_converter",
                                     "cont_four_quadrant_converter"])
def test_permex_rejects_a_converter_it_does_not_bake(builder, factory):
    """The PermExDc kernels step the DC family's physics with the Finite-4QC
    table baked in: another converter raises, where the JAX builder would
    run the 4QC table on it regardless."""
    from gym_electric_motor_tpu_torch.models import converters as tcv

    tenv = gt.make_functional("Finite-CC-PermExDc-v0", device="cpu",
                              converter=getattr(tcv, factory)(1e-5))
    build = {"rollout": fr.make_fused_permex_rollout,
             "record": fr.make_fused_permex_record_rollout}[builder]
    with pytest.raises(NotImplementedError, match="4QC"):
        build(tenv, 8, 256)


@pytest.mark.parametrize("env_id,builder", [
    ("Finite-CC-PermExDc-v0", "make_fused_permex_rollout"),
    ("Cont-TC-SCIM-v0", "make_fused_scim_rollout"),
    ("Finite-CC-EESM-v0", "make_fused_eesm_rollout"),
    ("Cont-CC-DFIM-v0", "make_fused_dfim_rollout"),
])
def test_builders_ignore_the_env_reference_generator(env_id, builder):
    """A specialised builder bakes its own references and reward, so it
    builds, as the JAX builder does, for an env whose reference the
    universal kernels do not fuse: the family constants it steps with read
    the physical system alone (``physics_only=True``)."""
    from gym_electric_motor_tpu import references as jrg
    from gym_electric_motor_tpu_torch import references as trg

    jenv = gemx.make_functional(env_id, reference_generator=jrg.ReferenceSpec(
        [jrg.ConstReference("omega", 0.1)]))
    tenv = gt.make_functional(env_id, device="cpu", reference_generator=trg.ReferenceSpec(
        [trg.ConstReference("omega", 0.1)]))
    getattr(jpr, builder)(jenv, 8, 256, interpret=True)
    with pytest.raises(NotImplementedError):
        fr.make_fused_rollout(tenv, 8, 256)
    out = getattr(fr, builder)(tenv, 8, 256)(3, *[torch.zeros((2, 128))] * {
        "make_fused_permex_rollout": 1, "make_fused_scim_rollout": 4,
        "make_fused_eesm_rollout": 4, "make_fused_dfim_rollout": 5}[builder])
    assert all(bool(torch.isfinite(x).all()) for x in out)


@pytest.mark.parametrize("env_id,n_state", [("Finite-CC-PermExDc-v0", 1)] + SC_IDS)
def test_buffer_matches_the_universal_buffer_kernels(env_id, n_state):
    """On the same id and buffer, the specialised buffer rollout (and the
    PermExDc recorder per step) against the universal DC kernels' plain
    versions, reached through the dispatch, at rtol 1e-5 / atol 1e-4: the
    two compute the same physics with their constants rounded in another
    order."""
    from gym_electric_motor_tpu_torch.ops.fused_record import make_fused_record_rollout

    tenv = gt.make_functional(env_id, device="cpu")
    N, T = 128, 64
    rng = np.random.default_rng(11)
    finite = env_id.startswith("Finite")
    acts = torch.as_tensor(rng.integers(0, 4, (T, 1, 128)).astype(np.int32) if finite
                           else rng.uniform(-1, 1, (T, 1, 128)).astype(np.float32))
    bounds = [(-100, 100)] if finite else [(0, 100)] + [(-5, 5)] * (n_state - 1)
    start = [torch.as_tensor(x) for x in _planes(rng, bounds)]
    universal = fr.make_fused_rollout(tenv, T, N, action_mode="buffer")(*start, acts)
    if finite:
        got = fr.make_fused_permex_rollout(tenv, T, N, action_mode="buffer")(start[0], acts)
        torch.testing.assert_close(got, universal[0], **BUF)
        rec = fr.make_fused_permex_record_rollout(tenv, T, N, action_mode="buffer")(start[0], acts)
        want = make_fused_record_rollout(tenv, T, N, action_mode="buffer")(start[0], acts)["i"]
        torch.testing.assert_close(rec, want, **BUF)
    else:
        got = fr.make_fused_dc_sc_rollout(tenv, T, N, action_mode="buffer")(*start, acts)
        for g, w in zip(got, universal):
            torch.testing.assert_close(g, w, **BUF)


def test_permex_ring_layout_is_the_kernels_ring():
    """permex_ring_layout, computed without the library, is the ring of
    csrc/fused_permex.cu's random rollout (PermexRing, 5 words a step): 4
    consumer warps, P producer warps per consumer warp, two slots of K
    steps, each producer's steps pairing an even step with the odd one that
    takes its sine half."""
    from pathlib import Path

    lay = fd.permex_ring_layout()
    K, P = fd.PERMEX_RING
    assert lay == {"consumer_warps": 4, "producer_warps": 4 * P, "K": K, "slots": 2, "words": 5,
                   "smem_bytes": 2 * K * 5 * 128 * 4, "design": "warp-specialised"}
    assert (K // P) % 2 == 0 and lay["smem_bytes"] <= 227 * 1024
    source = (Path(fd.__file__).resolve().parent.parent / "csrc" / "fused_permex.cu").read_text()
    assert f"using PermexRing = RingShape<{K}, {P}>;" in source
    assert f"constexpr int kPermexWords = {fd.PERMEX_RING_WORDS};" in source


def test_permex_record_ring_layout_is_the_kernels_ring():
    """permex_record_ring_layout, computed without the library, is the ring
    of csrc/fused_permex.cu's random recorder (PermexRecordRing, one of K in
    {4, 8} x P in {1, 2}), with the rollout's 5 words a step: 4 consumer
    warps, P producer warps per consumer warp, two slots of K steps, inside
    the default 48 KB of dynamic shared memory; the launch takes the ring
    kernel and the recorder's own draws, a fresh pair each step."""
    from pathlib import Path

    lay = fd.permex_record_ring_layout()
    K, P = fd.PERMEX_RECORD_RING
    assert (K, P) in {(4, 1), (4, 2), (8, 1), (8, 2)}
    assert lay == {"consumer_warps": 4, "producer_warps": 4 * P, "K": K, "slots": 2, "words": 5,
                   "smem_bytes": 2 * K * 5 * 128 * 4, "design": "warp-specialised"}
    assert lay["smem_bytes"] <= 48 * 1024
    source = (Path(fd.__file__).resolve().parent.parent / "csrc" / "fused_permex.cu").read_text()
    assert f"using PermexRecordRing = RingShape<{K}, {P}>;" in source
    assert f"constexpr int kPermexWords = {fd.PERMEX_RING_WORDS};" in source
    launch = source[source.index("int permex_record_random("):]
    launch = launch[:launch.index("\n}\n")]
    assert "ring_bytes<PermexRecordRing>(kPermexWords)" in launch
    assert "permex_record_ws_kernel<<<" in launch and "permex_record_random_kernel<<<" not in launch
    kernel = source[source.index("permex_record_ws_kernel(DcConst"):]
    assert "px_record_draws(" in kernel[:kernel.index("\n}\n")]
