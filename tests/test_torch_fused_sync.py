"""The plain PyTorch versions of the port's fused PMSM kernels against the
JAX package's Pallas kernels (run in interpret mode on the CPU, as
tests/test_pallas_rollout.py runs them), and the Philox bit source.

* Buffer modes: the same numpy action buffer through
  ``make_fused_pmsm_rollout`` / ``make_fused_pmsm_record_rollout`` of both
  packages, rtol 1e-5 / atol 1e-4 (A, rad): the tolerance of
  tests/test_pallas_rollout.py:54-59 (float32 RK4 in the same order; the
  libraries' sin/cos differ in the last ulp).
* Random mode, statistics: the checks of
  ``test_fused_pmsm_stochastic_stats`` (tests/test_pallas_rollout.py:185-207).
* Random mode, replay: the plain random mode driven by a copy of the
  interpret-mode xorshift bit source (pallas_common.py:885-901), consuming
  the bits in the kernel's (2R, 128) order, against the JAX interpret
  kernel: rtol 1e-4 in at least 99% of envs (float32 transcendentals
  differ by an ulp, which can flip a constraint threshold in an env).
* Philox4x32-10 against a pure-Python reference and Random123's known
  answers.

The CUDA kernels themselves run only on a GPU: ``chip_smoke.py`` and
tests/test_torch_cuda_kernels.py hold them against these plain versions
there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_electric_motor_tpu as gemx
from gym_electric_motor_tpu.ops.pallas_rollout import (
    make_fused_pmsm_record_rollout as jax_record,
    make_fused_pmsm_rollout as jax_rollout,
)
import gym_electric_motor_tpu_torch as gt
from gym_electric_motor_tpu_torch.ops import fused_common as fc
from gym_electric_motor_tpu_torch.ops import fused_sync as fs
from test_pallas_rollout import _check_wiener_state, _xla_random_rollout

torch.set_num_threads(1)

ENV_IDS = ["Finite-CC-PMSM-v0", "Finite-CC-SynRM-v0"]
BUF = dict(rtol=1e-5, atol=1e-4)


def _envs(env_id):
    return gemx.make_functional(env_id), gt.make_functional(env_id, device="cpu")


def _start(R, seed):
    rng = np.random.default_rng(seed)
    i_sd = rng.uniform(-50, 50, (R, 128)).astype(np.float32)
    i_sq = rng.uniform(-50, 50, (R, 128)).astype(np.float32)
    eps = rng.uniform(0, 2 * np.pi, (R, 128)).astype(np.float32)
    return i_sd, i_sq, eps


def _assert_angle(got, want):
    d = np.remainder(got - want, 2 * np.pi)
    np.testing.assert_allclose(np.minimum(d, 2 * np.pi - d), 0.0, atol=1e-4)


@pytest.mark.parametrize("env_id", ENV_IDS)
@pytest.mark.parametrize("builder", ["rollout", "record"])
def test_buffer_mode_matches_jax_interpret(env_id, builder):
    jenv, tenv = _envs(env_id)
    N, T = 128, 40
    acts = np.random.default_rng(5).integers(0, 8, (T, 1, 128)).astype(np.int32)
    start = _start(1, 6)
    jb, tb = (jax_rollout, fs.make_fused_pmsm_rollout) if builder == "rollout" else \
        (jax_record, fs.make_fused_pmsm_record_rollout)
    want = jb(jenv, T, N, action_mode="buffer", interpret=True)(
        *map(jnp.asarray, start), jnp.asarray(acts))
    got = tb(tenv, T, N, action_mode="buffer")(*map(torch.as_tensor, start), torch.as_tensor(acts))
    assert len(got) == len(want)
    for j, (g, w) in enumerate(zip(got, want)):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape
        if j == 2:
            _assert_angle(g, w)
        else:
            np.testing.assert_allclose(g, w, **BUF)


def test_random_mode_statistics_match_jax_env():
    """``test_fused_pmsm_stochastic_stats`` for the plain random mode."""
    N, T = 256, 1000
    tenv = gt.make_functional("Finite-CC-PMSM-v0", device="cpu")
    z = torch.zeros((2, 128))
    i_sd, i_sq, eps, reward, terms, rv, rk, rl, rs = fs.make_fused_pmsm_rollout(tenv, T, N)(3, z, z, z)
    assert rv.shape == (4, 128)
    ps = tenv.physical_system
    names = list(ps.state_names)
    margin = float(ps.nominal_state[names.index("i_sd")] / ps.limits[names.index("i_sd")])
    _check_wiener_state(rv.numpy(), rk.numpy(), rl.numpy(), rs.numpy(), margin, 1e-3, 1e-1)
    mean_r = float(reward.sum()) / (N * T)
    term_rate = float(terms.sum()) / (N * T)
    xla_mean_r, xla_term_rate = _xla_random_rollout("Finite-CC-PMSM-v0", N, T)
    assert abs(mean_r - xla_mean_r) < 0.05
    assert abs(term_rate - xla_term_rate) < max(0.5 * max(term_rate, xla_term_rate), 2e-3)
    assert np.all(np.isfinite(i_sd.numpy())) and np.all(np.isfinite(i_sq.numpy()))
    assert np.all(eps.numpy() >= 0.0) and np.all(eps.numpy() < 2 * np.pi)


class _XorshiftBits:
    """Test-only copy of the interpret-mode bit source of
    ``pallas_common._make_rng`` (:885-901): one xorshift32 state per lane
    of a (2R, 128) plane; a draw steps the whole plane and returns its
    first rows.  Consumed in the JAX kernel's order."""

    def __init__(self, seed, n):
        flat = np.arange(2 * n, dtype=np.uint32)
        with np.errstate(over="ignore"):
            v = ((flat + np.uint32(1)) * np.uint32(2654435761)) ^ (np.uint32(seed) * np.uint32(0x9E3779B9))
        self.s, self.n = v | np.uint32(1), n

    def _next(self):
        s = self.s
        s = s ^ (s << np.uint32(13))
        s = s ^ (s >> np.uint32(17))
        s = s ^ (s << np.uint32(5))
        self.s = s
        return torch.as_tensor(s.astype(np.int64))

    def init_words(self):
        n = self.n
        v, ln, sg = self._next(), self._next(), self._next()
        return v[:n], v[n:], ln[:n], ln[n:], sg[:n], sg[n:]

    def step_words(self, t):
        n = self.n
        a, u1, u2 = self._next()[:n], self._next()[:n], self._next()[:n]
        ln, sg, r = self._next(), self._next(), self._next()
        return a, u1, u2, ln[:n], ln[n:], sg[:n], sg[n:], r[:n], r[n:]


def test_random_mode_replays_jax_interpret_kernel():
    jenv, tenv = _envs("Finite-CC-PMSM-v0")
    N, T, seed = 256, 200, 3
    z = np.zeros((2, 128), np.float32)
    want = jax_rollout(jenv, T, N, action_mode="random", interpret=True)(seed, *[jnp.asarray(z)] * 3)
    zt = torch.zeros((2, 128))
    got = fs.pmsm_rollout_random_plain(fs.PmsmConsts(tenv), seed, zt, zt, zt, T,
                                       bits=_XorshiftBits(seed, N))
    ok = np.ones(N, bool)
    for j, (g, w) in enumerate(zip(got, want)):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape
        close = np.isclose(g, w, rtol=1e-4, atol=1e-6)
        ok &= close.reshape(-1, N).all(axis=0)
    assert ok.mean() >= 0.99


def _philox_py(ctr, key):
    """Pure-Python Philox4x32-10 (Random123's philox4x32_R, R = 10)."""
    c, k = [int(x) for x in ctr], [int(x) for x in key]
    m = 0xFFFFFFFF
    for r in range(10):
        if r:
            k = [(k[0] + 0x9E3779B9) & m, (k[1] + 0xBB67AE85) & m]
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k[0], p1 & m, (p0 >> 32) ^ c[3] ^ k[1], p0 & m]
    return c


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(ctr, key, want):
    got = fc.philox4x32(*(torch.tensor([c], dtype=torch.int64) for c in ctr), *key)
    assert tuple(int(w) for w in got) == want
    assert tuple(_philox_py(ctr, key)) == want


def test_philox_matches_python_reference():
    rng = np.random.default_rng(9)
    ctr = rng.integers(0, 2**32, (4, 64), dtype=np.uint64).astype(np.int64)
    key = rng.integers(0, 2**32, (2, 64), dtype=np.uint64).astype(np.int64)
    got = fc.philox4x32(*(torch.as_tensor(c) for c in ctr), *(torch.as_tensor(k) for k in key))
    got = np.stack([w.numpy() for w in got])
    want = np.array([_philox_py(ctr[:, i], key[:, i]) for i in range(64)]).T
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0 and got.max() < 2**32


def test_uniform_from_bits_keeps_24_bits():
    bits = torch.tensor([0, 255, 256, 0xFFFFFFFF], dtype=torch.int64)
    u = fc.uniform_from_bits(bits).numpy()
    np.testing.assert_array_equal(u, np.array([0.0, 0.0, 2.0**-24, 1.0 - 2.0**-24], np.float32))


def test_record_and_rollout_share_the_step():
    """Same seed: the recorder's last step is the rollout's final state and
    its rewards sum to the rollout's reward sums."""
    tenv = gt.make_functional("Finite-CC-SynRM-v0", device="cpu")
    N, T = 128, 60
    start = tuple(map(torch.as_tensor, _start(1, 7)))
    roll = fs.make_fused_pmsm_rollout(tenv, T, N)(11, *start)
    rec = fs.make_fused_pmsm_record_rollout(tenv, T, N)(11, *start)
    assert [tuple(x.shape) for x in rec] == [(T, 1, 128)] * 8
    assert rec[5].dtype == torch.int32 and int(rec[5].min()) >= 0 and int(rec[5].max()) <= 7
    for j in range(3):
        torch.testing.assert_close(rec[j][-1], roll[j], rtol=0, atol=0)
    torch.testing.assert_close(rec[6].sum(0), roll[3], rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(rec[7].sum(0), roll[4], rtol=0, atol=0)


def test_wrappers_take_plain_path_on_cpu_and_validate():
    tenv = gt.make_functional("Finite-CC-PMSM-v0", device="cpu")
    consts = fs.PmsmConsts(tenv)
    z = torch.zeros((1, 128))
    fs.reset_launches()
    out = fs.pmsm_rollout_random(consts, 1, z, z, z, 5)
    ref = fs.pmsm_rollout_random_plain(consts, 1, z, z, z, 5)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert all(v == 0 for v in fs.LAUNCHES.values())
    with pytest.raises(TypeError):
        fs.pmsm_rollout_random(consts, 1, z.double(), z, z, 5)
    with pytest.raises(ValueError):
        fs.pmsm_rollout_random(consts, 1, torch.zeros((2, 64)), z, z, 5)
    with pytest.raises(ValueError):
        fs.pmsm_rollout_buffer(consts, z, z, z, torch.zeros((5, 2, 128), dtype=torch.int32))
    with pytest.raises(ValueError):
        fs.pmsm_rollout_buffer(consts, z, z, z, torch.zeros((5, 1, 256), dtype=torch.int32)[:, :, ::2])
    with pytest.raises(NotImplementedError):
        fs.PmsmConsts(gt.make_functional("Finite-CC-PMSM-v0", device="cpu", constraints=()))
