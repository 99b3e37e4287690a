"""The port's frame transforms and integrators against the JAX package.

The same float32 inputs, drawn with numpy from a fixed seed, go through
``gym_electric_motor_tpu.ops`` and ``gym_electric_motor_tpu_torch.ops`` on
the CPU.  Transforms: rtol 1e-6 / atol 5e-5 (1e-6 of the inputs' scale of 50):
both sides run the same float32 operations in the same order; only the
libraries' sin/cos may differ in the last ulp, and a difference near a
zero crossing is absolute.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_electric_motor_tpu.ops import integrators as jint
from gym_electric_motor_tpu.ops import transforms as jtf
from gym_electric_motor_tpu_torch.ops import integrators as tint
from gym_electric_motor_tpu_torch.ops import transforms as ttf

torch.set_num_threads(1)

RTOL, ATOL = 1e-6, 5e-5


def _inputs(seed, n, width):
    rng = np.random.default_rng(seed)
    x = rng.normal(scale=50.0, size=(n, width)).astype(np.float32)
    eps = rng.uniform(-20.0, 20.0, size=n).astype(np.float32)
    return x, eps


@pytest.mark.parametrize("name,width,with_eps", [
    ("abc_to_alphabeta", 3, False),
    ("alphabeta_to_abc", 2, False),
    ("rotate", 2, True),
    ("dq_to_alphabeta", 2, True),
    ("alphabeta_to_dq", 2, True),
    ("dq_to_abc", 2, True),
    ("abc_to_dq", 3, True),
])
def test_transform_matches_jax(name, width, with_eps):
    x, eps = _inputs(sum(map(ord, name)), 64, width)
    if with_eps:
        want = getattr(jtf, name)(jnp.asarray(x), jnp.asarray(eps))
        got = getattr(ttf, name)(torch.as_tensor(x), torch.as_tensor(eps))
    else:
        want = getattr(jtf, name)(jnp.asarray(x))
        got = getattr(ttf, name)(torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_wrap_angle_matches_jax(seed):
    rng = np.random.default_rng(seed)
    eps = np.concatenate([rng.uniform(-100.0, 100.0, 256),
                          [0.0, np.pi, -np.pi, 2 * np.pi, 3 * np.pi]]).astype(np.float32)
    want = np.asarray(jtf.wrap_angle(jnp.asarray(eps)))
    got = ttf.wrap_angle(torch.as_tensor(eps)).numpy()
    # fmod is exact on both sides, so the wrap is too
    np.testing.assert_array_equal(got, want)
    assert np.all(got > -np.pi - 1e-6) and np.all(got <= np.pi + 1e-6)


def test_matrix_constants_match_jax():
    np.testing.assert_allclose(ttf.T23.numpy(), np.asarray(jtf.T23), rtol=1e-7)
    np.testing.assert_allclose(ttf.T32.numpy(), np.asarray(jtf.T32), rtol=1e-7)


A = np.array([[-12.0, 4.0], [2.0, -9.0]], dtype=np.float32)
B = np.array([1.5, -2.0], dtype=np.float32)


def _rhs_j(t, y, u):
    return y @ jnp.asarray(A).T + jnp.asarray(B) * u[:, None]


def _rhs_t(t, y, u):
    return y @ torch.as_tensor(A).T + torch.as_tensor(B) * u[:, None]


@pytest.mark.parametrize("kind", ["euler", "rk4"])
@pytest.mark.parametrize("substeps", [1, 3])
def test_integrator_matches_jax(kind, substeps):
    rng = np.random.default_rng(substeps)
    y = rng.normal(size=(32, 2)).astype(np.float32)
    u = rng.normal(size=32).astype(np.float32)
    jstep = jint.make_integrator(kind, substeps)
    tstep = tint.make_integrator(kind, substeps)
    yj, yt = jnp.asarray(y), torch.as_tensor(y)
    for _ in range(20):
        yj = jstep(_rhs_j, yj, 0.0, 1e-2, jnp.asarray(u))
        yt = tstep(_rhs_t, yt, 0.0, 1e-2, torch.as_tensor(u))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5, atol=1e-6)


def test_unported_solver_raises():
    with pytest.raises(NotImplementedError, match="slice 3"):
        tint.make_integrator("rk45")
