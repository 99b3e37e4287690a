"""Clarke / Park reference-frame transforms on batched torch tensors.

Same semantics and operation order as ``gym_electric_motor_tpu/ops/transforms.py``:

* ``abc_to_alphabeta`` (Clarke, amplitude-invariant) and its inverse,
* ``rotate`` (Park ``q``: dq -> alpha/beta by the electrical angle),
* ``wrap_angle`` to (-pi, pi].

Every function works on the *last* axis, so a leading env dimension (or
any number of them) passes through.
"""

from __future__ import annotations

import math

import torch

_SQRT3_2 = 0.8660254037844386  # sqrt(3) / 2
TWO_PI = 2.0 * math.pi

T23 = (2.0 / 3.0) * torch.tensor([[1.0, -0.5, -0.5], [0.0, _SQRT3_2, -_SQRT3_2]])
T32 = torch.tensor([[1.0, 0.0], [-0.5, _SQRT3_2], [-0.5, -_SQRT3_2]])


def abc_to_alphabeta(abc):
    """Clarke transform. ``abc``: (..., 3) -> (..., 2)."""
    a, b, c = abc[..., 0], abc[..., 1], abc[..., 2]
    alpha = (2.0 / 3.0) * (a - 0.5 * b - 0.5 * c)
    beta = ((2.0 / 3.0) * _SQRT3_2) * (b - c)
    return torch.stack([alpha, beta], dim=-1)


def alphabeta_to_abc(alphabeta):
    """Inverse Clarke transform. ``alphabeta``: (..., 2) -> (..., 3)."""
    alpha, beta = alphabeta[..., 0], alphabeta[..., 1]
    a = alpha
    b = -0.5 * alpha + _SQRT3_2 * beta
    c = -0.5 * alpha - _SQRT3_2 * beta
    return torch.stack([a, b, c], dim=-1)


def rotate(xy, epsilon):
    """Rotate the (..., 2) vector ``xy`` by ``epsilon`` (shape ``xy.shape[:-1]``)."""
    cos = torch.cos(epsilon)
    sin = torch.sin(epsilon)
    x, y = xy[..., 0], xy[..., 1]
    return torch.stack([cos * x - sin * y, sin * x + cos * y], dim=-1)


def dq_to_alphabeta(dq, epsilon):
    """Park ``q``: dq -> alpha/beta using the electrical angle."""
    return rotate(dq, epsilon)


def alphabeta_to_dq(alphabeta, epsilon):
    """Park ``q_inv``: alpha/beta -> dq (rotation by -epsilon)."""
    return rotate(alphabeta, -epsilon)


def dq_to_abc(dq, epsilon):
    """dq -> abc (Park then inverse Clarke)."""
    return alphabeta_to_abc(rotate(dq, epsilon))


def abc_to_dq(abc, epsilon):
    """abc -> dq (Clarke then inverse Park)."""
    return rotate(abc_to_alphabeta(abc), -epsilon)


def floor_mod(x, y: float):
    """``x mod y`` with the sign of ``y``, computed from the exact ``fmod``
    and one correction (the same construction as ``jnp.mod``)."""
    r = torch.fmod(x, y)
    fix = (r != 0) & ((r < 0) != (y < 0))
    return torch.where(fix, r + y, r)


def wrap_angle(epsilon):
    """Wrap an angle to (-pi, pi] (``eps mod 2pi``, minus 2pi above pi)."""
    eps = floor_mod(epsilon, TWO_PI)
    return torch.where(eps > math.pi, eps - TWO_PI, eps)
