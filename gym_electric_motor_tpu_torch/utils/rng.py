"""Counter-based random streams of the general env path.

Counterpart of ``gym_electric_motor_tpu/utils/rng.py``.  A per-env key is
two 32-bit words (an ``(N, 2)`` int64 tensor); every consumer turns its key
into one block of words with a single Philox4x32-10 pass
(``philox_words``), takes the first two words as its successor key and
shapes the rest with the inverse-CDF transforms below, as the JAX package
does with threefry.  The streams differ from ``jax.random``'s; the
distributions are the same, which is what the statistical tests check.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.fused_common import philox4x32, seed_key

# Largest float32 strictly below 1: keeps the inverse CDFs finite at the
# closed end of the [0, 1) uniform range (the guard jax.random uses).
_ONE_MINUS = float(np.nextafter(np.float32(1), np.float32(0)))
_SQRT2 = float(np.float32(np.sqrt(2.0)))

# Fourth counter word of a Philox call: keeps the streams of the different
# consumers of one key apart.
TAG_SPLIT = 1    # env keys from a root seed
TAG_RESET = 2    # the reset block of an env key
TAG_ADVANCE = 3  # the per-step block of a reference-generator key


def philox_words(key, n: int, tag: int):
    """``(N, n)`` int64 block of 32-bit words from ``(N, 2)`` keys: Philox
    calls with counters ``(j, 0, 0, tag)``, j = 0, 1, ..."""
    n_calls = -(-n // 4)
    j = torch.arange(n_calls, dtype=torch.int64, device=key.device)[None, :]
    zero = torch.zeros((), dtype=torch.int64, device=key.device)
    words = philox4x32(j, zero, zero, zero + tag, key[:, 0:1], key[:, 1:2])
    return torch.stack(words, dim=-1).reshape(key.shape[0], 4 * n_calls)[:, :n]


def env_keys(seed: int, n_envs: int, device):
    """``(n_envs, 2)`` per-env keys from one integer seed."""
    k0, k1 = seed_key(seed)
    i = torch.arange(n_envs, dtype=torch.int64, device=device)
    zero = torch.zeros((), dtype=torch.int64, device=device)
    w0, w1, _w2, _w3 = philox4x32(i, zero, zero, zero + TAG_SPLIT, k0, k1)
    return torch.stack([w0, w1], dim=-1)


def bits_to_uniform(bits):
    """32-bit words -> float32 uniforms in [0, 1) (the mantissa map of
    ``jax.random.uniform``: the top 23 bits, exact)."""
    return (bits >> 9).to(torch.float32) * (1.0 / (1 << 23))


def split_and_uniforms(key, n: int, tag: int = TAG_ADVANCE):
    """``(next_key (N, 2), u (N, n))`` from ONE Philox pass."""
    words = philox_words(key, n + 2, tag)
    return words[:, :2], bits_to_uniform(words[:, 2:])


def normal_from_u(u):
    """Standard normal from uniform [0, 1) (inverse CDF, like
    ``jax.random.normal``)."""
    x = torch.clamp(2.0 * u - 1.0, -_ONE_MINUS, _ONE_MINUS)
    return _SQRT2 * torch.erfinv(x)
