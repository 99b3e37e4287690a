"""Shared pieces of the fused rollout kernels: the lane constant, the
24-bit uniform map, and the Philox4x32-10 bit source.

Counterpart of ``LANE``, ``TWO_PI``, ``_uniform_from_bits`` and
``_make_rng`` in ``gym_electric_motor_tpu/ops/pallas_common.py``.  On the
TPU the bits come from the on-core PRNG (xorshift in interpret mode); here
they come from Philox4x32-10 (Salmon et al., "Parallel random numbers: as
easy as 1, 2, 3", SC'11), a counter-based generator: the bits of one draw
are a pure function of (key, counter), so the CUDA kernels
(``csrc/pmsm_step.cuh``) and the plain PyTorch versions below produce the
same bits whatever the launch geometry.

Plain version on the CPU: torch integer ops are signed and the 32x32->64
products of the Philox round overflow int64, so the words live in int64
tensors holding values in [0, 2**32) and every product is split into 16-bit
limbs (see ``_mulhilo``).
"""

from __future__ import annotations

import math

import torch

LANE = 128
TWO_PI = 2.0 * math.pi

MASK32 = 0xFFFFFFFF
PHILOX_M0 = 0xD2511F53
PHILOX_M1 = 0xCD9E8D57
PHILOX_W0 = 0x9E3779B9
PHILOX_W1 = 0xBB67AE85
PHILOX_ROUNDS = 10


def _mulhilo(m: int, x):
    """``(hi, lo)`` words of the 64-bit product ``m * x`` for a 32-bit
    constant ``m`` and an int64 tensor ``x`` of 32-bit values.

    ``x = x_hi * 2**16 + x_lo``; both partial products stay below 2**48, so
    nothing overflows int64:  ``m*x = p_hi * 2**16 + p_lo`` and
    ``hi = (p_hi + (p_lo >> 16)) >> 16``,
    ``lo = ((p_hi << 16) + p_lo) mod 2**32``."""
    p_lo = (x & 0xFFFF) * m
    p_hi = (x >> 16) * m
    hi = (p_hi + (p_lo >> 16)) >> 16
    lo = (((p_hi & 0xFFFF) << 16) + p_lo) & MASK32
    return hi, lo


def philox4x32(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 on int64 tensors (broadcasting) holding 32-bit words.

    Returns the four output words.  ``k0``/``k1`` may be Python ints or
    tensors."""
    for r in range(PHILOX_ROUNDS):
        if r:
            k0 = (k0 + PHILOX_W0) & MASK32
            k1 = (k1 + PHILOX_W1) & MASK32
        hi0, lo0 = _mulhilo(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def seed_key(seed: int):
    """Philox key words of an integer seed (its low and high 32 bits)."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return seed & MASK32, seed >> 32


def uniform_from_bits(bits):
    """32-bit words -> float32 uniform in [0, 1) from the top 24 bits
    (``pallas_common._uniform_from_bits``: a uniform can be exactly 0)."""
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


# Draw slots of the PMSM random mode: the counter of one Philox call is
# (env, step, slot, 0); the kernels skip a slot whose words the step
# discards (slot 1 without a sub-episode regeneration, slot 2 without a
# violation), which is safe because every call is independent.
SLOT_STEP = 0     # (action, box-muller u1, box-muller u2, -)
SLOT_PARAMS = 1   # (length d, length q, sigma d, sigma q)
SLOT_RESET = 2    # (reset value d, reset value q, -, -)
SLOT_INIT_A = 3   # at step 0: (value d, value q, length d, length q)
SLOT_INIT_B = 4   # at step 0: (sigma d, sigma q, -, -)


class PhiloxBits:
    """Bit source of the plain random modes: the same (env, step, slot)
    counters as the CUDA kernels.

    ``init_words()`` gives the six words of the Wiener initialisation
    ``(v_d, v_q, len_d, len_q, sig_d, sig_q)``; ``step_words(t)`` the nine
    words of step ``t``: ``(action, u1, u2, len_d, len_q, sig_d, sig_q,
    reset_d, reset_q)``, each an (N,) int64 tensor."""

    def __init__(self, seed: int, n_envs: int, device):
        self.k0, self.k1 = seed_key(seed)
        self.env = torch.arange(n_envs, dtype=torch.int64, device=device)
        self.device = device

    def _call(self, t, slots):
        s = torch.tensor(slots, dtype=torch.int64, device=self.device)[:, None]
        zero = torch.zeros((), dtype=torch.int64, device=self.device)
        return philox4x32(self.env[None, :], zero + t, s, zero, self.k0, self.k1)

    def init_words(self):
        a0, a1, a2, a3 = self._call(0, [SLOT_INIT_A, SLOT_INIT_B])
        return a0[0], a1[0], a2[0], a3[0], a0[1], a1[1]

    def step_words(self, t: int):
        w0, w1, w2, w3 = self._call(t, [SLOT_STEP, SLOT_PARAMS, SLOT_RESET])
        return (w0[0], w1[0], w2[0], w0[1], w1[1], w2[1], w3[1], w0[2], w1[2])
