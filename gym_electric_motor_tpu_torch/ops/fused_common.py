"""Shared pieces of the fused rollout kernels: the lane constant, the
24-bit uniform map, the Philox4x32-10 bit sources, and the plain versions
of the in-kernel machinery the universal family kernels share.

Counterpart of ``LANE``, ``TWO_PI``, ``_uniform_from_bits``, ``_make_rng``,
``_fused_check_system``, ``_fused_constraint_mode``, ``_make_b6``,
``_make_fused_mech``, ``_make_fused_supply``, ``_ref_configs``,
``_make_wiener``, ``_wse_err``, ``_rotation_protocol``, ``_c2u`` and
``_c2i`` in ``gym_electric_motor_tpu/ops/pallas_common.py``, restricted to
what the DC, synchronous, SCIM, EESM and DFIM families' catalog defaults
use (see :func:`fused_check_system` for what raises).  The CUDA
counterparts of the machinery are the device functions of
``csrc/common_step.cuh`` and the families' ``csrc/*_step.cuh``.  On the
TPU the bits come from the on-core PRNG (xorshift in interpret mode); here
they come from Philox4x32-10 (Salmon et al., "Parallel random numbers: as
easy as 1, 2, 3", SC'11), a counter-based generator: the bits of one draw are a pure
function of (key, counter), so the CUDA kernels (``csrc/philox.cuh``) and
the plain PyTorch versions below produce the same bits whatever the launch
geometry.

Plain version on the CPU: torch integer ops are signed and the 32x32->64
products of the Philox round overflow int64, so the words live in int64
tensors holding values in [0, 2**32) and every product is split into 16-bit
limbs (see ``_mulhilo``).
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from . import cuda_build

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


# Per-reference-row constants of the universal family kernels, in the order
# of RefRowIndex in csrc/common_step.cuh.
ROW_NAMES = ("coef", "inv_lim", "mlo", "mhi", "ep_lo", "ep_span", "sig_base", "sig_span")

# Draw slots of the PMSM random mode: the counter of one Philox call is
# (env, step, slot, 0); the kernels skip a slot whose words the step
# discards (slot 1 without a sub-episode regeneration, slot 2 without a
# violation), which is safe because every call is independent.
SLOT_STEP = 0     # (action, box-muller u1, box-muller u2, -)
SLOT_PARAMS = 1   # (length d, length q, sigma d, sigma q)
SLOT_RESET = 2    # (reset value d, reset value q, -, -)
SLOT_INIT_A = 3   # at step 0: (value d, value q, length d, length q)
SLOT_INIT_B = 4   # at step 0: (sigma d, sigma q, -, -)
# REINFORCE's own slots (csrc/policy_step.cuh): 8 Gumbel uniforms and one
# Box-Muller pair per reference; its parameter and reset draws use slots 1
# and 2.  The policy rollout and recorder take their action uniform and
# Box-Muller pair from SLOT_STEP.
SLOT_GUMBEL_A = 5    # (gumbel 0, 1, 2, 3)
SLOT_GUMBEL_B = 6    # (gumbel 4, 5, 6, 7)
SLOT_BOX_MULLER = 7  # (u1 d, u1 q, u2 d, u2 q)
# The synchronous family (csrc/sync_step.cuh, SyncBits below) reads slots 0
# to 4 with reference rows 0 and 1 in place of d and q: SLOT_STEP as
# (action 0, box-muller u1, box-muller u2, action 1), SLOT_PARAMS,
# SLOT_RESET, SLOT_INIT_A, SLOT_INIT_B; and a continuous converter's third
# to sixth action words (the DFIM's rotor duties are the fourth to sixth)
# from its own slot.
SLOT_ACTION_C = 8    # (action 2, action 3, action 4, action 5)
# A third reference row (the EESM's i_e, csrc/common_step.cuh) takes its
# words from two more slots, so that the one- and two-row draws stay as
# they are: per step the second Box-Muller pair and row 2's sub-episode
# length and sigma, and at step 0 row 2's initial draws; its reset value is
# SLOT_RESET's third word.
SLOT_ROW2 = 9        # (box-muller u1 of pair 2, u2 of pair 2, length row 2, sigma row 2)
SLOT_INIT_C = 10     # at step 0: (value row 2, length row 2, sigma row 2, -)
# The universal policy recorder (csrc/policy_heads.cuh, PolicyBits below)
# draws its uniforms from two slots of its own: one per categorical head (one
# for a joint head), or a Box-Muller pair per two Gaussian channels; the
# reference advance keeps SLOT_STEP's pair, so nothing the other kernels draw
# moves.
SLOT_POLICY_A = 11   # (uniform 0, 1, 2, 3)
SLOT_POLICY_B = 12   # (uniform 4, 5, -, -): the DFIM's third Box-Muller pair


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


class ReinforceBits(PhiloxBits):
    """REINFORCE's bit source: ``init_words()`` as ``PhiloxBits``;
    ``step_words(t)`` the 18 words of step ``t``: 8 Gumbel words, the
    Box-Muller ``(u1 d, u1 q, u2 d, u2 q)``, ``(len d, len q, sig d,
    sig q)`` and ``(reset d, reset q)``."""

    def step_words(self, t: int):
        w0, w1, w2, w3 = self._call(t, [SLOT_GUMBEL_A, SLOT_GUMBEL_B, SLOT_BOX_MULLER,
                                        SLOT_PARAMS, SLOT_RESET])
        words = [w[i] for i in range(4) for w in (w0, w1, w2, w3)]
        return tuple(words) + (w0[4], w1[4])


class SyncBits(PhiloxBits):
    """The synchronous family's bit source: the counters of
    ``csrc/sync_step.cuh``.

    ``init_words()`` gives ``(values, lengths, sigmas)``, one word per
    reference row each; ``step_words(t)`` gives ``(actions, u1, u2,
    lengths, sigmas, resets)``: 1 (finite), 3, 4 or 6 (cont) action words, the
    Box-Muller pair, and one word per row for the sub-episode length, the
    sigma and the reset value.  With three rows ``u1`` and ``u2`` are the
    lists of two pairs' words (``SLOT_ROW2``).  Each word is an (N,) int64
    tensor; the plain versions draw every word of ``BLOCK`` consecutive
    steps in one Philox call."""

    BLOCK = 16

    def __init__(self, seed: int, n_envs: int, device, n_rows: int, n_act: int):
        super().__init__(seed, n_envs, device)
        self.n_rows, self.n_act = n_rows, n_act
        self._slots = ([SLOT_STEP, SLOT_PARAMS, SLOT_RESET]
                       + ([SLOT_ACTION_C] if n_act >= 3 else [])
                       + ([SLOT_ROW2] if n_rows == 3 else []))
        self._block_t0, self._block = None, None

    def _call(self, t, slots):
        """Words of steps ``t .. t + BLOCK - 1`` at once: each (BLOCK,
        slots, N) when ``t`` is a range start, as ``PhiloxBits._call``
        otherwise."""
        if not isinstance(t, range):
            return super()._call(t, slots)
        s = torch.tensor(slots, dtype=torch.int64, device=self.device)[None, :, None]
        steps = torch.tensor(list(t), dtype=torch.int64, device=self.device)[:, None, None]
        zero = torch.zeros((), dtype=torch.int64, device=self.device)
        return philox4x32(self.env[None, None, :], steps, s, zero, self.k0, self.k1)

    def init_words(self):
        a0, a1, a2, a3 = self._call(0, [SLOT_INIT_A, SLOT_INIT_B, SLOT_INIT_C])
        n = self.n_rows
        return ([a0[0], a1[0], a0[2]][:n], [a2[0], a3[0], a1[2]][:n],
                [a0[1], a1[1], a2[2]][:n])

    def step_words(self, t: int):
        t0 = t - t % self.BLOCK
        if self._block_t0 != t0:
            self._block_t0 = t0
            self._block = self._call(range(t0, t0 + self.BLOCK), self._slots)
        w0, w1, w2, w3 = (w[t - t0] for w in self._block)
        acts = [w0[0], w3[0]][:self.n_act] + ([w0[3], w1[3], w2[3], w3[3]][:self.n_act - 2]
                                             if self.n_act >= 3 else [])
        n = self.n_rows
        u1, u2 = w1[0], w2[0]
        lens, sigs, resets = [w0[1], w1[1]], [w2[1], w3[1]], [w0[2], w1[2], w2[2]]
        if n == 3:
            row2 = len(self._slots) - 1
            u1, u2 = [u1, w0[row2]], [u2, w1[row2]]
            lens.append(w2[row2])
            sigs.append(w3[row2])
        return acts, u1, u2, lens[:n], sigs[:n], resets[:n]


class PolicyBits(SyncBits):
    """The universal policy recorder's bit source: the reference words of
    ``SyncBits`` (SLOT_STEP's Box-Muller pair, the length, sigma and reset
    words, SLOT_ROW2 with three rows) and, in place of the random action
    words, ``n_words`` policy uniforms from ``SLOT_POLICY_A`` and
    ``SLOT_POLICY_B``: ``step_words(t)`` gives ``(policy words, u1, u2,
    lengths, sigmas, resets)``."""

    def __init__(self, seed: int, n_envs: int, device, n_rows: int, n_words: int):
        if not 1 <= n_words <= 6:
            raise ValueError(f"the policy draws 1 to 6 uniforms per step, got {n_words}")
        super().__init__(seed, n_envs, device, n_rows, 1)
        self.n_words = n_words
        self._pslots = [SLOT_POLICY_A] + ([SLOT_POLICY_B] if n_words > 4 else [])
        self._pblock_t0, self._pblock = None, None

    def step_words(self, t: int):
        _acts, *ref_words = super().step_words(t)
        t0 = t - t % self.BLOCK
        if self._pblock_t0 != t0:
            self._pblock_t0 = t0
            self._pblock = self._call(range(t0, t0 + self.BLOCK), self._pslots)
        w = [x[t - t0] for x in self._pblock]
        words = [w[i % 4][i // 4] for i in range(self.n_words)]
        return (words, *ref_words)


def policy_obs_spec(mech, w_lim, omega_fixed, entries):
    """The universal policy recorder's observation spec
    (``_policy_obs_spec``, pallas_common.py:1459-1475): the speed feature,
    omega over its limit under a dynamic load or the constant
    ``omega_fixed / w_lim``, then the family's ``entries``, each
    ``("const", v)``, ``("state", plane, scale)`` or ``("cos"/"sin",
    plane)``.  The recorder appends the referenced quantities and the
    reference values."""
    head = ((("state", 0, 1.0 / w_lim),) if mech
            else (("const", float(omega_fixed) / w_lim),))
    return head + tuple(entries)


def system_limits(env):
    """``(unwrapped physical system, its state names, its limits)`` of an
    env the fused kernels take: what the families' policy surfaces scale
    their observation features by."""
    ps = fused_check_system(env.physical_system)
    return ps, list(ps.state_names), np.asarray(ps.limits)


class DcBits(SyncBits):
    """The DC family's bit source: the counters of ``csrc/dc_step.cuh``,
    which reads the sync family's slots with the same meaning.
    ``step_words(t)`` gives one action word per converter channel of a
    continuous converter (``SLOT_STEP``'s words 0 and 3) and one word for a
    finite one, whose low bits carry both ExtExDc channels (bits 0-1 and
    2-3, pallas_dc.py:1023-1026)."""

    def __init__(self, seed: int, n_envs: int, device, n_rows: int, n_act: int):
        if n_act not in (1, 2):
            raise ValueError(f"the DC family draws 1 or 2 action words, got {n_act}")
        super().__init__(seed, n_envs, device, n_rows, n_act)


# ---------------------------------------------------------------------------
# wrapper helpers of the kernel modules
# ---------------------------------------------------------------------------


def check_tensor(name, x, shape, dtype, device):
    """Raise unless ``x`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(x).__name__}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, the other inputs on {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def ptr_array(xs):
    """A C array of the tensors' device pointers (None for NULL)."""
    return (ctypes.c_void_p * len(xs))(*[None if x is None else x.data_ptr() for x in xs])


def seed_u64(seed):
    return int(seed) & 0xFFFFFFFFFFFFFFFF


def check_planes(c, states):
    """Validate the state planes of a family kernel: ``c.n_state`` float32
    ``(n_envs // 128, 128)`` tensors on one device, the CPU or CUDA (``c``
    names them in ``c.state_names``); returns ``(device, R)``."""
    states = tuple(states)
    if len(states) != c.n_state:
        raise ValueError(f"this env takes {c.n_state} state planes {c.state_names}, "
                         f"got {len(states)}")
    x0 = states[0]
    if not isinstance(x0, torch.Tensor) or x0.dim() != 2 or x0.shape[1] != LANE \
            or x0.shape[0] < 1:
        raise ValueError(f"state planes must be (n_envs // {LANE}, {LANE}) tensors")
    device = x0.device
    for nm, x in zip(c.state_names, states):
        check_tensor(nm, x, x0.shape, torch.float32, device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return device, x0.shape[0]


def check_b6_actions(c, actions, R, device):
    """Validate a B6 bridge's action buffer: int32 ``(T, R, 128)`` bits
    (``c.finite``) or float32 ``(T, 3, R, 128)`` duties; returns T."""
    T = actions.shape[0] if isinstance(actions, torch.Tensor) and actions.dim() else 0
    if c.finite:
        check_tensor("actions", actions, (T, R, LANE), torch.int32, device)
    else:
        check_tensor("actions", actions, (T, 3, R, LANE), torch.float32, device)
    return T


def check_channel_actions(c, actions, R, device):
    """Validate a multi converter's action buffer of ``c.n_act`` channels:
    int32 ``(T, n_act, R, 128)`` (``c.finite``) or float32 duties of the
    same shape; returns T."""
    T = actions.shape[0] if isinstance(actions, torch.Tensor) and actions.dim() else 0
    check_tensor("actions", actions, (T, c.n_act, R, LANE),
                 torch.int32 if c.finite else torch.float32, device)
    return T


# the C size queries of a library's constant layout, in the order of
# family_library's ``counts`` (``n_ctrl`` only in a controller-in-the-loop
# library)
LAYOUT_SUFFIXES = ("n_const", "n_row_const", "n_flag", "n_ctrl")


def family_library(library, prefix, argtypes, counts, suffixes=LAYOUT_SUFFIXES):
    """The loaded library of ``csrc/<library>.cu`` (built on first use),
    its kernel functions typed on first load (``argtypes``: ``{name:
    [ctypes types]}``; names the library lacks are skipped) and its
    constant layout checked: ``<prefix>_<suffix>`` for the first
    ``len(counts)`` of ``suffixes`` must return ``counts``."""
    lib = cuda_build.load(library)
    if not getattr(lib, "_gemx_typed", False):
        for name, types in argtypes.items():
            fn = getattr(lib, name, None)
            if fn is not None:
                fn.argtypes = types
                fn.restype = ctypes.c_int
        sizes = []
        for suffix in suffixes[:len(counts)]:
            fn = getattr(lib, f"{prefix}_{suffix}")
            fn.restype = ctypes.c_int
            sizes.append(fn())
        err = getattr(lib, f"{prefix}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        if tuple(sizes) != tuple(counts):
            raise RuntimeError(f"csrc/{library}.cu and its Python module disagree on the "
                               f"constants: {tuple(sizes)} against {tuple(counts)}")
        lib._gemx_typed = True
    return lib


def launch_kernel(lib, prefix, name, device, launches, *args):
    """Call kernel ``name`` of ``lib`` on the current stream of ``device``,
    raise on the error code it returns, and count the launch in
    ``launches``."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, name)(*args, stream)
    if rc != 0:
        message = getattr(lib, f"{prefix}_error_string")(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: {message}")
    launches[name] += 1


# the fields of csrc/ring_pipe.cuh's RingLayout, in order
RING_LAYOUT_FIELDS = ("consumer_warps", "producer_warps", "K", "slots", "words", "smem_bytes",
                      "design")


def named_ring_layout(values, extra=()):
    """A RingLayout (and ``extra`` fields after it) as a dict, its design
    named: warp-specialised, or one thread per env."""
    lay = dict(zip(RING_LAYOUT_FIELDS + tuple(extra), values))
    lay["design"] = "warp-specialised" if lay["design"] == 0 else "one thread per env"
    return lay


def check_rollout_inputs(R, n_steps, state0, actions=None):
    """A builder's own checks: the planes hold the envs it was built for,
    and an action buffer the steps."""
    check_tensor("state0[0]", state0[0], (R, LANE), torch.float32, state0[0].device)
    if actions is not None and actions.shape[0] != n_steps:
        raise ValueError(f"the action buffer must hold {n_steps} steps, got {actions.shape[0]}")


# ---------------------------------------------------------------------------
# plain versions of the universal families' shared machinery
# ---------------------------------------------------------------------------

_f32 = np.float32


def reciprocal_f32(x):
    """``1 / float32(x)`` in float32: XLA turns a division by a constant
    into this product, so the JAX kernels multiply by it."""
    return _f32(1.0) / _f32(x)


_FUSED_OK_WRAPPERS = ("CurrentSumProcessor", "CosSinProcessor", "FluxObserver")


def fused_check_system(ps):
    """Reject, loudly, what the universal family kernels would simulate
    wrong (``_fused_check_system``, pallas_common.py:74-114, with what the
    port does not fuse yet added): physical-system wrappers other than the
    observation-only ones, the dq control space, NoConverter (the grid
    simulation), non-ideal supplies, interlocking dead time, loads other
    than the constant-speed and polynomial static ones, and another
    integrator than one RK4 step."""
    chain, cur = [], ps
    while hasattr(cur, "inner"):
        chain.append(type(cur).__name__)
        cur = cur.inner
    bad = [n for n in chain if n not in _FUSED_OK_WRAPPERS]
    if bad:
        raise NotImplementedError(
            f"the fused kernels support observation-only wrappers {_FUSED_OK_WRAPPERS}; got "
            f"{bad}: the DeadTime, StateNoise and DqToAbc wraps (the SCIM's with its flux "
            "observer) arrive with queue 2, item 7")
    if getattr(cur, "control_space", "abc") != "abc":
        raise NotImplementedError(
            "control_space='dq' is not fused yet; it arrives with queue 2, item 7")
    if getattr(cur.converter, "action_type", None) == "none":
        raise NotImplementedError(
            "NoConverter (the AC3 grid simulation of pallas_induction.py:271-276) is not fused "
            "yet; it arrives with queue 2, item 8 (_make_fused_supply)")
    if cur.supply.kind != "IdealVoltageSupply":
        raise NotImplementedError(
            f"the fused kernels support IdealVoltageSupply only; {cur.supply.kind!r} "
            "arrives with queue 2, item 8 (_make_fused_supply)")
    if float(getattr(cur.converter, "interlocking_time", 0.0) or 0.0) != 0.0:
        raise NotImplementedError(
            "interlocking dead time is not fused yet; it arrives with queue 2, item 8 "
            "(_fused_interlock)")
    if cur.load.kind not in ("ConstantSpeedLoad", "PolynomialStaticLoad"):
        raise NotImplementedError(
            f"the fused kernels support ConstantSpeedLoad and PolynomialStaticLoad; "
            f"{cur.load.kind!r} arrives with queue 2, item 8 (_make_fused_mech)")
    if getattr(cur, "solver", "rk4") != "rk4" or getattr(cur, "substeps", 1) != 1:
        raise NotImplementedError(
            "the fused kernels take one RK4 step per control cycle; run other solvers "
            "on VectorEnv")
    return cur


def require(cond, message):
    """Raise ``AssertionError(message)`` unless ``cond``: the JAX builders'
    assertions, raised whatever the interpreter's ``-O``."""
    if not cond:
        raise AssertionError(message)


def require_default_constraints(env, default_desc):
    """The controller-in-the-loop kernels hard-code the catalog-default
    violation check and have no constraints-off mode: reject custom
    constraint sets and ``constraints=()`` alike
    (``_require_default_constraints``, pallas_common.py:168-176)."""
    if fused_constraint_mode(env, default_desc) != "default":
        raise NotImplementedError(
            f"this kernel implements the catalog-default constraints {default_desc} only, not "
            "constraints=(): run the closed loop on the general path (control_environment)")


def fused_constraint_mode(env, default_desc):
    """``'default'`` for the family's catalog constraint set, ``'none'``
    for ``constraints=()``; anything else raises
    (``_fused_constraint_mode``, pallas_common.py:117-155)."""
    cm = env.constraint_monitor
    cons = cm.constraints
    if len(cons) == 0:
        return "none"
    desc = []
    for c in cons:
        tn = type(c).__name__
        if tn == "LimitConstraint":
            desc.append(("limit", tuple(c.observed_state_names)))
        elif tn == "SquaredConstraint":
            desc.append(("squared", tuple(c.states)))
        else:
            desc.append((tn, None))
    if tuple(desc) == tuple(default_desc) and cm.merge_violations == "max":
        return "default"
    raise NotImplementedError(
        f"the fused kernels implement the catalog-default constraints {default_desc} (or "
        f"constraints=()); got {tuple(desc)}: run other constraint sets on VectorEnv")


def c2u(d):
    """A continuous half bridge's voltage fraction: the duty, less the
    interlock discount, which is zero without interlocking (``_c2u`` at
    k = 0, pallas_common.py:824-829)."""
    return d


def c2i(d, i):
    """Its supply current (``_c2i`` at k = 0, pallas_common.py:832-837)."""
    return d * i


def b6_fractions(finite: bool, action):
    """The three phase voltages as fractions of the supply voltage
    (``_make_b6(finite, 0).frac``, pallas_common.py:790-799): finite, the
    action's bits minus 1/2; cont, half the duty command, no clip."""
    if finite:
        return tuple(((action >> b) & 1).to(torch.float32) - 0.5 for b in (2, 1, 0))
    return tuple(0.5 * a for a in action)


def poly_load_rhs(k, w, t_e):
    """d omega / dt of the polynomial static load, linearised below
    ``omega_lin`` (``_make_fused_mech``'s 'poly' mode, pallas_common.py:
    671-676); ``k`` holds the float32 constants as Python floats."""
    sign = torch.sign(w)
    a_term = torch.where(torch.abs(w) > k["omega_lin"], sign * k["load_a"], k["jt_over_td"] * w)
    t_load = sign * k["load_c"] * w * w + k["load_b"] * w + a_term
    return (t_e - t_load) * k["inv_jt"]


def rotation_advance(k, c, s, violated):
    """The constant-increment Park rotation with rsqrt renormalisation, reset
    to (1, 0) on violation (``_rotation_protocol``, pallas_common.py:
    1476-1494)."""
    c_new = c * k["cos_d"] - s * k["sin_d"]
    s_new = s * k["cos_d"] + c * k["sin_d"]
    inv = torch.rsqrt(c_new * c_new + s_new * s_new)
    return (torch.where(violated, torch.ones_like(c), c_new * inv),
            torch.where(violated, torch.zeros_like(s), s_new * inv))


def wse_err(row, q, r):
    """One WSE penalty term at reward power 1, ``coef * |q - r|`` with the
    state-length normalisation folded into ``coef`` (``_wse_err``,
    pallas_common.py:912-925)."""
    return row["coef"] * torch.abs(q - r)


def ref_rows(env):
    """Per-reference-row constants, as float32-exact Python floats
    (``_ref_configs``, pallas_common.py:968-1092, for the 'wiener' and
    'const' kinds): the referenced state, the WSE coefficient, 1 / limit,
    the margins, the sub-episode length range and the log10 sigma range.  A
    constant reference rides the Wiener machinery with pinned margins,
    sigma 1e-30 and a sub-episode that never ends."""
    ps = env.physical_system
    names = list(ps.state_names)
    lim = np.asarray(ps.limits)
    rw = env.reward_function
    rows = []
    for s in env.reference_generator.subs:
        idx = names.index(s.reference_state)
        n_pow = float(np.asarray(rw._n).ravel()[idx])
        if n_pow != 1.0:
            raise NotImplementedError(
                f"the fused kernels take reward power 1; {n_pow} arrives with queue 2, "
                "item 8 (_wse_err)")
        row = dict(kind=s.kind, name=s.reference_state,
                   coef=_f32(rw._weights[idx] / rw._state_length[idx] ** n_pow),
                   inv_lim=_f32(1.0 / lim[idx]))
        if s.kind == "const":
            v = _f32(s.reference_value)
            row.update(mlo=v, mhi=v, sig_base=_f32(-30.0), sig_span=_f32(0.0),
                       ep_lo=_f32(1e9), ep_span=_f32(0.0))
        elif s.kind == "wiener":
            row.update(mlo=_f32(s.margin[0]), mhi=_f32(s.margin[1]),
                       ep_lo=_f32(s.episode_lengths[0]),
                       ep_span=_f32(s.episode_lengths[1] - s.episode_lengths[0]),
                       sig_base=_f32(np.log10(s.sigma_range[0])),
                       sig_span=_f32(np.log10(s.sigma_range[1]) - np.log10(s.sigma_range[0])))
        else:
            raise NotImplementedError(
                f"reference kind {s.kind!r} is not fused yet; it arrives with queue 2, "
                "item 8 (_make_wiener)")
        row["span"] = row["mhi"] - row["mlo"]  # float32, as the kernels form it
        rows.append({key: (float(v) if isinstance(v, np.floating) else v)
                     for key, v in row.items()})
    return rows


def physics_rows(name):
    """One constant reference row on ``name`` with every constant zero: the
    rows of a family's constants built with ``physics_only=True``, where the
    caller (a specialised builder) bakes its own references and reward."""
    row = dict(kind="const", name=name, **dict.fromkeys(ROW_NAMES, 0.0))
    row["span"] = 0.0
    return [row]


def _wiener_params(k, row, b_len, b_sig):
    rl = torch.floor(row["ep_lo"] + row["ep_span"] * uniform_from_bits(b_len))
    rs = torch.exp(k["ln10"] * (row["sig_base"] + row["sig_span"] * uniform_from_bits(b_sig)))
    return rl, rs


def _uniform_value(row, b):
    return row["mlo"] + row["span"] * uniform_from_bits(b)


def wiener_init(k, rows, all_const, words, shape, device):
    """The reference rows at step 0 (``_make_wiener``'s ``init``): lists of
    value, steps since regeneration, sub-episode length and sigma planes,
    one per row.  ``words`` = ``(values, lengths, sigmas)`` of the bit
    source; all-constant rows draw nothing (``words`` is then unused)."""
    zero = torch.zeros(shape, dtype=torch.float32, device=device)
    if all_const:
        return ([zero + r["mlo"] for r in rows], [zero.clone() for _ in rows],
                [torch.full(shape, 1e9, dtype=torch.float32, device=device) for _ in rows],
                [zero.clone() for _ in rows])
    vals, lens, sigs = ([w.reshape(shape) for w in ws] for ws in words)
    rv, rk, rl, rs = [], [], [], []
    for j, row in enumerate(rows):
        rv.append(_uniform_value(row, vals[j]))
        rk.append(zero.clone())
        length, sigma = _wiener_params(k, row, lens[j], sigs[j])
        rl.append(length)
        rs.append(sigma)
    return rv, rk, rl, rs


def box_muller(k, w_u1, w_u2):
    """``(r cos theta, r sin theta)`` of two 32-bit words."""
    rad = torch.sqrt(-2.0 * torch.log(torch.clamp(uniform_from_bits(w_u1), min=k["u_min"])))
    theta = k["two_pi"] * uniform_from_bits(w_u2)
    return rad * torch.cos(theta), rad * torch.sin(theta)


def reference_step(k, rows, all_const, st, new, words, violated, t):
    """The random modes' reference advance after step ``t`` (the part of
    ``make_fused_sync_rollout``'s and ``make_fused_dc_rollout``'s ``body``
    after the reset): the Box-Muller pair feeds both rows (two rows) or, for
    one row, is drawn at even steps and its sine half kept in ``zb`` for
    the next odd step; three rows take two pairs, cos, sin, cos
    (pallas_common.py:1379-1389); then ``wiener_advance`` of ``new`` in
    place.  ``words`` = ``(u1, u2, lengths, sigmas, resets)`` of the bit
    source, ``u1`` and ``u2`` lists of two words with three rows."""
    if all_const:
        return
    shape = violated.shape
    u1, u2, lens, sigs, resets = words
    if len(rows) == 3:
        draws = box_muller(k, u1[0].reshape(shape), u2[0].reshape(shape))
        draws += box_muller(k, u1[1].reshape(shape), u2[1].reshape(shape))[:1]
    elif len(rows) == 2:
        draws = box_muller(k, u1.reshape(shape), u2.reshape(shape))
    elif t % 2 == 0:
        za, new["zb"] = box_muller(k, u1.reshape(shape), u2.reshape(shape))
        draws = (za,)
    else:
        draws = (st["zb"],)
    wiener_advance(k, rows, new, draws, violated,
                   *([w.reshape(shape) for w in ws] for ws in (lens, sigs, resets)))


def wiener_advance(k, rows, ref, draws, violated, lens, sigs, resets):
    """One advance of every row in ``ref`` (a dict of the lists ``rv``,
    ``rk``, ``rl``, ``rs``), in place (``_make_wiener``'s ``advance``):
    regeneration where a sub-episode ended or the env reset, the clipped
    random-walk step with the row's ``draws``, and a fresh value where the
    env reset."""
    for j, row in enumerate(rows):
        regen = (ref["rk"][j] >= ref["rl"][j]) | violated
        length, sigma = _wiener_params(k, row, lens[j], sigs[j])
        ref["rl"][j] = torch.where(regen, length, ref["rl"][j])
        ref["rs"][j] = torch.where(regen, sigma, ref["rs"][j])
        ref["rk"][j] = torch.where(regen, torch.zeros_like(ref["rk"][j]), ref["rk"][j]) + 1.0
        value = torch.clamp(ref["rv"][j] + ref["rs"][j] * draws[j], row["mlo"], row["mhi"])
        ref["rv"][j] = torch.where(violated, _uniform_value(row, resets[j]), value)


# ---------------------------------------------------------------------------
# the specialised builders (ops/fused_dc.py, fused_induction.py,
# fused_eesm.py, fused_dfim.py; csrc/specialised_step.cuh)
# ---------------------------------------------------------------------------

# Draw slots of the specialised kernels (SpecSlot in csrc/specialised_step.cuh);
# each kernel's source says which words of a slot it reads.
SPEC_SLOT_STEP, SPEC_SLOT_PARAMS, SPEC_SLOT_RESET = 0, 1, 2
SPEC_SLOT_INIT_0, SPEC_SLOT_INIT_1, SPEC_SLOT_EXTRA, SPEC_SLOT_INIT_2 = 3, 4, 5, 6

# the catalog-default constraint set of each motor
# (``_DEFAULT_CONSTRAINT_DESC``, pallas_common.py:158-165)
DEFAULT_CONSTRAINT_DESC = {
    "PermExDc": (("limit", ("i",)),),
    "SeriesDc": (("limit", ("i",)),),
    "ShuntDc": (("limit", ("i_a",)), ("limit", ("i_e",))),
    "ExtExDc": (("limit", ("i_a",)), ("limit", ("i_e",))),
    "EESM": (("squared", ("i_sq", "i_sd")), ("limit", ("i_e",))),
    "SRM": (("limit", ("i_a", "i_b", "i_c")),),
}


class SlotBits(PhiloxBits):
    """The bit source of a specialised kernel's plain version: its Philox
    words by role.  ``init`` and ``step`` map each role to the ``(slot,
    word)`` the kernel reads it from, or to a list of them (one per
    reference row); ``init_words()`` and ``step_words(t)`` return ``{role:
    (N,) int64 tensor, or a list of them}``.  A test replays the JAX
    interpret kernels' xorshift with an object of the same interface."""

    def __init__(self, seed: int, n_envs: int, device, init: dict, step: dict):
        super().__init__(seed, n_envs, device)
        self.init, self.step = init, step

    def _pick(self, t, layout):
        def pairs(v):
            return v if isinstance(v, list) else [v]

        slots = sorted({s for v in layout.values() for s, _w in pairs(v)})
        words = self._call(t, slots)
        row = {s: j for j, s in enumerate(slots)}

        def get(sw):
            return words[sw[1]][row[sw[0]]]

        return {role: ([get(x) for x in v] if isinstance(v, list) else get(v))
                for role, v in layout.items()}

    def init_words(self):
        return self._pick(0, self.init)

    def step_words(self, t: int):
        return self._pick(t, self.step)


def shaped_words(words, shape):
    """``words`` (a dict of (N,) word tensors or lists of them, or None for
    a word not drawn) reshaped to the state planes' ``shape``."""
    def one(w):
        return None if w is None else w.reshape(shape)
    return {k: ([one(x) for x in v] if isinstance(v, list) else one(v)) for k, v in words.items()}


def spec_params(k, b_len, b_sig):
    """A row's new sub-episode length and sigma (``spec_params`` of
    csrc/specialised_step.cuh): ``floor(ep_lo + ep_span U)``, ``10^(sig_base
    + sig_span U)``."""
    rl = torch.floor(k["ep_lo"] + k["ep_span"] * uniform_from_bits(b_len))
    rs = torch.exp(k["ln10"] * (k["sig_base"] + k["sig_span"] * uniform_from_bits(b_sig)))
    return rl, rs


def spec_row_walk(row, regen, new_rl, new_rs, draw, lo, hi):
    """A row's advance (``spec_row_walk``): regeneration where ``regen``,
    then the clipped random-walk step.  ``row`` is a dict of the ``rv``,
    ``rk``, ``rl``, ``rs`` planes, updated in place; ``lo``/``hi`` floats."""
    row["rl"] = torch.where(regen, new_rl, row["rl"])
    row["rs"] = torch.where(regen, new_rs, row["rs"])
    row["rk"] = torch.where(regen, torch.zeros_like(row["rk"]), row["rk"]) + 1.0
    row["rv"] = torch.clamp(row["rv"] + row["rs"] * draw, lo, hi)


def specialised_u_sup(ps):
    """The supply voltage the specialised kernels bake: ideal supply and no
    interlocking only (``_fused_u_sup``, pallas_common.py:34-53)."""
    if ps.supply.kind != "IdealVoltageSupply":
        raise NotImplementedError(
            f"the specialized fused kernels support IdealVoltageSupply only; got "
            f"{ps.supply.kind!r}: use make_fused_rollout (the universal dispatch) or VectorEnv")
    if float(getattr(ps.converter, "interlocking_time", 0.0) or 0.0) != 0.0:
        raise NotImplementedError(
            "the specialized fused kernels support zero interlocking dead time only; use "
            "make_fused_rollout (the universal dispatch) or VectorEnv")
    return float(ps.supply.u_nominal)


def specialised_load(ps, kinds):
    """The load spec, restricted to the kinds the kernel implements
    (``_fused_load``, pallas_common.py:56-68)."""
    if ps.load.kind not in kinds:
        raise NotImplementedError(
            f"this fused kernel supports loads {kinds}; got {ps.load.kind!r}: use the general "
            "path (VectorEnv.rollout)")
    return ps.load


def require_specialised_defaults(env):
    """The specialised kernels hard-code the catalog-default constraints and
    have no constraints-off mode (``_require_default_constraints``,
    pallas_common.py:168-176)."""
    kind = env.physical_system.motor.kind
    desc = DEFAULT_CONSTRAINT_DESC.get(kind, (("squared", ("i_sq", "i_sd")),))
    if fused_constraint_mode(env, desc) != "default":
        raise NotImplementedError(
            "this specialized kernel implements the catalog-default constraints; "
            "constraints=() runs on the universal family kernels (make_fused_rollout) or "
            "VectorEnv")


def require_lanes(n_envs):
    """``n_envs % 128 == 0`` (the JAX builders' assertion); returns R."""
    require(n_envs % LANE == 0, f"n_envs must be a multiple of {LANE}, got {n_envs}")
    return n_envs // LANE


def pack_consts(c, names, values):
    """Set ``c.host``, the float32 array of ``values`` in ``names`` order
    that a kernel takes, and ``c.f``, the same values as Python floats for
    the plain versions."""
    c.host = np.array([np.float32(values[n]) for n in names], dtype=np.float32)
    c.f = {n: float(v) for n, v in zip(names, c.host)}


# what follows a specialised kernel's constants: (seed, n, n_steps, in,
# out, stream) in random mode, (n, n_steps, in, actions, out, stream) in
# buffer mode
_SPEC_RANDOM_ARGS = [ctypes.c_uint64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                     ctypes.c_void_p, ctypes.c_void_p]
_SPEC_BUFFER_ARGS = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                     ctypes.c_void_p, ctypes.c_void_p]
# the size queries of a specialised library: a family's constant layout,
# then the kernel's own constants
SPEC_LAYOUT_SUFFIXES = ("n_const", "n_row_const", "n_flag", "n_spec")


def spec_library(library, prefix, kernels, counts):
    """The loaded library of a specialised source (``csrc/<library>.cu``):
    each kernel takes ``(consts, flags, spec, ...)`` where its step is a
    universal family's (four ``counts``: the family's constants, rows and
    flags, then the kernel's own), ``(spec, ...)`` where it carries its
    own (one count), followed by ``(seed, n, n_steps, in, out, stream)``
    in random mode and ``(n, n_steps, in, actions, out, stream)`` in
    buffer mode."""
    lead = [ctypes.c_void_p] * (3 if len(counts) > 1 else 1)
    argtypes = {k: lead + (_SPEC_RANDOM_ARGS if "random" in k else _SPEC_BUFFER_ARGS)
                for k in kernels}
    return family_library(library, prefix, argtypes, counts,
                          SPEC_LAYOUT_SUFFIXES[-len(counts):])
