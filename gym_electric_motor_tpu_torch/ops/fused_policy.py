"""Policy-in-the-loop rollouts: the in-kernel actor MLP for RL evaluation,
PPO collection and in-kernel REINFORCE training on Finite-CC-PMSM-v0, and the
universal policy recorder, PPO's collection engine on every catalog id.

Counterpart of ``_policy_pmsm_ctx``, ``make_fused_policy_rollout``,
``make_fused_policy_record_rollout``, ``flatten_policy_params``,
``make_fused_reinforce_rollout``, ``unflatten_policy_grads``,
``make_fused_reinforce_trainer``, ``policy_obs_host``, ``_policy_family``,
``policy_obs_dim``, ``policy_act_ns``, ``policy_n_cont``,
``make_fused_policy_record_universal`` and ``fused_policy_init_planes`` in
``gym_electric_motor_tpu/ops/pallas_policy.py``.  Four kernels written in
CUDA (``csrc/fused_policy.cu``, over ``csrc/policy_step.cuh`` and the PMSM
step of ``csrc/pmsm_step.cuh``) carry the Finite-CC-PMSM work on the GPU,
and one kernel per family the universal recorder's (``UNIVERSAL_KERNELS``:
``<family>_policy_record`` of ``csrc/fused_<family>_policy.cu``, over
``csrc/policy_heads.cuh`` and the family's ``*_action_step``):

========================== ===========================================
``policy_rollout``         T steps with the MLP choosing the action
                           (categorical or greedy; Wiener or constant
                           references), reduced to the final state, reward
                           sums and termination counts (with Wiener
                           references producer warps draw and consumer
                           warps step, ``policy_rollout_layout``)
``policy_record``          the categorical, Wiener step with the 7-feature
                           observation, every step recorded (PPO
                           collection; at PPO's width eight lanes of a
                           warp an env, ``policy_record_layout``)
``reinforce_rollout``      the 6-feature step with Gumbel-max or greedy
                           actions and the policy gradient accumulated per
                           env from eligibility traces, which stay on
                           chip for the whole launch: e in the registers
                           of trace warps beside the step warps, G in
                           shared memory (``reinforce_layout``)
``reinforce_reduce``       the per-env gradient sums reduced to the
                           ``(P, 128)`` block in a fixed order
``<family>_policy_record`` any id's observation (the family's
                           ``obs_spec``, the referenced quantities, the
                           references), factorised or joint categorical
                           heads or squashed-Gaussian duties, the family's
                           step, every step recorded (the DC family's at
                           PPO's width on lane groups,
                           ``policy_universal_layout``)
========================== ===========================================

The PMSM kernels' policy is the 2-layer tanh MLP of ``parallel/sharded.py``
with H in {8, 16, 32} hidden units and 8 logits; its weights are the flat
float32 vectors ``w1 (F*H,)``, ``b1 (H,)``, ``w2 (H*8,)``, ``b2 (8,)``
(row-major ``obs @ w1``); the universal recorder's take A logits (the summed
or joint heads, or the duty channels' means) and 1 to 32 hidden units.  Each
kernel has a plain PyTorch version here (``*_plain``) with the same
arithmetic in the same order: every sum is an explicit loop in the kernel's
order, never a matrix product.  A wrapper runs the plain
version only for tensors on the CPU; for CUDA tensors it launches the kernel
(and counts the launch in ``LAUNCHES``) or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import cuda_build
from . import fused_dc_family as dcf
from . import fused_dfim_family as dff
from . import fused_eesm_family as ef
from . import fused_induction_family as indf
from . import fused_srm_family as srf
from . import fused_sync_family as sf
from .fused_common import (
    LANE,
    TWO_PI,
    PhiloxBits,
    RING_LAYOUT_FIELDS,
    PolicyBits,
    ReinforceBits,
    check_planes,
    check_rollout_inputs,
    family_library,
    launch_kernel,
    named_ring_layout,
    ptr_array,
    reference_step,
    seed_u64,
    uniform_from_bits,
)
from .fused_sync import (
    CONST_NAMES,
    PmsmConsts,
    _check,
    _planes,
    _ptrs,
    _random_init,
    action_step,
    wiener_advance,
    wiener_advance_pair,
)

_f32 = np.float32

N_ACTIONS = 8
HIDDEN_SIZES = (8, 16, 32)
STATE_FILTER = ("omega", "i_sd", "i_sq", "epsilon")
# Order of the constants after CONST_NAMES, the same as PolicyConstIndex in
# csrc/policy_step.cuh.
POLICY_CONST_NAMES = ("omega_n", "inv_eps_lim", "pi")

KERNELS = ("policy_rollout", "policy_record", "reinforce_rollout", "reinforce_reduce")
# the universal policy recorder's kernel of each family, csrc/fused_<family>_policy.cu
UNIVERSAL_KERNELS = ("sync_policy_record", "dc_policy_record", "induction_policy_record",
                     "eesm_policy_record", "dfim_policy_record", "srm_policy_record")

# launches of each CUDA kernel since the last reset_launches()
LAUNCHES = dict.fromkeys(KERNELS + UNIVERSAL_KERNELS, 0)


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def n_policy_params(n_features, hidden):
    """P = F*H + H + 8*H + 8, the length of the flat weight vector."""
    return n_features * hidden + hidden + hidden * N_ACTIONS + N_ACTIONS


class PolicyConsts(PmsmConsts):
    """``PmsmConsts`` plus the constants of ``_policy_pmsm_ctx`` that the
    PMSM kernels lack (the speed feature and the angle scale).  The env must
    observe ``state_filter=('omega', 'i_sd', 'i_sq', 'epsilon')``: the
    kernels rebuild that observation from their state."""

    def __init__(self, env):
        super().__init__(env)
        got = tuple(env.state_names[i] for i in np.asarray(env._state_filter))
        if got != STATE_FILTER:
            raise ValueError(f"the policy kernels observe {STATE_FILTER}: build the env with "
                             f"state_filter={STATE_FILTER!r}, not {got!r}")
        ps = env.physical_system
        names = list(ps.state_names)
        lim = np.asarray(ps.limits)
        values = dict(omega_n=float(ps.load.omega_fixed) / float(lim[names.index("omega")]),
                      inv_eps_lim=1.0 / float(lim[names.index("epsilon")]), pi=np.pi)
        extra = np.array([_f32(values[n]) for n in POLICY_CONST_NAMES], dtype=np.float32)
        self.host = np.concatenate([self.host, extra])
        self.f.update({n: float(v) for n, v in zip(POLICY_CONST_NAMES, extra)})


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def _col(v, like):
    """A weight vector as a column that broadcasts over the plane ``like``."""
    return v.reshape((-1,) + (1,) * like.dim())


def mlp_forward(w1, b1, w2, b2, obs, n_out=N_ACTIONS):
    """``h = tanh(b1 + obs @ w1)``, ``logits = b2 + h @ w2`` for a list of F
    feature planes, each sum taken in index order (``mlp_forward``).
    Returns ``h (H, ...)`` and ``logits (n_out, ...)``."""
    hidden = b1.numel()
    w1 = w1.reshape(len(obs), hidden)
    acc = _col(b1, obs[0]) + _col(w1[0], obs[0]) * obs[0]
    for f in range(1, len(obs)):
        acc = acc + _col(w1[f], obs[f]) * obs[f]
    h = torch.tanh(acc)
    w2 = w2.reshape(hidden, n_out)
    logits = _col(b2, h[0]) + _col(w2[0], h[0]) * h[0]
    for j in range(1, hidden):
        logits = logits + _col(w2[j], h[j]) * h[j]
    return h, logits


def argmax8(logits):
    """First maximum wins (strict >)."""
    best = logits[0]
    action = torch.zeros(best.shape, dtype=torch.int32, device=best.device)
    for a in range(1, N_ACTIONS):
        take = logits[a] > best
        best = torch.where(take, logits[a], best)
        action = torch.where(take, a, action)
    return action


def sample_inverse_cdf(logits, u):
    """Inverse-CDF categorical sample over the softmax of the ``n`` logits
    (``n`` exps, one uniform): the last a with ``u * total >= cumsum(exp)[a
    - 1]``."""
    n = logits.shape[0]
    m = logits[0]
    for a in range(1, n):
        m = torch.maximum(m, logits[a])
    es = torch.exp(logits - m)
    total = es[0]
    for a in range(1, n):
        total = total + es[a]
    uu = u * total
    cum = es[0]
    action = torch.zeros(m.shape, dtype=torch.int32, device=m.device)
    for a in range(1, n):
        action = torch.where(uu >= cum, a, action)
        cum = cum + es[a]
    return action


def _obs6(k, st):
    """The 6-feature observation (``policy_obs6``): the angle wrapped to
    (-pi, pi] and scaled by 1 / pi."""
    eps = st["eps"]
    eps_w = eps - k["two_pi"] * torch.floor(eps * k["inv_two_pi"])
    eps_w = torch.where(eps_w > k["pi"], eps_w - k["two_pi"], eps_w)
    return [torch.full_like(eps, k["omega_n"]), st["i_sd"] * k["inv_i_lim"],
            st["i_sq"] * k["inv_i_lim"], eps_w * k["inv_eps_lim"], st["rv_d"], st["rv_q"]]


def _const_init(i_sd0, i_sq0, eps0, ref_d, ref_q):
    return dict(i_sd=i_sd0.clone(), i_sq=i_sq0.clone(), eps=eps0.clone(),
                c=torch.cos(eps0), s=torch.sin(eps0), rv_d=ref_d.clone(), rv_q=ref_q.clone())


def _modes(sample, ref_mode):
    if sample not in ("categorical", "greedy"):
        raise ValueError(f"sample must be 'categorical' or 'greedy', got {sample!r}")
    if ref_mode not in ("wiener", "const"):
        raise ValueError(f"ref_mode must be 'wiener' or 'const', got {ref_mode!r}")
    return sample == "greedy", ref_mode == "wiener"


def _words(bits, t, shape):
    return [w.reshape(shape) for w in bits.step_words(t)]


def policy_rollout_plain(consts, seed, w1, b1, w2, b2, i_sd0, i_sq0, eps0, ref_d, ref_q,
                         n_steps, sample="categorical", ref_mode="wiener", bits=None):
    """Plain version of ``policy_rollout``: ``(i_sd, i_sq, eps, reward_sum,
    term_count)``.  ``bits`` replaces the Philox bit source (an object with
    ``init_words()`` and ``step_words(t)``, see ``fused_common.PhiloxBits``;
    the first step word is the action uniform)."""
    greedy, wiener = _modes(sample, ref_mode)
    k = consts.f
    bits = bits or PhiloxBits(seed, i_sd0.numel(), i_sd0.device)
    st = (_random_init(k, bits.init_words(), i_sd0, i_sq0, eps0) if wiener
          else _const_init(i_sd0, i_sq0, eps0, ref_d, ref_q))
    reward = torch.zeros_like(i_sd0)
    terms = torch.zeros_like(i_sd0)
    for t in range(n_steps):
        _h, logits = mlp_forward(w1, b1, w2, b2, _obs6(k, st))
        words = _words(bits, t, i_sd0.shape) if (wiener or not greedy) else None
        action = argmax8(logits) if greedy else sample_inverse_cdf(logits, uniform_from_bits(words[0]))
        st, (_a, r, done, _rd, _rq) = action_step(k, st, action)
        reward = reward + r
        terms = terms + done
        if wiener:
            wiener_advance_pair(k, st, done > 0.5, *words[1:])
    return st["i_sd"], st["i_sq"], st["eps"], reward, terms


def policy_record_plain(consts, seed, w1, b1, w2, b2, i_sd0, i_sq0, eps0, n_steps, bits=None):
    """Plain version of ``policy_record``: per step the post-reset (i_sd,
    i_sq, eps), the references the policy observed (and the reward was
    taken against), the action, the reward and the done flag."""
    k = consts.f
    bits = bits or PhiloxBits(seed, i_sd0.numel(), i_sd0.device)
    st = _random_init(k, bits.init_words(), i_sd0, i_sq0, eps0)
    omega_n = torch.full_like(i_sd0, k["omega_n"])
    rec = [[] for _ in range(8)]
    for t in range(n_steps):
        obs = [omega_n, st["i_sd"] * k["inv_i_lim"], st["i_sq"] * k["inv_i_lim"], st["c"], st["s"],
               st["rv_d"], st["rv_q"]]
        _h, logits = mlp_forward(w1, b1, w2, b2, obs)
        words = _words(bits, t, i_sd0.shape)
        st, (a, r, done, ref_d, ref_q) = action_step(
            k, st, sample_inverse_cdf(logits, uniform_from_bits(words[0])))
        wiener_advance_pair(k, st, done > 0.5, *words[1:])
        for lst, x in zip(rec, (st["i_sd"], st["i_sq"], st["eps"], ref_d, ref_q, a, r, done)):
            lst.append(x)
    if n_steps == 0:
        shape = (0,) + tuple(i_sd0.shape)
        return tuple(torch.empty(shape, dtype=torch.int32 if j == 5 else torch.float32,
                                 device=i_sd0.device) for j in range(8))
    return tuple(torch.stack(lst) for lst in rec)


def reinforce_reduce_plain(acc):
    """``(P, N)`` per-env gradient sums -> ``(P, 128)``: the rows of 128 envs
    added in ascending order (``reinforce_reduce``)."""
    rows = acc.reshape(acc.shape[0], -1, LANE)
    out = rows[:, 0]
    for r in range(1, rows.shape[1]):
        out = out + rows[:, r]
    return out


def reinforce_rollout_plain(consts, seed, baseline, w1, b1, w2, b2, i_sd0, i_sq0, eps0, ref_d,
                            ref_q, n_steps, gamma=0.99, sample="categorical", ref_mode="wiener",
                            bits=None):
    """Plain version of ``reinforce_rollout`` followed by
    ``reinforce_reduce``: ``(i_sd, i_sq, eps, reward_sum, term_count,
    grad_block)``.  ``baseline`` is a float or a one-element tensor."""
    greedy, wiener = _modes(sample, ref_mode)
    k = consts.f
    shape = i_sd0.shape
    bits = bits or ReinforceBits(seed, i_sd0.numel(), i_sd0.device)
    st = (_random_init(k, bits.init_words(), i_sd0, i_sq0, eps0) if wiener
          else _const_init(i_sd0, i_sq0, eps0, ref_d, ref_q))
    hidden = b1.numel()
    n_params = n_policy_params(6, hidden)
    gamma = float(_f32(gamma))
    baseline = baseline.reshape(()) if isinstance(baseline, torch.Tensor) else float(_f32(baseline))
    w2m = w2.reshape(hidden, N_ACTIONS)
    trace = torch.zeros((n_params,) + tuple(shape), dtype=torch.float32, device=i_sd0.device)
    acc = torch.zeros_like(trace)
    viol_prev = torch.zeros_like(i_sd0)
    reward_sum = torch.zeros_like(i_sd0)
    terms = torch.zeros_like(i_sd0)
    onehot_ids = _col(torch.arange(N_ACTIONS, device=i_sd0.device), i_sd0)
    for t in range(n_steps):
        obs = _obs6(k, st)
        h, logits = mlp_forward(w1, b1, w2, b2, obs)
        words = _words(bits, t, shape) if (wiener or not greedy) else None
        if greedy:
            action = argmax8(logits)
        else:
            best = action = None
            for a in range(N_ACTIONS):
                ug = torch.clamp(uniform_from_bits(words[a]), min=k["u_min"])
                pert = logits[a] - torch.log(-torch.log(ug))
                if a == 0:
                    best = pert
                    action = torch.zeros(shape, dtype=torch.int32, device=i_sd0.device)
                else:
                    take = pert > best
                    best = torch.where(take, pert, best)
                    action = torch.where(take, a, action)
        # score onehot(a) - softmax(logits), backpropagated through the MLP
        m = logits[0]
        for a in range(1, N_ACTIONS):
            m = torch.maximum(m, logits[a])
        ex = torch.exp(logits - m)
        z = ex[0]
        for a in range(1, N_ACTIONS):
            z = z + ex[a]
        inv_z = 1.0 / z
        dlogit = (onehot_ids == action).to(torch.float32) - ex * inv_z
        dh = _col(w2m[:, 0], dlogit[0]) * dlogit[0]
        for a in range(1, N_ACTIONS):
            dh = dh + _col(w2m[:, a], dlogit[a]) * dlogit[a]
        dpre = (1.0 - h * h) * dh
        g = torch.cat([torch.stack([o * dpre for o in obs]).reshape((-1,) + tuple(shape)), dpre,
                       (h[:, None] * dlogit[None]).reshape((-1,) + tuple(shape)), dlogit])

        st["c"], st["s"] = torch.cos(st["eps"]), torch.sin(st["eps"])
        st, (_a, r, done, _rd, _rq) = action_step(k, st, action)
        reward_sum = reward_sum + r
        terms = terms + done
        trace = trace * (gamma * (1.0 - viol_prev)) + g
        acc = acc + (r - baseline) * trace
        viol_prev = done
        if wiener:
            u1d, u1q, u2d, u2q = (uniform_from_bits(w) for w in words[8:12])
            draws = {"d": torch.sqrt(-2.0 * torch.log(torch.clamp(u1d, min=k["u_min"])))
                     * torch.cos(k["two_pi"] * u2d),
                     "q": torch.sqrt(-2.0 * torch.log(torch.clamp(u1q, min=k["u_min"])))
                     * torch.cos(k["two_pi"] * u2q)}
            wiener_advance(k, st, done > 0.5, draws, {"d": (words[12], words[14]),
                                                      "q": (words[13], words[15])},
                           {"d": words[16], "q": words[17]})
    grad = reinforce_reduce_plain(acc.reshape(n_params, -1))
    return st["i_sd"], st["i_sq"], st["eps"], reward_sum, terms, grad


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    "policy_rollout": [_P, ctypes.c_uint64, _I, _I, _I, _I, _I] + [_P] * 14 + [_P],
    "policy_record": [_P, ctypes.c_uint64, _I, _I, _I] + [_P] * 15 + [_P],
    "policy_record_layout": [_I, _P],
    "policy_rollout_layout": [_I, _I, _I, _P],
    "reinforce_rollout": ([_P, ctypes.c_uint64, _I, _I, _I, _I, _I, ctypes.c_float]
                          + [_P] * 16 + [_P]),
    "reinforce_reduce": [_I, _I, _P, _P, _P],
    "reinforce_shape": [_I, _P],
}

# reinforce_rollout's role split at each H (ReinforceShape in
# csrc/reinforce_split.cuh): step warps a block, trace warps per step warp,
# blocks an SM that the registers must allow; the steps of a ring slot; and
# the setmaxnreg budgets of the step and trace warps of a block of four step
# warps
REINFORCE_SHAPES = {8: (1, 4, 4), 16: (4, 2, 1), 32: (1, 8, 2)}
REINFORCE_K = 2
REINFORCE_REGS = (104, 200)


def reinforce_layout(hidden, n_envs):
    """The launch of ``reinforce_rollout`` at H ``hidden`` over ``n_envs``
    envs (csrc/reinforce_split.cuh): a block of 32 SW envs holds SW step
    warps and T trace warps per step warp (with four step warps, their
    warpgroup gives registers to the trace warps' under setmaxnreg), the
    step warps write the W = H + 17 words of each env-step (observation,
    logits, action, adv, geff, hidden layer) into a ring of two slots of K
    steps in shared memory, and a trace thread takes
    the score and its backward pass for H / T hidden units and keeps e of
    their parameters (15 each) and of 8 / T entries of b2 in its registers
    and their G in shared memory after the ring, for the whole launch."""
    if hidden not in REINFORCE_SHAPES:
        raise ValueError(f"the policy kernels are built for H in {HIDDEN_SIZES}, got {hidden}")
    SW, T, B = REINFORCE_SHAPES[hidden]
    E, K = 32 * SW, REINFORCE_K
    words = hidden + 17
    own = (hidden // T) * (6 + 1 + N_ACTIONS) + N_ACTIONS // T
    n_params = n_policy_params(6, hidden)
    step_regs, trace_regs = REINFORCE_REGS if SW > 1 else (0, 0)
    return {"design": "role split: step warps and trace warps, e in the trace warps' "
                      "registers, G in shared memory",
            "step_warps": SW, "trace_warps": T, "K": K, "slots": 2, "words": words,
            "smem_bytes": (2 * K * words + n_params) * E * 4, "threads": E * (1 + T),
            "envs_per_block": E, "blocks": -(-int(n_envs) // E), "params": n_params,
            "params_per_trace_thread": own, "min_blocks_per_sm": B,
            "setmaxnreg_step": step_regs, "setmaxnreg_trace": trace_regs}


def _lib():
    lib = cuda_build.load("fused_policy")
    if not getattr(lib, "_gemx_typed", False):
        for name, argtypes in _ARGTYPES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.policy_n_const.restype = ctypes.c_int
        lib.gemx_policy_error_string.argtypes = [ctypes.c_int]
        lib.gemx_policy_error_string.restype = ctypes.c_char_p
        if lib.policy_n_const() != len(CONST_NAMES) + len(POLICY_CONST_NAMES):
            raise RuntimeError("csrc/policy_step.cuh and POLICY_CONST_NAMES disagree on the constants")
        for hidden in HIDDEN_SIZES:
            out = (ctypes.c_int * 10)()
            lib.reinforce_shape(hidden, out)
            lay = reinforce_layout(hidden, 0)
            want = [lay[k] for k in ("trace_warps", "K", "words", "smem_bytes", "threads",
                                     "envs_per_block", "params_per_trace_thread",
                                     "min_blocks_per_sm", "setmaxnreg_step", "setmaxnreg_trace")]
            if list(out) != want:
                raise RuntimeError(f"csrc/reinforce_split.cuh and reinforce_layout disagree at "
                                   f"H {hidden}: {list(out)} against {want}")
        lib._gemx_typed = True
    return lib


def _call(name, device, *args):
    """Call kernel ``name`` on the current stream of ``device``; raise on
    the error code it returns."""
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: {lib.gemx_policy_error_string(rc).decode()}")


def _launch(name, device, *args):
    _call(name, device, *args)
    LAUNCHES[name] += 1


def _weights(n_features, w1, b1, w2, b2, device):
    """Validate the flat weights; returns H."""
    if not isinstance(b1, torch.Tensor) or b1.dim() != 1:
        raise ValueError("b1 must be a 1-D tensor of H floats")
    hidden = b1.shape[0]
    if hidden not in HIDDEN_SIZES:
        raise ValueError(f"the policy kernels are built for H in {HIDDEN_SIZES}, got {hidden}")
    for name, x, n in (("w1", w1, n_features * hidden), ("b1", b1, hidden),
                       ("w2", w2, hidden * N_ACTIONS), ("b2", b2, N_ACTIONS)):
        _check(name, x, (n,), torch.float32, device)
    return hidden


def _refs(ref_d, ref_q, wiener, i_sd0):
    """The reference planes: unused in Wiener mode (None is passed on), held
    constant in const mode (None reads as zeros)."""
    if wiener:
        return None, None
    ref_d = torch.zeros_like(i_sd0) if ref_d is None else ref_d
    ref_q = torch.zeros_like(i_sd0) if ref_q is None else ref_q
    _check("ref_d", ref_d, i_sd0.shape, torch.float32, i_sd0.device)
    _check("ref_q", ref_q, i_sd0.shape, torch.float32, i_sd0.device)
    return ref_d, ref_q


def _ptr(x):
    return None if x is None else x.data_ptr()


def policy_rollout(consts: PolicyConsts, seed: int, w1, b1, w2, b2, i_sd0, i_sq0, eps0,
                   ref_d, ref_q, n_steps: int, sample="categorical", ref_mode="wiener"):
    """``(i_sd, i_sq, eps, reward_sum, term_count)``, each ``(R, 128)``."""
    greedy, wiener = _modes(sample, ref_mode)
    device, R = _planes(i_sd0, i_sq0, eps0)
    _weights(6, w1, b1, w2, b2, device)
    ref_d, ref_q = _refs(ref_d, ref_q, wiener, i_sd0)
    if device.type == "cpu":
        return policy_rollout_plain(consts, seed, w1, b1, w2, b2, i_sd0, i_sq0, eps0, ref_d,
                                    ref_q, n_steps, sample, ref_mode)
    outs = _rollout_launch(consts, seed, w1, b1, w2, b2, i_sd0, i_sq0, eps0, ref_d, ref_q,
                           n_steps, R * LANE, greedy, wiener)
    LAUNCHES["policy_rollout"] += 1
    return tuple(x.reshape(R, LANE) for x in outs)


def _rollout_launch(consts, seed, w1, b1, w2, b2, i_sd0, i_sq0, eps0, ref_d, ref_q, n_steps,
                    n_envs, greedy, wiener):
    """policy_rollout's kernel on the first ``n_envs`` envs of the planes:
    the 5 outputs, each ``(n_envs,)``; not counted in ``LAUNCHES``."""
    outs = [torch.empty(n_envs, dtype=torch.float32, device=i_sd0.device) for _ in range(5)]
    _call("policy_rollout", i_sd0.device, consts.host.ctypes.data,
          int(seed) & 0xFFFFFFFFFFFFFFFF, n_envs, int(n_steps), b1.shape[0], int(greedy),
          int(wiener), *_ptrs(w1, b1, w2, b2, i_sd0, i_sq0, eps0), _ptr(ref_d), _ptr(ref_q),
          *_ptrs(*outs))
    return outs


def policy_rollout_layout(hidden, sample="categorical", ref_mode="wiener"):
    """The launch of ``policy_rollout`` at H ``hidden`` in these modes
    (csrc/fused_policy.cu): with Wiener references its ring
    (csrc/ring_pipe.cuh's RingLayout: consumer and producer warps, K steps
    a slot, slots, words a step, shared-memory bytes) and each role's
    register budget (setmaxnreg), with constant ones one thread per env;
    ``design`` names it."""
    greedy, wiener = _modes(sample, ref_mode)
    out = (ctypes.c_int * (len(RING_LAYOUT_FIELDS) + 2))()
    if _lib().policy_rollout_layout(int(hidden), int(greedy), int(wiener), out) != 0:
        raise ValueError(f"the policy kernels are built for H in {HIDDEN_SIZES}, got {hidden}")
    return named_ring_layout(out, ("consumer_registers", "producer_registers"))


def policy_record(consts: PolicyConsts, seed: int, w1, b1, w2, b2, i_sd0, i_sq0, eps0,
                  n_steps: int):
    """``(i_sd, i_sq, eps, ref_d, ref_q, action, reward, done)``, each
    ``(T, R, 128)`` (action int32)."""
    device, R = _planes(i_sd0, i_sq0, eps0)
    _weights(7, w1, b1, w2, b2, device)
    if device.type == "cpu":
        return policy_record_plain(consts, seed, w1, b1, w2, b2, i_sd0, i_sq0, eps0, n_steps)
    outs = _record_launch(consts, seed, w1, b1, w2, b2, i_sd0, i_sq0, eps0, n_steps, R * LANE)
    LAUNCHES["policy_record"] += 1
    return tuple(x.reshape(int(n_steps), R, LANE) for x in outs)


def _record_launch(consts, seed, w1, b1, w2, b2, i_sd0, i_sq0, eps0, n_steps, n_envs):
    """policy_record's kernel on the first ``n_envs`` envs of the planes:
    the 8 outputs, each ``(T, n_envs)``; not counted in ``LAUNCHES``."""
    outs = [torch.empty((int(n_steps), n_envs), dtype=torch.int32 if j == 5 else torch.float32,
                        device=i_sd0.device) for j in range(8)]
    _call("policy_record", i_sd0.device, consts.host.ctypes.data,
          int(seed) & 0xFFFFFFFFFFFFFFFF, n_envs, int(n_steps), b1.shape[0],
          *_ptrs(w1, b1, w2, b2, i_sd0, i_sq0, eps0, *outs))
    return outs


def policy_record_layout(n_envs):
    """The launch of ``policy_record`` over ``n_envs`` envs on the current
    card (csrc/fused_policy.cu, ``record_lanes``): its lanes an env (8, 4 or
    1), whether lane 0 of a group alone samples and steps, its blocks of 128
    threads and the card's SMs, and a name for the design."""
    out = (ctypes.c_int * 4)()
    _lib().policy_record_layout(int(n_envs), out)
    lanes, lead, blocks, sms = out
    design = ("one thread per env" if lanes == 1 else
              f"{lanes} lanes an env, " + ("lane 0 stepping" if lead else "every lane stepping"))
    return {"design": design, "lanes": lanes, "lead_lane_steps": bool(lead), "blocks": blocks,
            "sms": sms}


def reinforce_rollout(consts: PolicyConsts, seed: int, baseline, w1, b1, w2, b2, i_sd0, i_sq0,
                      eps0, ref_d, ref_q, n_steps: int, gamma=0.99, sample="categorical",
                      ref_mode="wiener"):
    """``(i_sd, i_sq, eps, reward_sum, term_count, grad_block)``: the
    ``reinforce_rollout`` kernel and then ``reinforce_reduce``.
    ``grad_block`` is ``(P, 128)``, packed ``[w1 | b1 | w2 | b2]`` like the
    weights; its lane sum is the unnormalised ascent direction.
    ``baseline`` is a float or a one-element float32 tensor on the planes'
    device (a trainer keeps it there)."""
    greedy, wiener = _modes(sample, ref_mode)
    device, R = _planes(i_sd0, i_sq0, eps0)
    hidden = _weights(6, w1, b1, w2, b2, device)
    ref_d, ref_q = _refs(ref_d, ref_q, wiener, i_sd0)
    if isinstance(baseline, torch.Tensor):
        _check("baseline", baseline, (1,), torch.float32, device)
    if device.type == "cpu":
        return reinforce_rollout_plain(consts, seed, baseline, w1, b1, w2, b2, i_sd0, i_sq0,
                                       eps0, ref_d, ref_q, n_steps, gamma, sample, ref_mode)
    if not isinstance(baseline, torch.Tensor):
        baseline = torch.full((1,), float(baseline), dtype=torch.float32, device=device)
    outs = _reinforce_launch(consts, seed, baseline, w1, b1, w2, b2, i_sd0, i_sq0, eps0, ref_d,
                             ref_q, n_steps, R * LANE, gamma, greedy, wiener)
    LAUNCHES["reinforce_rollout"] += 1
    return tuple(x.reshape(R, LANE) for x in outs[:5]) + (reinforce_reduce(outs[5]),)


def _reinforce_launch(consts, seed, baseline, w1, b1, w2, b2, i_sd0, i_sq0, eps0, ref_d, ref_q,
                      n_steps, n_envs, gamma, greedy, wiener):
    """reinforce_rollout's kernel on the first ``n_envs`` envs of the
    planes (``baseline`` a one-element tensor on their device): the 5
    outputs, each ``(n_envs,)``, and the ``(P, n_envs)`` per-env gradient
    sums; not counted in ``LAUNCHES``."""
    device = i_sd0.device
    outs = [torch.empty(n_envs, dtype=torch.float32, device=device) for _ in range(5)]
    acc = torch.empty((n_policy_params(6, b1.shape[0]), n_envs), dtype=torch.float32,
                      device=device)
    _call("reinforce_rollout", device, consts.host.ctypes.data, int(seed) & 0xFFFFFFFFFFFFFFFF,
          n_envs, int(n_steps), b1.shape[0], int(greedy), int(wiener), float(gamma),
          *_ptrs(baseline, w1, b1, w2, b2, i_sd0, i_sq0, eps0), _ptr(ref_d), _ptr(ref_q),
          *_ptrs(*outs, acc))
    return outs + [acc]


def reinforce_reduce(acc):
    """``(P, N)`` float32 per-env gradient sums -> the ``(P, 128)`` block
    (``reinforce_reduce``; the plain version for a CPU tensor)."""
    if not isinstance(acc, torch.Tensor) or acc.dim() != 2 or acc.shape[1] % LANE \
            or acc.shape[1] == 0:
        raise ValueError(f"acc must be a (P, N) tensor with N a positive multiple of {LANE}")
    _check("acc", acc, acc.shape, torch.float32, acc.device)
    if acc.device.type == "cpu":
        return reinforce_reduce_plain(acc)
    grad = torch.empty((acc.shape[0], LANE), dtype=torch.float32, device=acc.device)
    _launch("reinforce_reduce", acc.device, acc.shape[1], acc.shape[0], acc.data_ptr(),
            grad.data_ptr())
    return grad


# ---------------------------------------------------------------------------
# entry points (those of the JAX package)
# ---------------------------------------------------------------------------


def make_fused_policy_rollout(env, n_steps, n_envs, hidden=16, sample="categorical",
                              ref_mode="wiener"):
    """Fused policy-in-the-loop rollout of Finite-CC-PMSM-v0: the 2-layer
    tanh MLP of ``parallel/sharded.py`` picks each step's action in the
    kernel, then physics, references, reward and reset run as in
    ``make_fused_pmsm_rollout``.

    ``env`` must use ``state_filter=('omega', 'i_sd', 'i_sq', 'epsilon')``:
    the 6-feature observation is those 4 states plus the two current
    references.  Returns ``rollout(seed, w1, b1, w2, b2, i_sd0, i_sq0, eps0,
    ref_d=None, ref_q=None) -> (i_sd, i_sq, eps, reward_sum, term_count)``
    with flat float32 weights (``flatten_policy_params``).
    ``sample='greedy'`` takes argmax actions; ``ref_mode='const'`` holds the
    given reference planes (zeros when None)."""
    _modes(sample, ref_mode)
    if n_envs % LANE:
        raise ValueError(f"n_envs must be a multiple of {LANE}")
    if hidden not in HIDDEN_SIZES:
        raise ValueError(f"the policy kernels are built for H in {HIDDEN_SIZES}, got {hidden}")
    R = n_envs // LANE
    consts = PolicyConsts(env)

    def rollout(seed, w1, b1, w2, b2, i_sd0, i_sq0, eps0, ref_d=None, ref_q=None):
        _check("i_sd0", i_sd0, (R, LANE), torch.float32, i_sd0.device)
        return policy_rollout(consts, seed, w1, b1, w2, b2, i_sd0, i_sq0, eps0, ref_d, ref_q,
                              n_steps, sample, ref_mode)
    return rollout


def make_fused_policy_record_rollout(env, n_steps, n_envs, hidden=16):
    """Fused policy-in-the-loop trajectory recorder for Finite-CC-PMSM-v0,
    the collection engine of ``parallel.sharded.make_fused_ppo_trainer``.

    The policy observes 7 features ``(omega_n, i_sd/l, i_sq/l, cos(eps),
    sin(eps), ref_d, ref_q)`` (the angle as the incremental rotation's
    cos/sin), samples a categorical action, and every step's post-step
    ``(i_sd, i_sq, eps)``, the references it observed, the action, reward and
    done are recorded.  Returns ``rollout(seed, w1, b1, w2, b2, i_sd0, i_sq0,
    eps0) -> dict`` of ``(n_steps, n_envs // 128, 128)`` tensors keyed by
    ``rollout.signals`` (float32, the action int32), with the metadata of
    the JAX function (``state_names``, ``ref_names``, ``act_names``,
    ``act_ns``, ``obs_spec``, ``obs_dim``, ``n_state``)."""
    if n_envs % LANE:
        raise ValueError(f"n_envs must be a multiple of {LANE}")
    if hidden not in HIDDEN_SIZES:
        raise ValueError(f"the policy kernels are built for H in {HIDDEN_SIZES}, got {hidden}")
    R = n_envs // LANE
    consts = PolicyConsts(env)
    names_out = ("i_sd", "i_sq", "eps", "ref_d", "ref_q", "action", "reward", "done")

    def rollout(seed, w1, b1, w2, b2, i_sd0, i_sq0, eps0):
        _check("i_sd0", i_sd0, (R, LANE), torch.float32, i_sd0.device)
        return dict(zip(names_out, policy_record(consts, seed, w1, b1, w2, b2, i_sd0, i_sq0,
                                                 eps0, n_steps)))

    rollout.signals = names_out
    rollout.state_names = ("i_sd", "i_sq", "eps")
    rollout.ref_names = ("ref_d", "ref_q")
    rollout.act_names = ("action",)
    rollout.act_ns = (N_ACTIONS,)
    inv_i_lim = consts.f["inv_i_lim"]
    rollout.obs_spec = (("const", consts.f["omega_n"]), ("state", 0, inv_i_lim),
                        ("state", 1, inv_i_lim), ("cos", 2), ("sin", 2))
    rollout.obs_dim = 7
    rollout.n_state = 3
    rollout.consts = consts
    return rollout


def flatten_policy_params(params):
    """A policy's weights -> the flat ``(w1, b1, w2, b2)`` float32 vectors
    the kernels take (row-major, no transpose).  ``params`` is a
    ``parallel.sharded.Policy`` or a mapping with those four keys."""
    def get(nm):
        return params[nm] if hasattr(params, "keys") else getattr(params, nm)

    return tuple(torch.as_tensor(get(nm)).detach().to(torch.float32).reshape(-1).contiguous()
                 for nm in ("w1", "b1", "w2", "b2"))


def unflatten_policy_grads(grad_block, obs_dim=6, n_actions=8, hidden=16):
    """``(P, 128)`` gradient block -> ``{'w1', 'b1', 'w2', 'b2'}`` in the
    weights' shapes (the lane dimension summed)."""
    g = grad_block.sum(-1)
    f, h, a = obs_dim, hidden, n_actions
    p1, p2, p3 = f * h, h, h * a
    return {"w1": g[:p1].reshape(f, h), "b1": g[p1:p1 + p2],
            "w2": g[p1 + p2:p1 + p2 + p3].reshape(h, a), "b2": g[p1 + p2 + p3:]}


def make_fused_reinforce_rollout(env, n_steps, n_envs, hidden=16, gamma=0.99,
                                 sample="categorical", ref_mode="wiener"):
    """Fused REINFORCE rollout with the backward pass in the kernel: policy,
    sampling (Gumbel-max, or argmax with ``sample='greedy'``), physics,
    reward, reset and the policy-gradient accumulation per env

        e_t = gamma * (1 - reset_{t-1}) * e_{t-1} + grad log pi(a_t | s_t)
        G  += (r_t - baseline) * e_t

    reduced to one ``(n_params, 128)`` block.  The JAX function's
    ``block_rows`` (its TPU grid tiling) has no counterpart: each env's
    traces stay on chip for the whole launch (``reinforce_layout``), and
    its gradient sums are written once, to one ``[n_params, n_envs]``
    tensor.

    Returns ``rollout(seed, baseline, w1, b1, w2, b2, i_sd0, i_sq0, eps0,
    ref_d=None, ref_q=None) -> (i_sd, i_sq, eps, reward_sum, term_count,
    grad_block)``; ``unflatten_policy_grads`` unpacks the block."""
    _modes(sample, ref_mode)
    if n_envs % LANE:
        raise ValueError(f"n_envs must be a multiple of {LANE}")
    if hidden not in HIDDEN_SIZES:
        raise ValueError(f"the policy kernels are built for H in {HIDDEN_SIZES}, got {hidden}")
    R = n_envs // LANE
    consts = PolicyConsts(env)

    def rollout(seed, baseline, w1, b1, w2, b2, i_sd0, i_sq0, eps0, ref_d=None, ref_q=None):
        _check("i_sd0", i_sd0, (R, LANE), torch.float32, i_sd0.device)
        return reinforce_rollout(consts, seed, baseline, w1, b1, w2, b2, i_sd0, i_sq0, eps0,
                                 ref_d, ref_q, n_steps, gamma, sample, ref_mode)
    return rollout


def make_fused_reinforce_trainer(env, n_steps, n_envs, hidden=16, gamma=0.99, lr=0.05,
                                 baseline_decay=0.9):
    """REINFORCE with the rollout and the backward pass in the kernel:
    ``train(seed, policy, n_iters) -> (policy, mean_reward (n_iters,))``.
    Each iteration is one ``make_fused_reinforce_rollout`` launch (T steps
    and the policy gradient), an ascent step ``p += lr * g / (N T)`` on the
    ``parallel.sharded.Policy`` (in place) and a moving-average reward
    baseline.  The env state carries over from one iteration to the next;
    iteration i runs with seed ``seed + i``.  Nothing is read back to the
    host inside the loop."""
    roll = make_fused_reinforce_rollout(env, n_steps, n_envs, hidden=hidden, gamma=gamma)
    R = n_envs // LANE
    denom = 1.0 / float(n_envs * n_steps)

    def train(seed, policy, n_iters):
        device = policy.w1.device
        z = torch.zeros((R, LANE), dtype=torch.float32, device=device)
        isd, isq, eps = z, z, z
        baseline = torch.zeros((1,), dtype=torch.float32, device=device)
        rs = []
        with torch.no_grad():
            for i in range(n_iters):
                out = roll(seed + i, baseline, *flatten_policy_params(policy), isd, isq, eps)
                isd, isq, eps, reward_sum, _terms, grad_block = out
                mean_r = reward_sum.sum() * denom
                grads = unflatten_policy_grads(grad_block, 6, N_ACTIONS, hidden)
                for name, g in grads.items():
                    p = getattr(policy, name)
                    p.copy_(p + lr * g * denom)
                baseline = baseline_decay * baseline + (1.0 - baseline_decay) * mean_r
                rs.append(mean_r)
        return policy, torch.stack(rs) if rs else torch.zeros((0,), device=device)

    return train


def policy_obs_host(roll, prev_states, refs):
    """The observation the kernel's MLP saw at each step, rebuilt from the
    recorded signals (``policy_obs_host``, pallas_policy.py:901-936):
    ``prev_states`` holds the pre-step state planes (the recorded post-step
    planes shifted by one, the launch's initial planes at t = 0) keyed by
    ``roll.state_names``, ``refs`` the recorded references.  Returns an
    ``(..., obs_dim)`` stack.  Angle features are cos/sin of the recorded
    angle, which match the kernel's renormalised rotation to about an ulp.
    The universal recorder's controlled-quantity features come from the
    family's own plain functions (``roll.fs_pre_step`` and
    ``roll.fs_quantities``) on the pre-step planes."""
    names = roll.state_names
    some = prev_states[names[0]]
    feats = []
    for e in roll.obs_spec:
        if e[0] == "const":
            feats.append(torch.full_like(some, e[1]))
        elif e[0] == "state":
            feats.append(prev_states[names[e[1]]] * float(_f32(e[2])))
        elif e[0] == "cos":
            feats.append(torch.cos(prev_states[names[e[1]]]))
        elif e[0] == "sin":
            feats.append(torch.sin(prev_states[names[e[1]]]))
        else:
            raise ValueError(f"unknown observation entry {e!r}")
    if getattr(roll, "fs_quantities", None) is not None:
        cur = tuple(prev_states[nm] for nm in names)
        feats.extend(roll.fs_quantities(cur, roll.fs_pre_step(cur)))
    for nm in roll.ref_names:
        feats.append(refs[nm])
    return torch.stack(feats, dim=-1)


# ---------------------------------------------------------------------------
# the universal policy recorder: every catalog id
# ---------------------------------------------------------------------------

# family -> (module, constants): each module has policy_surface(consts, env)
_POLICY_FAMILIES = {
    "sync": (sf, sf.SyncConsts), "dc": (dcf, dcf.DcConsts),
    "induction": (indf, indf.InductionConsts), "eesm": (ef, ef.EesmConsts),
    "dfim": (dff, dff.DfimConsts), "srm": (srf, srf.SrmConsts),
}
MAX_HIDDEN = 32     # the kernels stage up to 32 hidden units
N_FEAT_CONST = 8    # the non-angle features' constants (PolicyConst.feat)
MAX_CHANNELS = 6    # Gaussian channels (the DFIM's six duties)
MAX_HEADS = 3       # categorical heads (the SRM's three phases)


def _policy_family(env, randomize=None):
    """The family's policy surface (``_policy_family``,
    pallas_policy.py:847-873); ``randomize=`` raises."""
    from .fused_rollout import family_of

    if randomize:
        raise NotImplementedError(
            "randomize= (per-env motor parameters as state planes) is not fused yet; it "
            "arrives with queue 2, item 8 of the port")
    mod, consts = _POLICY_FAMILIES[family_of(env)]
    return mod.policy_surface(consts(env), env)


def policy_obs_dim(env):
    """Observation features of the universal policy recorder for ``env``:
    the family's ``obs_spec`` plus, per reference, the normalised
    controlled quantity and the reference value."""
    fs = _policy_family(env)
    return len(fs.obs_spec) + 2 * fs.consts.n_ref


def policy_act_ns(env):
    """The categorical heads' cardinalities of a finite env (one head per
    converter channel, e.g. EESM (8, 4)), ``None`` for a continuous one."""
    return _policy_family(env).act_ns


def policy_n_cont(env):
    """The squashed-Gaussian channels of a continuous env, 0 for a finite
    one."""
    fs = _policy_family(env)
    return 0 if fs.act_ns is not None else len(fs.consts.act_names)


class UniversalPolicy:
    """The universal recorder's build of one env: the family's constants
    and policy surface, the sizes (``obs_dim`` F, ``n_out`` A, ``n_words``
    policy uniforms per step), the dtypes of the recorded signals, and the
    host arrays the kernel takes: ``pk`` (float32: the non-angle features'
    constants, then the duties' mid and half ranges) and ``pi`` (int32: the
    head count and cardinalities, the joint flag), in the order of
    PolicyConst in csrc/policy_heads.cuh."""

    def __init__(self, env, hidden, joint_heads=False, randomize=None):
        if not 1 <= int(hidden) <= MAX_HIDDEN:
            raise ValueError(f"the policy recorder takes 1 to {MAX_HIDDEN} hidden units, "
                             f"got {hidden}")
        fs = _policy_family(env, randomize)
        c = fs.consts
        self.surface, self.consts, self.hidden = fs, c, int(hidden)
        self.cont = fs.act_ns is None
        self.act_ns = fs.act_ns
        n_act = len(c.act_names)
        if joint_heads and (self.cont or len(fs.act_ns) < 2):
            raise ValueError("joint_heads needs a multi-head finite action space")
        self.joint = bool(joint_heads)
        self.obs_dim = len(fs.obs_spec) + 2 * c.n_ref
        self.n_out = (n_act if self.cont else int(np.prod(fs.act_ns)) if self.joint
                      else int(sum(fs.act_ns)))
        self.n_words = (2 * ((n_act + 1) // 2) if self.cont
                        else 1 if self.joint else len(fs.act_ns))
        act = torch.float32 if self.cont else torch.int32
        self.dtypes = ((torch.float32,) * (c.n_state + c.n_ref) + (act,) * n_act
                       + (torch.float32, torch.float32))
        feat = [e[1] if e[0] == "const" else e[2] for e in fs.obs_spec
                if e[0] in ("const", "state")]
        mid = half = np.zeros(0, _f32)
        if self.cont:
            lo, hi = fs.act_range
            mid, half = _f32(0.5) * (lo + hi), _f32(0.5) * (hi - lo)
            self.mid, self.half = [float(x) for x in mid], [float(x) for x in half]
        pad = lambda x, n: list(x) + [0.0] * (n - len(x))  # noqa: E731
        self.pk = np.array(pad(feat, N_FEAT_CONST) + pad(mid, MAX_CHANNELS)
                           + pad(half, MAX_CHANNELS), dtype=_f32)
        ns = list(fs.act_ns or ())
        self.pi = np.array([len(ns)] + ns + [0] * (MAX_HEADS - len(ns)) + [int(self.joint)],
                           dtype=np.int32)
        self.kernel = f"{fs.family}_policy_record"


def _universal_obs(pol, st, aux):
    """The observation of the kernel's step: the ``obs_spec`` features, the
    referenced quantities of the pre-step state, the references before
    they advance."""
    fs = pol.surface
    some = st[fs.state_keys[0]]
    cs = fs.aux_cs(aux) if fs.aux_cs is not None else None
    obs = []
    for e in fs.obs_spec:
        if e[0] == "const":
            obs.append(torch.full_like(some, float(_f32(e[1]))))
        elif e[0] == "state":
            obs.append(st[fs.state_keys[e[1]]] * float(_f32(e[2])))
        else:
            obs.append(cs[0] if e[0] == "cos" else cs[1])
    obs.extend(fs.quantities(st, aux))
    obs.extend(st["rv"][:pol.consts.n_ref])
    return obs


def sample_heads(logits, act_ns, joint, words):
    """Finite actions (pallas_policy.py:1154-1187): one inverse-CDF draw
    per head over its slice of the logits, or one over the joint logits,
    decoded by radix with the last head fastest."""
    if joint:
        a = sample_inverse_cdf(logits, uniform_from_bits(words[0]))
        decoded = []
        for n in reversed(act_ns):
            decoded.append(a % n)
            a = a // n
        return decoded[::-1]
    heads, off = [], 0
    for h, n in enumerate(act_ns):
        heads.append(sample_inverse_cdf(logits[off:off + n], uniform_from_bits(words[h])))
        off += n
    return heads


def gaussian_raw(logits, std, words):
    """The raw squashed-Gaussian samples ``mu + std z`` (pallas_policy.py:
    1133-1153): a Box-Muller pair per two channels, cosine then sine."""
    two_pi = float(_f32(TWO_PI))
    zs = []
    for j in range(0, logits.shape[0], 2):
        u1, u2 = uniform_from_bits(words[j]), uniform_from_bits(words[j + 1])
        rad = torch.sqrt(-2.0 * torch.log(torch.clamp(u1, min=1e-12)))
        th = two_pi * u2
        zs.append(rad * torch.cos(th))
        zs.append(rad * torch.sin(th))
    return [logits[j] + std[j] * zs[j] for j in range(logits.shape[0])]


def policy_record_universal_plain(pol, seed, w1, b1, w2, b2, ls, states, n_steps, bits=None):
    """Plain version of the family's ``<family>_policy_record`` kernel: per
    step the post-reset states, the references the policy observed (and the
    reward was taken against), the action of each head (int32) or each
    channel's raw sample (float32), the reward and the done flag, each
    ``(T, R, 128)``.  ``bits`` replaces the Philox bit source (see
    ``fused_common.PolicyBits``)."""
    fs, c = pol.surface, pol.consts
    shape, device = states[0].shape, states[0].device
    bits = bits or PolicyBits(seed, states[0].numel(), device, c.n_ref, pol.n_words)
    st = fs.init(bits, tuple(states))
    std = torch.exp(ls) if pol.cont else None
    rec = [[] for _ in pol.dtypes]
    for t in range(n_steps):
        words, *ref_words = bits.step_words(t)
        words = [w.reshape(shape) for w in words]
        aux = fs.aux(st)
        _h, logits = mlp_forward(w1, b1, w2, b2, _universal_obs(pol, st, aux), pol.n_out)
        if pol.cont:
            recorded = gaussian_raw(logits, std, words)
            action = fs.action([m + h * torch.tanh(raw)
                                for m, h, raw in zip(pol.mid, pol.half, recorded)])
        else:
            recorded = sample_heads(logits, pol.act_ns, pol.joint, words)
            action = fs.action(recorded)
        new, (_a, r, done, refs) = fs.step(st, action, aux)
        reference_step(c.f, c.rows, c.all_const, st, new, ref_words, done > 0.5, t)
        st = new
        row = [st[key] for key in fs.state_keys] + refs + list(recorded) + [r, done]
        for lst, x in zip(rec, row):
            lst.append(x)
    if n_steps == 0:
        return tuple(torch.empty((0,) + tuple(shape), dtype=dt, device=device)
                     for dt in pol.dtypes)
    return tuple(torch.stack(lst) for lst in rec)


_UNIVERSAL_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_uint64] + [ctypes.c_int] * 3 \
    + [ctypes.c_void_p] * 8
# <family>_policy_record_design: the recorder's arguments, then the design
_DESIGN_ARGTYPES = _UNIVERSAL_ARGTYPES[:-1] + [ctypes.c_int, ctypes.c_void_p]

# The lane designs of the width rule of the recorders, every family's on
# lane groups (WideDesign and NarrowDesign in csrc/fused_<family>_policy.cu):
# lanes an env, and whether lane 0 of a group alone samples and steps the
# env.
DC_POLICY_WIDE = (8, False)
DC_POLICY_NARROW = (4, True)
SYNC_POLICY_WIDE = (8, False)
SYNC_POLICY_NARROW = (8, False)
EESM_POLICY_WIDE = (8, False)
EESM_POLICY_NARROW = (8, False)
SRM_POLICY_WIDE = (8, False)
SRM_POLICY_NARROW = (8, False)
DFIM_POLICY_WIDE = (8, False)
DFIM_POLICY_NARROW = (8, False)
INDUCTION_POLICY_WIDE = (8, False)
INDUCTION_POLICY_NARROW = (8, False)
# the universal recorders' (wide, narrow) designs
POLICY_LANE_DESIGNS = {"dc_policy_record": (DC_POLICY_WIDE, DC_POLICY_NARROW),
                       "sync_policy_record": (SYNC_POLICY_WIDE, SYNC_POLICY_NARROW),
                       "eesm_policy_record": (EESM_POLICY_WIDE, EESM_POLICY_NARROW),
                       "srm_policy_record": (SRM_POLICY_WIDE, SRM_POLICY_NARROW),
                       "dfim_policy_record": (DFIM_POLICY_WIDE, DFIM_POLICY_NARROW),
                       "induction_policy_record": (INDUCTION_POLICY_WIDE,
                                                   INDUCTION_POLICY_NARROW)}


def _universal_library(pol):
    fs = pol.surface
    mod = _POLICY_FAMILIES[fs.family][0]
    prefix = f"{fs.family}_policy"
    argtypes = {pol.kernel: _UNIVERSAL_ARGTYPES, f"{pol.kernel}_design": _DESIGN_ARGTYPES}
    lib = family_library(f"fused_{prefix}", prefix, argtypes,
                         (len(mod.CONST_NAMES), len(mod.ROW_NAMES), len(mod.FLAG_NAMES)))
    return lib, prefix


def _universal_launch(pol, device, *args):
    lib, prefix = _universal_library(pol)
    launch_kernel(lib, prefix, pol.kernel, device, LAUNCHES, *args)


def policy_universal_lanes(kernel, n_envs, sms):
    """The lanes an env and whether lane 0 alone steps, of the universal
    recorder ``kernel``'s launch over ``n_envs`` envs on a card of ``sms``
    SMs: the width rule of csrc/policy_heads_lanes.cuh (``policy_width``)
    over the kernel's designs (``POLICY_LANE_DESIGNS``).  Computed here,
    without the library."""
    blocks = -(-int(n_envs) // LANE)
    wide, narrow = POLICY_LANE_DESIGNS[kernel]
    for (lanes, lead), per_sm in ((wide, 1), (narrow, 3)):
        if blocks * lanes <= per_sm * sms:
            return lanes, lead
    return 1, False


def policy_universal_layout(kernel, n_envs):
    """The launch of the universal recorder ``kernel`` over ``n_envs`` envs
    on the current card: its lanes an env (by its width rule), whether lane
    0 of a group alone samples and steps, its blocks of 128 threads, the
    card's SMs and a name for the design."""
    if kernel not in UNIVERSAL_KERNELS:
        raise ValueError(f"unknown universal recorder {kernel!r}")
    family = kernel[:-len("_policy_record")]
    fn = getattr(cuda_build.load(f"fused_{family}_policy"), f"{family}_policy_layout")
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 4)()
    fn(int(n_envs), out)
    lanes, lead, blocks, sms = out
    design = ("one thread per env" if lanes == 1 else
              f"{lanes} lanes an env, " + ("lane 0 stepping" if lead else "every lane stepping"))
    return {"design": design, "lanes": lanes, "lead_lane_steps": bool(lead), "blocks": blocks,
            "sms": sms}


def _universal_weights(pol, w1, b1, w2, b2, ls, device):
    """Validate the flat weights (and the log-stds of a continuous env)."""
    H, F, A = pol.hidden, pol.obs_dim, pol.n_out
    for name, x, n in (("w1", w1, F * H), ("b1", b1, H), ("w2", w2, H * A), ("b2", b2, A)):
        _check(name, x, (n,), torch.float32, device)
    if pol.cont:
        _check("ls", ls, (len(pol.consts.act_names),), torch.float32, device)
    elif ls is not None:
        raise ValueError("a finite env's policy takes no log-stds")


def policy_record_universal(pol, seed, w1, b1, w2, b2, ls, states, n_steps):
    """``(*states, *refs, *actions, reward, done)``, each ``(T, R, 128)``:
    the family's ``<family>_policy_record`` kernel on CUDA tensors, its
    plain version on CPU tensors."""
    c = pol.consts
    device, R = check_planes(c, states)
    _universal_weights(pol, w1, b1, w2, b2, ls, device)
    if device.type == "cpu":
        return policy_record_universal_plain(pol, seed, w1, b1, w2, b2, ls, tuple(states),
                                             n_steps)
    outs, args = _universal_args(pol, seed, w1, b1, w2, b2, ls, states, n_steps,
                                 (int(n_steps), R, LANE))
    _universal_launch(pol, device, *args)
    return tuple(outs)


def _universal_args(pol, seed, w1, b1, w2, b2, ls, states, n_steps, shape):
    """The output tensors, each of ``shape`` (``(T, n)`` or ``(T, R,
    128)``, n envs), and the C recorder's arguments before the stream."""
    c = pol.consts
    device = states[0].device
    outs = [torch.empty(shape, dtype=dt, device=device) for dt in pol.dtypes]
    n_act = len(c.act_names)
    it = iter(outs)
    st = [next(it) for _ in range(c.n_state)]
    refs = [next(it) for _ in range(c.n_ref)]
    acts = [next(it) for _ in range(n_act)]
    act_i = acts if not pol.cont else []
    act_f = acts if pol.cont else []
    ptrs = (pol.surface.planes(st) + refs + [None] * (3 - c.n_ref)
            + act_i + [None] * (MAX_HEADS - len(act_i))
            + act_f + [None] * (MAX_CHANNELS - len(act_f)) + list(it))
    n = int(np.prod(shape[1:]))
    return outs, (c.host.ctypes.data, c.flags.ctypes.data, pol.pk.ctypes.data,
                  pol.pi.ctypes.data, seed_u64(seed), n, int(n_steps), pol.hidden,
                  *_ptrs(w1, b1, w2, b2), _ptr(ls),
                  ptr_array(pol.surface.planes(list(states))), ptr_array(ptrs))


def _policy_design_launch(pol, seed, w1, b1, w2, b2, ls, states, n_steps, n_envs,
                          one_thread=False):
    """A universal recorder on the first ``n_envs`` envs of the planes, in
    the design its width rule takes at ``n_envs`` or (``one_thread``) one
    thread per env, through its C entry ``<kernel>_design``: the recorded
    signals, each ``(T, n_envs)``; for the tests and tools that hold the
    designs against each other, not counted in ``LAUNCHES``."""
    device, R = check_planes(pol.consts, states)
    _universal_weights(pol, w1, b1, w2, b2, ls, device)
    if device.type != "cuda" or not 0 < n_envs <= R * LANE:
        raise ValueError("the designs run on CUDA planes of at least n_envs envs")
    outs, args = _universal_args(pol, seed, w1, b1, w2, b2, ls, states, n_steps,
                                 (int(n_steps), int(n_envs)))
    lib, prefix = _universal_library(pol)
    name = f"{pol.kernel}_design"
    launch_kernel(lib, prefix, name, device, {name: 0}, *args, int(one_thread))
    return tuple(outs)


def make_fused_policy_record_universal(env, n_steps, n_envs, hidden=16, randomize=None,
                                       joint_heads=False):
    """Fused policy-in-the-loop trajectory recorder for any catalog id, all
    six families and both action types (``make_fused_policy_record_universal``,
    pallas_policy.py:939-1284).

    Per step a 2-layer tanh MLP reads the family's observation (the
    ``obs_spec`` features, the normalised referenced quantities of the
    pre-step state, the references before they advance) and picks the
    converter action: a finite env samples each head from its own softmax
    by inverse CDF (or, ``joint_heads``, one softmax over the product of
    the heads, decoded by radix with the last head fastest; the recorded
    columns stay per head); a continuous env samples one squashed-Gaussian
    duty per channel, recording the raw ``mu + exp(ls) z`` while the
    converter sees ``mid + half tanh(raw)``.  Then the family's step,
    constraint, reward and reset run as in its random recorder, through the
    same plain functions and device functions.

    Returns ``rollout(seed, w1, b1, w2, b2, [ls,] *state0) -> dict`` of
    ``(n_steps, n_envs // 128, 128)`` tensors keyed by ``rollout.signals``
    (the family's states, ``ref_*``, the action columns, ``reward``,
    ``done``), with flat float32 weights ``w1 (F*hidden,)``, ``b1``, ``w2
    (hidden*A,)``, ``b2 (A,)`` (F = ``policy_obs_dim(env)``, A the summed
    or joint head sizes, or the channels) and, for a continuous env, the
    log-stds ``ls``.  The attributes are the JAX function's.  On CUDA
    tensors one launch of ``csrc/fused_<family>_policy.cu`` records it all;
    on CPU tensors the plain version runs.  The TPU grid's ``chunk`` and
    ``interpret`` have no counterpart; ``randomize=`` raises, and StateNoise
    is rejected (as by the JAX function), by the family's constants."""
    if n_envs % LANE:
        raise ValueError(f"n_envs must be a multiple of {LANE}")
    R = n_envs // LANE
    pol = UniversalPolicy(env, hidden, joint_heads, randomize)
    fs, c = pol.surface, pol.consts
    ref_names = tuple("ref_" + row["name"] for row in c.rows)
    names = c.state_names + ref_names + c.act_names + ("reward", "done")

    def rollout(seed, w1, b1, w2, b2, *rest):
        ls, state0 = (rest[0], rest[1:]) if pol.cont else (None, rest)
        check_rollout_inputs(R, n_steps, state0)
        return dict(zip(names, policy_record_universal(pol, seed, w1, b1, w2, b2, ls, state0,
                                                       n_steps)))

    def pre_step(cur):
        return fs.aux(dict(zip(fs.state_keys, cur)), afresh=True)

    def quantities(cur, aux):
        return fs.quantities(dict(zip(fs.state_keys, cur)), aux)

    rollout.signals = names
    rollout.state_names = c.state_names
    rollout.ref_names = ref_names
    rollout.act_names = c.act_names
    rollout.obs_spec = fs.obs_spec
    rollout.act_ns = pol.act_ns
    rollout.joint_heads = pol.joint
    rollout.n_out = pol.n_out
    rollout.cont = pol.cont
    rollout.act_range = fs.act_range
    rollout.obs_dim = pol.obs_dim
    rollout.n_state = c.n_state
    rollout.fs_pre_step = pre_step
    rollout.fs_quantities = quantities
    rollout.policy = pol
    rollout.consts = c
    return rollout


def fused_policy_init_planes(env, n_envs, randomize=None, device=None):
    """Initial ``(n_envs // 128, 128)`` state planes for the universal
    policy recorder and the PPO trainer (``fused_policy_init_planes``,
    pallas_policy.py:1287-1313): zeros, the in-kernel reset value of every
    plane.  The supply planes (an RC supply's u_0) and ``randomize=``'s
    parameter draws (with the JAX function's ``seed``) arrive with queue 2,
    item 8: both raise, the first in the family's constants."""
    from ..utils.device import resolve_device

    fs = _policy_family(env, randomize)
    if n_envs % LANE:
        raise ValueError(f"n_envs must be a multiple of {LANE}")
    device = resolve_device(device)
    return tuple(torch.zeros((n_envs // LANE, LANE), dtype=torch.float32, device=device)
                 for _ in range(fs.consts.n_state))
