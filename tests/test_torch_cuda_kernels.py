"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

The kernels are CUDA C++ with no CPU mode, so every test here is marked
``cuda`` and skips without a card.  The module imports neither ``jax`` nor
the JAX package, so it also runs where only PyTorch is installed (the
repository's conftest imports jax, hence ``--noconftest``):

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda_kernels.py

Tolerances: the buffer modes must match in every env at rtol 1e-4 /
atol 1e-4 (float32 RK4, the kernel's transcendentals against PyTorch's);
in the random modes a constraint-threshold flip may send an env down
another branch, so 99% of envs must match.  Angles are compared modulo 2 pi.
"""

import numpy as np
import pytest
import torch

import gym_electric_motor_tpu_torch as gt
from gym_electric_motor_tpu_torch.ops import fused_sync as fs


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels are CUDA C++ without a CPU mode")
    dev = torch.device("cuda")
    consts = fs.PmsmConsts(gt.make_functional("Finite-CC-PMSM-v0", device=dev))
    R, T = 4, 64
    rng = np.random.default_rng(8)
    start = [torch.as_tensor(rng.uniform(lo, hi, (R, 128)).astype(np.float32), device=dev)
             for lo, hi in ((-50, 50), (-50, 50), (0, 2 * np.pi))]
    acts = torch.as_tensor(rng.integers(0, 8, (T, R, 128)).astype(np.int32), device=dev)
    fs.reset_launches()
    for kern, plain, args in [
        (fs.pmsm_rollout_buffer, fs.pmsm_rollout_buffer_plain, (*start, acts)),
        (fs.pmsm_record_buffer, fs.pmsm_record_buffer_plain, (*start, acts)),
        (fs.pmsm_rollout_random, fs.pmsm_rollout_random_plain, (5, *start, T)),
        (fs.pmsm_record_random, fs.pmsm_record_random_plain, (5, *start, T)),
    ]:
        got, want = kern(consts, *args), plain(consts, *args)
        ok = np.ones(R * 128, bool)
        for j, (g, w) in enumerate(zip(got, want)):
            g, w = g.cpu().numpy(), w.cpu().numpy()
            err = np.abs(g - w)
            if j == 2:
                err = np.remainder(err, 2 * np.pi)
                err = np.minimum(err, 2 * np.pi - err)
            ok &= (err <= 1e-4 + 1e-4 * np.abs(w)).reshape(-1, R * 128).all(axis=0)
        assert ok.all() if kern in (fs.pmsm_rollout_buffer, fs.pmsm_record_buffer) else ok.mean() >= 0.99
    torch.cuda.synchronize()
    assert all(v == 1 for v in fs.LAUNCHES.values())
