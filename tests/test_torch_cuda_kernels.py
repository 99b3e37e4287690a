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
    assert {k: v for k, v in fs.LAUNCHES.items() if v} == dict.fromkeys(fs.KERNELS, 1)


@pytest.mark.cuda
def test_cuda_policy_kernels_match_plain_versions():
    """The policy-in-the-loop kernels at H = 8, 16, 32: the deterministic
    modes (greedy, constant references) in every env at rtol 1e-4 /
    atol 1e-4 and the REINFORCE block within 1e-4 of its largest entry;
    the random modes in 99% of envs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels are CUDA C++ without a CPU mode")
    from gym_electric_motor_tpu_torch.ops import fused_policy as fp

    dev = torch.device("cuda")
    env = gt.make_functional("Finite-CC-PMSM-v0", device=dev,
                             state_filter=("omega", "i_sd", "i_sq", "epsilon"))
    consts = fp.PolicyConsts(env)
    R, T = 2, 64
    rng = np.random.default_rng(9)
    start = [torch.as_tensor(rng.uniform(lo, hi, (R, 128)).astype(np.float32), device=dev)
             for lo, hi in ((-50, 50), (-50, 50), (0, 2 * np.pi))]
    refs = [torch.as_tensor(rng.uniform(-0.5, 0.5, (R, 128)).astype(np.float32), device=dev)
            for _ in range(2)]

    def weights(n_features, hidden):
        return [torch.as_tensor((rng.normal(size=n) * s).astype(np.float32), device=dev)
                for n, s in ((n_features * hidden, 0.5), (hidden, 0.1), (hidden * 8, 0.5),
                             (8, 0.1))]

    def share(got, want, angle=(2,)):
        ok = np.ones(R * 128, bool)
        for j, (g, w) in enumerate(zip(got, want)):
            g, w = g.cpu().float().numpy(), w.cpu().float().numpy()
            err = np.abs(g - w)
            if j in angle:
                err = np.remainder(err, 2 * np.pi)
                err = np.minimum(err, 2 * np.pi - err)
            ok &= (err <= 1e-4 + 1e-4 * np.abs(w)).reshape(-1, R * 128).all(axis=0)
        return ok.mean()

    fp.reset_launches()
    for hidden in fp.HIDDEN_SIZES:
        w6, w7 = weights(6, hidden), weights(7, hidden)
        for sample, ref_mode in (("greedy", "const"), ("categorical", "wiener")):
            args = (consts, 5, *w6, *start, *refs, T, sample, ref_mode)
            s = share(fp.policy_rollout(*args), fp.policy_rollout_plain(*args))
            assert s == 1.0 if sample == "greedy" else s >= 0.99, (hidden, sample, s)
            rargs = (consts, 5, -0.05, *w6, *start, *refs, T, 0.9, sample, ref_mode)
            got, want = fp.reinforce_rollout(*rargs), fp.reinforce_rollout_plain(*rargs)
            s = share(got[:5], want[:5])
            assert s == 1.0 if sample == "greedy" else s >= 0.99, (hidden, sample, s)
            if sample == "greedy":
                err = float((got[5] - want[5]).abs().max() / want[5].abs().max())
                assert err < 1e-4, (hidden, err)
        args = (consts, 5, *w7, *start, T)
        assert share(fp.policy_record(*args), fp.policy_record_plain(*args)) >= 0.99
    torch.cuda.synchronize()
    # LAUNCHES also counts the universal recorders' kernels, none launched here
    assert {k: v for k, v in fp.LAUNCHES.items() if v} == {
        "policy_rollout": 6, "policy_record": 3, "reinforce_rollout": 6, "reinforce_reduce": 6}


@pytest.mark.cuda
@pytest.mark.parametrize("env_id", ["Finite-CC-PMSM-v0", "Cont-SC-SynRM-v0"])
def test_cuda_sync_kernels_match_plain_versions(env_id):
    """The universal synchronous-family kernels (csrc/fused_sync.cu) on a
    constant-speed finite id and a dynamic-speed continuous one: the buffer
    modes in every env, the random modes in 99% of envs, at rtol 1e-4 /
    atol 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels are CUDA C++ without a CPU mode")
    from gym_electric_motor_tpu_torch.ops import fused_sync_family as sf

    dev = torch.device("cuda")
    c = sf.SyncConsts(gt.make_functional(env_id, device=dev))
    R, T = 4, 64
    rng = np.random.default_rng(10)
    start = [torch.as_tensor(rng.uniform(-50, 50, (R, 128)).astype(np.float32), device=dev)
             for _ in range(c.n_state - 1)]
    start.append(torch.as_tensor(rng.uniform(0, 2 * np.pi, (R, 128)).astype(np.float32), device=dev))
    if c.finite:
        acts = torch.as_tensor(rng.integers(0, 8, (T, R, 128)).astype(np.int32), device=dev)
    else:
        acts = torch.as_tensor(rng.uniform(-1, 1, (T, 3, R, 128)).astype(np.float32), device=dev)
    sf.reset_launches()
    for kern, plain, args in [
        (sf.sync_rollout_buffer, sf.sync_rollout_buffer_plain, (start, acts)),
        (sf.sync_record_buffer, sf.sync_record_buffer_plain, (start, acts)),
        (sf.sync_rollout_random, sf.sync_rollout_random_plain, (5, start, T)),
        (sf.sync_record_random, sf.sync_record_random_plain, (5, start, T)),
    ]:
        got, want = kern(c, *args), plain(c, *args)
        ok = np.ones(R * 128, bool)
        for j, (g, w) in enumerate(zip(got, want)):
            g, w = g.cpu().float().numpy(), w.cpu().float().numpy()
            err = np.abs(g - w)
            if j == c.n_state - 1:
                err = np.remainder(err, 2 * np.pi)
                err = np.minimum(err, 2 * np.pi - err)
            ok &= (err <= 1e-4 + 1e-4 * np.abs(w)).reshape(-1, R * 128).all(axis=0)
        assert ok.all() if kern in (sf.sync_rollout_buffer, sf.sync_record_buffer) else ok.mean() >= 0.99
    torch.cuda.synchronize()
    assert all(v == 1 for v in sf.LAUNCHES.values())


@pytest.mark.cuda
@pytest.mark.parametrize("env_id", ["Finite-CC-ExtExDc-v0", "Cont-SC-ShuntDc-v0"])
def test_cuda_dc_kernels_match_plain_versions(env_id):
    """The universal DC-family kernels (csrc/fused_dc.cu, fused_dc_record.cu)
    on the two-channel finite id and a dynamic-speed continuous one: the
    buffer modes in every env, the random modes in 99% of envs, at
    rtol 1e-4 / atol 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels are CUDA C++ without a CPU mode")
    from gym_electric_motor_tpu_torch.ops import fused_dc_family as dcf

    dev = torch.device("cuda")
    c = dcf.DcConsts(gt.make_functional(env_id, device=dev))
    R, T = 4, 64
    rng = np.random.default_rng(11)
    start = ([torch.as_tensor(rng.uniform(0, 100, (R, 128)).astype(np.float32), device=dev)]
             if c.mech else [])
    start += [torch.as_tensor(rng.uniform(-100, 100, (R, 128)).astype(np.float32), device=dev)
              for _ in range(c.n_el)]
    ch = (2,) if c.n_ch == 2 else ()
    if c.finite:
        acts = torch.as_tensor(rng.integers(0, 4, (T,) + ch + (R, 128)).astype(np.int32), device=dev)
    else:
        acts = torch.as_tensor(rng.uniform(-1, 1, (T,) + ch + (R, 128)).astype(np.float32),
                               device=dev)
    dcf.reset_launches()
    for kern, plain, args in [
        (dcf.dc_rollout_buffer, dcf.dc_rollout_buffer_plain, (start, acts)),
        (dcf.dc_record_buffer, dcf.dc_record_buffer_plain, (start, acts)),
        (dcf.dc_rollout_random, dcf.dc_rollout_random_plain, (5, start, T)),
        (dcf.dc_record_random, dcf.dc_record_random_plain, (5, start, T)),
    ]:
        got, want = kern(c, *args), plain(c, *args)
        ok = np.ones(R * 128, bool)
        for g, w in zip(got, want):
            g, w = g.cpu().double().numpy(), w.cpu().double().numpy()
            ok &= (np.abs(g - w) <= 1e-4 + 1e-4 * np.abs(w)).reshape(-1, R * 128).all(axis=0)
        assert ok.all() if kern in (dcf.dc_rollout_buffer, dcf.dc_record_buffer) else ok.mean() >= 0.99
    torch.cuda.synchronize()
    assert {k: v for k, v in dcf.LAUNCHES.items() if v} == dict.fromkeys(dcf.KERNELS, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("env_id", ["Finite-CC-SCIM-v0", "Cont-SC-SCIM-v0"])
def test_cuda_induction_kernels_match_plain_versions(env_id):
    """The universal SCIM kernels (csrc/fused_induction.cu,
    fused_induction_record.cu) on a constant-speed finite CC id (two
    references, the flux direction) and a dynamic-speed continuous one:
    the buffer modes in every env, the random modes in 99% of envs, at
    rtol 1e-4 / atol 1e-4.  A fifth of the starts lie outside the current
    limit, so the random modes cross resets."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels are CUDA C++ without a CPU mode")
    from gym_electric_motor_tpu_torch.ops import fused_induction_family as indf

    dev = torch.device("cuda")
    c = indf.InductionConsts(gt.make_functional(env_id, device=dev))
    R, T = 4, 64
    rng = np.random.default_rng(12)
    bounds = ([(0, 100)] if c.mech else []) + [(-6, 6)] * 2 + [(-0.5, 0.5)] * 2
    start = [torch.as_tensor(rng.uniform(lo, hi, (R, 128)).astype(np.float32), device=dev)
             for lo, hi in bounds]
    if c.finite:
        acts = torch.as_tensor(rng.integers(0, 8, (T, R, 128)).astype(np.int32), device=dev)
    else:
        acts = torch.as_tensor(rng.uniform(-1, 1, (T, 3, R, 128)).astype(np.float32), device=dev)
    indf.reset_launches()
    for kern, plain, args in [
        (indf.induction_rollout_buffer, indf.induction_rollout_buffer_plain, (start, acts)),
        (indf.induction_record_buffer, indf.induction_record_buffer_plain, (start, acts)),
        (indf.induction_rollout_random, indf.induction_rollout_random_plain, (5, start, T)),
        (indf.induction_record_random, indf.induction_record_random_plain, (5, start, T)),
    ]:
        got, want = kern(c, *args), plain(c, *args)
        ok = np.ones(R * 128, bool)
        for g, w in zip(got, want):
            g, w = g.cpu().double().numpy(), w.cpu().double().numpy()
            ok &= (np.abs(g - w) <= 1e-4 + 1e-4 * np.abs(w)).reshape(-1, R * 128).all(axis=0)
        buffer = kern in (indf.induction_rollout_buffer, indf.induction_record_buffer)
        assert ok.all() if buffer else ok.mean() >= 0.99
    torch.cuda.synchronize()
    assert all(v == 1 for v in indf.LAUNCHES.values())


@pytest.mark.cuda
@pytest.mark.parametrize("env_id", ["Finite-CC-EESM-v0", "Cont-SC-EESM-v0"])
def test_cuda_eesm_kernels_match_plain_versions(env_id):
    """The universal EESM kernels (csrc/fused_eesm.cu, fused_eesm_record.cu)
    on a constant-speed finite CC id (three references, the incremental
    rotation) and a dynamic-speed continuous one: the buffer modes in every
    env, the random modes in 99% of envs, at rtol 1e-4 / atol 1e-4 (the
    angle modulo 2 pi).  Some starts lie outside the current limits, so the
    random modes cross resets."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels are CUDA C++ without a CPU mode")
    from gym_electric_motor_tpu_torch.ops import fused_eesm_family as ef

    dev = torch.device("cuda")
    c = ef.EesmConsts(gt.make_functional(env_id, device=dev))
    R, T = 4, 64
    rng = np.random.default_rng(13)
    bounds = (([(0, 100)] if c.mech else []) + [(-170, 170)] * 2 + [(-170, 170)]
              + [(0, 2 * np.pi)])
    start = [torch.as_tensor(rng.uniform(lo, hi, (R, 128)).astype(np.float32), device=dev)
             for lo, hi in bounds]
    if c.finite:
        acts = np.stack([rng.integers(0, 8, (T, R, 128)), rng.integers(0, 4, (T, R, 128))], 1)
        acts = torch.as_tensor(acts.astype(np.int32), device=dev)
    else:
        acts = torch.as_tensor(rng.uniform(-1, 1, (T, 4, R, 128)).astype(np.float32), device=dev)
    ef.reset_launches()
    for kern, plain, args in [
        (ef.eesm_rollout_buffer, ef.eesm_rollout_buffer_plain, (start, acts)),
        (ef.eesm_record_buffer, ef.eesm_record_buffer_plain, (start, acts)),
        (ef.eesm_rollout_random, ef.eesm_rollout_random_plain, (5, start, T)),
        (ef.eesm_record_random, ef.eesm_record_random_plain, (5, start, T)),
    ]:
        got, want = kern(c, *args), plain(c, *args)
        ok = np.ones(R * 128, bool)
        for j, (g, w) in enumerate(zip(got, want)):
            g, w = g.cpu().double().numpy(), w.cpu().double().numpy()
            d = np.abs(g - w)
            if j == c.n_state - 1:  # the angle
                d = np.minimum(np.remainder(g - w, 2 * np.pi), np.remainder(w - g, 2 * np.pi))
            ok &= (d <= 1e-4 + 1e-4 * np.abs(w)).reshape(-1, R * 128).all(axis=0)
        buffer = kern in (ef.eesm_rollout_buffer, ef.eesm_record_buffer)
        assert ok.all() if buffer else ok.mean() >= 0.99
    torch.cuda.synchronize()
    assert all(v == 1 for v in ef.LAUNCHES.values())


@pytest.mark.cuda
@pytest.mark.parametrize("env_id", ["Finite-CC-DFIM-v0", "Cont-SC-DFIM-v0"])
def test_cuda_dfim_kernels_match_plain_versions(env_id):
    """The universal DFIM kernels (csrc/fused_dfim.cu, fused_dfim_record.cu)
    on a constant-speed finite CC id (two references, the flux direction,
    the incremental rotation) and a dynamic-speed continuous one (six
    duties): the buffer modes in every env, the random modes in 99% of envs,
    at rtol 1e-4 / atol 1e-4 (the angle modulo 2 pi).  Some starts lie
    outside the current limit, so the random modes cross resets."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels are CUDA C++ without a CPU mode")
    from gym_electric_motor_tpu_torch.ops import fused_dfim_family as dff

    dev = torch.device("cuda")
    c = dff.DfimConsts(gt.make_functional(env_id, device=dev))
    R, T = 4, 64
    rng = np.random.default_rng(14)
    bounds = (([(0, 100)] if c.mech else []) + [(-10, 10)] * 2 + [(-1.5, 1.5)] * 2
              + [(0, 2 * np.pi)])
    start = [torch.as_tensor(rng.uniform(lo, hi, (R, 128)).astype(np.float32), device=dev)
             for lo, hi in bounds]
    if c.finite:
        acts = torch.as_tensor(rng.integers(0, 8, (T, 2, R, 128)).astype(np.int32), device=dev)
    else:
        acts = torch.as_tensor(rng.uniform(-1, 1, (T, 6, R, 128)).astype(np.float32), device=dev)
    dff.reset_launches()
    for kern, plain, args in [
        (dff.dfim_rollout_buffer, dff.dfim_rollout_buffer_plain, (start, acts)),
        (dff.dfim_record_buffer, dff.dfim_record_buffer_plain, (start, acts)),
        (dff.dfim_rollout_random, dff.dfim_rollout_random_plain, (5, start, T)),
        (dff.dfim_record_random, dff.dfim_record_random_plain, (5, start, T)),
    ]:
        got, want = kern(c, *args), plain(c, *args)
        ok = np.ones(R * 128, bool)
        for j, (g, w) in enumerate(zip(got, want)):
            g, w = g.cpu().double().numpy(), w.cpu().double().numpy()
            d = np.abs(g - w)
            if j == c.n_state - 1:  # the angle
                d = np.minimum(np.remainder(g - w, 2 * np.pi), np.remainder(w - g, 2 * np.pi))
            ok &= (d <= 1e-4 + 1e-4 * np.abs(w)).reshape(-1, R * 128).all(axis=0)
        buffer = kern in (dff.dfim_rollout_buffer, dff.dfim_record_buffer)
        assert ok.all() if buffer else ok.mean() >= 0.99
    torch.cuda.synchronize()
    assert all(v == 1 for v in dff.LAUNCHES.values())


@pytest.mark.cuda
@pytest.mark.parametrize("env_id,psi_s", [("Finite-CC-SRM-v0", None), ("Cont-SC-SRM-v0", None),
                                          ("Finite-TC-SRM-v0", 1.2), ("Cont-SC-SRM-v0", 1.2)],
                         ids=["Finite-CC-SRM-v0", "Cont-SC-SRM-v0", "Finite-TC-SRM-v0-psi_s",
                              "Cont-SC-SRM-v0-psi_s"])
def test_cuda_srm_kernels_match_plain_versions(env_id, psi_s):
    """The universal SRM kernels (csrc/fused_srm.cu, fused_srm_record.cu),
    linear and saturating, on a constant-speed finite CC id (three
    references, the carried rotation), a constant-speed finite TC id (the
    torque reward at the wrapped angle) and a dynamic-speed continuous one
    (the per-stage angles): the buffer modes in every env, the random modes
    in 99% of envs, at rtol 1e-4 / atol 1e-4 (the angle modulo 2 pi).  Some
    starts lie past the 20 A limit, so the random modes cross resets."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels are CUDA C++ without a CPU mode")
    from gym_electric_motor_tpu_torch.ops import fused_srm_family as srf

    dev = torch.device("cuda")
    kw = dict(motor=dict(motor_parameter={"psi_s": psi_s})) if psi_s else {}
    c = srf.SrmConsts(gt.make_functional(env_id, device=dev, **kw))
    assert c.sat == (psi_s is not None)
    R, T = 4, 64
    rng = np.random.default_rng(15)
    bounds = ([(0, 100)] if c.mech else []) + [(0, 22)] * 3 + [(-np.pi, np.pi)]
    start = [torch.as_tensor(rng.uniform(lo, hi, (R, 128)).astype(np.float32), device=dev)
             for lo, hi in bounds]
    if c.finite:
        acts = torch.as_tensor(rng.integers(0, 3, (T, 3, R, 128)).astype(np.int32), device=dev)
    else:
        acts = torch.as_tensor(rng.uniform(-1, 1, (T, 3, R, 128)).astype(np.float32), device=dev)
    srf.reset_launches()
    for kern, plain, args in [
        (srf.srm_rollout_buffer, srf.srm_rollout_buffer_plain, (start, acts)),
        (srf.srm_record_buffer, srf.srm_record_buffer_plain, (start, acts)),
        (srf.srm_rollout_random, srf.srm_rollout_random_plain, (5, start, T)),
        (srf.srm_record_random, srf.srm_record_random_plain, (5, start, T)),
    ]:
        got, want = kern(c, *args), plain(c, *args)
        ok = np.ones(R * 128, bool)
        for j, (g, w) in enumerate(zip(got, want)):
            g, w = g.cpu().double().numpy(), w.cpu().double().numpy()
            d = np.abs(g - w)
            if j == c.n_state - 1:  # the angle
                d = np.minimum(np.remainder(g - w, 2 * np.pi), np.remainder(w - g, 2 * np.pi))
            ok &= (d <= 1e-4 + 1e-4 * np.abs(w)).reshape(-1, R * 128).all(axis=0)
        buffer = kern in (srf.srm_rollout_buffer, srf.srm_record_buffer)
        assert ok.all() if buffer else ok.mean() >= 0.99
    torch.cuda.synchronize()
    assert {k: v for k, v in srf.LAUNCHES.items() if v} == dict.fromkeys(srf.KERNELS, 1)


POLICY_CASES = [("Finite-CC-PMSM-v0", False), ("Cont-SC-SynRM-v0", False),
                ("Finite-TC-SeriesDc-v0", False), ("Finite-CC-ExtExDc-v0", True),
                ("Cont-SC-ShuntDc-v0", False), ("Finite-CC-SCIM-v0", False),
                ("Cont-TC-SCIM-v0", False), ("Finite-CC-EESM-v0", False),
                ("Finite-CC-EESM-v0", True), ("Cont-SC-EESM-v0", False),
                ("Finite-TC-DFIM-v0", False), ("Finite-CC-DFIM-v0", True),
                ("Cont-CC-DFIM-v0", False), ("Finite-CC-SRM-v0", False),
                ("Finite-SC-SRM-v0", True), ("Cont-SC-SRM-v0", False)]


@pytest.mark.cuda
@pytest.mark.parametrize("H", [32, 16, 5])
@pytest.mark.parametrize("env_id,joint", POLICY_CASES,
                         ids=[e + ("-joint" if j else "") for e, j in POLICY_CASES])
def test_cuda_universal_policy_kernel_matches_plain_version(env_id, joint, H):
    """The universal policy recorder of each family (finite, joint heads
    and continuous) against its plain version at H = 32 (PPO's width), 16
    (the trainer's default) and an odd 5, since H is a run-time count that
    places the staged weights: every signal of an env at every step at
    rtol 1e-4 / atol 1e-4, angles modulo 2 pi, in 99% of envs (the
    random-mode rule), and one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels are CUDA C++ without a CPU mode")
    from gym_electric_motor_tpu_torch.ops import fused_policy as fp

    dev = torch.device("cuda")
    R, T = 2, 64
    env = gt.make_functional(env_id, device=dev)
    roll = fp.make_fused_policy_record_universal(env, T, R * 128, hidden=H, joint_heads=joint)
    pol = roll.policy
    rng = np.random.default_rng(10)
    scale = 0.3 if pol.cont else 0.5
    w = [torch.as_tensor((rng.normal(size=n) * s).astype(np.float32), device=dev)
         for n, s in ((pol.obs_dim * H, scale), (H, 0.1), (H * pol.n_out, scale),
                      (pol.n_out, 0.1))]
    ls = (torch.full((len(roll.act_names),), -0.5, device=dev) if pol.cont else None)
    planes = fp.fused_policy_init_planes(env, R * 128, device=dev)
    fp.reset_launches()
    got = fp.policy_record_universal(pol, 5, *w, ls, planes, T)
    torch.cuda.synchronize()
    assert fp.LAUNCHES[pol.kernel] == 1
    want = fp.policy_record_universal_plain(pol, 5, *w, ls, planes, T)
    ok = np.ones(R * 128, bool)
    for name, g, x in zip(roll.signals, got, want):
        assert g.dtype == x.dtype and g.shape == (T, R, 128)
        g, x = g.double().cpu().numpy(), x.double().cpu().numpy()
        err = np.abs(g - x)
        if name == "eps":
            err = np.remainder(err, 2 * np.pi)
            err = np.minimum(err, 2 * np.pi - err)
        ok &= (err <= 1e-4 + 1e-4 * np.abs(x)).reshape(-1, R * 128).all(axis=0)
    assert ok.mean() >= 0.99


def _close_share(got, want, n):
    """Share of the n envs (the trailing n elements) whose every output
    agrees at rtol 1e-5 / atol 1e-4."""
    ok = np.ones(n, bool)
    for g, w in zip(got, want):
        g, w = g.cpu().numpy().astype(np.float64), w.cpu().numpy().astype(np.float64)
        assert g.shape == w.shape
        ok &= (np.abs(g - w) <= 1e-4 + 1e-5 * np.abs(w)).reshape(-1, n).all(axis=0)
    return ok.mean()


CONTROL_SRM_REFS = {"CC": [("i_a", 0.2), ("i_b", 0.3), ("i_c", 0.1)], "TC": [("torque", 0.3)],
                    "SC": [("omega", 0.4)]}
CONTROL_CASES = ([("foc", "Cont-CC-PMSM-v0", None)]
                 + [("dc", i, None) for i in ("Cont-SC-PermExDc-v0", "Cont-SC-SeriesDc-v0",
                                              "Cont-SC-ShuntDc-v0")]
                 + [("srm", i, None) for i in gt.SRM_ENV_IDS] + [("srm", "Finite-TC-SRM-v0", 1.2)])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["const", "wiener"])
@pytest.mark.parametrize("kind,env_id,psi_s", CONTROL_CASES,
                         ids=[f"{i}{'-sat' if p else ''}" for _k, i, p in CONTROL_CASES])
def test_cuda_control_kernels_match_plain_versions(kind, env_id, psi_s, mode):
    """The three controller-in-the-loop kernels (FOC, DC speed cascade, SRM
    commutation cascade) at 256 envs x 64 steps: constant references in
    every env at rtol 1e-5 / atol 1e-4, Wiener references in 99% of envs;
    one launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels are CUDA C++ without a CPU mode")
    from gym_electric_motor_tpu_torch import references as rg
    from gym_electric_motor_tpu_torch.controllers import GemController
    from gym_electric_motor_tpu_torch.ops import fused_dc_family as dcf
    from gym_electric_motor_tpu_torch.ops import fused_srm_family as srf

    dev = torch.device("cuda")
    R, T, N = 2, 64, 256
    rng = np.random.default_rng(13)
    kw = {"motor": {"motor_parameter": {"psi_s": psi_s}}} if psi_s else {}
    task = env_id.split("-")[1]
    refs = {"foc": [("i_sd", -0.1), ("i_sq", 0.3)], "dc": [("omega", 0.5)],
            "srm": CONTROL_SRM_REFS[task]}[kind]
    if mode == "const":
        kw["reference_generator"] = rg.ReferenceSpec([rg.ConstReference(n, v) for n, v in refs])
    env = gt.make_functional(env_id, device=dev, **kw)
    ctrl = GemController.make(env, env_id)

    def planes(bounds):
        return [torch.as_tensor(rng.uniform(lo, hi, (R, 128)).astype(np.float32), device=dev)
                for lo, hi in bounds]

    if kind == "foc":
        mod, c = fs, fs.FocConsts(env, ctrl, mode)
        args = (7, *planes([(-50, 50), (-50, 50), (0, 2 * np.pi), (-0.3, 0.3), (-0.3, 0.3)]), T)
        kern, plain = fs.foc_rollout, fs.foc_rollout_plain
    elif kind == "dc":
        mod, c = dcf, dcf.DcCascadeConsts(env, ctrl)
        args = (7, planes([(0, 100)] + [(-5, 5)] * (c.c.n_state - 1)), T)
        kern, plain = dcf.dc_cascade_rollout, dcf.dc_cascade_rollout_plain
    else:
        mod, c = srf, srf.SrmCascadeConsts(env, ctrl)
        args = (7, planes(([(0, 100)] if c.c.mech else []) + [(0, 22)] * 3 + [(-np.pi, np.pi)]),
                T)
        kern, plain = srf.srm_cascade_rollout, srf.srm_cascade_rollout_plain
    mod.reset_launches()
    got = kern(c, *args)
    torch.cuda.synchronize()
    want = plain(c, *args)
    share = _close_share(got, want, N)
    assert share == 1.0 if mode == "const" else share >= 0.99
    assert {k: v for k, v in mod.LAUNCHES.items() if v} == dict.fromkeys(mod.CONTROL_KERNELS, 1)


# the SRM random rollout (lane groups at constant speed) and the SRM
# cascade: (kernel, id, psi_s, references)
SRM_BIT_CASES = ([("rollout", i, None, "wiener") for i in gt.SRM_ENV_IDS]
                  + [("rollout", "Finite-TC-SRM-v0", 1.2, "wiener"),
                     ("rollout", "Cont-SC-SRM-v0", 1.2, "wiener"),
                     ("rollout", "Finite-CC-SRM-v0", None, "const"),
                     ("rollout", "Cont-SC-SRM-v0", None, "const")]
                  + [("cascade", i, None, "wiener") for i in gt.SRM_ENV_IDS]
                  + [("cascade", "Finite-TC-SRM-v0", 1.2, "wiener"),
                     ("cascade", "Finite-CC-SRM-v0", None, "const"),
                     ("cascade", "Finite-SC-SRM-v0", None, "const")])


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,env_id,psi_s,refs", SRM_BIT_CASES,
                         ids=[f"{k}-{i}{'-sat' if p else ''}-{r}" for k, i, p, r in SRM_BIT_CASES])
def test_cuda_srm_rollout_and_cascade_equal_plain_versions_bit_for_bit(kernel, env_id, psi_s,
                                                                       refs):
    """srm_rollout_random (csrc/fused_srm.cu: four lanes an env at constant
    speed, one thread per env under the speed ODE) and srm_cascade_rollout
    (csrc/fused_srm_cascade.cu) equal their plain versions bit for bit in
    every env and every output (NaN where the plain version has NaN),
    linear and saturating, with Wiener and with constant references (the
    loop without the reference advance), at one plane of 128 envs: a grid
    smaller than the SMs.  Env 5 starts with only phase b above the 20 A
    limit, the others below it: its first step violates, and on lane groups
    the reset must reach all four lanes of its group."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels are CUDA C++ without a CPU mode")
    from gym_electric_motor_tpu_torch import references as rg
    from gym_electric_motor_tpu_torch.controllers import GemController
    from gym_electric_motor_tpu_torch.ops import fused_srm_family as srf

    dev = torch.device("cuda")
    kw = {"motor": {"motor_parameter": {"psi_s": psi_s}}} if psi_s else {}
    if refs == "const":
        kw["reference_generator"] = rg.ReferenceSpec(
            [rg.ConstReference(n, v) for n, v in CONTROL_SRM_REFS[env_id.split("-")[1]]])
    env = gt.make_functional(env_id, device=dev, **kw)
    if kernel == "cascade":
        c = srf.SrmCascadeConsts(env, GemController.make(env, env_id))
        base, kern, plain = c.c, srf.srm_cascade_rollout, srf.srm_cascade_rollout_plain
    else:
        c = base = srf.SrmConsts(env)
        kern, plain = srf.srm_rollout_random, srf.srm_rollout_random_plain
    assert base.sat == (psi_s is not None) and base.all_const == (refs == "const")
    R, T, hot = 1, 64, 5
    rng = np.random.default_rng(21)
    bounds = ([(0, 100)] if base.mech else []) + [(0, 19)] * 3 + [(-np.pi, np.pi)]
    start = [rng.uniform(lo, hi, (R, 128)).astype(np.float32) for lo, hi in bounds]
    start[-3][0, hot] = 25.0  # i_b
    start = [torch.as_tensor(x, device=dev) for x in start]
    srf.reset_launches()
    got = kern(c, 7, start, T)
    torch.cuda.synchronize()
    want = plain(c, 7, start, T)
    for j, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == w.dtype, j
        same = (g == w) | (torch.isnan(g) & torch.isnan(w))
        assert bool(same.all()), f"output {j} differs in {int((~same).sum())} elements"
    assert float(got[base.n_state + 1][0, hot]) >= 1.0  # the violating env reset
    name = "srm_cascade_rollout" if kernel == "cascade" else "srm_rollout_random"
    assert {k: v for k, v in srf.LAUNCHES.items() if v} == {name: 1}


# the specialised builders' kernels: (module, id, consts class, random
# kernel, buffer kernel, start bounds, action buffer kind)
SPECIALISED_CASES = [
    ("fused_dc", "Finite-CC-PermExDc-v0", "PermexConsts", "permex_rollout_random",
     "permex_rollout_buffer", [(-100, 100)], "4qc"),
    ("fused_dc", "Finite-CC-PermExDc-v0", "PermexConsts", "permex_record_random",
     "permex_record_buffer", [(-100, 100)], "4qc"),
    ("fused_dc", "Cont-SC-SeriesDc-v0", "DcScConsts", "dc_sc_rollout_random",
     "dc_sc_rollout_buffer", [(0, 100), (-5, 5)], "duty"),
    ("fused_dc", "Cont-SC-ShuntDc-v0", "DcScConsts", "dc_sc_rollout_random",
     "dc_sc_rollout_buffer", [(0, 100), (-5, 5), (-5, 5)], "duty"),
    ("fused_induction", "Cont-TC-SCIM-v0", "ScimConsts", "scim_rollout_random",
     "scim_rollout_buffer", [(-8, 8)] * 2 + [(-1, 1)] * 2, "duty3"),
    ("fused_eesm", "Finite-CC-EESM-v0", "EesmCcConsts", "eesm_cc_rollout_random",
     "eesm_cc_rollout_buffer", [(-8, 8)] * 3 + [(0, 2 * np.pi)], "b6_4qc"),
    ("fused_dfim", "Cont-CC-DFIM-v0", "DfimCcConsts", "dfim_cc_rollout_random",
     "dfim_cc_rollout_buffer", [(-10, 10)] * 2 + [(-1.5, 1.5)] * 2 + [(0, 2 * np.pi)], "duty6"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("mod_name,env_id,consts,random,buffer,bounds,acts", SPECIALISED_CASES,
                         ids=[f"{c[3]}-{c[1]}" for c in SPECIALISED_CASES])
def test_cuda_specialised_kernels_match_plain_versions(mod_name, env_id, consts, random, buffer,
                                                       bounds, acts):
    """The twelve kernels of the specialised builders (csrc/fused_permex.cu,
    fused_dc_sc.cu, fused_scim_tc.cu, fused_eesm_cc.cu, fused_dfim_cc.cu) at
    512 envs x 64 steps: the buffer mode in every env, the random mode in
    99% of envs, at rtol 1e-5 / atol 1e-4; one launch of each.  Some starts
    lie outside the limits, so the random modes cross resets."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels are CUDA C++ without a CPU mode")
    import importlib

    mod = importlib.import_module(f"gym_electric_motor_tpu_torch.ops.{mod_name}")
    dev = torch.device("cuda")
    c = getattr(mod, consts)(gt.make_functional(env_id, device=dev))
    R, T, N = 4, 64, 512
    rng = np.random.default_rng(15)
    start = [torch.as_tensor(rng.uniform(lo, hi, (R, 128)).astype(np.float32), device=dev)
             for lo, hi in bounds]
    shape = {"4qc": (T, R, 128), "duty": (T, R, 128), "duty3": (T, 3, R, 128),
             "b6_4qc": (T, 2, R, 128), "duty6": (T, 6, R, 128)}[acts]
    if acts == "4qc":
        a = rng.integers(0, 4, shape)
    elif acts == "b6_4qc":
        a = np.stack([rng.integers(0, 8, (T, R, 128)), rng.integers(0, 4, (T, R, 128))], axis=1)
    else:
        a = rng.uniform(-1, 1, shape)
    a = torch.as_tensor(a.astype(np.int32 if acts in ("4qc", "b6_4qc") else np.float32),
                        device=dev)
    state = start[0] if mod_name == "fused_dc" and "permex" in random else start
    mod.reset_launches()
    for name, args in ((random, (7, state, T)), (buffer, (state, a))):
        got = getattr(mod, name)(c, *args)
        torch.cuda.synchronize()
        want = getattr(mod, name + "_plain")(c, *args)
        if isinstance(got, torch.Tensor):
            got, want = (got,), (want,)
        share = _close_share(got, want, N)
        assert share == 1.0 if name == buffer else share >= 0.99
    assert {k: v for k, v in mod.LAUNCHES.items() if v} == {random: 1, buffer: 1}


# the warp-specialised DC and EESM random rollouts: (family, id, references);
# every DC motor class, finite and continuous, at constant speed (ExtExDc's
# CC id with two reference rows) and under the speed ODE, and all six EESM
# ids, each with its Wiener references and with constant ones
DC_EESM_CONST_REFS = {
    "CC": {"PermExDc": [("i", 0.2)], "SeriesDc": [("i", 0.2)], "ShuntDc": [("i_a", 0.2)],
           "ExtExDc": [("i_a", 0.2), ("i_e", 0.1)],
           "EESM": [("i_sd", 0.1), ("i_sq", -0.2), ("i_e", 0.3)]},
    "TC": [("torque", 0.3)], "SC": [("omega", 0.2)]}
WS_BIT_CASES = ([("dc", f"{conv}-{task}-{motor}-v0", refs)
                 for motor in ("PermExDc", "SeriesDc", "ShuntDc", "ExtExDc")
                 for conv in ("Finite", "Cont") for task in ("CC", "SC")
                 for refs in ("wiener", "const")]
                + [("eesm", env_id, refs) for env_id in gt.EESM_ENV_IDS
                   for refs in ("wiener", "const")])
# K, the steps of a ring slot (csrc/fused_dc.cu, csrc/fused_eesm.cu): 1,
# K - 1 and 2 K + 3 steps end inside the first slot and mid-way through the
# second fill of the first slot
WS_RING_STEPS = 4


@pytest.mark.cuda
@pytest.mark.parametrize("family,env_id,refs", WS_BIT_CASES,
                         ids=[f"{f}-{i}-{r}" for f, i, r in WS_BIT_CASES])
def test_cuda_dc_and_eesm_rollouts_equal_plain_versions_bit_for_bit(family, env_id, refs):
    """dc_rollout_random and eesm_rollout_random (csrc/fused_dc.cu,
    csrc/fused_eesm.cu: producer and consumer warps over a shared-memory
    ring with Wiener references, one thread per env with constant ones)
    equal their plain versions bit for bit in every env and every output
    (NaN where the plain version has NaN), at one plane of 128 envs (one
    block, fewer blocks than SMs) and at 1, K - 1 and 2 K + 3 steps, so
    that the ring stops in every place.  Env 5 starts at five times its
    current limit (at 1.5 times a continuous PermExDc's back-EMF brings
    some envs inside the limit within the step), the others inside it: its
    first step violates and resets."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels are CUDA C++ without a CPU mode")
    from gym_electric_motor_tpu_torch import references as rg
    from gym_electric_motor_tpu_torch.ops import fused_dc_family as dcf
    from gym_electric_motor_tpu_torch.ops import fused_eesm_family as ef

    dev = torch.device("cuda")
    _conv, task, motor, _v = env_id.split("-")
    kw = {}
    if refs == "const":
        const = DC_EESM_CONST_REFS[task]
        const = const[motor] if task == "CC" else const
        kw["reference_generator"] = rg.ReferenceSpec([rg.ConstReference(n, v) for n, v in const])
    env = gt.make_functional(env_id, device=dev, **kw)
    mod = dcf if family == "dc" else ef
    c = (dcf.DcConsts if family == "dc" else ef.EesmConsts)(env)
    assert c.all_const == (refs == "const")
    R, hot = 1, 5
    rng = np.random.default_rng(23)
    if family == "dc":
        lims = [c.f["lim0"], c.f["lim1"]][:c.n_el]
        start = ([rng.uniform(0, 100, (R, 128))] if c.mech else []) + [
            rng.uniform(-0.5 * lim, 0.5 * lim, (R, 128)) for lim in lims]
        start[-c.n_el][0, hot] = 5.0 * lims[0]
    else:
        i_lim, ie_lim = 1.0 / c.f["inv_i_lim"], 1.0 / c.f["inv_ie_lim"]
        start = ([rng.uniform(0, 100, (R, 128))] if c.mech else []) + [
            rng.uniform(-0.4 * i_lim, 0.4 * i_lim, (R, 128)),
            rng.uniform(-0.4 * i_lim, 0.4 * i_lim, (R, 128)),
            rng.uniform(-0.5 * ie_lim, 0.5 * ie_lim, (R, 128)),
            rng.uniform(0, 2 * np.pi, (R, 128))]
        start[-4][0, hot] = 5.0 * i_lim  # i_sd
    start = [torch.as_tensor(x.astype(np.float32), device=dev) for x in start]
    name = f"{family}_rollout_random"
    mod.reset_launches()
    for T in (1, WS_RING_STEPS - 1, 2 * WS_RING_STEPS + 3):
        got = getattr(mod, name)(c, 7, start, T)
        torch.cuda.synchronize()
        want = getattr(mod, name + "_plain")(c, 7, start, T)
        for j, (g, w) in enumerate(zip(got, want)):
            assert g.shape == w.shape and g.dtype == w.dtype, (T, j)
            same = (g == w) | (torch.isnan(g) & torch.isnan(w))
            assert bool(same.all()), f"T={T}: output {j} differs in {int((~same).sum())} elements"
        assert float(got[c.n_state + 1][0, hot]) >= 1.0  # the violating env reset
    assert {k: v for k, v in mod.LAUNCHES.items() if v} == {name: 3}


# policy_record's widths: a partial lane group's block, PPO's 2048 envs
# (eight lanes an env on an H100), a partial block past it (four lanes) and
# a full card (one thread per env)
POLICY_RECORD_CASES = [(h, n) for h in (8, 16, 32) for n in (1, 37, 2048, 2051, 16384)]


@pytest.mark.cuda
@pytest.mark.parametrize("hidden,n", POLICY_RECORD_CASES,
                         ids=[f"H{h}-n{n}" for h, n in POLICY_RECORD_CASES])
def test_cuda_policy_record_equals_plain_version_bit_for_bit(hidden, n):
    """policy_record (eight lanes of a warp an env with lane 0 stepping, four
    lanes each stepping, or one thread per env, by the launch's width rule)
    equals policy_record_plain bit for bit in every env and every output
    (NaN where the plain version has NaN), for 1, 2 and 64 steps.  Some envs
    start outside the current limit and reset at once; env 0 starts at
    three times it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels are CUDA C++ without a CPU mode")
    from gym_electric_motor_tpu_torch.ops import fused_policy as fp

    dev = torch.device("cuda")
    env = gt.make_functional("Finite-CC-PMSM-v0", device=dev, state_filter=fp.STATE_FILTER)
    consts = fp.PolicyConsts(env)
    rng = np.random.default_rng(31)
    w = [torch.as_tensor((rng.normal(size=k) * s).astype(np.float32), device=dev)
         for k, s in ((7 * hidden, 0.5), (hidden, 0.1), (hidden * 8, 0.5), (8, 0.1))]
    layout = fp.policy_record_layout(n)
    blocks = -(-n // 128)
    lanes = 8 if blocks * 8 <= layout["sms"] else 4 if blocks * 4 <= 3 * layout["sms"] else 1
    assert (layout["lanes"], layout["lead_lane_steps"]) == (lanes, lanes == 8)
    i_lim = 1.0 / float(consts.f["inv_i_lim"])
    R = -(-n // 128)
    start = [rng.uniform(lo, hi, (R, 128)).astype(np.float32)
             for lo, hi in ((-i_lim, i_lim), (-i_lim, i_lim), (0, 2 * np.pi))]
    start[0][0, 0] = 3.0 * i_lim
    start = [torch.as_tensor(x, device=dev) for x in start]
    for T in (1, 2, 64):
        got = fp._record_launch(consts, 3, *w, *start, T, n)
        torch.cuda.synchronize()
        want = fp.policy_record_plain(consts, 3, *w, *start, T)
        for j, (g, x) in enumerate(zip(got, want)):
            x = x.reshape(T, R * 128)[:, :n]
            assert g.shape == x.shape and g.dtype == x.dtype, (T, j)
            same = (g == x) | (torch.isnan(g) & torch.isnan(x))
            assert bool(same.all()), f"T={T}: output {j} differs in {int((~same).sum())}"
        assert float(got[7][0, 0]) == 1.0  # env 0 reset at its first step


SCIM_BIT_CASES = [(i, r) for i in gt.SCIM_ENV_IDS for r in ("wiener", "const")]
SCIM_CONST_REFS = {"CC": [("i_sd", 0.1), ("i_sq", -0.2)], "TC": [("torque", 0.3)],
                   "SC": [("omega", 0.2)]}


@pytest.mark.cuda
@pytest.mark.parametrize("env_id,refs", SCIM_BIT_CASES, ids=[f"{i}-{r}" for i, r in SCIM_BIT_CASES])
def test_cuda_induction_rollout_equals_plain_version_bit_for_bit(env_id, refs):
    """induction_rollout_random (producer and consumer warps over a
    shared-memory ring of K = 8 steps a slot with Wiener references, one
    thread per env drawing the next step's action ahead with constant ones)
    equals its plain version bit for bit in every env and every output (NaN
    where the plain version has NaN), for 1, 129 and 2048 envs (one partial
    block, a partial second block, full blocks) and 1, K - 1, K + 1 and 200
    steps, so that the ring stops in every place of a slot.  Envs 0 and 5
    start at five times the current limit and reset at their first step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels are CUDA C++ without a CPU mode")
    from gym_electric_motor_tpu_torch import references as rg
    from gym_electric_motor_tpu_torch.ops import fused_induction_family as indf

    dev = torch.device("cuda")
    kw = {}
    if refs == "const":
        kw["reference_generator"] = rg.ReferenceSpec(
            [rg.ConstReference(n, v) for n, v in SCIM_CONST_REFS[env_id.split("-")[1]]])
    c = indf.InductionConsts(gt.make_functional(env_id, device=dev, **kw))
    assert c.all_const == (refs == "const")
    rng = np.random.default_rng(29)
    i_lim = float(c.f["inv_ilim2"]) ** -0.5
    for n in (1, 129, 2048):
        R = -(-n // 128)
        bounds = ([(0, 100)] if c.mech else []) + [(-0.5 * i_lim, 0.5 * i_lim)] * 2 + [(-0.5, 0.5)] * 2
        start = [rng.uniform(lo, hi, (R, 128)).astype(np.float32) for lo, hi in bounds]
        for hot in (0, 5):
            start[-4].reshape(-1)[hot] = 5.0 * i_lim
        start = [torch.as_tensor(x, device=dev) for x in start]
        for T in (1, 7, 9, 200):
            want = indf.induction_rollout_random_plain(c, 7, start, T)
            want = ([x.reshape(-1)[:n] for x in want[:c.n_state + 2]]
                    + [x.reshape(c.n_ref, R * 128)[:, :n].reshape(-1) for x in want[c.n_state + 2:]])
            got = indf._rollout_random_launch(c, 7, start, T, n)
            torch.cuda.synchronize()
            for j, (g, x) in enumerate(zip(got, want)):
                same = (g == x) | (torch.isnan(g) & torch.isnan(x))
                assert bool(same.all()), f"n={n} T={T}: output {j} differs in {int((~same).sum())}"
            assert float(got[c.n_state + 1][0]) >= 1.0  # env 0 reset


# the DFIM and sync random rollouts warp-specialised: (family, id,
# references) on every id of both families
LANE_RING_BIT_CASES = ([("dfim", i, r) for i in gt.DFIM_ENV_IDS for r in ("wiener", "const")]
                       + [("sync", i, r) for i in gt.SYNC_ENV_IDS for r in ("wiener", "const")])


@pytest.mark.cuda
@pytest.mark.parametrize("family,env_id,refs", LANE_RING_BIT_CASES,
                         ids=[f"{f}-{i}-{r}" for f, i, r in LANE_RING_BIT_CASES])
def test_cuda_dfim_and_sync_rollouts_equal_plain_versions_bit_for_bit(family, env_id, refs):
    """dfim_rollout_random and sync_rollout_random (producer and consumer
    warps over a shared-memory ring of K = 8 steps a slot with Wiener
    references; one thread per env with constant ones, the sync rollout at
    constant speed drawing the next step's action ahead) equal their plain
    versions bit for bit in every env and every output (NaN where the plain
    version has NaN), for 1, 17, 129 and 2048 envs (a partial warp, a
    partial block, a partial second block, full blocks) and 1, K - 1, K + 1
    and 200 steps, so that the ring stops in every place of a slot.  Envs 0
    and 5 start at five times the current limit and reset at their first
    step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels are CUDA C++ without a CPU mode")
    from gym_electric_motor_tpu_torch import references as rg
    from gym_electric_motor_tpu_torch.ops import fused_dfim_family as dff
    from gym_electric_motor_tpu_torch.ops import fused_sync_family as sf

    dev = torch.device("cuda")
    kw = {}
    if refs == "const":
        kw["reference_generator"] = rg.ReferenceSpec(
            [rg.ConstReference(n, v) for n, v in SCIM_CONST_REFS[env_id.split("-")[1]]])
    env = gt.make_functional(env_id, device=dev, **kw)
    mod = dff if family == "dfim" else sf
    c = dff.DfimConsts(env) if family == "dfim" else sf.SyncConsts(env)
    assert c.all_const == (refs == "const")
    rng = np.random.default_rng(37)
    if family == "dfim":
        i_lim = float(c.f["inv_ilim2"]) ** -0.5
        bounds = [(-0.5 * i_lim, 0.5 * i_lim)] * 2 + [(-0.5, 0.5)] * 2 + [(0, 2 * np.pi)]
    else:
        i_lim = 1.0 / float(c.f["inv_i_lim"])
        bounds = [(-0.6 * i_lim, 0.6 * i_lim)] * 2 + [(0, 2 * np.pi)]
    bounds = ([(0, 100)] if c.mech else []) + bounds
    hot = int(c.mech)  # the first current plane
    name = f"{family}_rollout_random"
    for n in (1, 17, 129, 2048):
        R = -(-n // 128)
        start = [rng.uniform(lo, hi, (R, 128)).astype(np.float32) for lo, hi in bounds]
        for e in (0, 5):
            start[hot].reshape(-1)[e] = 5.0 * i_lim
        start = [torch.as_tensor(x, device=dev) for x in start]
        for T in (1, 7, 9, 200):
            want = getattr(mod, name + "_plain")(c, 7, start, T)
            want = ([x.reshape(-1)[:n] for x in want[:c.n_state + 2]]
                    + [x.reshape(c.n_ref, R * 128)[:, :n].reshape(-1) for x in want[c.n_state + 2:]])
            got = mod._rollout_random_launch(c, 7, start, T, n)
            torch.cuda.synchronize()
            for j, (g, x) in enumerate(zip(got, want)):
                same = (g == x) | (torch.isnan(g) & torch.isnan(x))
                assert bool(same.all()), f"n={n} T={T}: output {j} differs in {int((~same).sum())}"
            assert float(got[c.n_state + 1][0]) >= 1.0  # env 0 reset


# policy_rollout's twelve instances: (H, sample, references)
POLICY_ROLLOUT_CASES = [(h, s, r) for h in (8, 16, 32) for s in ("categorical", "greedy")
                        for r in ("wiener", "const")]


@pytest.mark.cuda
@pytest.mark.parametrize("hidden,sample,ref_mode", POLICY_ROLLOUT_CASES,
                         ids=[f"H{h}-{s}-{r}" for h, s, r in POLICY_ROLLOUT_CASES])
def test_cuda_policy_rollout_equals_plain_version_bit_for_bit(hidden, sample, ref_mode):
    """policy_rollout (csrc/fused_policy.cu: producer and consumer warps over
    a shared-memory ring with Wiener references, one thread per env reading
    the weights as 16-byte vectors with constant ones) equals
    policy_rollout_plain bit for bit in every env and every output (NaN
    where the plain version has NaN), for 1, 37 and 2051 envs (a partial
    warp, a partial block, a partial last block) and 1, 7, 8 and 64 steps,
    and for 131 envs at 1024 steps.  Envs 0 and 5 start at three times the
    current limit and reset at their first step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels are CUDA C++ without a CPU mode")
    from gym_electric_motor_tpu_torch.ops import fused_policy as fp

    dev = torch.device("cuda")
    env = gt.make_functional("Finite-CC-PMSM-v0", device=dev, state_filter=fp.STATE_FILTER)
    consts = fp.PolicyConsts(env)
    greedy, wiener = sample == "greedy", ref_mode == "wiener"
    rng = np.random.default_rng(41)
    w = [torch.as_tensor((rng.normal(size=k) * s).astype(np.float32), device=dev)
         for k, s in ((6 * hidden, 0.5), (hidden, 0.1), (hidden * 8, 0.5), (8, 0.1))]
    i_lim = 1.0 / float(consts.f["inv_i_lim"])
    fp.reset_launches()
    for n, steps in ((1, (1, 7, 8, 64)), (37, (1, 7, 8, 64)), (2051, (1, 7, 8, 64)),
                     (131, (1024,))):
        R = -(-n // 128)
        start = [rng.uniform(lo, hi, (R, 128)).astype(np.float32)
                 for lo, hi in ((-i_lim, i_lim), (-i_lim, i_lim), (0, 2 * np.pi))]
        for e in (0, 5):
            start[0].reshape(-1)[e] = 3.0 * i_lim
        start = [torch.as_tensor(x, device=dev) for x in start]
        refs = [torch.as_tensor(rng.uniform(-0.5, 0.5, (R, 128)).astype(np.float32), device=dev)
                for _ in range(2)]
        refs_k = (None, None) if wiener else refs
        for T in steps:
            got = fp._rollout_launch(consts, 9, *w, *start, *refs_k, T, n, greedy, wiener)
            torch.cuda.synchronize()
            want = fp.policy_rollout_plain(consts, 9, *w, *start, *refs, T, sample, ref_mode)
            for j, (g, x) in enumerate(zip(got, want)):
                x = x.reshape(-1)[:n]
                assert g.shape == x.shape and g.dtype == x.dtype, (n, T, j)
                same = (g == x) | (torch.isnan(g) & torch.isnan(x))
                assert bool(same.all()), f"n={n} T={T}: output {j} differs in {int((~same).sum())}"
            assert float(got[4][0]) >= 1.0  # env 0 reset
    # the plane entry point launches the same kernel, counted once
    R = 3
    start = [torch.zeros((R, 128), device=dev) for _ in range(3)]
    refs = [torch.full((R, 128), 0.1, device=dev) for _ in range(2)]
    got = fp.policy_rollout(consts, 9, *w, *start, *refs, 9, sample, ref_mode)
    want = fp.policy_rollout_plain(consts, 9, *w, *start, *refs, 9, sample, ref_mode)
    assert all(bool(torch.equal(g, x)) for g, x in zip(got, want))
    assert {k: v for k, v in fp.LAUNCHES.items() if v} == {"policy_rollout": 1}
    layout = fp.policy_rollout_layout(hidden, sample, ref_mode)
    assert layout["design"] == ("warp-specialised" if wiener else "one thread per env")


DC_SC_IDS = ["Cont-SC-SeriesDc-v0", "Cont-SC-ShuntDc-v0"]


@pytest.mark.cuda
@pytest.mark.parametrize("env_id", DC_SC_IDS)
def test_cuda_dc_sc_rollout_random_equals_plain_version_bit_for_bit(env_id):
    """dc_sc_rollout_random (csrc/fused_dc_sc.cu: producer and consumer warps
    over a shared-memory ring) equals dc_sc_rollout_random_plain bit for bit
    in every env and every output (NaN where the plain version has NaN), for
    1, 37 and 2051 envs and 1, 3, 4, 5, 9 and 64 steps (the ring stops in
    every place of its slots, and a Box-Muller pair's sine is carried to an
    odd step), and for 131 envs at 1024 steps.  Env 0 starts at five times
    the armature current's limit and resets at its first step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels are CUDA C++ without a CPU mode")
    from gym_electric_motor_tpu_torch.ops import fused_dc as fd

    dev = torch.device("cuda")
    c = fd.DcScConsts(gt.make_functional(env_id, device=dev))
    rng = np.random.default_rng(43)
    fd.reset_launches()
    for n, steps in ((1, (1, 3, 4, 5, 9, 64)), (37, (1, 3, 4, 5, 9, 64)),
                     (2051, (1, 3, 4, 5, 9, 64)), (131, (1024,))):
        R = -(-n // 128)
        start = [rng.uniform(lo, hi, (R, 128)).astype(np.float32)
                 for lo, hi in [(0, 100)] + [(-5, 5)] * (c.n_state - 1)]
        start[1].reshape(-1)[0] = 5.0 * float(c.f["i0_lim"])
        start = [torch.as_tensor(x, device=dev) for x in start]
        for T in steps:
            got = fd._dc_sc_random_launch(c, 7, start, T, n)
            torch.cuda.synchronize()
            want = fd.dc_sc_rollout_random_plain(c, 7, start, T)
            for j, (g, x) in enumerate(zip(got, want)):
                x = x.reshape(-1)[:n]
                assert g.shape == x.shape and g.dtype == x.dtype, (n, T, j)
                same = (g == x) | (torch.isnan(g) & torch.isnan(x))
                assert bool(same.all()), f"n={n} T={T}: output {j} differs in {int((~same).sum())}"
            assert float(got[c.n_state + 1][0]) >= 1.0  # env 0 reset
    assert not any(fd.LAUNCHES.values())
    assert fd.dc_sc_ring_layout()["design"] == "warp-specialised"


def _equal_bits(got, want, n, rows=1):
    """Per output, the envs where the kernel's first ``n`` envs equal the
    plain version's bit for bit (NaN where it has NaN); ``rows``-row
    planes hold row r's envs at ``[r n, (r + 1) n)``."""
    out = []
    for g, x in zip(got, want):
        k = rows if g.numel() == rows * n else 1
        x = x.reshape(k, -1)[:, :n].reshape(-1)
        assert g.shape == x.shape and g.dtype == x.dtype
        out.append((g == x) | (torch.isnan(g) & torch.isnan(x)))
    return out


# (envs, steps): the ring stops at every place in a slot of four or eight
# steps, and across the odd step that takes an even step's carried sine
RING_STOPS = ((1, (1, 3, 4, 5, 8, 9, 64)), (37, (1, 3, 4, 5, 8, 9, 64)),
              (2051, (1, 3, 4, 5, 8, 9, 64)), (131, (1024,)))


@pytest.mark.cuda
def test_cuda_eesm_cc_rollout_random_equals_plain_version_bit_for_bit():
    """eesm_cc_rollout_random (csrc/fused_eesm_cc.cu: producer and consumer
    warps over a shared-memory ring) equals eesm_cc_rollout_random_plain bit
    for bit in every env and every output (NaN where the plain version has
    NaN), for 1, 37 and 2051 envs at 1, 3, 4, 5, 8, 9 and 64 steps and 131
    envs at 1024.  Env 0 starts at five times the current limit and resets
    at its first step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels are CUDA C++ without a CPU mode")
    from gym_electric_motor_tpu_torch.ops import fused_eesm as fe

    dev = torch.device("cuda")
    c = fe.EesmCcConsts(gt.make_functional("Finite-CC-EESM-v0", device=dev))
    rng = np.random.default_rng(47)
    fe.reset_launches()
    for n, steps in RING_STOPS:
        R = -(-n // 128)
        start = [rng.uniform(lo, hi, (R, 128)).astype(np.float32)
                 for lo, hi in [(-8, 8)] * 3 + [(0, 2 * np.pi)]]
        start[0].reshape(-1)[0] = 5.0 / float(c.ec.f["inv_i_lim"])
        start = [torch.as_tensor(x, device=dev) for x in start]
        for T in steps:
            got = fe._eesm_cc_random_launch(c, 7, start, T, n)
            torch.cuda.synchronize()
            want = fe.eesm_cc_rollout_random_plain(c, 7, start, T)
            for j, same in enumerate(_equal_bits(got, want, n, rows=3)):
                assert bool(same.all()), f"n={n} T={T}: output {j} differs in {int((~same).sum())}"
            assert float(got[5][0]) >= 1.0  # env 0 reset
    assert not any(fe.LAUNCHES.values())
    assert fe.eesm_cc_ring_layout()["design"] == "warp-specialised"


DC_CASCADE_BIT_CASES = [(i, r) for i in ("Cont-SC-PermExDc-v0", "Cont-SC-SeriesDc-v0",
                                         "Cont-SC-ShuntDc-v0") for r in ("wiener", "const")]


@pytest.mark.cuda
@pytest.mark.parametrize("env_id,refs", DC_CASCADE_BIT_CASES,
                         ids=[f"{i}-{r}" for i, r in DC_CASCADE_BIT_CASES])
def test_cuda_dc_cascade_rollout_equals_plain_version_bit_for_bit(env_id, refs):
    """dc_cascade_rollout (csrc/fused_dc_cascade.cu) equals
    dc_cascade_rollout_plain bit for bit in every env and every output (NaN
    where the plain version has NaN): with Wiener references on the ring
    (producer warps draw the reference's candidates, consumer warps run the
    cascade and the step), with constant ones on one thread per env; for 1,
    37 and 2051 envs at 1, 3, 4, 5, 8, 9 and 64 steps and 131 envs at 1024.
    Env 0 starts at five times the armature current's limit and resets at
    its first step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels are CUDA C++ without a CPU mode")
    from gym_electric_motor_tpu_torch import references as rg
    from gym_electric_motor_tpu_torch.controllers import GemController
    from gym_electric_motor_tpu_torch.ops import fused_dc_family as dcf

    dev = torch.device("cuda")
    kw = ({"reference_generator": rg.ReferenceSpec([rg.ConstReference("omega", 0.5)])}
          if refs == "const" else {})
    env = gt.make_functional(env_id, device=dev, **kw)
    cc = dcf.DcCascadeConsts(env, GemController.make(env, env_id))
    n_state = cc.c.n_state
    rng = np.random.default_rng(53)
    dcf.reset_launches()
    for n, steps in RING_STOPS:
        R = -(-n // 128)
        start = [rng.uniform(lo, hi, (R, 128)).astype(np.float32)
                 for lo, hi in [(0, 100)] + [(-5, 5)] * (n_state - 1)]
        start[1].reshape(-1)[0] = 5.0 * float(cc.c.f["lim0"])
        start = [torch.as_tensor(x, device=dev) for x in start]
        for T in steps:
            got = dcf._dc_cascade_launch(cc, 7, start, T, n)
            torch.cuda.synchronize()
            want = dcf.dc_cascade_rollout_plain(cc, 7, start, T)
            for j, same in enumerate(_equal_bits(got, want, n)):
                assert bool(same.all()), f"n={n} T={T}: output {j} differs in {int((~same).sum())}"
            assert float(got[n_state + 1][0]) >= 1.0  # env 0 reset
    assert not any(dcf.LAUNCHES.values())
    assert dcf.dc_cascade_ring_layout(cc)["design"] == (
        "warp-specialised" if refs == "wiener" else "one thread per env")


@pytest.mark.cuda
@pytest.mark.parametrize("refs", ["wiener", "const"])
def test_cuda_foc_rollout_equals_plain_version_bit_for_bit(refs):
    """foc_rollout (csrc/fused_foc.cu) equals foc_rollout_plain bit for bit
    in every env and every output (NaN where the plain version has NaN):
    with Wiener references on the ring (producer warps draw the references'
    candidates, consumer warps run the controller and the step), with
    constant ones on one thread per env; for 1, 37 and 2051 envs at 1, 3,
    4, 5, 8, 9 and 64 steps and 131 envs at 1024.  Env 0 starts at five
    times the current limit and resets at its first step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels are CUDA C++ without a CPU mode")
    from gym_electric_motor_tpu_torch.controllers import GemController

    dev = torch.device("cuda")
    env = gt.make_functional("Cont-CC-PMSM-v0", device=dev)
    fc = fs.FocConsts(env, GemController.make(env, "Cont-CC-PMSM-v0"), refs)
    rng = np.random.default_rng(59)
    fs.reset_launches()
    for n, steps in RING_STOPS:
        R = -(-n // 128)
        start = [rng.uniform(lo, hi, (R, 128)).astype(np.float32)
                 for lo, hi in [(-50, 50), (-50, 50), (0, 2 * np.pi), (-0.3, 0.3), (-0.3, 0.3)]]
        start[0].reshape(-1)[0] = 5.0 / float(fc.pm.f["inv_i_lim"])
        start = [torch.as_tensor(x, device=dev) for x in start]
        for T in steps:
            got = fs._foc_launch(fc, 7, start, T, n)
            torch.cuda.synchronize()
            want = fs.foc_rollout_plain(fc, 7, *start, T)
            for j, same in enumerate(_equal_bits(got, want, n, rows=2)):
                assert bool(same.all()), f"n={n} T={T}: output {j} differs in {int((~same).sum())}"
            assert float(got[4][0]) >= 1.0  # env 0 reset
    assert not any(fs.LAUNCHES.values())
    assert fs.foc_ring_layout(fc)["design"] == (
        "warp-specialised" if refs == "wiener" else "one thread per env")


@pytest.mark.cuda
def test_cuda_dfim_cc_rollout_random_equals_plain_version_bit_for_bit():
    """dfim_cc_rollout_random (csrc/fused_dfim_cc.cu: producer and consumer
    warps over a shared-memory ring) equals dfim_cc_rollout_random_plain bit
    for bit in every env and every output (NaN where the plain version has
    NaN), for 1, 37 and 2051 envs at 1, 3, 4, 5, 8, 9 and 64 steps and 131
    envs at 1024.  Env 0 starts at five times the current limit and resets
    at its first step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels are CUDA C++ without a CPU mode")
    from gym_electric_motor_tpu_torch.ops import fused_dfim as fd

    dev = torch.device("cuda")
    c = fd.DfimCcConsts(gt.make_functional("Cont-CC-DFIM-v0", device=dev))
    rng = np.random.default_rng(61)
    fd.reset_launches()
    for n, steps in RING_STOPS:
        R = -(-n // 128)
        start = [rng.uniform(lo, hi, (R, 128)).astype(np.float32)
                 for lo, hi in [(-10, 10)] * 2 + [(-1.5, 1.5)] * 2 + [(0, 2 * np.pi)]]
        start[0].reshape(-1)[0] = 5.0 / float(c.f["inv_i_lim"])
        start = [torch.as_tensor(x, device=dev) for x in start]
        for T in steps:
            got = fd._dfim_cc_random_launch(c, 7, start, T, n)
            torch.cuda.synchronize()
            want = fd.dfim_cc_rollout_random_plain(c, 7, start, T)
            for j, same in enumerate(_equal_bits(got, want, n, rows=2)):
                assert bool(same.all()), f"n={n} T={T}: output {j} differs in {int((~same).sum())}"
            assert float(got[6][0]) >= 1.0  # env 0 reset
    assert not any(fd.LAUNCHES.values())
    assert fd.dfim_cc_ring_layout()["design"] == "warp-specialised"


@pytest.mark.cuda
def test_cuda_scim_rollout_random_equals_plain_version_bit_for_bit():
    """scim_rollout_random (csrc/fused_scim_tc.cu: producer and consumer
    warps over a shared-memory ring) equals scim_rollout_random_plain bit
    for bit in every env and every output (NaN where the plain version has
    NaN), for 1, 37 and 2051 envs at 1, 3, 4, 5, 8, 9 and 64 steps and 131
    envs at 1024: the ring stops at every place in a slot and across the
    odd step that takes the carried sine half.  Env 0 starts at five times
    the current limit and resets at its first step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels are CUDA C++ without a CPU mode")
    from gym_electric_motor_tpu_torch.ops import fused_induction as fi

    dev = torch.device("cuda")
    c = fi.ScimConsts(gt.make_functional("Cont-TC-SCIM-v0", device=dev))
    i_lim = float(c.ic.f["inv_ilim2"]) ** -0.5
    rng = np.random.default_rng(67)
    fi.reset_launches()
    for n, steps in RING_STOPS:
        R = -(-n // 128)
        start = [rng.uniform(lo, hi, (R, 128)).astype(np.float32)
                 for lo, hi in [(-10, 10)] * 2 + [(-1.5, 1.5)] * 2]
        start[0].reshape(-1)[0] = 5.0 * i_lim
        start = [torch.as_tensor(x, device=dev) for x in start]
        for T in steps:
            got = fi._scim_random_launch(c, 7, start, T, n)
            torch.cuda.synchronize()
            want = fi.scim_rollout_random_plain(c, 7, start, T)
            for j, same in enumerate(_equal_bits(got, want, n)):
                assert bool(same.all()), f"n={n} T={T}: output {j} differs in {int((~same).sum())}"
            assert float(got[5][0]) >= 1.0  # env 0 reset
    assert not any(fi.LAUNCHES.values())


@pytest.mark.cuda
def test_cuda_pmsm_rollout_random_equals_plain_version_bit_for_bit():
    """pmsm_rollout_random (csrc/fused_pmsm.cu: producer and consumer warps
    over a shared-memory ring, 9 words a step) equals
    pmsm_rollout_random_plain bit for bit in every env and every output (NaN
    where the plain version has NaN), for 1, 37 and 2051 envs at 1, 3, 4,
    5, 8, 9 and 64 steps and 131 envs at 1024: the ring stops at every place
    in a slot, partial warps and blocks.  Env 0 starts at five times the
    current limit and resets at its first step.  The wrapper's launch
    counts once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels are CUDA C++ without a CPU mode")
    dev = torch.device("cuda")
    consts = fs.PmsmConsts(gt.make_functional("Finite-CC-PMSM-v0", device=dev))
    rng = np.random.default_rng(79)
    fs.reset_launches()
    for n, steps in RING_STOPS:
        R = -(-n // 128)
        start = [rng.uniform(lo, hi, (R, 128)).astype(np.float32)
                 for lo, hi in ((-50, 50), (-50, 50), (0, 2 * np.pi))]
        start[0].reshape(-1)[0] = 5.0 / float(consts.f["inv_i_lim"])
        start = [torch.as_tensor(x, device=dev) for x in start]
        for T in steps:
            got = fs._pmsm_random_launch(consts, 7, start, T, n)
            torch.cuda.synchronize()
            want = fs.pmsm_rollout_random_plain(consts, 7, *start, T)
            for j, same in enumerate(_equal_bits(got, want, n, rows=2)):
                assert bool(same.all()), f"n={n} T={T}: output {j} differs in {int((~same).sum())}"
            assert float(got[4][0]) >= 1.0  # env 0 reset
    assert not any(fs.LAUNCHES.values())
    out = fs.pmsm_rollout_random(consts, 7, *start, 9)
    want = fs.pmsm_rollout_random_plain(consts, 7, *start, 9)
    assert all(bool(torch.equal(a, b)) for a, b in zip(out, want))
    assert {k: v for k, v in fs.LAUNCHES.items() if v} == {"pmsm_rollout_random": 1}
    assert fs.pmsm_ring_layout()["design"] == "warp-specialised"


@pytest.mark.cuda
def test_cuda_permex_rollout_random_equals_plain_version_bit_for_bit():
    """permex_rollout_random (csrc/fused_permex.cu: producer and consumer
    warps over a shared-memory ring, 5 words a step) equals
    permex_rollout_random_plain bit for bit in every env and every output
    (NaN where the plain version has NaN), for 1, 37 and 2051 envs at 1, 3,
    4, 5, 8, 9 and 64 steps and 131 envs at 1024: the ring stops at every
    place in a slot and across the odd step that takes the carried sine
    half.  Env 0 starts at five times the current limit and resets at its
    first step.  The wrapper's launch counts once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels are CUDA C++ without a CPU mode")
    from gym_electric_motor_tpu_torch.ops import fused_dc as fd

    dev = torch.device("cuda")
    c = fd.PermexConsts(gt.make_functional("Finite-CC-PermExDc-v0", device=dev))
    rng = np.random.default_rng(83)
    fd.reset_launches()
    for n, steps in RING_STOPS:
        R = -(-n // 128)
        i0 = rng.uniform(-100, 100, (R, 128)).astype(np.float32)
        i0.reshape(-1)[0] = 5.0 / float(c.f["inv_i_lim"])
        i0 = torch.as_tensor(i0, device=dev)
        for T in steps:
            got = fd._permex_random_launch(c, 7, i0, T, n)
            torch.cuda.synchronize()
            want = fd.permex_rollout_random_plain(c, 7, i0, T)
            for j, same in enumerate(_equal_bits(got, want, n)):
                assert bool(same.all()), f"n={n} T={T}: output {j} differs in {int((~same).sum())}"
            assert float(got[2][0]) >= 1.0  # env 0 reset
    assert not any(fd.LAUNCHES.values())
    out = fd.permex_rollout_random(c, 7, i0, 9)
    want = fd.permex_rollout_random_plain(c, 7, i0, 9)
    assert all(bool(torch.equal(a, b)) for a, b in zip(out, want))
    assert {k: v for k, v in fd.LAUNCHES.items() if v} == {"permex_rollout_random": 1}
    assert fd.permex_ring_layout()["design"] == "warp-specialised"


def _equal_record_bits(got, want, n, T):
    """Per recorded plane, the steps and envs where the kernel's ``(T, n)``
    plane equals the plain version's ``(T, R, 128)`` plane on its first
    ``n`` envs bit for bit (NaN where it has NaN)."""
    out = []
    for g, x in zip(got, want):
        x = x.reshape(T, -1)[:, :n]
        assert g.shape == x.shape and g.dtype == x.dtype
        out.append((g == x) | (torch.isnan(g) & torch.isnan(x)))
    return out


@pytest.mark.cuda
def test_cuda_pmsm_record_random_equals_plain_version_bit_for_bit():
    """pmsm_record_random (csrc/fused_pmsm.cu: producer and consumer warps
    over a shared-memory ring of its own, the random rollout's 9 words a
    step) equals pmsm_record_random_plain bit for bit in every plane, env
    and step (NaN where the plain version has NaN), for 1, 37 and 2051 envs
    at 1, 3, 4, 5, 8, 9 and 64 steps and 131 envs at 1024: the ring stops
    at every place in a slot, partial warps and blocks.  Env 0 starts at
    five times the current limit and resets at its first step.  The
    wrapper's launch counts once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels are CUDA C++ without a CPU mode")
    dev = torch.device("cuda")
    consts = fs.PmsmConsts(gt.make_functional("Finite-CC-PMSM-v0", device=dev))
    rng = np.random.default_rng(89)
    fs.reset_launches()
    for n, steps in RING_STOPS:
        R = -(-n // 128)
        start = [rng.uniform(lo, hi, (R, 128)).astype(np.float32)
                 for lo, hi in ((-50, 50), (-50, 50), (0, 2 * np.pi))]
        start[0].reshape(-1)[0] = 5.0 / float(consts.f["inv_i_lim"])
        start = [torch.as_tensor(x, device=dev) for x in start]
        for T in steps:
            got = fs._pmsm_record_random_launch(consts, 7, start, T, n)
            torch.cuda.synchronize()
            want = fs.pmsm_record_random_plain(consts, 7, *start, T)
            for j, same in enumerate(_equal_record_bits(got, want, n, T)):
                assert bool(same.all()), f"n={n} T={T}: plane {j} differs in {int((~same).sum())}"
            assert float(got[7][0, 0]) == 1.0  # env 0 reset at its first step
    assert not any(fs.LAUNCHES.values())
    out = fs.pmsm_record_random(consts, 7, *start, 9)
    want = fs.pmsm_record_random_plain(consts, 7, *start, 9)
    assert all(bool(torch.equal(a, b)) for a, b in zip(out, want))
    assert {k: v for k, v in fs.LAUNCHES.items() if v} == {"pmsm_record_random": 1}
    assert fs.pmsm_record_ring_layout()["design"] == "warp-specialised"


@pytest.mark.cuda
def test_cuda_permex_record_random_equals_plain_version_bit_for_bit():
    """permex_record_random (csrc/fused_permex.cu: producer and consumer
    warps over a shared-memory ring of its own, 5 words a step, a fresh
    Box-Muller pair each step) equals permex_record_random_plain bit for bit
    in every plane, env and step (NaN where the plain version has NaN), for
    1, 37 and 2051 envs at 1, 3, 4, 5, 8, 9 and 64 steps and 131 envs at
    1024: the ring stops at every place in a slot, partial warps and
    blocks.  Env 0 starts at five times the current limit and resets at its
    first step.  The wrapper's launch counts once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels are CUDA C++ without a CPU mode")
    from gym_electric_motor_tpu_torch.ops import fused_dc as fd

    dev = torch.device("cuda")
    c = fd.PermexConsts(gt.make_functional("Finite-CC-PermExDc-v0", device=dev))
    rng = np.random.default_rng(97)
    fd.reset_launches()
    for n, steps in RING_STOPS:
        R = -(-n // 128)
        i0 = rng.uniform(-100, 100, (R, 128)).astype(np.float32)
        i0.reshape(-1)[0] = 5.0 / float(c.f["inv_i_lim"])
        i0 = torch.as_tensor(i0, device=dev)
        for T in steps:
            got = fd._permex_record_random_launch(c, 7, i0, T, n)
            torch.cuda.synchronize()
            want = fd.permex_record_random_plain(c, 7, i0, T)
            for j, same in enumerate(_equal_record_bits(got, want, n, T)):
                assert bool(same.all()), f"n={n} T={T}: plane {j} differs in {int((~same).sum())}"
            assert float(got[4][0, 0]) == 1.0  # env 0 reset at its first step
    assert not any(fd.LAUNCHES.values())
    out = fd.permex_record_random(c, 7, i0, 9)
    want = fd.permex_record_random_plain(c, 7, i0, 9)
    assert all(bool(torch.equal(a, b)) for a, b in zip(out, want))
    assert {k: v for k, v in fd.LAUNCHES.items() if v} == {"permex_record_random": 1}
    assert fd.permex_record_ring_layout()["design"] == "warp-specialised"


REINFORCE_CASES = [(h, s, r) for h in (8, 16, 32) for s in ("greedy", "categorical")
                   for r in ("const", "wiener")]


@pytest.mark.cuda
@pytest.mark.parametrize("hidden,sample,ref_mode", REINFORCE_CASES,
                         ids=[f"H{h}-{s}-{r}" for h, s, r in REINFORCE_CASES])
def test_cuda_reinforce_rollout_every_instance_matches_plain_version(hidden, sample, ref_mode):
    """reinforce_rollout (csrc/fused_policy.cu's role split: a step warp and
    trace warps holding e and G in registers) in each of its 12 instances
    against its plain version at 256 envs x 64 steps, gamma 0.9: greedy in
    every env at rtol 1e-4 / atol 1e-4 and the gradient block within 1e-4 of
    its largest entry, categorical in 99% of envs.  On 200 of the envs (the
    last block cut short, at 32 and at 128 envs a block) the kernel gives
    the first 200 envs' outputs and per-env gradient sums of the full launch
    bit for bit, and the launch allocates the (P, n) sums and no trace
    tensor beside them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels are CUDA C++ without a CPU mode")
    from gym_electric_motor_tpu_torch.ops import fused_policy as fp

    dev = torch.device("cuda")
    env = gt.make_functional("Finite-CC-PMSM-v0", device=dev, state_filter=fp.STATE_FILTER)
    consts = fp.PolicyConsts(env)
    R, T, n = 2, 64, 200
    rng = np.random.default_rng(71 + hidden)
    start = [torch.as_tensor(rng.uniform(lo, hi, (R, 128)).astype(np.float32), device=dev)
             for lo, hi in ((-50, 50), (-50, 50), (0, 2 * np.pi))]
    refs = [torch.as_tensor(rng.uniform(-0.5, 0.5, (R, 128)).astype(np.float32), device=dev)
            for _ in range(2)]
    w = [torch.as_tensor((rng.normal(size=k) * s).astype(np.float32), device=dev)
         for k, s in ((6 * hidden, 0.5), (hidden, 0.1), (hidden * 8, 0.5), (8, 0.1))]
    fp.reset_launches()
    args = (consts, 5, -0.05, *w, *start, *refs, T, 0.9, sample, ref_mode)
    got, want = fp.reinforce_rollout(*args), fp.reinforce_rollout_plain(*args)
    ok = np.ones(R * 128, bool)
    for j, (g, x) in enumerate(zip(got[:5], want[:5])):
        g, x = g.cpu().numpy(), x.cpu().numpy()
        err = np.abs(g - x)
        if j == 2:
            err = np.remainder(err, 2 * np.pi)
            err = np.minimum(err, 2 * np.pi - err)
        ok &= (err <= 1e-4 + 1e-4 * np.abs(x)).reshape(-1)
    if sample == "greedy":
        assert ok.all(), (hidden, ref_mode, ok.mean())
        err = float((got[5] - want[5]).abs().max() / want[5].abs().max())
        assert err < 1e-4, (hidden, ref_mode, err)
    else:
        assert ok.mean() >= 0.99, (hidden, ref_mode, ok.mean())
    greedy, wiener = sample == "greedy", ref_mode == "wiener"
    base = torch.full((1,), -0.05, device=dev)
    ref_d, ref_q = (None, None) if wiener else refs
    full = fp._reinforce_launch(consts, 5, base, *w, *start, ref_d, ref_q, T, R * 128, 0.9,
                                greedy, wiener)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    part = fp._reinforce_launch(consts, 5, base, *w, *start, ref_d, ref_q, T, n, 0.9, greedy,
                                wiener)
    torch.cuda.synchronize()
    n_p = fp.n_policy_params(6, hidden)
    assert torch.cuda.max_memory_allocated(dev) - before < 2 * 4 * n_p * n + 4096
    for j, (a, b) in enumerate(zip(part, full)):
        b = b[:, :n] if b.dim() == 2 else b[:n]
        assert bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all()), (hidden, j)
    torch.cuda.synchronize()
    assert {k: v for k, v in fp.LAUNCHES.items() if v} == {"reinforce_rollout": 1,
                                                           "reinforce_reduce": 1}


# dc_policy_record's widths: a partial lane group's block, PPO's 2048 envs
# (eight lanes an env on an H100) and a partial block past it (four lanes);
# a finite, a joint-head ExtExDc and a continuous id
DC_POLICY_IDS = [("Finite-CC-PermExDc-v0", False), ("Finite-CC-ExtExDc-v0", True),
                 ("Cont-CC-PermExDc-v0", False)]
DC_POLICY_BIT_CASES = [(i, j, h, n) for i, j in DC_POLICY_IDS for h in (32, 16, 5)
                       for n in (1, 37, 2048, 2051)]
# sync_policy_record's: the same widths (PPO's 2048 envs take the wide
# design, 2051 the narrow one) on a finite id, the Gaussian head and the
# speed ODE
SYNC_POLICY_IDS = ["Finite-CC-PMSM-v0", "Cont-CC-PMSM-v0", "Cont-SC-PMSM-v0"]
SYNC_POLICY_BIT_CASES = [(i, h, n) for i in SYNC_POLICY_IDS for h in (32, 16, 5)
                         for n in (1, 37, 2048, 2051)]
# eesm_policy_record's: the same widths on the three-row finite id, its
# 32-way joint head, and the Gaussian head with the speed ODE
EESM_POLICY_IDS = [("Finite-CC-EESM-v0", False), ("Finite-CC-EESM-v0", True),
                   ("Cont-SC-EESM-v0", False)]
EESM_POLICY_BIT_CASES = [(i, j, h, n) for i, j in EESM_POLICY_IDS for h in (32, 16, 5)
                         for n in (1, 37, 2048, 2051)]
# srm_policy_record's: the three-row finite id, its 27-way joint head, the
# Gaussian head with the speed ODE, and the saturating finite TC id (the
# torque in the observation and the reward)
SRM_POLICY_IDS = [("Finite-CC-SRM-v0", False, None), ("Finite-CC-SRM-v0", True, None),
                  ("Cont-SC-SRM-v0", False, None), ("Finite-TC-SRM-v0", False, 1.2)]
SRM_POLICY_BIT_CASES = [(i, j, p, h, n) for i, j, p in SRM_POLICY_IDS for h in (32, 16, 5)
                        for n in (1, 37, 2048, 2051)]
# dfim_policy_record's: the finite dq id, its 64-way joint head, and the six
# Gaussian channels under the speed ODE
DFIM_POLICY_IDS = [("Finite-CC-DFIM-v0", False), ("Finite-CC-DFIM-v0", True),
                   ("Cont-SC-DFIM-v0", False)]
DFIM_POLICY_BIT_CASES = [(i, j, h, n) for i, j in DFIM_POLICY_IDS for h in (32, 16, 5)
                         for n in (1, 37, 2048, 2051)]
# induction_policy_record's: the finite and the continuous dq ids, and the
# three Gaussian channels under the speed ODE
INDUCTION_POLICY_IDS = ["Finite-CC-SCIM-v0", "Cont-CC-SCIM-v0", "Cont-SC-SCIM-v0"]
INDUCTION_POLICY_BIT_CASES = [(i, h, n) for i in INDUCTION_POLICY_IDS for h in (32, 16, 5)
                              for n in (1, 37, 2048, 2051)]


def _hold_policy_designs_bit_for_bit(env_id, joint, hidden, n, psi_s=None):
    """A universal recorder on lane groups (a kernel of
    ``fp.POLICY_LANE_DESIGNS``: G lanes of a warp an env, lane 0 alone stepping
    or every lane, or one thread per env, by the launch's width rule, which
    the layout reports) against its one-thread design, bit for bit in
    every env and every output (NaN where the other has NaN), for 1, 2 and
    64 steps, at ``hidden`` units (H is a run-time count that places the
    staged weights and the lanes' hidden slots).  The plain version rounds
    tanhf and expf otherwise, so the rule against it stays the universal
    recorder's (test_cuda_universal_policy_kernel_matches_plain_version).
    Env 0 starts at ten times its current limit and resets at once;
    ``psi_s`` builds a saturating SRM."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels are CUDA C++ without a CPU mode")
    from gym_electric_motor_tpu_torch.ops import fused_policy as fp

    dev = torch.device("cuda")
    kw = {"motor": {"motor_parameter": {"psi_s": psi_s}}} if psi_s else {}
    env = gt.make_functional(env_id, device=dev, **kw)
    R = -(-n // 128)
    roll = fp.make_fused_policy_record_universal(env, 64, R * 128, hidden=hidden,
                                                 joint_heads=joint)
    pol = roll.policy
    c = pol.consts
    layout = fp.policy_universal_layout(pol.kernel, n)
    lanes, lead = fp.policy_universal_lanes(pol.kernel, n, layout["sms"])
    assert (layout["lanes"], layout["lead_lane_steps"]) == (lanes, lead)
    assert layout["blocks"] == -(-n * lanes // 128)
    rng = np.random.default_rng(41)
    scale = 0.3 if pol.cont else 0.5
    w = [torch.as_tensor((rng.normal(size=k) * s).astype(np.float32), device=dev)
         for k, s in ((pol.obs_dim * hidden, scale), (hidden, 0.1), (hidden * pol.n_out, scale),
                      (pol.n_out, 0.1))]
    ls = torch.full((len(roll.act_names),), -0.5, device=dev) if pol.cont else None
    if pol.kernel == "sync_policy_record":
        # omega (under a dynamic load) to 100 rad/s, the currents to half
        # their limit, the angle in [0, 2 pi)
        i_lim = 1.0 / c.f["inv_i_lim"]
        bounds = ([(0.0, 100.0)] if c.mech else []) + [(-0.5 * i_lim, 0.5 * i_lim)] * 2 + [
            (0.0, 2 * np.pi)]
        start = [rng.uniform(lo, hi, (R, 128)).astype(np.float32) for lo, hi in bounds]
        start[1 if c.mech else 0][0, 0] = 10.0 * i_lim
    elif pol.kernel == "eesm_policy_record":
        # omega (under a dynamic load) to 100 rad/s, i_sd, i_sq and i_e to
        # half their limits, the angle in [0, 2 pi)
        i_lim, ie_lim = 1.0 / c.f["inv_i_lim"], 1.0 / c.f["inv_ie_lim"]
        bounds = ([(0.0, 100.0)] if c.mech else []) + [(-0.5 * i_lim, 0.5 * i_lim)] * 2 + [
            (-0.5 * ie_lim, 0.5 * ie_lim), (0.0, 2 * np.pi)]
        start = [rng.uniform(lo, hi, (R, 128)).astype(np.float32) for lo, hi in bounds]
        start[1 if c.mech else 0][0, 0] = 10.0 * i_lim
    elif pol.kernel == "srm_policy_record":
        # omega (under a dynamic load) to 100 rad/s, the phase currents in
        # [0, 22) A against the 20 A limit, the angle in [0, 2 pi); env 0's
        # three phases at ten times the limit (a saturating phase that its
        # command drives down can fall below the limit in one step)
        assert c.sat == (psi_s is not None)
        i_lim = 1.0 / c.f["inv_ilim"]
        bounds = ([(0.0, 100.0)] if c.mech else []) + [(0.0, 22.0)] * 3 + [(0.0, 2 * np.pi)]
        start = [rng.uniform(lo, hi, (R, 128)).astype(np.float32) for lo, hi in bounds]
        for j in range(3):
            start[j + c.mech][0, 0] = 10.0 * i_lim
    elif pol.kernel in ("dfim_policy_record", "induction_policy_record"):
        # omega (under a dynamic load) to 100 rad/s, the stator currents to
        # half their limit, the rotor fluxes to half of l_m times it and, on
        # the DFIM, the angle in [0, 2 pi)
        i_lim = 1.0 / np.sqrt(c.f["inv_ilim2"])
        psi_lim = c.f["l_m"] * i_lim
        bounds = ([(0.0, 100.0)] if c.mech else []) + [(-0.5 * i_lim, 0.5 * i_lim)] * 2 + [
            (-0.5 * psi_lim, 0.5 * psi_lim)] * 2 + (
            [(0.0, 2 * np.pi)] if pol.kernel == "dfim_policy_record" else [])
        start = [rng.uniform(lo, hi, (R, 128)).astype(np.float32) for lo, hi in bounds]
        start[1 if c.mech else 0][0, 0] = 10.0 * i_lim
    else:
        # omega (under a dynamic load) to 100 rad/s, the currents to their limits
        lims = ([100.0] if c.mech else []) + [c.f["lim0"], c.f["lim1"]]
        start = [rng.uniform(-lim, lim, (R, 128)).astype(np.float32)
                 for lim in lims[:c.n_state]]
        start[1 if c.mech else 0][0, 0] = 10.0 * c.f["lim0"]
    start = [torch.as_tensor(x, device=dev) for x in start]
    fp.reset_launches()
    for T in (1, 2, 64):
        got = fp._policy_design_launch(pol, 3, *w, ls, start, T, n)
        want = fp._policy_design_launch(pol, 3, *w, ls, start, T, n, one_thread=True)
        torch.cuda.synchronize()
        for name, g, x in zip(roll.signals, got, want):
            assert g.shape == x.shape == (T, n) and g.dtype == x.dtype, (T, name)
            same = (g == x) | (torch.isnan(g) & torch.isnan(x))
            assert bool(same.all()), f"T={T}: {name} differs in {int((~same).sum())}"
        assert float(got[-1][0, 0]) == 1.0  # env 0 reset at its first step
    assert not any(fp.LAUNCHES.values())  # the design entry is not the counted path


@pytest.mark.cuda
@pytest.mark.parametrize("env_id,joint,hidden,n", DC_POLICY_BIT_CASES,
                         ids=[f"{i}{'-joint' if j else ''}-H{h}-n{n}"
                              for i, j, h, n in DC_POLICY_BIT_CASES])
def test_cuda_dc_policy_record_equals_one_thread_design_bit_for_bit(env_id, joint, hidden, n):
    """dc_policy_record (eight lanes of a warp an env, every lane stepping,
    four lanes with lane 0 stepping, or one thread per env):
    _hold_policy_designs_bit_for_bit."""
    _hold_policy_designs_bit_for_bit(env_id, joint, hidden, n)


@pytest.mark.cuda
@pytest.mark.parametrize("env_id,hidden,n", SYNC_POLICY_BIT_CASES,
                         ids=[f"{i}-H{h}-n{n}" for i, h, n in SYNC_POLICY_BIT_CASES])
def test_cuda_sync_policy_record_equals_one_thread_design_bit_for_bit(env_id, hidden, n):
    """sync_policy_record (its wide and narrow lane designs, or one thread
    per env, csrc/fused_sync_policy.cu): _hold_policy_designs_bit_for_bit,
    with the constant-speed rotation (the CC ids) and cos and sin of the
    angle (Cont-SC-PMSM) in the observation."""
    _hold_policy_designs_bit_for_bit(env_id, False, hidden, n)


@pytest.mark.cuda
@pytest.mark.parametrize("env_id,joint,hidden,n", EESM_POLICY_BIT_CASES,
                         ids=[f"{i}{'-joint' if j else ''}-H{h}-n{n}"
                              for i, j, h, n in EESM_POLICY_BIT_CASES])
def test_cuda_eesm_policy_record_equals_one_thread_design_bit_for_bit(env_id, joint, hidden, n):
    """eesm_policy_record (its wide and narrow lane designs, or one thread
    per env, csrc/fused_eesm_policy.cu): _hold_policy_designs_bit_for_bit,
    with the constant-speed rotation and three reference rows (Finite-CC),
    the 32-way joint head, and the four Gaussian channels under the speed
    ODE (Cont-SC)."""
    _hold_policy_designs_bit_for_bit(env_id, joint, hidden, n)


@pytest.mark.cuda
@pytest.mark.parametrize("env_id,joint,psi_s,hidden,n", SRM_POLICY_BIT_CASES,
                         ids=[f"{i}{'-joint' if j else ''}{'-sat' if p else ''}-H{h}-n{n}"
                              for i, j, p, h, n in SRM_POLICY_BIT_CASES])
def test_cuda_srm_policy_record_equals_one_thread_design_bit_for_bit(env_id, joint, psi_s,
                                                                     hidden, n):
    """srm_policy_record (its wide and narrow lane designs, or one thread per
    env, csrc/fused_srm_policy.cu): _hold_policy_designs_bit_for_bit, with
    three reference rows (Finite-CC) and the 27-way joint head, the three
    Gaussian channels under the speed ODE (Cont-SC), and the saturating
    torque in the observation and the reward (Finite-TC, psi_s 1.2)."""
    _hold_policy_designs_bit_for_bit(env_id, joint, hidden, n, psi_s)


@pytest.mark.cuda
@pytest.mark.parametrize("env_id,joint,hidden,n", DFIM_POLICY_BIT_CASES,
                         ids=[f"{i}{'-joint' if j else ''}-H{h}-n{n}"
                              for i, j, h, n in DFIM_POLICY_BIT_CASES])
def test_cuda_dfim_policy_record_equals_one_thread_design_bit_for_bit(env_id, joint, hidden, n):
    """dfim_policy_record (its wide and narrow lane designs, or one thread
    per env, csrc/fused_dfim_policy.cu): _hold_policy_designs_bit_for_bit,
    with the constant-speed rotation and the pre-step flux direction
    (Finite-CC), the 64-way joint head sampled across the lanes, and the six
    Gaussian channels under the speed ODE (Cont-SC)."""
    _hold_policy_designs_bit_for_bit(env_id, joint, hidden, n)


@pytest.mark.cuda
@pytest.mark.parametrize("env_id,hidden,n", INDUCTION_POLICY_BIT_CASES,
                         ids=[f"{i}-H{h}-n{n}" for i, h, n in INDUCTION_POLICY_BIT_CASES])
def test_cuda_induction_policy_record_equals_one_thread_design_bit_for_bit(env_id, hidden, n):
    """induction_policy_record (its wide and narrow lane designs, or one
    thread per env, csrc/fused_induction_policy.cu):
    _hold_policy_designs_bit_for_bit, with the pre-step flux direction on
    the dq ids (Finite-CC, Cont-CC) and the three Gaussian channels under
    the speed ODE (Cont-SC)."""
    _hold_policy_designs_bit_for_bit(env_id, False, hidden, n)


SRM_RECORD_CASES = [(i, None) for i in gt.SRM_ENV_IDS] + [("Finite-TC-SRM-v0", 1.2),
                                                          ("Cont-SC-SRM-v0", 1.2)]


@pytest.mark.cuda
@pytest.mark.parametrize("env_id,psi_s", SRM_RECORD_CASES,
                         ids=[f"{i}{'-sat' if p else ''}" for i, p in SRM_RECORD_CASES])
def test_cuda_srm_record_random_equals_plain_version_bit_for_bit(env_id, psi_s):
    """srm_record_random (producer and consumer warps over a ring on the
    continuous ids with the catalog's Wiener references, one thread per env
    on the finite ids, csrc/fused_srm_record.cu) equals srm_record_random_plain
    bit for bit in every env and every output (NaN where the plain version
    has NaN), linear and saturating, at 37 steps (no multiple of the ring's
    K) and at 1 and 2, on one plane of 128 envs and on a partial block of 37
    envs (the planes' first 37).  Env 5 starts with only phase b above the
    20 A limit: its first step violates and draws the reset candidates."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels are CUDA C++ without a CPU mode")
    from gym_electric_motor_tpu_torch.ops import fused_srm_family as srf

    dev = torch.device("cuda")
    kw = {"motor": {"motor_parameter": {"psi_s": psi_s}}} if psi_s else {}
    c = srf.SrmConsts(gt.make_functional(env_id, device=dev, **kw))
    assert c.sat == (psi_s is not None) and not c.all_const
    assert srf.srm_record_ring_layout(c)["design"] == (
        "one thread per env" if c.finite else "warp-specialised")
    K, _P = srf.SRM_RECORD_RING
    rng = np.random.default_rng(23)
    bounds = ([(0, 100)] if c.mech else []) + [(0, 19)] * 3 + [(-np.pi, np.pi)]
    start = [rng.uniform(lo, hi, (1, 128)).astype(np.float32) for lo, hi in bounds]
    start[-3][0, 5] = 25.0  # i_b
    start = [torch.as_tensor(x, device=dev) for x in start]
    srf.reset_launches()
    for T in (37, 1, 2):
        assert T % K or T < K
        got = srf.srm_record_random(c, 7, start, T)
        part = srf._record_random_launch(c, 7, start, T, 37)
        torch.cuda.synchronize()
        want = srf.srm_record_random_plain(c, 7, start, T)
        for j, (g, p, w) in enumerate(zip(got, part, want)):
            assert g.shape == w.shape and g.dtype == w.dtype, (T, j)
            w2 = w.reshape(T, 128)[:, :37]
            assert p.shape == w2.shape and p.dtype == w2.dtype, (T, j)
            for x, y in ((g, w), (p, w2)):
                same = (x == y) | (torch.isnan(x) & torch.isnan(y))
                assert bool(same.all()), f"T={T}: output {j} differs in {int((~same).sum())}"
        assert float(got[-1][0, 0, 5]) == 1.0  # env 5 reset at its first step
    assert {k: v for k, v in srf.LAUNCHES.items() if v} == {"srm_record_random": 3}


# the universal DC and EESM random recorders: every built DC random
# instance (<FINITE, MECH, MC, NREF>: PermExDc and ShuntDc on CC and SC,
# ExtExDc on CC with its two rows, TC and SC, finite and continuous) and
# the six EESM ids, each with its Wiener references and with constant ones
DC_RECORD_IDS = [f"{conv}-{task}-{motor}-v0" for motor, tasks in (
    ("PermExDc", ("CC", "SC")), ("ShuntDc", ("CC", "SC")), ("ExtExDc", ("CC", "TC", "SC")))
    for conv in ("Finite", "Cont") for task in tasks]
DC_RECORD_CASES = [(i, r) for i in DC_RECORD_IDS for r in ("wiener", "const")]
EESM_RECORD_CASES = [(i, "wiener") for i in gt.EESM_ENV_IDS] + [("Finite-CC-EESM-v0", "const")]


def _record_case(family, env_id, refs, dev):
    """The family module, its constants for ``env_id`` (constant references
    DC_EESM_CONST_REFS, or SCIM_CONST_REFS for the sync, SCIM and DFIM
    families, with ``refs`` "const") and one plane of 128 start states:
    currents inside their limits (the SCIM's as chip_smoke.run_induction's
    planes: within 6 A against a 5.5 A limit, fluxes within 0.5 Wb; the
    DFIM's as chip_smoke.run_dfim's: within 10 A against a 9 A limit,
    fluxes within 1.5 Wb), the speed under a dynamic load in [0, 100),
    angles in [0, 2 pi), env 5's first current at five times its limit."""
    from gym_electric_motor_tpu_torch import references as rg
    from gym_electric_motor_tpu_torch.ops import fused_dc_family as dcf
    from gym_electric_motor_tpu_torch.ops import fused_dfim_family as dff
    from gym_electric_motor_tpu_torch.ops import fused_eesm_family as ef
    from gym_electric_motor_tpu_torch.ops import fused_induction_family as indf
    from gym_electric_motor_tpu_torch.ops import fused_sync_family as sf

    _conv, task, motor, _v = env_id.split("-")
    kw = {}
    if refs == "const":
        const = (DC_EESM_CONST_REFS if family in ("dc", "eesm") else SCIM_CONST_REFS)[task]
        const = const[motor] if isinstance(const, dict) else const
        kw["reference_generator"] = rg.ReferenceSpec([rg.ConstReference(n, v) for n, v in const])
    env = gt.make_functional(env_id, device=dev, **kw)
    mod, consts = {"dc": (dcf, dcf.DcConsts), "eesm": (ef, ef.EesmConsts),
                   "sync": (sf, sf.SyncConsts),
                   "induction": (indf, indf.InductionConsts),
                   "dfim": (dff, dff.DfimConsts)}[family]
    c = consts(env)
    assert c.all_const == (refs == "const")
    rng = np.random.default_rng(29)
    if family == "sync":
        i_lim = 1.0 / c.f["inv_i_lim"]
        start = ([rng.uniform(0, 100, (1, 128))] if c.mech else []) + [
            rng.uniform(-0.5 * i_lim, 0.5 * i_lim, (1, 128)),
            rng.uniform(-0.5 * i_lim, 0.5 * i_lim, (1, 128)),
            rng.uniform(0, 2 * np.pi, (1, 128))]
        start[-3][0, 5] = 5.0 * i_lim  # i_sd
    elif family == "induction":
        i_lim = float(c.f["inv_ilim2"]) ** -0.5
        bounds = ([(0, 100)] if c.mech else []) + [(-6, 6)] * 2 + [(-0.5, 0.5)] * 2
        start = [rng.uniform(lo, hi, (1, 128)) for lo, hi in bounds]
        start[-4][0, 5] = 5.0 * i_lim  # i_salpha
    elif family == "dfim":
        i_lim = float(c.f["inv_ilim2"]) ** -0.5
        bounds = (([(0, 100)] if c.mech else []) + [(-10, 10)] * 2 + [(-1.5, 1.5)] * 2
                  + [(0, 2 * np.pi)])
        start = [rng.uniform(lo, hi, (1, 128)) for lo, hi in bounds]
        start[-5][0, 5] = 5.0 * i_lim  # i_salpha
    elif family == "dc":
        lims = [c.f["lim0"], c.f["lim1"]][:c.n_el]
        start = ([rng.uniform(0, 100, (1, 128))] if c.mech else []) + [
            rng.uniform(-0.5 * lim, 0.5 * lim, (1, 128)) for lim in lims]
        start[-c.n_el][0, 5] = 5.0 * lims[0]
    else:
        i_lim, ie_lim = 1.0 / c.f["inv_i_lim"], 1.0 / c.f["inv_ie_lim"]
        start = ([rng.uniform(0, 100, (1, 128))] if c.mech else []) + [
            rng.uniform(-0.4 * i_lim, 0.4 * i_lim, (1, 128)),
            rng.uniform(-0.4 * i_lim, 0.4 * i_lim, (1, 128)),
            rng.uniform(-0.5 * ie_lim, 0.5 * ie_lim, (1, 128)),
            rng.uniform(0, 2 * np.pi, (1, 128))]
        start[-4][0, 5] = 5.0 * i_lim  # i_sd
    return mod, c, [torch.as_tensor(x.astype(np.float32), device=dev) for x in start]


def _hold_record_bit_for_bit(family, env_id, refs):
    """The random recorder of ``family`` on ``env_id`` against its plain
    version, bit for bit in every plane, env and step (NaN where the plain
    version has NaN), at 1, 2, 9 and 37 steps (the ring stops in every
    place of a slot of four or eight steps), on one plane of 128 envs and on
    a partial block of 37 envs (the planes' first 37); the launch takes the
    design the ring layout names, and each call counts one launch.  Env 5
    starts at five times its current limit: its first step violates and
    draws the reset candidates."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels are CUDA C++ without a CPU mode")
    dev = torch.device("cuda")
    mod, c, start = _record_case(family, env_id, refs, dev)
    name = f"{family}_record_random"
    lay = getattr(mod, f"{family}_record_ring_layout")(c)
    assert lay["design"] == ("one thread per env" if refs == "const" else "warp-specialised")
    mod.reset_launches()
    for T in (37, 1, 2, 9):
        got = getattr(mod, name)(c, 7, start, T)
        part = mod._record_random_launch(c, 7, start, T, 37)
        torch.cuda.synchronize()
        want = getattr(mod, name + "_plain")(c, 7, start, T)
        for j, (g, p, w) in enumerate(zip(got, part, want)):
            assert g.shape == w.shape and g.dtype == w.dtype, (T, j)
            w2 = w.reshape(T, 128)[:, :37]
            assert p.shape == w2.shape and p.dtype == w2.dtype, (T, j)
            for x, y in ((g, w), (p, w2)):
                same = (x == y) | (torch.isnan(x) & torch.isnan(y))
                assert bool(same.all()), f"T={T}: output {j} differs in {int((~same).sum())}"
        assert float(got[-1][0, 0, 5]) == 1.0  # env 5 reset at its first step
    assert {k: v for k, v in mod.LAUNCHES.items() if v} == {name: 4}


@pytest.mark.cuda
@pytest.mark.parametrize("env_id,refs", DC_RECORD_CASES,
                         ids=[f"{i}-{r}" for i, r in DC_RECORD_CASES])
def test_cuda_dc_record_random_equals_plain_version_bit_for_bit(env_id, refs):
    """dc_record_random (producer and consumer warps over a ring with Wiener
    references, one thread per env with constant ones,
    csrc/fused_dc_record.cu) on every built random instance:
    _hold_record_bit_for_bit."""
    _hold_record_bit_for_bit("dc", env_id, refs)


@pytest.mark.cuda
@pytest.mark.parametrize("env_id,refs", EESM_RECORD_CASES,
                         ids=[f"{i}-{r}" for i, r in EESM_RECORD_CASES])
def test_cuda_eesm_record_random_equals_plain_version_bit_for_bit(env_id, refs):
    """eesm_record_random (producer and consumer warps over a ring with
    Wiener references, one thread per env with constant ones,
    csrc/fused_eesm_record.cu) on the six EESM ids, and with constant
    references on Finite-CC-EESM: _hold_record_bit_for_bit."""
    _hold_record_bit_for_bit("eesm", env_id, refs)


# the universal sync and SCIM random recorders: every id of both families
# with its Wiener references, and one finite CC id with constant ones
SYNC_RECORD_CASES = [(i, "wiener") for i in gt.SYNC_ENV_IDS] + [("Finite-CC-PMSM-v0", "const")]
IND_RECORD_CASES = [(i, "wiener") for i in gt.SCIM_ENV_IDS] + [("Finite-CC-SCIM-v0", "const")]


@pytest.mark.cuda
@pytest.mark.parametrize("env_id,refs", SYNC_RECORD_CASES,
                         ids=[f"{i}-{r}" for i, r in SYNC_RECORD_CASES])
def test_cuda_sync_record_random_equals_plain_version_bit_for_bit(env_id, refs):
    """sync_record_random (producer and consumer warps over a ring with
    Wiener references, one thread per env with constant ones,
    csrc/fused_sync.cu) on the twelve sync ids, and with constant
    references on Finite-CC-PMSM: _hold_record_bit_for_bit."""
    _hold_record_bit_for_bit("sync", env_id, refs)


@pytest.mark.cuda
@pytest.mark.parametrize("env_id,refs", IND_RECORD_CASES,
                         ids=[f"{i}-{r}" for i, r in IND_RECORD_CASES])
def test_cuda_induction_record_random_equals_plain_version_bit_for_bit(env_id, refs):
    """induction_record_random (producer and consumer warps over a ring
    with Wiener references, one thread per env with constant ones,
    csrc/fused_induction_record.cu) on the six SCIM ids, and with constant
    references on Finite-CC-SCIM: _hold_record_bit_for_bit."""
    _hold_record_bit_for_bit("induction", env_id, refs)


# the universal DFIM random recorder: the six DFIM ids with their Wiener
# references, and Finite-CC-DFIM with constant ones
DFIM_RECORD_CASES = [(i, "wiener") for i in gt.DFIM_ENV_IDS] + [("Finite-CC-DFIM-v0", "const")]


@pytest.mark.cuda
@pytest.mark.parametrize("env_id,refs", DFIM_RECORD_CASES,
                         ids=[f"{i}-{r}" for i, r in DFIM_RECORD_CASES])
def test_cuda_dfim_record_random_equals_plain_version_bit_for_bit(env_id, refs):
    """dfim_record_random (producer and consumer warps over a ring with
    Wiener references, one thread per env with constant ones,
    csrc/fused_dfim_record.cu) on the six DFIM ids, and with constant
    references on Finite-CC-DFIM: _hold_record_bit_for_bit."""
    _hold_record_bit_for_bit("dfim", env_id, refs)
