"""The universal policy recorder's surface on all 60 catalog ids against the
JAX package's (``ops/pallas_policy.py``), and fused PPO through it.

* The surface: ``policy_obs_dim``, ``policy_act_ns``, ``policy_n_cont``, the
  recorder's signals, names, observation spec, head sizes (joint too) and
  duty ranges equal JAX's exactly; the recorded signals' dtypes are JAX's
  (float32, int32 actions of a finite id).
* ``policy_obs_host`` on one recording (the port's plain recorder, 128 envs
  x 8 steps, H 8) rebuilds the observation that JAX's function rebuilds
  from the same planes, within 1e-5.
* ``make_fused_ppo_trainer(env, kernel='auto')`` builds and trains on
  every id at its defaults (two iterations at 128 envs x 8 steps, H 8):
  finite rewards, moved parameters, the universal recorder's planes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_electric_motor_tpu as gemx
from gym_electric_motor_tpu.ops import pallas_policy as jp
import gym_electric_motor_tpu_torch as gt
from gym_electric_motor_tpu_torch.ops import fused_policy as fp
from gym_electric_motor_tpu_torch.parallel import init_actor_critic_params, make_fused_ppo_trainer

torch.set_num_threads(1)

N, T, H = 128, 8, 8
MULTI_HEAD = ("Finite-CC-ExtExDc-v0", "Finite-SC-ExtExDc-v0", "Finite-CC-EESM-v0",
              "Finite-TC-DFIM-v0", "Finite-CC-SRM-v0")


@pytest.mark.parametrize("env_id", gt.ENV_IDS)
def test_surface_matches_jax(env_id):
    jenv = gemx.make_functional(env_id)
    tenv = gt.make_functional(env_id, device="cpu")
    assert fp.policy_obs_dim(tenv) == jp.policy_obs_dim(jenv)
    assert fp.policy_act_ns(tenv) == jp.policy_act_ns(jenv)
    assert fp.policy_n_cont(tenv) == jp.policy_n_cont(jenv)
    jroll = jp.make_fused_policy_record_universal(jenv, T, N, hidden=H, interpret=True)
    troll = fp.make_fused_policy_record_universal(tenv, T, N, hidden=H)
    for attr in ("signals", "state_names", "ref_names", "act_names", "act_ns", "n_out",
                 "cont", "obs_dim", "n_state", "joint_heads"):
        assert getattr(troll, attr) == getattr(jroll, attr), attr
    assert tuple(troll.obs_spec) == tuple(jroll.obs_spec)
    if troll.cont:
        for x, y in zip(troll.act_range, jroll.act_range):
            assert x.dtype == y.dtype and np.array_equal(x, y)
    else:
        assert troll.act_range is None is jroll.act_range
    if env_id in MULTI_HEAD:
        jj = jp.make_fused_policy_record_universal(jenv, T, N, hidden=H, interpret=True,
                                                   joint_heads=True)
        tj = fp.make_fused_policy_record_universal(tenv, T, N, hidden=H, joint_heads=True)
        assert tj.n_out == jj.n_out and tj.joint_heads
    act = torch.float32 if troll.cont else torch.int32
    assert troll.policy.dtypes == ((torch.float32,) * (troll.n_state + len(troll.ref_names))
                                   + (act,) * len(troll.act_names) + (torch.float32,) * 2)


def _record(tenv):
    roll = fp.make_fused_policy_record_universal(tenv, T, N, hidden=H)
    rng = np.random.default_rng(1)
    w = [torch.as_tensor(rng.normal(0, 0.5, n).astype(np.float32))
         for n in (roll.obs_dim * H, H, H * roll.n_out, roll.n_out)]
    extra = (torch.full((len(roll.act_names),), -0.5),) if roll.cont else ()
    planes = fp.fused_policy_init_planes(tenv, N, device="cpu")
    out = roll(5, *w, *extra, *planes)
    for name, dt in zip(roll.signals, roll.policy.dtypes):
        assert out[name].dtype == dt and out[name].shape == (T, N // 128, 128)
        assert bool(torch.isfinite(out[name].double()).all())
    return roll, planes, out


@pytest.mark.parametrize("env_id", gt.ENV_IDS)
def test_policy_obs_host_matches_jax(env_id):
    jenv = gemx.make_functional(env_id)
    tenv = gt.make_functional(env_id, device="cpu")
    roll, planes, out = _record(tenv)
    jroll = jp.make_fused_policy_record_universal(jenv, T, N, hidden=H, interpret=True)
    prev = {nm: torch.cat([planes[i].reshape(1, N), out[nm].reshape(T, N)[:-1]])
            for i, nm in enumerate(roll.state_names)}
    refs = {nm: out[nm].reshape(T, N) for nm in roll.ref_names}
    got = fp.policy_obs_host(roll, prev, refs)
    want = jp.policy_obs_host(jroll, {k: jnp.asarray(v.numpy()) for k, v in prev.items()},
                              {k: jnp.asarray(v.numpy()) for k, v in refs.items()})
    assert got.shape == (T, N, roll.obs_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("env_id", gt.ENV_IDS)
def test_fused_ppo_auto_trains_on_every_id(env_id):
    tenv = gt.make_functional(env_id, device="cpu")
    init_opt, train = make_fused_ppo_trainer(tenv, hidden=H, horizon=T, n_envs=N,
                                             n_minibatches=2, n_epochs=1, lr=1e-3)
    pol = train.roll.policy
    n_cont = fp.policy_n_cont(tenv)
    assert pol.cont == bool(n_cont)
    model = init_actor_critic_params(1, pol.obs_dim, pol.n_out, H, device="cpu", n_cont=n_cont)
    p0 = {k: v.detach().clone() for k, v in model.named_parameters()}
    planes = fp.fused_policy_init_planes(tenv, N, device="cpu")
    model, _opt, planes, rs = train(model, init_opt(model), planes, 3, 2)
    assert rs.shape == (2,) and bool(torch.isfinite(rs).all())
    assert len(planes) == pol.consts.n_state
    assert all(bool(torch.isfinite(x).all()) for x in planes)
    assert ("ls" in p0) == bool(n_cont)
    for k, v in model.named_parameters():
        assert not torch.equal(v.detach(), p0[k]), k


def test_options_raise():
    """randomize= raises naming queue 2, item 8 (the builder, the initial
    planes); joint heads need a multi-head finite id; the kernels take 1 to
    32 hidden units; the weights and log-stds are checked."""
    tenv = gt.make_functional("Finite-CC-EESM-v0", device="cpu")
    with pytest.raises(NotImplementedError, match="item 8"):
        fp.make_fused_policy_record_universal(tenv, T, N, randomize=("r_s",))
    with pytest.raises(NotImplementedError, match="item 8"):
        fp.fused_policy_init_planes(tenv, N, randomize=("r_s",))
    for eid in ("Finite-CC-PMSM-v0", "Cont-CC-EESM-v0"):
        with pytest.raises(ValueError, match="joint_heads"):
            fp.make_fused_policy_record_universal(gt.make_functional(eid, device="cpu"), T, N,
                                                  joint_heads=True)
    with pytest.raises(ValueError, match="hidden"):
        fp.make_fused_policy_record_universal(tenv, T, N, hidden=33)
    with pytest.raises(ValueError, match="multiple"):
        fp.make_fused_policy_record_universal(tenv, T, 100)
    roll = fp.make_fused_policy_record_universal(tenv, T, N, hidden=H)
    planes = fp.fused_policy_init_planes(tenv, N, device="cpu")
    w = [torch.zeros(n) for n in (roll.obs_dim * H, H, H * roll.n_out, roll.n_out)]
    with pytest.raises(ValueError, match="w2"):
        roll(1, w[0], w[1], torch.zeros(H * roll.n_out + 1), w[3], *planes)
    cont = gt.make_functional("Cont-CC-EESM-v0", device="cpu")
    croll = fp.make_fused_policy_record_universal(cont, T, N, hidden=H)
    wc = [torch.zeros(n) for n in (croll.obs_dim * H, H, H * croll.n_out, croll.n_out)]
    with pytest.raises(ValueError, match="ls"):
        croll(1, *wc, torch.zeros(3), *fp.fused_policy_init_planes(cont, N, device="cpu"))


@pytest.mark.parametrize("n,sms,want", [(1, 132, (8, False)), (2048, 132, (8, False)),
                                        (2051, 132, (4, True)), (4096, 132, (4, True)),
                                        (12288, 132, (4, True)), (16384, 132, (1, False)),
                                        (2048, 114, (4, True))])
def test_dc_policy_width_rule_mirrors_the_kernels(n, sms, want):
    """policy_universal_lanes, computed without the library, is the width
    rule of csrc/policy_heads_lanes.cuh (policy_width) over
    csrc/fused_dc_policy.cu's designs: the wide design (WideDesign, eight
    lanes an env, every lane stepping) while the one-thread launch's blocks
    of 128 envs times its lanes fit the SMs once (PPO's 2048 envs on an
    H100's 132), the narrow design (NarrowDesign, four lanes, lane 0
    stepping) while they fit three times, else one thread per env; every
    family's recorder has lane designs of its own."""
    assert fp.policy_universal_lanes("dc_policy_record", n, sms) == want
    assert sorted(fp.POLICY_LANE_DESIGNS) == sorted(fp.UNIVERSAL_KERNELS)
    _hold_width_rule_source("fused_dc_policy.cu", fp.DC_POLICY_WIDE, fp.DC_POLICY_NARROW)
    assert fp.POLICY_LANE_DESIGNS["dc_policy_record"] == (fp.DC_POLICY_WIDE, fp.DC_POLICY_NARROW)


def _hold_width_rule_source(name, wide, narrow):
    """The designs a family's source names (the Python mirror ``wide``,
    ``narrow``), its launch and layout over the shared width rule, and the
    rule itself in csrc/policy_heads_lanes.cuh."""
    from pathlib import Path

    csrc = Path(fp.__file__).resolve().parent.parent / "csrc"
    source = (csrc / name).read_text()
    (gw, lw), (gn, ln) = wide, narrow
    assert f"using WideDesign = LaneDesign<{gw}, {str(lw).lower()}>;" in source
    assert f"using NarrowDesign = LaneDesign<{gn}, {str(ln).lower()}>;" in source
    assert "design == 1 ? kPolicyOneThread : policy_width<WideDesign, NarrowDesign>(n);" in source
    assert "  policy_layout<WideDesign, NarrowDesign>(n, out);" in source
    header = (csrc / "policy_heads_lanes.cuh").read_text()
    assert "  if ((long long)policy_blocks(n) * Wide::G <= sms) return kPolicyWide;" in header
    assert ("  if ((long long)policy_blocks(n) * Narrow::G <= 3 * sms) return kPolicyNarrow;"
            in header)
    assert ("inline int policy_blocks(int n) { return (n + kPolicyThreads - 1) / kPolicyThreads; }"
            in header)


def _hold_width_rule(kernel, wide, narrow, n, sms, per_sm):
    """policy_universal_lanes at n envs on sms SMs against the rule over the
    pair (wide, narrow): the wide design while the one-thread launch's
    blocks times its lanes fit the SMs once (per_sm 1), the narrow one while
    they fit three times (per_sm 3), else one thread per env (None)."""
    (gw, lw), (gn, ln) = wide, narrow
    blocks = -(-n // 128)
    got = fp.policy_universal_lanes(kernel, n, sms)
    if per_sm is None:
        assert got == (1, False) and blocks * gn > 3 * sms
    elif blocks * gw <= sms:
        assert got == (gw, lw) and per_sm == 1
    else:
        assert got == (gn, ln) and per_sm == 3 and blocks * gn <= 3 * sms


SYNC_WIDTH_CASES = [(1, 132, 1), (2048, 132, 1), (2049, 132, 3), (4096, 132, 3),
                    (6272, 132, 3), (13312, 132, None), (16384, 132, None), (2048, 114, 3)]


@pytest.mark.parametrize("n,sms,per_sm", SYNC_WIDTH_CASES)
def test_sync_policy_width_rule_mirrors_the_kernels(n, sms, per_sm):
    """sync_policy_record takes the width rule of csrc/policy_heads_lanes.cuh
    over csrc/fused_sync_policy.cu's own designs (SYNC_POLICY_WIDE, _NARROW):
    the wide design while the one-thread launch's blocks times its lanes fit
    the SMs once (PPO's 2048 envs on an H100's 132: one block an SM at
    most), the narrow one while they fit three times (per_sm 3), else one
    thread per env (per_sm None; 16384 envs, the bench width)."""
    _hold_width_rule("sync_policy_record", fp.SYNC_POLICY_WIDE, fp.SYNC_POLICY_NARROW, n, sms,
                     per_sm)
    _hold_width_rule_source("fused_sync_policy.cu", fp.SYNC_POLICY_WIDE, fp.SYNC_POLICY_NARROW)
    assert fp.POLICY_LANE_DESIGNS["sync_policy_record"] == (fp.SYNC_POLICY_WIDE,
                                                            fp.SYNC_POLICY_NARROW)


@pytest.mark.parametrize("n,sms,per_sm", SYNC_WIDTH_CASES)
def test_eesm_policy_width_rule_mirrors_the_kernels(n, sms, per_sm):
    """eesm_policy_record takes the width rule of csrc/policy_heads_lanes.cuh
    over csrc/fused_eesm_policy.cu's own designs (EESM_POLICY_WIDE,
    _NARROW), as the synchronous recorder does over its own: the wide
    design at PPO's 2048 envs on an H100's 132 SMs, one thread per env at
    the bench's 16384."""
    _hold_width_rule("eesm_policy_record", fp.EESM_POLICY_WIDE, fp.EESM_POLICY_NARROW, n, sms,
                     per_sm)
    _hold_width_rule_source("fused_eesm_policy.cu", fp.EESM_POLICY_WIDE, fp.EESM_POLICY_NARROW)
    assert fp.POLICY_LANE_DESIGNS["eesm_policy_record"] == (fp.EESM_POLICY_WIDE,
                                                            fp.EESM_POLICY_NARROW)


@pytest.mark.parametrize("n,sms,per_sm", SYNC_WIDTH_CASES)
def test_srm_policy_width_rule_mirrors_the_kernels(n, sms, per_sm):
    """srm_policy_record takes the width rule of csrc/policy_heads_lanes.cuh
    over csrc/fused_srm_policy.cu's own designs (SRM_POLICY_WIDE, _NARROW),
    as the synchronous recorder does over its own."""
    _hold_width_rule("srm_policy_record", fp.SRM_POLICY_WIDE, fp.SRM_POLICY_NARROW, n, sms,
                     per_sm)
    _hold_width_rule_source("fused_srm_policy.cu", fp.SRM_POLICY_WIDE, fp.SRM_POLICY_NARROW)
    assert fp.POLICY_LANE_DESIGNS["srm_policy_record"] == (fp.SRM_POLICY_WIDE,
                                                           fp.SRM_POLICY_NARROW)


@pytest.mark.parametrize("n,sms,per_sm", SYNC_WIDTH_CASES)
def test_dfim_policy_width_rule_mirrors_the_kernels(n, sms, per_sm):
    """dfim_policy_record takes the width rule of csrc/policy_heads_lanes.cuh
    over csrc/fused_dfim_policy.cu's own designs (DFIM_POLICY_WIDE,
    _NARROW), for its factorised and its joint heads alike, as the
    synchronous recorder does over its own: the wide design at PPO's 2048
    envs on an H100's 132 SMs, one thread per env at the bench's 16384."""
    _hold_width_rule("dfim_policy_record", fp.DFIM_POLICY_WIDE, fp.DFIM_POLICY_NARROW, n, sms,
                     per_sm)
    _hold_width_rule_source("fused_dfim_policy.cu", fp.DFIM_POLICY_WIDE, fp.DFIM_POLICY_NARROW)
    assert fp.POLICY_LANE_DESIGNS["dfim_policy_record"] == (fp.DFIM_POLICY_WIDE,
                                                            fp.DFIM_POLICY_NARROW)


@pytest.mark.parametrize("n,sms,per_sm", SYNC_WIDTH_CASES)
def test_induction_policy_width_rule_mirrors_the_kernels(n, sms, per_sm):
    """induction_policy_record takes the width rule of
    csrc/policy_heads_lanes.cuh over csrc/fused_induction_policy.cu's own
    designs (INDUCTION_POLICY_WIDE, _NARROW), as the synchronous recorder
    does over its own."""
    _hold_width_rule("induction_policy_record", fp.INDUCTION_POLICY_WIDE,
                     fp.INDUCTION_POLICY_NARROW, n, sms, per_sm)
    _hold_width_rule_source("fused_induction_policy.cu", fp.INDUCTION_POLICY_WIDE,
                            fp.INDUCTION_POLICY_NARROW)
    assert fp.POLICY_LANE_DESIGNS["induction_policy_record"] == (fp.INDUCTION_POLICY_WIDE,
                                                                 fp.INDUCTION_POLICY_NARROW)
