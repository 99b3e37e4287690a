#!/usr/bin/env python3
"""Time this checkout's random rollouts against another checkout's, in one
process on one card, and check that both give the same bits.

Run on a machine with an NVIDIA GPU and the CUDA toolkit, from the root of
a checkout, with another checkout unpacked beside it (for example the
parent commit: ``git archive <commit> | tar -x -C _checkout/parent``):

    python3 tools/rollout_ab.py _checkout/parent [path ...]

A path is ``family:env_id[:const]`` for a universal random rollout,
``policy:<sample>:<refs>:<H>`` for the policy evaluation rollout
(``policy_rollout`` on Finite-CC-PMSM-v0: sample ``categorical`` or
``greedy``, refs ``wiener`` or ``const``, H 8, 16 or 32),
``dc_sc:<env_id>`` for the specialised Cont-SC DC rollout
(``dc_sc_rollout_random`` on Cont-SC-SeriesDc-v0 or Cont-SC-ShuntDc-v0),
``eesm_cc:Finite-CC-EESM-v0`` for the specialised Finite-CC-EESM rollout
(``eesm_cc_rollout_random``), ``dfim_cc:Cont-CC-DFIM-v0`` for the
specialised Cont-CC-DFIM rollout (``dfim_cc_rollout_random``),
``scim_tc:Cont-TC-SCIM-v0`` for the specialised Cont-TC-SCIM rollout
(``scim_rollout_random``), ``pmsm:Finite-CC-PMSM-v0`` for the main path's
Finite-CC-PMSM random rollout (``pmsm_rollout_random``),
``permex:Finite-CC-PermExDc-v0`` for the specialised Finite-CC-PermExDc
rollout (``permex_rollout_random``), ``reinforce:<sample>:<refs>:<H>`` for the
REINFORCE rollout (``reinforce_rollout`` on Finite-CC-PMSM-v0, sample, refs
and H as for the policy; at the trainer's 1024 steps, gamma 0.99 and
baseline -0.1, its per-env gradient sums compared too),
``dc_cascade:<env_id>[:const]`` for the DC speed cascade in the loop
(``dc_cascade_rollout`` on Cont-SC-PermExDc-v0, Cont-SC-SeriesDc-v0 or
Cont-SC-ShuntDc-v0, the catalog's Wiener reference or
``ConstReference("omega", 0.5)``) or ``foc:Cont-CC-PMSM-v0[:const]`` for the
FOC closed loop (``foc_rollout``, the catalog's Wiener references or
constant zero ones), ``policy_universal:<id>[:joint][:psi_s=<x>]:<H>:<n>[:<T>]``
for the universal policy recorder of the id's family (``<family>_policy_record``,
``dc_policy_record`` on the DC ids; joint heads, an SRM's saturation flux
``psi_s``, H hidden units, n envs,
at T steps, by default 256, or 1024 from 16384 envs on: the two shapes
``chip_smoke.py`` times in phase 42; weights drawn from numpy as ``chip_smoke.pu_weights``
draws them, zero states), ``srm_record:<id>[:psi_s]`` for the SRM random
recorder (``srm_record_random`` at 1024 steps, the catalog's Wiener
references, linear or with that saturation flux ``psi_s``),
``dc_record:<id>`` for the universal DC random recorder (``dc_record_random``
on any of the 24 DC ids, at 1024 steps, the catalog's Wiener references),
``eesm_record:<id>`` for the universal EESM random recorder
(``eesm_record_random`` on any of the six EESM ids, likewise),
``sync_record:<id>`` for the universal synchronous random recorder
(``sync_record_random`` on any of the twelve sync ids, likewise),
``induction_record:<id>`` for the universal SCIM random recorder
(``induction_record_random`` on any of the six SCIM ids, likewise),
``dfim_record:<id>`` for the universal DFIM random recorder
(``dfim_record_random`` on any of the six DFIM ids, likewise),
``pmsm_record:Finite-CC-PMSM-v0`` for the specialised Finite-CC-PMSM random
recorder (``pmsm_record_random``, likewise) or
``permex_record:Finite-CC-PermExDc-v0`` for the specialised
Finite-CC-PermExDc random recorder (``permex_record_random``, likewise);
the closed loops take the tuned controller of ``GemController.make``.
For each path (default: the synchronous and DFIM ids that ``chip_smoke.py``
times, with Wiener and with constant references) it builds the path's
source (``csrc/fused_<family>.cu``, ``csrc/fused_policy.cu``,
``csrc/fused_dc_sc.cu``, ``csrc/fused_eesm_cc.cu``, ``csrc/fused_dfim_cc.cu``,
``csrc/fused_scim_tc.cu``, ``csrc/fused_pmsm.cu``, ``csrc/fused_permex.cu``,
``csrc/fused_dc_cascade.cu``, ``csrc/fused_foc.cu``,
``csrc/fused_<family>_policy.cu``, ``csrc/fused_srm_record.cu``,
``csrc/fused_dc_record.cu``, ``csrc/fused_eesm_record.cu``,
``csrc/fused_induction_record.cu``, ``csrc/fused_dfim_record.cu``) of both
trees with the package's nvcc flags,
runs the kernel of each on the same constants, seed and zero states
(16384 envs x 65536 steps, the recorders as above; the policy's weights drawn from numpy as
``chip_smoke.py``'s evaluation rollout draws them, its constant references
zero), in turns other, this, this, other, each a median of CUDA-event gaps
(``chip_smoke.cuda_ms``), and prints one JSON line: both sides' times,
other over this, whether the final outputs (a recorder's every step) of the
two sides are equal bit for bit (NaN where both are NaN), the mean reward
and the share of env-steps that reset; a recorder's line adds this tree's
design (the lane layout or the ring).  Families: ``sync``, ``induction`` and ``dfim`` (the
rollouts with a private ``_rollout_random_launch``); constant references
are those of ``chip_smoke.SYNC_CONST_REFS``.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
N_ENVS, T_STEPS, SEED, REPS = 16384, 65536, 7, 5
T_REINFORCE = 1024   # the REINFORCE trainer's depth (chip_smoke.T_REINFORCE)
T_RECORD = 1024      # the recorders' depth (chip_smoke.T_RECORD)
DEFAULT_PATHS = ("sync:Finite-CC-PMSM-v0", "sync:Cont-SC-PMSM-v0", "sync:Finite-CC-PMSM-v0:const",
                 "sync:Cont-SC-PMSM-v0:const", "dfim:Cont-CC-DFIM-v0", "dfim:Finite-CC-DFIM-v0",
                 "dfim:Cont-SC-DFIM-v0", "dfim:Cont-CC-DFIM-v0:const",
                 "dfim:Cont-SC-DFIM-v0:const")

# (consts, flags, spec, seed, n, n_steps, in, out, stream): the C rollouts
# of the specialised builders and the closed loops (permex_rollout_random,
# permex_record_random, eesm_cc_rollout_random, dfim_cc_rollout_random,
# scim_rollout_random, dc_cascade_rollout, foc_rollout)
C_ROLLOUT_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_uint64, ctypes.c_int, ctypes.c_int]
                      + [ctypes.c_void_p] * 3)


def build_other(other: Path, library: str) -> ctypes.CDLL:
    """``csrc/<library>.cu`` of the other checkout, built with this
    package's nvcc flags into ``<other>/_ab_build`` (kept there while no
    source of that checkout is newer, so that several runs against one
    checkout build it once)."""
    from gym_electric_motor_tpu_torch.ops import cuda_build

    csrc = other / "gym_electric_motor_tpu_torch" / "csrc"
    out = other / "_ab_build" / f"lib{library}.so"
    out.parent.mkdir(exist_ok=True)
    newest = max(f.stat().st_mtime for f in csrc.iterdir())
    if not out.exists() or out.stat().st_mtime < newest:
        subprocess.run([cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-I", str(csrc), "-o",
                        str(out), str(csrc / f"{library}.cu")], check=True, capture_output=True)
    return ctypes.CDLL(str(out))


def main():
    sys.path[:0] = [str(ROOT), str(ROOT / "tools")]
    import numpy as np
    import torch

    import chip_smoke as cs
    import gym_electric_motor_tpu_torch as gt
    from gym_electric_motor_tpu_torch import references as rg
    from gym_electric_motor_tpu_torch.controllers import GemController
    from gym_electric_motor_tpu_torch.ops import fused_dc as fd
    from gym_electric_motor_tpu_torch.ops import fused_dc_family as dcf
    from gym_electric_motor_tpu_torch.ops import fused_dfim as fdc
    from gym_electric_motor_tpu_torch.ops import fused_eesm as fe
    from gym_electric_motor_tpu_torch.ops import fused_induction as fi
    from gym_electric_motor_tpu_torch.ops import fused_dfim_family as dff
    from gym_electric_motor_tpu_torch.ops import fused_eesm_family as ef
    from gym_electric_motor_tpu_torch.ops import fused_induction_family as indf
    from gym_electric_motor_tpu_torch.ops import fused_policy as fp
    from gym_electric_motor_tpu_torch.ops import fused_srm_family as srf
    from gym_electric_motor_tpu_torch.ops import fused_sync as fs
    from gym_electric_motor_tpu_torch.ops import fused_sync_family as sf
    from gym_electric_motor_tpu_torch.ops.fused_common import ptr_array, seed_u64

    if not torch.cuda.is_available():
        sys.exit("rollout_ab.py: torch.cuda.is_available() is false")
    other = Path(sys.argv[1]).resolve()
    paths = sys.argv[2:] or DEFAULT_PATHS
    # the random recorders on a ring: module, constants, library
    RECORDERS = {"dc_record": (dcf, dcf.DcConsts, "fused_dc_record"),
                 "eesm_record": (ef, ef.EesmConsts, "fused_eesm_record"),
                 "srm_record": (srf, srf.SrmConsts, "fused_srm_record"),
                 "sync_record": (sf, sf.SyncConsts, "fused_sync"),
                 "induction_record": (indf, indf.InductionConsts, "fused_induction_record"),
                 "dfim_record": (dff, dff.DfimConsts, "fused_dfim_record")}
    families = {"sync": (sf, sf.SyncConsts, "fused_sync"),
                "induction": (indf, indf.InductionConsts, "fused_induction"),
                "dfim": (dff, dff.DfimConsts, "fused_dfim")}
    dev = torch.device("cuda")
    card = cs.card_line()
    libs = {}

    def other_lib(library, name, argtypes):
        if library not in libs:
            libs[library] = build_other(other, library)
        fn = getattr(libs[library], name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        return fn

    def stream():
        return torch.cuda.current_stream().cuda_stream

    for path in paths:
        family, *rest = path.split(":")
        steps, envs, design = T_STEPS, N_ENVS, None
        if family == "policy_universal":
            env_id, *rest = rest
            joint = rest[0] == "joint"
            rest = rest[joint:]
            psi = rest[0].startswith("psi_s=")
            kw = {"motor": {"motor_parameter": {"psi_s": float(rest[0][6:])}}} if psi else {}
            hidden, envs, *depth = (int(x) for x in rest[psi:])
            steps = depth[0] if depth else (1024 if envs >= 16384 else 256)
            env = gt.make_functional(env_id, device=dev, **kw)
            pol = fp.make_fused_policy_record_universal(env, steps, envs, hidden=hidden,
                                                        joint_heads=joint).policy
            w, ls = cs.pu_weights(torch, np.random.default_rng(SEED), pol, hidden, dev)
            planes = fp.fused_policy_init_planes(env, envs, device=dev)
            fn = other_lib(f"fused_{pol.surface.family}_policy", pol.kernel,
                           fp._UNIVERSAL_ARGTYPES)
            r_idx = len(pol.dtypes) - 2
            design = fp.policy_universal_layout(pol.kernel, envs)

            def run_other():
                outs, args = fp._universal_args(pol, SEED, *w, ls, planes, steps,
                                                (steps, envs // 128, 128))
                rc = fn(*args, stream())
                if rc:
                    raise RuntimeError(f"the other tree's {pol.kernel} returned {rc}")
                return outs

            def run_this():
                return fp.policy_record_universal(pol, SEED, *w, ls, planes, steps)
        elif family in RECORDERS:
            env_id, *psi = rest
            kw = {"motor": {"motor_parameter": {"psi_s": float(psi[0])}}} if psi else {}
            mod, consts, library = RECORDERS[family]
            c = consts(gt.make_functional(env_id, device=dev, **kw))
            steps = T_RECORD
            z = [torch.zeros((N_ENVS // 128, 128), device=dev) for _ in range(c.n_state)]
            kernel = f"{family}_random"
            fn = other_lib(library, kernel, mod._ARGTYPES[kernel])
            r_idx = len(mod.record_dtypes(c)) - 2
            design = getattr(mod, f"{family}_ring_layout")(c)

            def run_other():
                outs, args = mod._record_random_args(c, SEED, z, steps, N_ENVS)
                rc = fn(*args, stream())
                if rc:
                    raise RuntimeError(f"the other tree's {kernel} returned {rc}")
                return outs

            def run_this():
                return mod._record_random_launch(c, SEED, z, steps, N_ENVS)
        elif family == "policy":
            sample, refs, hidden = rest
            greedy, wiener = sample == "greedy", refs == "wiener"
            env_id = "Finite-CC-PMSM-v0"
            consts = fp.PolicyConsts(gt.make_functional(env_id, device=dev,
                                                        state_filter=fp.STATE_FILTER))
            w = cs.rl_weights(torch, np.random.default_rng(SEED), dev, 6, int(hidden), 0.5, 0.1)
            z = [torch.zeros(N_ENVS, device=dev) for _ in range(3)]
            zref = None if wiener else torch.zeros(N_ENVS, device=dev)
            fn = other_lib("fused_policy", "policy_rollout", fp._ARGTYPES["policy_rollout"])
            r_idx = 3

            def run_other():
                outs = [torch.empty(N_ENVS, device=dev) for _ in range(5)]
                rc = fn(consts.host.ctypes.data, seed_u64(SEED), N_ENVS, T_STEPS, int(hidden),
                        int(greedy), int(wiener), *[x.data_ptr() for x in w + z],
                        *([None, None] if wiener else [zref.data_ptr()] * 2),
                        *[x.data_ptr() for x in outs], stream())
                if rc:
                    raise RuntimeError(f"the other tree's policy_rollout returned {rc}")
                return outs

            def run_this():
                return fp._rollout_launch(consts, SEED, *w, *z, zref, zref, T_STEPS, N_ENVS,
                                          greedy, wiener)
        elif family == "reinforce":
            sample, refs, hidden = rest
            greedy, wiener = sample == "greedy", refs == "wiener"
            env_id, steps, gamma = "Finite-CC-PMSM-v0", T_REINFORCE, 0.99
            consts = fp.PolicyConsts(gt.make_functional(env_id, device=dev,
                                                        state_filter=fp.STATE_FILTER))
            w = cs.rl_weights(torch, np.random.default_rng(SEED), dev, 6, int(hidden), 0.5, 0.1)
            z = [torch.zeros(N_ENVS, device=dev) for _ in range(3)]
            zref = None if wiener else torch.zeros(N_ENVS, device=dev)
            base = torch.full((1,), -0.1, device=dev)
            n_p = fp.n_policy_params(6, int(hidden))
            # the parent's C interface: its [P, n] trace scratch before acc
            fn = other_lib("fused_policy", "reinforce_rollout",
                           fp._ARGTYPES["reinforce_rollout"][:-1] + [ctypes.c_void_p] * 2)
            r_idx = 3

            def run_other():
                outs = [torch.empty(N_ENVS, device=dev) for _ in range(5)]
                trace, acc = (torch.empty((n_p, N_ENVS), device=dev) for _ in range(2))
                rc = fn(consts.host.ctypes.data, seed_u64(SEED), N_ENVS, steps, int(hidden),
                        int(greedy), int(wiener), gamma, *[x.data_ptr() for x in [base] + w + z],
                        *([None, None] if wiener else [zref.data_ptr()] * 2),
                        *[x.data_ptr() for x in outs + [trace, acc]], stream())
                if rc:
                    raise RuntimeError(f"the other tree's reinforce_rollout returned {rc}")
                return outs + [acc]

            def run_this():
                return fp._reinforce_launch(consts, SEED, base, *w, *z, zref, zref, steps,
                                            N_ENVS, gamma, greedy, wiener)
        elif family == "scim_tc":
            (env_id,) = rest
            c = fi.ScimConsts(gt.make_functional(env_id, device=dev))
            z = [torch.zeros(N_ENVS, device=dev) for _ in range(c.n_state)]
            fn = other_lib("fused_scim_tc", "scim_rollout_random", C_ROLLOUT_ARGTYPES)
            r_idx = 4

            def run_other():
                outs = [torch.empty(N_ENVS, device=dev) for _ in range(10)]
                rc = fn(c.ic.host.ctypes.data, c.ic.flags.ctypes.data, c.host.ctypes.data,
                        seed_u64(SEED), N_ENVS, T_STEPS, ptr_array(z), ptr_array(outs), stream())
                if rc:
                    raise RuntimeError(f"the other tree's scim_rollout_random returned {rc}")
                return outs

            def run_this():
                return fi._scim_random_launch(c, SEED, z, T_STEPS, N_ENVS)
        elif family == "pmsm":
            (env_id,) = rest
            pc = fs.PmsmConsts(gt.make_functional(env_id, device=dev))
            z = [torch.zeros(N_ENVS, device=dev) for _ in range(3)]
            fn = other_lib("fused_pmsm", "pmsm_rollout_random",
                           fs._ARGTYPES["pmsm_rollout_random"])
            r_idx = 3

            def run_other():
                outs = ([torch.empty(N_ENVS, device=dev) for _ in range(5)]
                        + [torch.empty(2 * N_ENVS, device=dev) for _ in range(4)])
                rc = fn(pc.host.ctypes.data, seed_u64(SEED), N_ENVS, T_STEPS,
                        *[x.data_ptr() for x in z + outs], stream())
                if rc:
                    raise RuntimeError(f"the other tree's pmsm_rollout_random returned {rc}")
                return outs

            def run_this():
                return fs._pmsm_random_launch(pc, SEED, z, T_STEPS, N_ENVS)
        elif family == "pmsm_record":
            (env_id,) = rest
            pc = fs.PmsmConsts(gt.make_functional(env_id, device=dev))
            steps = T_RECORD
            z = [torch.zeros(N_ENVS, device=dev) for _ in range(3)]
            fn = other_lib("fused_pmsm", "pmsm_record_random",
                           fs._ARGTYPES["pmsm_record_random"])
            r_idx = 6
            design = fs.pmsm_record_ring_layout()

            def run_other():
                outs = [torch.empty((steps, N_ENVS), device=dev,
                                    dtype=torch.int32 if j == 5 else torch.float32)
                        for j in range(8)]
                rc = fn(pc.host.ctypes.data, seed_u64(SEED), N_ENVS, steps,
                        *[x.data_ptr() for x in z + outs], stream())
                if rc:
                    raise RuntimeError(f"the other tree's pmsm_record_random returned {rc}")
                return outs

            def run_this():
                return fs._pmsm_record_random_launch(pc, SEED, z, steps, N_ENVS)
        elif family == "permex_record":
            (env_id,) = rest
            c = fd.PermexConsts(gt.make_functional(env_id, device=dev))
            steps = T_RECORD
            z = torch.zeros(N_ENVS, device=dev)
            fn = other_lib("fused_permex", "permex_record_random", C_ROLLOUT_ARGTYPES)
            r_idx = 3
            design = fd.permex_record_ring_layout()

            def run_other():
                outs = [torch.empty((steps, N_ENVS), device=dev,
                                    dtype=torch.int32 if j == 2 else torch.float32)
                        for j in range(5)]
                rc = fn(*fd._px_consts(c), seed_u64(SEED), N_ENVS, steps, ptr_array([z]),
                        ptr_array(outs), stream())
                if rc:
                    raise RuntimeError(f"the other tree's permex_record_random returned {rc}")
                return outs

            def run_this():
                return fd._permex_record_random_launch(c, SEED, z, steps, N_ENVS)
        elif family == "permex":
            (env_id,) = rest
            c = fd.PermexConsts(gt.make_functional(env_id, device=dev))
            z = torch.zeros(N_ENVS, device=dev)
            fn = other_lib("fused_permex", "permex_rollout_random", C_ROLLOUT_ARGTYPES)
            r_idx = 1

            def run_other():
                outs = [torch.empty(N_ENVS, device=dev) for _ in range(7)]
                rc = fn(*fd._px_consts(c), seed_u64(SEED), N_ENVS, T_STEPS, ptr_array([z]),
                        ptr_array(outs), stream())
                if rc:
                    raise RuntimeError(f"the other tree's permex_rollout_random returned {rc}")
                return outs

            def run_this():
                return fd._permex_random_launch(c, SEED, z, T_STEPS, N_ENVS)
        elif family == "dc_sc":
            (env_id,) = rest
            c = fd.DcScConsts(gt.make_functional(env_id, device=dev))
            z = [torch.zeros(N_ENVS, device=dev) for _ in range(c.n_state)]
            fn = other_lib("fused_dc_sc", "dc_sc_rollout_random",
                           [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int, ctypes.c_int,
                            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])
            r_idx = c.n_state

            def run_other():
                outs = [torch.empty(N_ENVS, device=dev) for _ in range(c.n_state + 6)]
                rc = fn(c.host.ctypes.data, seed_u64(SEED), N_ENVS, T_STEPS, ptr_array(z),
                        ptr_array(outs), stream())
                if rc:
                    raise RuntimeError(f"the other tree's dc_sc_rollout_random returned {rc}")
                return outs

            def run_this():
                return fd._dc_sc_random_launch(c, SEED, z, T_STEPS, N_ENVS)
        elif family == "eesm_cc":
            (env_id,) = rest
            c = fe.EesmCcConsts(gt.make_functional(env_id, device=dev))
            z = [torch.zeros(N_ENVS, device=dev) for _ in range(c.n_state)]
            fn = other_lib("fused_eesm_cc", "eesm_cc_rollout_random", C_ROLLOUT_ARGTYPES)
            r_idx = 4

            def run_other():
                outs = ([torch.empty(N_ENVS, device=dev) for _ in range(6)]
                        + [torch.empty(3 * N_ENVS, device=dev) for _ in range(4)])
                rc = fn(c.ec.host.ctypes.data, c.ec.flags.ctypes.data, c.host.ctypes.data,
                        seed_u64(SEED), N_ENVS, T_STEPS, ptr_array(z), ptr_array(outs), stream())
                if rc:
                    raise RuntimeError(f"the other tree's eesm_cc_rollout_random returned {rc}")
                return outs

            def run_this():
                return fe._eesm_cc_random_launch(c, SEED, z, T_STEPS, N_ENVS)
        elif family == "dc_cascade":
            env_id, *refs = rest
            kw = ({"reference_generator": rg.ReferenceSpec([rg.ConstReference("omega", 0.5)])}
                  if refs else {})
            env = gt.make_functional(env_id, device=dev, **kw)
            cc = dcf.DcCascadeConsts(env, GemController.make(env, env_id))
            n_state = cc.c.n_state
            z = [torch.zeros(N_ENVS, device=dev) for _ in range(n_state)]
            fn = other_lib("fused_dc_cascade", "dc_cascade_rollout", C_ROLLOUT_ARGTYPES)
            r_idx = n_state

            def run_other():
                outs = [torch.empty(N_ENVS, device=dev) for _ in range(n_state + 8)]
                rc = fn(cc.c.host.ctypes.data, cc.c.flags.ctypes.data, cc.host.ctypes.data,
                        seed_u64(SEED), N_ENVS, T_STEPS, dcf._in_ptrs(cc.c, z),
                        ptr_array(dcf._out_state(cc.c, outs[:n_state]) + outs[n_state:]),
                        stream())
                if rc:
                    raise RuntimeError(f"the other tree's dc_cascade_rollout returned {rc}")
                return outs

            def run_this():
                return dcf._dc_cascade_launch(cc, SEED, z, T_STEPS, N_ENVS)
        elif family == "dfim_cc":
            (env_id,) = rest
            c = fdc.DfimCcConsts(gt.make_functional(env_id, device=dev))
            z = [torch.zeros(N_ENVS, device=dev) for _ in range(c.n_state)]
            fn = other_lib("fused_dfim_cc", "dfim_cc_rollout_random", C_ROLLOUT_ARGTYPES)
            r_idx = 5

            def run_other():
                outs = ([torch.empty(N_ENVS, device=dev) for _ in range(7)]
                        + [torch.empty(2 * N_ENVS, device=dev) for _ in range(4)])
                rc = fn(c.df.host.ctypes.data, c.df.flags.ctypes.data, c.host.ctypes.data,
                        seed_u64(SEED), N_ENVS, T_STEPS, ptr_array(z), ptr_array(outs), stream())
                if rc:
                    raise RuntimeError(f"the other tree's dfim_cc_rollout_random returned {rc}")
                return outs

            def run_this():
                return fdc._dfim_cc_random_launch(c, SEED, z, T_STEPS, N_ENVS)
        elif family == "foc":
            env_id, *refs = rest
            env = gt.make_functional(env_id, device=dev)
            fc = fs.FocConsts(env, GemController.make(env, env_id), "const" if refs else "wiener")
            flags = np.array([int(fc.wiener)], dtype=np.int32)
            z = [torch.zeros(N_ENVS, device=dev) for _ in range(5)]
            fn = other_lib("fused_foc", "foc_rollout", C_ROLLOUT_ARGTYPES)
            r_idx = 3

            def run_other():
                outs = ([torch.empty(N_ENVS, device=dev) for _ in range(5)]
                        + [torch.empty(2 * N_ENVS, device=dev) for _ in range(4)])
                rc = fn(fc.pm.host.ctypes.data, flags.ctypes.data, fc.host.ctypes.data,
                        seed_u64(SEED), N_ENVS, T_STEPS, ptr_array(z), ptr_array(outs), stream())
                if rc:
                    raise RuntimeError(f"the other tree's foc_rollout returned {rc}")
                return outs

            def run_this():
                return fs._foc_launch(fc, SEED, z, T_STEPS, N_ENVS)
        else:
            env_id, *refs = rest
            mod, consts, library = families[family]
            kw = {}
            if refs:
                kw["reference_generator"] = rg.ReferenceSpec(
                    [rg.ConstReference(n, v) for n, v in cs.SYNC_CONST_REFS[env_id.split("-")[1]]])
            c = consts(gt.make_functional(env_id, device=dev, **kw))
            z = [torch.zeros((N_ENVS // 128, 128), device=dev) for _ in range(c.n_state)]
            pad = ([] if c.mech else [None])
            fn = other_lib(library, f"{family}_rollout_random",
                           [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int,
                            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])
            r_idx = c.n_state

            def run_other():
                outs = ([torch.empty(N_ENVS, device=dev) for _ in range(c.n_state + 2)]
                        + [torch.empty(c.n_ref * N_ENVS, device=dev) for _ in range(4)])
                rc = fn(c.host.ctypes.data, c.flags.ctypes.data, seed_u64(SEED), N_ENVS, T_STEPS,
                        ptr_array(pad + z), ptr_array(pad + outs), stream())
                if rc:
                    raise RuntimeError(f"the other tree's {family}_rollout_random returned {rc}")
                return outs

            def run_this():
                return mod._rollout_random_launch(c, SEED, z, T_STEPS, N_ENVS)

        times, outs = {"other": [], "this": []}, {}
        for side in ("other", "this", "this", "other"):
            ms, outs[side] = cs.cuda_ms(torch, run_other if side == "other" else run_this, REPS)
            times[side].append(ms)
        equal = all(bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())
                    for a, b in zip(outs["this"], outs["other"]))
        o_ms, t_ms = float(np.median(times["other"])), float(np.median(times["this"]))
        ref = outs["this"]
        row = {"card": card, "path": path, "family": family, "env_id": env_id, "envs": envs,
               "steps": steps, "other_ms": times["other"], "this_ms": times["this"],
               "other_over_this": o_ms / t_ms, "equal": equal,
               "mean_reward": float(ref[r_idx].double().sum()) / (envs * steps),
               "reset_share": float(ref[r_idx + 1].double().sum()) / (envs * steps)}
        if design is not None:
            row["design"] = design
        print(json.dumps(row), flush=True)
        if not equal:
            raise AssertionError(f"{path}: the two trees' outputs differ")


if __name__ == "__main__":
    main()
