#!/usr/bin/env python3
"""Time this checkout's universal random rollouts against another
checkout's, in one process on one card, and check that both give the same
bits.

Run on a machine with an NVIDIA GPU and the CUDA toolkit, from the root of
a checkout, with another checkout unpacked beside it (for example the
parent commit: ``git archive <commit> | tar -x -C _checkout/parent``):

    python3 tools/rollout_ab.py _checkout/parent [family:env_id[:const] ...]

For each path (default: the synchronous and DFIM ids that ``chip_smoke.py``
times, with Wiener and with constant references) it builds
``csrc/fused_<family>.cu`` of both trees with the package's nvcc flags,
runs ``<family>_rollout_random`` of each on the same constants, seed and
zero states (16384 envs x 65536 steps), in turns other, this, this, other,
each a median of CUDA-event gaps (``chip_smoke.cuda_ms``), and prints one
JSON line: both sides' times, other over this, whether the final outputs
of the two sides are equal bit for bit (NaN where both are NaN), the mean
reward and the share of env-steps that reset.  Families: ``sync``,
``induction`` and ``dfim`` (the rollouts with a private
``_rollout_random_launch``); constant references are those of
``chip_smoke.SYNC_CONST_REFS``.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
N_ENVS, T_STEPS, SEED, REPS = 16384, 65536, 7, 5
DEFAULT_PATHS = ("sync:Finite-CC-PMSM-v0", "sync:Cont-SC-PMSM-v0", "sync:Finite-CC-PMSM-v0:const",
                 "sync:Cont-SC-PMSM-v0:const", "dfim:Cont-CC-DFIM-v0", "dfim:Finite-CC-DFIM-v0",
                 "dfim:Cont-SC-DFIM-v0", "dfim:Cont-CC-DFIM-v0:const",
                 "dfim:Cont-SC-DFIM-v0:const")


def build_other(other: Path, library: str) -> ctypes.CDLL:
    """``csrc/<library>.cu`` of the other checkout, built with this
    package's nvcc flags into ``<other>/_ab_build``."""
    from gym_electric_motor_tpu_torch.ops import cuda_build

    csrc = other / "gym_electric_motor_tpu_torch" / "csrc"
    out = other / "_ab_build" / f"lib{library}.so"
    out.parent.mkdir(exist_ok=True)
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
    from gym_electric_motor_tpu_torch.ops import fused_dfim_family as dff
    from gym_electric_motor_tpu_torch.ops import fused_induction_family as indf
    from gym_electric_motor_tpu_torch.ops import fused_sync_family as sf
    from gym_electric_motor_tpu_torch.ops.fused_common import ptr_array, seed_u64

    if not torch.cuda.is_available():
        sys.exit("rollout_ab.py: torch.cuda.is_available() is false")
    other = Path(sys.argv[1]).resolve()
    paths = sys.argv[2:] or DEFAULT_PATHS
    families = {"sync": (sf, sf.SyncConsts, "fused_sync"),
                "induction": (indf, indf.InductionConsts, "fused_induction"),
                "dfim": (dff, dff.DfimConsts, "fused_dfim")}
    dev = torch.device("cuda")
    card = cs.card_line()
    libs = {}
    for path in paths:
        family, env_id, *refs = path.split(":")
        mod, consts, library = families[family]
        if library not in libs:
            libs[library] = build_other(other, library)
        kw = {}
        if refs:
            kw["reference_generator"] = rg.ReferenceSpec(
                [rg.ConstReference(n, v) for n, v in cs.SYNC_CONST_REFS[env_id.split("-")[1]]])
        c = consts(gt.make_functional(env_id, device=dev, **kw))
        z = [torch.zeros((N_ENVS // 128, 128), device=dev) for _ in range(c.n_state)]
        pad = ([] if c.mech else [None])
        fn = getattr(libs[library], f"{family}_rollout_random")
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int

        def run_other():
            outs = ([torch.empty(N_ENVS, device=dev) for _ in range(c.n_state + 2)]
                    + [torch.empty(c.n_ref * N_ENVS, device=dev) for _ in range(4)])
            rc = fn(c.host.ctypes.data, c.flags.ctypes.data, seed_u64(SEED), N_ENVS, T_STEPS,
                    ptr_array(pad + z), ptr_array(pad + outs),
                    torch.cuda.current_stream().cuda_stream)
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
        print(json.dumps({"card": card, "family": family, "env_id": env_id,
                          "refs": "const" if refs else "wiener", "envs": N_ENVS,
                          "steps": T_STEPS, "other_ms": times["other"], "this_ms": times["this"],
                          "other_over_this": o_ms / t_ms, "equal": equal,
                          "mean_reward": float(ref[c.n_state].double().sum()) / (N_ENVS * T_STEPS),
                          "reset_share": float(ref[c.n_state + 1].double().sum())
                          / (N_ENVS * T_STEPS)}), flush=True)
        if not equal:
            raise AssertionError(f"{path}: the two trees' outputs differ")


if __name__ == "__main__":
    main()
