#!/usr/bin/env python3
"""Fused-collection PPO on Finite-CC-PMSM-v0 learns: the port's counterpart
of ``fused_ppo_improves`` in tools/tpu_validate.py (:270-300).

Run on a machine with a CUDA GPU, from the root of a checkout:

    python3 tools/torch_ppo_learn.py [--iters 1200] [--device cuda]

2048 envs x 256 steps per iteration, hidden 32, 8 minibatches, 2 epochs,
lr 1e-3, gamma 0.9, vf_coef 0.1, ent_coef 0.01 (the configuration of
bench.py:455-462).  It prints one JSON line per 50 iterations (mean reward
of the block, seconds so far) and a last line with the first 5 and last 10
iterations' mean reward, the wall time and the card; it exits 1 unless
``last > -0.11`` and ``last > first + 0.05``, the assertion of the JAX
package's on-chip check.  ``chip_smoke.py`` runs :func:`learn` as a phase.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

N_ENVS, HORIZON, BLOCK = 2048, 256, 50


def learn(device, iters=1200, seed=3, log=print):
    """Train from ``init_actor_critic_params(1, 7, 8, 32)``; ``log`` gets
    one dict per block of 50 iterations.  Returns the summary dict."""
    import torch

    import gym_electric_motor_tpu_torch as gt
    from gym_electric_motor_tpu_torch.parallel import (init_actor_critic_params,
                                                       make_fused_ppo_trainer)

    dev = torch.device(device)
    env = gt.make_functional("Finite-CC-PMSM-v0", device=dev,
                             state_filter=("omega", "i_sd", "i_sq", "epsilon"))
    init_opt, train = make_fused_ppo_trainer(env, hidden=32, horizon=HORIZON, n_envs=N_ENVS,
                                             n_minibatches=8, n_epochs=2, lr=1e-3, gamma=0.9,
                                             vf_coef=0.1, ent_coef=0.01)
    model = init_actor_critic_params(1, 7, 8, 32, device=dev)
    opt = init_opt(model)
    planes = tuple(torch.zeros((N_ENVS // 128, 128), device=dev) for _ in range(3))
    rs_all = []
    t0 = time.perf_counter()
    done = 0
    while done < iters:
        n = min(BLOCK, iters - done)
        model, opt, planes, rs = train(model, opt, planes, seed + done, n)
        rs = rs.double().cpu().tolist()
        rs_all += rs
        done += n
        log({"iters": done, "mean_reward": sum(rs) / len(rs),
             "seconds": time.perf_counter() - t0})
    wall = time.perf_counter() - t0
    first = sum(rs_all[:5]) / len(rs_all[:5])
    last = sum(rs_all[-10:]) / len(rs_all[-10:])
    return {"first": first, "last": last, "ok": last > -0.11 and last > first + 0.05,
            "iters": iters, "seconds": wall, "env_steps_per_s": iters * N_ENVS * HORIZON / wall}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=1200)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import subprocess

    import torch

    out = learn(args.device, args.iters, args.seed,
                log=lambda d: print(json.dumps(d), flush=True))
    if torch.device(args.device).type == "cuda":
        out["device"] = torch.cuda.get_device_name(torch.device(args.device))
        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(json.dumps(out), flush=True)
    sys.exit(0 if out["ok"] else 1)


if __name__ == "__main__":
    main()
