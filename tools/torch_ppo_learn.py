#!/usr/bin/env python3
"""Fused-collection PPO on Finite-CC-PMSM-v0 learns: the port's counterpart
of ``fused_ppo_improves`` in tools/tpu_validate.py (:270-300).

Run on a machine with a CUDA GPU, from the root of a checkout:

    python3 tools/torch_ppo_learn.py [--iters 1200] [--device cuda] [--universal]

2048 envs x 256 steps per iteration, hidden 32, 8 minibatches, 2 epochs,
lr 1e-3, gamma 0.9, vf_coef 0.1, ent_coef 0.01 (the configuration of
bench.py:455-462).  It prints one JSON line per 50 iterations (mean reward
of the block, seconds so far) and a last line with the first 5 and last 10
iterations' mean reward, the wall time and the card; it exits 1 unless
``last > -0.11`` and ``last > first + 0.05``, the assertion of the JAX
package's on-chip check.  ``--universal`` runs instead the two checks of the
universal policy recorder (:func:`learn_universal`, ``UNIVERSAL_CHECKS``:
Finite-CC-PermExDc-v0, 200 iterations, and Cont-CC-PermExDc-v0, 300).
``chip_smoke.py`` runs :func:`learn` and :func:`learn_universal` as phases.
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


# The JAX package's on-chip learning checks of the universal recorder
# (tools/tpu_validate.py:303-365): env id, iterations, ent_coef, and the
# limits on the last 10 iterations' mean reward (absolute, and its gain
# over the first 5).
UNIVERSAL_CHECKS = {
    "Finite-CC-PermExDc-v0": dict(iters=200, ent_coef=0.01, last_above=-0.05, gain=0.1),
    "Cont-CC-PermExDc-v0": dict(iters=300, ent_coef=0.0, last_above=-0.01, gain=0.2),
}


def learn_universal(device, env_id, iters, ent_coef, last_above, gain, seed=3, log=print):
    """Fused PPO through the universal policy recorder (``kernel='auto'``
    takes it on these ids) from ``init_actor_critic_params(1, F, A, 32)``
    (with ``n_cont`` log-stds for a continuous id) and the zero planes of
    ``fused_policy_init_planes``, at 2048 envs x 256 steps, 8 minibatches,
    2 epochs, lr 1e-3, gamma 0.9, vf_coef 0.1: the configuration of the JAX
    package's ``universal_ppo_improves`` and ``cont_ppo_improves``.  ``ok``
    holds when the last 10 iterations' mean reward is above ``last_above``
    and above the first 5's by ``gain``."""
    import torch

    import gym_electric_motor_tpu_torch as gt
    from gym_electric_motor_tpu_torch.ops.fused_policy import (fused_policy_init_planes,
                                                               policy_act_ns, policy_n_cont,
                                                               policy_obs_dim)
    from gym_electric_motor_tpu_torch.parallel import (init_actor_critic_params,
                                                       make_fused_ppo_trainer)

    dev = torch.device(device)
    env = gt.make_functional(env_id, device=dev)
    n_cont = policy_n_cont(env)
    n_out = n_cont or int(sum(policy_act_ns(env)))
    init_opt, train = make_fused_ppo_trainer(env, hidden=32, horizon=HORIZON, n_envs=N_ENVS,
                                             n_minibatches=8, n_epochs=2, lr=1e-3, gamma=0.9,
                                             vf_coef=0.1, ent_coef=ent_coef)
    model = init_actor_critic_params(1, policy_obs_dim(env), n_out, 32, device=dev,
                                     n_cont=n_cont)
    opt = init_opt(model)
    planes = fused_policy_init_planes(env, N_ENVS, device=dev)
    rs_all = []
    t0 = time.perf_counter()
    done = 0
    while done < iters:
        n = min(BLOCK, iters - done)
        model, opt, planes, rs = train(model, opt, planes, seed + done, n)
        rs = rs.double().cpu().tolist()
        rs_all += rs
        done += n
        log({"env_id": env_id, "iters": done, "mean_reward": sum(rs) / len(rs),
             "seconds": time.perf_counter() - t0})
    wall = time.perf_counter() - t0
    first = sum(rs_all[:5]) / len(rs_all[:5])
    last = sum(rs_all[-10:]) / len(rs_all[-10:])
    return {"env_id": env_id, "first": first, "last": last,
            "ok": last > last_above and last > first + gain, "iters": iters, "seconds": wall,
            "env_steps_per_s": iters * N_ENVS * HORIZON / wall,
            "trainer": (model, opt, planes, train)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=1200)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--universal", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import subprocess

    import torch

    def log(d):
        print(json.dumps(d), flush=True)

    if args.universal:
        runs = [learn_universal(args.device, env_id, seed=args.seed, log=log, **cfg)
                for env_id, cfg in UNIVERSAL_CHECKS.items()]
        for r in runs:
            r.pop("trainer")
        out = {"runs": runs, "ok": all(r["ok"] for r in runs)}
    else:
        out = learn(args.device, args.iters, args.seed, log=log)
    if torch.device(args.device).type == "cuda":
        out["device"] = torch.cuda.get_device_name(torch.device(args.device))
        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(json.dumps(out), flush=True)
    sys.exit(0 if out["ok"] else 1)


if __name__ == "__main__":
    main()
