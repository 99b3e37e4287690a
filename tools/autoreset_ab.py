#!/usr/bin/env python3
"""Time the general path's two ways of auto-resetting on the GPU.

Run from the root of a checkout on a machine with an NVIDIA GPU:

    python3 tools/autoreset_ab.py [--envs 16384] [--steps 500] [--rounds 2]

``VectorEnv.rollout`` of Finite-CC-PMSM-v0 under random actions, timed on
the host clock, alternating (A B B A per round):

* ``select``: the port's ``step_autoreset``, which computes the reset
  every step and selects it where an env terminated (the JAX package's
  unconditional select);
* ``branch``: a variant defined here that reads ``terminated.any()`` back
  to the host every step and computes the reset only when it is true.

Prints one JSON line per timed rollout, then a summary line with each
variant's median env-steps/s and the share of steps in which no env
terminated (the only steps the branch saves work on), then the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--envs", type=int, default=16384)
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import torch

    if not torch.cuda.is_available():
        sys.exit("autoreset_ab.py: needs a CUDA GPU")
    import gym_electric_motor_tpu_torch as gt
    from gym_electric_motor_tpu_torch.core import _select

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    venv = gt.make("Finite-CC-PMSM-v0", n_envs=args.envs)
    env = venv.env

    def step_branch(state, action):
        new_state, obs, reward, terminated = env.step(state, action)
        episode = state.episode + terminated.to(torch.int32)
        new_state = dataclasses.replace(new_state, episode=episode)
        if bool(terminated.any()):
            reset_state, reset_obs = env.reset(state.key)
            reset_state = dataclasses.replace(reset_state, episode=episode)
            new_state = _select(terminated, reset_state, new_state)
            obs = _select(terminated, reset_obs, obs)
        return new_state, obs, reward, terminated

    variants = {"select": env.step_autoreset, "branch": step_branch}
    policy = gt.random_policy(8)
    gen = torch.Generator(device="cuda").manual_seed(0)
    state, _ = venv.reset(0)
    for fn in variants.values():  # warm-up
        venv.step = fn
        state, _r, _t = venv.rollout(state, policy, 10, gen)

    rates = {k: [] for k in variants}
    no_term = []
    for _ in range(args.rounds):
        for name in ("select", "branch", "branch", "select"):
            venv.step = variants[name]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, _r, terms = venv.rollout(state, policy, args.steps, gen)
            torch.cuda.synchronize()
            s = time.perf_counter() - t0
            rates[name].append(args.envs * args.steps / s)
            no_term.append(float((terms == 0).double().mean()))
            print(json.dumps({"variant": name, "envs": args.envs, "steps": args.steps,
                              "seconds": s, "env_steps_per_s": rates[name][-1],
                              "share_steps_without_termination": no_term[-1]}), flush=True)
    print(json.dumps({"summary": True, "card": card,
                      "median_env_steps_per_s": {k: statistics.median(v) for k, v in rates.items()},
                      "select_over_branch": statistics.median(rates["select"])
                      / statistics.median(rates["branch"]),
                      "share_steps_without_termination": statistics.fmean(no_term)}), flush=True)
    print(card, flush=True)


if __name__ == "__main__":
    main()
