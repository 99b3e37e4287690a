#!/usr/bin/env python3
"""Where the time goes on the GPU for the PyTorch/CUDA port's main path.

Run from the root of a checkout on a machine with an NVIDIA GPU:

    python3 tools/torch_profile.py [--envs 16384] [--steps 20] [--env-id ID ...]

Profiles (torch.profiler, CPU + CUDA activities) a window of the general
path (``VectorEnv.rollout`` under the uniform random policy of the env's
action space; Finite-CC-PMSM-v0 unless ``--env-id`` names others) and
prints one JSON line: wall time (host clock), device busy time (the sum of
the device ops' time), the device's idle share, device ops per env-step
and the top device ops.  If the profiler records no device time, the
device numbers are null.  The last line is the card's name and power
limit.  The fused kernels are timed by chip_smoke.py with CUDA events.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path


def profile_window(torch, fn, steps, n_envs):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    # device-side events (kernels, copies, sets) on the one stream
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    by_name = {}
    for e in dev:
        us, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return {
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms if dev else None,
        "device_idle_share": (1.0 - busy_ms / wall_ms) if dev else None,
        "device_ops": len(dev),
        "device_ops_per_step": len(dev) / steps,
        "env_steps_per_s": n_envs * steps / (wall_ms / 1e3),
        "top_device_ops_ms": [[k[:60], us / 1e3, n] for k, (us, n) in top],
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--envs", type=int, default=16384)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--env-id", nargs="+", default=["Finite-CC-PMSM-v0"])
    args = ap.parse_args()
    root = Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        sys.exit("torch_profile.py: needs a CUDA GPU")
    import gym_electric_motor_tpu_torch as gt

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    for env_id in args.env_id:
        venv = gt.make(env_id, n_envs=args.envs)
        state, _ = venv.reset(0)
        gen = torch.Generator(device="cuda").manual_seed(0)
        policy = gt.random_policy_for(venv.env)
        state, _r, _t = venv.rollout(state, policy, 10, gen)  # warm-up
        general = profile_window(torch, lambda: venv.rollout(state, policy, args.steps, gen),
                                 args.steps, args.envs)
        print(json.dumps({"window": "general_path", "env_id": env_id, "envs": args.envs,
                          "steps": args.steps, "card": card, **general}), flush=True)
    print(card, flush=True)


if __name__ == "__main__":
    main()
