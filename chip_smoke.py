#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (gym_electric_motor_tpu_torch) once on an
NVIDIA GPU and check it.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (each prints one JSON line; any failure exits non-zero):

1. card     name and power limit (nvidia-smi), CUDA must be available
2. build    nvcc builds the kernels of csrc/ for sm_90a
3. kernels  each of the 4 fused PMSM kernels against its plain PyTorch
            version on the card, 16384 envs x 256 steps (the random
            recorder at its main-path 1024 steps), same inputs/seed
4. env      the main path: the port's VectorEnv (Finite-CC-PMSM-v0, const
            references, an action buffer, 16384 envs x 40 steps) against
            the buffer rollout and the buffer recorder
5. timings  the general path (VectorEnv.rollout, random actions,
            16384 envs x 1000 steps), the random rollout kernel
            (16384 envs x 65536 steps) and the random recorder (16384 envs
            x 1024 steps, ~0.54 GB written), with output checks
6. kernels line: launches on the main path (phases 4-5), errors, times
7. the card line, then {"ok": true, "device": {...}}

Tolerances: buffer modes rtol 1e-5 / atol 1e-4 (A, rad), those of
tests/test_pallas_rollout.py:52-58 (float32 RK4; the kernels are built
with -fmad=false, so each op rounds as PyTorch's do).  Random modes:
an env matches when all its outputs agree at rtol 1e-4 / atol 1e-4; at
least 99.9% of envs must match (a constraint-threshold flip sends an env
down another branch) and the mean reward must agree to 1e-4 relative.
Angles are compared modulo 2 pi.

Bounds (bound_ms): the larger of the bytes moved (each input read once,
each output written once) over 3.35 TB/s and, for each issue pipe, the
instructions one step always executes over the pipe's rate, at 132 SMs x
1.98 GHz.  The counts come from the SASS of the library this run built
(tools/sass_ops.py: FP32 operations at 256 per SM and clock, i.e.
67 TFLOP/s; ALU and IMAD instructions at 64; MUFU and conversions at 16).
They leave out the blocks a step runs only sometimes (reference
regeneration, the reset draws of a violation, the slow paths of sqrtf and
sincosf), so each bound is a lower bound; the build phase prints both
counts.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

N_ENVS = 16384
T_COMPARE = 256
T_ENV = 40
T_GENERAL = 1000
T_ROLLOUT = 65536
T_RECORD = 1024
SEED = 7

# peak rates (see the module docstring)
SMS, CLOCK, HBM = 132, 1.98e9, 3.35e12


def emit(obj):
    print(json.dumps(obj), flush=True)


def bound_ms(env_steps, ops, nbytes):
    """Least time for ``env_steps`` steps of ``ops`` (per step and pipe, as
    tools/sass_ops.py counts them) moving ``nbytes``."""
    from sass_ops import RATE_PER_SM_CLOCK

    t_ops = max(env_steps * n / (SMS * CLOCK * RATE_PER_SM_CLOCK[k]) for k, n in ops.items())
    t_bytes = nbytes / HBM
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0].strip()


def cuda_ms(torch, fn, reps):
    """Median device time (ms) of one ``fn()`` call.

    Each call allocates its outputs, as a caller's would.  The two warm-up
    calls leave two output sets in the allocator's cache, so no timed call
    waits on cudaMalloc.  The timed calls are queued back to back, with a
    CUDA event between two calls, behind a few milliseconds of matrix
    products: the host runs ahead, so an event gap is the device's time for
    one call and not the wrapper's host time.  The median drops a call that
    a stall of the host or the card lengthened."""
    out = fn()
    out = fn()
    a = torch.ones((4096, 4096), device="cuda")
    b = torch.empty_like(a)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    torch.cuda.synchronize()
    for _ in range(4):
        torch.mm(a, a, out=b)
    events[0].record()
    for ev in events[1:]:
        out = fn()
        ev.record()
    torch.cuda.synchronize()
    times = sorted(e0.elapsed_time(e1) for e0, e1 in zip(events, events[1:]))
    return times[reps // 2], out


def host_ms(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0), out


def angle_err(torch, x, y):
    d = torch.remainder(x - y, 2 * math.pi)
    return torch.minimum(d, 2 * math.pi - d)


def check_buffer(torch, name, got, ref, is_angle):
    """rtol 1e-5 / atol 1e-4 on every element; returns the max abs error."""
    worst = 0.0
    for j, (x, y) in enumerate(zip(got, ref)):
        err = angle_err(torch, x, y) if is_angle[j] else (x - y).abs()
        bad = err > 1e-4 + 1e-5 * y.abs()
        if bool(bad.any()) or not bool(torch.isfinite(x).all()):
            raise AssertionError(f"{name}: output {j} off tolerance in {int(bad.sum())} "
                                 f"elements, max abs err {float(err.max()):.3e}")
        worst = max(worst, float(err.max()))
    return worst


def env_match(torch, got, ref, is_angle, n_envs):
    """Per-env match at rtol 1e-4 / atol 1e-4 over every output (and every
    step of a recording); returns (share of envs matching, max abs err)."""
    ok = torch.ones(n_envs, dtype=torch.bool, device=got[0].device)
    worst = 0.0
    for j, (x, y) in enumerate(zip(got, ref)):
        x, y = x.float(), y.float()
        err = angle_err(torch, x, y) if is_angle[j] else (x - y).abs()
        bad = (err > 1e-4 + 1e-4 * y.abs()) | ~torch.isfinite(x)
        # envs are the trailing N elements: (R,128), (2R,128) or (T,R,128)
        ok &= ~bad.reshape(-1, n_envs).any(dim=0)
        worst = max(worst, float(err.max()))
    return float(ok.float().mean()), worst


def run(dev, card):
    """Phases 2-6 on ``dev``; returns nothing, raises on any failure."""
    import numpy as np
    import sass_ops
    import torch

    import gym_electric_motor_tpu_torch as gt
    from gym_electric_motor_tpu_torch import references as rg
    from gym_electric_motor_tpu_torch.ops import cuda_build
    from gym_electric_motor_tpu_torch.ops import fused_sync as fs

    # ---- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    lib = cuda_build.build(["fused_pmsm"])["fused_pmsm"]
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in cuda_build.BUILD_LOG.get("fused_pmsm", "").splitlines()
             if "registers" in ln or "spill" in ln]
    counts = sass_ops.step_ops(lib, [f"{k}_kernel" for k in fs.KERNELS])
    ops = {k: counts[f"{k}_kernel"]["always"] for k in fs.KERNELS}
    emit({"phase": "build", "seconds": build_s, "ptxas": ptxas,
          "ops_per_step": {k: {"always": v["always"], "conditional": v["conditional"]}
                           for k, v in counts.items()}})

    R = N_ENVS // 128
    env = gt.make_functional("Finite-CC-PMSM-v0", device=dev)
    consts = fs.PmsmConsts(env)
    rng = np.random.default_rng(SEED)
    i_sd0 = torch.as_tensor(rng.uniform(-100, 100, (R, 128)).astype(np.float32), device=dev)
    i_sq0 = torch.as_tensor(rng.uniform(-100, 100, (R, 128)).astype(np.float32), device=dev)
    eps0 = torch.as_tensor(rng.uniform(0, 2 * np.pi, (R, 128)).astype(np.float32), device=dev)
    acts = torch.as_tensor(rng.integers(0, 8, (T_COMPARE, R, 128)).astype(np.int32), device=dev)
    state_bytes = 3 * 4 * N_ENVS

    # ---- 3. kernels against their plain versions -------------------------
    # (kernel, plain version, which outputs are angles, steps, bytes moved)
    results = {}
    cases = {
        "pmsm_rollout_buffer": (
            lambda: fs.pmsm_rollout_buffer(consts, i_sd0, i_sq0, eps0, acts),
            lambda: fs.pmsm_rollout_buffer_plain(consts, i_sd0, i_sq0, eps0, acts),
            (False, False, True, False, False), T_COMPARE,
            state_bytes + 4 * N_ENVS * T_COMPARE + 5 * 4 * N_ENVS),
        "pmsm_record_buffer": (
            lambda: fs.pmsm_record_buffer(consts, i_sd0, i_sq0, eps0, acts),
            lambda: fs.pmsm_record_buffer_plain(consts, i_sd0, i_sq0, eps0, acts),
            (False, False, True), T_COMPARE, state_bytes + 16 * N_ENVS * T_COMPARE),
        "pmsm_rollout_random": (
            lambda: fs.pmsm_rollout_random(consts, SEED, i_sd0, i_sq0, eps0, T_COMPARE),
            lambda: fs.pmsm_rollout_random_plain(consts, SEED, i_sd0, i_sq0, eps0, T_COMPARE),
            (False, False, True, False, False, False, False, False, False), T_COMPARE,
            state_bytes + 13 * 4 * N_ENVS),
        "pmsm_record_random": (
            lambda: fs.pmsm_record_random(consts, SEED, i_sd0, i_sq0, eps0, T_RECORD),
            lambda: fs.pmsm_record_random_plain(consts, SEED, i_sd0, i_sq0, eps0, T_RECORD),
            (False, False, True, False, False, False, False, False), T_RECORD,
            state_bytes + 32 * N_ENVS * T_RECORD),
    }
    for name, (kern, plain, is_angle, steps, nbytes) in cases.items():
        ms, got = cuda_ms(torch, kern, reps=21)
        plain_ms, ref = host_ms(torch, plain)
        b_ms, b_by = bound_ms(N_ENVS * steps, ops[name], nbytes)
        row = {"name": name, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
               "compare_envs": N_ENVS, "compare_steps": steps}
        if "buffer" in name:
            row["max_abs_err"] = check_buffer(torch, name, got, ref, is_angle)
            row["match_share"] = 1.0
        else:
            share, worst = env_match(torch, got, ref, is_angle, N_ENVS)
            r_idx = 3 if name == "pmsm_rollout_random" else 6
            mean_k, mean_p = float(got[r_idx].double().mean()), float(ref[r_idx].double().mean())
            rel = abs(mean_k - mean_p) / max(abs(mean_p), 1e-12)
            row.update(max_abs_err=worst, match_share=share, mean_reward=mean_k,
                       mean_reward_plain=mean_p, mean_reward_rel_err=rel)
            if share < 0.999 or rel > 1e-4:
                emit({"phase": "kernels", **row})
                raise AssertionError(f"{name}: {share:.5f} of envs match (need 0.999), "
                                     f"mean reward rel err {rel:.2e} (need 1e-4)")
        results[name] = row
        emit({"phase": "kernels", **row})
        del got, ref

    # ---- 4./5. the main path: counts from zero ---------------------------
    fs.reset_launches()

    # 4. env against the buffer kernels
    env_c = gt.make_functional("Finite-CC-PMSM-v0", device=dev, reference_generator=rg.ReferenceSpec(
        [rg.ConstReference("i_sd", 0.0), rg.ConstReference("i_sq", 0.0)]))
    venv = gt.VectorEnv(env_c, N_ENVS)
    state, _obs = venv.reset(SEED)
    env_acts = torch.as_tensor(rng.integers(0, 8, (T_ENV, R, 128)).astype(np.int32), device=dev)
    traj = []
    for t in range(T_ENV):
        state, _obs, _r, term = venv.step(state, env_acts[t].reshape(N_ENVS))
        if bool(term.any()):
            raise AssertionError("env path terminated under the buffer actions")
        traj.append(state.phys.ode_state[:, 1:4])
    ode = torch.stack(traj)  # (T, N, [i_sd, i_sq, eps])
    z = torch.zeros((R, 128), device=dev)
    roll_buf = fs.make_fused_pmsm_rollout(env_c, T_ENV, N_ENVS, action_mode="buffer")
    rec_buf = fs.make_fused_pmsm_record_rollout(env_c, T_ENV, N_ENVS, action_mode="buffer")
    k_final = roll_buf(z, z, z, env_acts)
    k_traj = rec_buf(z, z, z, env_acts)
    env_final = [ode[-1, :, j].reshape(R, 128) for j in range(3)]
    env_traj = [ode[:, :, j].reshape(T_ENV, R, 128) for j in range(3)]
    err_final = check_buffer(torch, "env vs pmsm_rollout_buffer", k_final[:3], env_final,
                             (False, False, True))
    err_traj = check_buffer(torch, "env vs pmsm_record_buffer", k_traj, env_traj,
                            (False, False, True))
    emit({"phase": "env", "envs": N_ENVS, "steps": T_ENV, "max_abs_err_rollout": err_final,
          "max_abs_err_record": err_traj})

    # 5. timings at the bench sizes
    env_w = gt.make_functional("Finite-CC-PMSM-v0", device=dev)
    venv_w = gt.VectorEnv(env_w, N_ENVS)
    state, _obs = venv_w.reset(SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    policy = gt.random_policy(8)
    venv_w.rollout(state, policy, 5, gen)  # warm-up
    gen_ms, (state, rsum, tsum) = host_ms(
        torch, lambda: venv_w.rollout(state, policy, T_GENERAL, gen))
    gen_mean_r = float(rsum.double().sum()) / (N_ENVS * T_GENERAL)
    gen_term = float(tsum.double().sum()) / (N_ENVS * T_GENERAL)
    if not math.isfinite(gen_mean_r) or not bool(torch.isfinite(state.phys.ode_state).all()):
        raise AssertionError("general path produced non-finite values")

    roll = fs.make_fused_pmsm_rollout(env_w, T_ROLLOUT, N_ENVS)
    roll_ms, out = cuda_ms(torch, lambda: roll(SEED, z, z, z), reps=5)
    i_sd, i_sq, eps, reward, terms, rv, rk, rl, rs = out
    margin = consts.f["margin"]
    checks = {
        "finite": all(bool(torch.isfinite(x).all()) for x in out),
        "eps_in_range": bool(((eps >= 0) & (eps < 2 * math.pi)).all()),
        "in_current_circle": bool((i_sd ** 2 + i_sq ** 2 <= 400.0 ** 2 * (1 + 1e-5)).all()),
        "ref_in_margin": bool((rv.abs() <= margin * 1.001).all()),
        "lengths": bool(((rl >= 500) & (rl < 2000) & (rk >= 1) & (rk <= rl)).all()),
        "sigma": bool(((rs >= 1e-3 * 0.999) & (rs <= 1e-1 * 1.001)).all()),
    }
    k_mean_r = float(reward.double().sum()) / (N_ENVS * T_ROLLOUT)
    k_term = float(terms.double().sum()) / (N_ENVS * T_ROLLOUT)

    rec = fs.make_fused_pmsm_record_rollout(env_w, T_RECORD, N_ENVS)
    rec_ms, rec_out = cuda_ms(torch, lambda: rec(SEED, z, z, z), reps=5)
    rec_bytes = sum(x.numel() * x.element_size() for x in rec_out)
    short = fs.make_fused_pmsm_rollout(env_w, T_RECORD, N_ENVS)(SEED, z, z, z)
    checks["record_equals_rollout"] = bool(
        torch.allclose(rec_out[6].sum(0), short[3], rtol=1e-4, atol=1e-3)
        and torch.equal(rec_out[0][-1], short[0]))
    # the same process in distribution: general path vs kernel (the bounds
    # of tests/test_pallas_rollout.py:202-204)
    short_r = float(short[3].double().sum()) / (N_ENVS * T_RECORD)
    checks["general_vs_kernel_reward"] = abs(gen_mean_r - short_r) < 0.05
    del rec_out, short

    launches = dict(fs.LAUNCHES)
    emit({"phase": "timings", "card": card,
          "general_path": {"envs": N_ENVS, "steps": T_GENERAL, "ms": gen_ms,
                           "env_steps_per_s": N_ENVS * T_GENERAL / (gen_ms / 1e3),
                           "mean_reward": gen_mean_r, "term_rate": gen_term},
          "pmsm_rollout_random": {"envs": N_ENVS, "steps": T_ROLLOUT, "ms": roll_ms,
                                  "env_steps_per_s": N_ENVS * T_ROLLOUT / (roll_ms / 1e3),
                                  "mean_reward": k_mean_r, "term_rate": k_term},
          "pmsm_record_random": {"envs": N_ENVS, "steps": T_RECORD, "ms": rec_ms,
                                 "bytes_written": rec_bytes,
                                 "env_steps_per_s": N_ENVS * T_RECORD / (rec_ms / 1e3),
                                 "GB_per_s": rec_bytes / (rec_ms / 1e3) / 1e9,
                                 "mean_reward_1024": short_r},
          "checks": checks, "launches": launches})
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"output checks failed: {failed}")
    missing = [k for k, v in launches.items() if v < 1]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")

    # ---- 6. kernels line -------------------------------------------------
    main_shape = {"pmsm_rollout_random": (T_ROLLOUT, roll_ms, state_bytes + 52 * N_ENVS),
                  "pmsm_record_random": (T_RECORD, rec_ms, state_bytes + 32 * N_ENVS * T_RECORD)}
    line = []
    for name in fs.KERNELS:
        r = results[name]
        row = {"name": name, "route": "cuda", "source": "gym_electric_motor_tpu_torch/csrc/fused_pmsm.cu",
               "replaces": {"pmsm_rollout_random": "gym_electric_motor_tpu/ops/pallas_sync.py:280",
                            "pmsm_rollout_buffer": "gym_electric_motor_tpu/ops/pallas_sync.py:297",
                            "pmsm_record_random": "gym_electric_motor_tpu/ops/pallas_sync.py:502",
                            "pmsm_record_buffer": "gym_electric_motor_tpu/ops/pallas_sync.py:392"}[name],
               "launches": launches[name], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
               "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
               "library_ms": None, "envs": N_ENVS, "steps": r["compare_steps"],
               "match_share": r["match_share"]}
        if name in main_shape:
            steps, ms, nbytes = main_shape[name]
            row["main_steps"], row["main_ms"] = steps, ms
            row["main_bound_ms"] = bound_ms(N_ENVS * steps, ops[name], nbytes)[0]
        line.append(row)
    print(json.dumps({"kernels": line}), flush=True)


def main():
    root = Path(__file__).resolve().parent
    if not (root / "gym_electric_motor_tpu_torch" / "csrc").is_dir():
        sys.exit("chip_smoke.py: gym_electric_motor_tpu_torch/ is not next to this script")
    sys.path[:0] = [str(root), str(root / "tools")]
    import torch

    # ---- 1. card ---------------------------------------------------------
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: torch.cuda.is_available() is false")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "card", "nvidia_smi": card, "kind": kind, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run(torch.device("cuda"), card)

    # ---- 7. card and result ----------------------------------------------
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
