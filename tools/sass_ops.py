#!/usr/bin/env python3
"""Count the instructions one loop iteration of a CUDA kernel always
executes, by class, from the SASS of a built library (``cuobjdump -sass``).

Run on a machine with the CUDA toolkit, from the root of a checkout:

    python3 tools/sass_ops.py [kernel substring ...]

It builds ``csrc/fused_pmsm.cu`` (as the package does at first use) and
prints one JSON line per kernel.  ``chip_smoke.py`` calls
:func:`step_ops` to take the operation counts of its bounds.

Method.  The kernel's main loop is the one whose backward branch spans the
most code.  Its basic blocks are split at branch targets and after
branches; a block runs in every iteration exactly when it dominates the
block holding the backward branch (the loop has one entry and no other
exit).  The instructions of those blocks are counted by the pipe that
issues them on Hopper, at its rate per SM and clock (the CUDA C++
Programming Guide's throughput table for compute capability 9.0):

* ``fp32``: FFMA counts 2 operations, FADD and FMUL 1 (128 lanes, so
  67 TFLOP/s at 132 SMs and 1.98 GHz);
* ``alu`` (64): integer add, logic and shifts, compares, min/max and
  selects, integer and float alike (IADD3, LOP3, SHF, LEA, ISETP, FSETP,
  FSEL, FMNMX, I2FP, ...);
* ``imad`` (64): integer multiplies (IMAD, IMAD.WIDE, IMAD.HI), which
  issue on half of the FP32 lanes;
* ``xu`` (16): MUFU (rsqrt, exp2, ...) and conversions (I2F, F2I, F2F,
  FRND) and the bit counts.

Moves (MOV, move idioms of IMAD and HFMA2), uniform-datapath instructions
(once per warp, not per thread), memory, barrier and control instructions
are not counted, so the counts are a lower bound on the issued work.  The
blocks a step runs only sometimes (a branch taken on some data) are
reported apart, as ``conditional``.  The loop must hold one step per
iteration: the kernels' step loops are marked ``#pragma unroll 1``.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_SKIP = ("MOV", "CS2R", "S2R", "S2UR", "NOP", "BRA", "BSSY", "BSYNC", "EXIT", "CALL", "RET",
         "LD", "ST", "BAR", "WARPSYNC", "DEPBAR", "YIELD", "P2R", "R2P", "PLOP3", "RED", "ATOM",
         "MEMBAR", "ERRBAR", "CCTL", "BPT", "BMOV", "KILL", "NANOSLEEP", "VOTE", "SHFL", "PRMT")
_CONV = ("I2F", "F2I", "F2F", "FRND", "FLO", "POPC", "BREV")
CLASSES = ("fp32", "alu", "imad", "xu")
# issue rate per SM and clock of each class (operations for fp32)
RATE_PER_SM_CLOCK = {"fp32": 256, "alu": 64, "imad": 64, "xu": 16}


def functions(sass: str) -> dict:
    """``{mangled name: [(address, predicate, opcode, operands), ...]}``."""
    out, cur = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            cur = out.setdefault(line.split("Function :", 1)[1].strip(), [])
            continue
        m = _INSN.search(line)
        if cur is None or not m:
            continue
        text = m.group(2).strip()
        pred = ""
        if text.startswith("@"):
            pred, text = text.split(None, 1)
        op, _, rest = text.partition(" ")
        cur.append((int(m.group(1), 16), pred, op, [x.strip() for x in rest.split(",") if x.strip()]))
    return out


def classify(op: str, args) -> tuple:
    """``(class, operations)`` of one instruction, or ``(None, 0)``."""
    base = op.split(".")[0]
    if base.startswith("U"):
        return None, 0  # uniform datapath: one per warp
    if base.startswith(_SKIP) or base == "HFMA2":
        return None, 0
    if base == "IMAD":
        if args[1:3] == ["RZ", "RZ"]:
            return None, 0  # IMAD.MOV / IMAD.U32 Rd, RZ, RZ, x: a move
        return "imad", 1
    if base == "FFMA":
        return "fp32", 2
    if base in ("FADD", "FMUL"):
        return "fp32", 1
    if base == "MUFU" or base in _CONV:
        return "xu", 1
    return "alu", 1


def _target(args):
    for a in args:
        if a.startswith("0x") or a.startswith("`"):
            return int(a.strip("`()"), 16)
    return None


def loop_counts(insns) -> dict:
    """Always-executed and conditional counts of the main loop's body."""
    addr = [a for a, *_ in insns]
    back = [(i, _target(args)) for i, (a, _p, op, args) in enumerate(insns)
            if op.startswith("BRA") and _target(args) is not None and _target(args) <= a]
    if not back:
        raise ValueError("no loop in this function")
    latch_i, head = max(back, key=lambda b: addr[b[0]] - b[1])
    lo, hi = addr.index(head), latch_i
    body = insns[lo:hi + 1]
    # basic blocks: leaders at the head, branch targets and after branches
    leaders = {0}
    for j, (a, _p, op, args) in enumerate(body):
        if op.startswith(("BRA", "EXIT", "RET")):
            leaders.add(j + 1)
            t = _target(args)
            if t is not None and head <= t <= addr[hi]:
                leaders.add(addr.index(t) - lo)
    starts = sorted(x for x in leaders if x < len(body))
    block_of = {}
    blocks = []
    for b, s in enumerate(starts):
        e = starts[b + 1] if b + 1 < len(starts) else len(body)
        blocks.append(body[s:e])
        for j in range(s, e):
            block_of[j] = b
    succ = []
    for b, blk in enumerate(blocks):
        a, pred, op, args = blk[-1]
        nxt = [b + 1] if b + 1 < len(blocks) else []
        if op.startswith("BRA"):
            t = _target(args)
            tgt = [block_of[addr.index(t) - lo]] if t is not None and head <= t <= addr[hi] \
                and t != head else []
            succ.append(tgt + (nxt if pred else []))
        elif op.startswith(("EXIT", "RET")):
            succ.append(nxt if pred else [])
        else:
            succ.append(nxt)
    # dominators from the head (iterative data flow)
    n = len(blocks)
    preds = [[p for p in range(n) if b in succ[p]] for b in range(n)]
    dom = [set(range(n)) for _ in range(n)]
    dom[0] = {0}
    changed = True
    while changed:
        changed = False
        for b in range(1, n):
            ps = [dom[p] for p in preds[b]]
            new = ({b} | set.intersection(*ps)) if ps else {b}
            if new != dom[b]:
                dom[b], changed = new, True
    always = dom[block_of[len(body) - 1]]
    out = {"always": dict.fromkeys(CLASSES, 0), "conditional": dict.fromkeys(CLASSES, 0)}
    for b, blk in enumerate(blocks):
        kind = "always" if b in always else "conditional"
        for _a, _p, op, args in blk:
            cls, k = classify(op, args)
            if cls:
                out[kind][cls] += k
    out["opcodes_always"] = {}
    for b in sorted(always):
        for _a, _p, op, args in blocks[b]:
            if classify(op, args)[0]:
                out["opcodes_always"][op] = out["opcodes_always"].get(op, 0) + 1
    return out


def cuobjdump() -> str:
    from gym_electric_motor_tpu_torch.ops import cuda_build

    return str(Path(cuda_build.find_nvcc()).parent / "cuobjdump")


def step_ops(lib_path, kernels) -> dict:
    """``{kernel: loop_counts(...)}`` for each kernel whose mangled name
    holds the given substring, from ``cuobjdump -sass lib_path``."""
    sass = subprocess.run([cuobjdump(), "-sass", str(lib_path)], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    funcs = functions(sass)
    out = {}
    for k in kernels:
        names = [f for f in funcs if k in f]
        if len(names) != 1:
            raise ValueError(f"{k!r} matches {len(names)} functions of {lib_path}")
        out[k] = loop_counts(funcs[names[0]])
    return out


def main():
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from gym_electric_motor_tpu_torch.ops import cuda_build

    kernels = sys.argv[1:] or ["pmsm_rollout_random_kernel", "pmsm_rollout_buffer_kernel",
                               "pmsm_record_random_kernel", "pmsm_record_buffer_kernel"]
    lib = cuda_build.build(["fused_pmsm"])["fused_pmsm"]
    for k, v in step_ops(lib, kernels).items():
        print(json.dumps({"kernel": k, **v}), flush=True)


if __name__ == "__main__":
    main()
