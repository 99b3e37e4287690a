#!/usr/bin/env python3
"""Count the instructions one loop iteration of a CUDA kernel always
executes, by class, from the SASS of a built library (``cuobjdump -sass``).

Run on a machine with the CUDA toolkit, from the root of a checkout:

    python3 tools/sass_ops.py [kernel ...]

It builds the libraries of ``STEP_INSTANCES`` (``csrc/fused_pmsm.cu``,
``csrc/fused_policy.cu``, the six families' rollout and record sources,
their ``csrc/fused_<family>_policy.cu``, the three controller-in-the-loop
sources ``csrc/fused_foc.cu``, ``csrc/fused_dc_cascade.cu`` and
``csrc/fused_srm_cascade.cu`` and the specialised builders' five,
``csrc/fused_permex.cu``, ``csrc/fused_dc_sc.cu``, ``csrc/fused_scim_tc.cu``,
``csrc/fused_eesm_cc.cu`` and ``csrc/fused_dfim_cc.cu``, as the package does
at first use)
and prints one JSON line per kernel; a template instance is named by a
substring of its mangled name, e.g. ``policy_rollout_kernelILi16ELb0ELb1ELb0EE``
for H = 16, categorical, Wiener, mlp_forward's order.
    python3 tools/sass_ops.py --against OTHER LIBRARY [LIBRARY ...]

builds ``csrc/<LIBRARY>.cu`` of this tree and of the checkout OTHER (a
parent commit unpacked with ``git archive``) with the package's nvcc flags
and prints one JSON line per library: how many functions both listings
hold and how many of those are the same instruction for instruction (the
names of those that differ, and of those only one listing holds), and the
``STEP_INSTANCES`` entries that both listings hold with equal and with
different counts.  A change that must leave a kernel's SASS alone is held
to it that way.

With no argument it counts the instances of ``STEP_INSTANCES``, whose
counts ``chip_smoke.py`` takes for its bounds through :func:`step_ops`.

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
  FRND) and the bit counts;
* ``shfl`` (32): the warp shuffles (SHFL.IDX, .BFLY, .UP, .DOWN);
* ``smem`` (32): shared-memory loads and stores (LDS, STS, LDSM, STSM,
  ATOMS), one warp-wide access per clock: the guide's 32 banks of 32 bits
  a clock (its section on shared memory for compute capability 5.x and
  later, which 9.0 keeps); a wider or bank-conflicted access takes more;
* ``bar`` (16): barrier instructions (BAR.SYNC, BAR.ARV, BAR.RED), the
  guide's throughput of ``__syncthreads()`` (its section on
  synchronization instructions: 16 operations per clock for compute
  capability 7.x and later).

Moves (MOV, move idioms of IMAD and HFMA2), uniform-datapath instructions
(once per warp, not per thread), global and local memory and control
instructions are not counted, so the counts are a lower bound on the
issued work.  The ``smem`` and ``bar`` pipes are a kernel's layout, not
the function's work: ``chip_smoke.py`` leaves them out of a bound of the
function's own work and counts them in an issue bound.  The
blocks a step runs only sometimes (a branch taken on some data) are
reported apart, as ``conditional``.  A branch on the lane (its predicate
made of ``SR_TID.X`` or ``SR_LANEID``, immediates and constants alone,
such as a lane group's lead lane) is taken by some lane of every warp at
every step, and a warp issues both its sides, so a block under it counts
as always issued.  ``insns`` counts the same blocks' instructions one
each (an FFMA is one instruction, not two operations): at one
warp-instruction per scheduler and clock, four per SM, they give the
issue-slot floor, a lower bound since moves are not counted.  The loop
must hold one step per iteration: the kernels' step loops are marked ``#pragma unroll 1``.  A
loop nested in the step whose trip count is a launch parameter (the
universal policy recorders' loop over the H hidden units) is counted apart
where the instance's name ends in ``@inner``: a step then issues the outer
count plus H times the inner one.  A kernel that runs one env on a group
of G lanes (the SRM random rollout at constant speed and the PPO recorder
``policy_record`` between PPO's width and a full card, four lanes an env)
is marked ``@lanesG``: a warp then issues a lane's count for 32 / G envs,
so an env-step issues G times a lane's count, and ``step_ops`` multiplies
by G.  That is what the lanes issue, work that every lane repeats
included; the function's own work is the one-thread step's count.  A
warp-specialised kernel (the sync, DC, SCIM, EESM and DFIM random rollouts,
csrc/draw_ring.cuh; the policy evaluation rollout, the specialised DC SC,
Cont-TC-SCIM, Finite-CC-EESM and Cont-CC-DFIM rollouts, the DC cascade and
the FOC, the SRM, DC, EESM, synchronous, SCIM and DFIM random recorders,
csrc/ring_pipe.cuh) is marked ``@wsK``: its consumer warps run
a step loop (one step an iteration, shared-memory loads) and its producer warps
a loop whose iteration fills a ring slot of K steps (shared-memory
stores, the K steps unrolled); an env-step issues the consumer's count
plus the producer's over K, and both stay beside it under ``roles``.  The
REINFORCE rollout splits its roles otherwise (csrc/reinforce_split.cuh)
and is marked ``@rsT``: its step warp runs a step loop that stores each
step's operands into the ring, and T trace warps per step warp each run a
loop over the same steps that reads them (both one step an iteration; the
trace loop may store its gradient sums in shared memory too, so the larger
of the two outermost loops is taken as the step loop), so an env-step
issues the step loop's count plus T times the trace loop's, both kept
under ``roles`` as ``step`` and ``trace``.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_ANON = re.compile(r"_ZN\d+_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]{8}")
_SKIP = ("MOV", "CS2R", "S2R", "S2UR", "NOP", "BRA", "BSSY", "BSYNC", "EXIT", "CALL", "RET",
         "LD", "ST", "BAR", "WARPSYNC", "DEPBAR", "YIELD", "P2R", "R2P", "PLOP3", "RED", "ATOM",
         "MEMBAR", "ERRBAR", "CCTL", "BPT", "BMOV", "KILL", "NANOSLEEP", "VOTE", "PRMT")
_CONV = ("I2F", "F2I", "F2F", "FRND", "FLO", "POPC", "BREV")
_SMEM = ("LDS", "STS", "LDSM", "STSM", "ATOMS")
_SMEM_STORE = ("STS", "STSM", "ATOMS")
CLASSES = ("fp32", "alu", "imad", "xu", "shfl", "smem", "bar")
# issue rate per SM and clock of each class (operations for fp32)
RATE_PER_SM_CLOCK = {"fp32": 256, "alu": 64, "imad": 64, "xu": 16, "shfl": 32, "smem": 32,
                     "bar": 16}
# thread-instructions an SM issues per clock: four schedulers, one
# warp-instruction each
ISSUE_PER_SM_CLOCK = 4 * 32


def issue_floor_ms(env_steps, insns, sms, clock):
    """The issue-slot floor (ms) of ``env_steps`` steps of ``insns``
    counted instructions each (``insns`` of the counts), on ``sms`` SMs at
    ``clock`` Hz."""
    return 1e3 * env_steps * insns / (sms * clock * ISSUE_PER_SM_CLOCK)


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
    if base in _SMEM:
        return "smem", 1
    if base == "BAR":
        return "bar", 1
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
    if base == "SHFL":
        return "shfl", 1
    return "alu", 1


def _target(args):
    for a in args:
        if a.startswith("0x") or a.startswith("`"):
            return int(a.strip("`()"), 16)
    return None


def loop_counts(insns, second=False, inner=False) -> dict:
    """Always-executed and conditional counts of the main loop's body, or
    (``second``) of the largest loop outside it: a random kernel's step loop
    without the reference advance, which it takes when every reference is
    constant.  With ``inner`` the largest loop nested in that body (the
    policy recorders' hidden-unit loop, whose trip count is a launch
    parameter) is counted apart, as ``inner`` (its own always-executed and
    conditional counts per iteration), and left out of the outer counts."""
    addr = [a for a, *_ in insns]
    back = [(i, _target(args)) for i, (a, _p, op, args) in enumerate(insns)
            if op.startswith("BRA") and _target(args) is not None and _target(args) <= a]
    if not back:
        raise ValueError("no loop in this function")
    latch_i, head = max(back, key=lambda b: addr[b[0]] - b[1])
    if second:
        lo_m, hi_m = head, addr[latch_i]
        back = [b for b in back if addr[b[0]] < lo_m or b[1] > hi_m]
        if not back:
            raise ValueError("no second loop in this function")
        latch_i, head = max(back, key=lambda b: addr[b[0]] - b[1])
    skip = None
    out_inner = None
    if inner:
        nested = [b for b in back if head < b[1] and addr[b[0]] < addr[latch_i]]
        if not nested:
            raise ValueError("no loop nested in the main loop")
        i_latch, i_head = max(nested, key=lambda b: addr[b[0]] - b[1])
        skip = (i_head, addr[i_latch])
        out_inner = _body_counts(insns, addr, i_head, i_latch, None)
    out = _body_counts(insns, addr, head, latch_i, skip)
    if out_inner is not None:
        out["inner"] = {"always": out_inner["always"], "conditional": out_inner["conditional"],
                        "insns": out_inner["insns"]}
    return out


def _ws_role(body) -> str | None:
    """The role of a loop of a warp-specialised kernel from its body: the
    producer's stores the ring (shared-memory stores), the consumer's only
    loads it; None for a loop that touches no shared memory."""
    bases = {op.split(".")[0] for _a, _p, op, _args in body}
    if bases & set(_SMEM_STORE):
        return "producer"
    if bases & set(_SMEM):
        return "consumer"
    return None


def ws_counts(insns, steps, second=False) -> dict:
    """The counts of a warp-specialised kernel per env-step: the
    consumer's step loop plus the producer's slot loop over ``steps`` (the
    steps a producer iteration fills).  Each role's loop is the largest of
    its role, or (``second``) the largest of its role outside that one, as
    in ``loop_counts``; ``roles`` keeps each role's own counts (the
    producer's per iteration)."""
    addr = [a for a, *_ in insns]
    loops = {"consumer": [], "producer": []}
    for i, (a, _p, op, args) in enumerate(insns):
        t = _target(args) if op.startswith("BRA") else None
        if t is None or t > a:
            continue
        role = _ws_role(insns[addr.index(t):i + 1])
        if role:
            loops[role].append((i, t))
    out = {"always": dict.fromkeys(CLASSES, 0), "conditional": dict.fromkeys(CLASSES, 0),
           "insns": {"always": 0.0, "conditional": 0.0}, "roles": {}}
    for role, back in loops.items():
        if not back:
            raise ValueError(f"no {role} loop in this function")
        latch_i, head = max(back, key=lambda b: addr[b[0]] - b[1])
        if second:
            lo_m, hi_m = head, addr[latch_i]
            back = [b for b in back if addr[b[0]] < lo_m or b[1] > hi_m]
            if not back:
                raise ValueError(f"no second {role} loop in this function")
            latch_i, head = max(back, key=lambda b: addr[b[0]] - b[1])
        c = _body_counts(insns, addr, head, latch_i, None)
        per = steps if role == "producer" else 1
        for kind in ("always", "conditional"):
            for cls, n in c[kind].items():
                out[kind][cls] += n / per
            out["insns"][kind] += c["insns"][kind] / per
        out["roles"][role] = {"always": c["always"], "conditional": c["conditional"],
                              "insns": c["insns"], "steps": per,
                              "opcodes_always": c["opcodes_always"]}
    return out


def rs_counts(insns, trace) -> dict:
    """The counts of a role-split kernel (``@rsT``) per env-step.  Its two
    largest loops that nest in no other loop are the step warp's (the
    larger, one step an iteration) and a trace warp's (one step an
    iteration, ``trace`` warps serving an env): an env-step issues the
    first's count once and the second's ``trace`` times; ``roles`` keeps
    each as ``step`` and ``trace``."""
    addr = [a for a, *_ in insns]
    back = [(i, _target(args)) for i, (a, _p, op, args) in enumerate(insns)
            if op.startswith("BRA") and _target(args) is not None and _target(args) <= a]
    outer = [b for b in back
             if not any(o != b and o[1] <= b[1] and addr[b[0]] <= addr[o[0]] for o in back)]
    if len(outer) < 2:
        raise ValueError("a role split needs a step loop and a trace loop")
    step, tr = sorted(outer, key=lambda b: addr[b[0]] - b[1], reverse=True)[:2]
    out = {"always": dict.fromkeys(CLASSES, 0), "conditional": dict.fromkeys(CLASSES, 0),
           "insns": {"always": 0, "conditional": 0}, "roles": {}}
    for role, (latch_i, head), weight in (("step", step, 1), ("trace", tr, trace)):
        c = _body_counts(insns, addr, head, latch_i, None)
        for kind in ("always", "conditional"):
            for cls, n in c[kind].items():
                out[kind][cls] += n * weight
            out["insns"][kind] += c["insns"][kind] * weight
        out["roles"][role] = {"always": c["always"], "conditional": c["conditional"],
                              "insns": c["insns"], "steps": 1, "warps_per_env": weight,
                              "opcodes_always": c["opcodes_always"]}
    return out


_PRED = re.compile(r"^P[0-6]$")
_REG = re.compile(r"^R[0-9]+$")
_LANE_SR = ("SR_TID.X", "SR_LANEID")
_DATA_OPS = ("LD", "SHFL", "ATOM", "RED", "VOTE", "MATCH", "S2UR", "CS2R", "R2UR")


def _operand(a) -> str:
    """A register or predicate name, 'lane', 'const' or 'data'."""
    a = a.strip().lstrip("!-~|").rstrip("|")
    if a in ("RZ", "PT", "URZ", "UPT") or a.startswith(("c[", "0x", "-0x")):
        return "const"
    if a in _LANE_SR:
        return "lane"
    if a.startswith(("SR_", "UR", "UP", "[")):
        return "data"
    base = a.split(".")[0]
    if _REG.match(base) or _PRED.match(base):
        return base
    try:
        float(a.replace("INF", "inf").replace("QNAN", "nan"))
        return "const"
    except ValueError:
        return "data"


def _dests(op, args) -> int:
    """How many leading operands an instruction writes."""
    base = op.split(".")[0]
    if base.endswith("SETP") or base in ("PLOP3", "SHFL"):
        return 2
    if len(args) > 1 and _PRED.match(args[1].strip()) and base in ("IADD3", "LEA", "IMAD"):
        return 2
    return 1


def _reaching(insns, lo, blocks, preds, head_b):
    """Reaching definitions in the loop body from ``insns[lo]`` (``blocks``:
    (offset in the body, instructions)), the back edge and the last
    definition before the loop included: per block, ``{register: set of
    instruction indices}`` at its entry."""
    entry = {}
    for i in range(lo):
        _a, _p, op, args = insns[i]
        for d in args[:_dests(op, args)]:
            r = _operand(d)
            if r not in ("const", "lane", "data"):
                entry[r] = i
    gen = []
    for blk_start, blk in blocks:
        g = {}
        for j in range(len(blk)):
            _a, _p, op, args = blk[j]
            for d in args[:_dests(op, args)]:
                r = _operand(d)
                if r not in ("const", "lane", "data"):
                    g[r] = lo + blk_start + j
        gen.append(g)
    n = len(blocks)
    out = [dict() for _ in range(n)]
    inn = [dict() for _ in range(n)]
    changed = True
    while changed:
        changed = False
        for b in range(n):
            acc = {}
            srcs = [out[q] for q in preds[b]]
            if b == head_b:
                srcs.append({r: {i} for r, i in entry.items()})
            for m in srcs:
                for r, ds in m.items():
                    acc.setdefault(r, set()).update(ds)
            o = {r: set(ds) for r, ds in acc.items()}
            for r, i in gen[b].items():
                o[r] = {i}
            if acc != inn[b] or o != out[b]:
                inn[b], out[b], changed = acc, o, True
    return inn


def _lane_branches(insns, lo, blocks, preds, head_b) -> set:
    """The blocks (indices into ``blocks``) that end in a branch on the
    lane: a predicate whose every reaching definition is made of the lane
    index, immediates and constants alone."""
    inn = _reaching(insns, lo, blocks, preds, head_b)
    block_at = {}
    for b, (start, blk) in enumerate(blocks):
        for j in range(len(blk)):
            block_at[lo + start + j] = b
    memo = {}

    def defs_at(i, reg):
        if i not in block_at:  # before the loop: the last definition in program order
            for k in range(i - 1, -1, -1):
                _a, _p, op, args = insns[k]
                if any(_operand(d) == reg for d in args[:_dests(op, args)]):
                    return {k}
            return set()
        b = block_at[i]
        start = lo + blocks[b][0]
        for k in range(i - 1, start - 1, -1):
            _a, _p, op, args = insns[k]
            if any(_operand(d) == reg for d in args[:_dests(op, args)]):
                return {k}
        return set(inn[b].get(reg, ()))

    def lane_only(i, depth=0):
        if i in memo:
            return memo[i]
        if depth > 24:
            return False
        memo[i] = False  # a cycle through the back edge is not lane-only
        _a, pred, op, args = insns[i]
        base = op.split(".")[0]
        ok = not (pred and _operand(pred.lstrip("@")) not in ("const",)) \
            and not base.startswith(_DATA_OPS)
        if ok and base == "S2R":
            ok = args[1].strip() in _LANE_SR
        elif ok:
            for a in args[_dests(op, args):]:
                r = _operand(a)
                if r == "data":
                    ok = False
                elif r not in ("const", "lane"):
                    ds = defs_at(i, r)
                    ok = bool(ds) and all(lane_only(k, depth + 1) for k in ds)
                if not ok:
                    break
        memo[i] = ok
        return ok

    out = set()
    for b, (start, blk) in enumerate(blocks):
        _a, pred, op, _args = blk[-1]
        if not (op.startswith("BRA") and pred):
            continue
        reg = _operand(pred.lstrip("@"))
        if reg in ("const", "lane", "data"):
            continue
        i = lo + start + len(blk) - 1
        ds = defs_at(i, reg)
        if ds and all(lane_only(k) for k in ds):
            out.add(b)
    return out


def _issued_every_step(blocks_succ, latch_b, lane_b) -> set:
    """The blocks some lane of every warp runs at every step: a block is
    avoidable if the step can reach the latch without it, choosing a side
    of every branch on data but taking both sides of every branch on the
    lane (least fixed point)."""
    n = len(blocks_succ)
    always = set()
    for t in range(n):
        av = [False] * n
        av[latch_b] = latch_b != t
        changed = True
        while changed:
            changed = False
            for b in range(n):
                if b in (t, latch_b) or av[b] or not blocks_succ[b]:
                    continue
                side = [av[x] for x in blocks_succ[b]]
                if all(side) if b in lane_b else any(side):
                    av[b], changed = True, True
        if not av[0]:
            always.add(t)
    return always


def _body_counts(insns, addr, head, latch_i, skip) -> dict:
    """The counts of one loop's body from ``head`` to the backward branch
    at index ``latch_i``; instructions at addresses in the range ``skip``
    (a nested loop) are left out."""
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
    # the loop's own back edge
    preds[0] = preds[0] + [block_of[len(body) - 1]]
    lane_b = _lane_branches(insns, lo, list(zip(starts, blocks)), preds, 0)
    if lane_b:
        always = _issued_every_step(succ, block_of[len(body) - 1], lane_b)

    def counted(a):
        return skip is None or not skip[0] <= a <= skip[1]

    out = {"always": dict.fromkeys(CLASSES, 0), "conditional": dict.fromkeys(CLASSES, 0),
           "insns": {"always": 0, "conditional": 0}, "lane_branches": len(lane_b)}
    for b, blk in enumerate(blocks):
        kind = "always" if b in always else "conditional"
        for a, _p, op, args in blk:
            cls, k = classify(op, args)
            if cls and counted(a):
                out[kind][cls] += k
                out["insns"][kind] += 1
    out["opcodes_always"] = {}
    for b in sorted(always):
        for a, _p, op, args in blocks[b]:
            if classify(op, args)[0] and counted(a):
                out["opcodes_always"][op] = out["opcodes_always"].get(op, 0) + 1
    return out


def cuobjdump() -> str:
    from gym_electric_motor_tpu_torch.ops import cuda_build

    return str(Path(cuda_build.find_nvcc()).parent / "cuobjdump")


def lib_functions(lib_path) -> dict:
    """``functions()`` of ``cuobjdump -sass lib_path``."""
    return functions(subprocess.run([cuobjdump(), "-sass", str(lib_path)], capture_output=True,
                                    text=True, timeout=120, check=True).stdout)


def step_ops(lib_path, kernels) -> dict:
    """``instance_counts`` of the listing of ``cuobjdump -sass lib_path``."""
    return instance_counts(lib_functions(lib_path), kernels, str(lib_path))


def ws_steps_of(instance) -> int:
    """The steps a producer iteration fills of a ``STEP_INSTANCES`` entry:
    K for a name ending in ``@wsK``, else 0 (not warp-specialised)."""
    mark = instance.partition("@")[2]
    if not mark.startswith("ws"):
        return 0
    steps = int(mark[len("ws"):])
    if steps < 1:
        raise ValueError(f"{instance!r}: a producer iteration fills at least one step")
    return steps


def trace_warps_of(instance) -> int:
    """The trace warps per step warp of a ``STEP_INSTANCES`` entry: T for a
    name ending in ``@rsT``, else 0 (not a role split)."""
    mark = instance.partition("@")[2]
    if not mark.startswith("rs"):
        return 0
    warps = int(mark[len("rs"):])
    if warps < 1:
        raise ValueError(f"{instance!r}: a role split has at least one trace warp")
    return warps


def lanes_of(instance) -> int:
    """The lanes per env of a ``STEP_INSTANCES`` entry: G for a name
    ending in ``@lanesG``, else 1."""
    mark = instance.partition("@")[2]
    if not mark.startswith("lanes"):
        return 1
    lanes = int(mark[len("lanes"):])
    if lanes < 1 or 32 % lanes:
        raise ValueError(f"{instance!r}: a lane group must divide the warp")
    return lanes


def instance_counts(funcs, kernels, where="the listing") -> dict:
    """``{kernel: loop_counts(...)}`` for each kernel whose mangled name
    holds the given substring, in ``funcs`` (``functions()``); a substring
    ending in ``#2`` counts the second loop, one ending in ``@inner`` the
    main loop's nested loop apart (``loop_counts``), one ending in
    ``@lanesG`` a lane-group kernel: its counts are per env-step, G times
    a lane's, which ``per_lane`` keeps beside ``lanes``; one ending in
    ``@wsK`` a warp-specialised kernel (``ws_counts``, with ``ws_steps``
    K beside); one ending in ``@rsT`` a role-split kernel (``rs_counts``,
    with ``ws_steps`` 1 and ``trace_warps`` T beside)."""
    out = {}
    for k in kernels:
        sub, _, nested = k.partition("@")
        sub, mark, _ = sub.partition("#")
        names = [f for f in funcs if sub in f]
        if len(names) != 1:
            raise ValueError(f"{sub!r} matches {len(names)} functions of {where}")
        warps = trace_warps_of(k)
        if warps:
            counts = rs_counts(funcs[names[0]], warps)
            counts["ws_steps"] = 1
            counts["trace_warps"] = warps
            out[k] = counts
            continue
        steps = ws_steps_of(k)
        if steps:
            counts = ws_counts(funcs[names[0]], steps, second=bool(mark))
            counts["ws_steps"] = steps
            out[k] = counts
            continue
        counts = loop_counts(funcs[names[0]], second=bool(mark), inner=nested == "inner")
        lanes = lanes_of(k)
        if lanes > 1:
            counts["lanes"] = lanes
            counts["per_lane"] = {key: counts[key] for key in ("always", "conditional", "insns")}
            for key in ("always", "conditional", "insns"):
                counts[key] = {c: lanes * n for c, n in counts[key].items()}
        out[k] = counts
    return out


# the template instance whose step each kernel's bound counts (a substring
# of its mangled name), by library; chip_smoke.py takes its bounds from these
STEP_INSTANCES = {
    # The Finite-CC-PMSM random rollout runs pmsm_rollout_ws_kernel (K = 8,
    # two producer warps per consumer warp: @ws4) and the random recorder
    # pmsm_record_ws_kernel (@ws K / P of PMSM_RECORD_RING); their one-thread
    # kernels are built for the count of the function's own work and never
    # launched
    "fused_pmsm": {**{k: f"{k}_kernel" for k in ("pmsm_rollout_random", "pmsm_rollout_buffer",
                                                  "pmsm_record_random", "pmsm_record_buffer")},
                   "pmsm_rollout_ws": "pmsm_rollout_ws_kernel@ws4",
                   "pmsm_record_ws": "pmsm_record_ws_kernel@ws4"},
    # policy_record runs on lane groups below a full card,
    # policy_record_lanes_kernel<H, G, LEAD>: four lanes an env, every lane
    # stepping (@lanes4: the count a step issues), and at PPO's width eight
    # lanes with lane 0 alone stepping, a branch on the lane that every warp
    # issues (@lanes8).  policy_rollout runs policy_rollout_ws_kernel<H,
    # GREEDY> with Wiener references (two producer warps per consumer warp,
    # K = 8: @ws4), and with constant ones policy_rollout_kernel<H, GREEDY,
    # WIENER, VEC>, greedy at H 16 in mlp_forward_vec's loop order (/vec).
    # The one-thread instances in mlp_forward's order (VEC 0) count the
    # function's own work.  reinforce_rollout runs reinforce_split_kernel<H,
    # GREEDY, WIENER>, at H 16 two trace warps per step warp (@rs2); its
    # one-thread kernel, built at H 16 (categorical, Wiener) and never
    # launched, counts the function's own work
    "fused_policy": {
        # H 16, categorical, Wiener
        "policy_rollout": "policy_rollout_kernelILi16ELb0ELb1ELb0EE",
        "policy_rollout_ws": "policy_rollout_ws_kernelILi16ELb0E@ws4",
        # H 16, greedy, constant references
        "policy_rollout/greedy/const": "policy_rollout_kernelILi16ELb1ELb0ELb0EE",
        "policy_rollout/greedy/const/vec": "policy_rollout_kernelILi16ELb1ELb0ELb1EE",
        "policy_record": "policy_record_kernelILi32E",  # H 32
        "policy_record_lanes": "policy_record_lanes_kernelILi32ELi4ELb0E@lanes4",
        "policy_record_lanes/8": "policy_record_lanes_kernelILi32ELi8ELb1E@lanes8",
        "reinforce_rollout": "reinforce_rollout_kernelILi16ELb0ELb1E",
        "reinforce_split": "reinforce_split_kernelILi16ELb0ELb1E@rs2",
        "reinforce_reduce": "reinforce_reduce_kernel",
    },
    # <FINITE, MECH, NREF>: Cont-SC-PMSM-v0 (0, 1, 1) for each kernel, and
    # Finite-CC-PMSM-v0 (1, 0, 2) and Cont-CC-PMSM-v0 (0, 0, 2) for the
    # random ones.  With Wiener references the random rollout runs
    # sync_rollout_ws_kernel<FINITE, MECH, NREF, RingShape<8, 2>> (two
    # producer warps per consumer warp, four steps a producer iteration:
    # @ws4); with constant ones the one-thread kernel's second loop, which
    # draws the next step's action ahead (timed on Finite-CC-PMSM-v0, #2).
    # The one-thread kernel's Wiener loop counts the function's own work
    "fused_sync": {
        "sync_rollout_random": "sync_rollout_random_kernelILb0ELb1ELi1E",
        "sync_rollout_buffer": "sync_rollout_buffer_kernelILb0ELb1E",
        "sync_record_random": "sync_record_random_kernelILb0ELb1ELi1E",
        "sync_record_buffer": "sync_record_buffer_kernelILb0ELb1E",
        "sync_rollout_random/Finite-CC-PMSM-v0": "sync_rollout_random_kernelILb1ELb0ELi2E",
        "sync_rollout_random/Cont-CC-PMSM-v0": "sync_rollout_random_kernelILb0ELb0ELi2E",
        "sync_record_random/Finite-CC-PMSM-v0": "sync_record_random_kernelILb1ELb0ELi2E",
        "sync_rollout_ws": "sync_rollout_ws_kernelILb0ELb1ELi1E9RingShapeILi8ELi2EE@ws4",
        "sync_rollout_ws/Finite-CC-PMSM-v0":
            "sync_rollout_ws_kernelILb1ELb0ELi2E9RingShapeILi8ELi2EE@ws4",
        "sync_rollout_ws/Cont-CC-PMSM-v0":
            "sync_rollout_ws_kernelILb0ELb0ELi2E9RingShapeILi8ELi2EE@ws4",
        "sync_rollout_random/Finite-CC-PMSM-v0/const": "sync_rollout_random_kernelILb1ELb0ELi2E#2",
        # With Wiener references the random recorder runs sync_record_ws_kernel
        # (K = 8, two producer warps per consumer warp: @ws4); its one-thread
        # Wiener loop is built for the count of the function's own work
        "sync_record_ws": "sync_record_ws_kernelILb0ELb1ELi1E@ws4",
        "sync_record_ws/Finite-CC-PMSM-v0": "sync_record_ws_kernelILb1ELb0ELi2E@ws4",
    },
    # <FINITE, MECH, MC, NREF> (MC: 0 one current, 1 ShuntDc, 2 ExtExDc):
    # Cont-SC-ShuntDc-v0 (0, 1, 1, 1) for each kernel, and
    # Finite-CC-PermExDc-v0 (1, 0, 0, 1) and Cont-SC-PermExDc-v0 (0, 1, 0, 1)
    # for the random ones.  With Wiener references the random rollout runs
    # dc_rollout_ws_kernel, warp-specialised, a producer iteration two steps
    # (@ws2: what its two roles issue per env-step); with constant ones the
    # one-thread kernel's second loop (#2).  The one-thread Wiener loop is
    # built but never run, and counts the function's own work
    "fused_dc": {
        "dc_rollout_random": "dc_rollout_random_kernelILb0ELb1ELi1ELi1E",
        "dc_rollout_buffer": "dc_rollout_buffer_kernelILb0ELb1ELi1E",
        "dc_rollout_random/Finite-CC-PermExDc-v0": "dc_rollout_random_kernelILb1ELb0ELi0ELi1E",
        "dc_rollout_random/Cont-SC-PermExDc-v0": "dc_rollout_random_kernelILb0ELb1ELi0ELi1E",
        # its loop without the reference advance: constant references
        "dc_rollout_random/Finite-CC-PermExDc-v0/const":
            "dc_rollout_random_kernelILb1ELb0ELi0ELi1E#2",
        "dc_rollout_ws": "dc_rollout_ws_kernelILb0ELb1ELi1ELi1E@ws2",
        "dc_rollout_ws/Finite-CC-PermExDc-v0": "dc_rollout_ws_kernelILb1ELb0ELi0ELi1E@ws2",
    },
    # With Wiener references the random recorder runs dc_record_ws_kernel
    # (K = 8, two producer warps per consumer warp: @ws4); its one-thread
    # Wiener loop is built for the count of the function's own work
    "fused_dc_record": {
        "dc_record_random": "dc_record_random_kernelILb0ELb1ELi1ELi1E",
        "dc_record_buffer": "dc_record_buffer_kernelILb0ELb1ELi1E",
        "dc_record_random/Finite-CC-PermExDc-v0": "dc_record_random_kernelILb1ELb0ELi0ELi1E",
        "dc_record_ws": "dc_record_ws_kernelILb0ELb1ELi1ELi1E@ws4",
        "dc_record_ws/Finite-CC-PermExDc-v0": "dc_record_ws_kernelILb1ELb0ELi0ELi1E@ws4",
    },
    # <FINITE, MECH, NREF>: Cont-SC-SCIM-v0 (0, 1, 1) for each kernel, and
    # Cont-TC-SCIM-v0 (0, 0, 1) and Finite-CC-SCIM-v0 (1, 0, 2) for the
    # random ones.  With Wiener references the random rollout runs
    # induction_rollout_ws_kernel<FINITE, MECH, NREF>, as the DC and EESM
    # ones (K = 8, two producer warps per consumer warp, four steps a
    # producer iteration: @ws4); with constant ones the one-thread kernel's
    # second loop, which draws the next step's action ahead (timed on
    # Cont-TC-SCIM-v0, #2).  The one-thread kernel's Wiener loop, which the
    # launch does not take, counts the function's own work
    "fused_induction": {
        "induction_rollout_random": "induction_rollout_random_kernelILb0ELb1ELi1E",
        "induction_rollout_buffer": "induction_rollout_buffer_kernelILb0ELb1E",
        "induction_rollout_random/Cont-TC-SCIM-v0": "induction_rollout_random_kernelILb0ELb0ELi1E",
        "induction_rollout_random/Finite-CC-SCIM-v0":
            "induction_rollout_random_kernelILb1ELb0ELi2E",
        "induction_rollout_ws": "induction_rollout_ws_kernelILb0ELb1ELi1E@ws4",
        "induction_rollout_ws/Cont-TC-SCIM-v0": "induction_rollout_ws_kernelILb0ELb0ELi1E@ws4",
        "induction_rollout_ws/Finite-CC-SCIM-v0": "induction_rollout_ws_kernelILb1ELb0ELi2E@ws4",
        "induction_rollout_random/Cont-TC-SCIM-v0/const":
            "induction_rollout_random_kernelILb0ELb0ELi1E#2",
    },
    "fused_induction_record": {
        "induction_record_random": "induction_record_random_kernelILb0ELb1ELi1E",
        "induction_record_buffer": "induction_record_buffer_kernelILb0ELb1E",
        "induction_record_random/Finite-CC-SCIM-v0": "induction_record_random_kernelILb1ELb0ELi2E",
        # With Wiener references the random recorder runs
        # induction_record_ws_kernel (K = 8, two producer warps per consumer
        # warp: @ws4); its one-thread Wiener loop is built for the count of
        # the function's own work
        "induction_record_ws": "induction_record_ws_kernelILb0ELb1ELi1E@ws4",
        "induction_record_ws/Finite-CC-SCIM-v0": "induction_record_ws_kernelILb1ELb0ELi2E@ws4",
    },
    # <FINITE, MECH, NREF>: Cont-SC-EESM-v0 (0, 1, 1) for each kernel, and
    # Cont-TC-EESM-v0 (0, 0, 1) and Finite-CC-EESM-v0 (1, 0, 3) for the
    # random ones.  With Wiener references the random rollout runs
    # eesm_rollout_ws_kernel, as the DC family's (@ws2 at constant speed,
    # @ws4 under the speed ODE, one producer warp per consumer warp); with
    # constant ones eesm_rollout_ahead_kernel, one thread per env (timed on
    # Finite-CC-EESM-v0, beside the one-thread kernel's second loop).  The
    # one-thread instances are built but never launched, and count the
    # function's own work
    "fused_eesm": {
        "eesm_rollout_random": "eesm_rollout_random_kernelILb0ELb1ELi1E",
        "eesm_rollout_buffer": "eesm_rollout_buffer_kernelILb0ELb1E",
        "eesm_rollout_random/Cont-TC-EESM-v0": "eesm_rollout_random_kernelILb0ELb0ELi1E",
        "eesm_rollout_random/Finite-CC-EESM-v0": "eesm_rollout_random_kernelILb1ELb0ELi3E",
        "eesm_rollout_ws": "eesm_rollout_ws_kernelILb0ELb1ELi1E@ws4",
        "eesm_rollout_ws/Cont-TC-EESM-v0": "eesm_rollout_ws_kernelILb0ELb0ELi1E@ws2",
        "eesm_rollout_ws/Finite-CC-EESM-v0": "eesm_rollout_ws_kernelILb1ELb0ELi3E@ws2",
        "eesm_rollout_random/Finite-CC-EESM-v0/const": "eesm_rollout_random_kernelILb1ELb0ELi3E#2",
        "eesm_rollout_ahead/Finite-CC-EESM-v0/const": "eesm_rollout_ahead_kernelILb1ELb0ELi3E",
    },
    # With Wiener references the random recorder runs eesm_record_ws_kernel
    # (K = 8, two producer warps per consumer warp: @ws4); its one-thread
    # Wiener loop is built for the count of the function's own work
    "fused_eesm_record": {
        "eesm_record_random": "eesm_record_random_kernelILb0ELb1ELi1E",
        "eesm_record_buffer": "eesm_record_buffer_kernelILb0ELb1E",
        "eesm_record_random/Finite-CC-EESM-v0": "eesm_record_random_kernelILb1ELb0ELi3E",
        "eesm_record_ws": "eesm_record_ws_kernelILb0ELb1ELi1E@ws4",
        "eesm_record_ws/Finite-CC-EESM-v0": "eesm_record_ws_kernelILb1ELb0ELi3E@ws4",
    },
    # <FINITE, MECH, NREF>: Cont-SC-DFIM-v0 (0, 1, 1) for each kernel, and
    # Cont-CC-DFIM-v0 (0, 0, 2) and Finite-CC-DFIM-v0 (1, 0, 2) for the
    # random ones.  With Wiener references the random rollout runs
    # dfim_rollout_ws_kernel<FINITE, MECH, NREF> (K = 8, two producer warps
    # per consumer warp: @ws4); with constant ones the one-thread kernel.
    # Its Wiener loop, which the launch does not take, counts the function's
    # own work
    "fused_dfim": {
        "dfim_rollout_random": "dfim_rollout_random_kernelILb0ELb1ELi1E",
        "dfim_rollout_buffer": "dfim_rollout_buffer_kernelILb0ELb1E",
        "dfim_rollout_random/Cont-CC-DFIM-v0": "dfim_rollout_random_kernelILb0ELb0ELi2E",
        "dfim_rollout_random/Finite-CC-DFIM-v0": "dfim_rollout_random_kernelILb1ELb0ELi2E",
        "dfim_rollout_ws": "dfim_rollout_ws_kernelILb0ELb1ELi1E@ws4",
        "dfim_rollout_ws/Cont-CC-DFIM-v0": "dfim_rollout_ws_kernelILb0ELb0ELi2E@ws4",
        "dfim_rollout_ws/Finite-CC-DFIM-v0": "dfim_rollout_ws_kernelILb1ELb0ELi2E@ws4",
    },
    # With Wiener references the random recorder runs dfim_record_ws_kernel
    # (K = 8, two producer warps per consumer warp: @ws4); its one-thread
    # Wiener loop is built for the count of the function's own work
    "fused_dfim_record": {
        "dfim_record_random": "dfim_record_random_kernelILb0ELb1ELi1E",
        "dfim_record_buffer": "dfim_record_buffer_kernelILb0ELb1E",
        "dfim_record_random/Cont-CC-DFIM-v0": "dfim_record_random_kernelILb0ELb0ELi2E",
        "dfim_record_ws": "dfim_record_ws_kernelILb0ELb1ELi1E@ws4",
        "dfim_record_ws/Cont-CC-DFIM-v0": "dfim_record_ws_kernelILb0ELb0ELi2E@ws4",
    },
    # <FINITE, MECH, NREF, SAT> (<FINITE, MECH, SAT> for the buffer kernels),
    # linear: Cont-SC-SRM-v0 (0, 1, 1, 0) for each kernel, and
    # Finite-CC-SRM-v0 (1, 0, 3, 0), Finite-TC-SRM-v0 (1, 0, 1, 0) and
    # Finite-SC-SRM-v0 (1, 1, 1, 0) for the random ones.  At constant speed
    # (the CC and TC ids) the random rollout runs srm_rollout_lanes_kernel
    # <FINITE, NREF, SAT>, four lanes an env (@lanes4: the count a step
    # issues); the one-thread instances of those two ids are built but never
    # launched, and count the function's own work
    "fused_srm": {
        "srm_rollout_random": "srm_rollout_random_kernelILb0ELb1ELi1ELb0E",
        "srm_rollout_buffer": "srm_rollout_buffer_kernelILb0ELb1ELb0E",
        "srm_rollout_random/Finite-CC-SRM-v0": "srm_rollout_random_kernelILb1ELb0ELi3ELb0E",
        "srm_rollout_random/Finite-TC-SRM-v0": "srm_rollout_random_kernelILb1ELb0ELi1ELb0E",
        "srm_rollout_random/Finite-SC-SRM-v0": "srm_rollout_random_kernelILb1ELb1ELi1ELb0E",
        "srm_rollout_lanes/Finite-CC-SRM-v0": "srm_rollout_lanes_kernelILb1ELi3ELb0E@lanes4",
        "srm_rollout_lanes/Finite-TC-SRM-v0": "srm_rollout_lanes_kernelILb1ELi1ELb0E@lanes4",
    },
    # With Wiener references the random recorder's continuous instances run
    # srm_record_ws_kernel<FINITE, MECH, NREF, SAT> (K = 8, two producer
    # warps per consumer warp: @ws4), the finite ones the one-thread kernel,
    # whose Wiener loop counts the function's own work
    "fused_srm_record": {
        "srm_record_random": "srm_record_random_kernelILb0ELb1ELi1ELb0E",
        "srm_record_buffer": "srm_record_buffer_kernelILb0ELb1ELb0E",
        "srm_record_random/Finite-CC-SRM-v0": "srm_record_random_kernelILb1ELb0ELi3ELb0E",
        "srm_record_ws": "srm_record_ws_kernelILb0ELb1ELi1ELb0E@ws4",
    },
    # The universal policy recorders, one instance per family (and the
    # other ids chip_smoke.py times), the hidden-unit loop counted apart
    # (@inner: a step runs it H times): <FINITE, MECH, NREF> for the sync
    # and induction families, <FINITE, MECH, MC, NREF, JOINT> for the DC,
    # <FINITE, MECH, NREF, JOINT> for the EESM and DFIM, <FINITE, MECH,
    # NREF, SAT, JOINT> for the SRM family
    # sync_policy_record runs on lane groups below a full card, as the DC
    # family's: sync_policy_record_lanes_kernel<FINITE, MECH, NREF, G, LEAD>,
    # eight lanes, every lane stepping, in its wide and its narrow design
    # alike (@lanes8, the /8 entry)
    "fused_sync_policy": {  # Finite-CC-PMSM-v0
        "sync_policy_record": "sync_policy_record_kernelILb1ELb0ELi2EE@inner",
        "sync_policy_record_lanes/8":
            "sync_policy_record_lanes_kernelILb1ELb0ELi2ELi8ELb0EE@lanes8",
    },
    # dc_policy_record runs on lane groups below a full card,
    # dc_policy_record_lanes_kernel<FINITE, MECH, MC, NREF, JOINT, G, LEAD>:
    # at PPO's width eight lanes, every lane stepping (@lanes8), then four
    # lanes with lane 0 alone stepping (@lanes4, a branch on the lane that
    # every warp issues).  A lane's hidden slots run under a predicate on the
    # run-time H, which the count takes as a branch on data: the MLP's
    # hidden units stay conditional, so these counts bound what a step
    # issues from below.  The one-thread kernel counts the function's own
    # work
    "fused_dc_policy": {
        "dc_policy_record": "dc_policy_record_kernelILb1ELb0ELi0ELi1ELb0EE@inner",
        "dc_policy_record/Cont-CC-PermExDc-v0":
            "dc_policy_record_kernelILb0ELb0ELi0ELi1ELb0EE@inner",
        "dc_policy_record_lanes":
            "dc_policy_record_lanes_kernelILb1ELb0ELi0ELi1ELb0ELi4ELb1EE@lanes4",
        "dc_policy_record_lanes/8":
            "dc_policy_record_lanes_kernelILb1ELb0ELi0ELi1ELb0ELi8ELb0EE@lanes8",
        "dc_policy_record_lanes/8/Cont-CC-PermExDc-v0":
            "dc_policy_record_lanes_kernelILb0ELb0ELi0ELi1ELb0ELi8ELb0EE@lanes8",
    },
    # eesm_policy_record, srm_policy_record, dfim_policy_record and
    # induction_policy_record run on lane groups below a full card, as the
    # sync family's:
    # eesm_policy_record_lanes_kernel<FINITE, MECH, NREF, JOINT, G, LEAD>,
    # srm_policy_record_lanes_kernel<FINITE, MECH, NREF, SAT, JOINT, G, LEAD>,
    # dfim_policy_record_lanes_kernel<FINITE, MECH, NREF, JOINT, G, LEAD> and
    # induction_policy_record_lanes_kernel<FINITE, MECH, NREF, G, LEAD>,
    # eight lanes in the wide and the narrow design alike (@lanes8, the /8
    # entries), on the ids chip_smoke.py times
    "fused_induction_policy": {  # Finite-CC-SCIM-v0
        "induction_policy_record": "induction_policy_record_kernelILb1ELb0ELi2EE@inner",
        "induction_policy_record_lanes/8":
            "induction_policy_record_lanes_kernelILb1ELb0ELi2ELi8ELb0EE@lanes8",
    },
    "fused_eesm_policy": {  # Finite-CC-EESM-v0
        "eesm_policy_record": "eesm_policy_record_kernelILb1ELb0ELi3ELb0EE@inner",
        "eesm_policy_record_lanes/8":
            "eesm_policy_record_lanes_kernelILb1ELb0ELi3ELb0ELi8ELb0EE@lanes8",
    },
    "fused_dfim_policy": {  # Finite-CC-DFIM-v0, factorised and joint heads
        "dfim_policy_record": "dfim_policy_record_kernelILb1ELb0ELi2ELb0EE@inner",
        "dfim_policy_record/joint": "dfim_policy_record_kernelILb1ELb0ELi2ELb1EE@inner",
        "dfim_policy_record_lanes/8":
            "dfim_policy_record_lanes_kernelILb1ELb0ELi2ELb0ELi8ELb0EE@lanes8",
        "dfim_policy_record_lanes/8/joint":
            "dfim_policy_record_lanes_kernelILb1ELb0ELi2ELb1ELi8ELb0EE@lanes8",
    },
    "fused_srm_policy": {  # Cont-SC-SRM-v0
        "srm_policy_record": "srm_policy_record_kernelILb0ELb1ELi1ELb0ELb0EE@inner",
        "srm_policy_record_lanes/8":
            "srm_policy_record_lanes_kernelILb0ELb1ELi1ELb0ELb0ELi8ELb0EE@lanes8",
    },
    # The controller-in-the-loop kernels, each the instance with the
    # reference advance (WIENER true, the last template argument: the
    # catalog's Wiener references): <WIENER> for the FOC on Cont-CC-PMSM-v0;
    # <OPS, WIENER> (OPS 0 PermExDc, 1 SeriesDc, 2 ShuntDc) for the DC
    # cascade on Cont-SC-PermExDc-v0; <TASK, FINITE, SAT, WIENER> (TASK 0
    # CC, 1 TC, 2 SC) for the SRM cascade on Finite-SC-SRM-v0 and
    # Finite-TC-SRM-v0.  chip_smoke.py times each beside the open-loop
    # universal kernel on the same id, whose instances the "/<id>" entries
    # of fused_sync, fused_dc and fused_srm count.  With Wiener references
    # the DC cascade runs dc_cascade_rollout_ws_kernel<OPS> (K = 4, two
    # producer warps per consumer warp: @ws2), on the three motors, and the
    # FOC foc_rollout_ws_kernel (K = 8, two producer warps: @ws4); their
    # one-thread instances are built for the count of the function's own
    # work and never launched
    "fused_foc": {"foc_rollout": "foc_rollout_kernelILb1EE",
                  "foc_rollout_ws": "foc_rollout_ws_kernel@ws4"},
    "fused_dc_cascade": {
        "dc_cascade_rollout": "dc_cascade_rollout_kernelILi0ELb1EE",
        "dc_cascade_rollout/Cont-SC-SeriesDc-v0": "dc_cascade_rollout_kernelILi1ELb1EE",
        "dc_cascade_rollout/Cont-SC-ShuntDc-v0": "dc_cascade_rollout_kernelILi2ELb1EE",
        "dc_cascade_rollout_ws": "dc_cascade_rollout_ws_kernelILi0E@ws2",
        "dc_cascade_rollout_ws/Cont-SC-SeriesDc-v0": "dc_cascade_rollout_ws_kernelILi1E@ws2",
        "dc_cascade_rollout_ws/Cont-SC-ShuntDc-v0": "dc_cascade_rollout_ws_kernelILi2E@ws2",
    },
    "fused_srm_cascade": {
        "srm_cascade_rollout": "srm_cascade_rollout_kernelILi2ELb1ELb0ELb1EE",
        "srm_cascade_rollout/Finite-TC-SRM-v0": "srm_cascade_rollout_kernelILi1ELb1ELb0ELb1EE",
    },
    # The specialised builders' kernels, with their own baked constants and
    # draw order: the Finite-CC-PermExDc rollout and recorder, the DC SC
    # kernels (<NEL>: 1 SeriesDc, 2 ShuntDc; Cont-SC-ShuntDc-v0 for each
    # kernel, Cont-SC-SeriesDc-v0 for the random one), Cont-TC-SCIM,
    # Finite-CC-EESM and Cont-CC-DFIM.  chip_smoke.py times each random
    # kernel beside the universal kernel on the same id
    # The PermExDc random rollout runs permex_rollout_ws_kernel (K = 8, two
    # producer warps per consumer warp: @ws4) and the random recorder
    # permex_record_ws_kernel (@ws K / P of PERMEX_RECORD_RING); their
    # one-thread kernels are built for the count of the function's own work
    # and never launched
    "fused_permex": {**{k: f"{k}_kernel" for k in ("permex_rollout_random",
                                                    "permex_rollout_buffer",
                                                    "permex_record_random",
                                                    "permex_record_buffer")},
                     "permex_rollout_ws": "permex_rollout_ws_kernel@ws4",
                     "permex_record_ws": "permex_record_ws_kernel@ws4"},
    # The DC SC random rollout runs dc_sc_rollout_ws_kernel<NEL> (K = 8, two
    # producer warps per consumer warp: @ws4); its one-thread kernel is built
    # for the count of the function's own work and never launched
    "fused_dc_sc": {
        "dc_sc_rollout_random": "dc_sc_rollout_random_kernelILi2E",
        "dc_sc_rollout_buffer": "dc_sc_rollout_buffer_kernelILi2E",
        "dc_sc_rollout_random/Cont-SC-SeriesDc-v0": "dc_sc_rollout_random_kernelILi1E",
        "dc_sc_rollout_ws": "dc_sc_rollout_ws_kernelILi2E@ws4",
        "dc_sc_rollout_ws/Cont-SC-SeriesDc-v0": "dc_sc_rollout_ws_kernelILi1E@ws4",
    },
    # The Cont-TC-SCIM random rollout runs scim_rollout_ws_kernel (K = 8, two
    # producer warps per consumer warp: @ws4); its one-thread kernel is
    # built for the count of the function's own work and never launched
    "fused_scim_tc": {
        "scim_rollout_random": "scim_rollout_random_kernel",
        "scim_rollout_buffer": "scim_rollout_buffer_kernel",
        "scim_rollout_ws": "scim_rollout_ws_kernel@ws4",
    },
    # The Finite-CC-EESM random rollout runs eesm_cc_rollout_ws_kernel (K = 4,
    # two producer warps per consumer warp: @ws2); its one-thread kernel is
    # built for the count of the function's own work and never launched
    "fused_eesm_cc": {
        "eesm_cc_rollout_random": "eesm_cc_rollout_random_kernel",
        "eesm_cc_rollout_buffer": "eesm_cc_rollout_buffer_kernel",
        "eesm_cc_rollout_ws": "eesm_cc_rollout_ws_kernel@ws2",
    },
    # The Cont-CC-DFIM random rollout runs dfim_cc_rollout_ws_kernel (K = 8,
    # two producer warps per consumer warp: @ws4); its one-thread kernel is
    # built for the count of the function's own work and never launched
    "fused_dfim_cc": {
        "dfim_cc_rollout_random": "dfim_cc_rollout_random_kernel",
        "dfim_cc_rollout_buffer": "dfim_cc_rollout_buffer_kernel",
        "dfim_cc_rollout_ws": "dfim_cc_rollout_ws_kernel@ws4",
    },
}


def against(other: Path, libraries) -> list:
    """This tree's ``csrc/<library>.cu`` against the checkout ``other``'s,
    both built with the package's nvcc flags (the other's into
    ``<other>/_ab_build``): per library, the functions both listings hold,
    those equal instruction for instruction and those that differ, those only
    one holds, and the ``STEP_INSTANCES`` entries both hold with equal and
    with different counts."""
    import concurrent.futures

    from gym_electric_motor_tpu_torch.ops import cuda_build

    csrc = other / "gym_electric_motor_tpu_torch" / "csrc"
    (other / "_ab_build").mkdir(exist_ok=True)

    def build_other(library):
        out = other / "_ab_build" / f"lib{library}.so"
        subprocess.run([cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-I", str(csrc), "-o",
                        str(out), str(csrc / f"{library}.cu")], check=True, capture_output=True)
        return out

    with concurrent.futures.ThreadPoolExecutor(len(libraries) + 1) as pool:
        theirs = pool.map(build_other, libraries)
        ours = cuda_build.build(list(libraries))
        theirs = dict(zip(libraries, theirs))
    def named(lib_path):
        # the anonymous namespace's mangled name carries a hash of the
        # source's path, so the two trees' names differ there alone
        return {_ANON.sub("_ZN_anon_", f): body for f, body in lib_functions(lib_path).items()}

    rows = []
    for library in libraries:
        mine, base = named(ours[library]), named(theirs[library])
        both = sorted(set(mine) & set(base))
        differ = [f for f in both if mine[f] != base[f]]
        counts = {"equal": [], "differ": []}
        for key, inst in STEP_INSTANCES.get(library, {}).items():
            sub = inst.partition("@")[0].partition("#")[0]
            if any(sub in f for f in mine) and any(sub in f for f in base):
                same = instance_counts(mine, [inst]) == instance_counts(base, [inst])
                counts["equal" if same else "differ"].append(key)
        rows.append({"library": library, "functions_in_both": len(both),
                     "functions_equal": len(both) - len(differ), "functions_differ": differ,
                     "only_this": sorted(set(mine) - set(base)),
                     "only_other": sorted(set(base) - set(mine)),
                     "counts_equal": counts["equal"], "counts_differ": counts["differ"]})
    return rows


def main():
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from gym_electric_motor_tpu_torch.ops import cuda_build

    if sys.argv[1:2] == ["--against"]:
        for row in against(Path(sys.argv[2]).resolve(), sys.argv[3:]):
            print(json.dumps(row), flush=True)
        return

    libs = cuda_build.build(list(STEP_INSTANCES))
    for name, lib in libs.items():
        kernels = list(STEP_INSTANCES[name].values())
        if sys.argv[1:]:
            funcs = lib_functions(lib)
            kernels = [k for k in sys.argv[1:]
                       if any(k.partition("@")[0].partition("#")[0] in f for f in funcs)]
        for k, v in step_ops(lib, kernels).items():
            print(json.dumps({"kernel": k, **v}), flush=True)


if __name__ == "__main__":
    main()
