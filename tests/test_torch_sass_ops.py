"""tools/sass_ops.py: the per-step instruction counts behind the fused
kernels' bounds, on a hand-written SASS listing in cuobjdump's format.

The loop below runs from 0x0020 to its backward branch at 0x00c0; the
block 0x0050-0x0060 is skipped when P0 holds, so it is conditional, and
everything else in the loop runs every iteration.  Counts are exact
integers, so the test compares them exactly.
"""

import re
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
import sass_ops  # noqa: E402

from gym_electric_motor_tpu_torch.ops import fused_dc as fd  # noqa: E402
from gym_electric_motor_tpu_torch.ops import fused_dc_family as dcf  # noqa: E402
from gym_electric_motor_tpu_torch.ops import fused_dfim_family as dff  # noqa: E402
from gym_electric_motor_tpu_torch.ops import fused_eesm_family as ef  # noqa: E402
from gym_electric_motor_tpu_torch.ops import fused_induction_family as indf  # noqa: E402
from gym_electric_motor_tpu_torch.ops import fused_policy as fp  # noqa: E402
from gym_electric_motor_tpu_torch.ops import fused_srm_family as srf  # noqa: E402
from gym_electric_motor_tpu_torch.ops import fused_sync as fs  # noqa: E402
from gym_electric_motor_tpu_torch.ops import fused_sync_family as sf  # noqa: E402

SASS = """
        Function : _Z4stepPfi
        .headerflags    @"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   S2R R0, SR_TID.X ;                 /* 0x0000000000007919 */
                                                                      /* 0x000e220000002100 */
        /*0010*/                   MOV R1, RZ ;                       /* 0x000000ff00017202 */
        /*0020*/                   FFMA R2, R2, R3, R4 ;              /* 0x0000000302027223 */
        /*0030*/                   ISETP.GT.AND P0, PT, R2, RZ, PT ;  /* 0x000000ff0200720c */
        /*0040*/               @P0 BRA 0x70 ;                         /* 0x0000000000000947 */
        /*0050*/                   MUFU.EX2 R5, R2 ;                  /* 0x0000000200057308 */
        /*0060*/                   IMAD.WIDE.U32 R6, R5, 0x3, RZ ;    /* 0x0000000305067825 */
        /*0070*/                   FADD R2, R2, R5 ;                  /* 0x0000000502027221 */
        /*0080*/                   IMAD.MOV.U32 R7, RZ, RZ, R2 ;      /* 0x000000ffff077224 */
        /*0090*/                   UIADD3 UR4, UR4, 0x1, URZ ;        /* 0x0000000104047890 */
        /*00a0*/                   FSEL R8, R2, RZ, P0 ;              /* 0x000000ff02087208 */
        /*00b0*/                   ISETP.NE.AND P1, PT, R0, UR4, PT ; /* 0x0000000400007c0c */
        /*00c0*/               @P1 BRA 0x20 ;                         /* 0x0000000000001947 */
        /*00d0*/                   EXIT ;                             /* 0x000000000000794d */
"""


def test_loop_counts_split_always_from_conditional():
    funcs = sass_ops.functions(SASS)
    assert list(funcs) == ["_Z4stepPfi"]
    counts = sass_ops.loop_counts(funcs["_Z4stepPfi"])
    # FFMA (2) + FADD (1); ISETP, FSEL, ISETP; the move and the uniform
    # add are not counted
    assert counts["always"] == {"fp32": 3, "alu": 3, "imad": 0, "xu": 0, "shfl": 0, "smem": 0, "bar": 0}
    assert counts["conditional"] == {"fp32": 0, "alu": 0, "imad": 1, "xu": 1, "shfl": 0, "smem": 0, "bar": 0}


@pytest.mark.parametrize("op,args,want", [
    ("FFMA", ["R1", "R2", "R3", "R4"], ("fp32", 2)),
    ("FMUL", ["R1", "R2", "R3"], ("fp32", 1)),
    ("LOP3.LUT", ["R1", "R2", "R3", "R4", "0x96", "!PT"], ("alu", 1)),
    ("I2FP.F32.S32", ["R1", "R2"], ("alu", 1)),
    ("IMAD.HI.U32", ["R1", "R2", "R3", "RZ"], ("imad", 1)),
    ("IMAD.U32", ["R1", "RZ", "RZ", "UR4"], (None, 0)),
    ("MUFU.RSQ", ["R1", "R2"], ("xu", 1)),
    ("FRND.FLOOR", ["R1", "R2"], ("xu", 1)),
    ("HFMA2.MMA", ["R1", "-RZ", "RZ", "0", "0"], (None, 0)),
    ("STG.E", ["desc[UR4][R2.64]", "R5"], (None, 0)),
    ("SHFL.BFLY", ["PT", "R3", "R2", "0x1", "0x1f"], ("shfl", 1)),
    ("SHFL.IDX", ["PT", "R5", "R4", "R7", "0x1c1f"], ("shfl", 1)),
    ("LDS", ["R3", "[R2+0x200]"], ("smem", 1)),
    ("LDS.64", ["R4", "[R2]"], ("smem", 1)),
    ("STS", ["[R2+0x400]", "R5"], ("smem", 1)),
    ("BAR.SYNC.DEFER_BLOCKING", ["R2", "0x100"], ("bar", 1)),
    ("BAR.ARV", ["R3", "0x100"], ("bar", 1)),
    ("LDG.E", ["R1", "desc[UR4][R2.64]"], (None, 0)),
])
def test_classify(op, args, want):
    assert sass_ops.classify(op, args) == want


SASS_TWO_LOOPS = """
        Function : _Z3twoPfi
        /*0000*/                   S2R R0, SR_TID.X ;
        /*0010*/               @P2 BRA 0x60 ;
        /*0020*/                   FFMA R2, R2, R3, R4 ;
        /*0030*/                   MUFU.EX2 R5, R2 ;
        /*0040*/                   ISETP.NE.AND P1, PT, R0, UR4, PT ;
        /*0050*/               @P1 BRA 0x20 ;
        /*0060*/                   FADD R2, R2, R5 ;
        /*0070*/                   ISETP.NE.AND P1, PT, R0, UR4, PT ;
        /*0080*/               @P1 BRA 0x60 ;
        /*0090*/                   EXIT ;
"""


def test_second_loop_counts_the_loop_outside_the_main_one():
    """A random kernel's two step loops (with and without the reference
    advance): ``second`` counts the smaller one, and ``step_ops`` reads it
    from a substring ending in #2."""
    insns = sass_ops.functions(SASS_TWO_LOOPS)["_Z3twoPfi"]
    assert sass_ops.loop_counts(insns)["always"] == {"fp32": 2, "alu": 1, "imad": 0, "xu": 1,
                                                     "shfl": 0, "smem": 0, "bar": 0}
    assert sass_ops.loop_counts(insns, second=True)["always"] == {"fp32": 1, "alu": 1, "imad": 0,
                                                                  "xu": 0, "shfl": 0, "smem": 0, "bar": 0}


SASS_NESTED = """
        Function : _Z6nestedPfi
        /*0000*/                   S2R R0, SR_TID.X ;
        /*0010*/                   FMUL R2, R2, R3 ;
        /*0020*/                   ISETP.GE.AND P0, PT, R7, 0x1, PT ;
        /*0030*/               @!P0 BRA 0x80 ;
        /*0040*/                   FADD R4, R4, R5 ;
        /*0050*/                   FMUL R5, R5, R6 ;
        /*0060*/                   MUFU.TANH R6, R4 ;
        /*0070*/               @P1 BRA 0x40 ;
        /*0080*/                   FFMA R2, R2, R3, R4 ;
        /*0090*/                   ISETP.NE.AND P1, PT, R0, UR4, PT ;
        /*00a0*/               @P1 BRA 0x10 ;
        /*00b0*/                   EXIT ;
"""


def test_nested_loop_counts_apart():
    """The policy recorders' hidden-unit loop (its trip count a launch
    parameter) nested in the step loop: ``inner`` counts its body per
    iteration and the outer counts leave it out, so that a step issues the
    outer count plus H times the inner one."""
    insns = sass_ops.functions(SASS_NESTED)["_Z6nestedPfi"]
    counts = sass_ops.loop_counts(insns, inner=True)
    assert counts["always"] == {"fp32": 3, "alu": 2, "imad": 0, "xu": 0, "shfl": 0, "smem": 0, "bar": 0}
    assert counts["inner"]["always"] == {"fp32": 2, "alu": 0, "imad": 0, "xu": 1, "shfl": 0, "smem": 0, "bar": 0}
    # without `inner` the nested body counts once, as conditional (the guard skips it)
    plain = sass_ops.loop_counts(insns)
    assert plain["always"] == counts["always"] and "inner" not in plain
    assert plain["conditional"] == {"fp32": 2, "alu": 0, "imad": 0, "xu": 1, "shfl": 0, "smem": 0, "bar": 0}
    with pytest.raises(ValueError, match="nested"):
        sass_ops.loop_counts(sass_ops.functions(SASS)["_Z4stepPfi"], inner=True)


def _template_arity(source, kernel):
    """The number of template parameters of ``__global__ void kernel`` in a
    CUDA source (0 for a plain kernel)."""
    m = re.search(r"(?:template\s*<([^>]*)>\s*)?__global__\s+void\s+"
                  r"(?:__launch_bounds__\([^)]*\)\s*)?" + kernel + r"\s*\(", source)
    assert m, f"no __global__ {kernel} in the source"
    return 0 if m.group(1) is None else m.group(1).count(",") + 1


def _mangled_args(args, i):
    """Parse a mangled template argument list from ``args[i]`` (just after
    its ``I``): ``(count, index after its closing E)``; literals ``L...E``
    and named types, a named type with its own arguments counting once."""
    n = 0
    while i < len(args) and args[i] != "E":
        if args[i] == "L":
            i = args.index("E", i) + 1
        else:
            m = re.match(r"\d+", args[i:])
            i += len(m.group()) + int(m.group())
            if i < len(args) and args[i] == "I":
                i = _mangled_args(args, i + 1)[1]
        n += 1
    return n, i + 1


def _mangled_arity(args):
    """The number of template arguments in a mangled list ``I...E`` (its
    closing ``E`` may be cut off)."""
    return _mangled_args(args, 1 if args.startswith("I") else 0)[0]


CSRC = Path(__file__).resolve().parent.parent / "gym_electric_motor_tpu_torch" / "csrc"


@pytest.mark.parametrize("library", sorted(sass_ops.STEP_INSTANCES))
def test_step_instances_name_kernels_of_their_sources(library):
    """Every ``STEP_INSTANCES`` entry parses: a kernel defined in
    ``csrc/<library>.cu`` with as many template arguments in the mangled
    substring as the kernel has template parameters, and at most one loop
    mark (``#2``, ``@inner``, a lane group's ``@lanesG``, a
    warp-specialised kernel's ``@ws2`` or ``@ws4`` or the role-split
    REINFORCE kernel's ``@rs2``)."""
    source = (CSRC / f"{library}.cu").read_text()
    for key, instance in sass_ops.STEP_INSTANCES[library].items():
        sub, _, nested = instance.partition("@")
        sub, mark, second = sub.partition("#")
        assert nested in ("", "inner", "lanes2", "lanes4", "lanes8", "ws2", "ws4", "rs2") \
            and second in ("", "2"), key
        assert not (nested and mark), key
        kernel, _sep, args = sub.partition("_kernel")
        n_args = _mangled_arity(args)
        assert _template_arity(source, kernel + "_kernel") == n_args, key
        assert key.split("/")[0] == kernel, key


# the mangled names of the controller-in-the-loop instances, as cuobjdump
# lists them for the libraries nvcc builds (anonymous-namespace prefix as
# printed on an H100 build)
SASS_CONTROL = "\n".join(
    f"""        Function : _ZN45_GLOBAL__N__300bf0b0_12_x_cu_9057f009{len(k)}{k}Ev9CtrlConst
        /*0000*/                   S2R R0, SR_TID.X ;
        /*0010*/                   FFMA R2, R2, R3, R4 ;
        /*0020*/                   ISETP.NE.AND P1, PT, R0, UR4, PT ;
        /*0030*/               @P1 BRA 0x10 ;
        /*0040*/                   EXIT ;"""
    for k in ("foc_rollout_kernelILb0EE", "foc_rollout_kernelILb1EE", "foc_rollout_ws_kernel",
              *[f"dc_cascade_rollout_kernelILi{o}ELb{w}EE" for o in range(3) for w in range(2)],
              *[f"dc_cascade_rollout_ws_kernelILi{o}EE" for o in range(3)],
              *[f"srm_cascade_rollout_kernelILi{t}ELb{f}ELb{s}ELb{w}EE"
                for t in range(3) for f in range(2) for s in range(2) for w in range(2)]))


def test_control_instances_pick_one_function_each():
    """The controller-in-the-loop entries each match exactly one function of
    their library's listing (2, 6 and 24 one-thread instances, the FOC's
    ring kernel and the DC cascade's 3), a one-thread entry the one with the
    reference advance (WIENER, the last template argument, true), whose loop
    counts; a ring entry (the DC cascade's ``@ws2``, the FOC's ``@ws4``)
    names the kernel's OPS alone or, for the FOC, no template argument."""
    funcs = sass_ops.functions(SASS_CONTROL)
    assert len(funcs) == 36
    ws_steps = {"fused_foc": 4, "fused_dc_cascade": 2}
    for library in ("fused_foc", "fused_dc_cascade", "fused_srm_cascade"):
        for instance in sass_ops.STEP_INSTANCES[library].values():
            sub = instance.partition("@")[0]
            names = [f for f in funcs if sub in f]
            assert len(names) == 1, instance
            if sass_ops.ws_steps_of(instance):
                assert "_ws_kernel" in sub, instance
                assert sass_ops.ws_steps_of(instance) == ws_steps[library], instance
                continue
            assert instance.endswith("Lb1EE"), instance
            counts = sass_ops.loop_counts(funcs[names[0]])
            assert counts["always"] == {"fp32": 2, "alu": 1, "imad": 0, "xu": 0, "shfl": 0, "smem": 0, "bar": 0}


# the mangled names of the specialised builders' kernels, as cuobjdump lists
# them (anonymous-namespace prefix and parameter types as nvcc mangles them)
SPECIALISED_KERNELS = {
    "fused_permex": [f"{k}_kernelE7DcConst{'11PermexConst5uint2' if 'buffer' not in k else ''}ii"
                     for k in ("permex_rollout_random", "permex_rollout_buffer",
                               "permex_record_random", "permex_record_buffer",
                               "permex_rollout_ws", "permex_record_ws")],
    "fused_dc_sc": [f"dc_sc_rollout_{m}_kernelILi{n}EEv9DcScConst"
                    for m in ("random", "buffer", "ws") for n in (1, 2)],
    "fused_scim_tc": [f"scim_rollout_{m}_kernelE14InductionConst"
                      for m in ("random", "buffer", "ws")],
    "fused_eesm_cc": [f"eesm_cc_rollout_{m}_kernelE9EesmConst11EesmCcConst"
                      for m in ("random", "buffer", "ws")],
    "fused_dfim_cc": [f"dfim_cc_rollout_{m}_kernelE9DfimConst11DfimCcConst"
                      for m in ("random", "buffer", "ws")],
}


@pytest.mark.parametrize("library", sorted(SPECIALISED_KERNELS))
def test_specialised_instances_pick_one_function_each(library):
    """Every specialised entry matches exactly one function of its library's
    listing, and each of the library's random and buffer kernels is counted
    (the permex rollout's, the dc_sc random kernel on both motors and the
    scim_tc, eesm_cc and dfim_cc ones, one thread per env and on its ring; a
    ring entry's ``@wsK`` mark names no part of the function)."""
    listing = "\n".join(
        f"""        Function : _ZN45_GLOBAL__N__5c1e2d3f_12_x_cu_0f1e2d3c{len(k)}{k}
        /*0000*/                   S2R R0, SR_TID.X ;
        /*0010*/                   FFMA R2, R2, R3, R4 ;
        /*0020*/                   ISETP.NE.AND P1, PT, R0, UR4, PT ;
        /*0030*/               @P1 BRA 0x10 ;
        /*0040*/                   EXIT ;""" for k in SPECIALISED_KERNELS[library])
    funcs = sass_ops.functions(listing)
    counted = set()
    for instance in sass_ops.STEP_INSTANCES[library].values():
        names = [f for f in funcs if instance.partition("@")[0] in f]
        assert len(names) == 1, instance
        counted.add(names[0])
        assert sass_ops.loop_counts(funcs[names[0]])["always"]["fp32"] == 2
    assert len(counted) == len(sass_ops.STEP_INSTANCES[library]) >= 2


# a lane-group kernel's step loop: a shuffle beside the arithmetic
SASS_LANES = """
        Function : _ZN45_GLOBAL__N__0a1b2c3d_12_x_cu_4e5f6a7b24srm_rollout_lanes_kernelILb1ELi3ELb0EEEv8SrmConst
        /*0000*/                   S2R R0, SR_TID.X ;
        /*0010*/                   FFMA R2, R2, R3, R4 ;
        /*0020*/                   SHFL.IDX PT, R5, R2, 0x3, 0x1c1f ;
        /*0030*/                   FADD R2, R2, R5 ;
        /*0040*/                   ISETP.NE.AND P1, PT, R0, UR4, PT ;
        /*0050*/               @P1 BRA 0x10 ;
        /*0060*/                   EXIT ;
"""


def test_lane_mark_multiplies_by_the_lanes_per_env():
    """``@lanes4``: a warp issues a lane's count for eight envs, so an
    env-step issues four times a lane's count, shuffles included; the
    lane's own count stays beside it."""
    funcs = sass_ops.functions(SASS_LANES)
    name = "srm_rollout_lanes_kernelILb1ELi3ELb0E"
    assert sass_ops.lanes_of(name + "@lanes4") == 4 and sass_ops.lanes_of(name) == 1
    counts = sass_ops.instance_counts(funcs, [name, name + "@lanes4"])
    lane = {"fp32": 3, "alu": 1, "imad": 0, "xu": 0, "shfl": 1, "smem": 0, "bar": 0}
    assert counts[name]["always"] == lane and "lanes" not in counts[name]
    marked = counts[name + "@lanes4"]
    assert marked["lanes"] == 4 and marked["per_lane"]["always"] == lane
    assert marked["always"] == {k: 4 * v for k, v in lane.items()}
    # FFMA, SHFL, FADD, ISETP: an FFMA is one instruction
    assert counts[name]["insns"]["always"] == 4 and marked["insns"]["always"] == 16
    assert marked["per_lane"]["insns"]["always"] == 4
    with pytest.raises(ValueError, match="divide"):
        sass_ops.lanes_of(name + "@lanes3")


def test_srm_lane_kernels_carry_their_lane_mark():
    """The SRM random rollout's lane-group kernel runs four lanes an env:
    its entries (the constant-speed ids Finite-CC and Finite-TC) carry
    ``@lanes4`` and, besides them, only the PPO recorder's lane kernels
    (``test_policy_record_lane_instance_carries_its_lane_mark``) and the
    DC and synchronous families' universal recorders'
    (``test_dc_policy_lanes_and_srm_record_ring_keep_their_one_thread_entries``,
    ``test_sync_policy_lanes_keep_their_one_thread_entry``), the EESM, SRM
    and SCIM families' (``test_eesm_and_srm_policy_lanes_keep_their_one_thread_entries``)
    and the DFIM family's (``test_dfim_policy_lanes_keep_their_one_thread_entries``)
    carry a lane mark; each of those ids also has an unmarked one-thread
    entry of srm_rollout_random with the same FINITE, NREF and SAT, the
    function's own work that the bounds count."""
    marks = {"srm_rollout_lanes": 4, "policy_record_lanes": 4, "policy_record_lanes/8": 8,
             "dc_policy_record_lanes": 4, "dc_policy_record_lanes/8": 8,
             "dc_policy_record_lanes/8/Cont-CC-PermExDc-v0": 8,
             "sync_policy_record_lanes/8": fp.SYNC_POLICY_WIDE[0],
             "eesm_policy_record_lanes/8": fp.EESM_POLICY_WIDE[0],
             "srm_policy_record_lanes/8": fp.SRM_POLICY_WIDE[0],
             "dfim_policy_record_lanes/8": fp.DFIM_POLICY_WIDE[0],
             "dfim_policy_record_lanes/8/joint": fp.DFIM_POLICY_WIDE[0],
             "induction_policy_record_lanes/8": fp.INDUCTION_POLICY_WIDE[0]}
    lanes = {}
    for library, instances in sass_ops.STEP_INSTANCES.items():
        for key, instance in instances.items():
            lane_kernel = key.split("/")[0] == "srm_rollout_lanes"
            want = marks.get(key, marks.get(key.split("/")[0], 1))
            assert sass_ops.lanes_of(instance) == want, key
            if lane_kernel:
                lanes[key.split("/")[1]] = instance
    assert sorted(lanes) == ["Finite-CC-SRM-v0", "Finite-TC-SRM-v0"]
    srm = sass_ops.STEP_INSTANCES["fused_srm"]
    for env_id, instance in lanes.items():
        finite, nref, sat = re.fullmatch(r"srm_rollout_lanes_kernelI(Lb\dE)(Li\dE)(Lb\dE)@lanes4",
                                         instance).groups()
        assert srm[f"srm_rollout_random/{env_id}"] == (
            f"srm_rollout_random_kernelI{finite}Lb0E{nref}{sat}"), env_id


def test_policy_record_lane_instance_carries_its_lane_mark():
    """The PPO recorder runs on lane groups below a full card: the entry of
    its lane kernel with every lane stepping (LEAD 0, the design whose step
    the count takes as issued) carries ``@lanesG`` with G its second
    template argument, a divisor of the warp and of H (each lane holds H / G
    hidden units), and sits beside the one-thread entry of the same H, the
    function's own work that the bounds count."""
    policy = sass_ops.STEP_INSTANCES["fused_policy"]
    instance = policy["policy_record_lanes"]
    hidden, lanes, lead = re.fullmatch(
        r"policy_record_lanes_kernelILi(\d+)ELi(\d+)ELb(\d)E@lanes\d+", instance).groups()
    hidden, lanes = int(hidden), int(lanes)
    assert sass_ops.lanes_of(instance) == lanes and lead == "0"
    assert 32 % lanes == 0 and hidden % lanes == 0 and lanes > 1
    assert policy["policy_record"] == f"policy_record_kernelILi{hidden}E"
    # at PPO's width eight lanes, lane 0 stepping (LEAD 1): a branch on the
    # lane, counted as issued (test_branch_on_the_lane_counts_as_issued)
    assert policy["policy_record_lanes/8"] == (
        f"policy_record_lanes_kernelILi{hidden}ELi8ELb1E@lanes8")


# a warp-specialised kernel: the consumer's step loop (ring loads, a
# barrier wait at a slot's first step) and the producer's slot loop of two
# steps (ring stores, the barrier before a refill), with the constant-
# reference variant of each role (#2) after them
SASS_WS = """
        Function : _ZN45_GLOBAL__N__0a1b2c3d_12_x_cu_4e5f6a7b28dc_rollout_ws_kernelILb1ELb0ELi0ELi1EEEv7DcConst
        /*0000*/                   S2R R0, SR_TID.X ;
        /*0010*/                   ISETP.GE.AND P0, PT, R0, 0x80, PT ;
        /*0020*/               @P0 BRA 0x100 ;
        /*0030*/                   LOP3.LUT P1, RZ, R4, 0x3, RZ, 0xc0, !PT ;
        /*0040*/               @P1 BRA 0x60 ;
        /*0050*/                   BAR.SYNC R2, 0x100 ;
        /*0060*/                   LDS R5, [R3] ;
        /*0070*/                   LDS R6, [R3+0x200] ;
        /*0080*/                   FFMA R7, R5, R6, R7 ;
        /*0090*/                   FMUL R7, R7, R8 ;
        /*00a0*/                   ISETP.NE.AND P2, PT, R4, UR4, PT ;
        /*00b0*/               @P2 BRA 0x30 ;
        /*00c0*/                   LDS R5, [R3] ;
        /*00d0*/                   FADD R7, R7, R5 ;
        /*00e0*/               @P2 BRA 0xc0 ;
        /*00f0*/                   EXIT ;
        /*0100*/               @P3 BRA 0x120 ;
        /*0110*/                   BAR.SYNC R9, 0x100 ;
        /*0120*/                   IMAD.HI.U32 R10, R11, 0x3, RZ ;
        /*0130*/                   IMAD.HI.U32 R12, R13, 0x3, RZ ;
        /*0140*/                   LOP3.LUT R10, R10, R14, R15, 0x96, !PT ;
        /*0150*/                   LOP3.LUT R12, R12, R14, R15, 0x96, !PT ;
        /*0160*/                   MUFU.LG2 R16, R10 ;
        /*0170*/                   STS [R3], R10 ;
        /*0180*/                   STS [R3+0x200], R12 ;
        /*0190*/                   BAR.ARV R2, 0x100 ;
        /*01a0*/                   ISETP.NE.AND P4, PT, R17, UR5, PT ;
        /*01b0*/               @P4 BRA 0x100 ;
        /*01c0*/                   IMAD.HI.U32 R10, R11, 0x3, RZ ;
        /*01d0*/                   STS [R3], R10 ;
        /*01e0*/               @P4 BRA 0x1c0 ;
        /*01f0*/                   EXIT ;
"""


def test_ws_mark_gives_the_steps_of_a_producer_iteration():
    """``@wsK`` names a warp-specialised kernel whose producer iteration
    fills K steps; other entries are not warp-specialised (0)."""
    name = "dc_rollout_ws_kernelILb1ELb0ELi0ELi1E"
    assert sass_ops.ws_steps_of(name + "@ws4") == 4
    assert sass_ops.ws_steps_of(name + "#2@ws2") == 2
    assert sass_ops.ws_steps_of(name) == 0 and sass_ops.ws_steps_of(name + "@lanes4") == 0
    with pytest.raises(ValueError, match="at least one step"):
        sass_ops.ws_steps_of(name + "@ws0")


def test_rs_mark_gives_the_trace_warps_of_a_role_split():
    """``@rsT`` names a role-split kernel with T trace warps per step warp;
    other entries are not role splits (0), and ``@rsT`` is no ``@wsK``."""
    name = "reinforce_split_kernelILi16ELb0ELb1E"
    assert sass_ops.trace_warps_of(name + "@rs4") == 4
    assert sass_ops.trace_warps_of(name) == 0 and sass_ops.trace_warps_of(name + "@ws4") == 0
    assert sass_ops.ws_steps_of(name + "@rs4") == 0
    with pytest.raises(ValueError, match="at least one trace warp"):
        sass_ops.trace_warps_of(name + "@rs0")


def test_rs_counts_add_the_step_loop_and_t_trace_loops():
    """A role-split kernel (``@rsT``): the loop that stores the ring is the
    step warp's and the loop that only loads it a trace warp's, each one
    step an iteration, so an env-step issues the step loop's count plus T
    times the trace loop's; the roles are named step and trace."""
    funcs = sass_ops.functions(SASS_WS)
    name = "dc_rollout_ws_kernelILb1ELb0ELi0ELi1E"
    rs = sass_ops.instance_counts(funcs, [name + "@rs4"])[name + "@rs4"]
    zero = dict.fromkeys(sass_ops.CLASSES, 0)
    trace = {**zero, "fp32": 3, "alu": 2, "smem": 2}
    step = {**zero, "alu": 3, "imad": 2, "xu": 1, "smem": 2, "bar": 1}
    assert rs["ws_steps"] == 1 and rs["trace_warps"] == 4
    assert set(rs["roles"]) == {"step", "trace"}
    assert rs["roles"]["step"]["always"] == step and rs["roles"]["step"]["steps"] == 1
    assert rs["roles"]["trace"]["always"] == trace and rs["roles"]["trace"]["warps_per_env"] == 4
    assert rs["always"] == {k: step[k] + 4 * trace[k] for k in zero}
    assert rs["insns"]["always"] == (rs["roles"]["step"]["insns"]["always"]
                                     + 4 * rs["roles"]["trace"]["insns"]["always"])


def test_ws_counts_sum_the_consumer_step_and_the_producer_slot_over_its_steps():
    """The two roles' loops are told apart by the ring (stores: producer,
    loads only: consumer); an env-step issues the consumer's always-executed
    count plus the producer's over the steps its iteration fills, and the
    barrier waits, taken once a slot, are conditional.  ``#2`` counts each
    role's second loop (constant references)."""
    funcs = sass_ops.functions(SASS_WS)
    name = "dc_rollout_ws_kernelILb1ELb0ELi0ELi1E"
    counts = sass_ops.instance_counts(funcs, [name + "@ws2", name + "#2@ws2"])
    ws = counts[name + "@ws2"]
    zero = dict.fromkeys(sass_ops.CLASSES, 0)
    consumer = {**zero, "fp32": 3, "alu": 2, "smem": 2}
    producer = {**zero, "alu": 3, "imad": 2, "xu": 1, "smem": 2, "bar": 1}
    assert ws["ws_steps"] == 2
    assert ws["roles"]["consumer"]["always"] == consumer
    assert ws["roles"]["consumer"]["conditional"] == {**zero, "bar": 1}
    assert ws["roles"]["producer"]["always"] == producer and ws["roles"]["producer"]["steps"] == 2
    assert ws["roles"]["producer"]["conditional"] == {**zero, "bar": 1}
    assert ws["always"] == {k: consumer[k] + producer[k] / 2 for k in consumer}
    const = counts[name + "#2@ws2"]
    assert const["roles"]["consumer"]["always"] == {**zero, "fp32": 1, "smem": 1}
    assert const["roles"]["producer"]["always"] == {**zero, "imad": 1, "smem": 1}
    assert const["always"] == {**zero, "fp32": 1, "imad": 0.5, "smem": 1.5}
    with pytest.raises(ValueError, match="no consumer loop"):
        sass_ops.ws_counts(sass_ops.functions(SASS)["_Z4stepPfi"], 4)


def test_ws_kernels_sit_beside_their_one_thread_instances():
    """The sync, DC, SCIM, EESM and DFIM random rollouts, the policy
    evaluation rollout, the specialised DC SC, Cont-TC-SCIM, Finite-CC-EESM
    and Cont-CC-DFIM rollouts, the DC cascade, the FOC, the main path's
    Finite-CC-PMSM random rollout and recorder, the specialised
    Finite-CC-PermExDc rollout and recorder and the SRM, DC, EESM,
    synchronous, SCIM and DFIM random recorders run warp-specialised
    with Wiener references: the DC and EESM rollouts' ``_ws`` entries
    carry ``@ws2`` (two producer warps per consumer warp, two steps each of
    a four-step slot) or, under the EESM's speed ODE (MECH), ``@ws4`` (one),
    and no other entry carries a ``@ws`` mark; each has a one-thread entry
    whose template arguments start with its own, the function's own work
    that the bounds count (the policy's one-thread kernel adds its Wiener
    and weight-order flags).  The SCIM, sync, DFIM, policy, DC SC, SCIM TC,
    DFIM CC, FOC, PMSM, PermExDc and SRM recorder rings hold eight steps a
    slot for two
    producer warps, so their
    mark is ``@ws4``, the steps a producer iteration fills; the EESM CC and
    DC cascade rings hold four for two, ``@ws2``; the DC, EESM,
    synchronous, SCIM, DFIM, PMSM and PermExDc recorders' marks are K / P
    of their rings (``DC_RECORD_RING``, ``EESM_RECORD_RING``,
    ``SYNC_RECORD_RING``, ``IND_RECORD_RING``, ``DFIM_RECORD_RING``,
    ``PMSM_RECORD_RING``, ``PERMEX_RECORD_RING``)."""
    (dk, dp), (ek, ep) = dcf.DC_RECORD_RING, ef.EESM_RECORD_RING
    (sk, sp), (ik, ip) = sf.SYNC_RECORD_RING, indf.IND_RECORD_RING
    fk, fp_ = dff.DFIM_RECORD_RING
    (pk, pp), (xk, xp) = fs.PMSM_RECORD_RING, fd.PERMEX_RECORD_RING
    seen = {}
    for instances in sass_ops.STEP_INSTANCES.values():
        for key, instance in instances.items():
            ws = key.split("/")[0] in ("dc_rollout_ws", "eesm_rollout_ws", "induction_rollout_ws",
                                       "sync_rollout_ws", "dfim_rollout_ws", "policy_rollout_ws",
                                       "dc_sc_rollout_ws", "eesm_cc_rollout_ws",
                                       "dc_cascade_rollout_ws", "dfim_cc_rollout_ws",
                                       "foc_rollout_ws", "scim_rollout_ws", "pmsm_rollout_ws",
                                       "permex_rollout_ws", "srm_record_ws",
                                       "dc_record_ws", "eesm_record_ws", "sync_record_ws",
                                       "induction_record_ws", "dfim_record_ws",
                                       "pmsm_record_ws", "permex_record_ws")
            assert (sass_ops.ws_steps_of(instance) > 0) == ws, key
            if ws:
                seen[key] = sass_ops.ws_steps_of(instance)
                random = key.replace("_ws", "_random", 1)
                one = instances[random if random in instances else key.replace("_ws", "", 1)]
                # the sync ring's shape is a template argument of its own
                sub = instance.partition("@")[0].split("9RingShape")[0]
                kernel = "_random_kernel" if random in instances else "_kernel"
                assert one.startswith(sub.replace("_ws_kernel", kernel, 1)), key
    assert seen == {"dc_rollout_ws": 2, "dc_rollout_ws/Finite-CC-PermExDc-v0": 2,
                    "eesm_rollout_ws": 4, "eesm_rollout_ws/Cont-TC-EESM-v0": 2,
                    "eesm_rollout_ws/Finite-CC-EESM-v0": 2,
                    "induction_rollout_ws": 4, "induction_rollout_ws/Cont-TC-SCIM-v0": 4,
                    "induction_rollout_ws/Finite-CC-SCIM-v0": 4,
                    "sync_rollout_ws": 4, "sync_rollout_ws/Finite-CC-PMSM-v0": 4,
                    "sync_rollout_ws/Cont-CC-PMSM-v0": 4,
                    "dfim_rollout_ws": 4, "dfim_rollout_ws/Cont-CC-DFIM-v0": 4,
                    "dfim_rollout_ws/Finite-CC-DFIM-v0": 4, "policy_rollout_ws": 4,
                    "dc_sc_rollout_ws": 4, "dc_sc_rollout_ws/Cont-SC-SeriesDc-v0": 4,
                    "eesm_cc_rollout_ws": 2, "dc_cascade_rollout_ws": 2,
                    "dc_cascade_rollout_ws/Cont-SC-SeriesDc-v0": 2,
                    "dc_cascade_rollout_ws/Cont-SC-ShuntDc-v0": 2,
                    "dfim_cc_rollout_ws": 4, "foc_rollout_ws": 4, "scim_rollout_ws": 4,
                    "pmsm_rollout_ws": 4, "permex_rollout_ws": 4, "srm_record_ws": 4,
                    **{k: dk // dp for k in ("dc_record_ws", "dc_record_ws/Finite-CC-PermExDc-v0")},
                    **{k: ek // ep for k in ("eesm_record_ws", "eesm_record_ws/Finite-CC-EESM-v0")},
                    **{k: sk // sp for k in ("sync_record_ws", "sync_record_ws/Finite-CC-PMSM-v0")},
                    **{k: ik // ip for k in ("induction_record_ws",
                                             "induction_record_ws/Finite-CC-SCIM-v0")},
                    **{k: fk // fp_ for k in ("dfim_record_ws",
                                              "dfim_record_ws/Cont-CC-DFIM-v0")},
                    "pmsm_record_ws": pk // pp, "permex_record_ws": xk // xp}
    # under the speed ODE (the second template argument) one producer warp
    assert sass_ops.STEP_INSTANCES["fused_eesm"]["eesm_rollout_ws"].startswith(
        "eesm_rollout_ws_kernelILb0ELb1E")


# a step loop with a branch on the lane: P0 (lane index & 7 != 0) is made
# before the loop from SR_TID.X and immediates alone, so the block that
# lanes 0, 8, 16 and 24 take (0x40-0x50) runs in every warp at every step;
# the block under the branch on data (0x80) stays conditional
SASS_LANE_BRANCH = """
        Function : _Z5lanesPfi
        /*0000*/                   S2R R0, SR_TID.X ;
        /*0010*/                   LOP3.LUT P0, RZ, R0, 0x7, RZ, 0xc0, !PT ;
        /*0020*/                   FFMA R2, R2, R3, R4 ;
        /*0030*/               @P0 BRA 0x60 ;
        /*0040*/                   MUFU.EX2 R5, R2 ;
        /*0050*/                   FADD R2, R2, R5 ;
        /*0060*/                   FSETP.GT.AND P1, PT, R2, RZ, PT ;
        /*0070*/               @P1 BRA 0x90 ;
        /*0080*/                   IMAD.WIDE.U32 R6, R5, 0x3, RZ ;
        /*0090*/                   ISETP.NE.AND P2, PT, R0, UR4, PT ;
        /*00a0*/               @P2 BRA 0x20 ;
        /*00b0*/                   EXIT ;
"""


def test_branch_on_the_lane_counts_as_issued():
    """A block under a branch on the lane runs in every warp at every step
    (a warp issues both sides), so it counts as always issued; a block
    under a branch on data stays conditional."""
    counts = sass_ops.loop_counts(sass_ops.functions(SASS_LANE_BRANCH)["_Z5lanesPfi"])
    zero = dict.fromkeys(sass_ops.CLASSES, 0)
    assert counts["lane_branches"] == 1
    assert counts["always"] == {**zero, "fp32": 3, "alu": 2, "xu": 1}
    assert counts["conditional"] == {**zero, "imad": 1}
    # FFMA, MUFU, FADD, FSETP, ISETP
    assert counts["insns"] == {"always": 5, "conditional": 1}


@pytest.mark.parametrize("define", [
    # the predicate made again in the loop from data before the branch
    "FSETP.GEU.AND P0, PT, R2, RZ, PT",
    # the lane index mixed with data
    "ISETP.NE.AND P0, PT, R0, R2, PT",
    # the lane index mixed with a uniform register (a block's, not a lane's)
    "ISETP.NE.AND P0, PT, R0, UR5, PT",
])
def test_branch_on_data_stays_conditional(define):
    """A predicate with a definition that reads data (or a uniform
    register) is no branch on the lane: the block under it stays
    conditional, as before."""
    sass = SASS_LANE_BRANCH.replace("FFMA R2, R2, R3, R4 ;", define + " ;", 1).replace(
        "/*0010*/                   LOP3.LUT P0, RZ, R0, 0x7, RZ, 0xc0, !PT ;",
        "/*0010*/                   FFMA R2, R2, R3, R4 ;", 1)
    counts = sass_ops.loop_counts(sass_ops.functions(sass)["_Z5lanesPfi"])
    zero = dict.fromkeys(sass_ops.CLASSES, 0)
    assert counts["lane_branches"] == 0
    assert counts["conditional"] == {**zero, "fp32": 1, "imad": 1, "xu": 1}


def test_issue_slot_floor_is_instructions_at_four_warp_instructions_per_sm_and_clock():
    """The issue-slot floor: every counted instruction of every env-step
    at one warp-instruction per scheduler and clock, 4 x 32
    thread-instructions per SM and clock; 362 instructions a step (an
    estimate of the Cont-SC-PMSM step) at 16384 x 65536 on 132 SMs at
    1.98 GHz take 11.62 ms."""
    assert sass_ops.ISSUE_PER_SM_CLOCK == 128
    env_steps = 16384 * 65536
    want = 1e3 * env_steps * 362 / (132 * 1.98e9 * 128)
    assert sass_ops.issue_floor_ms(env_steps, 362, 132, 1.98e9) == pytest.approx(want, rel=1e-12)
    assert round(want, 2) == 11.62


def test_policy_and_dc_sc_rings_keep_their_one_thread_entries():
    """policy_rollout and dc_sc_rollout_random run on rings (csrc/ring_pipe.cuh):
    their ``_ws`` entries count what the launch issues, while the one-thread
    entries stay the count of the function's own work, the instances the
    bounds take: policy_rollout at H 16, categorical, Wiener references,
    the weights in mlp_forward's order (VEC 0), and greedy with constant
    references in both orders (the launch takes VEC 1 there); the DC SC
    kernel on both motors (NEL 2 ShuntDc, 1 SeriesDc)."""
    policy = sass_ops.STEP_INSTANCES["fused_policy"]
    assert policy["policy_rollout"] == "policy_rollout_kernelILi16ELb0ELb1ELb0EE"
    assert policy["policy_rollout_ws"] == "policy_rollout_ws_kernelILi16ELb0E@ws4"
    assert policy["policy_rollout/greedy/const"] == "policy_rollout_kernelILi16ELb1ELb0ELb0EE"
    assert policy["policy_rollout/greedy/const/vec"] == "policy_rollout_kernelILi16ELb1ELb0ELb1EE"
    dc_sc = sass_ops.STEP_INSTANCES["fused_dc_sc"]
    assert dc_sc["dc_sc_rollout_random"] == "dc_sc_rollout_random_kernelILi2E"
    assert dc_sc["dc_sc_rollout_random/Cont-SC-SeriesDc-v0"] == "dc_sc_rollout_random_kernelILi1E"
    assert dc_sc["dc_sc_rollout_ws"] == "dc_sc_rollout_ws_kernelILi2E@ws4"
    assert dc_sc["dc_sc_rollout_ws/Cont-SC-SeriesDc-v0"] == "dc_sc_rollout_ws_kernelILi1E@ws4"
    for instance in list(policy.values()) + list(dc_sc.values()):
        assert sass_ops.ws_steps_of(instance) == (4 if "_ws_kernel" in instance else 0)


def test_eesm_cc_and_dc_cascade_rings_keep_their_one_thread_entries():
    """eesm_cc_rollout_random and, with Wiener references, dc_cascade_rollout
    run on rings (csrc/ring_pipe.cuh): their ``_ws`` entries count what the
    launch issues (``@ws2``: K = 4, two producer warps), while the one-thread
    entries stay the count of the function's own work, the instances the
    bounds take: the EESM CC kernel, and the cascade with the reference
    advance (WIENER true) on each of the three motors (OPS 0 PermExDc, 1
    SeriesDc, 2 ShuntDc), each beside a ring entry of the same OPS."""
    eesm = sass_ops.STEP_INSTANCES["fused_eesm_cc"]
    assert eesm["eesm_cc_rollout_random"] == "eesm_cc_rollout_random_kernel"
    assert eesm["eesm_cc_rollout_ws"] == "eesm_cc_rollout_ws_kernel@ws2"
    cascade = sass_ops.STEP_INSTANCES["fused_dc_cascade"]
    for ops, suffix in enumerate(("", "/Cont-SC-SeriesDc-v0", "/Cont-SC-ShuntDc-v0")):
        assert cascade["dc_cascade_rollout" + suffix] == f"dc_cascade_rollout_kernelILi{ops}ELb1EE"
        assert cascade["dc_cascade_rollout_ws" + suffix] == f"dc_cascade_rollout_ws_kernelILi{ops}E@ws2"
    for instance in list(eesm.values()) + list(cascade.values()):
        assert sass_ops.ws_steps_of(instance) == (2 if "_ws_kernel" in instance else 0)


def test_foc_and_dfim_cc_rings_keep_their_one_thread_entries():
    """dfim_cc_rollout_random and, with Wiener references, foc_rollout run
    on rings (csrc/ring_pipe.cuh): their ``_ws`` entries count what the
    launch issues (``@ws4``: K = 8, two producer warps), while the
    one-thread entries stay the count of the function's own work, the
    instances the bounds take: the DFIM CC random kernel, and the FOC with
    the reference advance (WIENER true)."""
    dfim = sass_ops.STEP_INSTANCES["fused_dfim_cc"]
    assert dfim["dfim_cc_rollout_random"] == "dfim_cc_rollout_random_kernel"
    assert dfim["dfim_cc_rollout_buffer"] == "dfim_cc_rollout_buffer_kernel"
    assert dfim["dfim_cc_rollout_ws"] == "dfim_cc_rollout_ws_kernel@ws4"
    foc = sass_ops.STEP_INSTANCES["fused_foc"]
    assert foc == {"foc_rollout": "foc_rollout_kernelILb1EE",
                   "foc_rollout_ws": "foc_rollout_ws_kernel@ws4"}
    for instance in list(dfim.values()) + list(foc.values()):
        assert sass_ops.ws_steps_of(instance) == (4 if "_ws_kernel" in instance else 0)


def test_scim_tc_ring_and_reinforce_split_keep_their_one_thread_entries():
    """scim_rollout_random runs on a ring (csrc/ring_pipe.cuh; ``@ws4``: K =
    8, two producer warps) and reinforce_rollout on its role split
    (``@rs2``: two trace warps per step warp at H 16, categorical, Wiener
    references, as fused_policy.reinforce_layout gives them), while the
    one-thread entries stay the count of the function's own work, the
    instances the bounds take."""
    scim = sass_ops.STEP_INSTANCES["fused_scim_tc"]
    assert scim == {"scim_rollout_random": "scim_rollout_random_kernel",
                    "scim_rollout_buffer": "scim_rollout_buffer_kernel",
                    "scim_rollout_ws": "scim_rollout_ws_kernel@ws4"}
    policy = sass_ops.STEP_INSTANCES["fused_policy"]
    assert policy["reinforce_rollout"] == "reinforce_rollout_kernelILi16ELb0ELb1E"
    assert policy["reinforce_split"] == "reinforce_split_kernelILi16ELb0ELb1E@rs2"
    for instance in scim.values():
        assert sass_ops.ws_steps_of(instance) == (4 if "_ws_kernel" in instance else 0)
    assert [k for k, v in policy.items() if sass_ops.trace_warps_of(v)] == ["reinforce_split"]
    assert sass_ops.trace_warps_of(policy["reinforce_split"]) == fp.reinforce_layout(
        16, 128)["trace_warps"] == 2


def test_pmsm_and_permex_rings_keep_their_one_thread_entries():
    """pmsm_rollout_random and permex_rollout_random run on rings
    (csrc/ring_pipe.cuh; ``@ws4``: K = 8, two producer warps), and so do
    the random recorders pmsm_record_random and permex_record_random (``@ws``
    K / P of ``PMSM_RECORD_RING`` and ``PERMEX_RECORD_RING``), while the
    one-thread entries stay the count of the function's own work, the
    instances the bounds take, beside the buffer kernels, which keep one
    thread per env."""
    (pk, pp), (xk, xp) = fs.PMSM_RECORD_RING, fd.PERMEX_RECORD_RING
    pmsm = sass_ops.STEP_INSTANCES["fused_pmsm"]
    assert pmsm == {"pmsm_rollout_random": "pmsm_rollout_random_kernel",
                    "pmsm_rollout_buffer": "pmsm_rollout_buffer_kernel",
                    "pmsm_record_random": "pmsm_record_random_kernel",
                    "pmsm_record_buffer": "pmsm_record_buffer_kernel",
                    "pmsm_rollout_ws": "pmsm_rollout_ws_kernel@ws4",
                    "pmsm_record_ws": f"pmsm_record_ws_kernel@ws{pk // pp}"}
    permex = sass_ops.STEP_INSTANCES["fused_permex"]
    assert permex == {"permex_rollout_random": "permex_rollout_random_kernel",
                      "permex_rollout_buffer": "permex_rollout_buffer_kernel",
                      "permex_record_random": "permex_record_random_kernel",
                      "permex_record_buffer": "permex_record_buffer_kernel",
                      "permex_rollout_ws": "permex_rollout_ws_kernel@ws4",
                      "permex_record_ws": f"permex_record_ws_kernel@ws{xk // xp}"}
    ws = {"pmsm_rollout_ws": 4, "permex_rollout_ws": 4, "pmsm_record_ws": pk // pp,
          "permex_record_ws": xk // xp}
    for key, instance in list(pmsm.items()) + list(permex.items()):
        assert sass_ops.ws_steps_of(instance) == ws.get(key, 0)


def test_dc_policy_lanes_and_srm_record_ring_keep_their_one_thread_entries():
    """dc_policy_record runs on lane groups below a full card (eight lanes
    an env at PPO's width, every lane stepping, ``@lanes8``, on
    Finite-CC-PermExDc and Cont-CC-PermExDc; four lanes with lane 0 stepping,
    ``@lanes4``) and srm_record_random's continuous instances on a ring with
    Wiener references (``@ws4``: K = 8, two producer warps, on Cont-SC-SRM),
    while the one-thread entries stay the count of the function's own work:
    the DC recorder's hidden-unit loop apart (``@inner``), the SRM
    recorder's Wiener loop, which its finite instances (Finite-CC-SRM) run.
    Each new entry's template arguments start with its one-thread entry's,
    followed by the lanes and the lead flag."""
    dc = sass_ops.STEP_INSTANCES["fused_dc_policy"]
    assert dc["dc_policy_record"] == "dc_policy_record_kernelILb1ELb0ELi0ELi1ELb0EE@inner"
    assert dc["dc_policy_record/Cont-CC-PermExDc-v0"] == (
        "dc_policy_record_kernelILb0ELb0ELi0ELi1ELb0EE@inner")
    (gw, lw), (gn, ln) = fp.DC_POLICY_WIDE, fp.DC_POLICY_NARROW
    for key, one, lanes, lead in (
            ("dc_policy_record_lanes", "dc_policy_record", gn, ln),
            ("dc_policy_record_lanes/8", "dc_policy_record", gw, lw),
            ("dc_policy_record_lanes/8/Cont-CC-PermExDc-v0",
             "dc_policy_record/Cont-CC-PermExDc-v0", gw, lw)):
        args = dc[one].partition("@")[0][len("dc_policy_record_kernel"):-1]
        assert dc[key] == (f"dc_policy_record_lanes_kernel{args}Li{lanes}ELb{int(lead)}EE"
                           f"@lanes{lanes}"), key
        assert sass_ops.lanes_of(dc[key]) == lanes and sass_ops.ws_steps_of(dc[key]) == 0
    assert (gw, gn) == (8, 4)
    srm = sass_ops.STEP_INSTANCES["fused_srm_record"]
    assert srm["srm_record_random"] == "srm_record_random_kernelILb0ELb1ELi1ELb0E"
    assert srm["srm_record_random/Finite-CC-SRM-v0"] == "srm_record_random_kernelILb1ELb0ELi3ELb0E"
    K, P = srf.SRM_RECORD_RING
    assert srm["srm_record_ws"] == (
        srm["srm_record_random"].replace("_random_kernel", "_ws_kernel") + f"@ws{K // P}")
    assert sass_ops.ws_steps_of(srm["srm_record_ws"]) == K // P
    assert sass_ops.lanes_of(srm["srm_record_ws"]) == 1
    assert [k for k in srm if "_ws" in k] == ["srm_record_ws"]


@pytest.mark.parametrize("library,prefix,mod,ids", [
    ("fused_dc_record", "dc_record", dcf, ("", "/Finite-CC-PermExDc-v0")),
    ("fused_eesm_record", "eesm_record", ef, ("", "/Finite-CC-EESM-v0"))])
def test_dc_and_eesm_record_rings_keep_their_one_thread_entries(library, prefix, mod, ids):
    """dc_record_random and eesm_record_random run on a ring with Wiener
    references (``@wsK``, K / P of ``DC_RECORD_RING`` and
    ``EESM_RECORD_RING``) on the ids chip_smoke.py times (Cont-SC-ShuntDc
    and Finite-CC-PermExDc, Cont-SC-EESM and Finite-CC-EESM), while each
    one-thread entry stays the count of the function's own work: every ring
    entry's template arguments are its one-thread entry's."""
    instances = sass_ops.STEP_INSTANCES[library]
    K, P = getattr(mod, f"{prefix.split('_')[0].upper()}_RECORD_RING")
    for tail in ids:
        one, ring = instances[f"{prefix}_random{tail}"], instances[f"{prefix}_ws{tail}"]
        assert ring == one.replace("_random_kernel", "_ws_kernel") + f"@ws{K // P}"
        assert sass_ops.ws_steps_of(ring) == K // P and sass_ops.lanes_of(ring) == 1
        assert sass_ops.ws_steps_of(one) == 0
    assert sorted(k for k in instances if "_ws" in k) == [f"{prefix}_ws{t}" for t in ids]


@pytest.mark.parametrize("library,prefix,ring,ids", [
    ("fused_sync", "sync_record", sf.SYNC_RECORD_RING, ("", "/Finite-CC-PMSM-v0")),
    ("fused_induction_record", "induction_record", indf.IND_RECORD_RING,
     ("", "/Finite-CC-SCIM-v0")),
    ("fused_dfim_record", "dfim_record", dff.DFIM_RECORD_RING, ("", "/Cont-CC-DFIM-v0"))])
def test_sync_and_induction_record_rings_keep_their_one_thread_entries(library, prefix, ring,
                                                                      ids):
    """sync_record_random, induction_record_random and dfim_record_random
    run on a ring with Wiener references (``@wsK``, K / P of
    ``SYNC_RECORD_RING``, ``IND_RECORD_RING`` and ``DFIM_RECORD_RING``) on
    the ids chip_smoke.py times (Cont-SC-PMSM and Finite-CC-PMSM,
    Cont-SC-SCIM and Finite-CC-SCIM, Cont-SC-DFIM and Cont-CC-DFIM), while
    each one-thread entry stays the count of the function's own work: every
    ring entry's template arguments are its one-thread entry's.  The sync
    rollout's ring entries stay where they were."""
    instances = sass_ops.STEP_INSTANCES[library]
    K, P = ring
    for tail in ids:
        one, ring_key = instances[f"{prefix}_random{tail}"], instances[f"{prefix}_ws{tail}"]
        assert ring_key == one.replace("_random_kernel", "_ws_kernel") + f"@ws{K // P}"
        assert sass_ops.ws_steps_of(ring_key) == K // P and sass_ops.lanes_of(ring_key) == 1
        assert sass_ops.ws_steps_of(one) == 0
    assert sorted(k for k in instances if k.startswith(prefix) and "_ws" in k) == [
        f"{prefix}_ws{t}" for t in ids]


def test_against_names_functions_apart_from_the_source_path_hash():
    """``--against`` holds two checkouts' listings function by function: the
    anonymous namespace's mangled name carries a hash of the source's path,
    so two builds of one kernel differ there alone and must match, while the
    kernel's own name and template arguments still tell instances apart."""
    a = ("_ZN46_GLOBAL__N__ba48b36c_13_fused_sync_cu_011d8fbd22sync_rollout_ws_kernelILb0ELb0ELi1E"
         "9RingShapeILi8ELi2EEEEv9SyncConst5uint2iiNS_8RandomIoE")
    b = a.replace("ba48b36c", "2c616fb8")
    c = a.replace("ILb0ELb0ELi1E", "ILb0ELb1ELi1E")
    norm = [sass_ops._ANON.sub("_ZN_anon_", x) for x in (a, b, c)]
    assert norm[0] == norm[1] != norm[2]
    assert norm[0].startswith("_ZN_anon_22sync_rollout_ws_kernelILb0ELb0ELi1E")


def test_sync_policy_lanes_keep_their_one_thread_entry():
    """sync_policy_record runs on lane groups below a full card, on
    Finite-CC-PMSM in the one lane design its width rule names, wide and
    narrow alike (``SYNC_POLICY_WIDE`` and ``SYNC_POLICY_NARROW``: eight
    lanes, every lane stepping, the ``/8`` entry, ``@lanes8``), while the
    one-thread entry stays the count of the function's own work, its
    hidden-unit loop apart (``@inner``).  The lane entry's template
    arguments start with the one-thread entry's, followed by the lanes and
    the lead flag."""
    sync = sass_ops.STEP_INSTANCES["fused_sync_policy"]
    assert sync["sync_policy_record"] == "sync_policy_record_kernelILb1ELb0ELi2EE@inner"
    assert fp.SYNC_POLICY_WIDE == fp.SYNC_POLICY_NARROW == (8, False)
    lanes, lead = fp.SYNC_POLICY_WIDE
    args = sync["sync_policy_record"].partition("@")[0][len("sync_policy_record_kernel"):-1]
    key = "sync_policy_record_lanes/8"
    assert sync[key] == (f"sync_policy_record_lanes_kernel{args}Li{lanes}ELb{int(lead)}EE"
                         f"@lanes{lanes}")
    assert sass_ops.lanes_of(sync[key]) == lanes and sass_ops.ws_steps_of(sync[key]) == 0
    assert sorted(sync) == ["sync_policy_record", key]


@pytest.mark.parametrize("library,kernel,one_thread,design", [
    ("fused_eesm_policy", "eesm_policy_record", "eesm_policy_record_kernelILb1ELb0ELi3ELb0EE@inner",
     fp.EESM_POLICY_WIDE),
    ("fused_srm_policy", "srm_policy_record",
     "srm_policy_record_kernelILb0ELb1ELi1ELb0ELb0EE@inner", fp.SRM_POLICY_WIDE),
    ("fused_induction_policy", "induction_policy_record",
     "induction_policy_record_kernelILb1ELb0ELi2EE@inner", fp.INDUCTION_POLICY_WIDE)])
def test_eesm_and_srm_policy_lanes_keep_their_one_thread_entries(library, kernel, one_thread,
                                                                 design):
    """eesm_policy_record, srm_policy_record and induction_policy_record run
    on lane groups below a full card, on the ids chip_smoke.py times
    (Finite-CC-EESM, Cont-SC-SRM, Finite-CC-SCIM) in the one lane design
    their width rules name, wide and narrow alike (``EESM_POLICY_WIDE``/
    ``_NARROW``, ``SRM_POLICY_WIDE``/``_NARROW``,
    ``INDUCTION_POLICY_WIDE``/``_NARROW``: the ``/8`` entry, ``@lanes8``),
    while each one-thread entry stays the count
    of the function's own work, its hidden-unit loop apart (``@inner``).
    The lane entry's template arguments start with the one-thread entry's,
    followed by the lanes and the lead flag."""
    instances = sass_ops.STEP_INSTANCES[library]
    assert instances[kernel] == one_thread
    assert fp.POLICY_LANE_DESIGNS[kernel] == (design, design)
    lanes, lead = design
    args = one_thread.partition("@")[0][len(f"{kernel}_kernel"):-1]
    key = f"{kernel}_lanes/{lanes}"
    assert instances[key] == (f"{kernel}_lanes_kernel{args}Li{lanes}ELb{int(lead)}EE"
                              f"@lanes{lanes}")
    assert sass_ops.lanes_of(instances[key]) == lanes and sass_ops.ws_steps_of(instances[key]) == 0
    assert sorted(instances) == [kernel, key]


def test_dfim_policy_lanes_keep_their_one_thread_entries():
    """dfim_policy_record runs on lane groups below a full card, its
    factorised and its joint heads alike, on the id chip_smoke.py times
    (Finite-CC-DFIM) in the one lane design its width rule names, wide and
    narrow alike (``DFIM_POLICY_WIDE``/``_NARROW``: the ``/8`` entries,
    ``@lanes8``), while each one-thread entry stays the count of the
    function's own work, its hidden-unit loop apart (``@inner``).  Each lane
    entry's template arguments start with its one-thread entry's, followed
    by the lanes and the lead flag."""
    instances = sass_ops.STEP_INSTANCES["fused_dfim_policy"]
    design = fp.DFIM_POLICY_WIDE
    assert fp.POLICY_LANE_DESIGNS["dfim_policy_record"] == (design, design)
    lanes, lead = design
    keys = []
    for head, joint in (("", "0"), ("/joint", "1")):
        one_thread = instances["dfim_policy_record" + head]
        assert one_thread == f"dfim_policy_record_kernelILb1ELb0ELi2ELb{joint}EE@inner"
        args = one_thread.partition("@")[0][len("dfim_policy_record_kernel"):-1]
        key = f"dfim_policy_record_lanes/{lanes}{head}"
        assert instances[key] == (f"dfim_policy_record_lanes_kernel{args}Li{lanes}"
                                  f"ELb{int(lead)}EE@lanes{lanes}")
        assert sass_ops.lanes_of(instances[key]) == lanes
        assert sass_ops.ws_steps_of(instances[key]) == 0
        keys += ["dfim_policy_record" + head, key]
    assert sorted(instances) == sorted(keys)
