"""tools/sass_ops.py: the per-step instruction counts behind the fused
kernels' bounds, on a hand-written SASS listing in cuobjdump's format.

The loop below runs from 0x0020 to its backward branch at 0x00c0; the
block 0x0050-0x0060 is skipped when P0 holds, so it is conditional, and
everything else in the loop runs every iteration.  Counts are exact
integers, so the test compares them exactly.
"""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
import sass_ops  # noqa: E402

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
    assert counts["always"] == {"fp32": 3, "alu": 3, "imad": 0, "xu": 0}
    assert counts["conditional"] == {"fp32": 0, "alu": 0, "imad": 1, "xu": 1}


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
])
def test_classify(op, args, want):
    assert sass_ops.classify(op, args) == want
