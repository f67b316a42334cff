"""The SASS instruction-mix reader (art_tpu_torch/sass_mix.py) on a
piece of `cuobjdump -sass` text: no toolkit needed."""

from art_tpu_torch import sass_mix

SASS = """
\tcode for sm_90a
\t\tFunction : _Z1kPf
\t.headerflags\t@"EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;   /* 0x00000a00ff017b82 */
                                                            /* 0x000fe40000000800 */
        /*0010*/                   LDS.U.128 R4, [R2] ;
        /*0020*/              @!P0 MUFU.RSQ R3, R2 ;
        /*0030*/               @P1 FADD.FTZ R5, R4, c[0x3][0x0] ;
        /*0040*/                   FMUL R6, R5, R5 ;
        /*0050*/                   FSETP.GT.AND P0, PT, R6, RZ, PT ;
        /*0060*/                   EXIT ;
        /*0070*/                   NOP;
\t\tFunction : _Z1gv
        /*0000*/                   EXIT ;
"""


def test_counts_by_class():
    counts = sass_mix.opcode_counts(SASS)
    assert list(counts) == ["_Z1kPf", "_Z1gv"]
    assert sass_mix.mix(counts["_Z1kPf"]) == {
        "LDS": 1, "LDC": 1, "MUFU": 1, "FP32": 3, "total": 7}
    assert sass_mix.mix(counts["_Z1gv"])["total"] == 1
