"""chip_profile.py's SASS loop classifier on canned cuobjdump output.

``sass_loops`` finds each backward branch of one function in ``cuobjdump
--dump-sass`` text and counts the loop's instructions by class (FP32,
special-function, compare/select, integer, shared memory, shuffle, global,
barrier, branch, tensor-core), a predicate guard aside; with the MUFU count a pair it
also gives the loop's pairs and instructions a pair. The snippet below has
one loop with every class, a forward branch that is no loop, a trailing
self-branch, and a second function whose loop must not be counted.
"""

import pytest

import chip_profile

FUNC = ("_ZN12_GLOBAL__N_131fused_phi_terms_sympanel_kernel"
        "ILi11ELb1ELi3ELi2EEEvPKfS2_S2_NS_9TermSignsEiS2_iiiiiiPfPy")

SASS = f"""
	code for sm_90a
		Function : {FUNC}
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                 /* 0x00000a00ff017b82 */
                                                                          /* 0x000fe20000000800 */
        /*0010*/                   S2R R0, SR_TID.X ;                     /* 0x0000000000007919 */
        /*0020*/                   FADD R2, R3, -R4 ;                     /* 0x8000000403027221 */
        /*0030*/                   FMUL R5, R2, R2 ;                      /* 0x0000000202057220 */
        /*0040*/                   MUFU.EX2 R6, R5 ;                      /* 0x0000000500067308 */
        /*0050*/                   MUFU.EX2 R7, R5 ;                      /* 0x0000000500077308 */
        /*0060*/                   FFMA R8, R6, R9, R8 ;                  /* 0x0000000906087223 */
        /*0070*/               @P0 FSETP.GTU.AND P1, PT, R5, R10, PT ;    /* 0x0000000a0500020b */
        /*0080*/              @!P1 IADD3 R11, R11, 0x1, RZ ;              /* 0x000000010b0b9810 */
        /*0090*/                   LDS.128 R12, [R13] ;                   /* 0x000000000d0c7984 */
        /*00a0*/                   SHFL.IDX PT, R14, R14, R15, 0x1f ;     /* 0x00001f0f0e0e7589 */
        /*00b0*/               @P3 BRA 0xc0 ;                             /* 0x0000000000003947 */
        /*00c0*/                   STS [R16], R14 ;                       /* 0x0000000e10007388 */
        /*00d0*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;          /* 0x0000000000007b1d */
        /*00e0*/               @P2 BRA 0x20 ;                             /* 0xffffff3c00002947 */
        /*00f0*/                   RED.E.ADD.F32.FTZ.RN.STRONG.GPU [R2.64], R3 ; /* 0x000000030200798e */
        /*0100*/                   EXIT ;                                 /* 0x000000000000794d */
        /*0110*/                   BRA 0x110;                             /* 0xfffffff000007947 */
		Function : _ZN12_GLOBAL__N_1other_kernelEv
        /*0000*/                   FADD R1, R1, R1 ;                      /* 0x0000000101017221 */
        /*0010*/                   BRA 0x0 ;                              /* 0xfffffff000007947 */
"""

LOOP = {
    "start": "0x20", "end": "0xe0", "instructions": 13,
    "fp32": 3, "mufu": 2, "cmp_sel": 1, "int": 1, "shared": 2, "shuffle": 1,
    "global": 0, "barrier": 1, "branch": 2, "tensor": 0,
}
TAIL = {
    "start": "0x110", "end": "0x110", "instructions": 1,
    "fp32": 0, "mufu": 0, "cmp_sel": 0, "int": 0, "shared": 0, "shuffle": 0,
    "global": 0, "barrier": 0, "branch": 1, "tensor": 0,
}


def test_sass_loops_counts_each_class():
    assert chip_profile.sass_loops(SASS, FUNC) == [LOOP, TAIL]


@pytest.mark.parametrize("pairs_per,pairs", [(1, 2.0), (2, 1.0)])
def test_sass_loops_pairs_from_mufu(pairs_per, pairs):
    loop, tail = chip_profile.sass_loops(SASS, FUNC, pairs_per=pairs_per)
    assert loop == {**LOOP, "pairs": pairs, "per_pair": 13 / pairs}
    assert tail == TAIL  # no MUFU: no pair count


def test_sass_loops_reads_only_the_named_function():
    other = "_ZN12_GLOBAL__N_1other_kernelEv"
    assert chip_profile.sass_loops(SASS, other) == [{
        "start": "0x0", "end": "0x10", "instructions": 2,
        "fp32": 1, "mufu": 0, "cmp_sel": 0, "int": 0, "shared": 0,
        "shuffle": 0, "global": 0, "barrier": 0, "branch": 1, "tensor": 0,
    }]
    assert chip_profile.sass_loops(SASS, "no_such_kernel") == []


def test_sass_instances_name_paths_a_and_b():
    labels = [label for label, *_ in chip_profile.SASS_INSTANCES]
    assert labels == ["counts_sympanel<2,1,3>", "terms_sympanel<11,1,3,2>",
                      "count_le<2,1,0,1,5>", "count_le<2,1,0,0,3>",
                      "count_le<11,1,1,1,5>", "aniso_terms_sym<11,1,1,3>",
                      "terms_sym<11,1,3,2>", "phi_rbf_sym<11,1>",
                      "phi_rbf_square<11,1>", "counts_sym<2,1,3>",
                      "counts_square<50,1,3>", "terms_square<11,1,3,2>",
                      "terms_square<50,1,3,2>"]
    for _, kernel, args, per in chip_profile.SASS_INSTANCES:
        assert any(kernel + args[0] in f for f in (
            "_ZN12_GLOBAL__N_132fused_phi_counts_sympanel_kernel"
            "ILi2ELb1ELi3EEEvPKfS2_S2_S2_iiiiiPfPy", FUNC,
            COUNT_FUNC.replace("ILi2ELb1ELb0ELb1ELi5E", args[0]),
            "_ZN12_GLOBAL__N_132fused_phi_aniso_terms_sym_kernel"
            "ILi11ELb1ELi1ELi3EEEvPKfS2_S2_S2_N4svgd9TermSignsEifS2_iiiiPfPy",
            "_ZN12_GLOBAL__N_126fused_phi_terms_sym_kernel"
            "ILi11ELb1ELi3ELi2EEEvPKfS2_S2_N4svgd9TermSignsEiS2_iiiixPfPy",
            "_ZN12_GLOBAL__N_118phi_rbf_sym_kernelILi11ELb1EEEvPKfS2_S2_iiiiPf",
            "_ZN12_GLOBAL__N_121phi_rbf_square_kernelILi11ELb1EEEv"
            "PKfS2_S2_iiiiPf",
            "_ZN12_GLOBAL__N_127fused_phi_counts_sym_kernel"
            "ILi2ELb1ELi3EEEvPKfS2_S2_S2_iiiixPfPy",
            "_ZN12_GLOBAL__N_130fused_phi_counts_square_kernel"
            "ILi50ELb1ELi3EEEvPKfS2_S2_S2_S2_iiiiiPfPy",
            *(f"_ZN12_GLOBAL__N_129fused_phi_terms_square_kernel"
              f"ILi{mm}ELb1ELi3ELi2EEEvPKfS2_S2_S2_N4svgd9TermSignsEiS2_"
              f"iiiiiPfPy" for mm in (11, 50))))
        assert per in (1, 2, ("fp32", 5), ("fp32", 15))


COUNT_FUNC = ("_ZN12_GLOBAL__N_121count_le_cross_kernel"
              "ILi2ELb1ELb0ELb1ELi5EEEvPKfS2_S2_PKiiiiibiiiPy")


def test_sass_loops_pairs_from_another_class():
    """The count kernel evaluates no exponential: its pairs are the loop's
    FP32 instructions over those of one pair's sq (5 at m = 2)."""
    text = SASS.replace(FUNC, COUNT_FUNC)
    loop, tail = chip_profile.sass_loops(text, COUNT_FUNC, pairs_per=3,
                                         pair_class="fp32")
    assert loop == {**LOOP, "pairs": 1.0, "per_pair": 13.0}
    assert tail == TAIL
