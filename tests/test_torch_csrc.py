"""The CUDA sources on the CPU, where there is no nvcc: the PTX carry
chains of halo2tpu_torch/csrc/field.cuh, read from the file and run by a
small interpreter of the instructions they use, give the Montgomery
product, square, sum and difference of Python integers for Fr and Fq (edge
operands included); _build.parse_ptxas reads ptxas's register and spill
report and _build.parse_sass cuobjdump's instruction listing.  The
kernels themselves run in tests/test_torch_cuda.py on the card."""
import os
import re

import numpy as np
import pytest

from halo2tpu_torch import _build
from halo2tpu_torch.fields.bn254 import Q, R

M32 = 0xFFFFFFFF
SRC = os.path.join(_build.CSRC, "field.cuh")


def _asm_blocks(src: str, func: str) -> list:
    """The asm statements of a __device__ function of field.cuh, each a
    list of instructions."""
    i = src.index(f" {func}(")
    body = src[i:src.index("\n}\n", i)]
    blocks = []
    for m in re.finditer(r"asm\((.*?)\n\s*:", body, re.S):
        text = "".join(re.findall(r'"((?:[^"\\]|\\.)*)"', m.group(1)))
        text = text.replace("\\n", "").replace("\\t", "")
        blocks.append([s.strip() for s in text.split(";") if s.strip()])
    return blocks


def _run(ins: list, ops: list) -> list:
    """Interpret add/sub/mul/mad(.lo/.hi)(.cc) and their carry-in forms
    on u32 operands %0.. (a list, updated in place)."""
    cf = 0
    for s in ins:
        op, args = s.split(None, 1)
        a = [x.strip() for x in args.split(",")]
        v = [ops[int(x[1:])] if x.startswith("%") else int(x, 0)
             for x in a[1:]]
        parts = op.split(".")
        name = parts[0]
        if name in ("mad", "madc", "mul"):
            prod = v[0] * v[1]
            r = (prod & M32) if parts[1] == "lo" else prod >> 32
            if name != "mul":
                r += v[2] + (cf if name == "madc" else 0)
        elif name in ("add", "addc"):
            r = v[0] + v[1] + (cf if name == "addc" else 0)
        elif name in ("sub", "subc"):
            r = v[0] - v[1] - (cf if name == "subc" else 0)
        else:
            raise ValueError(f"instruction {op} not interpreted")
        if "cc" in parts:
            cf = int(r > M32 or r < 0)
        ops[int(a[0][1:])] = r & M32
    return ops


class FieldCuh:
    """fe_add, fe_sub, fe_mul, fe_sqr of field.cuh: the asm blocks from the
    file, the C++ around them (CIOS and SOS rounds) written out here."""

    def __init__(self, p: int):
        with open(SRC) as f:
            src = f.read()
        self.b = {f: _asm_blocks(src, f) for f in
                  ("sub8", "add8", "mac_row", "mac_row_carry", "fe_sqr")}
        self.p = self.limbs(p)
        self.inv = -pow(p, -1, 1 << 32) % (1 << 32)

    @staticmethod
    def limbs(x: int) -> list:
        return [(x >> (32 * i)) & M32 for i in range(8)]

    def _op8(self, name, a, b):
        ops = _run(self.b[name][0], [0] * 9 + a + b)
        return ops[:8], ops[8]

    def reduce_once(self, a, top):
        d, borrow = self._op8("sub8", a, self.p)
        return d if top or borrow == 0 else a

    def add(self, a, b):
        return self.reduce_once(*self._op8("add8", a, b))

    def sub(self, a, b):
        d, borrow = self._op8("sub8", a, b)
        return self._op8("add8", d, [x & borrow for x in self.p])[0]

    def mul(self, a, b):
        t = [0] * 9
        for i in range(8):
            t = _run(self.b["mac_row"][0], t + a + [b[i]])[:9]
            m = t[0] * self.inv & M32
            t = _run(self.b["mac_row"][0], t + self.p + [m])[:9]
            assert t[0] == 0
            t = t[1:] + [0]
        return self.reduce_once(t[:8], 0)

    def sqr(self, a):
        w = [0] * 16
        for block in self.b["fe_sqr"]:
            w = _run(block, w + a)[:16]
        c = 0
        for i in range(8):
            m = w[i] * self.inv & M32
            ops = _run(self.b["mac_row_carry"][0], w[i:i + 9] + [c] + self.p
                       + [m])
            w[i:i + 9], c = ops[:9], ops[9]
            assert w[i] == 0
        return self.reduce_once(w[8:], 0)


def _value(limbs) -> int:
    return sum(v << (32 * i) for i, v in enumerate(limbs))


@pytest.mark.parametrize("p", [R, Q], ids=["fr", "fq"])
def test_field_cuh_chains_match_integers(p):
    f = FieldCuh(p)
    rinv = pow(1 << 256, -1, p)
    rng = np.random.default_rng(p % 1000)
    edge = [0, 1, 2, p - 1, p - 2, (1 << 254) % p, 1 << 253, p >> 1]
    vals = edge + [int.from_bytes(rng.bytes(32), "big") % p
                   for _ in range(120)]
    pairs = [(x, y) for x in edge for y in edge] + list(
        zip(vals, vals[::-1]))
    for x, y in pairs:
        a, b = f.limbs(x), f.limbs(y)
        assert _value(f.mul(a, b)) == x * y * rinv % p, (x, y)
        assert _value(f.add(a, b)) == (x + y) % p, (x, y)
        assert _value(f.sub(a, b)) == (x - y) % p, (x, y)
    for x in vals:
        assert _value(f.sqr(f.limbs(x))) == x * x * rinv % p, x


PTXAS = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN46_GLOBAL__N__0a_mont_mul_cu_15mont_mul_kernelILb1EEEvPKjS2_Pjx7Modulus' for 'sm_90a'
ptxas info    : Function properties for _ZN46_GLOBAL__N__0a_mont_mul_cu_15mont_mul_kernelILb1EEEvPKjS2_Pjx7Modulus
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 34 registers, used 0 barriers, 472 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN46_GLOBAL__N__0b_ec_fold_cu_23fold_mixed_tiled_kernelEPKjPjS1_PKhxi7Modulus' for 'sm_90a'
ptxas info    : Function properties for _ZN46_GLOBAL__N__0b_ec_fold_cu_23fold_mixed_tiled_kernelEPKjPjS1_PKhxi7Modulus
    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 128 registers, used 0 barriers, 488 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN46_GLOBAL__N__0b_ec_fold_cu_17fold_mixed_kernelEPKjPjS1_S1_xiixii7Modulus' for 'sm_90a'
ptxas info    : Function properties for _ZN46_GLOBAL__N__0b_ec_fold_cu_17fold_mixed_kernelEPKjPjS1_S1_xiixii7Modulus
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 123 registers, used 0 barriers, 24576 bytes smem, 504 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN38_GLOBAL__N__c7_6_ntt_cu_58ff407715ntt_pass_kernelILi3EEEvNS_7NttPassE7Modulus' for 'sm_90a'
ptxas info    : Function properties for _ZN38_GLOBAL__N__c7_6_ntt_cu_58ff407715ntt_pass_kernelILi3EEEvNS_7NttPassE7Modulus
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN38_GLOBAL__N__c7_6_ntt_cu_58ff407715ntt_pass_kernelILi1EEEvNS_7NttPassE7Modulus' for 'sm_90a'
ptxas info    : Function properties for _ZN38_GLOBAL__N__c7_6_ntt_cu_58ff407715ntt_pass_kernelILi1EEEvNS_7NttPassE7Modulus
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 76 registers, used 1 barriers
"""


def test_parse_ptxas():
    res = _build.parse_ptxas(PTXAS)
    assert sorted(res) == ["fold_mixed_kernel", "fold_mixed_tiled_kernel",
                           "mont_mul_kernel<true>", "ntt_pass_kernel<1>",
                           "ntt_pass_kernel<3>"]
    assert [res[f"ntt_pass_kernel<{rb}>"]["registers"] for rb in (3, 1)] == [
        128, 76]
    fm = res["fold_mixed_kernel"]
    assert (fm["registers"], fm["spill_bytes"], fm["smem_bytes"]) == (
        123, 0, 24576)
    tiled = res["fold_mixed_tiled_kernel"]
    assert (tiled["registers"], tiled["stack_bytes"], tiled["spill_bytes"]) \
        == (128, 8, 16)
    assert res["mont_mul_kernel<true>"]["registers"] == 34
    assert len(fm["lines"]) == 4


SASS = """\
\tcode for sm_90a
\t\tFunction : _ZN43_GLOBAL__N__9ffe0043_10_ec_fold_cu_3dad9b9415fold_add_kernelEPKjS1_Pjx7Modulus
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                /* 0x00000a00ff017b82 */
                                                                         /* 0x000fe20000000800 */
        /*0010*/                   IMAD.WIDE.U32 R2, R5, UR4, R2 ;       /* 0x0000000405027c25 */
        /*0020*/              @!P0 IMAD.X R5, R6, R7, R8, P1 ;           /* 0x0000000706057224 */
        /*0030*/                   CALL.REL.NOINC 0x80 ;                 /* 0x0000000400107944 */
        /*0040*/                   CALL.REL.NOINC 0x80 ;                 /* 0x0000000400107944 */
        /*0050*/               @P0 CALL.REL.NOINC 0x70 ;                 /* 0x0000000000047944 */
        /*0060*/                   EXIT ;                                /* 0x000000000000794d */
        /*0070*/                   RET.REL.NODEC R2 0x0 ;                /* 0xffffff8002007950 */
        /*0080*/                   IMAD.MOV.U32 R2, RZ, RZ, R4 ;         /* 0x000000ffff027224 */
        /*0090*/                   IMAD.HI.U32 R1, R2, R3, RZ ;          /* 0x0000000302017227 */
        /*00a0*/                   RET.REL.NODEC R20 0x0 ;               /* 0xffffff5014007950 */
        /*00b0*/                   BRA 0xb0;                             /* 0xfffffffc00fc7947 */
        /*00c0*/                   NOP;                                  /* 0x0000000000007918 */
\t\tFunction : _ZN46_GLOBAL__N__0a_mont_mul_cu_15mont_mul_kernelILb0EEEvPKjS2_Pjx7Modulus
        /*0000*/                   EXIT ;                                /* 0x000000000000794d */
\t\tFunction : _Z9somethingv
        /*0000*/                   EXIT ;                                /* 0x000000000000794d */
"""


def test_parse_sass():
    res = _build.parse_sass(SASS)
    assert sorted(res) == ["fold_add_kernel", "mont_mul_kernel<false>"]
    (add,) = res["fold_add_kernel"]
    assert (add["instructions"], add["imad"], add["imad_wide"]) == (12, 4, 1)
    assert add["parts"] == [
        {"address": 0, "body_calls": 0, "instructions": 7, "imad": 2,
         "imad_wide": 1},
        {"address": 0x70, "body_calls": 1, "instructions": 1, "imad": 0,
         "imad_wide": 0},
        {"address": 0x80, "body_calls": 2, "instructions": 4, "imad": 2,
         "imad_wide": 0}]
    assert res["mont_mul_kernel<false>"] == [
        {"instructions": 1, "imad": 0, "imad_wide": 0,
         "parts": [{"address": 0, "body_calls": 0, "instructions": 1,
                    "imad": 0, "imad_wide": 0}]}]
