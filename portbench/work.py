"""The work a proof asks of the NTT and the MSM, counted from what is
transformed and committed, never from how the program launches it.

NTT: each transform of C columns of n rows needs (n/2) log2 n Montgomery
products a column, and reads and writes each of its n C field elements
(32 bytes) once.  The scales a kernel fuses in (coset powers, 1/n) are not
counted: the transform's size and column count (the program's
`ntt_kernel.shapes`) do not say which it fused.

MSM: each commitment is a multi-scalar multiplication over n bases whose
scalars have a known bit width.  It is counted as the bucket (Pippenger)
method with the window c that makes it cheapest: in each window of c bits
every base whose scalars reach it is one mixed addition into a bucket
(7M + 4S), the running-sum reduction of the 2^c - 1 buckets is two full
additions each (11M + 5S), and between windows the accumulator doubles c
times (2M + 5S, dbl-2009-l).  Inputs: each affine base (64 bytes) and
scalar (32 bytes) read once, the point (64 bytes) written once.
"""
from __future__ import annotations

import math

from .peaks import mul32

FIELD_BYTES = 32
AFFINE_BYTES = 64
MIXED_ADD = (7, 4)
FULL_ADD = (11, 5)
DOUBLE = (2, 5)
FULL_BITS = 254


def ntt_work(shapes) -> tuple:
    """shapes: {(n, C, ...): transforms} -> (bytes, 32-bit multiplies)."""
    nbytes = mul = 0
    for key, count in shapes.items():
        n, cols = key[0], key[1]
        products = (n // 2) * int(math.log2(n)) * cols
        nbytes += count * 2 * n * cols * FIELD_BYTES
        mul += count * mul32(products)
    return nbytes, mul


def msm_ops(groups) -> tuple:
    """groups: [(bases, scalar bits)] of one MSM -> (products, squares) of
    the cheapest bucket method over window sizes 1..24."""
    groups = [(count, bits) for count, bits in groups if count and bits]
    if not groups:
        return 0, 0
    top = max(bits for _, bits in groups)
    best = None
    for c in range(1, 25):
        windows = -(-top // c)
        adds = sum(count * -(-bits // c) for count, bits in groups)
        full = windows * 2 * ((1 << c) - 1)
        dbl = (windows - 1) * c
        m = adds * MIXED_ADD[0] + full * FULL_ADD[0] + dbl * DOUBLE[0]
        s = adds * MIXED_ADD[1] + full * FULL_ADD[1] + dbl * DOUBLE[1]
        cost = mul32(m, s)
        if best is None or cost < best[0]:
            best = (cost, m, s)
    return best[1], best[2]


def msm_work(commitments) -> tuple:
    """commitments: [[(bases, bits), ...] per MSM] -> (bytes, 32-bit
    multiplies)."""
    nbytes = mul = 0
    for groups in commitments:
        m, s = msm_ops(groups)
        bases = sum(count for count, _ in groups)
        nbytes += bases * (AFFINE_BYTES + FIELD_BYTES) + AFFINE_BYTES
        mul += mul32(m, s)
    return nbytes, mul


def proof_commitments(cs, k: int, advice_bits) -> list:
    """The MSMs of one proof, from the constraint system and the advice
    columns' widths (the largest value's bit length over the rows before
    the blinding rows, which take full-width random values): the advice
    columns; each lookup's permuted input and table (at the lookup's
    declared width); the permutation and lookup grand products; the
    vanishing argument's random polynomial; the quotient's pieces; the
    SHPLONK openings W and W'."""
    n = 1 << k
    u = n - (cs.blinding_factors() + 1)

    def narrow(bits):
        return [(u, FULL_BITS if bits is None else min(bits, FULL_BITS)),
                (n - u, FULL_BITS)]
    full = [(n, FULL_BITS)]
    out = [narrow(b) for b in advice_bits]
    for lk in cs.lookups:
        out += [narrow(getattr(lk, "max_bits", None))] * 2
    out += [full] * (cs.num_permutation_chunks() + len(cs.lookups))
    out += [full]                              # the random polynomial
    out += [full] * (cs.degree() - 1)          # the quotient's pieces
    out += [full] * 2                          # W, W'
    return out
