"""The card's peaks and the roofline bound (chip_smoke.py's constants).

NVIDIA H100 SXM: HBM3 at 3.35 TB/s (NVIDIA's data sheet); 32-bit integer
multiplies at 64 an SM a clock (compute capability 9.0) on 132 SMs at
1980 MHz.  One CIOS Montgomery product of 8 32-bit limbs takes 8 rounds of
8 a*b and 8 m*p products, each two 32-bit multiplies (low and high), and
one m = t0 * inv a round: 264; a squaring takes the 36 distinct a_i*a_j
in place of the 64 a*b: 208.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
SMS = 132
IMAD_PER_SM_CLOCK = 64
CLOCK_HZ = 1.98e9
MUL32_PER_S = SMS * IMAD_PER_SM_CLOCK * CLOCK_HZ
MUL32_PER_MONT = 8 * (8 + 8) * 2 + 8
MUL32_PER_SQR = (36 + 64) * 2 + 8


def mul32(products: int, squares: int = 0) -> int:
    return products * MUL32_PER_MONT + squares * MUL32_PER_SQR


def bound_s(nbytes: float, mul32s: float) -> float:
    """The least time the card could take: the larger of moving the bytes
    at peak bandwidth and doing the 32-bit multiplies at peak rate."""
    return max(nbytes / HBM_BYTES_PER_S, mul32s / MUL32_PER_S)
