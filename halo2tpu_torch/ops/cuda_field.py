"""Montgomery multiply and power: the CUDA kernels (csrc/mont_mul.cu) and
their plain torch versions.  Counterparts of halo2tpu/ops/pallas_field.py
and of halo2tpu/fields/jfield.py::mont_pow.

`mont_mul` and `mont_pow` launch their kernels for CUDA tensors and take
the plain versions only for CPU tensors.  The plain versions work on any
device (chip_smoke.py compares them with the kernels on the card).  Beside
its count of launches, each wrapper keeps `shapes`, a histogram of the lane
counts it launched: (lanes,).

Field constants come from a halo2tpu_torch.fields.jfield.FieldSpec.
"""
from __future__ import annotations

from collections import Counter

import ctypes

import torch
import torch.nn.functional as F

NLIMB = 8
_M16 = 0xFFFF

_AUX: dict = {}


def _aux(name: str, k: int, device) -> torch.Tensor:
    key = (name, k, device)
    t = _AUX.get(key)
    if t is None:
        idx = torch.arange(k, dtype=torch.int64, device=device)
        t = (torch.ones_like(idx) << idx) if name == "pow2" else idx
        _AUX[key] = t
    return t


def carry_in(gen: torch.Tensor, prop: torch.Tensor) -> torch.Tensor:
    """Carry chain over the last axis (K <= 62 limbs) as one parallel
    prefix: limb i generates a carry (gen) or passes its incoming carry on
    (prop).  Returns (..., K + 1) 0/1: the carry INTO each limb, then the
    carry out of the top limb.  With G, P the bit masks, the carries are
    ((G | P) + G) ^ P: the sum bit of limb i is p_i ^ carry_i."""
    k = gen.shape[-1]
    w = _aux("pow2", k, gen.device)
    g = (gen * w).sum(-1)
    x = ((gen | prop) * w).sum(-1)
    c = (x + g) ^ (x - g)
    return (c.unsqueeze(-1) >> _aux("idx", k + 1, gen.device)) & 1


def _split16(x):
    """(..., 8) int32 limbs -> (..., 16) int64 16-bit sub-limbs."""
    x64 = x.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([x64 & _M16, x64 >> 16], -1).flatten(-2)


def _join16(r):
    """(..., 16) exact 16-bit limbs (int64) -> (..., 8) int32 limbs."""
    r = r.unflatten(-1, (NLIMB, 2))
    v = r[..., 0] | (r[..., 1] << 16)
    return (v - ((v >> 31) << 32)).to(torch.int32)


def _norm16(c, rounds: int = 2):
    """Lazy nonnegative columns (< 2^40) -> exact 16-bit limbs (same width,
    value mod 2^(16 K)).  Each round moves every column's excess up one
    column (the top column's excess is dropped); after two rounds every
    column is < 2^16 + 2^9, so each carries at most 1 out and one parallel
    carry chain finishes."""
    for _ in range(rounds):
        hi = c >> 16
        c = c & _M16
        c[..., 1:] += hi[..., :-1]
    cin = carry_in(c > _M16, c == _M16)
    return (c + cin[..., :-1]) & _M16


def _matmul_exact(x, m):
    """x (..., k) int64 @ m (k, j) float64 for integer operands whose
    partial sums stay below 2^53: exact in float64 on any device."""
    return (x.to(torch.float64) @ m).to(torch.int64)


def mont_mul_plain(spec, a, b):
    """a * b * 2^-256 mod p in plain torch: SOS reduction over 16-bit
    sub-limbs (a 32 x 32-bit product would overflow signed int64).  Every
    convolution is a float64 matrix product whose partial sums are integers
    below 2^36, so it is exact.  Canonical output, bit-identical to the
    kernel."""
    dev = a.device
    a16 = _split16(a).to(torch.float64)
    b16 = _split16(b).to(torch.float64)
    outer = a16.unsqueeze(-1) * b16.unsqueeze(-2)          # (..., 16, 16)
    T = (outer.flatten(-2) @ spec.const("diag_sum", dev)).to(torch.int64)
    tl = _norm16(T[..., :16])                           # T mod 2^256
    m = _norm16(_matmul_exact(tl, spec.const("pinv_t", dev)))
    mp = _matmul_exact(m, spec.const("p_t", dev))          # (..., 31)
    Z = _norm16(F.pad(T + mp, (0, 1)))                  # (..., 32)
    r = Z[..., 16:]                      # Z / 2^256 < 2p < 2^255
    t = r - spec.const("p16", dev)
    bb = carry_in(t < 0, t == 0)
    d = (t - bb[..., :-1]) & _M16
    r = torch.where(bb[..., -1:] == 0, d, r)
    return _join16(r)


def mont_mul(spec, a, b):
    """Lanewise Montgomery product of (..., 8) int32 tensors (broadcast).
    CUDA tensors launch the kernel; CPU tensors take mont_mul_plain.  When
    a and b are one buffer the kernel takes its squaring (same bits)."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return mont_mul_plain(spec, a, b)
    if a.device != b.device or a.device.type != "cuda":
        raise ValueError(f"mont_mul: operands on {a.device} and {b.device}")
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise TypeError("mont_mul: operands must be int32 limb tensors")
    if a.shape[-1] != NLIMB or b.shape[-1] != NLIMB:
        raise ValueError(f"mont_mul: limb axis must be {NLIMB}")
    from .._build import check, lib
    a, b = torch.broadcast_tensors(a, b)
    a = a.contiguous()
    b = b.contiguous()
    out = torch.empty(a.shape, dtype=torch.int32, device=a.device)
    n = a.numel() // NLIMB
    stream = torch.cuda.current_stream(a.device).cuda_stream
    check(lib().h2_mont_mul(a.data_ptr(), b.data_ptr(), out.data_ptr(), n,
                            spec.mod_words_ptr, stream), "mont_mul")
    mont_mul.launches += 1
    mont_mul.shapes[(n,)] += 1
    return out


mont_mul.launches = 0
mont_mul.shapes = Counter()


def mont_pow_plain(spec, a, e: int):
    """a^e lanewise for a python-int exponent: square-and-multiply from the
    lowest bit, one mont_mul_plain a product or squaring."""
    result = spec.const("one_mont", a.device).expand(a.shape)
    base = a
    while e:
        if e & 1:
            result = mont_mul_plain(spec, result, base)
        e >>= 1
        if e:
            base = mont_mul_plain(spec, base, base)
    return result


def mont_pow(spec, a, e: int):
    """a^e lanewise, (..., 8) int32 limbs, 0 <= e < 2^256.  A CUDA tensor
    takes one launch of the kernel (the whole square-and-multiply chain);
    a CPU tensor takes mont_pow_plain."""
    if not 0 <= e < 1 << 256:
        raise ValueError("mont_pow: exponent out of [0, 2^256)")
    if a.device.type == "cpu":
        return mont_pow_plain(spec, a, e)
    if a.device.type != "cuda":
        raise ValueError(f"mont_pow: operand on {a.device}")
    if a.dtype != torch.int32 or a.shape[-1] != NLIMB:
        raise TypeError("mont_pow: operand must be an int32 limb tensor")
    from .._build import check, lib
    a = a.contiguous()
    out = torch.empty(a.shape, dtype=torch.int32, device=a.device)
    n = a.numel() // NLIMB
    words = (ctypes.c_uint32 * NLIMB)(*[(e >> (32 * i)) & 0xFFFFFFFF
                                         for i in range(NLIMB)])
    stream = torch.cuda.current_stream(a.device).cuda_stream
    check(lib().h2_mont_pow(a.data_ptr(), out.data_ptr(), n,
                            ctypes.addressof(words), e.bit_length(),
                            spec.mod_words_ptr, stream), "mont_pow")
    mont_pow.launches += 1
    mont_pow.shapes[(n,)] += 1
    return out


mont_pow.launches = 0
mont_pow.shapes = Counter()
