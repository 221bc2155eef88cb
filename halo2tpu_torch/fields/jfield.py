"""Vectorized BN254 field arithmetic on torch tensors.

Port of halo2tpu/fields/jfield.py.  A field element is a (..., 8) int32
tensor holding eight little-endian 32-bit limbs (read as uint32), value
canonical in [0, p) and in Montgomery form with R = 2^256 — the same bytes
as halo2tpu's (..., 16) 16-bit limbs, so raw Montgomery arrays convert
without arithmetic (halo2tpu_torch/convert.py).

mont_mul launches the CUDA kernel (ops/cuda_field.py) for CUDA tensors and
runs its plain torch version for CPU tensors.  add/sub/neg and the scans
are plain torch on either device.  CPU torch has no uint32 add, shift or
compare, so limbs are widened to int64 inside every function.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .bn254 import Q, R as FR_MOD
from ..ops import cuda_field
from ..ops.cuda_field import carry_in

NLIMB = 8
LIMB_BITS = 32
MASK = (1 << LIMB_BITS) - 1


# -- numpy helpers (host side, no torch) ----------------------------------

def int_to_limbs(v: int) -> np.ndarray:
    """python int -> (8,) int32 limbs (uint32 bit patterns)."""
    return np.array([(v >> (LIMB_BITS * i)) & MASK for i in range(NLIMB)],
                    dtype=np.uint32).view(np.int32)


def ints_to_limbs16(vals) -> np.ndarray:
    """python ints -> (n, 16) uint16 limbs: the host wire format, and the
    proving key's fixed-column format (shared with halo2tpu)."""
    buf = b"".join(int(v).to_bytes(32, "little") for v in vals)
    return np.frombuffer(buf, dtype="<u2").reshape(len(vals), 16)


def limbs16_to_limbs(u16) -> np.ndarray:
    """(..., 16) 16-bit limbs -> (..., 8) int32 limbs of the same value."""
    arr = np.ascontiguousarray(np.asarray(u16).astype("<u2", copy=False))
    return arr.view("<u4").view(np.int32).reshape(arr.shape[:-1] + (NLIMB,))


def ints_to_limbs(vals) -> np.ndarray:
    """python ints -> (n, 8) int32 limbs."""
    return limbs16_to_limbs(ints_to_limbs16(vals))


def limbs_to_int(limbs) -> int:
    """(8,) 32-bit or (16,) 16-bit limbs -> python int."""
    return limbs_to_ints(np.asarray(limbs)[None])[0]


def limbs_to_ints(arr) -> list[int]:
    """(..., 8) 32-bit or (..., 16) 16-bit limbs -> python ints."""
    arr = np.asarray(arr)
    width = arr.shape[-1]
    dt = {NLIMB: "<u4", 2 * NLIMB: "<u2"}[width]
    raw = np.ascontiguousarray(arr.reshape(-1, width).astype(dt)).tobytes()
    return [int.from_bytes(raw[i * 32:(i + 1) * 32], "little")
            for i in range(len(raw) // 32)]


def device_of(device) -> torch.device:
    """Normalize a device spec; "cuda" becomes the current CUDA device.
    Asking for CUDA where there is none raises (never runs on the CPU)."""
    d = torch.device(device)
    if d.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA device requested but CUDA is not "
                               "available")
        if d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
    return d


def _toeplitz(v: int, rows: int, cols: int) -> np.ndarray:
    """M[k, j] = 16-bit limb (j - k) of v (0 outside [0, 16)): the lazy
    column sums of x * v are x16 @ M."""
    v16 = [(v >> (16 * i)) & 0xFFFF for i in range(16)]
    M = np.zeros((rows, cols), np.float64)
    for k in range(rows):
        for j in range(k, min(cols, k + 16)):
            M[k, j] = v16[j - k]
    return M


class FieldSpec:
    """Per-modulus constants.  Tensors are made per device on first use."""

    def __init__(self, p: int):
        self.p = p
        self.r = (1 << 256) % p          # Montgomery R
        self.r2 = self.r * self.r % p
        self._np = {
            "p64": int_to_limbs(p).view(np.uint32).astype(np.int64),
            "p16": np.array([(p >> (16 * i)) & 0xFFFF for i in range(16)],
                            np.int64),
            # plain mont_mul: x * (-p^-1 mod 2^256) low half, and m * p
            "pinv_t": _toeplitz((-pow(p, -1, 1 << 256)) % (1 << 256), 16, 16),
            "p_t": _toeplitz(p, 16, 31),
            # (16 x 16 outer product, flattened) @ diag_sum = column sums
            "diag_sum": np.array([[float(i // 16 + i % 16 == j)
                                   for j in range(31)] for i in range(256)]),
            "r2": int_to_limbs(self.r2),
            "one_plain": int_to_limbs(1),
            "one_mont": int_to_limbs(self.r),
        }
        self._dev: dict = {}
        # kernel modulus words: p[8], -p^-1 mod 2^32, Montgomery one[8]
        words = ([(p >> (32 * i)) & MASK for i in range(NLIMB)]
                 + [(-pow(p, -1, 1 << 32)) % (1 << 32)]
                 + [(self.r >> (32 * i)) & MASK for i in range(NLIMB)])
        self._mod_words = (ctypes.c_uint32 * len(words))(*words)
        self.mod_words_ptr = ctypes.addressof(self._mod_words)

    def const(self, name: str, device) -> torch.Tensor:
        t = self._dev.get((name, device))
        if t is None:
            d = device_of(device)
            t = torch.from_numpy(self._np[name].copy()).to(d)
            self._dev[(name, device)] = self._dev[(name, d)] = t
        return t

    # -- conversions -------------------------------------------------------
    def to_mont(self, a):
        return mont_mul(self, a, self.const("r2", a.device))

    def from_mont(self, a):
        return mont_mul(self, a, self.const("one_plain", a.device))

    def encode(self, vals, device="cuda") -> torch.Tensor:
        """python ints -> (n, 8) Montgomery tensor on `device`."""
        limbs = ints_to_limbs([v % self.p for v in vals]).copy()
        return self.to_mont(torch.from_numpy(limbs).to(device_of(device)))

    def encode_packed(self, u16_arr, device="cuda") -> torch.Tensor:
        """(..., 16) uint16 plain limbs (host numpy) -> Montgomery."""
        limbs = limbs16_to_limbs(u16_arr).copy()
        return self.to_mont(torch.from_numpy(limbs).to(device_of(device)))

    def encode_narrow_stack(self, main_u16, tail_u16, split: int,
                            device="cuda") -> torch.Tensor:
        """main_u16 (L, n) uint16 VALUES (rows >= split zeroed), tail_u16
        (L, n - split, 16) full limbs of the tail rows -> (L, n, 8)
        Montgomery."""
        d = device_of(device)
        main = torch.from_numpy(np.asarray(main_u16).astype(np.int32)).to(d)
        tail = torch.from_numpy(limbs16_to_limbs(tail_u16).copy()).to(d)
        L, n = main.shape
        limbs = torch.zeros((L, n, NLIMB), dtype=torch.int32, device=d)
        limbs[:, :, 0] = main
        limbs[:, split:] = tail
        return self.to_mont(limbs)

    def decode(self, arr) -> list[int]:
        plain = self.from_mont(arr)
        return limbs_to_ints(plain.cpu().numpy())


FQ = FieldSpec(Q)
FR = FieldSpec(FR_MOD)


# -- limb arithmetic helpers (int64 carriers) ------------------------------

def u64(x: torch.Tensor) -> torch.Tensor:
    """int32 limbs -> int64 holding the uint32 values."""
    return x.to(torch.int64) & MASK


def i32(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 bit patterns."""
    return (v - ((v >> 31) << 32)).to(torch.int32)


def _add_limbs(x, y):
    """x + y over 32-bit limbs (int64 carriers): (limbs, carry out)."""
    s = x + y
    lo = s & MASK
    c = carry_in(s > MASK, lo == MASK)
    return (lo + c[..., :-1]) & MASK, c[..., -1]


def _sub_limbs(x, y):
    """x - y over 32-bit limbs: (limbs mod 2^256, borrow out)."""
    t = x - y
    b = carry_in(t < 0, t == 0)
    return (t - b[..., :-1]) & MASK, b[..., -1]


# -- field ops ---------------------------------------------------------------

def mont_mul(spec: FieldSpec, a, b):
    """Montgomery product a * b * 2^-256 mod p, canonical (broadcasts)."""
    return cuda_field.mont_mul(spec, a, b)


def add(spec: FieldSpec, a, b):
    s, top = _add_limbs(u64(a), u64(b))
    d, borrow = _sub_limbs(s, spec.const("p64", s.device))
    ge = (top == 1) | (borrow == 0)
    return i32(torch.where(ge.unsqueeze(-1), d, s))


def sub(spec: FieldSpec, a, b):
    """a - b mod p, inputs canonical."""
    d, borrow = _sub_limbs(u64(a), u64(b))
    e, _ = _add_limbs(d, spec.const("p64", d.device))
    return i32(torch.where((borrow == 1).unsqueeze(-1), e, d))


def neg(spec: FieldSpec, a):
    return sub(spec, torch.zeros_like(a), a)


def is_zero(a):
    return (a == 0).all(-1)


def eq(a, b):
    return (a == b).all(-1)


def one_like(spec: FieldSpec, a):
    return spec.const("one_mont", a.device).expand(a.shape)


def mont_pow(spec: FieldSpec, a, e: int):
    """a^e for a python-int exponent (square-and-multiply)."""
    result = one_like(spec, a)
    base = a
    while e:
        if e & 1:
            result = mont_mul(spec, result, base)
        e >>= 1
        if e:
            base = mont_mul(spec, base, base)
    return result


def inv(spec: FieldSpec, a):
    """Fermat inversion a^(p-2); a must be nonzero."""
    return mont_pow(spec, a, spec.p - 2)


def _prefix_sum_mod(spec: FieldSpec, a):
    """Inclusive prefix sum mod p along axis 0 (Hillis-Steele rounds)."""
    n = a.shape[0]
    x = a
    shift = 1
    while shift < n:
        x = torch.cat([x[:shift], add(spec, x[shift:], x[:n - shift])])
        shift *= 2
    return x


def suffix_sum_mod(spec: FieldSpec, a):
    """S[i] = sum_{j >= i} a[j] mod p over axis 0."""
    return torch.flip(_prefix_sum_mod(spec, torch.flip(a, [0])), [0])


_SCAN_BLOCK = 16


def _prefix_prod(spec: FieldSpec, a):
    """Inclusive prefix product along axis 0, blocked: a sequential scan
    inside blocks of 16 rows (16 batched multiplies over n/16 rows each),
    the same scan recursively over the block totals, then one multiply by
    each block's exclusive prefix — about 2n products in all."""
    n = a.shape[0]
    b = _SCAN_BLOCK
    if n <= b:
        rows = [a[0]]
        for i in range(1, n):
            rows.append(mont_mul(spec, rows[-1], a[i]))
        return torch.stack(rows)
    nb = -(-n // b)
    pad = one_like(spec, a[:1]).expand((nb * b - n,) + a.shape[1:])
    x = torch.cat([a, pad]).reshape((nb, b) + a.shape[1:])
    cols = [x[:, 0]]
    for j in range(1, b):
        cols.append(mont_mul(spec, cols[-1], x[:, j]))
    x = torch.stack(cols, dim=1)
    carry = _prefix_prod(spec, x[:, -1])[:-1]       # block totals' prefix
    x = torch.cat([x[:1], mont_mul(spec, x[1:], carry[:, None])])
    return x.reshape((nb * b,) + a.shape[1:])[:n]


def batch_inv_scan(spec: FieldSpec, a):
    """Batched inversion over the leading axis: prefix/suffix products +
    one Fermat inversion.  a: (n, 8), nonzero entries."""
    prefix = _prefix_prod(spec, a)
    suffix = torch.flip(_prefix_prod(spec, torch.flip(a, [0])), [0])
    total_inv = inv(spec, prefix[-1:])
    one = spec.const("one_mont", a.device)[None]
    prefix_shift = torch.cat([one, prefix[:-1]])
    suffix_shift = torch.cat([suffix[1:], one])
    return mont_mul(spec, mont_mul(spec, prefix_shift, suffix_shift),
                    total_inv)
