"""Vectorized BN254 field arithmetic on torch tensors.

Port of halo2tpu/fields/jfield.py.  A field element is a (..., 8) int32
tensor holding eight little-endian 32-bit limbs (read as uint32), value
canonical in [0, p) and in Montgomery form with R = 2^256 — the same bytes
as halo2tpu's (..., 16) 16-bit limbs, so raw Montgomery arrays convert
without arithmetic (halo2tpu_torch/convert.py).

mont_mul, mont_pow, add/sub/neg, the prefix and suffix sums (the linear
scan) and the prefix products (the product scan) launch the CUDA kernels
(ops/cuda_field.py) for CUDA tensors and run their plain torch versions
for CPU tensors.
Python ints become host limbs through the host packer (csrc/host_pack.c,
pack_limbs16 and pack_u16), and random big-endian words through its
reduce_be256, on every device.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .bn254 import Q, R as FR_MOD
from .. import _build
from ..ops import cuda_field
from ..ops.cuda_field import i32, u64  # noqa: F401  (the limb helpers)
from ..utils import trace

NLIMB = 8
LIMB_BITS = 32
MASK = (1 << LIMB_BITS) - 1


# -- numpy helpers (host side, no torch) ----------------------------------

def int_to_limbs(v: int) -> np.ndarray:
    """python int -> (8,) int32 limbs (uint32 bit patterns)."""
    return np.array([(v >> (LIMB_BITS * i)) & MASK for i in range(NLIMB)],
                    dtype=np.uint32).view(np.int32)


def _pack(entry: str, vals, out: np.ndarray, row: tuple) -> None:
    """The first len(out) ints of vals into out, of rows shaped `row`,
    through the host packer (csrc/host_pack.c); a traced proof counts the
    values (pack_values) and those that took the packer's long path, at or
    above 2^30 (pack_long_values)."""
    if out.dtype != np.dtype("<u2") or out.shape[1:] != row or not (
            out.flags.c_contiguous and out.flags.writeable):
        raise ValueError(f"{entry}: out must be a writable C-contiguous "
                         f"<u2 array of rows {row}")
    n = out.shape[0]
    if n > len(vals):
        raise ValueError(f"{entry}: {n} rows, {len(vals)} values")
    long_values = getattr(_build.host_lib(), entry)(vals, out.ctypes.data, n)
    rec = trace.current()
    rec.count("pack_values", n)
    rec.count("pack_long_values", long_values)


def pack_limbs16(vals, out: np.ndarray) -> None:
    """Python ints (a list or an object ndarray; numpy integers read
    through __index__) -> out, (m, 16) uint16: the first m values, each
    little-endian over 32 bytes.  A value outside [0, 2^256) raises
    OverflowError, a non-integer TypeError."""
    _pack("pack_limbs16", vals, out, (16,))


def pack_u16(vals, out: np.ndarray) -> None:
    """Python ints below 2^16 -> out, (m,) uint16: the first m values.  A
    value outside [0, 2^16) raises OverflowError."""
    _pack("pack_u16", vals, out, ())


def reduce_be256(raw, mod: int, out: np.ndarray) -> None:
    """The first len(out) 32-byte big-endian words of raw (bytes), each
    reduced mod `mod` (2^250 <= mod < 2^256) -> out, (m, 16) uint16: row i
    is int.from_bytes(raw[32 i:32 i + 32], "big") % mod, little-endian
    over 32 bytes (csrc/host_pack.c)."""
    if out.dtype != np.dtype("<u2") or out.shape[1:] != (16,) or not (
            out.flags.c_contiguous and out.flags.writeable):
        raise ValueError("reduce_be256: out must be a writable C-contiguous "
                         "<u2 array of rows (16,)")
    if not 250 < mod.bit_length() <= 256:
        raise ValueError(f"reduce_be256: a {mod.bit_length()}-bit modulus")
    n = out.shape[0]
    if 32 * n > len(raw):
        raise ValueError(f"reduce_be256: {n} rows, {len(raw)} bytes")
    words = (ctypes.c_uint64 * 4)(*((mod >> (64 * i)) & ((1 << 64) - 1)
                                    for i in range(4)))
    _build.host_lib().reduce_be256(raw, n, words, out.ctypes.data)


def ints_to_limbs16(vals) -> np.ndarray:
    """python ints -> (n, 16) uint16 limbs: the host wire format, and the
    proving key's fixed-column format (shared with halo2tpu)."""
    out = np.empty((len(vals), 16), "<u2")
    pack_limbs16(vals, out)
    return out


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
        self.ninv256 = (-pow(p, -1, 1 << 256)) % (1 << 256)
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

    # A traced proof counts the bytes each encode copies to the device
    # (h2d_bytes) and each decode, a blocking read (d2h_reads; the
    # engine's lookup check counts the prover's one other).
    def encode(self, vals, device="cuda") -> torch.Tensor:
        """python ints -> (n, 8) Montgomery tensor on `device`."""
        limbs = ints_to_limbs([v % self.p for v in vals])
        trace.current().count("h2d_bytes", limbs.nbytes)
        return self.to_mont(torch.from_numpy(limbs).to(device_of(device)))

    def encode_packed(self, u16_arr, device="cuda") -> torch.Tensor:
        """(..., 16) uint16 plain limbs (host numpy, writable: the tensor
        made on the CPU views them until to_mont) -> Montgomery."""
        limbs = limbs16_to_limbs(u16_arr)
        trace.current().count("h2d_bytes", limbs.nbytes)
        return self.to_mont(torch.from_numpy(limbs).to(device_of(device)))

    def encode_narrow_stack(self, main_u16, tail_u16, split: int,
                            device="cuda") -> torch.Tensor:
        """main_u16 (L, n) uint16 VALUES (rows >= split zeroed), tail_u16
        (L, n - split, 16) full limbs of the tail rows -> (L, n, 8)
        Montgomery."""
        d = device_of(device)
        main = np.asarray(main_u16).astype(np.int32)
        tail = limbs16_to_limbs(tail_u16).copy()
        trace.current().count("h2d_bytes", main.nbytes + tail.nbytes)
        main = torch.from_numpy(main).to(d)
        tail = torch.from_numpy(tail).to(d)
        L, n = main.shape
        limbs = torch.zeros((L, n, NLIMB), dtype=torch.int32, device=d)
        limbs[:, :, 0] = main
        limbs[:, split:] = tail
        return self.to_mont(limbs)

    def decode(self, arr) -> list[int]:
        trace.current().count("d2h_reads")
        plain = self.from_mont(arr)
        return limbs_to_ints(plain.cpu().numpy())


FQ = FieldSpec(Q)
FR = FieldSpec(FR_MOD)


# -- field ops ---------------------------------------------------------------

def mont_mul(spec: FieldSpec, a, b):
    """Montgomery product a * b * 2^-256 mod p, canonical (broadcasts)."""
    return cuda_field.mont_mul(spec, a, b)


def add(spec: FieldSpec, a, b):
    """a + b mod p, canonical (broadcasts)."""
    return cuda_field.add(spec, a, b)


def sub(spec: FieldSpec, a, b):
    """a - b mod p, inputs canonical (broadcasts)."""
    return cuda_field.sub(spec, a, b)


def neg(spec: FieldSpec, a):
    return cuda_field.neg(spec, a)


def linscan(spec: FieldSpec, v, a: int = 1, reverse: bool = False,
            exclusive: bool = False, totals: bool = False):
    """x_j = v_j + a x_(j-1) mod p along axis -2 ((n, 8) or (C, n, 8)):
    ops/cuda_field.py::linscan."""
    return cuda_field.linscan(spec, v, a, reverse, exclusive, totals)


def prodscan(spec: FieldSpec, r, reverse: bool = False,
             exclusive: bool = False, totals: bool = False):
    """x_j = r_j x_(j-1) mod p (x_(-1) = 1) along axis -2 ((n, 8) or (C, n,
    8)): ops/cuda_field.py::prodscan."""
    return cuda_field.prodscan(spec, r, reverse, exclusive, totals)


def is_zero(a):
    return (a == 0).all(-1)


def eq(a, b):
    return (a == b).all(-1)


def one_like(spec: FieldSpec, a):
    return spec.const("one_mont", a.device).expand(a.shape)


def mont_pow(spec: FieldSpec, a, e: int):
    """a^e for a python-int exponent (square-and-multiply; one kernel
    launch on CUDA)."""
    return cuda_field.mont_pow(spec, a, e)


def inv(spec: FieldSpec, a):
    """Fermat inversion a^(p-2); a must be nonzero."""
    return mont_pow(spec, a, spec.p - 2)


def _prefix_sum_mod(spec: FieldSpec, a):
    """Inclusive prefix sum mod p along axis 0 of an (n, 8) vector (one
    field_linscan call on CUDA)."""
    return cuda_field.linscan(spec, a)


def suffix_sum_mod(spec: FieldSpec, a):
    """S[i] = sum_{j >= i} a[j] mod p over axis 0 (the reverse scan)."""
    return cuda_field.linscan(spec, a, reverse=True)


def _prefix_prod(spec: FieldSpec, a):
    """Inclusive prefix product along axis 0 of an (n, ..., 8) tensor: one
    prodscan over the columns behind axis 0 (one launch on CUDA)."""
    cols = a.reshape(a.shape[0], -1, NLIMB).transpose(0, 1)
    return prodscan(spec, cols).transpose(0, 1).reshape(a.shape)


def batch_inv_scan(spec: FieldSpec, a):
    """Batched inversion over the leading axis: each entry times the
    product of all the others (an exclusive prefix and an exclusive suffix
    product) times the inverse of the total (one Fermat inversion).  a:
    (n, 8), nonzero entries.  Two prodscan calls, the total, one mont_pow
    and two products (on CUDA one launch each)."""
    prefix = prodscan(spec, a, exclusive=True)
    suffix = prodscan(spec, a, reverse=True, exclusive=True)
    total_inv = inv(spec, mont_mul(spec, prefix[-1:], a[-1:]))
    return mont_mul(spec, mont_mul(spec, prefix, suffix), total_inv)
