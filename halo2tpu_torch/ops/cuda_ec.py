"""G1 point folds: the CUDA kernels (csrc/ec_fold.cu) and their plain torch
versions.  Counterpart of halo2tpu/ops/pallas_ec.py:
fold_mixed (windowed row steps, table gather fused), fold_mixed_tiled (one
bit-serial row step), fold_add (tile-aligned) and fold_add_any (one add
kernel), fold_dbl_any.

Layout: a point batch is (L, 3, 8) int32, lane-major — each thread of a
kernel loads its own 96 contiguous bytes.  The windowed table is
(W, npad, 3, 8): entry table[digit, base] is one affine point (Z =
Montgomery 1, or 0 for the identity entries: digit 0 and padded bases).

Each wrapper launches its kernel for CUDA tensors and takes the plain
version only for CPU tensors.  The plain versions are the curves/jpoint.py
formulas (plain field multiply), on any device.  Beside its count of
launches, each wrapper keeps `shapes`, a histogram of the shapes it
launched: (lanes, C, rows) for fold_mixed, (lanes, times) for fold_dbl_any,
(lanes,) for the others.
"""
from __future__ import annotations

from collections import Counter

import torch

from ..curves import jpoint
from ..fields.jfield import FQ, u64

NLIMB = 8


def _check_points(name, *ts):
    for t in ts:
        if t.dtype != torch.int32 or t.dim() != 3 or t.shape[1:] != (3, NLIMB):
            raise ValueError(f"{name}: expected (L, 3, 8) int32 points, got "
                             f"{tuple(t.shape)} {t.dtype}")


def _launch_args(t):
    from .._build import lib
    return lib(), torch.cuda.current_stream(t.device).cuda_stream


def _on_cpu(*ts) -> bool:
    if all(t.device.type == "cpu" for t in ts):
        return True
    dev = ts[0].device
    if any(t.device != dev for t in ts) or dev.type != "cuda":
        raise ValueError(f"operands on {[str(t.device) for t in ts]}")
    return False


# -- fold_mixed: MSM row steps with the table gather fused in --------------

def window_digits(scalars, planes: int):
    """(B, C, 8) plain scalar limbs -> (planes, B, C) int64 8-bit digits
    (digit w = byte w of the little-endian scalar)."""
    s = u64(scalars)
    w = torch.arange(planes, device=scalars.device)
    words = s[..., w // 4]                             # (B, C, planes)
    digits = (words >> (8 * (w % 4))) & 0xFF
    return digits.permute(2, 0, 1)


def fold_mixed_plain(acc, table, scalars, C: int, planes: int, r0: int,
                     r1: int):
    """Plain version of fold_mixed: the same rows, one gather and one
    jpoint.padd_mixed per row."""
    npad = table.shape[1]
    L = acc.shape[0]
    lane = torch.arange(L, device=acc.device)
    c = lane % C
    for r in range(r0, r1):
        digs = window_digits(scalars[:, r * C:(r + 1) * C], planes)
        pts = table.reshape(-1, 3, NLIMB)[digs.reshape(-1) * npad + r * C + c]
        acc = jpoint.padd_mixed(acc, pts)
    return acc


def fold_mixed(acc, table, scalars, C: int, planes: int, r0: int, r1: int):
    """MSM row steps r in [r0, r1): lane l = g * C + c, g = plane * B + b,
    adds table[digit, r * C + c] where digit = byte `plane` of scalars[b,
    r * C + c].  acc (L, 3, 8) Jacobian, L = planes * B * C; table
    (W, npad, 3, 8) affine; scalars (B, npad, 8) plain limbs.  Lanes whose
    entry is the identity keep acc; acc == entry doubles; acc == -entry
    gives the identity (pallas_ec.py::_mixed_kernel lane rules)."""
    B, npad = scalars.shape[0], scalars.shape[1]
    _check_points("fold_mixed", acc)
    if table.dim() != 4 or table.shape[1:] != (npad, 3, NLIMB):
        raise ValueError(f"fold_mixed: table {tuple(table.shape)} does not "
                         f"match scalars {tuple(scalars.shape)}")
    if acc.shape[0] != planes * B * C or not (0 <= r0 <= r1 <= npad // C):
        raise ValueError("fold_mixed: lanes/rows do not match the shapes")
    if planes > 32 or scalars.shape[2] != NLIMB:
        raise ValueError("fold_mixed: at most 32 digit planes of 8 limbs")
    if _on_cpu(acc, table, scalars):
        return fold_mixed_plain(acc, table, scalars, C, planes, r0, r1)
    from .._build import check
    acc = acc.contiguous()
    table = table.contiguous()
    scalars = scalars.contiguous()
    if table.data_ptr() % 16:
        raise ValueError("fold_mixed: the table must be 16-byte aligned "
                         "(the kernel copies its entries in 16-byte pieces)")
    out = torch.empty_like(acc)
    lib, stream = _launch_args(acc)
    check(lib.h2_fold_mixed(acc.data_ptr(), out.data_ptr(), table.data_ptr(),
                            scalars.data_ptr(), acc.shape[0], C, B, npad, r0,
                            r1, FQ.mod_words_ptr, stream), "fold_mixed")
    fold_mixed.launches += 1
    fold_mixed.shapes[(acc.shape[0], C, r1 - r0)] += 1
    return out


fold_mixed.launches = 0
fold_mixed.shapes = Counter()


# -- fold_mixed_tiled: one bit-serial MSM row step --------------------------

def fold_mixed_tiled_plain(acc, pts_c, bits):
    """Plain version of fold_mixed_tiled: jpoint.padd_mixed over the bases
    broadcast to every lane, masked lanes given a Z = 0 point."""
    L, C = acc.shape[0], pts_c.shape[0]
    pts = pts_c.repeat(L // C, 1, 1)
    pts[:, 2] = torch.where((bits != 0)[:, None], pts[:, 2], 0)
    return jpoint.padd_mixed(acc, pts)


def fold_mixed_tiled(acc, pts_c, bits):
    """acc[l] += pts_c[l mod C] where bits[l] != 0: acc (L, 3, 8) Jacobian,
    pts_c (C, 3, 8) affine bases shared by every group of C lanes (C | L),
    bits (L,) uint8.  Lane rules of pallas_ec.py::_mixed_tiled_kernel:
    a zero bit or an identity base keeps acc, an identity acc takes the
    base, acc == -base gives the identity, acc == base doubles."""
    _check_points("fold_mixed_tiled", acc, pts_c)
    L, C = acc.shape[0], pts_c.shape[0]
    if C == 0 or L % C:
        raise ValueError(f"fold_mixed_tiled: C = {C} does not divide L = {L}")
    if bits.dtype != torch.uint8 or bits.shape != (L,):
        raise ValueError(f"fold_mixed_tiled: expected ({L},) uint8 bits, got "
                         f"{tuple(bits.shape)} {bits.dtype}")
    if _on_cpu(acc, pts_c, bits):
        return fold_mixed_tiled_plain(acc, pts_c, bits)
    from .._build import check
    acc = acc.contiguous()
    pts_c = pts_c.contiguous()
    bits = bits.contiguous()
    out = torch.empty_like(acc)
    lib, stream = _launch_args(acc)
    check(lib.h2_fold_mixed_tiled(acc.data_ptr(), out.data_ptr(),
                                  pts_c.data_ptr(), bits.data_ptr(), L, C,
                                  FQ.mod_words_ptr, stream),
          "fold_mixed_tiled")
    fold_mixed_tiled.launches += 1
    fold_mixed_tiled.shapes[(L,)] += 1
    return out


fold_mixed_tiled.launches = 0
fold_mixed_tiled.shapes = Counter()


# -- fold_add (tile-aligned entry) / fold_add_any / fold_dbl_any -----------

ADD_TILE = 512   # pallas_ec.py::TILE: fold_add takes whole tiles of lanes


def _launch_add(p, q, name):
    from .._build import check
    p = p.contiguous()
    q = q.contiguous()
    out = torch.empty_like(p)
    lib, stream = _launch_args(p)
    check(lib.h2_fold_add(p.data_ptr(), q.data_ptr(), out.data_ptr(),
                          p.shape[0], FQ.mod_words_ptr, stream), name)
    return out


def fold_add_plain(p, q):
    return jpoint.padd(p, q)


def fold_add(p, q):
    """Lanewise full Jacobian add over (L, 3, 8) with L % 512 == 0, the
    contract of pallas_ec.py::fold_add; the same add kernel as
    fold_add_any, with its own launch count."""
    _check_points("fold_add", p, q)
    if p.shape != q.shape:
        raise ValueError("fold_add: shape mismatch")
    if p.shape[0] % ADD_TILE:
        raise ValueError(f"fold_add: L = {p.shape[0]} is not a multiple of "
                         f"{ADD_TILE}")
    if _on_cpu(p, q):
        return fold_add_plain(p, q)
    out = _launch_add(p, q, "fold_add")
    fold_add.launches += 1
    fold_add.shapes[(p.shape[0],)] += 1
    return out


fold_add.launches = 0
fold_add.shapes = Counter()

fold_add_any_plain = fold_add_plain


def fold_add_any(p, q):
    """Lanewise full Jacobian add over (L, 3, 8), any L.  Whole 512-lane
    tiles go through fold_add and count there, as pallas_ec.py::fold_add_any
    launches the tile-aligned add itself."""
    _check_points("fold_add_any", p, q)
    if p.shape != q.shape:
        raise ValueError("fold_add_any: shape mismatch")
    if _on_cpu(p, q):
        return fold_add_any_plain(p, q)
    if p.shape[0] % ADD_TILE == 0:
        return fold_add(p, q)
    out = _launch_add(p, q, "fold_add_any")
    fold_add_any.launches += 1
    fold_add_any.shapes[(p.shape[0],)] += 1
    return out


fold_add_any.launches = 0
fold_add_any.shapes = Counter()


def fold_dbl_any_plain(p, times: int = 1):
    for _ in range(times):
        p = jpoint.pdbl(p)
    return p


def fold_dbl_any(p, times: int = 1):
    """Lanewise Jacobian doubling over (L, 3, 8), any L, identity-safe,
    `times` times over (2^times * p) in one launch; bitwise equal to
    `times` chained doublings.  times=1 is pallas_ec.py::fold_dbl_any."""
    _check_points("fold_dbl_any", p)
    if times < 1:
        raise ValueError(f"fold_dbl_any: times = {times} < 1")
    if _on_cpu(p):
        return fold_dbl_any_plain(p, times)
    from .._build import check
    p = p.contiguous()
    out = torch.empty_like(p)
    lib, stream = _launch_args(p)
    check(lib.h2_fold_dbl(p.data_ptr(), out.data_ptr(), p.shape[0], times,
                          FQ.mod_words_ptr, stream), "fold_dbl_any")
    fold_dbl_any.launches += 1
    fold_dbl_any.shapes[(p.shape[0], times)] += 1
    return out


fold_dbl_any.launches = 0
fold_dbl_any.shapes = Counter()
