"""Multi-scalar multiplication on torch tensors.  Port of halo2tpu/ops/msm.py
(the windowed path and the single-device bit-serial path).

Windowed (MSMContext, every commitment of the prover): the SRS bases are
fixed across every commitment, so each base gets a 256-entry table of
affine multiples w * P (built once per SRS, on the device), and a
commitment walks 32 8-bit digit planes: lane (plane, batch, c) adds
table[digit, r * C + c] for every row r (one fold_mixed launch covers all
rows), a C -> 1 tree-fold (fold_add_tree: one launch) sums each
group, and a Horner pass over the planes (fold_horner, 8 doublings and an
add a plane, one launch) combines them.  C is chosen per call (fold_width)
so that every launch over more than one row has at least LANE_TARGET
lanes.

Bit-serial (msm(), no table): lane (bit * B + b) * C + c adds base r * C + c
of row r where bit `bit` of scalars[b, r * C + c] is set, every row of C
bases in one fold_mixed_tiled_rows launch; a C -> 1 tree-fold sums each
(bit, batch) group and a Horner pass over the 254 bits (one fold_horner
launch) combines them.
"""
from __future__ import annotations

import contextlib
import hashlib
import os

import numpy as np
import torch

from ..fields.bn254 import R
from ..curves.jpoint import affine_to_device, device_to_affine, identity_points
from ..fields.jfield import (FQ, batch_inv_scan, device_of, ints_to_limbs,
                             is_zero, mont_mul)
from .cuda_ec import (bit_masks, fold_add_any, fold_add_tree, fold_dbl_any,
                      fold_horner, fold_mixed, fold_mixed_tiled_rows)

SCALAR_BITS = 254
WINDOW_BITS = 8
TABLE_W = 1 << WINDOW_BITS          # multiples per base, incl. identity
NUM_WINDOWS = 256 // WINDOW_BITS    # digit planes
_FOLD_WIDTH = 256                   # C: least point lanes per row of bases
# Lanes a windowed fold_mixed launch should reach: csrc/ec_fold.cu runs 128
# threads a block with 4 blocks an SM, so 65,536 lanes are 512 blocks, one
# wave on an H100's 132 SMs (528 slots).  Fewer lanes leave SMs idle while
# each thread walks more rows in series.
LANE_TARGET = 1 << 16


def _normalize(jac):
    """(m, 3, 8) Jacobian -> affine (Z = Montgomery 1; identity lanes keep
    Z = 0) via one Fq batch inversion."""
    x, y, z = jac[:, 0], jac[:, 1], jac[:, 2]
    inf = is_zero(z).unsqueeze(-1)
    one = FQ.const("one_mont", jac.device).expand(z.shape)
    zi = batch_inv_scan(FQ, torch.where(inf, one, z))
    zi2 = mont_mul(FQ, zi, zi)
    zi3 = mont_mul(FQ, zi2, zi)
    xa = mont_mul(FQ, x, zi2)
    ya = mont_mul(FQ, y, zi3)
    za = torch.where(inf, torch.zeros_like(z), one)
    return torch.stack([xa, ya, za], dim=1)


def precompute_window_table(points):
    """points (n, 3, 8) affine bases -> (TABLE_W, n, 3, 8) table with
    table[w, i] = affine w * P_i (w = 0 and padded bases: Z = 0).

    log2(W) rounds: with multiples 1..m known, evens 2..2m come from ONE
    batched doubling and odds 3..2m+1 from ONE batched add of P."""
    n = points.shape[0]
    mults = {1: points}
    have = 1
    while have < TABLE_W - 1:
        evens = fold_dbl_any(torch.cat([mults[k] for k in range(1, have + 1)]))
        for i in range(have):
            mults[2 * (i + 1)] = evens[i * n:(i + 1) * n]
        odd_top = min(2 * have + 1, TABLE_W - 1)
        odd_ws = [w for w in range(3, odd_top + 1, 2) if w not in mults]
        if odd_ws:
            odds = fold_add_any(torch.cat([mults[w - 1] for w in odd_ws]),
                                points.repeat(len(odd_ws), 1, 1))
            for i, w in enumerate(odd_ws):
                mults[w] = odds[i * n:(i + 1) * n]
        have = odd_top
    slots = [identity_points((n,), points.device)]
    ws = list(range(1, TABLE_W))
    chunk = max(1, (1 << 22) // n)   # lanes per batch inversion
    for i in range(0, len(ws), chunk):
        grp = ws[i:i + chunk]
        aff = _normalize(torch.cat([mults[w] for w in grp]))
        slots.extend(aff[j * n:(j + 1) * n] for j in range(len(grp)))
    return torch.stack(slots)


def fold_width(planes: int, batch: int, npad: int,
               lane_target: int = LANE_TARGET,
               min_width: int = _FOLD_WIDTH) -> int:
    """C for a windowed fold of `batch` scalar vectors over `planes` digit
    planes and npad bases (a power of two): the smallest power of two >=
    min_width with planes * batch * C >= lane_target, capped at npad."""
    C = min_width
    while C < npad and planes * batch * C < lane_target:
        C *= 2
    return min(C, npad)


def _partials_fused(table, scalar_limbs, C: int, P: int = NUM_WINDOWS):
    """Windowed fold of B scalar vectors: table (W, n, 3, 8); scalar_limbs
    (B, n, 8) plain limbs, known < 2^(8P).  Returns (B, P, 3, 8) Jacobian
    per-digit-plane sums."""
    n = table.shape[1]
    bsz = scalar_limbs.shape[0]
    rows = n // C
    G = P * bsz
    acc = identity_points((G * C,), table.device)
    acc = fold_mixed(acc, table, scalar_limbs, C, P, 0, rows)
    acc = fold_add_tree(acc, G, C)
    return acc.reshape(P, bsz, 3, 8).transpose(0, 1)


def _horner_device_w(partials):
    """(B, NUM_WINDOWS, 3, 8) -> (B, 3, 8): acc = 256 * acc + partial[d],
    top digit plane down, in one fold_horner launch."""
    return fold_horner(partials, WINDOW_BITS)


def _wpartials_to_affine(partials) -> list:
    """(B, NUM_WINDOWS, 3, 8) digit-plane sums -> B host affine points."""
    return device_to_affine(_horner_device_w(partials))


# -- bit-serial path (ops/msm.py::msm without `shardings`) ------------------

def _bit_masks(scalar_rows):
    """(B, C, 8) plain scalar limbs -> (SCALAR_BITS * B * C,) uint8 lane
    masks: lane (bit * B + b) * C + c holds bit `bit` of scalar [b, c]."""
    return bit_masks(scalar_rows, SCALAR_BITS)


def _bit_partials(points, scalar_limbs, fold_width=None):
    """points (n, 3, 8) affine bases; scalar_limbs (B, n, 8) plain limbs.
    Returns (B, SCALAR_BITS, 3, 8) Jacobian per-bit masked sums."""
    n = points.shape[0]
    bsz = scalar_limbs.shape[0]
    C = min(n, fold_width or _FOLD_WIDTH)
    G = SCALAR_BITS * bsz
    acc = identity_points((G * C,), points.device)
    acc = fold_mixed_tiled_rows(acc, points, scalar_limbs, C, 0, n // C)
    acc = fold_add_tree(acc, G, C)
    return acc.reshape(SCALAR_BITS, bsz, 3, 8).transpose(0, 1)


def _horner_device(partials):
    """(B, SCALAR_BITS, 3, 8) -> (B, 3, 8): acc = 2 * acc + partial[bit],
    top bit down, in one fold_horner launch."""
    return fold_horner(partials, 1)


def _partials_to_affine(partials) -> list:
    """(B, SCALAR_BITS, 3, 8) per-bit sums -> B host affine points."""
    return device_to_affine(_horner_device(partials))


def msm(points_device, scalars_batch: list[list[int]]) -> list:
    """MSM of the same bases against a batch of scalar vectors, on the
    device of `points_device` ((n, 3, 8) from jpoint.affine_to_device, n a
    power of two, padded with identity).  scalars_batch: B lists of python
    ints.  Returns B host affine points (None for the identity)."""
    n = points_device.shape[0]
    arrs = [ints_to_limbs([v % R for v in s] + [0] * (n - len(s)))
            for s in scalars_batch]
    limbs = torch.from_numpy(np.stack(arrs)).to(points_device.device)
    return _partials_to_affine(_bit_partials(points_device, limbs))


def points_tag(points) -> str:
    """Content tag of a base list for on-disk artifacts: a hash of every
    point, not only the first and last."""
    h = hashlib.sha256(str(len(points)).encode())
    for p in points:
        h.update(b"-" if p is None else
                 p[0].to_bytes(32, "little") + p[1].to_bytes(32, "little"))
    return h.hexdigest()[:16]


def _load_table(path: str, shape: tuple):
    """The table stored at path, or None when there is none or it is not
    a readable int32 array of `shape` (the caller rebuilds it)."""
    try:
        host = np.load(path, mmap_mode="r")
        if host.shape != shape or host.dtype != np.int32:
            return None
        return np.array(host)
    except (OSError, ValueError, EOFError):
        return None


def _save_table(path: str, table: np.ndarray) -> None:
    """Write the table atomically; a cache that cannot be written is
    skipped (the cache is best-effort)."""
    tmp = f"{path}.{os.getpid()}.tmp.npy"
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        np.save(tmp, table)
        os.replace(tmp, path)
    except OSError:
        with contextlib.suppress(OSError):
            os.remove(tmp)


class MSMContext:
    """Device-resident bases (padded to a power of two) and their windowed
    multiple table (lazily built, (TABLE_W, npad, 3, 8) int32).

    cache_tag: when set, the built table persists to
    $HALO2TPU_CACHE (default <repo>/.cache)/msm_table_torch_<tag>.npy,
    written atomically; best-effort: a file that cannot be read or is of
    the wrong shape or dtype is rebuilt, a directory that cannot be
    written is skipped."""

    def __init__(self, points: list, cache_tag: str | None = None,
                 device="cuda"):
        n = len(points)
        npad = 1 << (n - 1).bit_length() if n > 1 else 1
        self.n = n
        self.device = device_of(device)
        self.points = affine_to_device(list(points) + [None] * (npad - n),
                                       self.device)
        self._table = None
        self._cache_tag = cache_tag

    def _table_path(self):
        if self._cache_tag is None:
            return None
        d = os.environ.get("HALO2TPU_CACHE", os.path.join(
            os.path.dirname(__file__), "..", "..", ".cache"))
        return os.path.join(d, f"msm_table_torch_{self._cache_tag}.npy")

    @property
    def table(self):
        if self._table is None:
            npad = self.points.shape[0]
            shape = (TABLE_W, npad, 3, 8)
            path = self._table_path()
            host = _load_table(path, shape) if path else None
            if host is not None:
                self._table = torch.from_numpy(host).to(self.device)
                return self._table
            self._table = precompute_window_table(self.points)
            if path:
                _save_table(path, self._table.cpu().numpy())
        return self._table

    def partials(self, plain_limbs, planes: int = NUM_WINDOWS,
                 lane_target: int = LANE_TARGET,
                 min_width: int = _FOLD_WIDTH):
        """(B, npad, 8) plain scalar limbs -> (B, planes, 3, 8) partial
        sums.  planes < NUM_WINDOWS: scalars known < 2^(8 * planes).  The
        fold's width C is fold_width(planes, B, npad, lane_target,
        min_width): the Jacobian partials depend on it, their sum does
        not."""
        npad = self.points.shape[0]
        C = fold_width(planes, plain_limbs.shape[0], npad, lane_target,
                       min_width)
        return _partials_fused(self.table, plain_limbs, C, planes)

    def finalize(self, partials_batches: list) -> list:
        """Per-batch (B, NUM_WINDOWS, 3, 8) partials -> host affine."""
        return _wpartials_to_affine(torch.cat(partials_batches))

    def commit_limbs(self, plain_limbs) -> list:
        return self.finalize([self.partials(plain_limbs)])

    def commit_batch(self, scalar_vectors: list[list[int]]) -> list:
        npad = self.points.shape[0]
        arrs = [ints_to_limbs([v % R for v in s] + [0] * (npad - len(s)))
                for s in scalar_vectors]
        return self.commit_limbs(
            torch.from_numpy(np.stack(arrs)).to(self.device))

    def commit(self, scalars: list[int]):
        return self.commit_batch([scalars])[0]
