"""Multi-device MSM: the fold-lane (C) axis of the bit-serial MSM split over
the mesh.  Port of halo2tpu/parallel/msm.py.

halo2tpu shards the accumulator's lane axis and lets GSPMD partition its
two MSM kernels.  The port does it explicitly: each shard takes its block
of C / D fold lanes (the bases and scalars those lanes read, every row),
folds its rows with one fold_mixed_tiled_rows launch and its lanes to one
point a (bit, batch) group with one fold_add_tree launch.  The shards'
(B, 254, 3, 8) partial sums then go to the mesh's first device, where one
more fold_add_tree over the D shards and the Horner combine (fold_horner)
finish them, as ops/msm.py does on one device.  The Jacobian partials
group the additions differently from msm()'s; their affine sums are the
same points.
"""
from __future__ import annotations

import torch

from ..curves.jpoint import identity_points
from ..ops.cuda_ec import fold_add_tree, fold_mixed_tiled_rows
from ..ops.msm import SCALAR_BITS, _partials_to_affine
from .mesh import Mesh, Sharded, on_device


def lane_split(mesh: Mesh, blocks: list, C: int, dim: int) -> list:
    """Row blocks -> lane blocks.  `blocks`: one or more equal blocks that
    split an axis of n rows (axis `dim`) in order.  Row i of that axis is
    fold lane i mod C of fold row i // C; lane block d (on mesh.flat[d])
    holds lanes [d C / D, (d + 1) C / D) of every fold row, row after row:
    the bases or scalars shard d folds."""
    D = mesh.size
    Cd = C // D
    m = blocks[0].shape[dim]
    rows = m * len(blocks) // C
    out = []
    if m % C == 0:
        pieces = [b.unflatten(dim, (m // C, C)).chunk(D, dim + 1)
                  for b in blocks]
        for j, dev in enumerate(mesh.flat):
            x = torch.cat([p[j].to(dev, non_blocking=True) for p in pieces],
                          dim)
            out.append(x.flatten(dim, dim + 1))
        return out
    for j, dev in enumerate(mesh.flat):       # a block is part of a fold row
        parts = []
        for r in range(rows):
            i, end = r * C + j * Cd, r * C + (j + 1) * Cd
            while i < end:
                s, off = divmod(i, m)
                take = min(end - i, m - off)
                parts.append(blocks[s].narrow(dim, off, take).to(
                    dev, non_blocking=True))
                i += take
        out.append(torch.cat(parts, dim))
    return out


def _row_blocks(x, dim: int) -> list:
    """The blocks of x along its row axis `dim`: a Sharded split there
    gives its blocks, a tensor one block."""
    if not isinstance(x, Sharded):
        return [x]
    spec = x.placement.spec
    if x.mesh.size > 1 and (len(spec) <= dim or spec[dim] is None or any(
            a is not None for k, a in enumerate(spec) if k != dim)):
        raise ValueError(f"MSM operand placed {spec}: need its rows (axis "
                         f"{dim}) split and nothing else")
    return x.blocks if x.mesh.size > 1 else x.blocks[:1]


def fold_lanes(mesh: Mesh, pts: list, scalars: list, Cd: int):
    """Shard d folds its lane block (pts[d] (rows * Cd, 3, 8) affine,
    scalars[d] (B, rows * Cd, 8) plain limbs) over every row and then its
    Cd lanes; the mesh's first device adds the D shards' sums.  Returns
    (B, SCALAR_BITS, 3, 8) Jacobian per-bit sums on the first device."""
    first = mesh.first
    B = scalars[0].shape[0]
    G = SCALAR_BITS * B
    parts = []
    for d, dev in enumerate(mesh.flat):
        with on_device(dev):
            acc = identity_points((G * Cd,), dev)
            acc = fold_mixed_tiled_rows(acc, pts[d], scalars[d], Cd, 0,
                                        pts[d].shape[0] // Cd)
            parts.append(fold_add_tree(acc, G, Cd).to(first,
                                                      non_blocking=True))
    with on_device(first):
        D = len(parts)
        acc = torch.stack(parts, 1).reshape(G * D, 3, parts[0].shape[-1])
        acc = fold_add_tree(acc, G, D)
    return acc.reshape(SCALAR_BITS, B, 3, acc.shape[-1]).transpose(0, 1)


def sharded_bit_partials(mesh: Mesh, points_device, scalar_limbs,
                         fold_width=None, axis: str = "shard"):
    """The bit-serial MSM's (B, 254, 3, 8) partials over a 1-D mesh, on its
    first device.  points_device: (n, 3, 8) affine bases; scalar_limbs:
    (B, n, 8) plain limbs; each a tensor or a Sharded whose rows (points
    axis 0, scalars axis 1) are split over `axis`.  Fold width C = min(n,
    fold_width or max(ndev, 128)), split evenly over the devices."""
    ndev = mesh.size
    n = points_device.shape[0]
    C = min(n, fold_width or max(ndev, 128))
    assert C % ndev == 0, "fold width must split across the mesh"
    pts = lane_split(mesh, _row_blocks(points_device, 0), C, 0)
    sc = lane_split(mesh, _row_blocks(scalar_limbs, 1), C, 1)
    return fold_lanes(mesh, pts, sc, C // ndev)


def make_sharded_msm(mesh: Mesh, axis: str = "shard"):
    """Returns run(points_device, scalar_limbs, fold_width=None) -> B host
    affine points (None for the identity).

    points: (n, 3, 8); scalar_limbs: (B, n, 8) plain limbs.  The fold
    width is n // n_devices-aligned so each device owns a contiguous lane
    block."""

    def run(points_device, scalar_limbs, fold_width=None) -> list:
        partials = sharded_bit_partials(mesh, points_device, scalar_limbs,
                                        fold_width, axis)
        with on_device(mesh.first):
            return _partials_to_affine(partials)

    return run
