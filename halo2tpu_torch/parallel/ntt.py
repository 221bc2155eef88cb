"""Multi-device NTT: the Bailey four-step decomposition over a device mesh.
Port of halo2tpu/parallel/ntt.py.

n = n1 * n2, data as an (n1, n2) matrix of field elements, columns split
over the mesh axis.  Column NTTs and row NTTs are device-local (the `ntt`
kernel over stacks of columns, ops/ntt.py); the one exchange between them
is an all-to-all over the mesh (parallel/mesh.py).

Layout convention: input x[j1, j2] holds coefficient a[j1 * n2 + j2];
output out[k1, k2] holds NTT value X[k2 * n1 + k1] (row-sharded).
"""
from __future__ import annotations

from functools import lru_cache

import torch

from ..fields.bn254 import R
from ..fields.jfield import FR, NLIMB, ints_to_limbs, mont_mul
from ..ops.ntt import get_plan, ntt_kernel, ntt_plain
from .mesh import Mesh, Placement, Sharded, on_device


@lru_cache(maxsize=16)
def _twiddles(n1: int, n2: int, omega: int) -> torch.Tensor:
    rows = []
    for k1 in range(n1):
        w = pow(omega, k1, R)
        cur = 1
        row = [1] * n2
        for j2 in range(1, n2):
            cur = cur * w % R
            row[j2] = cur
        rows.extend(row)
    limbs = ints_to_limbs([v * FR.r % R for v in rows])
    return torch.from_numpy(limbs).reshape(n1, n2, NLIMB)


def twiddle_matrix(n1: int, n2: int, omega: int) -> torch.Tensor:
    """(n1, n2, 8) Montgomery twiddles w^(k1*j2) for the middle step, an
    int32 tensor on the CPU (cached: do not write to it)."""
    return _twiddles(n1, n2, omega % R)


def line_plan(size: int, omega: int, device):
    """The plan of a size-`size` transform (None for size 1: identity)."""
    return None if size == 1 else get_plan(size, omega, device)


def local_ntt(plan, x, scale=None):
    """Forward NTT over axis 0 of an (L, ..., 8) stack, the output times
    the (8,) Montgomery constant `scale` if given: the `ntt` kernel (the
    scale fused into its last pass) for CUDA tensors, the plain loop for
    CPU ones."""
    if plan is None:
        return x if scale is None else mont_mul(FR, x, scale)
    if x.device.type == "cpu":
        out = ntt_plain(plan, x)
        return out if scale is None else mont_mul(FR, out, scale)
    return ntt_kernel(plan, x, scale=scale)


def sharded_ntt_blocks(mesh: Mesh, plans: tuple, tw: list, x: list,
                       scale: list | None = None) -> list:
    """The four-step over a 1-D mesh on blocks: x[d] (n1, n2/D, ..., 8) holds
    columns j2 of block d, tw[d] (n1, n2/D, 8) their twiddles, plans the
    per-device (column, row) line plans; scale[d], if given, an (8,)
    constant fused into the row NTTs.  Returns per device the row NTTs'
    (n2, n1/D, ..., 8) output for rows k1 of block d: [k2, k1] = X[k2 * n1
    + k1]."""
    devs = mesh.flat
    a2 = []
    for d, blk in enumerate(x):
        with on_device(devs[d]):
            n1, w = blk.shape[0], blk.shape[1]
            cols = blk.shape[2:-1]
            a1 = local_ntt(plans[0][d], blk.reshape(n1, -1, NLIMB))
            a2.append(mont_mul(FR, a1.reshape(blk.shape), tw[d].reshape(
                (n1, w) + (1,) * len(cols) + (NLIMB,))))  # * w^(k1*j2)
    out = []
    for d, blk in enumerate(mesh.all_to_all(a2, 0, 1)):    # (n1/D, n2)
        with on_device(devs[d]):
            t = blk.transpose(0, 1)                       # (n2, n1/D, ...)
            out.append(local_ntt(plans[1][d], t.reshape(t.shape[0], -1, NLIMB),
                                 None if scale is None else scale[d]
                                 ).reshape(t.shape))
    return out


def ntt_plans(mesh: Mesh, n1: int, n2: int, omega: int) -> tuple:
    """Per device of the mesh, the column (n1) and row (n2) line plans."""
    return ([line_plan(n1, pow(omega, n2, R), d) for d in mesh.flat],
            [line_plan(n2, pow(omega, n1, R), d) for d in mesh.flat])


def make_sharded_ntt(mesh: Mesh, n1: int, n2: int, omega: int,
                     axis: str = "shard"):
    """A sharded NTT of size n = n1 * n2 over a 1-D mesh: run(x) takes the
    (n1, n2, 8) matrix (a tensor, placed with its columns split, or a
    Sharded so placed) and returns the Sharded (n1, n2, 8) output, rows
    split: out[k1, k2] = X[k2 * n1 + k1]."""
    plans = ntt_plans(mesh, n1, n2, omega)
    col = Placement(mesh, (None, axis, None))
    row = Placement(mesh, (axis, None, None))
    tw = col.put(twiddle_matrix(n1, n2, omega)).blocks

    def run(x_matrix) -> Sharded:
        x = x_matrix if isinstance(x_matrix, Sharded) else col.put(x_matrix)
        out = sharded_ntt_blocks(mesh, plans, tw, x.blocks)
        return Sharded(row, [b.transpose(0, 1).contiguous() for b in out],
                       (n1, n2, NLIMB))

    run.plan1, run.plan2, run.n1, run.n2 = plans[0][0], plans[1][0], n1, n2
    return run
