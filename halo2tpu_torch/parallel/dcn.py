"""Multi-host layouts: 2-D ("dcn", "ici") meshes.  Port of
halo2tpu/parallel/dcn.py.

The design rule of halo2tpu's: collectives ride the fast intra-node axis,
the slow cross-node axis only carries embarrassingly parallel work.

  * The row dimension of a polynomial (NTT butterflies, MSM fold lanes)
    needs all-to-all bandwidth -> split over "ici" (the GPUs of one node,
    NVLink).
  * The BATCH dimension (independent polynomials, proofs, MSMs) needs no
    communication -> split over "dcn" (the nodes).

So a 2-node x 4-GPU mesh transforms 2 polynomial batches at once, each
four-step NTT exchanging only within its node.  The per-batch results are
gathered at the end (proof assembly is a byte stream; nothing is reduced
across nodes).

Like halo2tpu's, this module describes the layout and is tested on one
process: here a mesh of devices of one machine (the CPU repeated in the
tests), the "dcn" rows standing for nodes.  Running it across nodes (one
process a node, NCCL between them) is not done in either package.
"""
from __future__ import annotations

import torch

from ..fields.jfield import FR, NLIMB, device_of, mont_mul
from .mesh import Mesh, Placement, Sharded, on_device
from .msm import sharded_bit_partials
from .ntt import local_ntt, ntt_plans, twiddle_matrix


def make_mesh2d(n_dcn: int, n_ici: int, device="cuda") -> Mesh:
    """(n_dcn, n_ici) mesh over the first n_dcn * n_ici devices of type
    `device`; consecutive devices land on the "ici" axis.  Raises when
    fewer exist."""
    kind = torch.device(device).type
    if kind == "cuda":
        device_of("cuda")
        have = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        have = [torch.device(kind)]
    need = n_dcn * n_ici
    if len(have) < need:
        raise RuntimeError(f"make_mesh2d: need {need} {kind} devices, have "
                           f"{len(have)}")
    return Mesh([have[i * n_ici:(i + 1) * n_ici] for i in range(n_dcn)],
                ("dcn", "ici"))


def make_batched_ntt(mesh: Mesh, n1: int, n2: int, omega: int):
    """Batched four-step NTT on a 2-D mesh: input (B, n1, n2, 8) (a tensor
    or a Sharded so placed) with the batch split over "dcn" and the columns
    over "ici"; the all-to-all stays inside each "dcn" row.  Returns the
    Sharded (B, n1, n2, 8) output, batch over "dcn" and rows over "ici":
    out[b, k1, k2] = X_b[k2 * n1 + k1]."""
    n_dcn, n_ici = mesh.shape["dcn"], mesh.shape["ici"]
    in_pl = Placement(mesh, ("dcn", None, "ici", None))
    out_pl = Placement(mesh, ("dcn", "ici", None, None))
    tw = Placement(mesh, (None, "ici", None)).put(
        twiddle_matrix(n1, n2, omega)).blocks
    plans = ntt_plans(mesh, n1, n2, omega)
    devs = mesh.flat

    def run(x) -> Sharded:
        xs = x if isinstance(x, Sharded) else in_pl.put(x)
        out = [None] * len(devs)
        for i in range(n_dcn):
            row = mesh.sub("ici", i)
            idx = range(i * n_ici, (i + 1) * n_ici)
            a2 = []
            for f in idx:
                with on_device(devs[f]):
                    b = xs.blocks[f].transpose(0, 1)    # (n1, B/dcn, n2/ici)
                    a1 = local_ntt(plans[0][f], b.reshape(n1, -1, NLIMB))
                    a2.append(mont_mul(FR, a1.reshape(b.shape),
                                       tw[f][:, None]).transpose(0, 1))
            a3 = row.all_to_all(a2, 1, 2)            # (B/dcn, n1/ici, n2)
            for j, f in enumerate(idx):
                with on_device(devs[f]):
                    t = a3[j].permute(2, 0, 1, 3)    # (n2, B/dcn, n1/ici)
                    a5 = local_ntt(plans[1][f], t.reshape(n2, -1, NLIMB))
                    out[f] = a5.reshape(t.shape).permute(1, 2, 0,
                                                         3).contiguous()
        return Sharded(out_pl, out, xs.shape)

    return run


def batched_msm_partials(mesh: Mesh, points_device, scalar_limbs,
                         fold_width: int | None = None):
    """MSM with the scalar-batch (B) axis split over "dcn" and the fold
    lanes over "ici": each "dcn" row reduces its own batch; the only
    traffic across rows is the final (B, 254, 3, 8) partials gather onto
    the mesh's first device."""
    n_dcn, n_ici = mesh.shape["dcn"], mesh.shape["ici"]
    n = points_device.shape[0]
    C = min(n, fold_width or max(n_ici, 128))
    assert C % n_ici == 0
    B = scalar_limbs.shape[0]
    assert B % n_dcn == 0, "the batch must split across the dcn axis"
    bl = B // n_dcn
    parts = [sharded_bit_partials(mesh.sub("ici", i), points_device,
                                  scalar_limbs[i * bl:(i + 1) * bl],
                                  fold_width=C, axis="ici")
             for i in range(n_dcn)]
    return torch.cat([p.to(mesh.first) for p in parts])

