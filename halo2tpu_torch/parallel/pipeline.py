"""Sharded proving-core step: the multi-device composition of the prover's
hot phases.  Port of halo2tpu/parallel/pipeline.py.

One step over a 1-D mesh: the column-sharded coefficient -> evaluation NTT
(Bailey four-step, one all-to-all, parallel/ntt.py), a gate-style
elementwise fold on the evaluations (the square gate), and the
lane-sharded bit-serial MSM partials (parallel/msm.py).  Each device runs
the port's kernels on its own blocks (ntt, mont_mul,
fold_mixed_tiled_rows, fold_add_tree).
"""
from __future__ import annotations

from ..fields.jfield import FR, NLIMB, mont_mul
from .mesh import Mesh, Placement, Sharded, on_device
from .msm import sharded_bit_partials
from .ntt import ntt_plans, sharded_ntt_blocks, twiddle_matrix


def make_sharded_prove_core(mesh: Mesh, n1: int, n2: int, omega: int,
                            axis: str = "shard"):
    """Returns (fn, shardings, tw).  fn(tw, x_matrix, points, scalars) ->
    (gate_evals_matrix, msm_partials): the sharded NTT and the gate fold,
    a Sharded (n1, n2, 8) with its rows split (gate[k1, k2] = X[k2 * n1 +
    k1]^2), then the lane-sharded MSM's (B, 254, 3, 8) partials on the
    mesh's first device.  shardings: how fn's inputs lie on the mesh (put
    each argument with its Placement); tw: the (n1, n2, 8) twiddles."""
    plans = ntt_plans(mesh, n1, n2, omega)
    shardings = (
        Placement(mesh, (None, axis, None)),     # tw
        Placement(mesh, (None, axis, None)),     # x_matrix: columns split
        Placement(mesh, (axis, None, None)),     # points: rows split
        Placement(mesh, (None, axis, None)),     # scalars: rows split
    )
    rows = Placement(mesh, (axis, None, None))

    def fn(tw_arr, x_matrix, points, scalars):
        tw_s, x = (a if isinstance(a, Sharded) else s.put(a)
                   for a, s in zip((tw_arr, x_matrix), shardings))
        evals = sharded_ntt_blocks(mesh, plans, tw_s.blocks, x.blocks)
        gate = []
        for d, dev in enumerate(mesh.flat):
            with on_device(dev):
                ev = evals[d].transpose(0, 1).contiguous()   # (n1/D, n2)
                gate.append(mont_mul(FR, ev, ev))
        parts = sharded_bit_partials(mesh, points, scalars,
                                     fold_width=points.shape[0], axis=axis)
        return Sharded(rows, gate, (n1, n2, NLIMB)), parts

    return fn, shardings, twiddle_matrix(n1, n2, omega)
