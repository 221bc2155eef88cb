"""msm_roofline: the kernels (csrc/ec_fold.cu): the MSM kernels' bound
over their profiled time in the window, %.  The bound is the larger of
the bytes and the 32-bit multiplies of the window's commitments counted
as the cheapest bucket (Pippenger) MSM (work.py): each commitment's base
count and scalar width, the advice columns' widths from the witness (the
reference's synthesis of each request), the rest from the constraint
system.  The points' normalisation to affine (field kernels) is in
neither the work nor the time."""
from __future__ import annotations

from portbench.peaks import bound_s
from portbench.tracing import kernel_seconds
from portbench.work import msm_work

KERNELS = ("fold_mixed_kernel", "fold_mixed_tiled_kernel",
           "fold_mixed_tiled_rows_kernel", "fold_add_kernel",
           "fold_add_tree_kernel", "fold_dbl_kernel", "fold_horner_kernel")


def read(ctx):
    if not ctx.trace or not ctx.msm_commitments:
        return None
    spent = kernel_seconds(ctx.trace.get("kernels", []), KERNELS)
    if not spent:
        return None
    return 100.0 * bound_s(*msm_work(ctx.msm_commitments)) / spent
