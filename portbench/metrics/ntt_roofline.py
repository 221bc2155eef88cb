"""ntt_roofline: the kernels (csrc/ntt.cu): the NTT kernel's bound over
its profiled time in the window, %.  The bound is the larger of the
bytes and the 32-bit multiplies the window's transforms need (work.py's
ntt_work), counted from each transform's size and column count (the
program's `ntt_kernel.shapes`), never from its passes or launches."""
from __future__ import annotations

from portbench.peaks import bound_s
from portbench.tracing import kernel_seconds
from portbench.work import ntt_work

KERNELS = ("ntt_pass_kernel",)


def read(ctx):
    if not ctx.trace or not ctx.ntt_shapes:
        return None
    spent = kernel_seconds(ctx.trace.get("kernels", []), KERNELS)
    if not spent:
        return None
    return 100.0 * bound_s(*ntt_work(ctx.ntt_shapes)) / spent
