"""kernel_ms: the device: the CUDA kernels' summed time a proof, from
torch.profiler's trace of the window, ms."""
from __future__ import annotations


def read(ctx):
    kernels = ctx.trace.get("kernels") if ctx.trace else None
    if not kernels or not ctx.proofs:
        return None
    return sum(d for _, d in kernels) * 1e3 / ctx.proofs
