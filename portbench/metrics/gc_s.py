"""gc_s: the host runtime (CPython): the garbage collector's seconds in
the window a proof (gc.callbacks)."""
from __future__ import annotations


def read(ctx):
    if not ctx.proofs:
        return None
    return ctx.gc_s / ctx.proofs
