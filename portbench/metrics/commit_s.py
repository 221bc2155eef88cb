"""commit_s: the MSM (ops/msm.py): the prover's commitment phases."""
from __future__ import annotations

PHASES = ("commit_advice", "commit_lookup_permuted", "commit_z", "commit_h")


def read(ctx):
    """The window's seconds in PHASES over its completed proofs."""
    if not ctx.phases or not ctx.proofs or not any(
            p in d for d in ctx.phases for p in PHASES):
        return None
    return sum(d.get(p, 0.0) for d in ctx.phases for p in PHASES) / ctx.proofs
