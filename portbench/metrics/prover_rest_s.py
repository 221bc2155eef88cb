"""prover_rest_s: the prover (plonk/prover.py) outside its phases: each
proof's wall seconds less the seconds of all its phases, a proof."""
from __future__ import annotations


def read(ctx):
    if not ctx.phases or not ctx.proofs or len(ctx.phases) != len(
            ctx.proof_seconds):
        return None
    rest = sum(wall - sum(d.values())
               for wall, d in zip(ctx.proof_seconds, ctx.phases))
    return rest / ctx.proofs
