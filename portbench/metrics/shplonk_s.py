"""shplonk_s: SHPLONK (plonk/shplonk.py): the prover's `shplonk` phase, the
multi-opening's host steps and its two commitments."""
from __future__ import annotations

PHASES = ("shplonk",)


def read(ctx):
    """The window's seconds in PHASES over its completed proofs."""
    if not ctx.phases or not ctx.proofs or not any(
            p in d for d in ctx.phases for p in PHASES):
        return None
    return sum(d.get(p, 0.0) for d in ctx.phases for p in PHASES) / ctx.proofs
