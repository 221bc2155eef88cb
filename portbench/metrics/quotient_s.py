"""quotient_s: the quotient (plonk/quotient.py): the prover's `quotient`
phase, every part's coset NTTs and field program."""
from __future__ import annotations

PHASES = ("quotient",)


def read(ctx):
    """The window's seconds in PHASES over its completed proofs."""
    if not ctx.phases or not ctx.proofs or not any(
            p in d for d in ctx.phases for p in PHASES):
        return None
    return sum(d.get(p, 0.0) for d in ctx.phases for p in PHASES) / ctx.proofs
