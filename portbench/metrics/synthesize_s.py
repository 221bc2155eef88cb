"""synthesize_s: the circuits and gadgets (circuits/*, gadgets/*): the
prover's `synthesize` phase, the witness and its rows as Python ints."""
from __future__ import annotations

PHASES = ("synthesize",)


def read(ctx):
    """The window's seconds in PHASES over its completed proofs."""
    if not ctx.phases or not ctx.proofs or not any(
            p in d for d in ctx.phases for p in PHASES):
        return None
    return sum(d.get(p, 0.0) for d in ctx.phases for p in PHASES) / ctx.proofs
