"""advice_ntt_s: the engine (plonk/engine.py): the advice columns' encoding
onto the device (from_ints_stack) and their inverse NTTs, the prover's
`advice_ntt` phase."""
from __future__ import annotations

PHASES = ("advice_ntt",)


def read(ctx):
    """The window's seconds in PHASES over its completed proofs."""
    if not ctx.phases or not ctx.proofs or not any(
            p in d for d in ctx.phases for p in PHASES):
        return None
    return sum(d.get(p, 0.0) for d in ctx.phases for p in PHASES) / ctx.proofs
