"""random_poly_s: the prover (plonk/prover.py): the vanishing argument's
random polynomial, its n draws, encoding and commitment, outside the
phases (the program's span `random_poly`), s a proof."""
from __future__ import annotations

from portbench.records import span_seconds

SPANS = ("random_poly",)


def read(ctx):
    return span_seconds(ctx, SPANS)
