"""advice_encode_s: the engine (plonk/engine.py): the advice columns' host
encoding (limbs, packing) and their copy to the device, inside the
prover's `advice_ntt` phase (the program's span `advice_ntt.encode`), s
a proof."""
from __future__ import annotations

from portbench.records import span_seconds

SPANS = ("advice_ntt.encode",)


def read(ctx):
    return span_seconds(ctx, SPANS)
