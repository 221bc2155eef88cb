"""synth_circuit_s: the circuits and gadgets (circuits/*, gadgets/*): the
copied circuits' synthesis, `circuit.synthesize`, inside the prover's
`synthesize` phase (the program's span `synthesize.circuit`), s a proof."""
from __future__ import annotations

from portbench.records import span_seconds

SPANS = ("synthesize.circuit",)


def read(ctx):
    return span_seconds(ctx, SPANS)
