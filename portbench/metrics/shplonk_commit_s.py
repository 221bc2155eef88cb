"""shplonk_commit_s: the MSM (ops/msm.py): SHPLONK's two commitments, W and
W', inside the prover's `shplonk` phase (the program's spans
`shplonk.commit`), s a proof."""
from __future__ import annotations

from portbench.records import span_seconds

SPANS = ("shplonk.commit",)


def read(ctx):
    return span_seconds(ctx, SPANS)
