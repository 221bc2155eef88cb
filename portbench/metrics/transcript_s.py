"""transcript_s: the transcript (plonk/transcript.py): every challenge
squeezed, keccak over the bytes absorbed since the last squeeze, inside
and outside the phases (the program's spans `transcript.squeeze`), s a
proof."""
from __future__ import annotations

from portbench.records import span_seconds

SPANS = ("transcript.squeeze",)


def read(ctx):
    return span_seconds(ctx, SPANS)
