"""warmup_s: set-up: the warm-up proofs of the cell's own traffic (the
first compiles the quotient's program and fills the part cache), s."""
from __future__ import annotations


def read(ctx):
    return ctx.setup.get("warmup_s")
