"""key_load_s: set-up (plonk/srs.py, plonk/keygen.py): the SRS and the
proving key from the checkout's cache (made there when missing), and the
engine on them, s."""
from __future__ import annotations


def read(ctx):
    return ctx.setup.get("key_load_s")
