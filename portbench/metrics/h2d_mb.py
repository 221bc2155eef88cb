"""h2d_mb: the engine (fields/jfield.py): megabytes copied from the host to
the device by the field encodings (encode, encode_packed,
encode_narrow_stack; the program's counter `h2d_bytes`), a proof."""
from __future__ import annotations

from portbench.records import counter_total

COUNTER = "h2d_bytes"
SCALE = 1e-6


def read(ctx):
    return counter_total(ctx, COUNTER, SCALE)
