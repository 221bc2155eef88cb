"""d2h_reads: the engine (fields/jfield.py, plonk/engine.py): blocking
reads from the device to the host, each `FieldSpec.decode` and the lookup
check's read of the failure flags (the program's counter `d2h_reads`), a
proof."""
from __future__ import annotations

from portbench.records import counter_total

COUNTER = "d2h_reads"
SCALE = 1


def read(ctx):
    return counter_total(ctx, COUNTER, SCALE)
