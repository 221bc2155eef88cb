"""What synthesis computes once rather than once a region or a cell: the
least-filled column of a chip's columns, the SHA packing's Const(2^i)
coefficients and the inverses of (byte - 255) the QR extractor writes.

None of it depends on the witness.  A region's column and rows are fixed by
the key (its selectors and permutation would not match otherwise), and the
constants are constants, so every value here equals the one it replaces:
`LeastFilled.least` names the column that

    min(range(len(fill)), key=fill.__getitem__)

names, ties going to the lowest index, in O(log columns) instead of
O(columns); the tables hold `Const(pow(2, i, R))` and
`pow((v - 255) % R, R - 2, R)`.
"""
from __future__ import annotations

import functools
import heapq

from ..fields.bn254 import R
from ..utils import trace

DELIM = 255         # the QR's field delimiter (qr_extractor.DELIM)
WORD_BITS = 32      # a SHA-256 word: the bit groups _pack_sum packs


class LeastFilled:
    """The least-filled of `columns` columns, ties to the lowest index.

    `fill` is the plain list of each column's fill, which the chips'
    occupancy reports and overflow messages read; `heap` holds one
    (fill, column) pair a column, so its least pair is min's answer.
    `placed` counts the regions placed; `report` adds what it has not yet
    reported to the traced proof's `placements`."""

    __slots__ = ("fill", "heap", "placed", "reported")

    def __init__(self, columns: int):
        self.fill = [0] * columns
        self.heap = [(0, ci) for ci in range(columns)]    # sorted: a heap
        self.placed = 0
        self.reported = 0

    def least(self) -> tuple[int, int]:
        """(column, fill) of the least-filled column."""
        fill, ci = self.heap[0]
        return ci, fill

    def take(self, n: int) -> None:
        """The least-filled column takes a region of n rows."""
        fill, ci = self.heap[0]
        heapq.heapreplace(self.heap, (fill + n, ci))
        self.fill[ci] = fill + n
        self.placed += 1


def report(*allocators: LeastFilled) -> None:
    """Adds the regions each allocator placed since its last report to the
    traced proof's `placements` counter (nothing outside a traced proof).
    The chips call it from their occupancy reports, once a synthesis, so a
    region counts once whichever report runs first."""
    rec = trace.current()
    for a in allocators:
        rec.count("placements", a.placed - a.reported)
        a.reported = a.placed


@functools.cache
def pow2_consts() -> tuple:
    """Const(2^i mod R) for i < WORD_BITS, built at first use (Const lives
    in flexgate, which imports this module)."""
    from .flexgate import Const
    return tuple(Const(pow(2, i, R)) for i in range(WORD_BITS))


@functools.cache
def _delim_inverses() -> tuple:
    return tuple(pow((v - DELIM) % R, R - 2, R) for v in range(DELIM))


def delim_inverse(v: int) -> int:
    """(v - 255)^-1 mod R (0 for v = 255): from a table for a byte below
    255, by Fermat's pow for any other value."""
    if 0 <= v < DELIM:
        return _delim_inverses()[v]
    return pow((v - DELIM) % R, R - 2, R)
