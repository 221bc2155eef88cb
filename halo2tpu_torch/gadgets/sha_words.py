"""The SHA-256 chip's witness a word at a time (gadgets/sha256.py).

Every value of a SHA lane run follows from one 32-bit word: a sigma, ch or
maj run's four columns are the bits of its three operand words and of
their word op, a q_dec run's bit and accumulator columns are `v >> s` for
its one value.  So the hash path keeps each word as an int and a place:

    Bits(value, col, base, step)     bit j is the cell (col, base + step*j)

and never makes a bit cell.  Each run or packing region is placed when the
per-cell code would place it (the lanes' and the gate's LeastFilled, in
the same order and with the same sizes), its selectors and, while the
Assignment records, its copies are written then, in the per-cell code's
order; the advice values wait in a list of words and `flush` writes them
in bulk, one slice a lane column and one index array a gate column.  The
cells that leave the SHA code stay AssignedValues: the state and schedule
words the gate reads, the carries of the low-word regions and the digest's
bytes (`byte_cells`).

Values equal the per-cell code's cell for cell: every cell here is a bit,
a power of two below 2^32 or a sum below 2^63 of words below 2^32 (pack
asserts it), so int64 holds it and its reduction mod R is itself, and
numpy writes int64 into the object columns as Python ints.
"""
from __future__ import annotations

from collections import defaultdict

import numpy as np

from ..utils import trace
from .flexgate import AssignedValue, Const, Witness

MASK = 0xFFFFFFFF
XOR, CH, MAJ, DEC = 0, 1, 2, 3      # a lane run's kind; DEC0 is DEC's row 0
DEC0 = 4
QNAMES = ("q_xor", "q_ch", "q_maj", "q_dec", "q_dec0")
_OPS = (lambda x, y, z: x ^ y ^ z,
        lambda x, y, z: z ^ (x & (y ^ z)),
        lambda x, y, z: (x & y) | (z & (x | y)))
# a view's source bit for row i: ROTR^r takes bit (i + r) % 32, SHR^s bit
# i + s, or the zero cell (-1) past the top
_ROTR = tuple(tuple((i + r) % 32 for i in range(32)) for r in range(32))
_SHR = tuple(tuple(i + s if i + s < 32 else -1 for i in range(32))
             for s in range(33))
_I32 = np.arange(32, dtype=np.int64)
_LOW = (2 << _I32) - 1              # masks of bits 0..i


class Bits:
    """A word's 32 bit cells, LSB first, by place: bit j is the cell
    (col, base + step * j); `value` is the word."""
    __slots__ = ("value", "col", "base", "step")

    def __init__(self, value: int, col, base: int, step: int):
        self.value = value
        self.col = col
        self.base = base
        self.step = step

    def cell(self, j: int) -> AssignedValue:
        return AssignedValue(self.col, self.base + self.step * j,
                             (self.value >> j) & 1)


def rotr(b: Bits, r: int = 0):
    """The operand ROTR^r(b) of a lane run, b itself at r = 0: (its word,
    b, the source bit of each row)."""
    v = b.value
    return ((v >> r) | (v << (32 - r))) & MASK, b, _ROTR[r]


class WordLanes:
    """The word-level emitter of one Sha256Chip (see the module)."""

    def __init__(self, chip):
        self.chip = chip
        self.gate = chip.gate
        self.rec = chip.asn.recording
        self.copies = chip.asn.copies
        # pending values, flat: 8 ints a run (lane, start, rows, kind and
        # its four words), and a region's (col, start, words..., extras...)
        # under its (words, extras) count
        self.runs = []
        self.packs = defaultdict(list)
        self.rows_written = 0
        self.rows_reported = 0

    # -- operands -------------------------------------------------------------
    def shr(self, b: Bits, s: int):
        """The operand SHR^s(b); loads the chip's zero cell, as the
        per-cell `_shr` does, for the bits shifted in."""
        self.chip._zero_cell()
        return b.value >> s, b, _SHR[s]

    def _sources(self, operand):
        _, b, src = operand
        col, base, step = b.col, b.base, b.step
        z = self.chip._zero
        return [(col, base + step * j) if j >= 0 else (z.col, z.row)
                for j in src]

    # -- lane runs ------------------------------------------------------------
    def bitop(self, kind: int, x, y, z) -> Bits:
        """One q_xor / q_ch / q_maj run of 32 rows over three operands;
        the output word's bits are the run's u3 cells."""
        li, start = self.chip._lane_rows(32)
        o = _OPS[kind](x[0], y[0], z[0])
        self.runs.extend((li, start, 32, kind, x[0], y[0], z[0], o))
        u = self.chip.cfg.lanes[li]["u"]
        if self.rec:
            rows = range(start, start + 32)
            self.copies.extend(
                c for sx, sy, sz, row in zip(self._sources(x),
                                             self._sources(y),
                                             self._sources(z), rows)
                for c in ((sx, (u[0], row)), (sy, (u[1], row)),
                          (sz, (u[2], row))))
        return Bits(o, u[3], start, 1)

    def decompose(self, cell: AssignedValue, nbits: int):
        """The per-cell `decompose` by word: (the word's cell, its Bits).
        Above 32 bits the word's cell is the low-word gate region's."""
        v = cell.value
        assert v < (1 << nbits)
        li, start = self.chip._lane_rows(nbits)
        self.runs.extend((li, start, nbits, DEC, v, 0, 0, v))
        u = self.chip.cfg.lanes[li]["u"]
        last = start + nbits - 1
        if self.rec:
            self.copies.append(((cell.col, cell.row), (u[3], last)))
        bits = Bits(v & MASK, u[0], last, -1)
        if nbits <= 32:
            return cell, bits
        carry = AssignedValue(u[3], last - 32, v >> 32)
        low = self.gate.assign_region(
            [Witness(v & MASK), carry, Const(1 << 32), cell], [0])[0]
        return low, bits

    # -- gate regions ---------------------------------------------------------
    def pack(self, words: list, extras: list) -> AssignedValue:
        """The per-cell `_pack_sum` by word: sum_g sum_i 2^i * bit_i(g)
        + sum extras as one inner-product region [0, (bit, 2^i, acc)...,
        (extra, 1, acc)...] of the least-filled gate column."""
        g = self.gate
        n = 1 + 3 * (32 * len(words) + len(extras))
        ci, start = g.cols.least()
        if start + n > g.usable:
            raise OverflowError(
                f"advice columns exhausted: region of {n} cells, "
                f"fill={g.col_fill}")
        col = g.cfg.advice[ci]
        wv = [b.value for b in words]
        ev = [c.value for c in extras]
        acc = sum(wv) + sum(ev)
        assert acc < 1 << 63
        self.packs[len(words), len(extras)].extend((ci, start, *wv, *ev))
        if self.rec:
            self._pack_copies(words, extras, col, start)
        g._q_arrays[ci][start:start + n - 1:3] = 1
        g.cols.take(n)
        g.cells_assigned += n
        return AssignedValue(col, start + n - 1, acc)

    def _pack_copies(self, words, extras, col, start):
        const_cell = self.gate._const_cell
        copies = self.copies
        copies.append((const_cell(0), (col, start)))
        row = start + 1
        for b in words:
            for j in range(32):
                copies.append(((b.col, b.base + b.step * j), (col, row)))
                copies.append((const_cell(1 << j), (col, row + 1)))
                row += 3
        for c in extras:
            copies.append(((c.col, c.row), (col, row)))
            copies.append((const_cell(1), (col, row + 1)))
            row += 3

    def byte_cells(self, bits: Bits) -> list:
        """The word's four big-endian digest bytes, each an inner product
        of its eight bit cells (made here: they leave the SHA code)."""
        return [self.gate.inner_product(
                    [bits.cell(i) for i in range(24 - 8 * j, 32 - 8 * j)],
                    [Const(1 << i) for i in range(8)])
                for j in range(4)]

    # -- bulk writes ----------------------------------------------------------
    def flush(self) -> None:
        """Writes every pending run's and region's advice values."""
        if self.runs:
            self._flush_lanes()
            self.runs = []
        for (nw, ne), regions in self.packs.items():
            self._flush_packs(nw, ne, regions)
        self.packs.clear()

    def _flush_lanes(self):
        """Every lane column once: a lane's runs tile its rows, so each is
        one slice (an index array if other runs lie between).  A q_dec
        run's u1 and u2 get the zeros they hold."""
        runs = np.array(self.runs, dtype=np.int64).reshape(-1, 8)
        runs = runs[np.lexsort((runs[:, 1], runs[:, 0]))]   # lane, start
        rows = runs[:, 2]
        ends = np.cumsum(rows)
        i = np.arange(ends[-1], dtype=np.int64) - np.repeat(ends - rows, rows)
        kind = np.repeat(runs[:, 3], rows)
        dec = kind == DEC
        sh = np.where(dec, np.repeat(rows, rows) - 1 - i, i)
        vals = np.repeat(np.ascontiguousarray(runs[:, 4:].T), rows, axis=1)
        vals >>= sh
        vals[:3] &= 1
        vals[3] &= np.where(dec, -1, 1)     # a q_dec run's accumulator
        kind[dec & (i == 0)] = DEC0
        row = np.repeat(runs[:, 1], rows) + i
        lane_ends = np.searchsorted(
            runs[:, 0], np.arange(len(self.chip.cfg.lanes)), side="right")
        p = 0
        for li, q in enumerate(np.concatenate([[0], ends])[lane_ends]):
            if q == p:
                continue
            arrs = self.chip._lane_arrs[li]
            seg = row[p:q]
            at = (slice(int(seg[0]), int(seg[-1]) + 1)
                  if seg[-1] - seg[0] == q - p - 1 else seg)
            for k in range(4):
                arrs["u"][k][at] = vals[k, p:q]
            kinds = kind[p:q]
            for k, qname in enumerate(QNAMES):
                arrs[qname][seg[kinds == k]] = 1
            p = q
        self.rows_written += int(ends[-1])

    def _flush_packs(self, nw, ne, regions):
        reg = np.array(regions, dtype=np.int64).reshape(-1, 2 + nw + ne)
        w, e = reg[:, 2:2 + nw], reg[:, 2 + nw:]
        m = len(reg)
        bits = ((w[:, :, None] >> _I32) & 1).reshape(m, 32 * nw)
        before = np.cumsum(w, axis=1) - w
        accw = (before[:, :, None] + (w[:, :, None] & _LOW)).reshape(m, -1)
        acce = w.sum(axis=1)[:, None] + np.cumsum(e, axis=1)
        n = 1 + 3 * (32 * nw + ne)
        vals = np.zeros((m, n), dtype=np.int64)
        vals[:, 1::3] = np.concatenate([bits, e], axis=1)
        vals[:, 2::3] = np.concatenate(
            [np.tile(1 << _I32, (m, nw)), np.ones((m, ne), np.int64)], axis=1)
        vals[:, 3::3] = np.concatenate([accw, acce], axis=1)
        cols = reg[:, 0]
        offs = np.arange(n, dtype=np.int64)
        for ci in np.unique(cols):
            mine = cols == ci
            at = (reg[mine, 1][:, None] + offs).ravel()
            self.gate._adv_arrays[ci][at] = vals[mine].ravel()

    def report(self) -> None:
        """Adds the lane rows written since the last report to the traced
        proof's `sha_bulk_rows` (nothing outside a traced proof)."""
        trace.current().count("sha_bulk_rows",
                              self.rows_written - self.rows_reported)
        self.rows_reported = self.rows_written
