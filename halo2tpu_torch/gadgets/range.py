"""Range chip (SURVEY N10) — re-design of halo2-base `RangeConfig`
(reference usage: anon-aadhaar-halo2/src/lib.rs:296-305, lookup_bits=12).

A fixed table column holds [0, 2^lookup_bits); dedicated lookup-advice
columns are constrained (PLONK lookup argument) to take values from it;
range_check copies value limbs into those columns.  Unused lookup rows
default to 0 which is in the table, so the lookup is total.

RangeInstructions parity (halo2-base src/gates/range.rs): range_check,
check_less_than, is_less_than, check_big_less_than / is_big_less_than via
limb decomposition, div_mod helpers live in the biguint chip.
"""
from __future__ import annotations

from ..fields.bn254 import R
from ..plonk.circuit import Assignment, Column, ConstraintSystem
from .flexgate import AssignedValue, Const, FlexGateConfig, GateChip, Witness
from .placement import LeastFilled, report


class RangeStrategyConfig:
    def __init__(self, cs: ConstraintSystem, gate: FlexGateConfig,
                 lookup_bits: int, num_lookup_advice: int):
        self.cs = cs
        self.gate = gate
        self.lookup_bits = lookup_bits
        self.table = cs.fixed_column()
        self.lookup_advice: list[Column] = []
        t = cs.query_fixed(self.table, 0)
        for _ in range(num_lookup_advice):
            col = cs.advice_column()
            cs.enable_equality(col)
            self.lookup_advice.append(col)
            cs.lookup(f"range_{col.index}",
                      [(cs.query_advice(col, 0), t)],
                      max_bits=lookup_bits)

    @classmethod
    def configure(cls, cs, gate, lookup_bits, num_lookup_advice):
        return cls(cs, gate, lookup_bits, num_lookup_advice)


class RangeChip:
    """Bound to (config, gate chip, assignment) for one synthesize pass."""

    def __init__(self, cfg: RangeStrategyConfig, gate: GateChip,
                 asn: Assignment):
        self.cfg = cfg
        self.gate = gate
        self.asn = asn
        self.bits = cfg.lookup_bits
        self.cols = LeastFilled(len(cfg.lookup_advice))
        self._cursor = self.cols.fill
        self.lookups_used = 0

    def load_table(self) -> None:
        n = 1 << self.bits
        assert n <= self.asn.usable, (
            f"lookup table 2^{self.bits} does not fit in {self.asn.usable} "
            "usable rows")
        for i in range(n):
            self.asn.assign_fixed(self.cfg.table, i, i)

    # -- primitive: constrain an existing cell to [0, 2^bits) -----------------
    def _lookup_cell(self, cell: AssignedValue) -> None:
        ci, row = self.cols.least()
        assert row < self.asn.usable, "lookup advice columns exhausted"
        col = self.cfg.lookup_advice[ci]
        self.asn.assign_advice(col, row, cell.value)
        self.asn.copy((cell.col, cell.row), (col, row))
        self.cols.take(1)
        self.lookups_used += 1

    def range_check(self, a: AssignedValue, nbits: int) -> list[AssignedValue]:
        """Constrain a < 2^nbits.  Decomposes into lookup_bits-sized limbs
        (little-endian), looks each up, recomposes; the top limb of width
        rem < lookup_bits is additionally checked via the shift trick
        (limb * 2^(lookup_bits-rem) must also be in the table)."""
        assert a.value < (1 << nbits), f"witness {a.value} >= 2^{nbits}"
        lb = self.bits
        if nbits <= lb:
            if nbits == lb:
                self._lookup_cell(a)
                return [a]
            shifted = self.gate.assign_region(
                [Const(0), a, Const(1 << (lb - nbits)),
                 Witness((a.value << (lb - nbits)) % R)], [0])[3]
            self._lookup_cell(a)
            self._lookup_cell(shifted)
            return [a]
        nlimbs = (nbits + lb - 1) // lb
        limbs = [(a.value >> (i * lb)) & ((1 << lb) - 1) for i in range(nlimbs)]
        lcells = [self.gate.load_witness(v) for v in limbs]
        rec = self.gate.linear_combination(
            lcells, [pow(2, i * lb, R) for i in range(nlimbs)])
        self.gate.assert_equal(rec, a)
        rem = nbits - (nlimbs - 1) * lb
        for i, lc in enumerate(lcells):
            self._lookup_cell(lc)
            if i == nlimbs - 1 and rem < lb:
                shifted = self.gate.assign_region(
                    [Const(0), lc, Const(1 << (lb - rem)),
                     Witness((lc.value << (lb - rem)) % R)], [0])[3]
                self._lookup_cell(shifted)
        return lcells

    # -- comparisons (halo2-base range.rs style) -------------------------------
    def check_less_than(self, a: AssignedValue, b: AssignedValue,
                        nbits: int) -> None:
        """Constrain a < b where both < 2^nbits: check a - b + 2^nbits
        in [0, 2^nbits) ... i.e. shifted = a + 2^nbits - b < 2^nbits."""
        shifted_v = (a.value + (1 << nbits) - b.value) % R
        # cell: shifted + b*1 == a + 2^nbits
        apow = self.gate.assign_region(
            [a, Const(1 << nbits), Const(1),
             Witness((a.value + (1 << nbits)) % R)], [0])[3]
        sh = self.gate.assign_region(
            [Witness(shifted_v), b, Const(1), apow], [0])[0]
        self.range_check(sh, nbits)

    def is_less_than(self, a: AssignedValue, b: AssignedValue,
                     nbits: int) -> AssignedValue:
        """Boolean a < b for a, b < 2^nbits.
        shifted = a - b + 2^nbits in (0, 2^(nbits+1));
        its bit nbits is 1 iff a >= b."""
        sv = a.value - b.value + (1 << nbits)
        apow = self.gate.assign_region(
            [a, Const(1 << nbits), Const(1),
             Witness((a.value + (1 << nbits)) % R)], [0])[3]
        sh = self.gate.assign_region(
            [Witness(sv % R), b, Const(1), apow], [0])[0]
        low = sv & ((1 << nbits) - 1)
        hibit = sv >> nbits
        lowc = self.gate.load_witness(low)
        hic = self.gate.load_witness(hibit)
        self.gate.assert_bit(hic)
        self.range_check(lowc, nbits)
        rec = self.gate.assign_region(
            [lowc, hic, Const(1 << nbits), sh], [0])
        # a < b  <=>  hibit == 0
        return self.gate.not_(hic)

    def finalize(self) -> dict:
        """Occupancy report (tracing aid, SURVEY §5.1); adds the regions
        the gate and lookup columns placed to the traced proof's
        `placements`."""
        report(self.gate.cols, self.cols)
        return {
            "gate_cells": self.gate.cells_assigned,
            "gate_fill": list(self.gate.col_fill),
            "lookup_cells": self.lookups_used,
            "lookup_fill": list(self._cursor),
        }
