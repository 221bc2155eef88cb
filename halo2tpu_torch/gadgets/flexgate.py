"""Flex-gate gadget substrate (SURVEY N10) — TPU-first re-design of
halo2-base's `FlexGateConfig`/`GateInstructions` (reference usage:
anon-aadhaar-halo2/src/lib.rs:20-25, src/big_uint/chip.rs).

Semantics kept from halo2-base (Vertical strategy): computation is a stream
of cells in *virtual columns*; every enabled vertical gate enforces

    a[i] + a[i+1] * a[i+2] == a[i+3]

on four consecutive cells of one physical advice column; dataflow between
ops is copy (permutation) constraints; constants live in one fixed column
and are copy-constrained.

TPU-first departures from the Rust design:
  * no Layouter/Region two-pass — ops assign eagerly into the dense
    Assignment matrix (values are plain python ints; witness generation is
    not the hot path, the prover kernels are);
  * regions are placed greedily into the least-filled physical column
    (same packing idea as halo2-base's min-gate-index context juggling,
    anon-aadhaar-halo2's dep halo2-base 0.2.2), found in a heap of the
    columns' fills (gadgets/placement.py);
  * the layout is static given the op stream, so the emitted circuit IR is
    a fixed matrix ready for the vectorized prover.

GateInstructions parity (halo2-base src/gates/flex_gate.rs ops used by the
reference): add, sub, neg, mul, mul_add, mul_not, and, or, not, select,
is_equal, is_zero, inner_product, num_to_bits, idx_to_indicator,
assert_is_const, load_witness/constant/zero, assert_equal, div_unsafe.
"""
from __future__ import annotations

from ..fields.bn254 import R, inv_mod
from ..plonk.circuit import Assignment, Column, ConstraintSystem
from .placement import LeastFilled


class AssignedValue:
    """A witness cell: physical (column, row) plus its value.
    Hand-rolled __slots__ class: synthesis creates millions of these and
    the frozen-dataclass __init__ alone cost ~20% of witness generation."""

    __slots__ = ("col", "row", "value")

    def __init__(self, col: Column, row: int, value: int):
        self.col = col
        self.row = row
        self.value = value

    def __repr__(self):
        return f"AssignedValue({self.col!r}, {self.row}, {self.value})"


class FlexGateConfig:
    """Columns + the vertical gate family."""

    def __init__(self, cs: ConstraintSystem, num_advice: int):
        self.cs = cs
        self.num_advice = num_advice
        self.advice: list[Column] = []
        self.q_enable: list[Column] = []
        self.constants_col = cs.fixed_column()
        cs.enable_equality(self.constants_col)
        for _ in range(num_advice):
            a = cs.advice_column()
            q = cs.fixed_column()
            cs.enable_equality(a)
            self.advice.append(a)
            self.q_enable.append(q)
            qq = cs.query_fixed(q, 0)
            a0 = cs.query_advice(a, 0)
            a1 = cs.query_advice(a, 1)
            a2 = cs.query_advice(a, 2)
            a3 = cs.query_advice(a, 3)
            cs.create_gate(f"vertical_gate_{a.index}",
                           qq * (a0 + a1 * a2 - a3))

    @classmethod
    def configure(cls, cs: ConstraintSystem, num_advice: int):
        return cls(cs, num_advice)


class Witness:
    """Marker for a fresh witness value in a region spec."""
    __slots__ = ("value",)

    def __init__(self, value: int):
        self.value = value % R


class Const:
    """Marker for a constant cell (copy-constrained to the fixed column)."""
    __slots__ = ("value",)

    def __init__(self, value: int):
        self.value = value % R


class GateChip:
    """Op emitter bound to (config, assignment). One instance per synthesize.

    Cell spec elements accepted by assign_region:
      AssignedValue -> new cell copy-constrained to the existing one
      Const(c)      -> new cell copy-constrained to constant c
      Witness(v)    -> new unconstrained witness cell
    """

    def __init__(self, config: FlexGateConfig, asn: Assignment):
        self.cfg = config
        self.asn = asn
        self.usable = asn.usable
        self.cols = LeastFilled(config.num_advice)
        self.col_fill = self.cols.fill
        self._const_rows: dict[int, int] = {}
        self._n_const = 0
        self.cells_assigned = 0
        # direct array/handle caches: assign_region is the synthesis hot
        # loop (millions of cells) and must not pay per-cell method dispatch
        self._adv_arrays = [asn.advice[c.index] for c in config.advice]
        self._q_arrays = [asn.fixed[c.index] for c in config.q_enable]
        self._copies = asn.copies
        # proof-time synthesis (asn.recording False) skips all copy/const
        # bookkeeping — the pk already holds the permutation and fixed cols
        self._rec = asn.recording

    # -- placement ----------------------------------------------------------
    def _const_cell(self, value: int) -> tuple[Column, int]:
        value %= R
        row = self._const_rows.get(value)
        if row is None:
            row = self._n_const
            assert row < self.usable, "constants column overflow"
            self.asn.assign_fixed(self.cfg.constants_col, row, value)
            self._const_rows[value] = row
            self._n_const += 1
        return (self.cfg.constants_col, row)

    def assign_region(self, spec: list, gate_offsets: list[int]
                      ) -> list[AssignedValue]:
        """Place a contiguous region into the least-filled advice column;
        enable the vertical gate at each offset in gate_offsets.

        Hot loop: writes the column array and appends copies directly —
        every flexgate column has enable_equality (configure), so the
        Assignment.copy membership assertion is statically satisfied."""
        n = len(spec)
        ci, start = self.cols.least()
        if start + n > self.usable:
            raise OverflowError(
                f"advice columns exhausted: region of {n} cells, "
                f"fill={self.col_fill}")
        col = self.cfg.advice[ci]
        arr = self._adv_arrays[ci]
        copies = self._copies
        rec = self._rec
        out: list[AssignedValue] = []
        row = start
        for cell in spec:
            v = cell.value
            if rec:
                tc = type(cell)
                if tc is AssignedValue:
                    copies.append(((cell.col, cell.row), (col, row)))
                elif tc is Const:
                    copies.append((self._const_cell(v), (col, row)))
            arr[row] = v
            out.append(AssignedValue(col, row, v))
            row += 1
        qarr = self._q_arrays[ci]
        for off in gate_offsets:
            qarr[start + off] = 1
        self.cols.take(n)
        self.cells_assigned += n
        return out

    # -- loads ---------------------------------------------------------------
    def load_witness(self, v: int) -> AssignedValue:
        return self.assign_region([Witness(v)], [])[0]

    def load_constant(self, c: int) -> AssignedValue:
        return self.assign_region([Const(c)], [])[0]

    def load_zero(self) -> AssignedValue:
        return self.load_constant(0)

    # -- core arithmetic (cell layouts follow halo2-base flex_gate.rs) -------
    def add(self, a: AssignedValue, b: AssignedValue) -> AssignedValue:
        out = (a.value + b.value) % R
        return self.assign_region([a, b, Const(1), Witness(out)], [0])[3]

    def sub(self, a: AssignedValue, b: AssignedValue) -> AssignedValue:
        out = (a.value - b.value) % R
        # out + b*1 == a
        return self.assign_region([Witness(out), b, Const(1), a], [0])[0]

    def neg(self, a: AssignedValue) -> AssignedValue:
        out = (-a.value) % R
        # out + a*1 == 0
        return self.assign_region([Witness(out), a, Const(1), Const(0)], [0])[0]

    def mul(self, a: AssignedValue, b: AssignedValue) -> AssignedValue:
        out = a.value * b.value % R
        return self.assign_region([Const(0), a, b, Witness(out)], [0])[3]

    def mul_add(self, a: AssignedValue, b: AssignedValue,
                c: AssignedValue) -> AssignedValue:
        """Returns a*b + c."""
        out = (a.value * b.value + c.value) % R
        return self.assign_region([c, a, b, Witness(out)], [0])[3]

    def mul_not(self, a: AssignedValue, b: AssignedValue) -> AssignedValue:
        """(1-a)*b: layout [out, a, b, b] -> out + a*b == b."""
        out = (1 - a.value) * b.value % R
        return self.assign_region([Witness(out), a, b, b], [0])[0]

    def and_(self, a: AssignedValue, b: AssignedValue) -> AssignedValue:
        return self.mul(a, b)

    def not_(self, a: AssignedValue) -> AssignedValue:
        # out + a*1 == 1
        out = (1 - a.value) % R
        return self.assign_region([Witness(out), a, Const(1), Const(1)], [0])[0]

    def or_(self, a: AssignedValue, b: AssignedValue) -> AssignedValue:
        # a + b - a*b: t = a*b; out + t*1 == a + b... two gates:
        # s = a + b ; out = s - a*b via [out, a, b, s]
        s = self.add(a, b)
        out = (a.value + b.value - a.value * b.value) % R
        return self.assign_region([Witness(out), a, b, s], [0])[0]

    def select(self, a: AssignedValue, b: AssignedValue,
               sel: AssignedValue) -> AssignedValue:
        """sel ? a : b  (sel boolean).  out = b + sel*(a-b)."""
        diff = self.sub(a, b)
        out = (b.value + sel.value * diff.value) % R
        return self.assign_region([b, sel, diff, Witness(out)], [0])[3]

    def div_unsafe(self, a: AssignedValue, b: AssignedValue) -> AssignedValue:
        """a/b with witness inverse (b must be nonzero; constrained by
        out*b == a)."""
        out = a.value * inv_mod(b.value, R) % R
        return self.assign_region([Const(0), Witness(out), b, a], [0])[1]

    # -- equality / zero tests ------------------------------------------------
    def assert_equal(self, a: AssignedValue, b: AssignedValue) -> None:
        self.asn.copy((a.col, a.row), (b.col, b.row))

    def assert_is_const(self, a: AssignedValue, c: int) -> None:
        self.asn.copy((a.col, a.row), self._const_cell(c))

    def is_zero(self, a: AssignedValue) -> AssignedValue:
        """1 if a == 0 else 0.  Witness inv; m = a*inv; out = 1 - m;
        constrain a*out == 0."""
        inv = inv_mod(a.value, R) if a.value != 0 else 0
        m = a.value * inv % R
        cells = self.assign_region(
            [Const(0), a, Witness(inv), Witness(m)], [0])
        mcell = cells[3]
        out = (1 - m) % R
        ocell = self.assign_region(
            [Witness(out), mcell, Const(1), Const(1)], [0])[0]
        # a * out == 0
        self.assign_region([Const(0), a, ocell, Const(0)], [0])
        return ocell

    def is_equal(self, a: AssignedValue, b: AssignedValue) -> AssignedValue:
        return self.is_zero(self.sub(a, b))

    def assert_bit(self, a: AssignedValue) -> None:
        # 0 + a*a == a  <=>  a boolean
        self.assign_region([Const(0), a, a, a], [0])

    # -- vectors ---------------------------------------------------------------
    def inner_product(self, a: list, b: list) -> AssignedValue:
        """<a, b> as one chained region: acc_{k+1} = acc_k + a_k*b_k.
        Elements may be AssignedValue, Const, or Witness (fresh).

        Direct-emission specialization of the assign_region layout
        [Const(0), (x, y, Witness(acc))*] with gates at 0, 3, 6, ... —
        inner products carry most of the bigint/sha synthesis cells, and
        the generic spec-list path costs ~2x in object churn."""
        assert len(a) == len(b) and a
        n = 1 + 3 * len(a)
        ci, start = self.cols.least()
        if start + n > self.usable:
            raise OverflowError(
                f"advice columns exhausted: region of {n} cells, "
                f"fill={self.col_fill}")
        col = self.cfg.advice[ci]
        arr = self._adv_arrays[ci]
        copies = self._copies
        const_cell = self._const_cell
        rec = self._rec
        row = start
        arr[row] = 0
        if rec:
            copies.append((const_cell(0), (col, row)))
        row += 1
        acc = 0
        for x, y in zip(a, b):
            xv = x.value
            yv = y.value
            for cell, v in ((x, xv), (y, yv)):
                if rec:
                    tc = type(cell)
                    if tc is AssignedValue:
                        copies.append(((cell.col, cell.row), (col, row)))
                    elif tc is Const:
                        copies.append((const_cell(v), (col, row)))
                arr[row] = v
                row += 1
            acc = (acc + xv * yv) % R
            arr[row] = acc
            row += 1
        qarr = self._q_arrays[ci]
        for off in range(start, start + n - 1, 3):
            qarr[off] = 1
        self.cols.take(n)
        self.cells_assigned += n
        return AssignedValue(col, row - 1, acc)

    def linear_combination(self, vals: list, coeffs: list[int]
                           ) -> AssignedValue:
        return self.inner_product(vals, [Const(c) for c in coeffs])

    def sum(self, vals: list) -> AssignedValue:
        return self.inner_product(vals, [Const(1)] * len(vals))

    def num_to_bits(self, a: AssignedValue, nbits: int) -> list[AssignedValue]:
        """Little-endian boolean decomposition, constrained to recompose."""
        bits = [(a.value >> i) & 1 for i in range(nbits)]
        assert a.value < (1 << nbits), "value exceeds bit width"
        bcells = []
        for bv in bits:
            # booleanity: [b, b, b, 2b] gate b + b*b = 2b... needs 2b cell
            # simpler: [0, b, b, b] gate: 0 + b*b == b
            c = self.assign_region(
                [Const(0), Witness(bv), Witness(bv), Witness(bv)], [0])
            self.asn.copy((c[1].col, c[1].row), (c[2].col, c[2].row))
            self.asn.copy((c[1].col, c[1].row), (c[3].col, c[3].row))
            bcells.append(c[1])
        recomposed = self.linear_combination(
            bcells, [pow(2, i, R) for i in range(nbits)])
        self.assert_equal(recomposed, a)
        return bcells

    def idx_to_indicator(self, idx: AssignedValue, size: int
                         ) -> list[AssignedValue]:
        """One-hot indicator vector of length size for idx."""
        out = []
        for i in range(size):
            ic = self.load_constant(i)
            out.append(self.is_equal(idx, ic))
        return out

    def select_by_indicator(self, vals: list, ind: list) -> AssignedValue:
        return self.inner_product(vals, ind)

    def pow2_lookup(self, e: AssignedValue, max_bits: int) -> AssignedValue:
        """2^e for 0 <= e < max_bits via indicator select."""
        ind = self.idx_to_indicator(e, max_bits)
        return self.inner_product(
            ind, [Const(pow(2, i, R)) for i in range(max_bits)])
