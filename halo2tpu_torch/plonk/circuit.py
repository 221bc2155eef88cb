"""Circuit IR: columns, constraint system, assignments.

TPU-first redesign of halo2's `ConstraintSystem`/`Circuit` (reference usage:
anon-aadhaar-halo2/src/signal.rs:27-49): circuits declare a static constraint
system once (`configure`) and fill a dense column matrix (`synthesize`) —
no Region/Layouter two-pass machinery (a Rust-idiom artifact per SURVEY §7).

Selectors are plain boolean fixed columns (halo2's selector compression is an
optimization we skip; each selector gets its own fixed column, which changes
only our own vk layout, not capability).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..fields.bn254 import R
from .expression import (
    AdviceQuery,
    Constant,
    Expr,
    FixedQuery,
    InstanceQuery,
    collect_queries,
)


class Column:
    """A column handle.  Hand-rolled (not a dataclass): synthesis hashes and
    compares columns millions of times via copy()/assign()."""

    __slots__ = ("kind", "index", "_hash")

    def __init__(self, kind: str, index: int):
        self.kind = kind    # 'advice' | 'fixed' | 'instance'
        self.index = index
        self._hash = hash((kind, index))

    def __hash__(self):
        return self._hash

    def __eq__(self, other):
        return (self is other
                or (isinstance(other, Column) and self.kind == other.kind
                    and self.index == other.index))

    def __lt__(self, other):
        return (self.kind, self.index) < (other.kind, other.index)

    def __repr__(self):
        return f"Column({self.kind!r}, {self.index})"

    # __slots__ + legacy (dataclass-era pickle cache) compatibility
    def __getstate__(self):
        return (self.kind, self.index)

    def __setstate__(self, state):
        if isinstance(state, dict):
            kind, index = state["kind"], state["index"]
        else:
            kind, index = state[:2]
        self.__init__(kind, index)


@dataclass
class Gate:
    name: str
    polys: list  # list[Expr]


@dataclass
class Lookup:
    name: str
    # list of (input_expr, table_expr) pairs; compressed with theta powers
    pairs: list
    # optional static bound: ALL honest input/table values < 2^max_bits
    # (single-pair lookups only, e.g. range tables).  Engines may sort with
    # narrow keys; a value exceeding the bound flips the lookup-fail flag
    # (such a witness could never satisfy the lookup anyway).
    max_bits: int | None = None


class ConstraintSystem:
    def __init__(self):
        self.num_advice = 0
        self.num_fixed = 0
        self.num_instance = 0
        self.gates: list[Gate] = []
        self.lookups: list[Lookup] = []
        # columns participating in the permutation argument, in
        # enable_equality order (determines sigma poly order; the on-chain
        # verifier binds delta powers to this order, contract.sol:475-501)
        self.permutation_columns: list[Column] = []
        # ordered, deduplicated query lists -> proof eval layout
        self.advice_queries: list[tuple[int, int]] = []   # (col_idx, rotation)
        self.fixed_queries: list[tuple[int, int]] = []
        self.instance_queries: list[tuple[int, int]] = []
        self._query_set: set = set()

    # -- column constructors ------------------------------------------------
    def advice_column(self) -> Column:
        c = Column("advice", self.num_advice)
        self.num_advice += 1
        return c

    def fixed_column(self) -> Column:
        c = Column("fixed", self.num_fixed)
        self.num_fixed += 1
        return c

    def instance_column(self) -> Column:
        c = Column("instance", self.num_instance)
        self.num_instance += 1
        return c

    def selector(self) -> Column:
        """A selector is just a boolean fixed column here."""
        return self.fixed_column()

    # -- queries ------------------------------------------------------------
    def _register(self, q) -> None:
        key = (type(q).__name__, q.column_index, q.rotation)
        if key in self._query_set:
            return
        self._query_set.add(key)
        if isinstance(q, AdviceQuery):
            self.advice_queries.append((q.column_index, q.rotation))
        elif isinstance(q, FixedQuery):
            self.fixed_queries.append((q.column_index, q.rotation))
        elif isinstance(q, InstanceQuery):
            if q.rotation != 0:
                # The PSE verifier contract evaluates instance columns only
                # at rotation 0 (contract.sol:370-435); reject at configure
                # time instead of failing later in verify (VERDICT r1 weak #4).
                raise NotImplementedError(
                    "instance queries at nonzero rotation are unsupported")
            self.instance_queries.append((q.column_index, q.rotation))

    def query(self, col: Column, rotation: int = 0) -> Expr:
        if col.kind == "advice":
            q = AdviceQuery(col.index, rotation)
        elif col.kind == "fixed":
            q = FixedQuery(col.index, rotation)
        else:
            q = InstanceQuery(col.index, rotation)
        self._register(q)
        return q

    query_advice = query
    query_fixed = query
    query_instance = query
    query_selector = query

    # -- constraints --------------------------------------------------------
    def enable_equality(self, col: Column) -> None:
        if col not in self.permutation_columns:
            self.permutation_columns.append(col)
            self.query(col, 0)

    def create_gate(self, name: str, polys) -> None:
        if isinstance(polys, Expr):
            polys = [polys]
        for p in polys:
            qs: set = set()
            collect_queries(p, qs)
            # register in deterministic order
            for q in sorted(qs, key=lambda q: (type(q).__name__, q.column_index, q.rotation)):
                self._register(q)
        self.gates.append(Gate(name, list(polys)))

    def lookup(self, name: str, pairs, max_bits: int | None = None) -> None:
        for inp, tab in pairs:
            for e in (inp, tab):
                qs: set = set()
                collect_queries(e, qs)
                for q in sorted(qs, key=lambda q: (type(q).__name__, q.column_index, q.rotation)):
                    self._register(q)
        if max_bits is not None:
            assert len(pairs) == 1, "max_bits only for single-pair lookups"
        self.lookups.append(Lookup(name, list(pairs), max_bits))

    # -- derived parameters (mirror halo2 ConstraintSystem) ------------------
    def gate_degree(self) -> int:
        d = 0
        for g in self.gates:
            for p in g.polys:
                d = max(d, p.degree())
        return d

    def lookup_required_degree(self) -> int:
        d = 0
        for lk in self.lookups:
            inp_deg = max((max(i.degree() for i, _ in lk.pairs)), 1)
            tab_deg = max((max(t.degree() for _, t in lk.pairs)), 1)
            # product rule: z(wx) * (a'+beta) * (s'+gamma) gated by active rows
            # vs z(x) * (compressed_input+beta) * (compressed_table+gamma)
            d = max(d, 2 + inp_deg + tab_deg)
        return d

    def degree(self) -> int:
        # permutation argument needs degree >= 3 (chunk of 1 column)
        return max(3, self.gate_degree(), self.lookup_required_degree())

    def permutation_chunk_len(self) -> int:
        return self.degree() - 2

    def num_permutation_chunks(self) -> int:
        c = self.permutation_chunk_len()
        return (len(self.permutation_columns) + c - 1) // c

    def blinding_factors(self) -> int:
        # max times any single advice column is queried
        per_col: dict[int, int] = {}
        for ci, _ in self.advice_queries:
            per_col[ci] = per_col.get(ci, 0) + 1
        factors = max(per_col.values(), default=1)
        factors = max(3, factors)
        factors += 1  # multiopen opening at an additional point
        factors += 1  # off-by-one defense (halo2 convention) -> rotation -6
        return factors

    def usable_rows(self, n: int) -> int:
        return n - (self.blinding_factors() + 1)

    def min_rows(self) -> int:
        return self.blinding_factors() + 3


class Assignment:
    """Dense column matrices over Fr as python ints (numpy object arrays).

    recording=False is the PROOF-TIME mode: copies, q-selector and fixed
    values are already baked into the proving key (permutation mapping +
    packed fixed columns), so per-proof synthesis only needs the advice
    values — chips skip all copy bookkeeping (a measurable slice of the
    witness-generation hot loop)."""

    def __init__(self, cs: ConstraintSystem, n: int, recording: bool = True):
        self.cs = cs
        self.n = n
        self.recording = recording
        self.advice = [np.zeros(n, dtype=object) for _ in range(cs.num_advice)]
        self.fixed = [np.zeros(n, dtype=object) for _ in range(cs.num_fixed)]
        self.instance = [np.zeros(n, dtype=object) for _ in range(cs.num_instance)]
        self.copies: list[tuple[tuple[Column, int], tuple[Column, int]]] = []
        self.usable = cs.usable_rows(n)
        # permutation membership as a set: copy() is called O(cells) times
        # and a list scan over hundreds of columns dominates synthesis
        self._perm_set = frozenset(cs.permutation_columns)

    def assign(self, col: Column, row: int, value: int) -> None:
        assert 0 <= row < self.usable, f"row {row} outside usable region [0,{self.usable})"
        arr = getattr(self, col.kind)
        arr[col.index][row] = value % R

    def assign_advice(self, col, row, value):
        self.assign(col, row, value)

    def assign_fixed(self, col, row, value):
        self.assign(col, row, value)

    def enable_selector(self, col: Column, row: int) -> None:
        assert col.kind == "fixed"
        self.assign(col, row, 1)

    def copy(self, a: tuple[Column, int], b: tuple[Column, int]) -> None:
        if not self.recording:
            return
        for col, _row in (a, b):
            assert col in self._perm_set, f"{col} lacks enable_equality"
        self.copies.append((a, b))

    def column_values(self, col: Column) -> np.ndarray:
        return getattr(self, col.kind)[col.index]


class Circuit:
    """Base class: subclasses define configure(cs) -> config and
    synthesize(config, assignment)."""

    def configure(self, cs: ConstraintSystem):
        raise NotImplementedError

    def synthesize(self, config, assignment: Assignment) -> None:
        raise NotImplementedError

    def instances(self) -> list[list[int]]:
        """Public input columns."""
        return []
