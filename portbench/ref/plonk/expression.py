"""Polynomial expression IR for PLONKish gates.

The TPU-first stance (SURVEY.md §7): circuits are fixed, ahead-of-time IR —
no Layouter/Region double-pass machinery.  Gates are small expression trees
over column queries; the prover compiles them into vectorized JAX ops over
the extended evaluation domain, the verifier evaluates them at a point.

Mirrors the role of halo2's `Expression` (used by the reference at e.g.
anon-aadhaar-halo2/src/signal.rs:36-42).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable


class Expr:
    def __add__(self, other):
        return Sum(self, _coerce(other))

    def __radd__(self, other):
        return Sum(_coerce(other), self)

    def __sub__(self, other):
        return Sum(self, Neg(_coerce(other)))

    def __rsub__(self, other):
        return Sum(_coerce(other), Neg(self))

    def __mul__(self, other):
        return Product(self, _coerce(other))

    def __rmul__(self, other):
        return Product(_coerce(other), self)

    def __neg__(self):
        return Neg(self)

    def degree(self) -> int:
        raise NotImplementedError

    def evaluate(
        self,
        constant: Callable[[int], Any],
        fixed: Callable[["FixedQuery"], Any],
        advice: Callable[["AdviceQuery"], Any],
        instance: Callable[["InstanceQuery"], Any],
        negate: Callable[[Any], Any],
        add: Callable[[Any, Any], Any],
        mul: Callable[[Any, Any], Any],
    ) -> Any:
        """Generic fold; the single evaluation mechanism shared by the mock
        prover (rows), the real prover (extended-domain vectors) and the
        verifier (point evals)."""
        raise NotImplementedError


def _coerce(x) -> "Expr":
    if isinstance(x, Expr):
        return x
    if isinstance(x, int):
        return Constant(x)
    raise TypeError(f"cannot coerce {type(x)} to Expr")


@dataclass(frozen=True)
class Constant(Expr):
    value: int

    def degree(self):
        return 0

    def evaluate(self, constant, fixed, advice, instance, negate, add, mul):
        return constant(self.value)


@dataclass(frozen=True)
class FixedQuery(Expr):
    column_index: int
    rotation: int

    def degree(self):
        return 1

    def evaluate(self, constant, fixed, advice, instance, negate, add, mul):
        return fixed(self)


@dataclass(frozen=True)
class AdviceQuery(Expr):
    column_index: int
    rotation: int

    def degree(self):
        return 1

    def evaluate(self, constant, fixed, advice, instance, negate, add, mul):
        return advice(self)


@dataclass(frozen=True)
class InstanceQuery(Expr):
    column_index: int
    rotation: int

    def degree(self):
        return 1

    def evaluate(self, constant, fixed, advice, instance, negate, add, mul):
        return instance(self)


@dataclass(frozen=True)
class Neg(Expr):
    expr: Expr

    def degree(self):
        return self.expr.degree()

    def evaluate(self, constant, fixed, advice, instance, negate, add, mul):
        return negate(self.expr.evaluate(constant, fixed, advice, instance, negate, add, mul))


@dataclass(frozen=True)
class Sum(Expr):
    lhs: Expr
    rhs: Expr

    def degree(self):
        return max(self.lhs.degree(), self.rhs.degree())

    def evaluate(self, constant, fixed, advice, instance, negate, add, mul):
        a = self.lhs.evaluate(constant, fixed, advice, instance, negate, add, mul)
        b = self.rhs.evaluate(constant, fixed, advice, instance, negate, add, mul)
        return add(a, b)


@dataclass(frozen=True)
class Product(Expr):
    lhs: Expr
    rhs: Expr

    def degree(self):
        return self.lhs.degree() + self.rhs.degree()

    def evaluate(self, constant, fixed, advice, instance, negate, add, mul):
        a = self.lhs.evaluate(constant, fixed, advice, instance, negate, add, mul)
        b = self.rhs.evaluate(constant, fixed, advice, instance, negate, add, mul)
        return mul(a, b)


def collect_queries(expr: Expr, out: set) -> None:
    if isinstance(expr, (FixedQuery, AdviceQuery, InstanceQuery)):
        out.add(expr)
    elif isinstance(expr, Neg):
        collect_queries(expr.expr, out)
    elif isinstance(expr, (Sum, Product)):
        collect_queries(expr.lhs, out)
        collect_queries(expr.rhs, out)
