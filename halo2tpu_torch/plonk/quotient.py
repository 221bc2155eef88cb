"""Part-wise quotient evaluation on torch tensors.  Port of the vectorized
path of halo2tpu/plonk/quotient.py.

The extended coset splits into step = extended_n / n interleaved cosets
("parts") of the order-n subgroup; rotations never cross parts and Z_H is
constant on each, so the quotient is evaluated part by part with an n-sized
working set.

Everything a part computes (every gate poly, the permutation and lookup
rules, the lookups' theta-compressions, the y-fold and the 1 / Z_H scale) is
compiled once per proving key into one field program (`part_program`,
cached on the prover's _PkState) and runs as one field_prog launch a part
(ops/field_prog.py).  A proof re-encodes only the program's constants.
Field ops on canonical values are exact, so the Horner y-fold gives the
bits of halo2tpu's weighted reduction.  The prover's n-domain lookup
compression (TorchEngine.compress_exprs) compiles its expressions the same
way, one program a compression.  `_val_fn_for` evaluates an expression one
field op a launch (torch callables cached by structure): the per-op route
that chip_smoke.py holds the field_prog kernel against.

Fold order (gates, then permutation rules, then per-lookup rules) is pinned
by the verifier's y-Horner and must match halo2tpu/plonk/verifier.py.
"""
from __future__ import annotations

import numpy as np
import torch

from ..fields.bn254 import R, FR_DELTA
from .expression import (AdviceQuery, Constant, FixedQuery, InstanceQuery,
                         Neg, Product, Sum)
from ..fields import jfield
from ..fields.jfield import FR
from ..ops.field_prog import (ADD, CONST, HORNER, LOAD, MUL, NEG, OUT, S_MAX,
                              SQR, SUB, Program, groups_for)


# ---------------------------------------------------------------------------
# structural expression compiler

_FOLD_FNS: dict[str, object] = {}


def _walk(e, leaves, toks):
    if isinstance(e, Constant):
        leaves.append(("const", e.value))
        toks.append("c")
    elif isinstance(e, AdviceQuery):
        leaves.append(("advice", e.column_index))
        toks.append(f"a{e.rotation};")
    elif isinstance(e, FixedQuery):
        leaves.append(("fixed", e.column_index))
        toks.append(f"f{e.rotation};")
    elif isinstance(e, InstanceQuery):
        leaves.append(("instance", e.column_index))
        toks.append(f"i{e.rotation};")
    elif isinstance(e, Neg):
        toks.append("n(")
        _walk(e.expr, leaves, toks)
        toks.append(")")
    elif isinstance(e, Sum):
        toks.append("s(")
        _walk(e.lhs, leaves, toks)
        toks.append(",")
        _walk(e.rhs, leaves, toks)
        toks.append(")")
    elif isinstance(e, Product):
        toks.append("p(")
        _walk(e.lhs, leaves, toks)
        toks.append(",")
        _walk(e.rhs, leaves, toks)
        toks.append(")")
    else:  # pragma: no cover
        raise TypeError(f"unknown expr node {type(e)}")


def _make_val_fn(expr):
    """Build fn(*leaf_tensors) -> expression value.  Expressions with the
    same structure token evaluate identically from their own leaves, so
    the fn built from the first instance serves all of them."""

    def f(*args):
        it = iter(args)
        shape = next(a.shape for a in args if a.dim() == 2)

        def ev(e):
            if isinstance(e, Constant):
                return next(it).expand(shape)
            if isinstance(e, (AdviceQuery, FixedQuery, InstanceQuery)):
                a = next(it)
                r = e.rotation % a.shape[0]
                return torch.roll(a, -r, 0) if r else a
            if isinstance(e, Neg):
                return jfield.neg(FR, ev(e.expr))
            if isinstance(e, Sum):
                return jfield.add(FR, ev(e.lhs), ev(e.rhs))
            return jfield.mont_mul(FR, ev(e.lhs), ev(e.rhs))

        return ev(expr)

    return f


def _val_fn_for(expr):
    leaves: list = []
    toks: list = []
    _walk(expr, leaves, toks)
    key = "".join(toks)
    fn = _FOLD_FNS.get(key)
    if fn is None:
        fn = _make_val_fn(expr)
        _FOLD_FNS[key] = fn
    return fn, leaves


# ---------------------------------------------------------------------------
# the part program compiler
#
# A part's values are trees of tuples: ("load", leaf_key, rot),
# ("const", const_key), ("neg", x), ("add" | "sub" | "mul", x, y) and
# ("horner", x, y, const_key) = x * c + y.  Leaf keys name the part's
# vectors: ("advice" | "fixed" | "instance" | "sigma" | "z", index),
# ("lookup", i, 0 | 1 | 2) for lookup i's z, A' and S', ("l0",),
# ("l_last",), ("l_active",) and ("wq",) (c_q * omega^i).  Constant keys:
# ("value", v), the challenges ("beta",), ("gamma",), ("theta",), ("y",),
# ("bd", j) = beta * delta^j, ("zh_inv",), the part's 1 / Z_H, and
# ("pow", key, e), constant key to the power e (the sub-programs' combine).

def _ld(*key, rot: int = 0):
    return ("load", key, rot)


def _cst(*key):
    return ("const", key)


def _add(x, y):
    return ("add", x, y)


def _sub(x, y):
    return ("sub", x, y)


def _mul(x, y):
    return ("mul", x, y)


def expr_ir(e):
    """A gate expression (plonk/expression.py) as a value tree."""
    if isinstance(e, Constant):
        return _cst("value", e.value % R)
    if isinstance(e, AdviceQuery):
        return _ld("advice", e.column_index, rot=e.rotation)
    if isinstance(e, FixedQuery):
        return _ld("fixed", e.column_index, rot=e.rotation)
    if isinstance(e, InstanceQuery):
        return _ld("instance", e.column_index, rot=e.rotation)
    if isinstance(e, Neg):
        return ("neg", expr_ir(e.expr))
    if isinstance(e, Sum):
        return _add(expr_ir(e.lhs), expr_ir(e.rhs))
    if isinstance(e, Product):
        return _mul(expr_ir(e.lhs), expr_ir(e.rhs))
    raise TypeError(f"unknown expr node {type(e)}")


def _horner(values, key):
    """sum_i c^(k-1-i) v_i as a left-deep Horner tree."""
    acc = values[0]
    for v in values[1:]:
        acc = ("horner", acc, v, key)
    return acc


class _Emitter:
    """Sethi-Ullman code generation: each binary node evaluates its deeper
    operand first, so a tree of label l (a leaf 1; a node the larger of
    its operands' labels, or one more when they are equal) takes l slots.
    One emitter a sub-program; `leaves` and `consts` (key -> index) are
    shared by the sub-programs of one program."""

    def __init__(self, n: int, leaves: dict, consts: dict, labels: dict):
        self.n = n
        self.code: list = []
        self.leaves = leaves
        self.consts = consts
        self.free: list = []
        self.slots = 0
        self._labels = labels

    def leaf(self, key) -> int:
        return self.leaves.setdefault(key, len(self.leaves))

    def const(self, key) -> int:
        return self.consts.setdefault(key, len(self.consts))

    def alloc(self) -> int:
        if self.free:
            s = min(self.free)
            self.free.remove(s)
            return s
        if self.slots == S_MAX:
            raise ValueError(f"field program needs more than {S_MAX} slots")
        self.slots += 1
        return self.slots - 1

    def label(self, node) -> int:
        got = self._labels.get(id(node))
        if got is None:
            kind = node[0]
            if kind in ("load", "const"):
                got = 1
            elif kind == "neg":
                got = self.label(node[1])
            else:
                a, b = self.label(node[1]), self.label(node[2])
                got = a + 1 if a == b else max(a, b)
            self._labels[id(node)] = got
        return got

    def emit(self, node) -> int:
        """Code for node into a fresh slot; returns the slot."""
        kind = node[0]
        if kind == "load":
            s = self.alloc()
            self.code.append((LOAD, s, self.leaf(node[1]), node[2] % self.n))
            return s
        if kind == "const":
            s = self.alloc()
            self.code.append((CONST, s, self.const(node[1]), 0))
            return s
        if kind == "neg":
            s = self.emit(node[1])
            self.code.append((NEG, s, s, 0))
            return s
        x, y = node[1], node[2]
        if kind == "mul" and x == y:
            s = self.emit(x)
            self.code.append((SQR, s, s, 0))
            return s
        if self.label(y) > self.label(x):
            sy = self.emit(y)
            sx = self.emit(x)
        else:
            sx = self.emit(x)
            sy = self.emit(y)
        if kind == "horner":
            self.code.append((HORNER, sx, sy, self.const(node[3])))
        else:
            op = {"add": ADD, "sub": SUB, "mul": MUL}[kind]
            self.code.append((op, sx, sx, sy))
        self.free.append(sy)
        return sx


# the cost of an instruction in the balance of sub-programs: a Montgomery
# product (MUL, SQR, HORNER) takes about six times an add's time
PRODUCT_COST = 6


def _cost(node, memo: dict) -> int:
    """Instruction cost of emitting node (shared subtrees are emitted at
    each use, and counted so)."""
    got = memo.get(id(node))
    if got is None:
        kind = node[0]
        if kind in ("load", "const"):
            got = 1
        elif kind == "neg":
            got = 1 + _cost(node[1], memo)
        elif kind == "mul" and node[1] == node[2]:
            got = PRODUCT_COST + _cost(node[1], memo)
        else:
            got = ((PRODUCT_COST if kind in ("mul", "horner") else 1)
                   + _cost(node[1], memo) + _cost(node[2], memo))
        memo[id(node)] = got
    return got


def split_values(costs: list, groups: int) -> list:
    """Cut len(costs) values into `groups` contiguous non-empty runs of
    about equal cost (each value after a run's first also costs a HORNER):
    returns the groups + 1 boundaries."""
    m = len(costs)
    groups = max(1, min(groups, m))
    pre = [0]
    for i, c in enumerate(costs):
        pre.append(pre[-1] + c + (PRODUCT_COST if i else 0))
    cuts = [0]
    for g in range(1, groups):
        target = pre[m] * g / groups
        lo, hi = cuts[-1] + 1, m - (groups - g)
        cuts.append(min(range(lo, hi + 1), key=lambda c: abs(pre[c] - target)))
    return cuts + [m]


def compile_program(values, n: int, fold=None, scale=None,
                    groups: int = 1, name: str = "program") -> Program:
    """One program over n rows: the value of one tree or, with `fold` (a
    constant key c), sum_i c^(N-1-i) v_i, split into at most `groups`
    sub-programs: split_values cuts the values into runs, each folded by
    Horner into its own accumulator as the values are computed (an
    accumulator slot and one more for each value); the combine multiplies
    run g's result by c^(values after run g), the constant ("pow", c, e),
    none for the last run, and the sum by the constant `scale` if given.
    Raises ValueError past S_MAX slots in any sub-program."""
    if fold is None and len(values) != 1:
        raise ValueError("several values need a fold constant")
    values = list(values) or [_cst("value", 0)]
    memo: dict = {}
    cuts = split_values([_cost(v, memo) for v in values], groups)
    leaves: dict = {}
    consts: dict = {}
    labels: dict = {}
    code, starts, comb, slots = [], [0], [], 0
    for lo, hi in zip(cuts, cuts[1:]):
        em = _Emitter(n, leaves, consts, labels)
        acc = em.emit(values[lo])
        for v in values[lo + 1:hi]:
            s = em.emit(v)
            em.code.append((HORNER, acc, s, em.const(fold)))
            em.free.append(s)
        em.code.append((OUT, 0, acc, 0))
        code += em.code
        starts.append(len(code))
        slots = max(slots, em.slots)
        after = len(values) - hi
        comb.append(em.const(("pow", fold, after)) if after else -1)
    sc = -1 if scale is None else consts.setdefault(scale, len(consts))
    return Program(np.asarray(code, dtype=np.int32).reshape(-1, 4), starts,
                   comb, sc, slots, list(leaves), list(consts), name=name)


def _perm_layout(cs):
    chunk_len = cs.permutation_chunk_len()
    cols = cs.permutation_columns
    return [cols[i:i + chunk_len] for i in range(0, len(cols), chunk_len)]


def part_values(cs, n: int) -> list:
    """Every value a quotient part folds, as trees, in the protocol fold
    order the verifier's y-Horner pins (halo2tpu/plonk/verifier.py): each
    gate poly; the permutation rules l0 (1 - z_0), l_last (z_last^2 -
    z_last), each chunk link l0 (z_j - z_{j-1}(omega^-(b+1) X)) and each
    chunk's (z(omega X) prod(c + beta sigma + gamma) - z(X) prod(c +
    beta delta^g c_q omega^i + gamma)) l_active; then each lookup's five
    rules over its theta-compressed input and table."""
    values = [expr_ir(poly) for gate in cs.gates for poly in gate.polys]
    l0, l_last, l_active = _ld("l0"), _ld("l_last"), _ld("l_active")
    one = _cst("value", 1)
    beta, gamma = _cst("beta"), _cst("gamma")
    chunks = _perm_layout(cs)
    if chunks:
        b = cs.blinding_factors()
        perm_cols = cs.permutation_columns
        last = len(chunks) - 1
        values.append(_mul(l0, _sub(one, _ld("z", 0))))
        values.append(_mul(l_last, _sub(_mul(_ld("z", last), _ld("z", last)),
                                        _ld("z", last))))
        for j in range(1, len(chunks)):
            values.append(_mul(l0, _sub(_ld("z", j),
                                        _ld("z", j - 1, rot=-(b + 1)))))
        gidx = 0
        for j, chunk in enumerate(chunks):
            lhs, rhs = _ld("z", j, rot=1), _ld("z", j)
            for i, c in enumerate(chunk):
                col = _ld(c.kind, c.index)
                sigma = _ld("sigma", perm_cols.index(c))
                lhs = _mul(lhs, _add(_add(col, _mul(sigma, beta)), gamma))
                idp = _mul(_ld("wq"), _cst("bd", gidx + i))
                rhs = _mul(rhs, _add(_add(col, idp), gamma))
            values.append(_mul(_sub(lhs, rhs), l_active))
            gidx += len(chunk)
    for li, lk in enumerate(cs.lookups):
        comp_in = _horner([expr_ir(p[0]) for p in lk.pairs], ("theta",))
        comp_tb = _horner([expr_ir(p[1]) for p in lk.pairs], ("theta",))
        z, a, s = (_ld("lookup", li, k) for k in range(3))
        lhs = _mul(_ld("lookup", li, 0, rot=1), _mul(_add(a, beta),
                                                     _add(s, gamma)))
        rhs = _mul(z, _mul(_add(comp_in, beta), _add(comp_tb, gamma)))
        a_minus_s = _sub(a, s)
        values.extend([
            _mul(l0, _sub(one, z)),
            _mul(l_last, _sub(_mul(z, z), z)),
            _mul(_sub(lhs, rhs), l_active),
            _mul(l0, a_minus_s),
            _mul(_mul(a_minus_s, _sub(a, _ld("lookup", li, 1, rot=-1))),
                 l_active)])
    return values


def part_program(cs, n: int, groups: int | None = None) -> Program:
    """A quotient part as one program: hv / Z_H, with hv = sum_i y^(N-1-i)
    v_i over part_values (equal to the verifier's Horner y-fold), in
    `groups` sub-programs (default ops/field_prog.py::groups_for(n))."""
    return compile_program(part_values(cs, n), n, fold=("y",),
                           scale=("zh_inv",),
                           groups=groups_for(n) if groups is None else groups,
                           name="part")


def const_value(key, ch: dict, zh_inv: int) -> int:
    """The value of a program constant for challenges ch and a part's
    1 / Z_H."""
    kind = key[0]
    if kind == "value":
        return key[1]
    if kind == "pow":
        return pow(const_value(key[1], ch, zh_inv), key[2], R)
    if kind == "bd":
        return ch["beta"] * pow(FR_DELTA, key[1], R) % R
    if kind == "zh_inv":
        return zh_inv
    return ch[kind]


# ---------------------------------------------------------------------------
# part-wise fold

def fold_quotient(eng, cs, d, st, srcs, ch):
    """Evaluate the folded quotient numerator part by part and return the
    h coefficient chunks.

    st:   prover._PkState (part l0/l_last/l_active and wq, zh_inv,
          fixed/sigma coefficient polys, the cached part program)
    srcs: dict with advice_polys, instance_polys, z_polys,
          lookup_polys = [(z, a, s)] per lookup
    ch:   dict with theta, beta, gamma, y (python ints)
    """
    if st.quotient_program is None:
        st.quotient_program = part_program(cs, d.n)
    step = d.extended_n // d.n
    parts = [_fold_part(eng, st, srcs, ch, q, st.quotient_program)
             for q in range(step)]
    return eng.parts_to_h_chunks(parts, d.quotient_poly_degree)


def _fold_part(eng, st, srcs, ch, q, prog):
    """Part q's hv / Z_H: the part's vectors (one coeff_to_part_stack call
    over every advice, instance, z and lookup poly), then one field_prog
    launch.  A proof only re-encodes the constants (one _encode call)."""
    groups = [srcs["advice_polys"], srcs["instance_polys"], srcs["z_polys"],
              *(list(polys) for polys in srcs["lookup_polys"])]
    vals = eng.coeff_to_part_stack([p for grp in groups for p in grp], q)
    split, i = [], 0
    for grp in groups:
        split.append(vals[i:i + len(grp)])
        i += len(grp)
    tables = {
        "advice": split[0],
        "fixed": st.fixed_parts(eng, q),
        "sigma": st.sigma_parts(eng, q),
        "instance": split[1],
        "z": split[2],
        "lookup": split[3:],
    }
    named = dict(zip(("l0", "l_last", "l_active"), st.part_l[q]),
                 wq=st.part_wq[q])

    def leaf(key):
        if key[0] == "lookup":
            return tables["lookup"][key[1]][key[2]]
        return tables[key[0]][key[1]] if len(key) > 1 else named[key[0]]

    consts = eng._encode([const_value(k, ch, st.zh_inv[q])
                          for k in prog.const_keys])
    return eng.run_program(prog, [leaf(k) for k in prog.leaf_keys], consts)


