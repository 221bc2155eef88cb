"""Part-wise quotient evaluation on torch tensors.  Port of the vectorized
path of halo2tpu/plonk/quotient.py.

The extended coset splits into step = extended_n / n interleaved cosets
("parts") of the order-n subgroup; rotations never cross parts and Z_H is
constant on each, so the quotient is evaluated part by part with an n-sized
working set.  Gate expressions are compiled into torch callables, cached by
structure (leaf kinds, rotations and op tree), so structurally identical
gates share one callable; constants enter as (8,) scalar tensors.

Fold order (gates, then permutation rules, then per-lookup rules) is pinned
by the verifier's y-Horner and must match halo2tpu/plonk/verifier.py.
"""
from __future__ import annotations

import torch

from ..fields.bn254 import R, FR_DELTA
from . import polyops
from .expression import (AdviceQuery, Constant, FixedQuery, InstanceQuery,
                         Neg, Product, Sum)
from ..fields import jfield
from ..fields.jfield import FR


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


# rule values (each returns its expression VALUE; the y-fold happens
# afterwards as one weighted reduction) -------------------------------------

def _val_l0_one_minus_z(l0, z):
    return jfield.mont_mul(FR, l0, jfield.sub(FR, jfield.one_like(FR, z), z))


def _val_llast_zz(l_last, z):
    return jfield.mont_mul(FR, l_last,
                           jfield.sub(FR, jfield.mont_mul(FR, z, z), z))


def _val_l0_z_minus_prev(l0, z, z_prev, rot):
    prev = torch.roll(z_prev, -(rot % z_prev.shape[0]), 0)
    return jfield.mont_mul(FR, l0, jfield.sub(FR, z, prev))


def _val_perm_product(z, l_active, cvals, sigmas, bds, beta, gamma, wq):
    """Permutation chunk product rule value:
      (z(wX) prod(c + beta*sigma + gamma) - z(X) prod(c + beta*delta_j*wq
       + gamma)) * l_active.  cvals/sigmas: (m, n, 8); bds: (m, 8)."""
    lhs, rhs = torch.roll(z, -1, 0), z
    for j in range(cvals.shape[0]):
        c = cvals[j]
        t1 = jfield.add(FR, c, jfield.mont_mul(FR, sigmas[j], beta))
        lhs = jfield.mont_mul(FR, lhs, jfield.add(FR, t1, gamma))
        t2 = jfield.add(FR, c, jfield.mont_mul(FR, wq, bds[j]))
        rhs = jfield.mont_mul(FR, rhs, jfield.add(FR, t2, gamma))
    return jfield.mont_mul(FR, jfield.sub(FR, lhs, rhs), l_active)


def _val_lookup_rules(zc, ac, sc, comp_in, comp_tb, l0, l_last, l_active,
                      beta, gamma):
    """The five halo2 lookup-argument expression values, protocol order:
      l0(1-z); l_last(z^2-z);
      (z(wX)(a'+beta)(s'+gamma) - z(X)(A+beta)(S+gamma)) l_active;
      l0(a'-s'); (a'-s')(a'-a'(w^-1 X)) l_active."""
    v1 = _val_l0_one_minus_z(l0, zc)
    v2 = _val_llast_zz(l_last, zc)
    z_next = torch.roll(zc, -1, 0)
    a_prev = torch.roll(ac, 1, 0)
    lhs = jfield.mont_mul(FR, z_next, jfield.mont_mul(
        FR, jfield.add(FR, ac, beta), jfield.add(FR, sc, gamma)))
    rhs = jfield.mont_mul(FR, zc, jfield.mont_mul(
        FR, jfield.add(FR, comp_in, beta), jfield.add(FR, comp_tb, gamma)))
    v3 = jfield.mont_mul(FR, jfield.sub(FR, lhs, rhs), l_active)
    a_minus_s = jfield.sub(FR, ac, sc)
    v4 = jfield.mont_mul(FR, l0, a_minus_s)
    v5 = jfield.mont_mul(FR, jfield.mont_mul(
        FR, a_minus_s, jfield.sub(FR, ac, a_prev)), l_active)
    return v1, v2, v3, v4, v5


def _compress(eng, exprs, leaf_value, theta):
    """theta-compression sum_i theta^(k-1-i) e_i."""
    vals = []
    for e in exprs:
        fn, leaves = _val_fn_for(e)
        vals.append(fn(*[leaf_value(kind, v) for kind, v in leaves]))
    if len(vals) == 1:
        return vals[0]
    k = len(vals)
    return eng.weighted_sum(vals, [pow(theta, k - 1 - i, R)
                                   for i in range(k)])


def compress_exprs(eng, exprs, col_vals, theta):
    """theta-compression over any column family (the prover's n-domain
    lookup compression)."""
    return _compress(
        eng, exprs, lambda kind, v: eng._enc_scalar(v) if kind == "const"
        else col_vals[kind][v], theta)


# ---------------------------------------------------------------------------
# part-wise fold

def fold_quotient(eng, cs, d, st, srcs, ch):
    """Evaluate the folded quotient numerator part by part and return the
    h coefficient chunks.

    st:   prover._PkState (part l0/l_last/l_active, zh_inv, omega_pows,
          fixed/sigma coefficient polys)
    srcs: dict with advice_polys, instance_polys, z_polys,
          lookup_polys = [(z, a, s)] per lookup
    ch:   dict with theta, beta, gamma, y (python ints)
    """
    step = d.extended_n // d.n
    parts = []
    for q in range(step):
        hv = _fold_part(eng, cs, d, st, srcs, ch, q)
        parts.append(eng.scale(hv, st.zh_inv[q]))
    return eng.parts_to_h_chunks(parts, d.quotient_poly_degree)


def _perm_layout(cs):
    chunk_len = cs.permutation_chunk_len()
    cols = cs.permutation_columns
    return [cols[i:i + chunk_len] for i in range(0, len(cols), chunk_len)]


def _fold_part(eng, cs, d, st, srcs, ch, q):
    """Every contribution's value on part q, then hv = sum_i y^(N-1-i) v_i
    as chunked weighted reductions (the verifier's Horner y-fold)."""
    n = d.n
    b = cs.blinding_factors()
    adv = eng.coeff_to_part_stack(srcs["advice_polys"], q)
    fix = st.fixed_parts(eng, q)     # witness-independent: cached on state
    sig = st.sigma_parts(eng, q)
    inst = eng.coeff_to_part_stack(srcs["instance_polys"], q)
    zs = eng.coeff_to_part_stack(srcs["z_polys"], q)
    lk_parts = [tuple(eng.coeff_to_part_stack(list(polys), q))
                for polys in srcs["lookup_polys"]]
    l0, l_last, l_active = st.part_l[q]
    wq = eng.scale(st.omega_pows, polyops.part_shift(d, q))

    col_vals = {"advice": adv, "fixed": fix, "instance": inst}
    theta = ch["theta"]
    beta_e = eng._enc_scalar(ch["beta"])
    gamma_e = eng._enc_scalar(ch["gamma"])

    def leaf_value(kind, v):
        return eng._enc_scalar(v) if kind == "const" else col_vals[kind][v]

    values = []   # protocol fold order (gates, permutation, lookups)
    for gate in cs.gates:
        for poly in gate.polys:
            fn, leaves = _val_fn_for(poly)
            values.append(fn(*[leaf_value(kind, v) for kind, v in leaves]))

    chunks = _perm_layout(cs)
    if chunks:
        perm_cols = cs.permutation_columns
        deltas = [pow(FR_DELTA, j, R) for j in range(len(perm_cols))]
        values.append(_val_l0_one_minus_z(l0, zs[0]))
        values.append(_val_llast_zz(l_last, zs[-1]))
        for j in range(1, len(chunks)):
            values.append(_val_l0_z_minus_prev(l0, zs[j], zs[j - 1],
                                               (-(b + 1)) % n))
        gidx = 0
        for j, chunk in enumerate(chunks):
            cvals = torch.stack([col_vals[c.kind][c.index] for c in chunk])
            sigmas = torch.stack([sig[perm_cols.index(c)] for c in chunk])
            bds = torch.stack([eng._enc_scalar(ch["beta"] * deltas[gidx + i]
                                               % R)
                               for i in range(len(chunk))])
            values.append(_val_perm_product(zs[j], l_active, cvals, sigmas,
                                            bds, beta_e, gamma_e, wq))
            gidx += len(chunk)

    for lk, (zc, ac, sc) in zip(cs.lookups, lk_parts):
        comp_in = _compress(eng, [p[0] for p in lk.pairs], leaf_value, theta)
        comp_tb = _compress(eng, [p[1] for p in lk.pairs], leaf_value, theta)
        values.extend(_val_lookup_rules(zc, ac, sc, comp_in, comp_tb,
                                        l0, l_last, l_active, beta_e,
                                        gamma_e))

    if not values:   # constraint-free circuit (reference timestamp quirk)
        return eng.const_vec(0, n).contiguous()
    N = len(values)
    y = ch["y"]
    return eng.weighted_sum(values, [pow(y, N - 1 - i, R) for i in range(N)])
