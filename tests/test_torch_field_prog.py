"""The quotient's part-program compiler (halo2tpu_torch/plonk/quotient.py)
and the field-program interpreter (ops/field_prog.py::field_prog_plain)
against halo2tpu.

Every gate-poly structure of the RSA-SHA256 circuit and the golden
circuits (Square, Timestamp, RangeHarness, Identity, Nullifier and the QR
extractor harness; configure only), compiled into a program and
interpreted at n = 64, gives exactly halo2tpu's `quotient._val_fn_for`
value on JAX CPU for the same leaves; a program folding several values by
Horner gives the port engine's weighted_sum; slot counts stay within S_MAX
(halo2tpu's composite Aadhaar gates included) and a program past it
raises.  Whole part programs (the composite's among them) equal
halo2tpu's per-op route (the steps of its quotient._fold_part_jnp on JAX
CPU), and run in every proof of the byte-parity slice tests
(tests/test_torch_slice_*.py, test_torch_golden.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import port_circuits
from halo2tpu.circuits.aadhaar_qr import (AadhaarParams,
                                          AadhaarQRVerifierCircuit)
from halo2tpu.circuits.rsa_sha256 import RSASha256Circuit as JaxRSACircuit
from halo2tpu.fields import jfield as jjf
from halo2tpu.fields.jfield import FR as JFR
from halo2tpu.plonk import expression as jexpr
from halo2tpu.plonk import quotient as jquot
from halo2tpu.plonk.circuit import ConstraintSystem as JaxCS
from halo2tpu_torch import convert
from halo2tpu_torch.fields.bn254 import FR_DELTA, R
from halo2tpu_torch.fields.jfield import FR
from halo2tpu_torch.ops import field_prog as fp
from halo2tpu_torch.plonk import expression as texpr
from halo2tpu_torch.plonk import quotient
from halo2tpu_torch.plonk.circuit import ConstraintSystem
from halo2tpu_torch.plonk.domain import make_domain
from halo2tpu_torch.plonk.engine import TorchEngine
from halo2tpu_torch.plonk.srs import setup
from test_torch_golden import jax_golden_circuits

torch.set_num_threads(1)

N = 64


def _configured(circuit, cs_cls):
    cs = cs_cls()
    circuit.configure(cs)
    return cs


def _circuit_pairs():
    """name -> (halo2tpu ConstraintSystem, the port's), configure only."""
    port_c = port_circuits.golden_circuits()
    out = {name: (_configured(_jax_circuit(name), JaxCS),
                  _configured(port_c[name][0], ConstraintSystem))
           for name in port_c}
    out["rsa_sha256"] = (_configured(_jax_circuit("rsa_sha256"), JaxCS),
                         _configured(_circuit("rsa_sha256"), ConstraintSystem))
    return out


def _circuit(name: str):
    """The port's circuit `name`: RSA-SHA256, the composite or a golden
    circuit (port_circuits.py)."""
    return {"composite": port_circuits.composite_circuit,
            "rsa_sha256": port_circuits.rsa_circuit}.get(
        name, lambda: port_circuits.golden_circuits()[name][0])()


def _jax_circuit(name: str):
    """halo2tpu's circuit `name`, at the port's parameters (configure only
    for the composite)."""
    if name == "composite":
        return AadhaarQRVerifierCircuit(None, AadhaarParams(
            signed_len=port_circuits.COMPOSITE_SIGNED_LEN))
    if name == "rsa_sha256":
        rsa = port_circuits.rsa_circuit()
        return JaxRSACircuit(rsa.msg, rsa.n, rsa.sig)
    return jax_golden_circuits()[name][0]


def _wrap_expr(mod):
    """a(-3) * f(5) + 7 - i(-1) * a(2): rotations that wrap at both ends of
    the rows, a constant and every leaf kind."""
    a3 = mod.AdviceQuery(0, -3)
    f5 = mod.FixedQuery(1, 5)
    i1 = mod.InstanceQuery(0, -1)
    a2 = mod.AdviceQuery(2, 2)
    return mod.Sum(mod.Product(a3, f5), mod.Sum(
        mod.Constant(7), mod.Neg(mod.Product(i1, a2))))


def _structures():
    """[(label, halo2tpu expr, port expr)]: the first poly of each
    structure token of every circuit, and the wrapping expression."""
    out = [("wrap", _wrap_expr(jexpr), _wrap_expr(texpr))]
    seen = set()
    for name, (jcs, tcs) in _circuit_pairs().items():
        assert len(jcs.gates) == len(tcs.gates)
        for gj, gt in zip(jcs.gates, tcs.gates):
            for pj, pt in zip(gj.polys, gt.polys):
                toks: list = []
                jquot._walk(pj, [], toks)
                key = "".join(toks)
                if key not in seen:
                    seen.add(key)
                    out.append((f"{name}:{gt.name}:{len(seen)}", pj, pt))
    return out


STRUCTURES = _structures()


class _Leaves:
    """Random Montgomery columns, made on demand, as JAX arrays and as the
    port's tensors (convert.py), and encoded constants."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)
        self.jax: dict = {}
        self.port: dict = {}

    def column(self, key):
        if key not in self.jax:
            vals = [int.from_bytes(self.rng.bytes(32), "big") % R
                    for _ in range(N)]
            self.jax[key] = JFR.encode(vals)
            self.port[key] = convert.from_jax_limbs(np.asarray(self.jax[key]))
        return self.jax[key], self.port[key]

    def jax_leaf(self, kind, v):
        if kind == "const":
            return JFR.encode([v % R])[0]
        return self.column((kind, v))[0]

    def run(self, prog, consts: dict | None = None):
        """prog through field_prog (the CPU interpreter): leaf keys (kind,
        index) are this object's columns, const keys ("value", v) or from
        `consts` (name -> int)."""
        leaves = [self.column(k)[1] for k in prog.leaf_keys]
        ints = [k[1] if k[0] == "value" else consts[k[0]]
                for k in prog.const_keys]
        return fp.field_prog(FR, prog, leaves, FR.encode(ints, "cpu"), N)


def test_structures_cover_the_circuits():
    labels = [s[0] for s in STRUCTURES]
    assert any(lb.startswith("rsa_sha256:") for lb in labels)
    assert any(lb.startswith("range_k7:") for lb in labels)
    assert len(labels) == len(set(labels))


@pytest.mark.parametrize("label,jexp,texp", STRUCTURES,
                         ids=[s[0] for s in STRUCTURES])
def test_gate_program_matches_halo2tpu(label, jexp, texp):
    lv = _Leaves(sum(map(ord, label)))
    fn, leaves = jquot._val_fn_for(jexp)
    want = np.asarray(fn(*[lv.jax_leaf(kind, v) for kind, v in leaves]))
    prog = quotient.compile_program([quotient.expr_ir(texp)], N)
    assert prog.slots <= fp.S_MAX
    got = lv.run(prog)
    assert np.array_equal(convert.to_jax_limbs(got), want), label


def test_program_rows_are_rotations():
    """LOAD's rot is normalised mod n: a(-3) reads row i - 3 (wrapping to
    the end), f(5) row i + 5 (wrapping to the start)."""
    lv = _Leaves(3)
    prog = quotient.compile_program([quotient.expr_ir(_wrap_expr(texpr))], N)
    loads = {(lv_key, rot) for op, _, lv_key, rot in prog.code.tolist()
             if op == fp.LOAD}
    keys = prog.leaf_keys
    assert (keys.index(("advice", 0)), N - 3) in loads
    assert (keys.index(("fixed", 1)), 5) in loads
    got = FR.decode(lv.run(prog))
    a0 = FR.decode(lv.column(("advice", 0))[1])
    f1 = FR.decode(lv.column(("fixed", 1))[1])
    i0 = FR.decode(lv.column(("instance", 0))[1])
    a2 = FR.decode(lv.column(("advice", 2))[1])
    for i in range(N):
        assert got[i] == (a0[(i - 3) % N] * f1[(i + 5) % N] + 7
                          - i0[(i - 1) % N] * a2[(i + 2) % N]) % R


@pytest.fixture(scope="module")
def engine():
    k = 6
    return TorchEngine(make_domain(k, 3), setup(k, cache=False), "cpu")


def test_horner_fold_matches_weighted_sum(engine):
    """sum_i y^(N-1-i) v_i as one program (the Horner fold over every
    structure's value, then the scale) equals the engine's weighted_sum
    of the values, each run as a program of its own, times the scale."""
    lv = _Leaves(5)
    rng = np.random.default_rng(6)
    y, zh = (int.from_bytes(rng.bytes(32), "big") % R for _ in range(2))
    trees = [quotient.expr_ir(t) for _, _, t in STRUCTURES]
    vals = [lv.run(quotient.compile_program([t], N)) for t in trees]
    want = engine.scale(engine.weighted_sum(
        vals, [pow(y, len(vals) - 1 - i, R) for i in range(len(vals))]), zh)
    prog = quotient.compile_program(trees, N, fold=("y",), scale=("zh",))
    assert prog.op_counts()["HORNER"] == len(trees) - 1
    got = lv.run(prog, {"y": y, "zh": zh})
    assert torch.equal(got, want)


def test_program_past_s_max_raises():
    """A balanced product of 2^S_MAX leaves needs S_MAX + 1 slots."""
    leaves = [texpr.AdviceQuery(i, 0) for i in range(1 << fp.S_MAX)]
    while len(leaves) > 1:
        leaves = [texpr.Product(leaves[i], leaves[i + 1])
                  for i in range(0, len(leaves), 2)]
    with pytest.raises(ValueError, match="slots"):
        quotient.compile_program([quotient.expr_ir(leaves[0])], N)
    one_less = leaves[0].lhs
    prog = quotient.compile_program([quotient.expr_ir(one_less)], N)
    assert prog.slots == fp.S_MAX


def test_several_values_need_a_fold():
    tree = quotient.expr_ir(_wrap_expr(texpr))
    with pytest.raises(ValueError, match="fold"):
        quotient.compile_program([tree, tree], N)


def _to_port(e):
    """A halo2tpu expression as the port's (the same node classes)."""
    if isinstance(e, jexpr.Constant):
        return texpr.Constant(e.value)
    for name in ("AdviceQuery", "FixedQuery", "InstanceQuery"):
        if isinstance(e, getattr(jexpr, name)):
            return getattr(texpr, name)(e.column_index, e.rotation)
    if isinstance(e, jexpr.Neg):
        return texpr.Neg(_to_port(e.expr))
    cls = texpr.Sum if isinstance(e, jexpr.Sum) else texpr.Product
    return cls(_to_port(e.lhs), _to_port(e.rhs))


def test_composite_gates_fit_s_max():
    """halo2tpu's composite Aadhaar circuit (configure only): every gate
    poly, alone and all folded by y into one program, fits S_MAX."""
    cs = _configured(AadhaarQRVerifierCircuit(None), JaxCS)
    trees = [quotient.expr_ir(_to_port(p)) for g in cs.gates
             for p in g.polys]
    assert len(trees) > 100
    worst = max(quotient.compile_program([t], 1 << 15).slots for t in trees)
    folded = quotient.compile_program(trees, 1 << 15, fold=("y",))
    assert worst <= fp.S_MAX and folded.slots <= fp.S_MAX


def test_rsa_part_program_shape():
    """The RSA-SHA256 part program: one value a gate poly, permutation rule
    and lookup rule (333 at this circuit's configuration), in 4
    sub-programs at 2^15 rows (ops/field_prog.py::groups_for), one HORNER a
    value after each sub-program's first, the y and zh_inv constants, one
    OUT ending each sub-program."""
    tcs = _circuit_pairs()["rsa_sha256"][1]
    chunks = -(-len(tcs.permutation_columns) // tcs.permutation_chunk_len())
    n_values = (sum(len(g.polys) for g in tcs.gates) + 2 + (chunks - 1)
                + chunks + 5 * len(tcs.lookups))
    assert n_values == 333
    assert len(quotient.part_values(tcs, 1 << 15)) == n_values
    prog = quotient.part_program(tcs, 1 << 15)
    ops = prog.op_counts()
    assert prog.groups == fp.groups_for(1 << 15) == 4
    assert ops["OUT"] == prog.groups
    assert all(prog.sub_code(g)[-1, 0] == fp.OUT for g in range(4))
    assert ops["HORNER"] >= n_values - prog.groups
    assert ("y",) in prog.const_keys and ("zh_inv",) in prog.const_keys
    assert prog.slots <= fp.S_MAX
    assert ((prog.code[:, 0] != fp.LOAD)
            | ((prog.code[:, 3] >= 0) & (prog.code[:, 3] < 1 << 15))).all()


def _part_case(circuit, seed: int):
    """A circuit's part program at N rows on random leaves (strided column
    views of one stack, as coeff_to_part_stack returns them) and random
    challenges: (ConstraintSystem, program, leaves by key, challenges,
    zh_inv)."""
    g = torch.Generator().manual_seed(seed)
    cs = _configured(circuit, ConstraintSystem)
    prog = quotient.part_program(cs, N)
    m = len(prog.leaf_keys)
    x = torch.randint(-2**31, 2**31, (N * m, 8), generator=g,
                      dtype=torch.int64)
    x[:, 7] &= 0x0FFFFFFF                             # canonical: < 2^252
    by_key = dict(zip(prog.leaf_keys,
                      x.to(torch.int32).reshape(N, m, 8).unbind(1)))
    vals = torch.randint(0, 2**62, (5, 4), generator=g, dtype=torch.int64)
    ch_vals = [sum(int(w) << (62 * i) for i, w in enumerate(row)) % R
               for row in vals.tolist()]
    ch = dict(zip(("theta", "beta", "gamma", "y"), ch_vals))
    return cs, prog, by_key, ch, ch_vals[4]


def _run_part(prog, by_key, ch, zh_inv):
    consts = FR.encode([quotient.const_value(k, ch, zh_inv)
                        for k in prog.const_keys], "cpu")
    return fp.field_prog(FR, prog, [by_key[k] for k in prog.leaf_keys],
                         consts, N)


def _halo2tpu_part(jcs, by_key, ch, zh_inv):
    """A part's hv / Z_H by halo2tpu's per-op route on JAX CPU, the steps
    of its quotient._fold_part_jnp: _val_fn_for for each gate poly and
    each lookup's compressed expressions, _val_l0_one_minus_z,
    _val_llast_zz, _val_l0_z_minus_prev and _val_perm_product for the
    permutation chunks, _val_lookup_rules for each lookup, then the
    y-fold and the 1 / Z_H scale; over the port's leaves by_key as
    halo2tpu's limbs."""
    cols = {k: jnp.asarray(convert.to_jax_limbs(v)) for k, v in by_key.items()}

    def col(*key):
        return cols[key]

    def enc(v):
        return JFR.encode([v % R])[0]

    def value(expr):
        fn, leaves = jquot._val_fn_for(expr)
        return fn(*[enc(v) if kind == "const" else col(kind, v)
                    for kind, v in leaves])

    def wsum(vals, coefs):
        """sum_i coefs[i] vals[i] (the engine's weighted_sum)."""
        terms = [jjf.mont_mul(JFR, v, jnp.broadcast_to(enc(c), v.shape))
                 for v, c in zip(vals, coefs)]
        acc = terms[0]
        for t in terms[1:]:
            acc = jjf.add(JFR, acc, t)
        return acc

    def compress(exprs):
        vals = [value(e) for e in exprs]
        k = len(vals)
        return vals[0] if k == 1 else wsum(
            vals, [pow(ch["theta"], k - 1 - i, R) for i in range(k)])

    l0, l_last, l_active = col("l0"), col("l_last"), col("l_active")
    beta_e, gamma_e = enc(ch["beta"]), enc(ch["gamma"])
    values = [value(poly) for gate in jcs.gates for poly in gate.polys]
    chunks = jquot._perm_layout(jcs)
    if chunks:
        b = jcs.blinding_factors()
        perm_cols = jcs.permutation_columns
        zs = [col("z", j) for j in range(len(chunks))]
        values.append(jquot._val_l0_one_minus_z(l0, zs[0]))
        values.append(jquot._val_llast_zz(l_last, zs[-1]))
        for j in range(1, len(chunks)):
            values.append(jquot._val_l0_z_minus_prev(l0, zs[j], zs[j - 1],
                                                     (-(b + 1)) % N))
        gidx = 0
        for j, chunk in enumerate(chunks):
            values.append(jquot._val_perm_product(
                zs[j], l_active, jnp.stack([col(c.kind, c.index)
                                            for c in chunk]),
                jnp.stack([col("sigma", perm_cols.index(c)) for c in chunk]),
                jnp.stack([enc(ch["beta"] * pow(FR_DELTA, gidx + i, R))
                           for i in range(len(chunk))]),
                beta_e, gamma_e, col("wq")))
            gidx += len(chunk)
    for li, lk in enumerate(jcs.lookups):
        values.extend(jquot._val_lookup_rules(
            *[col("lookup", li, k) for k in range(3)],
            compress([p[0] for p in lk.pairs]),
            compress([p[1] for p in lk.pairs]), l0, l_last, l_active,
            beta_e, gamma_e))
    n_values = len(values)
    hv = wsum(values, [pow(ch["y"], n_values - 1 - i, R)
                       for i in range(n_values)])
    return jjf.mont_mul(JFR, hv, jnp.broadcast_to(enc(zh_inv), hv.shape))


@pytest.mark.parametrize("name", ["composite", "nullifier_k10",
                                  "extractor_k8", "rsa_sha256"])
def test_part_program_matches_the_per_op_route(name):
    """A whole part program (gates, permutation chunks, lookups, the y-fold
    and 1 / Z_H), interpreted at n = 64 on random leaves and challenges,
    equals halo2tpu's per-op route over halo2tpu's copy of the circuit
    (_halo2tpu_part): the composite at the default AadhaarParams
    (permutation chunks of 4, lookups over advice tables), Nullifier
    (degree 6), the extractor harness and RSA-SHA256."""
    cs, prog, by_key, ch, zh_inv = _part_case(_circuit(name), 5)
    got = _run_part(prog, by_key, ch, zh_inv)
    want = _halo2tpu_part(_configured(_jax_circuit(name), JaxCS), by_key,
                          ch, zh_inv)
    assert np.array_equal(convert.to_jax_limbs(got), np.asarray(want)), name


def test_composite_part_program_shape():
    """The composite's part program at k=15: one value a gate poly,
    permutation rule and lookup rule, 5 slots (it fits S_MAX), 8 parts;
    10,141 instructions in 4 sub-programs (the 1 / Z_H scale is the
    combine's, not an instruction)."""
    tcs = _configured(_circuit("composite"), ConstraintSystem)
    assert (tcs.degree(), tcs.permutation_chunk_len()) == (6, 4)
    assert make_domain(15, tcs.degree()).extended_n == 8 << 15
    chunks = -(-len(tcs.permutation_columns) // tcs.permutation_chunk_len())
    n_values = (sum(len(g.polys) for g in tcs.gates) + 2 + (chunks - 1)
                + chunks + 5 * len(tcs.lookups))
    assert len(quotient.part_values(tcs, 1 << 15)) == n_values == 500
    prog = quotient.part_program(tcs, 1 << 15)
    assert (prog.code.shape[0], prog.slots, len(prog.leaf_keys),
            prog.groups) == (10141, 5, 849, 4)


# -- the split into sub-programs (one warp each on the card) -----------------

def _sub_slots(prog, g: int) -> int:
    """Slots sub-program g touches (its largest slot index + 1)."""
    code = prog.sub_code(g)
    used = set(code[:, 1].tolist())
    for op, _, a, b in code.tolist():
        if op in (fp.ADD, fp.SUB, fp.MUL):
            used |= {a, b}
        elif op in (fp.NEG, fp.SQR, fp.OUT, fp.HORNER):
            used.add(a)
    return max(used) + 1


@pytest.mark.parametrize("groups", [2, 3, 4, 7])
@pytest.mark.parametrize("name", ["rsa_sha256", "composite"])
def test_split_program_matches_one_program(name, groups):
    """The part program split into G sub-programs, combined by y-powers
    and scaled, gives the bits of the unsplit program (G = 1) on the same
    seeded leaves at n = 64 rows."""
    cs, _, by_key, ch, zh_inv = _part_case(_circuit(name), 11)
    one = quotient.part_program(cs, N, groups=1)
    split = quotient.part_program(cs, N, groups=groups)
    assert (one.groups, split.groups) == (1, groups)
    assert split.op_counts()["OUT"] == groups
    assert torch.equal(_run_part(split, by_key, ch, zh_inv),
                       _run_part(one, by_key, ch, zh_inv))


@pytest.mark.parametrize("name", ["rsa_sha256", "composite"])
def test_split_subprograms_fit_s_max(name):
    """Every sub-program, at G = 1 to G_MAX, stays within S_MAX slots (and
    within the program's own count), ends in OUT and costs within a third
    of the others (the balance by instruction cost)."""
    cs = _configured(_circuit(name), ConstraintSystem)
    for groups in range(1, fp.G_MAX + 1):
        prog = quotient.part_program(cs, 1 << 15, groups=groups)
        assert prog.groups == groups and prog.slots <= fp.S_MAX
        costs = []
        for g in range(groups):
            code = prog.sub_code(g)
            assert code[-1, 0] == fp.OUT and _sub_slots(prog, g) <= prog.slots
            heavy = np.isin(code[:, 0], [fp.MUL, fp.SQR, fp.HORNER])
            costs.append(int(heavy.sum()) * quotient.PRODUCT_COST
                         + int((~heavy).sum()))
        assert max(costs) <= 1.34 * min(costs), costs


def test_combine_constants_are_y_powers():
    """Sub-program g's result is multiplied by y^(values after run g): the
    constant ("pow", ("y",), e), none for the last run; the scale is
    1 / Z_H; const_value gives y^e."""
    cs = _circuit_pairs()["rsa_sha256"][1]
    values = quotient.part_values(cs, N)
    prog = quotient.part_program(cs, N, groups=4)
    # each run's values: its HORNERs (fold constant y) plus its first
    y_idx = prog.const_keys.index(("y",))
    sizes = [1 + int(((prog.sub_code(g)[:, 0] == fp.HORNER)
                      & (prog.sub_code(g)[:, 3] == y_idx)).sum())
             for g in range(4)]
    assert sum(sizes) == len(values)
    for g in range(4):
        after = sum(sizes[g + 1:])
        if g == 3:
            assert after == 0 and prog.comb[g] == -1
        else:
            assert prog.const_keys[prog.comb[g]] == ("pow", ("y",), after)
    assert prog.const_keys[prog.scale] == ("zh_inv",)
    ch = {"y": 123456789, "beta": 1, "gamma": 2, "theta": 3}
    assert quotient.const_value(("pow", ("y",), 17), ch, 5) == pow(
        123456789, 17, R)


def test_groups_for_fills_the_card():
    """G = round(132 SMs x 32 warps x 32 rows / n) within [1, G_MAX]: 4 at
    a k=15 part (1,024 blocks of 4 warps, 31 warps an SM)."""
    assert fp.groups_for(1 << 15) == 4
    assert fp.groups_for(1 << 16) == 2
    assert fp.groups_for(1 << 20) == 1
    assert fp.groups_for(64) == fp.G_MAX == 8
    assert quotient.part_program(_circuit_pairs()["rsa_sha256"][1],
                                 1 << 15).groups == 4
