"""The port's MockProver (halo2tpu_torch/plonk/mock.py) against halo2tpu's:
for each circuit of chip_smoke.golden_circuits(), built once from each
package, and each witness (satisfied, one advice cell overwritten after
synthesis, a broken copy, a lookup input outside its table, a wrong
instance, and tampers that break more than 16 rows), the port's verify()
list on the CPU equals halo2tpu's (its C++ gate evaluator) string for
string and in the same order.  Also the port's GateEvaluator against
halo2tpu's NativeGateEvaluator row for row, and the CUDA default."""
import copy
import random

import numpy as np
import pytest
import torch

from chip_smoke import golden_circuits
from halo2tpu import native
from halo2tpu.fields.bn254 import R
from halo2tpu.plonk import expression as jexpr
from halo2tpu.plonk.circuit import Assignment as JAssignment
from halo2tpu.plonk.circuit import ConstraintSystem as JConstraintSystem
from halo2tpu.plonk.mock import MockProver as JMockProver
from halo2tpu_torch.plonk import expression as texpr
from halo2tpu_torch.plonk.circuit import Assignment, ConstraintSystem
from halo2tpu_torch.fields.jfield import FR
from halo2tpu_torch.plonk.mock import GateEvaluator, MockProver
from test_torch_golden import jax_golden_circuits

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(
    not native.available(), reason="halo2tpu's C++ evaluator did not build")


def _bump(arr, row: int) -> None:
    arr[row] = (int(arr[row]) + 1) % R


def cell(col: int, row: int):
    """Advice cell (col, row) plus one."""
    def edit(cs, asn, inst):
        _bump(asn.advice[col], row)
        return inst
    return edit


def column(col: int, value=None, start: int = 0):
    """Every usable row from start of advice column col plus one, or set
    to value."""
    def edit(cs, asn, inst):
        for row in range(start, cs.usable_rows(asn.n)):
            if value is None:
                _bump(asn.advice[col], row)
            else:
                asn.advice[col][row] = value
        return inst
    return edit


def broken_copy(cs, asn, inst):
    """The second cell of the first copy plus one."""
    (_, _), (cb, rb) = asn.copies[0]
    _bump(getattr(asn, cb.kind)[cb.index], rb)
    return inst


def lookup_miss(cs, asn, inst):
    """Row 0 of the first lookup whose input is a lone advice query set to
    R - 1, which no range table holds."""
    lk = next(lk for lk in cs.lookups
              if type(lk.pairs[0][0]).__name__ == "AdviceQuery")
    asn.advice[lk.pairs[0][0].column_index][0] = R - 1
    return inst


def unreduced(cs, asn, inst):
    """Advice cells of column 0 written as other ints below 2^256 of the
    same class mod R: row 0 plus R, row 1 plus 2R; the witness stays
    satisfied."""
    asn.advice[0][0] = int(asn.advice[0][0]) + R
    asn.advice[0][1] = int(asn.advice[0][1]) + 2 * R
    return inst


def wrong_instance(cs, asn, inst):
    bad = [list(col) for col in inst]
    bad[0][0] ^= 1
    return bad


# (circuit, witness, edit, what halo2tpu's list must show for the case to
# test what it names: a kind it holds, or "many" for more than 16)
CASES = [
    ("square_k4", "satisfied", None, None),
    ("square_k4", "gate", cell(0, 0), "gate"),
    ("square_k4", "unreduced", unreduced, None),
    ("timestamp_k6", "satisfied", None, None),
    ("range_k7", "satisfied", None, None),
    ("range_k7", "copy", broken_copy, "copy"),
    ("range_k7", "lookup", lookup_miss, "lookup"),
    ("range_k7", "many_lookups", column(4, R - 1), "many"),
    # row 0 is copied: from row 1 the list is 17 lookup failures alone
    ("range_k7", "only_lookups", column(4, R - 1, start=1), "many"),
    ("identity_k4", "satisfied", None, None),
    ("identity_k4", "gate", cell(0, 0), "gate"),
    ("nullifier_k10", "satisfied", None, None),
    ("nullifier_k10", "gate", cell(10, 1), "gate"),
    ("nullifier_k10", "copy", broken_copy, "copy"),
    ("nullifier_k10", "lookup", lookup_miss, "lookup"),
    ("nullifier_k10", "instance", wrong_instance, "copy"),
    ("nullifier_k10", "many_gates", column(10), "many"),
    ("nullifier_k10", "many_copies", column(0), "many"),
    ("extractor_k8", "satisfied", None, None),
    ("extractor_k8", "gate", cell(10, 0), "gate"),
    ("extractor_k8", "copy", broken_copy, "copy"),
    ("extractor_k8", "lookup", lookup_miss, "lookup"),
    ("extractor_k8", "many_gates", column(10), "many"),
    ("extractor_k8", "many_copies", column(0), "many"),
]

_SYNTH: dict = {}


def _synthesized(name: str):
    """(halo2tpu's (cs, asn), the port's (cs, asn), k, instances) of a
    golden circuit, synthesized once."""
    got = _SYNTH.get(name)
    if got is None:
        jc, k, inst, _ = jax_golden_circuits()[name]
        tc = golden_circuits()[name][0]
        sides = []
        for c, cs_cls, asn_cls in ((jc, JConstraintSystem, JAssignment),
                                   (tc, ConstraintSystem, Assignment)):
            cs = cs_cls()
            config = c.configure(cs)
            asn = asn_cls(cs, 1 << k)
            c.synthesize(config, asn)
            sides.append((cs, asn))
        got = _SYNTH[name] = (sides[0], sides[1], k, inst)
    return got


def _edited(cs, asn, inst, edit):
    """A copy of asn (its columns and copies) with edit applied; returns
    (asn, instances)."""
    asn = copy.copy(asn)
    asn.advice = [a.copy() for a in asn.advice]
    asn.fixed = [a.copy() for a in asn.fixed]
    asn.copies = list(asn.copies)
    return asn, (edit(cs, asn, inst) if edit else inst)


@pytest.mark.parametrize("name,witness,edit,shows", CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in CASES])
def test_mock_failures_equal_halo2tpu(name, witness, edit, shows):
    (jcs, jasn), (tcs, tasn), k, inst = _synthesized(name)
    jasn, jinst = _edited(jcs, jasn, inst, edit)
    tasn, tinst = _edited(tcs, tasn, inst, edit)
    want = [(f.kind, f.detail)
            for f in JMockProver(jcs, jasn, jinst, 1 << k).verify()]
    mp = MockProver(tcs, tasn, tinst, 1 << k, device="cpu")
    got = [(f.kind, f.detail) for f in mp.verify()]
    assert got == want
    if shows is None:
        assert want == []
    elif shows == "many":
        assert len(want) > 16
    else:
        assert shows in {kind for kind, _ in want}
    # verify() returns after the gates once they hold more than 16
    parts = ({"encode", "gates"}
             if sum(kind == "gate" for kind, _ in want) > 16
             else {"encode", "gates", "copies", "lookups"})
    assert set(mp.times) == parts


def test_mock_run_equals_halo2tpu_run():
    """MockProver.run (synthesis included) on the port's Nullifier circuit
    gives halo2tpu's list for a wrong instance, and times each part."""
    jc, k, inst, _ = jax_golden_circuits()["nullifier_k10"]
    tc = golden_circuits()["nullifier_k10"][0]
    bad = wrong_instance(None, None, inst)
    want = [(f.kind, f.detail) for f in JMockProver.run(k, jc, bad).verify()]
    mp = MockProver.run(k, tc, bad, device="cpu")
    assert [(f.kind, f.detail) for f in mp.verify()] == want != []
    assert set(mp.times) == {"synthesize", "encode", "gates", "copies",
                             "lookups"}
    with pytest.raises(AssertionError, match="not satisfied"):
        mp.assert_satisfied()
    MockProver.run(k, tc, inst, device="cpu").assert_satisfied()


def _expr(mod, lone: bool = False):
    """One gate polynomial over rotations -1, 0 and +1 in each column kind,
    built from the expression classes of mod; or a lone rotated query."""
    if lone:
        return mod.FixedQuery(0, -1)
    a0, a1 = mod.AdviceQuery(0, 0), mod.AdviceQuery(1, 1)
    f0, f1 = mod.FixedQuery(0, -1), mod.FixedQuery(1, 0)
    i0 = mod.InstanceQuery(0, 0)
    return (f0 * (a0 * a0 + a1 * mod.Constant(7) - a0)
            + f1 * (mod.AdviceQuery(0, -1) - i0 * a1))


@pytest.mark.parametrize("lone", [False, True], ids=["gate", "lone_query"])
@pytest.mark.parametrize("usable", [25, 32])
def test_gate_evaluator_rows_equal_native(usable, lone):
    """Random columns, n = 32: the port's failing rows equal the native
    evaluator's at max_fail = n (usable = n reaches row n - 1, whose +1
    rotation wraps to row 0, and row 0, whose -1 reads row n - 1)."""
    rnd = random.Random(5)
    n = 32
    adv = [[rnd.randrange(R) for _ in range(n)] for _ in range(2)]
    fx = [[rnd.randrange(3) for _ in range(n)] for _ in range(2)]
    ins = [[rnd.randrange(R) for _ in range(n)]]
    want = native.NativeGateEvaluator(fx, adv, ins, n, usable).eval_poly(
        _expr(jexpr, lone), max_fail=n)
    ev = GateEvaluator(fx, adv, ins, n, usable, device="cpu")
    assert ev.eval_poly(_expr(texpr, lone), max_fail=n) == want
    assert 0 < len(want) < usable
    assert ev.eval_poly(_expr(texpr, lone)) == want[:8]
    # the same polynomial twice, each cut at max_fail rows
    assert ev.fail_rows([_expr(texpr, lone)] * 2, max_fail=3) == (
        [want[:3]] * 2)


def test_column_encoding_reduces_mod_r():
    """The stacked columns hold each cell's value mod R, for cells past 64
    bits, at or past R, past 2^256 and negative."""
    col = [0, 1, 2**63, 2**64 - 1, 2**64, R - 1, R, R + 5, 2**256 - 1, -1,
           -R - 3]
    ev = GateEvaluator([col], [col[::-1]], [], len(col), len(col),
                       device="cpu")
    assert FR.decode(ev.column("fixed", 0)) == [v % R for v in col]
    assert FR.decode(ev.column("advice", 0)) == [v % R for v in col[::-1]]


def test_mock_prover_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the default device works")
    (_, _), (cs, asn), k, inst = _synthesized("square_k4")
    with pytest.raises(RuntimeError, match="CUDA"):
        MockProver(cs, asn, inst, 1 << k)
    with pytest.raises(RuntimeError, match="CUDA"):
        MockProver.run(k, golden_circuits()["square_k4"][0], inst)
