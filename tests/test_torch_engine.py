"""TorchEngine methods against halo2tpu's JaxEngine (XLA on CPU) at k=4,
and the lookup permutation against HostEngine.  Same inputs, made with
numpy from a seed; exact equality of the raw Montgomery limbs."""
import numpy as np
import pytest
import torch

from halo2tpu.fields.bn254 import R
from halo2tpu.plonk.domain import make_domain
from halo2tpu.plonk.engine import HostEngine, JaxEngine
from halo2tpu.plonk.srs import setup
from halo2tpu_torch import convert
from halo2tpu_torch.plonk.engine import TorchEngine

torch.set_num_threads(1)

K = 4
N = 1 << K


@pytest.fixture(scope="module")
def engines():
    d = make_domain(K, 3)
    srs = setup(K, cache=False)
    return JaxEngine(d, srs), TorchEngine(d, srs, "cpu"), HostEngine(d, srs)


def _ints(rng, m, n=N):
    return [[int.from_bytes(rng.bytes(32), "big") % R for _ in range(n)]
            for _ in range(m)]


def _t(v):
    return convert.from_jax_limbs(np.asarray(v))


def _eq(jv, tv):
    if isinstance(jv, (list, tuple)):
        assert len(jv) == len(tv)
        for a, b in zip(jv, tv):
            _eq(a, b)
        return
    assert np.array_equal(np.asarray(jv),
                          convert.to_jax_limbs(tv).reshape(np.shape(jv)))


def test_representation_and_elementwise(engines):
    je, te, _ = engines
    rng = np.random.default_rng(40)
    cols = _ints(rng, 3)
    small = [int(v) for v in rng.integers(0, 1 << 12, N)]
    cols.append(small[:10] + cols[0][10:])       # narrow until row 10
    bits = [None, None, 254, 12]
    jv = je.from_ints_stack(cols, bits=bits, blind_start=10)
    tv = te.from_ints_stack(cols, bits=bits, blind_start=10)
    _eq(jv, tv)
    assert te.to_ints(tv[3]) == cols[3]
    _eq(je.from_packed_stack([np.asarray(jv[0])[:, :16].astype("<u2")]),
        te.from_packed_stack([np.asarray(jv[0])[:, :16].astype("<u2")]))
    a, b = jv[0], jv[1]
    ta, tb = tv[0], tv[1]
    _eq(je.add(a, b), te.add(ta, tb))
    _eq(je.sub(a, b), te.sub(ta, tb))
    _eq(je.mul(a, b), te.mul(ta, tb))
    _eq(je.neg(a), te.neg(ta))
    _eq(je.scale(a, 12345), te.scale(ta, 12345))
    _eq(je.add_const(a, R - 3), te.add_const(ta, R - 3))
    _eq(je.rotate(a, -3), te.rotate(ta, -3))
    _eq(je.const_vec(7, N), te.const_vec(7, N))
    assert je.read_rows(jv, 5) == te.read_rows(tv, 5)
    _eq(je.set_rows_batch(jv[:2], 12, [[1, 2], [3, 4]]),
        te.set_rows_batch(tv[:2], 12, [[1, 2], [3, 4]]))
    _eq(je.assemble_z_batch(jv[:2], [5, 6], 13, [[7, 8, 9], [1, 2, 3]]),
        te.assemble_z_batch(tv[:2], [5, 6], 13, [[7, 8, 9], [1, 2, 3]]))


def test_transforms(engines):
    je, te, _ = engines
    rng = np.random.default_rng(41)
    cols = _ints(rng, 3)
    jv = je.from_ints_stack(cols)
    tv = [_t(v) for v in jv]
    jc = je.lagrange_to_coeff_stack(jv)
    tc = te.lagrange_to_coeff_stack(tv)
    _eq(jc, tc)
    _eq(je.coeff_to_lagrange_stack(jc), te.coeff_to_lagrange_stack(tc))
    jp = [je.coeff_to_part_stack(jc, q) for q in range(2)]
    tp = [te.coeff_to_part_stack(tc, q) for q in range(2)]
    _eq(jp, tp)
    _eq(je.parts_to_h_chunks([p[0] for p in jp], 2),
        te.parts_to_h_chunks([p[0] for p in tp], 2))


def test_permute_lookup_matches_host(engines):
    _, te, he = engines
    rng = np.random.default_rng(43)
    usable = N - 3
    table = [int(v) for v in rng.integers(0, 9, N)]
    table[:9] = list(range(9))                     # every value present
    inputs = [int(v) for v in rng.choice(table[:usable], N)]
    big = [int.from_bytes(rng.bytes(32), "big") % R for _ in range(4)]
    table[9:13] = big                              # wide values too
    inputs[:2] = big[:2]
    ins = [inputs, table[::-1]]
    tbs = [table, table[::-1]]
    a_t, s_t, fails = te.permute_lookup_batch(
        [te.from_ints(v) for v in ins], [te.from_ints(v) for v in tbs],
        usable, [None, 8])
    te.check_lookup_fails(fails)
    for i in range(2):
        a_h, s_h, _ = he.permute_lookup(ins[i], tbs[i], usable)
        assert te.to_ints(a_t[i]) == a_h
        assert te.to_ints(s_t[i]) == s_h
    bad = list(inputs)
    bad[0] = 10 ** 6                               # not in the table
    _, _, fails = te.permute_lookup_batch(
        [te.from_ints(bad)], [te.from_ints(table)], usable, [None])
    with pytest.raises(ValueError, match="lookup failure"):
        te.check_lookup_fails(fails)
