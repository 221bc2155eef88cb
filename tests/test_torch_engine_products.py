"""TorchEngine grand-product, evaluation and sigma methods against
halo2tpu's JaxEngine (XLA on CPU) at k=4.  Exact equality of the raw
Montgomery limbs."""
import numpy as np
import torch

from halo2tpu.fields.bn254 import R
from tests.test_torch_engine import N, _eq, _ints, _t, engines  # noqa: F401

torch.set_num_threads(1)


def test_grand_products_and_evaluation(engines):
    je, te, _ = engines
    rng = np.random.default_rng(42)
    jv = je.from_ints_stack(_ints(rng, 6))
    tv = [_t(v) for v in jv]
    beta, gamma = 1234567, 7654321
    omega = je.from_ints([pow(je.d.omega, i, R) for i in range(N)])
    chunk_cols = [[0, 1, 2], [3]]
    jn, jd = je.perm_numden_chunks(
        [[jv[i] for i in c] for c in chunk_cols],
        [[jv[5 - i] for i in c] for c in chunk_cols], omega, beta, gamma,
        [[1, 5, 25], [125]])
    tn, td = te.perm_numden_chunks(
        [[tv[i] for i in c] for c in chunk_cols],
        [[tv[5 - i] for i in c] for c in chunk_cols], _t(omega), beta, gamma,
        [[1, 5, 25], [125]])
    _eq(jn, tn)
    _eq(jd, td)
    _eq(je.lookup_numden(jv[:2], jv[2:4], jv[4:6], jv[:2], beta, gamma),
        te.lookup_numden(tv[:2], tv[2:4], tv[4:6], tv[:2], beta, gamma))
    _eq(je.grand_products(jn, jd), te.grand_products(tn, td))
    pairs = [(jv[0], 99), (jv[1], 99), (jv[2], 12345)]
    assert je.eval_polys(pairs) == te.eval_polys(
        [(_t(p), x) for p, x in pairs])
    _eq(je.div_linear(jv[3], 4242), te.div_linear(tv[3], 4242))
    _eq(je.weighted_sum(jv, [3, 1, 4, 1, 5, 9]),
        te.weighted_sum(tv, [3, 1, 4, 1, 5, 9]))
    mapping = np.stack([np.stack([rng.integers(0, 3, N),
                                  rng.permutation(N)], axis=-1)
                        for _ in range(3)]).astype(np.int32)
    _eq(je.sigma_from_mapping(mapping), te.sigma_from_mapping(mapping))


def test_grand_products_all_vectors_at_once(engines):
    """11 numerator/denominator pairs (more than one of halo2tpu's chunks
    of 8): the port's one pass over the stack (column totals, one
    inversion of all of them, the ratios' product scan) equals
    JaxEngine.grand_products, and each prefix ends in prod(num / den)."""
    je, te, _ = engines
    rng = np.random.default_rng(43)
    nums = _ints(rng, 11)
    dens = [[1 + v % (R - 1) for v in d] for d in _ints(rng, 11)]
    jn, jd = je.from_ints_stack(nums), je.from_ints_stack(dens)
    got = te.grand_products([_t(v) for v in jn], [_t(v) for v in jd])
    _eq(je.grand_products(jn, jd), got)
    for g, n_, d_ in zip(got, nums, dens):
        acc = 1
        for a, b in zip(n_, d_):
            acc = acc * a * pow(b, -1, R) % R
        assert te.to_ints(g)[-1] == acc
