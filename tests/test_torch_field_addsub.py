"""Field add / sub / neg of halo2tpu_torch (on CPU tensors: the plain
versions) against halo2tpu's jfield.add / sub / neg (XLA on CPU), at the
edge values 0, 1 and p - 1 and random ones, with broadcast operands, over
Fr and Fq; and the operand layout the add/sub kernel reads
(cuda_field._operand: lane i reads element (i // div) % mod).  Exact
equality: these are finite-field values."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo2tpu.fields import jfield as jjf
from halo2tpu.fields.bn254 import Q, R
from halo2tpu_torch import convert
from halo2tpu_torch.fields import jfield as tjf
from halo2tpu_torch.ops import cuda_field

torch.set_num_threads(1)

SPECS = {"fr": (R, jjf.FR, tjf.FR), "fq": (Q, jjf.FQ, tjf.FQ)}
N, C = 40, 3


def _raw(vals, shape):
    """Raw canonical limbs (the ops take any canonical value) as a port
    tensor and a JAX array."""
    t = torch.from_numpy(tjf.ints_to_limbs(vals).copy())
    t = t.reshape(shape + (8,))
    return t, jnp.asarray(convert.to_jax_limbs(t))


def _vals(rng, p, m, rot):
    """m values: 0, 1 and p - 1 rotated by rot, then random ones."""
    edge = [0, 1, p - 1]
    rand = [int.from_bytes(rng.bytes(32), "big") % p for _ in range(m)]
    return (edge[rot:] + edge[:rot] + rand)[:m]


@pytest.mark.parametrize("shapes", [((N,), ()), ((N, C), (N, 1)),
                                    ((N, C), (N, C))],
                         ids=["n+1", "nC+n1", "nC+nC"])
@pytest.mark.parametrize("field", ["fr", "fq"])
def test_add_sub_neg_match_jfield(field, shapes):
    p, sj, st = SPECS[field]
    rng = np.random.default_rng(5 + len(shapes[1]))
    sa, sb = shapes
    a_t, a_j = _raw(_vals(rng, p, int(np.prod(sa)), 0), sa)
    for rot in range(3):
        b_t, b_j = _raw(_vals(rng, p, int(np.prod(sb, dtype=int)), rot), sb)
        for fn_t, fn_j in ((tjf.add, jjf.add), (tjf.sub, jjf.sub)):
            for x_t, x_j, y_t, y_j in ((a_t, a_j, b_t, b_j),
                                       (b_t, b_j, a_t, a_j)):
                got = fn_t(st, x_t, y_t)
                want = np.asarray(fn_j(sj, x_j, y_j))
                assert np.array_equal(convert.to_jax_limbs(got), want)
        assert np.array_equal(convert.to_jax_limbs(tjf.neg(st, b_t)),
                              np.asarray(jjf.neg(sj, b_j)))
    assert np.array_equal(convert.to_jax_limbs(tjf.neg(st, a_t)),
                          np.asarray(jjf.neg(sj, a_j)))


def test_edge_pairs():
    """Every pair of 0, 1, p - 1 in both fields, against the integers."""
    for p, _, st in SPECS.values():
        edge = [0, 1, p - 1]
        a, _ = _raw([x for x in edge for _ in edge], (9,))
        b, _ = _raw([y for _ in edge for y in edge], (9,))
        pairs = [(x, y) for x in edge for y in edge]
        for fn, op in ((tjf.add, lambda x, y: x + y),
                       (tjf.sub, lambda x, y: x - y)):
            assert tjf.limbs_to_ints(fn(st, a, b).numpy()) == [
                op(x, y) % p for x, y in pairs]
        assert tjf.limbs_to_ints(tjf.neg(st, a).numpy()) == [
            -x % p for x, _ in pairs]


def _gather(x, shape):
    """What the kernel reads for operand x at output shape `shape`: lane i
    reads the 8 words at 8 ((i // div) % mod) from the operand's address;
    also whether the wrapper copied x out."""
    v, div, mod = cuda_field._operand(x, shape)
    words = v.as_strided((mod * 8,), (1,))
    i = torch.arange(int(np.prod(shape[:-1])))
    idx = ((i // div) % mod)[:, None] * 8 + torch.arange(8)
    return words[idx].reshape(tuple(shape)), v.data_ptr() != x.data_ptr()


@pytest.mark.parametrize("case", range(7))
def test_operand_layout(case):
    """The (div, mod) read of each operand equals torch's broadcast, for
    contiguous blocks (no copy) and for layouts the wrapper copies out."""
    z = torch.arange(6 * 4 * 5 * 8, dtype=torch.int32).reshape(6, 4, 5, 8)
    out = (6, 4, 5, 8)
    x, copied = {
        0: (z, False),                          # same shape
        1: (z[:1, :1, :1], False),              # one element
        2: (z[:, :1], True),                    # (6, 1, 5): two blocks
        3: (z[:, :, :1].contiguous(), False),   # (6, 4, 1): rows of a stack
        4: (z[0], False),                       # (4, 5) over a leading axis
        5: (z.transpose(0, 1).contiguous().transpose(0, 1), True),
        6: (z[:, 1:3], True),                   # a strided slice
    }[case]
    if case == 6:
        out = (6, 2, 5, 8)
    got, was_copied = _gather(x, out)
    assert torch.equal(got, x.expand(out))
    assert was_copied == copied
