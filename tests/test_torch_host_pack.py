"""The host packer (csrc/host_pack.c through jfield.pack_limbs16 and
pack_u16) against the plain join it replaced, and TorchEngine.
from_ints_stack against the packing it did before: the same bytes, the
same tensors, errors where a value does not fit, and the count of values
that took the long path."""
import random

import numpy as np
import pytest
import torch

import chip_smoke
from halo2tpu_torch import _build
from halo2tpu_torch.fields import jfield
from halo2tpu_torch.fields.bn254 import Q, R
from halo2tpu_torch.fields.jfield import FR
from halo2tpu_torch.plonk.circuit import Assignment, ConstraintSystem
from halo2tpu_torch.plonk.engine import TorchEngine
from halo2tpu_torch.plonk.srs import setup
from halo2tpu_torch.utils import trace

torch.set_num_threads(1)

EDGES = [0, 1, 2**16 - 1, 2**16, 2**30 - 1, 2**30, 2**63, 2**64 - 1, 2**64,
         Q - 1, R - 1, 2**256 - 1]
COMPACT = 1 << 30       # below it CPython stores an int in one digit


def join_limbs16(vals) -> np.ndarray:
    """The plain packing: each value's 32 little-endian bytes, joined."""
    buf = b"".join(int(v).to_bytes(32, "little") for v in vals)
    return np.frombuffer(buf, dtype="<u2").reshape(len(vals), 16)


def _containers(vals):
    return {"list": list(vals), "ndarray": np.array(vals, dtype=object)}


def _mixed(seed: int, n: int) -> list:
    """A column of mixed widths: zeros, 12-bit, 40-bit, 64-bit and full
    field elements."""
    rng = random.Random(seed)
    return [rng.choice([0, rng.getrandbits(12), rng.getrandbits(40),
                        rng.getrandbits(64), rng.randrange(R)])
            for _ in range(n)]


@pytest.mark.parametrize("kind", ["list", "ndarray"])
@pytest.mark.parametrize("v", EDGES, ids=[f"edge{i}" for i in
                                           range(len(EDGES))])
def test_pack_limbs16_edges_match_the_join(v, kind):
    vals = _containers([v, 0, v, 1])[kind]
    assert np.array_equal(jfield.ints_to_limbs16(vals), join_limbs16(vals))


@pytest.mark.parametrize("kind", ["list", "ndarray"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pack_limbs16_mixed_column_and_long_count(seed, kind):
    col = _mixed(seed, 4099)
    vals = _containers(col)[kind]
    out = np.empty((len(col), 16), "<u2")
    long_values = _build.host_lib().pack_limbs16(vals, out.ctypes.data,
                                                 len(col))
    assert np.array_equal(out, join_limbs16(col))
    assert long_values == sum(v >= COMPACT for v in col)
    assert np.array_equal(jfield.ints_to_limbs(vals),
                          jfield.limbs16_to_limbs(join_limbs16(col)))


def test_numpy_integers_inside_an_object_array():
    vals = np.array([np.int64(5), 7, np.uint64(2**64 - 1), np.int64(2**40),
                     True], dtype=object)
    assert np.array_equal(jfield.ints_to_limbs16(vals),
                          join_limbs16([5, 7, 2**64 - 1, 2**40, 1]))
    out = np.empty(3, "<u2")
    jfield.pack_u16(np.array([np.int64(3), np.uint16(65535), 0],
                             dtype=object), out)
    assert out.tolist() == [3, 65535, 0]


@pytest.mark.parametrize("kind", ["list", "ndarray"])
def test_pack_u16_values_and_prefix(kind):
    col = [random.Random(7).getrandbits(16) for _ in range(1000)]
    col[:3] = [0, 1, 2**16 - 1]
    out = np.zeros(1200, "<u2")
    # the first 900 values of the column into a slice of a larger row
    jfield.pack_u16(_containers(col)[kind], out[100:1000])
    assert out[100:1000].tolist() == col[:900]
    assert not out[:100].any() and not out[1000:].any()


@pytest.mark.parametrize("v,err", [(-1, OverflowError),
                                   (-2**40, OverflowError),
                                   (2**256, OverflowError),
                                   (1.5, TypeError), ("7", TypeError)])
def test_pack_limbs16_refuses_what_does_not_fit(v, err):
    with pytest.raises(err):
        jfield.ints_to_limbs16([3, v])


@pytest.mark.parametrize("v,err", [(2**16, OverflowError),
                                   (-1, OverflowError),
                                   (2**30, OverflowError),
                                   (2**300, OverflowError),
                                   (2.0, TypeError)])
def test_pack_u16_refuses_what_does_not_fit(v, err):
    with pytest.raises(err):
        jfield.pack_u16([3, v], np.empty(2, "<u2"))


def test_pack_checks_the_destination():
    with pytest.raises(ValueError):
        jfield.pack_limbs16([1, 2], np.empty((3, 16), "<u2"))
    with pytest.raises(ValueError):
        jfield.pack_limbs16([1, 2], np.empty((2, 16), "<u4"))
    with pytest.raises(ValueError):
        jfield.pack_limbs16([1, 2], np.empty((2, 32), "<u2")[:, ::2])
    with pytest.raises(ValueError):
        jfield.pack_u16([1, 2], np.empty((2, 1), "<u2"))
    assert jfield.ints_to_limbs16([]).shape == (0, 16)


def test_a_traced_record_counts_packed_and_long_values():
    col = _mixed(5, 777)
    with trace.proof(trace.Tracer(), lambda: None) as rec:
        jfield.ints_to_limbs16(col)
        jfield.pack_u16([1, 2, 3], np.empty(3, "<u2"))
    assert rec.counters["pack_values"] == 780
    assert rec.counters["pack_long_values"] == sum(v >= COMPACT for v in col)


# -- TorchEngine.from_ints_stack ---------------------------------------------

def _stack_by_join(cols, reduced, bits, blind_start):
    """from_ints_stack's packing before the host packer: per-column
    arrays through the join, stacked."""
    out = [None] * len(cols)
    narrow = [i for i, b in enumerate(bits or [])
              if b is not None and b <= 16] if blind_start else []
    rest = [i for i in range(len(cols)) if i not in set(narrow)]
    if narrow:
        n = len(cols[narrow[0]])
        main = np.zeros((len(narrow), n), "<u2")
        tails = []
        for j, i in enumerate(narrow):
            main[j, :blind_start] = cols[i][:blind_start]
            tails.append(join_limbs16(cols[i][blind_start:]))
        enc = FR.encode_narrow_stack(main, np.stack(tails), blind_start,
                                     "cpu")
        for j, i in enumerate(narrow):
            out[i] = enc[j]
    if rest:
        u16 = np.stack([join_limbs16(cols[i] if reduced
                                     else [v % R for v in cols[i]])
                        for i in rest])
        stacked = FR.encode_packed(u16, "cpu")
        for j, i in enumerate(rest):
            out[i] = stacked[j]
    return out


@pytest.fixture(scope="module")
def engine():
    from halo2tpu_torch.plonk.domain import make_domain
    return TorchEngine(make_domain(6, 3), setup(6, cache=False), "cpu")


def _blinded(cols, u, seed):
    """The prover's rows: each column's bit length before blinding, and
    the rows from u on drawn at full width."""
    rng = random.Random(seed)
    bits = [max(c).bit_length() for c in cols]
    return [c[:u] + [rng.randrange(R) for _ in c[u:]] for c in cols], bits


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_from_ints_stack_matches_the_joined_packing(engine, seed):
    n, u = 64, 57
    rng = random.Random(seed)
    cols = [[rng.getrandbits(w) for _ in range(u)] + [0] * (n - u)
            for w in (1, 12, 16, 35, 64)]
    cols += [[0] * n, [rng.randrange(R) for _ in range(u)] + [0] * (n - u),
             _mixed(seed, u) + [0] * (n - u)]
    cols, bits = _blinded(cols, u, seed)
    got = engine.from_ints_stack(cols, reduced=True, bits=bits,
                                 blind_start=u)
    want = _stack_by_join(cols, True, bits, u)
    assert [b <= 16 for b in bits] == [True] * 3 + [False] * 2 + [True] + [
        False] * 2
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_from_ints_stack_of_a_circuits_advice(engine):
    c = chip_smoke.golden_circuits()["timestamp_k6"][0]
    cs = ConstraintSystem()
    config = c.configure(cs)
    asn = Assignment(cs, 64, recording=False)
    c.synthesize(config, asn)
    cols, bits = _blinded([col.tolist() for col in asn.advice],
                          cs.usable_rows(64), 3)
    assert min(bits) <= 16 < max(bits)
    got = engine.from_ints_stack(cols, reduced=True, bits=bits,
                                 blind_start=cs.usable_rows(64))
    want = _stack_by_join(cols, True, bits, cs.usable_rows(64))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_from_ints_stack_reduces_unreduced_columns(engine):
    """reduced=False (the instances): values reduced mod R first, negative
    ones and those of R or more too."""
    cols = [[-1, R, R + 5, 2**256 + 3, 0, 7, -R - 2, 2**40],
            [3] * 8]
    got = engine.from_ints_stack(cols)
    want = _stack_by_join(cols, False, None, None)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert engine.to_ints(got[0]) == [v % R for v in cols[0]]
