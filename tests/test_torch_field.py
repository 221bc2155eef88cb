"""halo2tpu_torch field arithmetic against halo2tpu's jfield (XLA on CPU)
and the Pallas mont_mul (interpret mode), and the JAX <-> port converters.
Exact equality: these are finite-field values."""
import numpy as np
import pytest
import torch

from halo2tpu.fields import jfield as jjf
from halo2tpu.fields.bn254 import Q, R
from halo2tpu.ops.pallas_field import kc_for, mont_mul_flat
from halo2tpu_torch import convert
from halo2tpu_torch.fields import jfield as tjf
from halo2tpu_torch.ops import cuda_field

torch.set_num_threads(1)

SPECS = {"fr": (R, jjf.FR, tjf.FR), "fq": (Q, jjf.FQ, tjf.FQ)}


def _vals(rng, p, n):
    return [int.from_bytes(rng.bytes(32), "big") % p for _ in range(n)]


def _pair(spec_j, vals):
    """The same Montgomery values as a JAX array and a port tensor."""
    a = spec_j.encode(vals)
    return a, convert.from_jax_limbs(np.asarray(a))


def _same(jax_arr, t):
    assert np.array_equal(np.asarray(jax_arr),
                          convert.to_jax_limbs(t).reshape(
                              np.asarray(jax_arr).shape))


@pytest.mark.parametrize("field", ["fr", "fq"])
def test_mont_mul_matches_jfield_and_pallas(field):
    p, sj, st = SPECS[field]
    rng = np.random.default_rng(11)
    edge = [p - 1, p - 2, 1, (1 << 254) % p]
    xs = [x for x in edge for _ in edge] + _vals(rng, p, 48)
    ys = [y for _ in edge for y in edge] + _vals(rng, p, 48)
    aj, at = _pair(sj, xs)
    bj, bt = _pair(sj, ys)
    got = tjf.mont_mul(st, at, bt)
    _same(jjf.mont_mul(sj, aj, bj), got)
    _same(mont_mul_flat(kc_for(p), aj, bj), got)
    assert st.decode(got) == [x * y % p for x, y in zip(xs, ys)]


def test_mont_mul_raw_edge_operands():
    """Raw (non-encoded) edge operands: every pair of {p-1, p-2, 1,
    2^254 mod p} gives a * b * 2^-256 mod p."""
    for p, _, st in SPECS.values():
        edge = [p - 1, p - 2, 1, (1 << 254) % p]
        a = torch.from_numpy(tjf.ints_to_limbs(
            [x for x in edge for _ in edge]).copy())
        b = torch.from_numpy(tjf.ints_to_limbs(
            [y for _ in edge for y in edge]).copy())
        rinv = pow(1 << 256, -1, p)
        assert tjf.limbs_to_ints(cuda_field.mont_mul_plain(st, a, b)) == [
            x * y * rinv % p for x in edge for y in edge]


@pytest.mark.parametrize("field", ["fr", "fq"])
def test_add_sub_neg_match_jfield(field):
    p, sj, st = SPECS[field]
    rng = np.random.default_rng(12)
    xs = [0, 1, p - 1, p - 2] + _vals(rng, p, 28)
    ys = [p - 1, 0, p - 1, 2] + _vals(rng, p, 28)
    aj, at = _pair(sj, xs)
    bj, bt = _pair(sj, ys)
    _same(jjf.add(sj, aj, bj), tjf.add(st, at, bt))
    _same(jjf.sub(sj, aj, bj), tjf.sub(st, at, bt))
    _same(jjf.neg(sj, aj), tjf.neg(st, at))


def test_scans_match_jfield():
    rng = np.random.default_rng(13)
    xs = [1 + v for v in _vals(rng, R - 1, 40)]
    aj, at = _pair(jjf.FR, xs)
    _same(jjf.batch_inv_scan(jjf.FR, aj), tjf.batch_inv_scan(tjf.FR, at))
    _same(jjf._prefix_prod(jjf.FR, aj), tjf._prefix_prod(tjf.FR, at))
    _same(jjf.suffix_sum_mod(jjf.FR, aj), tjf.suffix_sum_mod(tjf.FR, at))


def test_prefix_prod_batched_columns():
    """The blocked scan runs over axis 0 with batch columns behind it."""
    rng = np.random.default_rng(14)
    cols = [[1 + v for v in _vals(rng, R - 1, 37)] for _ in range(3)]
    t = torch.stack([tjf.FR.encode(c, "cpu") for c in cols], dim=1)
    out = tjf._prefix_prod(tjf.FR, t)
    for j, c in enumerate(cols):
        acc, want = 1, []
        for v in c:
            acc = acc * v % R
            want.append(acc)
        assert tjf.FR.decode(out[:, j]) == want


def test_encodings():
    rng = np.random.default_rng(15)
    vals = _vals(rng, R, 24)
    u16 = tjf.ints_to_limbs16(vals)
    assert tjf.limbs_to_ints(u16) == vals
    assert tjf.limbs_to_ints(tjf.ints_to_limbs(vals)) == vals
    assert tjf.limbs_to_int(tjf.int_to_limbs(vals[0])) == vals[0]
    assert tjf.FR.decode(tjf.FR.encode_packed(u16, "cpu")) == vals
    _same(jjf.FR.encode_packed(u16), tjf.FR.encode_packed(u16, "cpu"))
    # narrow wire: small values on rows < split, full limbs after
    small = [int(v) for v in rng.integers(0, 1 << 16, 12)]
    main = np.array([small[:8] + [0] * 4], "<u2")
    tail = tjf.ints_to_limbs16(vals[:4])[None]
    got = tjf.FR.encode_narrow_stack(main, tail, 8, "cpu")
    _same(jjf.FR.encode_narrow_stack(main, tail, 8), got)
    assert tjf.FR.decode(got[0]) == small[:8] + vals[:4]


def test_convert_round_trips(tmp_path):
    rng = np.random.default_rng(16)
    arr = rng.integers(0, 1 << 16, (5, 3, 16), dtype=np.uint32)
    t = convert.from_jax_limbs(arr)
    assert t.shape == (5, 3, 8) and t.dtype == torch.int32
    assert np.array_equal(convert.to_jax_limbs(t), arr)
    lm = np.ascontiguousarray(np.transpose(arr, (1, 2, 0)))   # (3, 16, 5)
    pts = convert.points_from_limb_major(lm)
    assert torch.equal(pts, t)
    assert np.array_equal(convert.points_to_limb_major(pts), lm)
    tab = rng.integers(0, 1 << 16, (3, 256, 16, 4), dtype=np.uint16)
    pt = convert.msm_table_from_jax(tab)
    assert pt.shape == (256, 4, 3, 8)
    assert np.array_equal(convert.msm_table_to_jax(pt), tab)
    # entry (w, i, coord) holds the JAX table's limbs of that entry
    assert np.array_equal(convert.to_jax_limbs(pt[7, 2, 1]), tab[1, 7, :, 2])
    # halo2tpu's on-disk table file (.cache/msm_table_<tag>.npy)
    np.save(tmp_path / "msm_table_x.npy", tab)
    assert torch.equal(convert.load_jax_msm_table(
        str(tmp_path / "msm_table_x.npy"), "cpu"), pt)
