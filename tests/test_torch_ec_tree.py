"""The entries that replace chains of point-kernel launches, on the CPU
(their plain versions): fold_add_tree (the MSM tails' halving rounds),
fold_horner (the MSM Horner combines) and fold_mixed_tiled_rows (msm()'s
row steps).  Each against the chain of entries it replaces, against
halo2tpu (its jpoint.padd halving chain; its host Horner routes) and host
G1 arithmetic, with identity, doubling and inverse lanes.  Exact
equality."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from halo2tpu.curves import g1 as G1
from halo2tpu.curves.jpoint import affine_to_device as jax_affine
from halo2tpu.curves.jpoint import padd as jax_padd
from halo2tpu.fields.bn254 import G1_GEN, R
from halo2tpu.ops import msm as jmsm
from halo2tpu_torch import convert
from halo2tpu_torch.curves.jpoint import affine_to_device, device_to_affine
from halo2tpu_torch.fields.jfield import ints_to_limbs
from halo2tpu_torch.ops import cuda_ec
from halo2tpu_torch.ops import msm as tmsm

torch.set_num_threads(1)


def _points(m: int, seed: int):
    rng = np.random.default_rng(seed)
    return [G1.scalar_mul(G1_GEN, int(rng.integers(1, 1 << 30)))
            for _ in range(m)]


def _tree_case(G: int, width: int, seed: int):
    """G groups of `width` points; group 0 holds a doubling pair (lanes 0
    and half), an inverse pair (1 and 1 + half), an identity p (lane 2) and
    an identity q (lane 3 + half)."""
    pts = _points(G * width, seed)
    half = width // 2
    pts[half] = pts[0]
    pts[1 + half] = G1.neg(pts[1])
    pts[2] = pts[3 + half] = None
    return pts


@pytest.mark.parametrize("G,width", [(2, 8), (3, 16)])
def test_fold_add_tree_matches_chain_halo2tpu_and_g1(G, width):
    pts = _tree_case(G, width, 90 + width)
    acc = affine_to_device(pts, "cpu")
    got = cuda_ec.fold_add_tree(acc, G, width)
    assert got.shape == (G, 3, 8)
    # the chain of lanewise fold_add_any rounds it replaces
    chain, w = acc, width
    while w > 1:
        a4 = chain.reshape(G, w, 3, 8)
        chain = cuda_ec.fold_add_any(a4[:, :w // 2].reshape(-1, 3, 8),
                                     a4[:, w // 2:].reshape(-1, 3, 8))
        w //= 2
    assert torch.equal(got, chain)
    # halo2tpu: the same halving order with its jpoint.padd
    want, w = jax_affine(pts), width
    while w > 1:
        a4 = want.reshape(G, w, 3, 16)
        want = jax_padd(a4[:, :w // 2].reshape(-1, 3, 16),
                        a4[:, w // 2:].reshape(-1, 3, 16))
        w //= 2
    assert np.array_equal(convert.to_jax_limbs(got), np.asarray(want))
    sums = []
    for g in range(G):
        s = None
        for p in pts[g * width:(g + 1) * width]:
            s = G1.add(s, p)
        sums.append(s)
    assert device_to_affine(got) == sums


@pytest.mark.parametrize("G,width,lanes", [(2, 6, 12), (2, 8, 15),
                                           (0, 8, 8)])
def test_fold_add_tree_refuses_bad_groups(G, width, lanes):
    acc = affine_to_device([G1_GEN] * lanes, "cpu")
    with pytest.raises(ValueError, match="power of two"):
        cuda_ec.fold_add_tree(acc, G, width)


def _partials(B: int, planes: int, seed: int):
    """(B, planes, 3, 8) Jacobian partials (doubled points, Z != 1); lane 0
    has identity planes at the top and every third plane, lane 1 none."""
    pts = _points(B * planes, seed)
    for d in range(0, planes, 3):
        pts[d] = None
    pts[planes - 1] = pts[planes - 2] = None
    jac = cuda_ec.fold_dbl_any(affine_to_device(pts, "cpu"))
    return jac.reshape(B, planes, 3, 8)


@pytest.mark.parametrize("times,planes", [(8, tmsm.NUM_WINDOWS),
                                          (1, tmsm.SCALAR_BITS)])
def test_fold_horner_matches_chain_halo2tpu_and_g1(times, planes):
    parts = _partials(2, planes, 95 + times)
    got = cuda_ec.fold_horner(parts, times)
    assert got.shape == (2, 3, 8)
    # the chain it replaces: a fold_dbl_any(times) and a fold_add_any a plane
    chain = tmsm.identity_points((2,), "cpu")
    for d in range(planes - 1, -1, -1):
        chain = cuda_ec.fold_add_any(cuda_ec.fold_dbl_any(chain, times),
                                     parts[:, d].contiguous())
    assert torch.equal(got, chain)
    # halo2tpu's host routes of the same combine on the CPU
    jparts = jnp.asarray(convert.to_jax_limbs(parts))
    host = (jmsm._wpartials_to_affine if times == 8
            else jmsm._partials_to_affine)(jparts)
    assert device_to_affine(got) == host
    # by definition: sum of 2^(times * d) * partial[d]
    aff = device_to_affine(parts.reshape(-1, 3, 8))
    want = []
    for b in range(2):
        s = None
        for d in range(planes):
            p = aff[b * planes + d]
            if p is not None:
                s = G1.add(s, G1.scalar_mul(p, pow(2, times * d, R)))
        want.append(s)
    assert host == want
    # the module's combines take the entry
    if times == 8:
        assert device_to_affine(tmsm._horner_device_w(parts)) == host
    else:
        assert device_to_affine(tmsm._horner_device(parts)) == host


def test_fold_horner_refuses_bad_shapes():
    with pytest.raises(ValueError, match="planes"):
        cuda_ec.fold_horner(torch.zeros((2, 3, 8), dtype=torch.int32), 1)
    with pytest.raises(ValueError, match="times"):
        cuda_ec.fold_horner(torch.zeros((2, 4, 3, 8), dtype=torch.int32), 0)


def _rows_case(seed: int, C: int = 4, B: int = 2, rows: int = 4):
    """n = rows * C bases (base 3 the identity), B scalar vectors, and acc
    lanes of every kind at their first set row: equal, inverse, identity."""
    n = rows * C
    rng = np.random.default_rng(seed)
    pts = _points(n, seed)
    pts[3] = None
    svs = [[int.from_bytes(rng.bytes(32), "big") % R for _ in range(n)]
           for _ in range(B)]
    L = tmsm.SCALAR_BITS * B * C
    accs = _points(16, seed + 1)
    accs = [accs[i % 16] for i in range(L)]
    kinds = 0
    for lane in range(L):
        g, c = divmod(lane, C)
        bit, b = divmod(g, B)
        first = next((r for r in range(rows)
                      if svs[b][r * C + c] >> bit & 1), None)
        if first is None or pts[first * C + c] is None or lane % 5:
            continue
        base = pts[first * C + c]
        accs[lane] = [base, G1.neg(base), None][kinds % 3]
        kinds += 1
    assert kinds >= 30
    return pts, svs, accs


def test_fold_mixed_tiled_rows_matches_chain_and_g1():
    C, B, rows = 4, 2, 4
    pts, svs, accs = _rows_case(97, C, B, rows)
    points = affine_to_device(pts, "cpu")
    limbs = torch.from_numpy(np.stack([ints_to_limbs(s) for s in svs]))
    acc = affine_to_device(accs, "cpu")
    got = cuda_ec.fold_mixed_tiled_rows(acc, points, limbs, C, 0, rows)
    # the chain it replaces: a fold_mixed_tiled step a row with its masks
    chain = acc
    for r in range(rows):
        chain = cuda_ec.fold_mixed_tiled(
            chain, points[r * C:(r + 1) * C],
            tmsm._bit_masks(limbs[:, r * C:(r + 1) * C]))
    assert torch.equal(got, chain)
    # a row range: rows [1, 3) after rows [0, 1), then [3, 4)
    part = cuda_ec.fold_mixed_tiled_rows(acc, points, limbs, C, 0, 1)
    part = cuda_ec.fold_mixed_tiled_rows(part, points, limbs, C, 1, 3)
    part = cuda_ec.fold_mixed_tiled_rows(part, points, limbs, C, 3, rows)
    assert torch.equal(part, got)
    want = []
    for lane, a in enumerate(accs):
        g, c = divmod(lane, C)
        bit, b = divmod(g, B)
        for r in range(rows):
            if svs[b][r * C + c] >> bit & 1:
                a = G1.add(a, pts[r * C + c])
        want.append(a)
    assert device_to_affine(got) == want


@pytest.mark.parametrize("lanes,C,n_scalars,r0,r1,match", [
    (2 * 2 * 4, 3, 16, 0, 1, "nbits"),            # C does not divide n
    (2 * 2 * 4 + 1, 4, 16, 0, 1, "nbits"),        # L not nbits * B * C
    (257 * 2 * 4, 4, 16, 0, 1, "nbits"),          # more than 256 bits
    (2 * 2 * 4, 4, 8, 0, 1, "do not match"),      # scalars of other bases
    (2 * 2 * 4, 4, 16, 2, 5, "outside"),          # rows past the end
])
def test_fold_mixed_tiled_rows_refuses_bad_shapes(lanes, C, n_scalars, r0,
                                                  r1, match):
    acc = affine_to_device([G1_GEN] * lanes, "cpu")
    points = affine_to_device([G1_GEN] * 16, "cpu")
    limbs = torch.zeros((2, n_scalars, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match=match):
        cuda_ec.fold_mixed_tiled_rows(acc, points, limbs, C, r0, r1)
