"""fold_mixed (MSM row step with the table gather fused in) against the
Pallas fold_mixed (interpret mode) and host G1 arithmetic: identity,
masked (digit 0), inverse and equal-point lanes.  Exact equality."""
import numpy as np
import jax.numpy as jnp
import torch

from halo2tpu.curves import g1 as G1
from halo2tpu.curves.jpoint import affine_to_device as jax_affine
from halo2tpu.fields.bn254 import G1_GEN
from halo2tpu.ops.pallas_ec import fold_mixed as pallas_fold_mixed
from halo2tpu.ops.pallas_ec import to_limb_major
from halo2tpu_torch import convert
from halo2tpu_torch.curves.jpoint import affine_to_device, device_to_affine
from halo2tpu_torch.fields.jfield import ints_to_limbs
from halo2tpu_torch.ops import cuda_ec
from halo2tpu_torch.ops.msm import TABLE_W

torch.set_num_threads(1)

L = 512


def _case():
    rng = np.random.default_rng(21)
    pts = [G1.scalar_mul(G1_GEN, int(rng.integers(1, 1 << 30)))
           for _ in range(L)]
    accs = [G1.scalar_mul(G1_GEN, int(rng.integers(1, 1 << 30)))
            for _ in range(L)]
    digits = [1 + i % 7 for i in range(L)]
    for i in range(0, 40):
        accs[i] = None                       # acc at infinity
    for i in range(40, 60):
        pts[i] = None                        # identity table entry
    for i in range(60, 80):
        digits[i] = 0                        # masked: digit 0
    for i in range(80, 100):
        accs[i] = pts[i]                     # equal points: doubling
    for i in range(100, 120):
        accs[i] = G1.neg(pts[i])             # inverse: identity
    return accs, pts, digits


def test_fold_mixed_matches_pallas_and_g1():
    accs, pts, digits = _case()
    bits = np.array([[d != 0 for d in digits]], np.uint32)
    want = pallas_fold_mixed(to_limb_major(jax_affine(accs)),
                             to_limb_major(jax_affine(pts)),
                             jnp.asarray(bits))
    # port: one row of C = L bases, B = 1 scalar vector, 1 digit plane
    table = affine_to_device([None] * L, "cpu").expand(
        TABLE_W, L, 3, 8).clone()
    ptab = affine_to_device(pts, "cpu")
    lane = torch.arange(L)
    dig = torch.tensor(digits)
    table[dig, lane] = ptab
    table[0] = affine_to_device([None] * L, "cpu")
    scalars = torch.from_numpy(ints_to_limbs(digits).copy())[None]
    got = cuda_ec.fold_mixed(affine_to_device(accs, "cpu"), table, scalars,
                             L, 1, 0, 1)
    assert torch.equal(got, convert.points_from_limb_major(np.asarray(want)))
    exp = []
    for a, p, d in zip(accs, pts, digits):
        exp.append(a if d == 0 else G1.add(a, p))
    assert device_to_affine(got) == exp


def test_fold_mixed_rows_and_planes():
    """Several rows and digit planes: the fold equals a plain per-lane sum
    of the gathered table entries."""
    rng = np.random.default_rng(22)
    C, B, P, npad = 4, 2, 3, 8
    base_pts = [G1.scalar_mul(G1_GEN, int(rng.integers(1, 1 << 20)))
                for _ in range(npad)]
    table = torch.stack([affine_to_device(
        [None if w == 0 else G1.scalar_mul(p, w) for p in base_pts], "cpu")
        for w in range(TABLE_W)])
    svals = [[int(rng.integers(0, 1 << 24)) for _ in range(npad)]
             for _ in range(B)]
    scalars = torch.from_numpy(np.stack([ints_to_limbs(s) for s in svals]))
    acc = affine_to_device([None] * (P * B * C), "cpu")
    got = device_to_affine(cuda_ec.fold_mixed(acc, table, scalars, C, P, 0,
                                              npad // C))
    for plane in range(P):
        for b in range(B):
            for c in range(C):
                want = None
                for r in range(npad // C):
                    d = (svals[b][r * C + c] >> (8 * plane)) & 0xFF
                    want = G1.add(want, G1.scalar_mul(base_pts[r * C + c], d))
                assert got[(plane * B + b) * C + c] == want
