"""fold_mixed_tiled (one bit-serial MSM row step: C shared bases, a lane
mask) against the Pallas _fold_mixed_tiled (interpret mode) and host G1
arithmetic, at L = 128 lanes and C = 4: masked, identity-base, acc
identity, equal-point and inverse lanes, then a second step from the
Jacobian result.  Exact equality."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from halo2tpu.curves import g1 as G1
from halo2tpu.curves.jpoint import affine_to_device as jax_affine
from halo2tpu.fields.bn254 import G1_GEN
from halo2tpu.ops.pallas_ec import _fold_mixed_tiled, _pick_tile
from halo2tpu.ops.pallas_ec import to_limb_major
from halo2tpu_torch import convert
from halo2tpu_torch.curves.jpoint import affine_to_device, device_to_affine
from halo2tpu_torch.ops import cuda_ec

torch.set_num_threads(1)

C = 4


def _case(L: int, seed: int):
    """Bases (C - 1 points and the identity), accumulators and a mask with
    every lane kind; returns (pts, accs, bits, expected host result)."""
    rng = np.random.default_rng(seed)
    pts = [G1.scalar_mul(G1_GEN, int(rng.integers(1, 1 << 30)))
           for _ in range(C - 1)] + [None]
    accs = [G1.scalar_mul(G1_GEN, int(rng.integers(1, 1 << 30)))
            for _ in range(L)]
    bits = rng.integers(0, 2, L).astype(np.uint8)      # mask 0 lanes
    for i in range(0, 3 * C, C):
        accs[i], bits[i] = pts[0], 1                   # equal: doubling
        accs[i + 1], bits[i + 1] = G1.neg(pts[1]), 1   # inverse: identity
        accs[i + 2], bits[i + 2] = None, 1             # acc identity
        bits[i + 3] = 1                                # identity base
    want = [a if not b or pts[i % C] is None else G1.add(a, pts[i % C])
            for i, (a, b) in enumerate(zip(accs, bits))]
    return pts, accs, bits, want


def check_tiled(L: int, seed: int):
    pts, accs, bits, want = _case(L, seed)
    tile = _pick_tile(L, C)
    pts_j = to_limb_major(jax_affine(pts))
    acc_j = to_limb_major(jax_affine(accs))
    pts_t = affine_to_device(pts, "cpu")
    acc_t = affine_to_device(accs, "cpu")
    bits2 = np.random.default_rng(seed + 1).integers(0, 2, L).astype(
        np.uint8)
    for step_bits in (bits, bits2):
        acc_j = _fold_mixed_tiled(
            acc_j, pts_j, jnp.asarray(step_bits.astype(np.uint32)[None]),
            tile)
        acc_t = cuda_ec.fold_mixed_tiled(acc_t, pts_t,
                                         torch.from_numpy(step_bits))
        assert torch.equal(acc_t,
                           convert.points_from_limb_major(np.asarray(acc_j)))
        if step_bits is bits:
            assert device_to_affine(acc_t) == want
    assert torch.equal(cuda_ec.fold_mixed_tiled_plain(
        acc_t, pts_t, torch.from_numpy(bits)), cuda_ec.fold_mixed_tiled(
        acc_t, pts_t, torch.from_numpy(bits)))


def test_fold_mixed_tiled_matches_pallas_l128():
    check_tiled(128, 61)


@pytest.mark.parametrize("C,bits_len,bits_dtype,match", [
    (3, 8, torch.uint8, "does not divide"),
    (2, 8, torch.int32, "uint8 bits"),
    (2, 4, torch.uint8, "uint8 bits"),
])
def test_fold_mixed_tiled_rejects_bad_shapes(C, bits_len, bits_dtype, match):
    acc = affine_to_device([G1_GEN] * 8, "cpu")
    pts = affine_to_device([G1_GEN] * C, "cpu")
    bits = torch.ones(bits_len, dtype=bits_dtype)
    with pytest.raises(ValueError, match=match):
        cuda_ec.fold_mixed_tiled(acc, pts, bits)
