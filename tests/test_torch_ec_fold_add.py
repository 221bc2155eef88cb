"""fold_add (the tile-aligned entry to the add kernel) against the Pallas
fold_add (interpret mode) and host G1 arithmetic at L = 512: doubling,
inverse and identity lanes.  An unaligned L raises.  Exact equality."""
import numpy as np
import pytest
import torch

from halo2tpu.curves import g1 as G1
from halo2tpu.curves.jpoint import affine_to_device as jax_affine
from halo2tpu.fields.bn254 import G1_GEN
from halo2tpu.ops.pallas_ec import fold_add as pallas_fold_add
from halo2tpu.ops.pallas_ec import to_limb_major
from halo2tpu_torch import convert
from halo2tpu_torch.curves.jpoint import affine_to_device, device_to_affine
from halo2tpu_torch.ops import cuda_ec

torch.set_num_threads(1)

L = 512


def test_fold_add_matches_pallas_and_g1():
    rng = np.random.default_rng(71)
    ps = [G1.scalar_mul(G1_GEN, int(rng.integers(1, 1 << 30)))
          for _ in range(L)]
    qs = [G1.scalar_mul(G1_GEN, int(rng.integers(1, 1 << 30)))
          for _ in range(L)]
    for i in range(0, 16):
        qs[i] = ps[i]                        # doubling
    for i in range(16, 32):
        qs[i] = G1.neg(ps[i])                # inverse -> identity
    for i in range(32, 48):
        ps[i] = None                         # p identity -> q
    for i in range(40, 56):
        qs[i] = None                         # q identity -> p (both: q)
    want = pallas_fold_add(to_limb_major(jax_affine(ps)),
                           to_limb_major(jax_affine(qs)))
    p, q = affine_to_device(ps, "cpu"), affine_to_device(qs, "cpu")
    got = cuda_ec.fold_add(p, q)
    assert torch.equal(got, convert.points_from_limb_major(np.asarray(want)))
    assert torch.equal(got, cuda_ec.fold_add_any(p, q))
    assert device_to_affine(got) == [
        a if b is None else b if a is None else G1.add(a, b)
        for a, b in zip(ps, qs)]


@pytest.mark.parametrize("lanes", [1, 511, 513, 1000])
def test_fold_add_refuses_unaligned_lanes(lanes):
    p = affine_to_device([G1_GEN] * lanes, "cpu")
    with pytest.raises(ValueError, match="multiple of 512"):
        cuda_ec.fold_add(p, p)
