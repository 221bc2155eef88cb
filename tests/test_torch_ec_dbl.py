"""fold_dbl_any against the Pallas fold_dbl_any (interpret mode) and host
G1 doubling, identity lanes included.  Exact equality."""
import numpy as np
import torch

from halo2tpu.curves import g1 as G1
from halo2tpu.curves.jpoint import affine_to_device as jax_affine
from halo2tpu.fields.bn254 import G1_GEN
from halo2tpu.ops.pallas_ec import fold_dbl_any as pallas_fold_dbl_any
from halo2tpu.ops.pallas_ec import to_limb_major
from halo2tpu_torch import convert
from halo2tpu_torch.curves.jpoint import affine_to_device, device_to_affine
from halo2tpu_torch.ops import cuda_ec

torch.set_num_threads(1)


def test_fold_dbl_any_matches_pallas_and_g1():
    L = 100
    ps = [G1.scalar_mul(G1_GEN, 7 + 3 * i) for i in range(L - 3)] + [None] * 3
    want = pallas_fold_dbl_any(to_limb_major(jax_affine(ps)))
    got = cuda_ec.fold_dbl_any(affine_to_device(ps, "cpu"))
    assert torch.equal(got, convert.points_from_limb_major(np.asarray(want)))
    assert device_to_affine(got) == [G1.add(p, p) for p in ps]
    # chained: doubling a doubled (Z != 1) batch
    assert device_to_affine(cuda_ec.fold_dbl_any(got)) == [
        G1.scalar_mul(p, 4) if p else None for p in ps]
