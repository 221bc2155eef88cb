"""fold_add_any against the Pallas fold_add_any (interpret mode) and host
G1 arithmetic at an unaligned lane count, with identity, doubling and
inverse lanes.  Exact equality."""
import numpy as np
import torch

from halo2tpu.curves import g1 as G1
from halo2tpu.curves.jpoint import affine_to_device as jax_affine
from halo2tpu.fields.bn254 import G1_GEN
from halo2tpu.ops.pallas_ec import fold_add_any as pallas_fold_add_any
from halo2tpu.ops.pallas_ec import to_limb_major
from halo2tpu_torch import convert
from halo2tpu_torch.curves.jpoint import affine_to_device, device_to_affine
from halo2tpu_torch.ops import cuda_ec

torch.set_num_threads(1)


def _case(L=100):
    ps = [G1.scalar_mul(G1_GEN, 40 + i) for i in range(L - 2)] + [None] * 2
    qs = [G1.scalar_mul(G1_GEN, 140 + i) for i in range(L - 4)] + [
        ps[L - 4],             # doubling lane
        G1.neg(ps[L - 3]),     # inverse lane -> infinity
        None,                  # p=None, q=None -> infinity
        G1_GEN]                # p=None -> q
    return ps, qs


def test_fold_add_any_matches_pallas_and_g1():
    ps, qs = _case()
    L = len(ps)
    want = pallas_fold_add_any(
        to_limb_major(jax_affine(ps + [None] * 28))[:, :, :L],
        to_limb_major(jax_affine(qs + [None] * 28))[:, :, :L])
    got = cuda_ec.fold_add_any(affine_to_device(ps, "cpu"),
                               affine_to_device(qs, "cpu"))
    assert torch.equal(got, convert.points_from_limb_major(np.asarray(want)))
    assert device_to_affine(got) == [G1.add(p, q) for p, q in zip(ps, qs)]
