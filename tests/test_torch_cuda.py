"""Each CUDA kernel of halo2tpu_torch against its plain torch version on
the card (bitwise), and the bit-serial msm() against the host G1.msm.
Needs an NVIDIA GPU and nvcc: the tests skip where CUDA is absent.  This
file imports only the port (no jax, no halo2tpu), so it runs on the GPU
machine:
    python -m pytest tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

from halo2tpu_torch.curves import g1 as G1
from halo2tpu_torch.curves.jpoint import affine_to_device
from halo2tpu_torch.fields.bn254 import G1_GEN, Q, R
from halo2tpu_torch.fields.jfield import FQ, FR, ints_to_limbs
from halo2tpu_torch.ops import cuda_ec, cuda_field
from halo2tpu_torch.ops.msm import TABLE_W, msm

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _points(m, seed):
    rng = np.random.default_rng(seed)
    return [G1.scalar_mul(G1_GEN, int(rng.integers(1, 1 << 40)))
            for _ in range(m)]


@pytest.mark.parametrize("spec,p", [(FR, R), (FQ, Q)])
def test_mont_mul_kernel_matches_plain(dev, spec, p):
    rng = np.random.default_rng(1)
    vals = [int.from_bytes(rng.bytes(32), "big") % p for _ in range(4099)]
    edge = [p - 1, p - 2, 1, (1 << 254) % p]
    a = torch.from_numpy(ints_to_limbs(vals + edge * 4).copy()).to(dev)
    b = torch.from_numpy(ints_to_limbs(vals[::-1] + [e for e in edge
                                                     for _ in edge]).copy())
    b = b.to(dev)
    assert torch.equal(cuda_field.mont_mul(spec, a, b),
                       cuda_field.mont_mul_plain(spec, a, b))
    # broadcast operand
    assert torch.equal(cuda_field.mont_mul(spec, a, b[:1]),
                       cuda_field.mont_mul_plain(spec, a, b[:1]))


def test_point_kernels_match_plain(dev):
    ps = _points(297, 2) + [None] * 3
    qs = _points(296, 3) + [ps[0], G1.neg(ps[1]), None, G1_GEN]
    p = affine_to_device(ps, dev)
    q = affine_to_device(qs, dev)
    assert torch.equal(cuda_ec.fold_add_any(p, q),
                       cuda_ec.fold_add_any_plain(p, q))
    assert torch.equal(cuda_ec.fold_dbl_any(p), cuda_ec.fold_dbl_any_plain(p))
    C, B, P, npad = 8, 2, 4, 16
    bases = _points(npad, 4)
    table = torch.stack([affine_to_device(
        [None if w == 0 else G1.scalar_mul(pt, w) for pt in bases], dev)
        for w in range(TABLE_W)])
    rng = np.random.default_rng(5)
    scalars = torch.from_numpy(np.stack([ints_to_limbs(
        [int(rng.integers(0, 1 << 32)) for _ in range(npad)])
        for _ in range(B)])).to(dev)
    acc = affine_to_device(ps[:P * B * C], dev)
    args = (acc, table, scalars, C, P, 0, npad // C)
    assert torch.equal(cuda_ec.fold_mixed(*args),
                       cuda_ec.fold_mixed_plain(*args))


def test_bit_serial_kernels_match_plain(dev):
    C, L = 8, 8 * 64
    pts = _points(C - 1, 6) + [None]
    accs = _points(L - 3, 7) + [pts[0], G1.neg(pts[1]), None]
    acc = affine_to_device(accs, dev)
    pts_c = affine_to_device(pts, dev)
    bits = torch.from_numpy(np.random.default_rng(8).integers(
        0, 2, L).astype(np.uint8)).to(dev)
    bits[-3:] = 1
    before = cuda_ec.fold_mixed_tiled.launches
    assert torch.equal(cuda_ec.fold_mixed_tiled(acc, pts_c, bits),
                       cuda_ec.fold_mixed_tiled_plain(acc, pts_c, bits))
    assert cuda_ec.fold_mixed_tiled.launches == before + 1
    before = cuda_ec.fold_add.launches
    assert torch.equal(cuda_ec.fold_add(acc, acc.flip(0)),
                       cuda_ec.fold_add_plain(acc, acc.flip(0)))
    assert cuda_ec.fold_add.launches == before + 1
    # fold_add_any hands whole tiles to fold_add, which counts the launch
    before_any = cuda_ec.fold_add_any.launches
    assert torch.equal(cuda_ec.fold_add_any(acc, acc.flip(0)),
                       cuda_ec.fold_add_plain(acc, acc.flip(0)))
    assert cuda_ec.fold_add.launches == before + 2
    assert cuda_ec.fold_add_any.launches == before_any
    with pytest.raises(ValueError):
        cuda_ec.fold_add(acc[:L - 1], acc[:L - 1])


def test_msm_matches_host(dev):
    n = 64
    pts = _points(n - 1, 9) + [None]
    rng = np.random.default_rng(10)
    svs = [[int.from_bytes(rng.bytes(32), "big") % R for _ in range(n)],
           [R - 1] * n, [0] * n]
    assert msm(affine_to_device(pts, dev), svs) == [G1.msm(pts, s)
                                                    for s in svs]


def test_kernels_reject_mixed_devices(dev):
    a = FR.encode([1, 2, 3], dev)
    with pytest.raises(ValueError):
        cuda_field.mont_mul(FR, a, a.cpu())
