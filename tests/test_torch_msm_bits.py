"""The bit-serial MSM (ops/msm.py::msm and _bit_partials) on the CPU, where
every kernel wrapper runs its plain version: msm() against the host
G1.msm at n = 16, B = 2; the per-bit partial sums against their definition
and against halo2tpu's _bit_partials; the lane layout of the masks.
Exact equality."""
import numpy as np
import pytest
import torch

from halo2tpu_torch import convert
from halo2tpu_torch.curves import g1 as G1
from halo2tpu_torch.curves.jpoint import affine_to_device, device_to_affine
from halo2tpu_torch.fields.bn254 import G1_GEN, R
from halo2tpu_torch.fields.jfield import ints_to_limbs
from halo2tpu_torch.ops import msm as tmsm

torch.set_num_threads(1)

N, B = 16, 2


def _case(seed: int):
    rng = np.random.default_rng(seed)
    pts = [G1.scalar_mul(G1_GEN, int(rng.integers(1, 1 << 40)))
           for _ in range(N - 2)] + [None] * 2
    full = [int.from_bytes(rng.bytes(32), "big") % R for _ in range(N)]
    full[0], full[1] = R - 1, 1
    small = [int(v) for v in rng.integers(0, 256, N)]
    return pts, [full, small]


def test_msm_matches_g1_msm():
    pts, svs = _case(81)
    dev_pts = affine_to_device(pts, "cpu")
    assert tmsm.msm(dev_pts, svs) == [G1.msm(pts, s) for s in svs]
    # scalars are taken mod r; a zero batch gives the identity
    assert tmsm.msm(dev_pts, [[s + R for s in svs[0]], [0] * N]) == [
        G1.msm(pts, svs[0]), None]


def test_bit_partials_match_their_definition():
    """partial[b, bit] = sum of the bases whose scalar has that bit set;
    the fold uses C = 4, so 4 rows and a 2-round tail."""
    pts, svs = _case(82)
    limbs = torch.from_numpy(np.stack([ints_to_limbs(s) for s in svs]))
    part = tmsm._bit_partials(affine_to_device(pts, "cpu"), limbs,
                              fold_width=4)
    assert part.shape == (B, tmsm.SCALAR_BITS, 3, 8)
    got = device_to_affine(part)
    for b, s in enumerate(svs):
        for bit in range(tmsm.SCALAR_BITS):
            acc = None
            for p, v in zip(pts, s):
                if v >> bit & 1:
                    acc = G1.add(acc, p)
            assert got[b * tmsm.SCALAR_BITS + bit] == acc, (b, bit)


def test_bit_mask_lane_layout():
    """Lane (bit * B + b) * C + c holds bit `bit` of scalars[b, c], the
    layout of halo2tpu/ops/msm.py::_pallas_row_step."""
    rng = np.random.default_rng(83)
    C = 4
    svs = [[int.from_bytes(rng.bytes(32), "big") % R for _ in range(C)]
           for _ in range(B)]
    limbs = torch.from_numpy(np.stack([ints_to_limbs(s) for s in svs]))
    masks = tmsm._bit_masks(limbs).reshape(tmsm.SCALAR_BITS, B, C)
    want = [[[svs[b][c] >> bit & 1 for c in range(C)] for b in range(B)]
            for bit in range(tmsm.SCALAR_BITS)]
    assert masks.dtype == torch.uint8 and masks.tolist() == want


@pytest.mark.slow
def test_bit_partials_match_halo2tpu():
    """Jacobian partials equal halo2tpu's _bit_partials (its XLA route on
    the CPU, which compiles for about a minute there)."""
    import jax.numpy as jnp
    from halo2tpu.curves.jpoint import affine_to_device as jax_affine
    from halo2tpu.ops.msm import _bit_partials as jax_bit_partials
    pts, svs = _case(84)
    limbs = np.stack([ints_to_limbs(s) for s in svs])
    want = jax_bit_partials(jax_affine(pts), jnp.asarray(
        convert.to_jax_limbs(torch.from_numpy(limbs))))
    got = tmsm._bit_partials(affine_to_device(pts, "cpu"),
                             torch.from_numpy(limbs))
    assert np.array_equal(convert.to_jax_limbs(got), np.asarray(want))
