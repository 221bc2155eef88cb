"""NTT against halo2tpu/ops/ntt.py and the host NTT; the windowed MSM
(window table, MSMContext.commit, narrow digit planes) against host G1
arithmetic.  Exact equality."""
import numpy as np
import pytest
import torch

from halo2tpu.curves import g1 as G1
from halo2tpu.fields.bn254 import G1_GEN, R, fr_root_of_unity
from halo2tpu.fields.jfield import FR as JFR
from halo2tpu.ops import ntt as jntt
from halo2tpu.plonk.polyops import ntt as host_ntt
from halo2tpu_torch import convert
from halo2tpu_torch.curves.jpoint import affine_to_device, device_to_affine
from halo2tpu_torch.fields.jfield import FQ, FR, ints_to_limbs
from halo2tpu_torch.ops import ntt as tntt
from halo2tpu_torch.ops.msm import (NUM_WINDOWS, TABLE_W, MSMContext,
                                    precompute_window_table)

torch.set_num_threads(1)


@pytest.mark.parametrize("k", [4, 6])
def test_ntt_intt_match_jax_and_host(k):
    n = 1 << k
    omega = fr_root_of_unity(k)
    rng = np.random.default_rng(30 + k)
    vals = [int.from_bytes(rng.bytes(32), "big") % R for _ in range(n)]
    a_j = JFR.encode(vals)
    a_t = convert.from_jax_limbs(np.asarray(a_j))
    plan_j, plan_t = jntt.get_plan(n, omega), tntt.get_plan(n, omega, "cpu")
    fwd = tntt.ntt(plan_t, a_t)
    assert np.array_equal(convert.to_jax_limbs(fwd),
                          np.asarray(jntt.ntt(plan_j, a_j)))
    assert FR.decode(fwd) == host_ntt(vals, omega)
    back = tntt.intt(plan_t, fwd)
    assert np.array_equal(convert.to_jax_limbs(back),
                          np.asarray(jntt.intt(plan_j, jntt.ntt(plan_j, a_j))))
    assert FR.decode(back) == vals
    # batch columns: (n, 3, 8) transforms each column
    cols = torch.stack([a_t, fwd, back], dim=1)
    out = tntt.ntt(plan_t, cols)
    for j in range(3):
        assert torch.equal(out[:, j], tntt.ntt(plan_t, cols[:, j]))


def test_window_table_entries():
    n = 8
    pts = [G1.scalar_mul(G1_GEN, 5 + i) for i in range(n - 1)] + [None]
    tab = precompute_window_table(affine_to_device(pts, "cpu"))
    assert tab.shape == (TABLE_W, n, 3, 8)
    for w in (0, 1, 2, 3, 7, 128, 200, 255):
        got = device_to_affine(tab[w])
        assert got == [None if (p is None or w == 0) else G1.scalar_mul(p, w)
                       for p in pts], f"window {w}"
    # every entry is affine: Z is Montgomery 1 or 0
    z = tab[:, :, 2]
    one = FQ.const("one_mont", "cpu")
    assert bool(((z == one).all(-1) | (z == 0).all(-1)).all())


def test_msm_commit_matches_g1_msm():
    n = 16
    rng = np.random.default_rng(31)
    pts = [G1.scalar_mul(G1_GEN, int(rng.integers(1, 1 << 40)))
           for _ in range(n)]
    ctx = MSMContext(pts, device="cpu")
    svs = [[int.from_bytes(rng.bytes(32), "big") % R for _ in range(n)]
           for _ in range(2)] + [[0] * n]
    assert ctx.commit_batch(svs) == [G1.msm(pts, sv) for sv in svs]
    assert ctx.commit(svs[0]) == G1.msm(pts, svs[0])


def test_msm_narrow_planes():
    """planes=8: scalars < 2^64 fold only their 8 live digit planes."""
    n = 16
    rng = np.random.default_rng(32)
    pts = [G1.scalar_mul(G1_GEN, int(rng.integers(1, 1 << 40)))
           for _ in range(n - 3)] + [None] * 3
    ctx = MSMContext(pts, device="cpu")
    small = [[int(rng.integers(0, 1 << 62)) for _ in range(ctx.n)]
             for _ in range(2)]
    limbs = torch.from_numpy(np.stack([ints_to_limbs(s) for s in small]))
    part = ctx.partials(limbs, planes=8)
    assert part.shape == (2, 8, 3, 8)
    full = torch.nn.functional.pad(part, (0, 0, 0, 0, 0, NUM_WINDOWS - 8))
    assert ctx.finalize([full]) == [G1.msm(pts, s) for s in small]
