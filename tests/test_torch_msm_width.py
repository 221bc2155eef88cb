"""The windowed fold's width rule (ops/msm.py::fold_width) and the
commitments it gives: MSMContext at widths other than the fixed 256
against halo2tpu's host G1.msm, and against the same vectors folded at
the fixed width.  Exact equality."""
import numpy as np
import pytest
import torch

from halo2tpu.curves import g1 as G1
from halo2tpu.fields.bn254 import G1_GEN, R
from halo2tpu_torch.fields.jfield import ints_to_limbs
from halo2tpu_torch.ops import msm as tmsm

torch.set_num_threads(1)

N = 64


@pytest.mark.parametrize("planes,batch,npad,want", [
    (32, 8, 1 << 15, 256),     # a full batch: 65,536 lanes at C = 256
    (8, 8, 1 << 15, 1024),     # narrow advice columns
    (32, 1, 1 << 15, 2048),    # a coefficient commit
    (32, 3, 1 << 15, 1024),    # a short last batch: 98,304 lanes
    (8, 8, 512, 512),          # capped at npad (a tail context)
    (32, 1, 256, 256),
    (32, 8, 64, 64),           # npad below the least width
    (1, 1, 1 << 20, 1 << 16),
])
def test_fold_width_rule(planes, batch, npad, want):
    C = tmsm.fold_width(planes, batch, npad)
    assert C == want
    assert npad % C == 0
    assert planes * batch * C >= tmsm.LANE_TARGET or C == npad


def test_fold_width_arguments():
    assert tmsm.fold_width(8, 2, N, lane_target=256, min_width=4) == 16
    assert tmsm.fold_width(32, 1, N, lane_target=256, min_width=4) == 8
    assert tmsm.fold_width(32, 1, N, lane_target=0, min_width=4) == 4
    assert tmsm.fold_width(8, 2, N) == N


@pytest.fixture(scope="module")
def ctx_case():
    rng = np.random.default_rng(41)
    pts = [G1.scalar_mul(G1_GEN, int(rng.integers(1, 1 << 40)))
           for _ in range(N - 3)] + [None] * 3
    ctx = tmsm.MSMContext(pts, device="cpu")
    small = [[int(rng.integers(0, 1 << 62)) for _ in range(N)]
             for _ in range(2)]
    full = [[int.from_bytes(rng.bytes(32), "big") % R for _ in range(N)]]
    full[0][:3] = [R - 1, 0, 1]
    return pts, ctx, small, full


def _limbs(vectors):
    return torch.from_numpy(np.stack([ints_to_limbs(v) for v in vectors]))


def _widths(monkeypatch):
    """Record the C of every _partials_fused call."""
    seen = []
    inner = tmsm._partials_fused

    def spy(table, limbs, C, P=tmsm.NUM_WINDOWS):
        seen.append(C)
        return inner(table, limbs, C, P)
    monkeypatch.setattr(tmsm, "_partials_fused", spy)
    return seen


def _commit(ctx, limbs, planes, **width):
    part = ctx.partials(limbs, planes=planes, **width)
    full = torch.nn.functional.pad(
        part, (0, 0, 0, 0, 0, tmsm.NUM_WINDOWS - planes))
    return ctx.finalize([full])


@pytest.mark.parametrize("kind", ["narrow", "coefficient"])
def test_commit_at_rule_width_matches_g1_and_fixed_width(ctx_case, kind,
                                                         monkeypatch):
    """A narrow batch (planes = 8, B = 2) and a B = 1 full-width batch with
    a lane target of 256 and a least width of 4: C = 16 and 8 (4 and 8
    rows, so a tree-fold of 16 and 8 lanes), not the fixed C = 64."""
    pts, ctx, small, full = ctx_case
    vectors, planes = (small, 8) if kind == "narrow" else (full, 32)
    limbs = _limbs(vectors)
    seen = _widths(monkeypatch)
    got = _commit(ctx, limbs, planes, lane_target=256, min_width=4)
    assert got == [G1.msm(pts, v) for v in vectors]
    assert _commit(ctx, limbs, planes) == got          # the fixed width
    assert seen == [16 if kind == "narrow" else 8, N]
