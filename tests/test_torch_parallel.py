"""The multi-device building blocks (halo2tpu_torch/parallel/* and the
four-step of plonk/sharded.py) on meshes of CPU devices, held to halo2tpu's
on its 8 virtual CPU devices (tests/conftest.py): the split rule, the
twiddles, the flat four-step, the sharded and batched NTTs, the prove
core's gate; the sharded MSM against msm() and halo2tpu's host G1 sum
(halo2tpu/curves/g1.py, python ints: its JAX MSM is minutes on XLA:CPU);
the mesh's collectives and placements; the rotated-leaf rewrite of a field
program.  Inputs come from numpy seeds; equality is exact."""
import jax
import numpy as np
import pytest
import torch

from halo2tpu.curves import g1 as JG1
from halo2tpu.fields.bn254 import G1_GEN as JG1_GEN
from halo2tpu.fields.jfield import FR as JFR
from halo2tpu.parallel import dcn as jdcn
from halo2tpu.parallel import ntt as jpntt
from halo2tpu.parallel import pipeline as jpipe
from halo2tpu.parallel.mesh import make_mesh as jax_make_mesh
from halo2tpu.plonk import sharded as jsharded
from halo2tpu_torch.convert import from_jax_limbs
from halo2tpu_torch.curves.jpoint import affine_to_device, device_to_affine
from halo2tpu_torch.fields.bn254 import R, fr_root_of_unity, inv_mod
from halo2tpu_torch.fields.jfield import FR, ints_to_limbs
from halo2tpu_torch.ops import msm as tmsm
from halo2tpu_torch.ops.field_prog import field_prog_plain, unrotated
from halo2tpu_torch.ops.ntt import get_plan, intt, ntt
from halo2tpu_torch.parallel import dcn, pipeline
from halo2tpu_torch.parallel.mesh import (Mesh, Placement, Sharded,
                                          make_mesh, replicated,
                                          shard_leading)
from halo2tpu_torch.parallel.msm import make_sharded_msm, sharded_bit_partials
from halo2tpu_torch.parallel.ntt import make_sharded_ntt, twiddle_matrix
from halo2tpu_torch.plonk.sharded import _FlatFourStep, _pick_split

torch.set_num_threads(1)

@pytest.fixture
def jax8():
    """halo2tpu's side runs on tests/conftest.py's 8 virtual devices."""
    if len(jax.devices()) < 8:
        pytest.skip("halo2tpu's side needs 8 (virtual) devices")


def _cpu_mesh(d: int, axis: str = "shard") -> Mesh:
    return Mesh([torch.device("cpu")] * d, (axis,))


def _vals(seed: int, n: int) -> list:
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(31), "big") % R for _ in range(n)]


# -- split rule and twiddles --------------------------------------------------

def test_pick_split_cases():
    assert _pick_split(64, 8) == (8, 8)
    assert _pick_split(256, 8) == (16, 16)
    assert _pick_split(128, 8) == (8, 16)
    assert _pick_split(1 << 15, 8) == (128, 256)
    with pytest.raises(AssertionError):
        _pick_split(16, 8)


@pytest.mark.parametrize("ndev", [1, 2, 3, 4, 8])
def test_pick_split_matches_halo2tpu(ndev):
    for logn in range(4, 19):
        n = 1 << logn
        try:
            want = jsharded._pick_split(n, ndev)
        except AssertionError:
            with pytest.raises(AssertionError):
                _pick_split(n, ndev)
            continue
        assert _pick_split(n, ndev) == want, (n, ndev)


@pytest.mark.parametrize("n1,n2", [(8, 8), (16, 32)])
def test_twiddle_matrix_bytes_match_halo2tpu(n1, n2):
    omega = fr_root_of_unity((n1 * n2).bit_length() - 1)
    got = twiddle_matrix(n1, n2, omega)
    assert got.shape == (n1, n2, 8) and got.dtype == torch.int32
    assert torch.equal(got, from_jax_limbs(jpntt.twiddle_matrix(n1, n2,
                                                                omega)))


# -- the flat four-step -------------------------------------------------------

_JAX_FOURSTEP: dict = {}


def _jax_fourstep(k: int, inverse: bool):
    """halo2tpu's _FlatFourStep on make_mesh(8), once per (k, inverse)."""
    key = (k, inverse)
    if key not in _JAX_FOURSTEP:
        n, omega = 1 << k, fr_root_of_unity(k)
        fs = (jsharded._FlatFourStep(jax_make_mesh(8), "shard", n,
                                     inv_mod(omega, R), scale=inv_mod(n, R))
              if inverse else
              jsharded._FlatFourStep(jax_make_mesh(8), "shard", n, omega))
        _JAX_FOURSTEP[key] = from_jax_limbs(np.asarray(fs(JFR.encode(
            _vals(5, n)))))
    return _JAX_FOURSTEP[key]


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("k", [6, 10])
def test_flat_four_step_matches_halo2tpu_and_ntt(jax8, k, inverse):
    n, omega = 1 << k, fr_root_of_unity(k)
    x = FR.encode(_vals(5, n), "cpu")
    plan = get_plan(n, omega, "cpu")
    want = intt(plan, x) if inverse else ntt(plan, x)
    assert torch.equal(_jax_fourstep(k, inverse), want)
    for d in (1, 2, 4, 8):
        mesh = _cpu_mesh(d)
        fs = (_FlatFourStep(mesh, "shard", n, inv_mod(omega, R),
                            scale=inv_mod(n, R)) if inverse
              else _FlatFourStep(mesh, "shard", n, omega))
        got = fs(mesh.split(x))
        assert len(got) == d and torch.equal(torch.cat(got), want), d
        # a Sharded in, a Sharded out; stacked columns transform together
        sh = fs(shard_leading(mesh).put(x))
        assert isinstance(sh, Sharded) and torch.equal(sh.gather(), want)
        cols = torch.stack([x, x.flip(0)], 1)
        two = torch.cat(fs(mesh.split(cols)))
        assert torch.equal(two[:, 0], want)
        assert torch.equal(two[:, 1], intt(plan, x.flip(0)) if inverse
                           else ntt(plan, x.flip(0)))


def test_flat_four_step_rejects_small_domains():
    with pytest.raises(AssertionError):
        _FlatFourStep(_cpu_mesh(8), "shard", 32, fr_root_of_unity(5))
    with pytest.raises(AssertionError):
        _FlatFourStep(_cpu_mesh(3), "shard", 64, fr_root_of_unity(6))


# -- sharded and batched NTTs -------------------------------------------------

def test_sharded_ntt_matches_halo2tpu(jax8):
    n1 = n2 = 8
    omega = fr_root_of_unity(6)
    vals = _vals(3, n1 * n2)
    jrun = jpntt.make_sharded_ntt(jax_make_mesh(4), n1, n2, omega)
    want = from_jax_limbs(np.asarray(jrun(JFR.encode(vals).reshape(
        n1, n2, 16))))
    run = make_sharded_ntt(_cpu_mesh(4), n1, n2, omega)
    out = run(FR.encode(vals, "cpu").reshape(n1, n2, 8))
    assert out.placement.spec[0] == "shard" and len(out.blocks) == 4
    assert torch.equal(out.gather(), want)
    # out[k1, k2] = X[k2 * n1 + k1]
    X = ntt(get_plan(n1 * n2, omega, "cpu"), FR.encode(vals, "cpu"))
    assert torch.equal(out.gather().transpose(0, 1).reshape(-1, 8), X)


def test_batched_ntt_matches_halo2tpu(jax8):
    n1, n2, B = 8, 8, 2
    n = n1 * n2
    omega = fr_root_of_unity(6)
    vals = [_vals(10 + b, n) for b in range(B)]
    jrun = jdcn.make_batched_ntt(jdcn.make_mesh2d(2, 4), n1, n2, omega)
    want = from_jax_limbs(np.asarray(jrun(np.stack([
        np.asarray(JFR.encode(v)).reshape(n1, n2, 16) for v in vals]))))
    mesh = Mesh([[torch.device("cpu")] * 4] * 2, ("dcn", "ici"))
    run = dcn.make_batched_ntt(mesh, n1, n2, omega)
    x = torch.stack([FR.encode(v, "cpu").reshape(n1, n2, 8) for v in vals])
    out = run(x)
    assert out.placement.spec[:2] == ("dcn", "ici") and len(out.blocks) == 8
    assert torch.equal(out.gather(), want)
    plan = get_plan(n, omega, "cpu")
    for b in range(B):
        assert torch.equal(out.gather()[b].transpose(0, 1).reshape(n, 8),
                           ntt(plan, FR.encode(vals[b], "cpu")))


def test_batched_msm_partials_match_msm():
    """The batch split over "dcn" (2 rows), the fold lanes over "ici" (2
    shards a row), at n = 16, B = 2."""
    dev, limbs, want = _msm_case(16, 2)
    mesh = Mesh([["cpu"] * 2] * 2, ("dcn", "ici"))
    part = dcn.batched_msm_partials(mesh, dev, limbs)
    assert part.shape == (2, tmsm.SCALAR_BITS, 3, 8)
    assert tmsm._partials_to_affine(part) == want


def test_make_mesh2d_needs_enough_devices():
    with pytest.raises(RuntimeError):
        dcn.make_mesh2d(2, 4, device="cpu")
    m = dcn.make_mesh2d(1, 1, device="cpu")
    assert m.shape == {"dcn": 1, "ici": 1}


# -- sharded MSM --------------------------------------------------------------

_MSM_CASES: dict = {}


def _msm_case(n: int, B: int):
    """Bases (two identity, the rest halo2tpu's host G1 multiples of the
    generator), scalars (edge values in batch 0), their port tensors and
    msm()'s points, held to halo2tpu's host G1 MSM, once per (n, B)."""
    if (n, B) not in _MSM_CASES:
        rng = np.random.default_rng(n + B)
        pts = [JG1.scalar_mul(JG1_GEN, int(rng.integers(1, 1 << 40)))
               for _ in range(n - 2)] + [None] * 2
        svs = [[int.from_bytes(rng.bytes(32), "big") % R for _ in range(n)]
               for _ in range(B)]
        svs[0][0], svs[0][1] = R - 1, 1
        dev = affine_to_device(pts, "cpu")
        limbs = torch.from_numpy(np.stack([ints_to_limbs(s) for s in svs]))
        want = tmsm.msm(dev, svs)
        assert want == [JG1.msm(pts, s) for s in svs]
        _MSM_CASES[(n, B)] = (dev, limbs, want)
    return _MSM_CASES[(n, B)]


@pytest.mark.parametrize("ndev", [1, 2, 4])
@pytest.mark.parametrize("n,B", [(16, 1), (16, 2), (64, 1), (64, 2)])
def test_sharded_msm_matches_msm_and_host(n, B, ndev):
    dev, limbs, want = _msm_case(n, B)
    mesh = _cpu_mesh(ndev)
    part = sharded_bit_partials(mesh, dev, limbs)
    assert part.shape == (B, tmsm.SCALAR_BITS, 3, 8)
    assert tmsm._partials_to_affine(part) == want
    if n == 16:
        assert make_sharded_msm(mesh)(dev, limbs) == want


def test_sharded_msm_from_row_sharded_operands():
    """Operands already split by rows (the prove core's placements) give
    the same points, at a fold width wider than a block (C = 16 lanes,
    4-row blocks) and narrower (C = 4)."""
    dev, limbs, want = _msm_case(16, 2)
    mesh = _cpu_mesh(4)
    pts = Placement(mesh, ("shard",)).put(dev)
    sc = Placement(mesh, (None, "shard")).put(limbs)
    for fw in (None, 4):
        assert tmsm._partials_to_affine(sharded_bit_partials(
            mesh, pts, sc, fold_width=fw)) == want
    with pytest.raises(AssertionError):
        sharded_bit_partials(_cpu_mesh(4), dev, limbs, fold_width=2)
    with pytest.raises(ValueError):
        sharded_bit_partials(mesh, Placement(mesh, (None, "shard")).put(
            dev), limbs)


# -- the prove core -----------------------------------------------------------

def test_prove_core_gate_matches_halo2tpu_and_msm(jax8, monkeypatch):
    """make_sharded_prove_core at the dryrun's shape (n1 = D, n2 = 2D, D =
    4): the gate equals halo2tpu's (its MSM, minutes on XLA:CPU, stubbed
    out there) and the partials give halo2tpu's host G1 MSM."""
    D = 4
    n1, n2 = D, 2 * D
    n = n1 * n2
    omega = fr_root_of_unity(n.bit_length() - 1)
    coeffs = _vals(1, n)
    pts = [JG1.scalar_mul(JG1_GEN, 1 + i) for i in range(n)]
    scal = _vals(2, n)
    monkeypatch.setattr(jpipe, "sharded_bit_partials",
                        lambda *a, **k: None)
    jfn, jsh, jtw = jpipe.make_sharded_prove_core(jax_make_mesh(D), n1, n2,
                                                  omega)
    jx = jax.device_put(JFR.encode(coeffs).reshape(n1, n2, 16), jsh[1])
    jgate, _ = jfn(jax.device_put(jtw, jsh[0]), jx, np.zeros((n, 3, 16)),
                   None)
    want = from_jax_limbs(np.asarray(jgate))

    fn, shardings, tw = pipeline.make_sharded_prove_core(_cpu_mesh(D), n1,
                                                         n2, omega)
    assert torch.equal(tw, from_jax_limbs(np.asarray(jtw)))
    args = [s.put(a) for a, s in zip(
        (tw, FR.encode(coeffs, "cpu").reshape(n1, n2, 8),
         affine_to_device(pts, "cpu"),
         torch.from_numpy(ints_to_limbs(scal).copy())[None]), shardings)]
    gate, partials = fn(*args)
    assert torch.equal(gate.gather(), want)
    assert device_to_affine(tmsm._horner_device(partials)) == [
        JG1.msm(pts, scal)]


def test_scaling_report_line():
    """run_report's keys are halo2tpu's plus "device"; on one device
    every mesh is shards of it, and the line says so."""
    from halo2tpu_torch.parallel.scaling_report import run_report
    rep = run_report((1, 2), ntt_k=6, msm_n=16, device="cpu")
    assert set(rep) == {"devices", "backend", "ntt", "msm", "device",
                        "ntt_efficiency", "msm_efficiency"}
    assert rep["device"] == {"name": "cpu", "count": 1,
                             "shards_of_one": True}
    assert set(rep["ntt"]) == set(rep["msm"]) == {"1", "2"}
    assert rep["ntt_efficiency"]["1"] == rep["msm_efficiency"]["1"] == 1.0


# -- the mesh -----------------------------------------------------------------

def test_make_mesh_raises_for_missing_devices():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh(1)
    else:
        with pytest.raises(RuntimeError):
            make_mesh(torch.cuda.device_count() + 1)
    with pytest.raises(RuntimeError):
        make_mesh(2, device="cpu")
    m = make_mesh(1, device="cpu")
    assert m.flat == [torch.device("cpu")] and m.shape == {"shard": 1}
    # a mesh may repeat a device: four shards of one
    m4 = Mesh(["cpu"] * 4)
    assert m4.size == 4 and m4.first == torch.device("cpu")


def test_all_to_all_is_jax_tiled_all_to_all():
    """Block j of device d goes to device j, joined in source order."""
    mesh = _cpu_mesh(4)
    blocks = [torch.arange(24).reshape(2, 12) + 100 * d for d in range(4)]
    out = mesh.all_to_all(blocks, 1, 0)
    for j in range(4):
        assert torch.equal(out[j], torch.cat(
            [b[:, 3 * j:3 * j + 3] for b in blocks], 0))
    assert torch.equal(mesh.gather(mesh.split(blocks[1])), blocks[1])
    assert all(torch.equal(r, blocks[0]) for r in mesh.replicate(blocks[0]))


@pytest.mark.parametrize("spec", [("dcn", "ici"), ("ici", None, "dcn"),
                                  (None, "dcn"), ()])
def test_placement_put_gather_round_trip(spec):
    mesh = Mesh([["cpu"] * 2] * 2, ("dcn", "ici"))
    t = torch.arange(4 * 6 * 2).reshape(4, 6, 2)
    sh = Placement(mesh, spec).put(t)
    assert len(sh.blocks) == 4 and torch.equal(sh.gather(), t)
    sizes = [t.shape[k] // (2 if k < len(spec) and spec[k] else 1)
             for k in range(3)]
    assert all(tuple(b.shape) == tuple(sizes) for b in sh.blocks)
    assert torch.equal(shard_leading(mesh.sub("ici", 0), "ici").put(
        t).gather(), t)
    assert all(torch.equal(b, t) for b in replicated(mesh).put(t).blocks)


# -- the rotated-leaf rewrite -------------------------------------------------

def test_unrotated_program_per_block_matches_whole_vector():
    """A program loading two leaves at rotations -1, 0 and +1 (and the
    domain's far rotation n - 3): with its rotations moved into rotated
    leaves (ops/field_prog.py::unrotated), each 4-row block of a D = 4
    split computes its rows of the whole-vector result."""
    from halo2tpu_torch.plonk.quotient import _ld, _mul, _add, _sub, \
        compile_program
    n, D = 16, 4
    vals = [_mul(_ld("a", 0, rot=-1), _ld("b", 0, rot=1)),
            _add(_ld("a", 0), _ld("b", 0, rot=-1)),
            _sub(_ld("a", 0, rot=1), _ld("b", 0, rot=n - 3))]
    prog = compile_program(vals, n, fold=("y",), groups=2)
    flat, extra = unrotated(prog)
    a, b = ("a", 0), ("b", 0)
    assert sorted((prog.leaf_keys[i], r) for i, r in extra) == sorted(
        [(a, n - 1), (a, 1), (b, 1), (b, n - 1), (b, n - 3)])
    assert not flat.code[flat.code[:, 0] == 0][:, 3].any()
    leaves = [FR.encode(_vals(20 if k == a else 21, n), "cpu")
              for k in prog.leaf_keys]
    consts = FR.encode([int(v) for v in _vals(30, len(prog.const_keys))],
                       "cpu")
    want = field_prog_plain(FR, prog, leaves, consts, n)
    m = n // D
    rot = [torch.roll(leaves[i], -r, 0) for i, r in extra]
    got = torch.cat([field_prog_plain(
        FR, flat, [x[d * m:(d + 1) * m] for x in leaves + rot], consts, m)
        for d in range(D)])
    assert torch.equal(got, want)
