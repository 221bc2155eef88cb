"""ShardedTorchEngine (plonk/sharded.py) on meshes of CPU devices: whole
proofs byte-identical to tests/golden/torch_port_proofs.json (halo2tpu's
HostEngine proofs) at halo2tpu's seeds and mesh sizes
(tests/test_sharded_proof.py: Timestamp k=6 at seed 27, RangeHarness k=7
at seed 22), D = 1 against TorchEngine, and each engine method the prover
calls against TorchEngine's on the same inputs (exact equality).  The
proofs commit one column a fold (msm_batch=1: the CPU runs the plain
bit-serial fold, 254 point additions a base); the padded groups of the
default batch are held to TorchEngine's commitments below."""
import json
import os

import numpy as np
import pytest
import torch

from chip_smoke import _configured_cs, golden_circuits
from halo2tpu_torch.fields.bn254 import R
from halo2tpu_torch.parallel.mesh import Mesh, Sharded
from halo2tpu_torch.plonk.domain import make_domain
from halo2tpu_torch.plonk.engine import TorchEngine
from halo2tpu_torch.plonk.expression import AdviceQuery, Constant, FixedQuery
from halo2tpu_torch.plonk.keygen import keygen
from halo2tpu_torch.plonk import prover
from halo2tpu_torch.plonk.prover import create_proof
from halo2tpu_torch.plonk.quotient import (_ld, _mul, _sub, compile_program,
                                           part_program)
from halo2tpu_torch.plonk.sharded import ShardedTorchEngine
from halo2tpu_torch.plonk.srs import setup
from halo2tpu_torch.plonk.verifier import verify_proof

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "torch_port_proofs.json")


def _mesh(d: int) -> Mesh:
    return Mesh([torch.device("cpu")] * d)


def _golden(name: str) -> str:
    with open(GOLDEN) as f:
        return json.load(f)[name]["proof"]


# -- whole proofs -------------------------------------------------------------

@pytest.mark.parametrize("name,ndev", [("timestamp_k6", 4), ("range_k7", 2)])
def test_sharded_proof_is_the_golden_and_verifies(name, ndev):
    c, k, inst, seed = golden_circuits()[name]
    srs = setup(k, cache=False)
    pk, vk = keygen(c, k, srs, device="cpu")
    eng = ShardedTorchEngine(vk.domain, srs, _mesh(ndev), msm_batch=1)
    proof = create_proof(pk, srs, c, inst, rng_seed=seed, engine=eng)
    assert proof.hex() == _golden(name)
    assert verify_proof(vk, srs, inst, proof)


def test_one_shard_equals_torch_engine():
    c, k, inst, seed = golden_circuits()["square_k4"]
    srs = setup(k, cache=False)
    pk, vk = keygen(c, k, srs, device="cpu")
    want = create_proof(pk, srs, c, inst, rng_seed=seed,
                        engine=TorchEngine(vk.domain, srs, "cpu"))
    eng = ShardedTorchEngine(vk.domain, srs, _mesh(1))
    assert create_proof(pk, srs, c, inst, rng_seed=seed, engine=eng) == want
    assert want.hex() == _golden("square_k4")
    # the pk state is kept per mesh: a second mesh gets its own
    st = prover._get_state(pk, eng)
    st2 = prover._get_state(pk, ShardedTorchEngine(vk.domain, srs, _mesh(2)))
    assert st2 is not st and len(st2.fixed_lag[0].blocks) == 2
    assert len(pk._torch_state_cache) == 3


def test_mesh_that_does_not_split_the_domain_raises():
    d = make_domain(4, 3)
    srs = setup(4, cache=False)
    with pytest.raises(AssertionError, match="too small"):
        ShardedTorchEngine(d, srs, _mesh(8))        # n = 16 < 8^2
    with pytest.raises(AssertionError, match="power of two"):
        ShardedTorchEngine(d, srs, _mesh(3))
    with pytest.raises(ValueError):
        ShardedTorchEngine(d, srs, Mesh([["cpu"] * 2] * 2, ("a", "b")))


# -- engine methods against TorchEngine ---------------------------------------

K = 5
N = 1 << K


@pytest.fixture(scope="module")
def engines():
    d = make_domain(K, 3)
    srs = setup(K, cache=False)
    ref = TorchEngine(d, srs, "cpu")
    return ref, {D: ShardedTorchEngine(d, srs, _mesh(D), msm_batch=2)
                 for D in (1, 2, 4)}


def _cols(seed: int, m: int, n: int = N) -> list:
    rng = np.random.default_rng(seed)
    return [[int.from_bytes(rng.bytes(32), "big") % R for _ in range(n)]
            for _ in range(m)]


def _same(ref_vecs, sh_vecs):
    assert len(ref_vecs) == len(sh_vecs)
    for r, s in zip(ref_vecs, sh_vecs):
        assert isinstance(s, Sharded)
        assert torch.equal(s.gather(), r)


@pytest.mark.parametrize("D", [1, 2, 4])
def test_representation_and_elementwise(engines, D):
    ref, sh = engines[0], engines[1][D]
    cols = _cols(1, 3)
    a, b = sh.from_ints(cols[0]), sh.from_ints(cols[1])
    ra, rb = ref.from_ints(cols[0]), ref.from_ints(cols[1])
    assert sh.to_ints(a) == cols[0]
    narrow = [[v % 16 for v in cols[0][:N - 4]] + cols[0][N - 4:],
              cols[1], [v % 65536 for v in cols[2][:N - 4]] + cols[2][N - 4:]]
    _same(ref.from_ints_stack(narrow, bits=[4, None, 16], blind_start=N - 4),
          sh.from_ints_stack(narrow, bits=[4, None, 16], blind_start=N - 4))
    u16 = np.stack([np.asarray(
        [[(v >> (16 * i)) & 0xFFFF for i in range(16)] for v in c], "<u2")
        for c in cols[:2]])
    _same(ref.from_packed_stack(list(u16)), sh.from_packed_stack(list(u16)))
    c = cols[2][0]
    _same([ref.add(ra, rb), ref.sub(ra, rb), ref.mul(ra, rb), ref.neg(ra),
           ref.scale(ra, c), ref.add_const(ra, c), ref.const_vec(c, N)],
          [sh.add(a, b), sh.sub(a, b), sh.mul(a, b), sh.neg(a),
           sh.scale(a, c), sh.add_const(a, c), sh.const_vec(c, N)])
    _same([ref.rotate(ra, k) for k in (1, -1, 5, -9, N - 1, 0, 8)],
          [sh.rotate(a, k) for k in (1, -1, 5, -9, N - 1, 0, 8)])
    assert sh.read_rows([a, b], N - 3) == ref.read_rows([ra, rb], N - 3)
    patch = [7, 8, 9, 10, 11]
    _same([ref.set_rows(ra, 6, patch)], [sh.set_rows(a, 6, patch)])
    assert sh.to_ints(a) == cols[0]              # the input is unchanged
    _same(ref.set_rows_batch([ra, rb], N - 6, [patch, patch[::-1]]),
          sh.set_rows_batch([a, b], N - 6, [patch, patch[::-1]]))
    _same(ref.assemble_z_batch([ra, rb], [3, 4], N - 3, [[1, 2, 3]] * 2),
          sh.assemble_z_batch([a, b], [3, 4], N - 3, [[1, 2, 3]] * 2))
    _same(ref.compact([ra, rb]), sh.compact([a, b]))
    assert sh.nbytes(a) == ref.nbytes(ra)
    mapping = np.stack([np.stack([np.arange(N) % 3, (np.arange(N) * 5) % N],
                                 -1)] * 3)
    _same(ref.sigma_from_mapping(mapping), sh.sigma_from_mapping(mapping))


@pytest.mark.parametrize("D", [1, 2, 4])
def test_transforms(engines, D):
    ref, sh = engines[0], engines[1][D]
    cols = _cols(2, 3)
    rv, sv = ref.from_ints_stack(cols), sh.from_ints_stack(cols)
    _same(ref.lagrange_to_coeff_stack(rv), sh.lagrange_to_coeff_stack(sv))
    _same([ref.lagrange_to_coeff(rv[0])], [sh.lagrange_to_coeff(sv[0])])
    _same(ref.coeff_to_lagrange_stack(rv), sh.coeff_to_lagrange_stack(sv))
    d = ref.d
    step = d.extended_n // d.n
    for q in range(step):
        _same(ref.coeff_to_part_stack(rv, q), sh.coeff_to_part_stack(sv, q))
    parts = [rv[i % 3] for i in range(step)]
    sparts = [sv[i % 3] for i in range(step)]
    _same(ref.parts_to_h_chunks(parts, d.quotient_poly_degree),
          sh.parts_to_h_chunks(sparts, d.quotient_poly_degree))


@pytest.mark.parametrize("D", [1, 2, 4])
def test_scans_and_sums(engines, D):
    ref, sh = engines[0], engines[1][D]
    cols = _cols(3, 70)
    rv, sv = ref.from_ints_stack(cols), sh.from_ints_stack(cols)
    coefs = _cols(4, 1, 70)[0]
    _same([ref.weighted_sum(rv, coefs)], [sh.weighted_sum(sv, coefs)])
    xs = [5, R - 1, 0, 123456789]
    pairs = [(rv[i], xs[i % 4]) for i in range(9)]
    spairs = [(sv[i], xs[i % 4]) for i in range(9)]
    assert sh.eval_polys(spairs) == ref.eval_polys(pairs)
    for a in (3, R - 2, 0, 1):
        _same([ref.div_linear(rv[0], a)], [sh.div_linear(sv[0], a)])
    # grand products over nonzero numerators and denominators
    nz = [[v or 1 for v in c] for c in cols[:6]]
    rn, sn = ref.from_ints_stack(nz), sh.from_ints_stack(nz)
    _same(ref.grand_products(rn[:3], rn[3:]),
          sh.grand_products(sn[:3], sn[3:]))


@pytest.mark.parametrize("D", [1, 2, 4])
def test_numerators_lookups_and_programs(engines, D):
    ref, sh = engines[0], engines[1][D]
    cols = _cols(5, 8)
    rv, sv = ref.from_ints_stack(cols), sh.from_ints_stack(cols)
    pows = [pow(ref.d.omega, i, R) for i in range(N)]
    ro, so = ref.from_ints(pows), sh.from_ints(pows)
    args = ([[0, 1, 2], [3]], [[4, 5, 6], [7]])
    r = ref.perm_numden_chunks([[rv[i] for i in c] for c in args[0]],
                               [[rv[i] for i in c] for c in args[1]], ro,
                               11, 13, [[1, 2, 3], [4]])
    s = sh.perm_numden_chunks([[sv[i] for i in c] for c in args[0]],
                              [[sv[i] for i in c] for c in args[1]], so,
                              11, 13, [[1, 2, 3], [4]])
    _same(r[0] + r[1], s[0] + s[1])
    r = ref.lookup_numden(rv[:2], rv[2:4], rv[4:6], rv[6:8], 11, 13)
    s = sh.lookup_numden(sv[:2], sv[2:4], sv[4:6], sv[6:8], 11, 13)
    _same(r[0] + r[1], s[0] + s[1])
    # permuted pairs: inputs drawn from the table, and one that is not
    table = [i * 7 % 50 for i in range(N)]
    ins = [table[(3 * i) % 20] for i in range(N)]
    t_r, t_s = ref.from_ints(table), sh.from_ints(table)
    i_r, i_s = ref.from_ints(ins), sh.from_ints(ins)
    bad_r = ref.from_ints(ins[:-6] + [999] * 6)
    bad_s = sh.from_ints(ins[:-6] + [999] * 6)
    ra, rs, rf = ref.permute_lookup_batch([i_r, bad_r], [t_r, t_r], N - 4, 8)
    sa, ss, sf = sh.permute_lookup_batch([i_s, bad_s], [t_s, t_s], N - 4, 8)
    _same(ra + rs, sa + ss)
    assert [bool(f) for f in sf] == [bool(f) for f in rf] == [False, True]
    sh.check_lookup_fails(sf[:1])
    with pytest.raises(ValueError, match="lookup failure"):
        sh.check_lookup_fails(sf)
    # theta-compression (a field program, the sharded engine's block by
    # block), against host ints; a lone column query is its column; and a
    # program with rotations
    exprs = [AdviceQuery(0, 0) * FixedQuery(0, 1),
             AdviceQuery(1, -1) + Constant(5), AdviceQuery(0, 2),
             AdviceQuery(1, 0)]
    vals = {"advice": [rv[0], rv[1]], "fixed": [rv[2]]}
    svals = {"advice": [sv[0], sv[1]], "fixed": [sv[2]]}
    a0, a1, f0 = cols[0], cols[1], cols[2]
    host = [(a0[i] * f0[(i + 1) % N], a1[(i - 1) % N] + 5, a0[(i + 2) % N],
             a1[i]) for i in range(N)]
    for ks in ((0, 1, 2), (0,), (2,), (1, 3)):
        ex = [exprs[k] for k in ks]
        got = ref.compress_exprs(ex, vals, 17)
        assert ref.to_ints(got) == [
            sum(pow(17, len(ks) - 1 - j, R) * h[k]
                for j, k in enumerate(ks)) % R for h in host]
        _same([got], [sh.compress_exprs(ex, svals, 17)])
    assert ref.compress_exprs(exprs[3:], vals, 17) is rv[1]
    assert sh.compress_exprs(exprs[3:], svals, 17) is sv[1]
    prog = compile_program([_mul(_ld("a", 0, rot=-1), _ld("b", 0, rot=3)),
                            _sub(_ld("b", 0), _ld("a", 0, rot=N - 5))], N,
                           fold=("y",))
    leaves = {("a", 0): 0, ("b", 0): 1}
    consts = ref._encode(_cols(6, 1, len(prog.const_keys))[0])
    _same([ref.run_program(prog, [rv[leaves[k]] for k in prog.leaf_keys],
                           consts)],
          [sh.run_program(prog, [sv[leaves[k]] for k in prog.leaf_keys],
                          consts)])


def test_quotient_part_program_runs_block_by_block(engines):
    """A circuit's whole part program (RangeHarness: gates, permutation
    and lookup rules, rotations of +1, -1 and -(b + 1)) on D = 4 blocks
    equals its run on TorchEngine."""
    cs = _configured_cs(golden_circuits()["range_k7"][0])
    prog = part_program(cs, N)
    ref, sh = engines[0], engines[1][4]
    cols = _cols(7, len(prog.leaf_keys))
    rv, sv = ref.from_ints_stack(cols), sh.from_ints_stack(cols)
    consts = ref._encode(_cols(8, 1, len(prog.const_keys))[0])
    assert any(r != 0 for r in prog.code[prog.code[:, 0] == 0][:, 3])
    _same([ref.run_program(prog, rv, consts)],
          [sh.run_program(prog, sv, consts)])


@pytest.mark.parametrize("D", [1, 2, 4])
def test_commitments_in_padded_groups(engines, D):
    """msm_batch = 2 over three columns: two groups, the second padded with
    a zero column; the points are TorchEngine's windowed commitments."""
    ref, sh = engines[0], engines[1][D]
    cols = _cols(9, 3)
    rv, sv = ref.from_ints_stack(cols), sh.from_ints_stack(cols)
    assert sh.commit_lagrange_batch(sv) == ref.commit_lagrange_batch(rv)
    assert sh.commit_batch(sv[:1]) == ref.commit_batch(rv[:1])
    assert sh.commit_batch([]) == []
