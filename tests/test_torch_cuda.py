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
from halo2tpu_torch.fields.jfield import (FQ, FR, ints_to_limbs, limbs_to_ints,
                                          neg)
from halo2tpu_torch.fields.bn254 import fr_root_of_unity
from halo2tpu_torch.ops import cuda_ec, cuda_field, field_prog
from halo2tpu_torch.ops import ntt as tntt
from halo2tpu_torch.ops.msm import TABLE_W, msm, precompute_window_table
from halo2tpu_torch.plonk import expression as ex
from halo2tpu_torch.plonk import quotient
from halo2tpu_torch.plonk.circuit import ConstraintSystem

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


@pytest.mark.parametrize("spec,p", [(FR, R), (FQ, Q)])
def test_mont_pow_kernel_matches_plain(dev, spec, p):
    """One launch a call at 1, 16, 80 and 4,097 lanes (edge values 0, 1,
    p - 1 and R mod p first), exponents 0, 1, 2, 65537, 2^200, p - 2 and
    2^256 - 1."""
    rng = np.random.default_rng(4)
    edge = [0, 1, p - 1, (1 << 256) % p]
    vals = edge + [int.from_bytes(rng.bytes(32), "big") % p
                   for _ in range(4093)]
    a = torch.from_numpy(ints_to_limbs(vals).copy()).to(dev)
    for lanes in (1, 16, 80, 4097):
        for e in (0, 1, 2, 65537, 1 << 200, p - 2, (1 << 256) - 1):
            before = cuda_field.mont_pow.launches
            got = cuda_field.mont_pow(spec, a[:lanes], e)
            assert cuda_field.mont_pow.launches == before + 1
            assert torch.equal(got, cuda_field.mont_pow_plain(
                spec, a[:lanes], e)), (lanes, e)
    inv = cuda_field.mont_pow(spec, a[1:], p - 2)
    assert torch.equal(cuda_field.mont_mul(spec, inv, a[1:]),
                       spec.const("one_mont", dev).expand(a[1:].shape))


def _wrap_gate():
    a, f = ex.AdviceQuery(0, -3), ex.FixedQuery(1, 5)
    return a * f + ex.Constant(7) - ex.InstanceQuery(0, -1) * ex.AdviceQuery(
        2, 2) * a


def _run_both(dev, prog, n, seed, stride_cols=3):
    """prog through the kernel and the plain interpreter on random leaves,
    each leaf a strided column view of an (n, stride_cols, 8) stack."""
    g = torch.Generator().manual_seed(seed)
    m = len(prog.leaf_keys)
    stacks = torch.randint(-2**31, 2**31, (n, m * stride_cols, 8),
                           generator=g, dtype=torch.int64)
    stacks[..., 7] &= 0x0FFFFFFF
    stacks = stacks.to(torch.int32).to(dev)
    leaves = list(stacks.unbind(1))[::stride_cols]
    consts = torch.randint(0, 2**28, (len(prog.const_keys), 8), generator=g,
                           dtype=torch.int32).to(dev)
    before = field_prog.field_prog.launches
    got = field_prog.field_prog(FR, prog, leaves, consts, n)
    assert field_prog.field_prog.launches == before + 1
    return got, field_prog.field_prog_plain(FR, prog, leaves, consts, n)


@pytest.mark.parametrize("square", [False, True])
def test_mont_chain_probe_matches_plain(dev, square):
    """The latency probe: 7 dependent products (squarings) a lane, at 1 and
    300 lanes, against the plain chain and Python integers."""
    rng = np.random.default_rng(11)
    xs = [int(v) for v in rng.integers(1, 1 << 62, 300)]
    ys = [int(v) for v in rng.integers(1, 1 << 62, 300)]
    x, y = FQ.encode(xs, dev), FQ.encode(ys, dev)
    for L in (1, 300):
        got = cuda_field.mont_chain(FQ, x[:L], y[:L], 7, square)
        assert torch.equal(got, cuda_field.mont_chain_plain(
            FQ, x[:L], y[:L], 7, square))
    want = [pow(a, 1 << 7, Q) if square else a * pow(b, 7, Q) % Q
            for a, b in zip(xs, ys)]
    assert got.cpu().equal(FQ.encode(want, "cpu"))


@pytest.mark.parametrize("n", [1, 200, 1000])
def test_field_prog_kernel_matches_plain(dev, n):
    """A part program with permutation and lookup rules (the RangeHarness
    circuit) and a gate whose rotations wrap at both ends, at row counts
    that are not multiples of the block, leaves as strided views."""
    from chip_smoke import golden_circuits
    cs = ConstraintSystem()
    golden_circuits()["range_k7"][0].configure(cs)
    for prog in (quotient.part_program(cs, n),
                 quotient.compile_program([quotient.expr_ir(_wrap_gate())],
                                          n)):
        got, want = _run_both(dev, prog, n, seed=n)
        assert torch.equal(got, want)


def test_field_prog_many_slots_and_refusals(dev):
    """A program of four sub-programs of 13 slots (52 KB of shared memory
    a block: over the 48 KB default) matches the interpreter; a
    misaligned leaf and a wrong constant table are refused."""
    leaves = [ex.AdviceQuery(i % 5, i % 7 - 3) for i in range(1 << 12)]
    while len(leaves) > 1:
        leaves = [ex.Product(leaves[i], leaves[i + 1])
                  if i % 4 else ex.Sum(leaves[i], leaves[i + 1])
                  for i in range(0, len(leaves), 2)]
    n = 300
    tree = quotient.expr_ir(leaves[0])
    prog = quotient.compile_program([tree] * 4, n, fold=("y",), groups=4)
    assert (prog.slots, prog.groups) == (13, 4)
    got, want = _run_both(dev, prog, n, seed=9, stride_cols=1)
    assert torch.equal(got, want)
    x = torch.zeros((n, 12), dtype=torch.int32, device=dev)
    consts = torch.zeros((len(prog.const_keys), 8), dtype=torch.int32,
                         device=dev)
    ok = [torch.zeros((n, 8), dtype=torch.int32, device=dev)] * len(
        prog.leaf_keys)
    with pytest.raises(ValueError):
        field_prog.field_prog(FR, prog, [x[:, 1:9]] + ok[1:], consts, n)
    one_more = torch.zeros((len(prog.const_keys) + 1, 8), dtype=torch.int32,
                           device=dev)
    with pytest.raises(ValueError):
        field_prog.field_prog(FR, prog, ok, one_more, n)


@pytest.mark.parametrize("name", ["rsa", "composite"])
def test_field_prog_split_parts_match_plain(dev, name):
    """The RSA-SHA256 and composite part programs at a k=15 part's 2^15
    rows, split into groups_for(2^15) = 4 sub-programs, and the RSA one
    unsplit and at G_MAX: kernel equal to the interpreter."""
    import chip_smoke
    circuit = {"rsa": chip_smoke.rsa_circuit,
               "composite": chip_smoke.composite_circuit}[name]()
    cs = ConstraintSystem()
    circuit.configure(cs)
    n = 1 << 15
    progs = [quotient.part_program(cs, n)]
    if name == "rsa":
        progs += [quotient.part_program(cs, n, groups=g)
                  for g in (1, field_prog.G_MAX)]
    assert progs[0].groups == 4
    for prog in progs:
        got, want = _run_both(dev, prog, n, seed=15, stride_cols=2)
        assert torch.equal(got, want), prog.groups


def test_sum_program_matches_plain(dev):
    """The engine's weighted sum (ops/field_prog.py::sum_program) over 64
    vectors of 2^15 rows, in 4 sub-programs."""
    n = 1 << 15
    prog = field_prog.sum_program(64, field_prog.groups_for(n))
    got, want = _run_both(dev, prog, n, seed=16)
    assert torch.equal(got, want)


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


@pytest.mark.parametrize("C,P", [(8, 1), (8, 32), (32, 8), (32, 32)])
def test_fold_mixed_widths_match_plain(dev, C, P):
    """Several rows at C in {8, 32}: identity bases, zero digits, and row-0
    lanes whose acc equals, negates or lacks their entry."""
    B, npad = 2, 4 * C
    bases = _points(npad - 2, 11) + [None, None]
    table = precompute_window_table(affine_to_device(bases, dev))
    rng = np.random.default_rng(12 + C + P)
    svals = [[int.from_bytes(rng.bytes(32), "big") % R for _ in range(npad)]
             for _ in range(B)]
    for sv in svals:
        sv[::5] = [0] * len(sv[::5])
    scalars = torch.from_numpy(np.stack([ints_to_limbs(s) for s in svals]))
    scalars = scalars.to(dev)
    L = P * B * C
    lane = torch.arange(L, device=dev)
    acc = affine_to_device(_points(16, 13), dev)[lane % 16]
    digs = cuda_ec.window_digits(scalars[:, :C], P).reshape(-1)
    ent = table[digs, lane % C]
    live = lane[digs != 0]
    acc[live[0::4]] = ent[live[0::4]]                          # equal
    inv = live[1::4]                                           # inverse
    acc[inv] = ent[inv]
    acc[inv, 1] = neg(FQ, ent[inv, 1])
    acc[live[2::4], 2] = 0                                     # identity
    args = (acc, table, scalars, C, P, 0, npad // C)
    before = cuda_ec.fold_mixed.shapes[(L, C, npad // C)]
    assert torch.equal(cuda_ec.fold_mixed(*args),
                       cuda_ec.fold_mixed_plain(*args))
    assert cuda_ec.fold_mixed.shapes[(L, C, npad // C)] == before + 1


def test_fold_dbl_any_times_matches_chained(dev):
    p = affine_to_device(_points(61, 14) + [None] * 3, dev)
    before = cuda_ec.fold_dbl_any.launches
    got = cuda_ec.fold_dbl_any(p, times=8)
    assert cuda_ec.fold_dbl_any.launches == before + 1
    assert torch.equal(got, cuda_ec.fold_dbl_any_plain(p, 8))
    chained = p
    for _ in range(8):
        chained = cuda_ec.fold_dbl_any(chained)
    assert torch.equal(got, chained)


_EDGES = {"fr": [0, 1, R - 1, R - 2, (1 << 254) % R],
          "fq": [0, 1, Q - 1, Q - 2, (1 << 254) % Q]}


def test_squaring_edge_operands(dev):
    """field.cuh's fe_sqr on 0, 1, p - 1, p - 2 and 2^254 mod p: through
    mont_mul(a, a) (one buffer: the kernel squares) over Fr and Fq, and
    through fold_dbl_any (five squarings a doubling) over Fq coordinates."""
    for spec, p, name in ((FR, R, "fr"), (FQ, Q, "fq")):
        e = _EDGES[name]
        a = torch.from_numpy(ints_to_limbs(e).copy()).to(dev)
        rinv = pow(1 << 256, -1, p)
        got = cuda_field.mont_mul(spec, a, a)
        assert limbs_to_ints(got.cpu().numpy()) == [x * x * rinv % p
                                                    for x in e]
        assert torch.equal(got, cuda_field.mont_mul_plain(spec, a, a))
        assert torch.equal(got, cuda_field.mont_mul(spec, a, a.clone()))
    e = torch.from_numpy(ints_to_limbs(_EDGES["fq"]).copy()).to(dev)
    idx = torch.cartesian_prod(*[torch.arange(5)] * 3).to(dev)   # (125, 3)
    pts = e[idx]                                                 # (125, 3, 8)
    for times in (1, 3):
        assert torch.equal(cuda_ec.fold_dbl_any(pts, times=times),
                           cuda_ec.fold_dbl_any_plain(pts, times))


def _rand_points(m, seed, dev):
    """m points of random canonical Fq coordinates (< 2^252): the point
    formulas, and so the kernel against its plain version, do not need
    points on the curve."""
    w = np.random.default_rng(seed).integers(0, 1 << 32, (m, 3, 8),
                                             dtype=np.uint32)
    w[..., 7] &= 0x0FFFFFFF
    return torch.from_numpy(w.view(np.int32)).to(dev)


@pytest.mark.parametrize("G,width", [(2, 8), (3, 16), (5, 512), (1, 2048),
                                     (520, 256), (256, 256), (64, 1024),
                                     (32, 2048), (96, 1024), (2032, 256),
                                     (1, 2), (1, 65536)])
def test_fold_add_tree_matches_plain(dev, G, width):
    """The warm proof's tail shapes (256 x 256, 64 x 1024, 32 x 2048, 96 x
    1024), msm()'s (2032 x 256: two lanewise rounds of the add kernel
    first; 520 x 256: one), widths up to 65,536 in one launch (the last
    block of each group merging its blocks' sums), and the slot switch a
    round earlier and later.  Group 0 holds doubling, inverse and identity
    lanes."""
    acc = _rand_points(G * width, 20 + width, dev)
    half = width // 2
    acc[half] = acc[0]                                        # doubling
    if width >= 8:
        acc[1 + half] = acc[1]                                # inverse
        acc[1 + half, 1] = neg(FQ, acc[1, 1])
        acc[2, 2] = 0                                         # p identity
        acc[3 + half, 2] = 0                                  # q identity
    want = cuda_ec.fold_add_tree_plain(acc, G, width)
    lanewise = 0
    while G * width >> (lanewise + 1) >= cuda_ec.ADD_WAVE:
        lanewise += 1
    wave = cuda_ec.tree_slot_limit(dev)
    for limit in (wave, 2 * wave, wave // 2):
        cuda_ec.TREE_SLOT_LIMIT = limit
        try:
            before = (cuda_ec.fold_add_tree.launches,
                      cuda_ec.fold_add.launches)
            got = cuda_ec.fold_add_tree(acc, G, width)
        finally:
            cuda_ec.TREE_SLOT_LIMIT = None
        assert torch.equal(got, want), limit
        assert (cuda_ec.fold_add_tree.launches - before[0],
                cuda_ec.fold_add.launches - before[1]) == (1, lanewise)
    # the counters of the wide groups are left at zero: again, same bits
    assert torch.equal(cuda_ec.fold_add_tree(acc, G, width), want)


@pytest.mark.parametrize("B,times,planes", [
    (3, 8, 32), (3, 1, 254), (1, 8, 32), (48, 8, 32), (200, 8, 32),
    (392, 8, 32), (8, 1, 254)])
def test_fold_horner_matches_plain(dev, B, times, planes):
    """At the proofs' lane counts (1-392) and msm()'s B = 8.  Lane 0's
    partials all the identity; lane 1's top planes and every fifth plane
    the identity; where B >= 3, lane 2 holds curve points with only planes
    1 and 0 set, plane 0 = 2^times * plane 1 (the add doubles), and where B
    >= 8 lane 3 the same with plane 0 negated (the add gives the
    identity)."""
    parts = _rand_points(B * planes, 30 + times + B, dev).reshape(
        B, planes, 3, 8)
    parts[0, :, 2] = 0
    if B > 1:
        parts[1, -3:, 2] = 0
        parts[1, ::5, 2] = 0
    for lane, sign in ((2, 1), (3, -1)):
        if lane >= B or (lane == 3 and B < 8):
            continue
        p1 = G1.scalar_mul(G1_GEN, 1000 + lane)
        p0 = G1.scalar_mul(p1, 1 << times)
        pts = [None] * planes
        pts[1], pts[0] = p1, p0 if sign > 0 else G1.neg(p0)
        parts[lane] = affine_to_device(pts, dev)
    before = cuda_ec.fold_horner.launches
    got = cuda_ec.fold_horner(parts, times)
    assert cuda_ec.fold_horner.launches == before + 1
    assert torch.equal(got, cuda_ec.fold_horner_plain(parts, times))
    if B >= 8:
        assert int(got[3, 2].abs().sum()) == 0


@pytest.mark.parametrize("C,n,nbits,r0,r1", [(8, 64, 254, 0, 8),
                                             (2, 128, 40, 3, 61)])
def test_fold_mixed_tiled_rows_matches_plain(dev, C, n, nbits, r0, r1):
    """Against the plain row loop and the chain of one-row fold_mixed_tiled
    launches; bases 5 and n - 1 the identity; lanes whose acc equals,
    negates or lacks the base of their first set row.  (2, 128): 58 rows,
    two 32-row mask chunks and a bit of the second scalar word."""
    B = 2
    L = nbits * B * C
    points = _rand_points(n, 40 + C, dev)
    points[:, 2] = FQ.const("one_mont", dev)
    points[5, 2] = points[n - 1, 2] = 0
    rng = np.random.default_rng(41 + C)
    scalars = torch.from_numpy(np.stack([ints_to_limbs(
        [int.from_bytes(rng.bytes(32), "big") % R for _ in range(n)])
        for _ in range(B)])).to(dev)
    acc = _rand_points(L, 42 + C, dev)
    lane = torch.arange(L, device=dev)
    c = lane % C
    bit, b = (lane // C) // B, (lane // C) % B
    first = torch.full((L,), -1, dtype=torch.int64, device=dev)
    for r in range(r1 - 1, r0 - 1, -1):
        w = scalars[b, r * C + c, bit // 32].to(torch.int64) & 0xFFFFFFFF
        first = torch.where((w >> (bit % 32)) & 1 == 1, r, first)
    sel = lane[first >= 0]
    base = points[first[sel] * C + c[sel]]
    acc[sel[0::7]] = base[0::7]                                # equal
    acc[sel[1::7]] = base[1::7]                                # inverse
    acc[sel[1::7], 1] = neg(FQ, base[1::7, 1])
    acc[sel[2::7], 2] = 0                                      # identity
    before = cuda_ec.fold_mixed_tiled_rows.launches
    got = cuda_ec.fold_mixed_tiled_rows(acc, points, scalars, C, r0, r1)
    assert cuda_ec.fold_mixed_tiled_rows.launches == before + 1
    assert torch.equal(got, cuda_ec.fold_mixed_tiled_rows_plain(
        acc, points, scalars, C, r0, r1))
    chain = acc
    for r in range(r0, r1):
        chain = cuda_ec.fold_mixed_tiled(
            chain, points[r * C:(r + 1) * C],
            cuda_ec.bit_masks(scalars[:, r * C:(r + 1) * C], nbits))
    assert torch.equal(got, chain)


def test_kernels_reject_mixed_devices(dev):
    a = FR.encode([1, 2, 3], dev)
    with pytest.raises(ValueError):
        cuda_field.mont_mul(FR, a, a.cpu())
    with pytest.raises(ValueError):
        cuda_field.add(FR, a, a.cpu())


def _rand_stack(rng, shape, p=R):
    vals = [int.from_bytes(rng.bytes(32), "big") % p
            for _ in range(int(np.prod(shape)))]
    return torch.from_numpy(ints_to_limbs(vals).copy()).reshape(
        tuple(shape) + (8,))


@pytest.mark.parametrize("k,C", [(k, C) for k in (4, 6, 8, 10)
                                 for C in (1, 3, 8, None)]
                         + [(15, 64), (15, 60), (15, 34), (15, 1), (11, 3),
                            (1, 2), (20, 1)])
def test_ntt_kernel_matches_plain(dev, k, C):
    """Forward, inverse, coset (pre-scale) and h-chunk (post-scale) entries
    bitwise equal to the plain versions on the same inputs (C None: the
    batch-less (n, 8) shape); the plain loop never runs for them."""
    n = 1 << k
    rng = np.random.default_rng(k * 100 + (C or 0))
    plan = tntt.get_plan(n, fr_root_of_unity(k), dev)
    a = _rand_stack(rng, (n,) if C is None else (n, C)).to(dev)
    pre = _rand_stack(rng, (n,)).to(dev)
    post = _rand_stack(rng, (n,)).to(dev)
    passes = len(tntt.pass_shapes(k, C or 1))
    for got_fn, want_fn in (
            (lambda: tntt.ntt(plan, a), lambda: tntt.ntt_plain(plan, a)),
            (lambda: tntt.intt(plan, a), lambda: tntt.intt_plain(plan, a)),
            (lambda: tntt.ntt(plan, a, pre=pre),
             lambda: tntt.ntt_plain(plan, a, pre=pre)),
            (lambda: tntt.intt(plan, a, post=post),
             lambda: tntt.intt_plain(plan, a, post=post))):
        launches, plain = tntt.ntt_kernel.launches, tntt._ntt_run.cuda_calls
        got = got_fn()
        assert tntt.ntt_kernel.launches == launches + passes
        assert tntt._ntt_run.cuda_calls == plain
        assert torch.equal(got, want_fn())
    # forward then inverse is the identity
    assert torch.equal(tntt.intt(plan, tntt.ntt(plan, a)), a)


@pytest.mark.parametrize("spec,p", [(FR, R), (FQ, Q)])
def test_field_addsub_kernel_matches_plain(dev, spec, p):
    """add, sub and neg at 0, 1, p - 1 and random values, same-shape and
    broadcast operands ((n,) + (), (n, C) + (n, 1), (C,) over a leading
    axis, a strided view), bitwise equal to the plain versions."""
    rng = np.random.default_rng(21)
    n, C = 4099, 5
    a = _rand_stack(rng, (n, C), p).to(dev)
    b = _rand_stack(rng, (n, C), p).to(dev)
    edge = torch.from_numpy(ints_to_limbs([0, 1, p - 1]).copy()).to(dev)
    a[:3, 0], b[:3, 0] = edge, edge.flip(0)
    a[3:6, 0], b[3:6, 0] = edge, edge
    cases = [(a, b), (a[:, 0], b[0, 0]), (a, b[:, :1]), (a, b[0]),
             (a[:, 1:4], b[:, 2:5]), (b[0, 0], a)]
    for x, y in cases:
        for fn, plain in ((cuda_field.add, cuda_field.add_plain),
                          (cuda_field.sub, cuda_field.sub_plain)):
            before = cuda_field.add_sub.launches
            got = fn(spec, x, y)
            assert cuda_field.add_sub.launches == before + 1
            assert torch.equal(got, plain(spec, x, y))
        assert torch.equal(cuda_field.neg(spec, x),
                           cuda_field.neg_plain(spec, x))


def _rand_canonical(rng, shape):
    """Random field elements below 2^252 (canonical in Fr and Fq), fast."""
    w = rng.integers(0, 1 << 32, tuple(shape) + (8,), dtype=np.uint32)
    w[..., 7] &= 0x0FFFFFFF
    return torch.from_numpy(w.view(np.int32))


def _scan_wants(plain, v, reverse):
    """The plain scan's full, exclusive and total outputs from one run."""
    full = plain(v, reverse)
    first = torch.zeros_like(full[..., :1, :]) if plain.zero else (
        FR.const("one_mont", v.device).expand(full[..., :1, :].shape))
    if reverse:
        excl = torch.cat([full[..., 1:, :], first], -2)
        tot = full[..., 0, :]
    else:
        excl = torch.cat([first, full[..., :-1, :]], -2)
        tot = full[..., -1, :]
    return {(False, False): full, (True, False): excl, (False, True): tot}


@pytest.mark.parametrize("shape", [(1,), (3,), (1000,), (4096,), (1 << 15,),
                                   (80, 1 << 15), (1 << 20,)],
                         ids=["1", "3", "1000", "4096", "32768", "80x32768",
                              "1048576"])
def test_linscan_kernel_matches_plain(dev, shape):
    """The scans' sum and linear (a random a) scans (linscan,
    field_linscan_kernel) and product scan (prodscan, the stream kernel)
    over one column or a stack: forward and reverse,
    every x, the exclusive x and the total, bitwise equal to the plain
    scans; one launch a call, no run of a plain scan on the card."""
    rng = np.random.default_rng(shape[-1] + len(shape))
    v = _rand_canonical(rng, shape).to(dev)
    a_rand = int.from_bytes(rng.bytes(32), "big") % R
    scans = []
    for a in (1, a_rand):
        def plain(x, reverse, a=a):
            return cuda_field.linscan_plain(FR, x, a, reverse)
        plain.zero = True
        scans.append((lambda x, r, e, t, a=a: cuda_field.linscan(
            FR, x, a, r, e, t), plain))

    def plain_prod(x, reverse):
        return cuda_field.prodscan_plain(FR, x, reverse)
    plain_prod.zero = False
    scans.append((lambda x, r, e, t: cuda_field.prodscan(FR, x, r, e, t),
                  plain_prod))
    for kind, (scan, plain) in enumerate(scans):
        for reverse in (False, True):
            wants = _scan_wants(plain, v, reverse)
            for (exclusive, totals), want in wants.items():
                before = (cuda_field.linscan.launches
                          + cuda_field.prodscan.launches)
                plains = (cuda_field.linscan_plain.cuda_calls,
                          cuda_field.prodscan_plain.cuda_calls)
                got = scan(v, reverse, exclusive, totals)
                assert (cuda_field.linscan.launches
                        + cuda_field.prodscan.launches - before) == 1
                assert (cuda_field.linscan_plain.cuda_calls,
                        cuda_field.prodscan_plain.cuda_calls) == plains
                assert torch.equal(got, want), (kind, reverse, exclusive,
                                                totals)


@pytest.mark.parametrize("spec", [FR, FQ], ids=["fr", "fq"])
@pytest.mark.parametrize("n,cols", [(1, 80), (255, 1), (255, 80), (4097, 1),
                                    (4097, 80), ((1 << 15) + 3, 1),
                                    ((1 << 15) + 3, 80)],
                         ids=["1x80", "255", "255x80", "4097", "4097x80",
                              "32771", "32771x80"])
def test_prodscan_kernel_odd_sizes_match_plain(dev, spec, n, cols):
    """The product scan over Fr and over Fq (keygen's window table), at odd
    n (the first block padded), one column and 80, forward and reverse,
    every output, bitwise equal to prodscan_plain; one launch a call."""
    r = _rand_canonical(np.random.default_rng(n + cols), (cols, n)).to(dev)
    for reverse in (False, True):
        for exclusive, totals in ((False, False), (True, False),
                                  (False, True)):
            before = cuda_field.prodscan.launches
            got = cuda_field.prodscan(spec, r, reverse, exclusive, totals)
            assert cuda_field.prodscan.launches == before + 1
            assert torch.equal(got, cuda_field.prodscan_plain(
                spec, r, reverse, exclusive, totals)), (reverse, exclusive,
                                                        totals)


def test_grand_products_on_card_match_cpu(dev):
    """TorchEngine.grand_products at 2^12 rows, 11 vectors, on the card
    (three prodscan, four mont_mul and one fe_pow launch, no plain route)
    and on the CPU, the same bits."""
    from halo2tpu_torch.fields import jfield
    from halo2tpu_torch.plonk.engine import TorchEngine
    rng = np.random.default_rng(31)
    n = 1 << 12
    nums = _rand_canonical(rng, (11, n))
    dens = _rand_canonical(rng, (11, n))
    dens[..., 0] |= 1                                         # nonzero
    cpu = TorchEngine.grand_products(None, list(nums), list(dens))
    before = (cuda_field.prodscan.launches, cuda_field.mont_mul.launches,
              cuda_field.mont_pow.launches)
    plains = (jfield._prefix_prod_plain.cuda_calls,
              jfield.batch_inv_scan_plain.cuda_calls,
              cuda_field.prodscan_plain.cuda_calls)
    got = TorchEngine.grand_products(None, list(nums.to(dev)),
                                     list(dens.to(dev)))
    assert (cuda_field.prodscan.launches - before[0],
            cuda_field.mont_mul.launches - before[1],
            cuda_field.mont_pow.launches - before[2]) == (3, 4, 1)
    assert (jfield._prefix_prod_plain.cuda_calls,
            jfield.batch_inv_scan_plain.cuda_calls,
            cuda_field.prodscan_plain.cuda_calls) == plains
    for g, c in zip(got, cpu):
        assert torch.equal(g.cpu(), c)
    # batch inversion and the prefix product over columns take the kernel
    x = dens[0].to(dev)
    assert torch.equal(jfield.batch_inv_scan(FR, x).cpu(),
                       jfield.batch_inv_scan_plain(FR, dens[0]))
    assert torch.equal(jfield._prefix_prod(FR, dens.transpose(0, 1).to(dev))
                       .cpu(), jfield._prefix_prod_plain(
                           FR, dens.transpose(0, 1)))


def test_linscan_kernel_stacks_match_plain(dev):
    """A group of 16 polys of 2^15 rows (eval_polys' reverse total), a
    strided view of an (n, C, 8) stack read in place, and a poly's
    div_linear (exclusive reverse), bitwise equal to the plain scan."""
    rng = np.random.default_rng(17)
    n = 1 << 15
    x = int.from_bytes(rng.bytes(32), "big") % R
    polys = _rand_stack(rng, (16, n)).to(dev)
    assert torch.equal(
        cuda_field.linscan(FR, polys, x, reverse=True, totals=True),
        cuda_field.linscan_plain(FR, polys, x, reverse=True, totals=True))
    stack = _rand_stack(rng, (n, 5)).to(dev)
    view = stack.transpose(0, 1)
    for a in (1, x):
        assert torch.equal(cuda_field.linscan(FR, view, a),
                           cuda_field.linscan_plain(FR, view, a))
    assert torch.equal(
        cuda_field.linscan(FR, polys[0], x, reverse=True, exclusive=True),
        cuda_field.linscan_plain(FR, polys[0], x, reverse=True,
                                 exclusive=True))


# -- the multi-device prover on shards of the card ---------------------------

def _card_mesh(d):
    from halo2tpu_torch.parallel.mesh import Mesh
    return Mesh([torch.device("cuda", 0)] * d)


@pytest.mark.parametrize("k", [10, 15])
def test_four_step_on_card_shards_matches_ntt(dev, k):
    """plonk/sharded.py::_FlatFourStep on D = 1, 2, 4, 8 shards of the
    card, forward and inverse, one column and a stack of three: the ntt
    kernel's bits."""
    from halo2tpu_torch.fields.bn254 import inv_mod
    from halo2tpu_torch.plonk.sharded import _FlatFourStep
    n, omega = 1 << k, fr_root_of_unity(k)
    rng = np.random.default_rng(k)
    x = torch.from_numpy(ints_to_limbs([int.from_bytes(rng.bytes(32), "big")
                                        % R for _ in range(3 * n)]).copy())
    x = FR.to_mont(x.reshape(n, 3, 8).to(dev))
    plan = tntt.get_plan(n, omega, dev)
    for inverse in (False, True):
        want = tntt.intt(plan, x) if inverse else tntt.ntt(plan, x)
        for d in (1, 2, 4, 8):
            mesh = _card_mesh(d)
            fs = (_FlatFourStep(mesh, "shard", n, inv_mod(omega, R),
                                scale=inv_mod(n, R)) if inverse
                  else _FlatFourStep(mesh, "shard", n, omega))
            assert torch.equal(torch.cat(fs(mesh.split(x))), want), d
            assert torch.equal(torch.cat(fs(mesh.split(
                x[:, 1].contiguous()))), want[:, 1]), d


def test_sharded_engine_on_card_matches_cpu(dev):
    """ShardedTorchEngine on 4 shards of the card against TorchEngine on the
    CPU: the cross-block scans (grand products, div_linear, evaluations),
    the weighted sum, a rotated field program and commitments in a padded
    group of the bit-serial sharded fold."""
    from halo2tpu_torch.plonk.domain import make_domain
    from halo2tpu_torch.plonk.engine import TorchEngine
    from halo2tpu_torch.plonk.sharded import ShardedTorchEngine
    from halo2tpu_torch.plonk.srs import setup
    k = 8
    n = 1 << k
    d, srs = make_domain(k, 3), setup(k, cache=False)
    ref = TorchEngine(d, srs, "cpu")
    sh = ShardedTorchEngine(d, srs, _card_mesh(4), msm_batch=2)
    rng = np.random.default_rng(8)
    cols = [[int.from_bytes(rng.bytes(32), "big") % R or 1
             for _ in range(n)] for _ in range(6)]
    rv, sv = ref.from_ints_stack(cols), sh.from_ints_stack(cols)

    def same(a, b):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert torch.equal(y.gather().cpu(), x)

    same(ref.grand_products(rv[:3], rv[3:]), sh.grand_products(sv[:3],
                                                               sv[3:]))
    for a in (3, R - 2, 0):
        same([ref.div_linear(rv[0], a)], [sh.div_linear(sv[0], a)])
    pairs = [(i, x) for i in range(6) for x in (5, R - 1)]
    assert sh.eval_polys([(sv[i], x) for i, x in pairs]) == ref.eval_polys(
        [(rv[i], x) for i, x in pairs])
    same([ref.weighted_sum(rv, cols[0][:6])], [sh.weighted_sum(sv,
                                                               cols[0][:6])])
    prog = quotient.compile_program(
        [quotient._mul(quotient._ld("a", 0, rot=-1),
                       quotient._ld("b", 0, rot=n - 70)),
         quotient._ld("a", 0, rot=65)], n, fold=("y",))
    leaves = {("a", 0): 0, ("b", 0): 1}
    consts = ref._encode(cols[1][:len(prog.const_keys)])
    same([ref.run_program(prog, [rv[leaves[k_]] for k_ in prog.leaf_keys],
                          consts)],
         [sh.run_program(prog, [sv[leaves[k_]] for k_ in prog.leaf_keys],
                         consts.to(dev))])
    assert sh.commit_lagrange_batch(sv[:3]) == ref.commit_lagrange_batch(
        rv[:3])
    assert sh.commit_batch(sv[3:4]) == ref.commit_batch(rv[3:4])


def test_sharded_timestamp_on_card_is_the_golden(dev):
    """Timestamp k=6 proven by ShardedTorchEngine on 4 shards of the card:
    halo2tpu's HostEngine bytes (tests/golden/torch_port_proofs.json)."""
    import json
    import os
    from chip_smoke import golden_circuits
    from halo2tpu_torch.plonk.keygen import keygen
    from halo2tpu_torch.plonk.prover import create_proof
    from halo2tpu_torch.plonk.sharded import ShardedTorchEngine
    from halo2tpu_torch.plonk.srs import setup
    from halo2tpu_torch.plonk.verifier import verify_proof
    with open(os.path.join(os.path.dirname(__file__), "golden",
                           "torch_port_proofs.json")) as f:
        golden = json.load(f)["timestamp_k6"]["proof"]
    c, k, inst, seed = golden_circuits()["timestamp_k6"]
    srs = setup(k, cache=False)
    pk, vk = keygen(c, k, srs, device="cuda")
    eng = ShardedTorchEngine(vk.domain, srs, _card_mesh(4))
    proof = create_proof(pk, srs, c, inst, rng_seed=seed, engine=eng)
    assert proof.hex() == golden
    assert verify_proof(vk, srs, inst, proof)


def test_sharded_prover_one_shard_a_card(dev):
    """On a machine with several cards, one shard a card (make_mesh over
    the first power of two of them): the four-step against the ntt kernel,
    the sharded MSM against msm(), Timestamp k=6 against the golden."""
    import json
    import os
    from chip_smoke import golden_circuits
    from halo2tpu_torch.fields.bn254 import inv_mod
    from halo2tpu_torch.ops.msm import _partials_to_affine
    from halo2tpu_torch.parallel.mesh import make_mesh
    from halo2tpu_torch.parallel.msm import sharded_bit_partials
    from halo2tpu_torch.plonk.keygen import keygen
    from halo2tpu_torch.plonk.prover import create_proof
    from halo2tpu_torch.plonk.sharded import ShardedTorchEngine, _FlatFourStep
    from halo2tpu_torch.plonk.srs import setup
    from halo2tpu_torch.plonk.verifier import verify_proof
    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip("needs two or more CUDA devices")
    mesh = make_mesh(1 << (cards.bit_length() - 1))
    k = 12
    n, omega = 1 << k, fr_root_of_unity(k)
    rng = np.random.default_rng(12)
    x = FR.to_mont(torch.from_numpy(ints_to_limbs(
        [int.from_bytes(rng.bytes(32), "big") % R for _ in range(n)]
    ).copy()).to(dev))
    plan = tntt.get_plan(n, omega, dev)
    fs = _FlatFourStep(mesh, "shard", n, omega)
    got = fs(mesh.split(x))
    assert [b.device for b in got] == mesh.flat
    assert torch.equal(torch.cat([b.to(dev) for b in got]),
                       tntt.ntt(plan, x))
    fi = _FlatFourStep(mesh, "shard", n, inv_mod(omega, R),
                       scale=inv_mod(n, R))
    assert torch.equal(torch.cat([b.to(dev) for b in fi(mesh.split(x))]),
                       tntt.intt(plan, x))
    pts = affine_to_device(_points(256, 3), dev)
    svs = [[int.from_bytes(rng.bytes(32), "big") % R for _ in range(256)]
           for _ in range(2)]
    limbs = torch.from_numpy(np.stack([ints_to_limbs(s) for s in svs])).to(
        dev)
    assert _partials_to_affine(sharded_bit_partials(mesh, pts, limbs)) == (
        msm(pts, svs))
    with open(os.path.join(os.path.dirname(__file__), "golden",
                           "torch_port_proofs.json")) as f:
        golden = json.load(f)["timestamp_k6"]["proof"]
    c, k, inst, seed = golden_circuits()["timestamp_k6"]
    srs = setup(k, cache=False)
    pk, vk = keygen(c, k, srs, device="cuda")
    eng = ShardedTorchEngine(vk.domain, srs, mesh)
    proof = create_proof(pk, srs, c, inst, rng_seed=seed, engine=eng)
    assert proof.hex() == golden
    assert verify_proof(vk, srs, inst, proof)


@pytest.mark.parametrize("name", ["square_k4", "range_k7", "nullifier_k10",
                                  "extractor_k8"])
def test_mock_prover_on_card_matches_cpu(dev, name):
    """MockProver on the card gives the CPU's failure list (which
    tests/test_torch_mock.py holds to halo2tpu's): satisfied, an advice
    cell plus one, a lookup input outside its table, a wrong instance."""
    from chip_smoke import golden_circuits
    from halo2tpu_torch.plonk.mock import MockProver
    c, k, inst, _ = golden_circuits()[name]
    card = MockProver.run(k, c, inst, device="cuda")
    cpu = MockProver(card.cs, card.asn, inst, card.n, device="cpu")

    def same(card, cpu):
        got = [(f.kind, f.detail) for f in card.verify()]
        assert got == [(f.kind, f.detail) for f in cpu.verify()]
        return got

    assert same(card, cpu) == []
    adv = card.asn.advice
    adv[0][0] = (int(adv[0][0]) + 1) % R
    tampered = same(card, cpu)
    lk = next((lk for lk in card.cs.lookups
               if type(lk.pairs[0][0]).__name__ == "AdviceQuery"), None)
    if lk is not None:
        adv[lk.pairs[0][0].column_index][1] = R - 1
        assert len(same(card, cpu)) > len(tampered)
    if inst:
        wrong = [list(col) for col in inst]
        wrong[0][0] ^= 1
        same(MockProver(card.cs, card.asn, wrong, card.n, device="cuda"),
             MockProver(card.cs, card.asn, wrong, card.n, device="cpu"))
