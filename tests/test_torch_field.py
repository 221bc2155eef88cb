"""halo2tpu_torch field arithmetic against halo2tpu's jfield (XLA on CPU)
and the Pallas mont_mul (interpret mode), mont_pow and inv against
jfield's, the prefix products and batch inversion (the blocked plain
routes and the product-scan routes) against jfield's, and the JAX <->
port converters.
Exact equality: these are finite-field values."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo2tpu.fields import jfield as jjf
from halo2tpu.fields.bn254 import Q, R
from halo2tpu.ops.pallas_field import kc_for, mont_mul_flat
from halo2tpu_torch import convert
from halo2tpu_torch.fields import jfield as tjf
from halo2tpu_torch.ops import cuda_field

torch.set_num_threads(1)

SPECS = {"fr": (R, jjf.FR, tjf.FR), "fq": (Q, jjf.FQ, tjf.FQ)}


def _vals(rng, p, n):
    return [int.from_bytes(rng.bytes(32), "big") % p for _ in range(n)]


def _pair(spec_j, vals):
    """The same Montgomery values as a JAX array and a port tensor."""
    a = spec_j.encode(vals)
    return a, convert.from_jax_limbs(np.asarray(a))


def _same(jax_arr, t):
    assert np.array_equal(np.asarray(jax_arr),
                          convert.to_jax_limbs(t).reshape(
                              np.asarray(jax_arr).shape))


@pytest.mark.parametrize("field", ["fr", "fq"])
def test_mont_mul_matches_jfield_and_pallas(field):
    p, sj, st = SPECS[field]
    rng = np.random.default_rng(11)
    edge = [p - 1, p - 2, 1, (1 << 254) % p]
    xs = [x for x in edge for _ in edge] + _vals(rng, p, 48)
    ys = [y for _ in edge for y in edge] + _vals(rng, p, 48)
    aj, at = _pair(sj, xs)
    bj, bt = _pair(sj, ys)
    got = tjf.mont_mul(st, at, bt)
    _same(jjf.mont_mul(sj, aj, bj), got)
    _same(mont_mul_flat(kc_for(p), aj, bj), got)
    assert st.decode(got) == [x * y % p for x, y in zip(xs, ys)]


def test_mont_mul_raw_edge_operands():
    """Raw (non-encoded) edge operands: every pair of {p-1, p-2, 1,
    2^254 mod p} gives a * b * 2^-256 mod p."""
    for p, _, st in SPECS.values():
        edge = [p - 1, p - 2, 1, (1 << 254) % p]
        a = torch.from_numpy(tjf.ints_to_limbs(
            [x for x in edge for _ in edge]).copy())
        b = torch.from_numpy(tjf.ints_to_limbs(
            [y for _ in edge for y in edge]).copy())
        rinv = pow(1 << 256, -1, p)
        assert tjf.limbs_to_ints(cuda_field.mont_mul_plain(st, a, b)) == [
            x * y * rinv % p for x in edge for y in edge]


@pytest.mark.parametrize("lanes", [1, 3, 256, 3000])
@pytest.mark.parametrize("field", ["fr", "fq"])
def test_plain_python_int_route_matches_torch_route(field, lanes,
                                                    monkeypatch):
    """mont_mul_plain's python-int route on CPU operands gives the bits of
    its float64 torch route (the one CUDA tensors take), on any 256-bit
    operands (canonical or not) and broadcast shapes."""
    p, _, st = SPECS[field]
    g = torch.Generator().manual_seed(lanes)
    a = torch.randint(-2**31, 2**31, (lanes, 8), generator=g,
                      dtype=torch.int64).to(torch.int32)
    b = torch.randint(-2**31, 2**31, (lanes, 8), generator=g,
                      dtype=torch.int64).to(torch.int32)
    c = torch.from_numpy(tjf.ints_to_limbs([p - 1, 0, 1, p]).copy())
    pairs = [(a, b), (a, b[:1]), (a[:4, None], c[None]), (c, c.flip(0)),
             (a, a)]
    got = [cuda_field.mont_mul_plain(st, x, y) for x, y in pairs]
    monkeypatch.setattr(cuda_field, "_cpu_ints", lambda *ts: False)
    want = [cuda_field.mont_mul_plain(st, x, y) for x, y in pairs]
    for w, gt in zip(want, got):
        assert gt.dtype == torch.int32 and gt.shape == w.shape
        assert torch.equal(gt, w)


@pytest.mark.parametrize("field", ["fr", "fq"])
def test_add_sub_neg_match_jfield(field):
    p, sj, st = SPECS[field]
    rng = np.random.default_rng(12)
    xs = [0, 1, p - 1, p - 2] + _vals(rng, p, 28)
    ys = [p - 1, 0, p - 1, 2] + _vals(rng, p, 28)
    aj, at = _pair(sj, xs)
    bj, bt = _pair(sj, ys)
    _same(jjf.add(sj, aj, bj), tjf.add(st, at, bt))
    _same(jjf.sub(sj, aj, bj), tjf.sub(st, at, bt))
    _same(jjf.neg(sj, aj), tjf.neg(st, at))


def _raw_pair(p, rng):
    """Raw Montgomery limbs, the same in both packages: the edge values 0,
    1, p - 1 and R mod p (Montgomery one), then random values below p."""
    vals = [0, 1, p - 1, (1 << 256) % p] + _vals(rng, p, 12)
    u16 = tjf.ints_to_limbs16(vals)
    return jnp.asarray(u16.astype(np.uint32)), convert.from_jax_limbs(u16)


@pytest.mark.parametrize("field", ["fr", "fq"])
@pytest.mark.parametrize("e", ["0", "1", "2", "65537", "p-2"])
def test_mont_pow_matches_jfield(field, e):
    """The port's mont_pow on the CPU (mont_pow_plain: the loop of
    mont_mul_plain the kernel's one launch replaces) against halo2tpu's
    jfield.mont_pow, and against the definition."""
    p, sj, st = SPECS[field]
    exp = p - 2 if e == "p-2" else int(e)
    aj, at = _raw_pair(p, np.random.default_rng(17 + exp % 1000))
    got = tjf.mont_pow(st, at, exp)
    _same(jjf.mont_pow(sj, aj, exp), got)
    assert torch.equal(got, cuda_field.mont_pow_plain(st, at, exp))
    assert st.decode(got) == [pow(v, exp, p) for v in st.decode(at)]


def _pair_schedule(spec, a, e: int, rng, ring: int):
    """csrc/mont_mul.cu's mont_pow_kernel written out: the squaring
    warp and the product warp as two sequences of steps, run in an order
    that rng picks among those the named barriers allow.  Barrier 1 + s
    (full) and 1 + ring + s (empty) of slot s; a wait passes once the other
    warp has arrived for that phase; an arrive needs its previous phase
    taken (else the hardware would count the next one in).  Returns the
    product warp's result and the order of the steps."""
    nbits, bits = e.bit_length(), [k for k in range(e.bit_length())
                                   if e >> k & 1]
    slots, tags = [None] * ring, [None] * ring
    out, order = [], []

    def squaring():
        base, m = a, 0
        for k in range(nbits):
            if e >> k & 1:
                slot = m % ring
                if m >= ring:
                    yield "wait", 1 + ring + slot
                slots[slot], tags[slot] = base, k
                yield "arrive", 1 + slot
                m += 1
            if k + 1 < nbits:
                base = cuda_field.mont_mul_plain(spec, base, base)

    def product():
        result = spec.const("one_mont", "cpu").expand(a.shape)
        for m in range(len(bits)):
            slot = m % ring
            yield "wait", 1 + slot
            x = slots[slot]
            assert tags[slot] == bits[m]          # the power of this bit
            if m + ring < len(bits):
                yield "arrive", 1 + ring + slot
            result = x if m == 0 else cuda_field.mont_mul_plain(spec,
                                                                result, x)
        out.append(result)

    arrived = [0] * (2 * ring + 1)
    taken = [0] * (2 * ring + 1)
    warps = {"squaring": squaring(), "product": product()}
    step = {w: next(g, None) for w, g in warps.items()}
    while any(step.values()):
        ready = [w for w, s in step.items() if s is not None and (
            s[0] == "arrive" or arrived[s[1]] > taken[s[1]])]
        assert ready, f"deadlock at {step}"
        w = ready[rng.integers(len(ready))]
        kind, bar = step[w]
        if kind == "arrive":
            assert arrived[bar] == taken[bar], f"barrier {bar} arrived twice"
            arrived[bar] += 1
        else:
            taken[bar] += 1
        order.append((w, kind, bar))
        step[w] = next(warps[w], None)
    assert arrived == taken
    return out[0], order


EXPONENTS = {"0": 0, "1": 1, "2": 2, "65537": 65537, "2^200": 1 << 200}


@pytest.mark.parametrize("field", ["fr", "fq"])
@pytest.mark.parametrize("e", list(EXPONENTS) + ["p-2", "2^256-1"])
def test_mont_pow_schedules_match_jfield(field, e):
    """The fe_pow kernel's two-warp schedule (the ring of slots, the
    hand-overs in every order the barriers allow: three random orders,
    rings of 7 and 2 slots), over the edge values 0, 1, p - 1, R mod p and
    random values, against mont_pow_plain and, but for 2^256 - 1,
    halo2tpu's mont_pow."""
    p, sj, st = SPECS[field]
    exp = {"p-2": p - 2, "2^256-1": (1 << 256) - 1}.get(e, EXPONENTS.get(e))
    aj, at = _raw_pair(p, np.random.default_rng(23 + exp % 997))
    want = cuda_field.mont_pow_plain(st, at, exp)
    if e != "2^256-1":
        _same(jjf.mont_pow(sj, aj, exp), want)
    rng = np.random.default_rng(exp % 1009)
    for ring in (cuda_field.FE_POW_RING, 2, cuda_field.FE_POW_RING):
        got, order = _pair_schedule(st, at, exp, rng, ring)
        assert torch.equal(got, want), ring
        hand = sum(1 for s in order if s[:2] == ("squaring", "arrive"))
        assert hand == bin(exp).count("1")


@pytest.mark.parametrize("field", ["fr", "fq"])
def test_inv_matches_jfield(field):
    p, sj, st = SPECS[field]
    aj, at = _raw_pair(p, np.random.default_rng(18))
    aj, at = aj[1:], at[1:]                           # nonzero lanes
    got = tjf.inv(st, at)
    _same(jjf.inv(sj, aj), got)
    assert st.decode(got) == [pow(v, -1, p) for v in st.decode(at)]


def test_mont_pow_refuses_exponents_out_of_range():
    with pytest.raises(ValueError):
        cuda_field.mont_pow(tjf.FR, torch.zeros((1, 8), dtype=torch.int32),
                            1 << 256)


def test_scans_match_jfield():
    rng = np.random.default_rng(13)
    xs = [1 + v for v in _vals(rng, R - 1, 40)]
    aj, at = _pair(jjf.FR, xs)
    _same(jjf.batch_inv_scan(jjf.FR, aj), tjf.batch_inv_scan(tjf.FR, at))
    _same(jjf._prefix_prod(jjf.FR, aj), tjf._prefix_prod(tjf.FR, at))
    _same(jjf.suffix_sum_mod(jjf.FR, aj), tjf.suffix_sum_mod(tjf.FR, at))


@pytest.mark.parametrize("field", ["fr", "fq"])
def test_scan_routes_match_jfield(field):
    """The kernel routes of batch_inv_scan and _prefix_prod (written with
    prodscan: here its plain version), as CUDA tensors take them (the grand
    products over Fr, keygen's window-table normalisation over Fq), against
    halo2tpu's batch_inv_scan and _prefix_prod."""
    p, sj, st = SPECS[field]
    rng = np.random.default_rng(19)
    xs = [1 + v for v in _vals(rng, p - 1, 40)]
    aj, at = _pair(sj, xs)
    _same(jjf.batch_inv_scan(sj, aj), tjf._batch_inv_prodscan(st, at))
    _same(jjf._prefix_prod(sj, aj), tjf._prefix_prod_scan(st, at))
    assert st.decode(tjf._batch_inv_prodscan(st, at)) == [
        pow(x, -1, p) for x in xs]


def test_prefix_prod_batched_columns():
    """The blocked scan runs over axis 0 with batch columns behind it."""
    rng = np.random.default_rng(14)
    cols = [[1 + v for v in _vals(rng, R - 1, 37)] for _ in range(3)]
    t = torch.stack([tjf.FR.encode(c, "cpu") for c in cols], dim=1)
    out = tjf._prefix_prod(tjf.FR, t)
    for j, c in enumerate(cols):
        acc, want = 1, []
        for v in c:
            acc = acc * v % R
            want.append(acc)
        assert tjf.FR.decode(out[:, j]) == want


def test_encodings():
    rng = np.random.default_rng(15)
    vals = _vals(rng, R, 24)
    u16 = tjf.ints_to_limbs16(vals)
    assert tjf.limbs_to_ints(u16) == vals
    assert tjf.limbs_to_ints(tjf.ints_to_limbs(vals)) == vals
    assert tjf.limbs_to_int(tjf.int_to_limbs(vals[0])) == vals[0]
    assert tjf.FR.decode(tjf.FR.encode_packed(u16, "cpu")) == vals
    _same(jjf.FR.encode_packed(u16), tjf.FR.encode_packed(u16, "cpu"))
    # narrow wire: small values on rows < split, full limbs after
    small = [int(v) for v in rng.integers(0, 1 << 16, 12)]
    main = np.array([small[:8] + [0] * 4], "<u2")
    tail = tjf.ints_to_limbs16(vals[:4])[None]
    got = tjf.FR.encode_narrow_stack(main, tail, 8, "cpu")
    _same(jjf.FR.encode_narrow_stack(main, tail, 8), got)
    assert tjf.FR.decode(got[0]) == small[:8] + vals[:4]


def test_convert_round_trips(tmp_path):
    rng = np.random.default_rng(16)
    arr = rng.integers(0, 1 << 16, (5, 3, 16), dtype=np.uint32)
    t = convert.from_jax_limbs(arr)
    assert t.shape == (5, 3, 8) and t.dtype == torch.int32
    assert np.array_equal(convert.to_jax_limbs(t), arr)
    lm = np.ascontiguousarray(np.transpose(arr, (1, 2, 0)))   # (3, 16, 5)
    pts = convert.points_from_limb_major(lm)
    assert torch.equal(pts, t)
    assert np.array_equal(convert.points_to_limb_major(pts), lm)
    tab = rng.integers(0, 1 << 16, (3, 256, 16, 4), dtype=np.uint16)
    pt = convert.msm_table_from_jax(tab)
    assert pt.shape == (256, 4, 3, 8)
    assert np.array_equal(convert.msm_table_to_jax(pt), tab)
    # entry (w, i, coord) holds the JAX table's limbs of that entry
    assert np.array_equal(convert.to_jax_limbs(pt[7, 2, 1]), tab[1, 7, :, 2])
    # halo2tpu's on-disk table file (.cache/msm_table_<tag>.npy)
    np.save(tmp_path / "msm_table_x.npy", tab)
    assert torch.equal(convert.load_jax_msm_table(
        str(tmp_path / "msm_table_x.npy"), "cpu"), pt)
