"""The scans (ops/cuda_field.py::linscan and prodscan, on CPU tensors
their plain versions) and the engine methods built on them and on field
programs (TorchEngine.div_linear, eval_polys, weighted_sum) against
halo2tpu's _prefix_sum_mod, suffix_sum_mod, _prefix_prod, batch_inv_scan,
_div_linear_jit, _eval_group_jit and _wsum_jit (XLA on CPU), at n in {1,
2, 3, 16, 1000, 2^12}, multipliers 1, p - 1 and random, one and several
columns; and the field_linscan kernel's single-pass schedule
(csrc/field_linscan.cu at cuda_field.scan_shapes: the padded chunks, each
thread's run, the block scan with its powers, the decoupled look-back over
windows of blocks and the rescan, forward and reverse, for the sum and the
linear scan) and the stream kernel's that the product scan takes
(cuda_field.stream_shapes: runs streamed through tiles of shared memory,
the unit's shuffle scans, the look-back, the refold), written out in
torch, against the plain scans and halo2tpu's prefix products.  Exact
equality of raw Montgomery limbs: these are finite-field values."""
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo2tpu.fields import jfield as jjf
from halo2tpu.plonk import engine as jeng
from halo2tpu_torch import convert
from halo2tpu_torch.fields.bn254 import R
from halo2tpu_torch.fields.jfield import FR
from halo2tpu_torch.ops import cuda_field
from halo2tpu_torch.ops.cuda_field import (add_plain, linscan_plain,
                                           mont_mul_plain)
from halo2tpu_torch.plonk.domain import make_domain
from halo2tpu_torch.plonk.engine import TorchEngine
from halo2tpu_torch.plonk.srs import setup

torch.set_num_threads(1)

SIZES = [1, 2, 3, 16, 1000, 1 << 12]
MULTS = {"one": 1, "p-1": R - 1, "random": 0x2A6F3B1C9D5E7F8091A2B3C4D5E6F708
         % R}


def _vals(seed: int, m: int) -> list:
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "big") % R for _ in range(m)]


def _pair(vals, shape=None):
    """Montgomery encodings of vals: the port's tensor (CPU) and halo2tpu's
    array, the same bytes."""
    t = FR.encode(vals, "cpu")
    if shape is not None:
        t = t.reshape(shape + (8,))
    return t, jnp.asarray(convert.to_jax_limbs(t))


def _same(got: torch.Tensor, want) -> None:
    assert np.array_equal(convert.to_jax_limbs(got), np.asarray(want))


def _mont(c: int) -> torch.Tensor:
    return FR.encode([c], "cpu")[0]


@pytest.fixture(scope="module")
def engine():
    k = 6
    return TorchEngine(make_domain(k, 3), setup(k, cache=False), "cpu")


@pytest.mark.parametrize("reverse", [False, True], ids=["prefix", "suffix"])
@pytest.mark.parametrize("n", SIZES)
def test_sums_match_jfield(n, reverse):
    """a = 1: the prefix and suffix sums, the port's jfield entries and the
    scan itself, against halo2tpu's _prefix_sum_mod / suffix_sum_mod."""
    from halo2tpu_torch.fields import jfield as tjf
    t, j = _pair(_vals(n, n))
    if reverse:
        want = jjf.suffix_sum_mod(jjf.FR, j)
        _same(tjf.suffix_sum_mod(FR, t), want)
    else:
        want = jjf._prefix_sum_mod(jjf.FR, j)
        _same(tjf._prefix_sum_mod(FR, t), want)
    _same(cuda_field.linscan(FR, t, 1, reverse=reverse), want)


@pytest.mark.parametrize("reverse", [False, True], ids=["prefix", "suffix"])
def test_sums_over_columns_match_jfield(reverse):
    """A (C, n, 8) stack scans each column; and a strided (n, C, 8) stack
    seen as columns gives the same."""
    C, n = 3, 1000
    t, _ = _pair(_vals(5, C * n), (C, n))
    ref = jjf.suffix_sum_mod if reverse else jjf._prefix_sum_mod
    got = cuda_field.linscan(FR, t, 1, reverse=reverse)
    got_t = cuda_field.linscan(FR, t.transpose(0, 1).contiguous()
                               .transpose(0, 1), 1, reverse=reverse)
    for c in range(C):
        want = ref(jjf.FR, jnp.asarray(convert.to_jax_limbs(t[c])))
        _same(got[c], want)
        _same(got_t[c], want)


@pytest.mark.parametrize("mult", list(MULTS), ids=list(MULTS))
@pytest.mark.parametrize("n", SIZES)
def test_div_linear_matches_halo2tpu(engine, n, mult):
    """vec(X) / (X - a) as the exclusive reverse scan with multiplier a
    equals _div_linear_jit's power vectors around a suffix sum."""
    a = MULTS[mult]
    t, j = _pair(_vals(100 + n, n))
    want = jeng._div_linear_jit(j, jjf.FR.encode([a])[0],
                                jjf.FR.encode([pow(a, -1, R)])[0])
    _same(engine.div_linear(t, a), want)


@pytest.mark.parametrize("mult", list(MULTS), ids=list(MULTS))
def test_eval_polys_matches_halo2tpu(engine, mult):
    """A group of polys of 1000, 3, 1000 and 1 coefficients (padded to
    the longest, not a power of two) and a group of one at n = 1: the
    reverse scan's totals equal _eval_group_jit's, raw, and eval_polys
    gives the same integers."""
    x = MULTS[mult]
    lens = [1000, 3, 1000, 1]
    polys = [_pair(_vals(200 + i, m))[0] for i, m in enumerate(lens)]
    n = max(lens)
    stacked = torch.stack([torch.nn.functional.pad(p, (0, 0, 0, n - len(p)))
                           for p in polys])
    pows = jeng._pow_block(jjf.FR.encode([x])[0], n)
    want = jeng._eval_group_jit(jnp.asarray(convert.to_jax_limbs(stacked)),
                                pows)
    _same(cuda_field.linscan(FR, stacked, x, reverse=True, totals=True),
          want)
    got = engine.eval_polys([(p, x) for p in polys] + [(polys[3], x + 1)])
    assert got[:4] == jjf.FR.decode(want)
    assert got[4] == jjf.FR.decode(jeng._eval_group_jit(
        jnp.asarray(convert.to_jax_limbs(polys[3]))[None],
        jeng._pow_block(jjf.FR.encode([x + 1])[0], 1)))[0]


@pytest.mark.parametrize("m", [1, 3, 64, 70])
def test_weighted_sum_matches_halo2tpu(engine, m):
    """sum_i c_i v_i as field programs (chunks of 64 vectors) equals
    _wsum_jit over all m at once; n = 1000 rows."""
    n = 1000
    t, j = _pair(_vals(300 + m, m * n), (m, n))
    coefs = _vals(400 + m, m)
    want = jeng._wsum_jit(j, jjf.FR.encode(coefs))
    _same(engine.weighted_sum(list(t.unbind(0)), coefs), want)
    _same(engine._wsum(list(t[:1].unbind(0)), FR.encode(coefs[:1], "cpu")),
          jeng._wsum_jit(j[:1], jjf.FR.encode(coefs[:1])))


# -- prodscan against halo2tpu's prefix products and batch inversion --------

@pytest.mark.parametrize("n", [1, 2, 3, 16, 37, 1000])
def test_prodscan_matches_jfield(n):
    """prodscan (on CPU tensors prodscan_plain), every direction and output,
    over an (n, 8) vector and a (C, n, 8) stack, against halo2tpu's
    _prefix_prod (forward inclusive; the reverse ones through flips, the
    exclusive ones shifted with a leading 1) and batch_inv_scan (the
    exclusive prefix times the exclusive suffix times the total's inverse
    is the port's kernel route, written with prodscan)."""
    from halo2tpu_torch.fields import jfield as tjf
    C = 3
    t, _ = _pair([1 + v % (R - 1) for v in _vals(600 + n, C * n)], (C, n))
    one = FR.encode([1], "cpu")
    for c in range(C):
        j = jnp.asarray(convert.to_jax_limbs(t[c]))
        fwd = jjf._prefix_prod(jjf.FR, j)
        rev = jnp.flip(jjf._prefix_prod(jjf.FR, jnp.flip(j, 0)), 0)
        want = {(False, False): fwd, (True, False): rev,
                (False, True): np.concatenate(
                    [convert.to_jax_limbs(one), np.asarray(fwd)[:-1]]),
                (True, True): np.concatenate(
                    [np.asarray(rev)[1:], convert.to_jax_limbs(one)])}
        for (reverse, exclusive), w in want.items():
            _same(cuda_field.prodscan(FR, t[c], reverse, exclusive), w)
            _same(cuda_field.prodscan(FR, t, reverse, exclusive)[c], w)
        _same(cuda_field.prodscan(FR, t[c], totals=True), np.asarray(fwd)[-1])
        _same(cuda_field.prodscan(FR, t, totals=True)[c], np.asarray(fwd)[-1])
        _same(cuda_field.prodscan(FR, t, reverse=True, totals=True)[c],
              np.asarray(fwd)[-1])
        _same(tjf._batch_inv_prodscan(FR, t[c]), jjf.batch_inv_scan(jjf.FR, j))
    # the prefix product over the columns behind axis 0, as _prefix_prod
    # takes them on CUDA
    _same(tjf._prefix_prod_scan(FR, t.transpose(0, 1)),
          np.stack([np.asarray(jjf._prefix_prod(jjf.FR, jnp.asarray(
              convert.to_jax_limbs(t[c])))) for c in range(C)], 1))


# -- the kernel's schedule, written out in torch -----------------------------

KINDS = {"one": ("one", 1), "random": ("a", MULTS["random"])}


def _fold(kind, x, v, a_m):
    """x_(j-1) -> x_j: x + v or x a + v (a_m: a's Montgomery form)."""
    if kind == "one":
        return add_plain(FR, x, v)
    return add_plain(FR, mont_mul_plain(FR, x, a_m), v)


def _combine(kind, left, right, pw):
    """A left segment's x carried over a right one's (pw: a^(its length))."""
    if kind == "one":
        return add_plain(FR, left, right)
    return add_plain(FR, mont_mul_plain(FR, left, pw), right)


def _look_back(comb, mul, look, ident, total, rng, window):
    """csrc/field_linscan.cu's look_back (both kernels) over every block of
    every column: rng decides which blocks before block b had published
    their inclusive prefix by then (block 0 always), as concurrent blocks
    would; each window's values from the last inclusive prefix on are
    combined toward the last lane in only as many shuffle rounds as they
    need.  look[r] = A^(2^r) for r <= log2(window), A the multiplier over a
    block; mul carries the linear scan's multiplier from window to window
    (None for the other scans).  Returns (x before each block, x through
    it), (C, nb, 8) each."""
    C, nb = total.shape[0], total.shape[1]
    wlog = window.bit_length() - 1
    agg, incl = total, total.clone()
    E = ident.expand(C, nb, 8).clone()
    for b in range(1, nb):
        shown = torch.from_numpy(rng.random(b) < 0.4)
        shown[0] = True
        end, first_window, mult, e_b = b, True, None, None
        while True:
            js = torch.arange(end - window, end)
            st_incl = (js < 0) | shown[js.clamp(min=0)]
            y = torch.where(st_incl[None, :, None], incl[:, js.clamp(min=0)],
                            agg[:, js.clamp(min=0)])
            y = torch.where((js < 0)[None, :, None], ident, y)
            hi = int(st_incl.nonzero().max()) if st_incl.any() else -1
            y = torch.where((torch.arange(window) < hi)[None, :, None],
                            ident, y)
            live = window - hi if hi >= 0 else window
            r = 0
            while (1 << r) < live:          # toward the last lane
                z = _shift_up(y, 1 << r, 1)
                sel = ((window - 1 - torch.arange(window)) % (2 << r)) == 0
                y = torch.where(sel[None, :, None], comb(z, y, look[r]), y)
                r += 1
            y = y[:, -1]
            if first_window:
                e_b, mult = y, look[wlog]
            else:
                e_b = comb(y, e_b, mult)
                if mul is not None:
                    mult = mul(mult, look[wlog])
            first_window = False
            if hi >= 0:
                break
            end -= window
        E[:, b] = e_b
        incl[:, b] = comb(e_b, total[:, b], look[0])
    return E, incl


def _shift_up(x, d, dim):
    """__shfl_up_sync along `dim`: lane l reads lane l - d, lanes below d
    their own value."""
    m = x.shape[dim]
    src = torch.arange(m)
    src = torch.where(src >= d, src - d, src)
    return x.index_select(dim, src)


def _schedule(v, kind, a, reverse, exclusive, totals, threads, window, rng,
              wave):
    """field_linscan_kernel's one launch over v (C, n, 8) at `threads`
    threads a block and look-back windows of `window` blocks: grid of nb
    blocks a column in ticket order; logical position q = j + pad with pad
    = nb * chunk - n identity elements first; j is row j (forward) or row
    n - 1 - j (reverse).  Each block folds its threads' runs, scans the
    run totals (Hillis-Steele), publishes its aggregate and looks back:
    rng decides which blocks before it had published their inclusive
    prefix by then (block 0 always), as concurrent blocks would.  `wave`:
    the blocks a wave of the card holds, which sets the run.  Returns the
    totals (C, 8) or the output (C, n, 8)."""
    C, n = v.shape[0], v.shape[1]
    run, nb = cuda_field.scan_shapes(n, kind, C, wave)
    chunk = threads * run
    pad = nb * chunk - n
    assert 0 <= pad < chunk
    ident = torch.zeros(8, dtype=torch.int32)
    a_m = _mont(a) if kind == "a" else None
    steps = [_mont(pow(a, run << k, R)) for k in range(threads.bit_length() - 1)]
    A = pow(a, chunk, R)
    look = [_mont(pow(A, 1 << r, R)) for r in range(window.bit_length())]
    rows = torch.arange(n)
    order = rows.flip(0) if reverse else rows            # row of each j
    seq = torch.cat([ident.expand(C, pad, 8), v[:, order]], 1).reshape(
        C, nb, threads, run, 8)
    j_of = (torch.arange(nb * chunk) - pad).reshape(nb, threads, run)
    # each thread's run total, padded elements skipped
    T = ident.expand(C, nb, threads, 8).clone()
    for s in range(run):
        j = j_of[:, :, s]
        vs = seq[:, :, :, s]
        start = (j == 0) | ((j > 0) & (s == 0))
        T = torch.where((j < 0)[None, :, :, None], T, torch.where(
            start[None, :, :, None], vs, _fold(kind, T, vs, a_m)))
    for k, step in enumerate(steps):
        d = 1 << k
        T = torch.cat([T[:, :, :d], _combine(kind, T[:, :, :threads - d],
                                             T[:, :, d:], step)], 2)
    total = T[:, :, -1]                                   # (C, nb, 8)
    E, incl = _look_back(
        lambda l, r, pw: _combine(kind, l, r, pw),
        (lambda x, y: mont_mul_plain(FR, x, y)) if kind == "a" else None,
        look, ident, total, rng, window)
    if totals:
        return incl[:, -1]
    lin = torch.stack([_mont(pow(a, run * t, R)) for t in range(threads)])
    S = torch.cat([ident.expand(C, nb, 1, 8), T[:, :, :-1]], 2)
    Eb = E[:, :, None].expand(C, nb, threads, 8)
    X = _combine(kind, Eb, S, lin[None, None])
    X[:, 0] = S[:, 0]                                     # block 0: no prefix
    X[:, :, 0] = E                                        # thread 0
    outs = []
    for s in range(run):
        vs = seq[:, :, :, s]
        if exclusive:
            outs.append(X)
        X = torch.where((j_of[:, :, s] < 0)[None, :, :, None], X,
                        _fold(kind, X, vs, a_m))
        if not exclusive:
            outs.append(X)
    q = torch.stack(outs, 3).reshape(C, nb * chunk, 8)[:, pad:]
    out = torch.empty_like(q)
    out[:, order] = q
    return out


MODES = {"full": (False, False), "exclusive": (True, False),
         "totals": (False, True)}


def test_scan_shapes_cover_the_rows():
    """Every row in a block, the first block padded; with products, short
    runs while the grid fits one wave (a proof's div_linear), long ones
    beyond (its evaluation groups)."""
    for n in [1, 3, 1000, 1 << 15, (1 << 20) + 1, 1 << 22]:
        for kind in cuda_field.SCAN_KINDS:
            for cols in (1, 16, 80):
                run, nb = cuda_field.scan_shapes(n, kind, cols)
                chunk = cuda_field.SCAN_THREADS * run
                assert (nb - 1) * chunk < n <= nb * chunk
    shapes = cuda_field.scan_shapes
    assert shapes(1 << 15, "a") == (4, 32)
    assert shapes(1 << 15, "a", 16) == (16, 8)
    assert shapes(1 << 20, "a") == (16, 256)
    assert shapes(1 << 15, "one", 1) == (16, 8)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("mult", ["one", "random"])
@pytest.mark.parametrize("n,threads", [(1000, 256), (1 << 12, 256),
                                       (5000, 256), (3, 4), (1000, 4),
                                       (1, 4)],
                         ids=["1000", "4096", "5000", "3-t4", "1000-t4",
                              "1-t4"])
def test_scan_schedule_matches_plain(monkeypatch, n, threads, mult, mode):
    """The kernel's single-pass schedule (one launch: runs, the block scan,
    the look-back, the rescan) at its 256 threads a block (one to five
    blocks a column) and at 4 (up to 63 blocks, looking back 32 and 4
    blocks a window, with random blocks already inclusive), short and long
    runs, two columns, forward and reverse, for the sum and a random
    multiplier, equals the plain scan."""
    monkeypatch.setattr(cuda_field, "SCAN_THREADS", threads)
    kind, a = KINDS[mult]
    exclusive, totals = MODES[mode]
    v, _ = _pair(_vals(500 + n, 2 * n), (2, n))
    rng = np.random.default_rng(n * threads)
    for reverse in (False, True):
        want = linscan_plain(FR, v, a, reverse, exclusive, totals)
        # a wave of 264 blocks and of 1 (long runs at the small sizes)
        for window, wave in ((32, 264), (4, 264), (4, 1)):
            got = _schedule(v, kind, a, reverse, exclusive, totals, threads,
                            window, rng, wave)
            assert torch.equal(got, want), (reverse, window, wave)


# -- the product scan's kernel (field_linscan_stream_kernel) ----------------

STREAM_WARP = 32       # lanes a warp: the unit's shuffle scans


def _tile_map(k, warp):
    """A warp's tile k: 16-byte word u (lane u % 32 copies it) is half u & 1
    of element k of thread u // 2's run; it lands at word u + u // 2 of the
    tile (one pad word a thread).  Returns (thread, 16-byte half, slot)."""
    u = torch.arange(warp * 2)
    tl = u // 2
    return tl, u & 1, u + tl


def _stream_schedule(spec, v, reverse, exclusive, totals, rng, wave,
                     window=32):
    """field_linscan_stream_kernel's one launch over v (C, n, 8), written
    out at cuda_field's STREAM_THREADS threads a unit and STREAM_WARP lanes
    a warp, looking back `window` units a window: a grid of nb units a
    column in ticket order; logical position q = j + pad with pad = nb *
    chunk - n ones first; j is row j (forward) or row n - 1 - j (reverse).
    Each warp streams its runs through tiles (the word map of _tile_map;
    every element is read from its tile slot) and folds each run; the unit
    scans the run totals by shuffles in each warp and then the warp totals,
    publishes its aggregate and looks back: rng decides which units before
    it had published their inclusive prefix by then (unit 0 always), as
    concurrent units would.  Then each warp streams its runs again, folds
    each from the prefix before it, writes the outputs in place in the tile
    and stores the tile through the same map.  `wave`: the units a wave of
    the card holds, which sets the run.  Returns the totals (C, 8) or the
    output (C, n, 8)."""
    threads, warp = cuda_field.STREAM_THREADS, STREAM_WARP
    warps = threads // warp
    lane_log, warp_log = warp.bit_length() - 1, warps.bit_length() - 1
    C, n = v.shape[0], v.shape[1]
    run, nb = cuda_field.stream_shapes(n, C, wave)
    assert 2 <= run <= cuda_field.STREAM_MAX_RUN
    chunk, slot_words = threads * run, 3
    pad = nb * chunk - n
    assert 0 <= pad < chunk
    one = spec.encode([1], "cpu")[0]
    words = v.reshape(C, 2 * n, 4)
    # j of each warp's first element
    q0 = (torch.arange(nb)[:, None] * chunk - pad
          + warp * run * torch.arange(warps)[None])              # (nb, W)

    def mul(left, right):
        return mont_mul_plain(spec, left, right)

    def tile(k):
        """Tile k of every warp, (C, nb, W, warp * slot_words, 4), and the
        map: j of each word, (nb, W, words), its global word, slot."""
        tl, h, slot = _tile_map(k, warp)
        j = q0[:, :, None] + tl * run + k                        # (nb, W, u)
        row = torch.where(j < 0, 0, n - 1 - j if reverse else j)
        g = 2 * row + h
        got = words[:, g]                                        # (C, ., 4)
        got = torch.where((j < 0)[None, ..., None],
                          one.reshape(2, 4)[h].expand_as(got), got)
        sh = torch.zeros(C, nb, warps, warp * slot_words, 4, dtype=torch.int32)
        sh[:, :, :, slot] = got
        return sh, j, g, slot

    at = torch.arange(warp) * slot_words

    def elems(sh):                                       # (C, nb, T, 8)
        e = torch.cat([sh[:, :, :, at], sh[:, :, :, at + 1]], -1)
        return e.reshape(C, nb, threads, 8)

    # pass 1: each run folded
    x = elems(tile(0)[0])
    for k in range(1, run):
        x = mul(x, elems(tile(k)[0]))
    # the shuffle scan in each warp, then of the warp totals
    x = x.reshape(C, nb, warps, warp, 8)
    lane = torch.arange(warp)
    for k in range(lane_log):
        y = _shift_up(x, 1 << k, 3)
        x = torch.where((lane >= 1 << k)[:, None], mul(y, x), x)
    xe = _shift_up(x, 1, 3)
    wt = x[:, :, :, -1]                                         # (C, nb, W, 8)
    for k in range(warp_log):
        y = _shift_up(wt, 1 << k, 2)
        wt = torch.where((torch.arange(warps) >= 1 << k)[:, None], mul(y, wt),
                         wt)
    total = wt[:, :, -1]                                        # (C, nb, 8)
    wex = _shift_up(wt, 1, 2)
    E, incl = _look_back(lambda left, right, pw: mul(left, right), None,
                         [None] * window.bit_length(), one, total, rng,
                         window)
    if totals:
        return incl[:, -1]
    # x before each warp, then before each run
    W = torch.where((torch.arange(nb) == 0)[None, :, None, None], wex,
                    mul(E[:, :, None].expand(C, nb, warps, 8), wex))
    W[:, :, 0] = E
    Wl = W[:, :, :, None].expand(C, nb, warps, warp, 8)
    X = mul(Wl, xe)
    first_block = (torch.arange(nb)[:, None] == 0) & (torch.arange(warps) == 0)
    X = torch.where(first_block[None, :, :, None, None], xe, X)
    X[:, :, :, 0] = Wl[:, :, :, 0]
    X = X.reshape(C, nb, threads, 8)
    # pass 2: fold again from it, outputs in place in the tile, the tile
    # stored through its map (pads skipped)
    out = torch.empty(C, 2 * n, 4, dtype=torch.int32)
    for k in range(run):
        sh, j, g, slot = tile(k)
        nx = mul(X, elems(sh))
        o = (X if exclusive else nx).reshape(C, nb, warps, warp, 8)
        sh[:, :, :, at] = o[..., :4]
        sh[:, :, :, at + 1] = o[..., 4:]
        X = nx
        keep = j >= 0
        out[:, g[keep]] = sh[:, :, :, slot][:, keep]
    return out.reshape(C, n, 8)


def test_stream_shapes_cover_the_rows():
    """Every row in a unit, the first unit padded; short runs while the
    grid fits one wave (a single column of 2^15), runs of 32 beyond (the
    grand products' 80 columns: 8 units a column, 640 in one wave; keygen's
    batch inversions over 2^22 lanes)."""
    for n in [1, 3, 1000, 1 << 15, (1 << 20) + 1, 1 << 22]:
        for cols in (1, 16, 80):
            run, nb = cuda_field.stream_shapes(n, cols)
            chunk = cuda_field.STREAM_THREADS * run
            assert (nb - 1) * chunk < n <= nb * chunk
            assert 2 <= run <= cuda_field.STREAM_MAX_RUN
    shapes = cuda_field.stream_shapes
    assert shapes(1 << 15, 80) == (32, 8)
    assert shapes(1 << 15, 1) == (4, 64)
    assert shapes(1 << 22, 1) == (32, 1024)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("n,threads,warp", [
    (1000, 128, 32), (1 << 12, 128, 32), (5000, 128, 32), (3, 8, 4),
    (1000, 8, 4), (1, 8, 4)],
    ids=["1000", "4096", "5000", "3-t8", "1000-t8", "1-t8"])
def test_stream_schedule_matches_plain(monkeypatch, n, threads, warp, mode):
    """The stream kernel's single-pass schedule (one launch: the runs
    streamed through tiles and folded, the shuffle scans, the look-back,
    the refold) at its 128 threads a unit in warps of 32 (one to ten units
    a column) and at 8 threads in warps of 4 (up to 250 units, looking back
    32 and 4 units a window, with random units already inclusive), short
    and long runs, two columns, forward and reverse, equals the plain
    product scan."""
    monkeypatch.setattr(cuda_field, "STREAM_THREADS", threads)
    monkeypatch.setattr(sys.modules[__name__], "STREAM_WARP", warp)
    exclusive, totals = MODES[mode]
    v, _ = _pair([1 + x % (R - 1) for x in _vals(500 + n, 2 * n)], (2, n))
    rng = np.random.default_rng(n * threads)
    for reverse in (False, True):
        want = cuda_field.prodscan_plain(FR, v, reverse, exclusive, totals)
        # a wave of 660 units and of 1 (long runs at the small sizes)
        for window, wave in ((32, 660), (4, 660), (4, 1)):
            got = _stream_schedule(FR, v, reverse, exclusive, totals, rng,
                                   wave, window)
            assert torch.equal(got, want), (reverse, window, wave)


@pytest.mark.parametrize("field", ["fr", "fq"])
@pytest.mark.parametrize("n,cols", [(1, 1), (1, 80), (255, 1), (255, 80),
                                    (4097, 1), ((1 << 15) + 3, 1)],
                         ids=["1", "1x80", "255", "255x80", "4097",
                              "32771"])
def test_prodscan_schedule_matches_jfield(field, n, cols):
    """The product scan's schedule (the stream kernel) at its 128 threads
    in warps of 32, over Fr (the grand products) and Fq (keygen's window
    table), forward and reverse, every x, the exclusive x and the totals,
    at short runs and (one column, a wave of one unit) long ones, against
    prodscan_plain and, for the first column, against halo2tpu's
    _prefix_prod (forward; the reverse through flips) and, built from the
    exclusive scans as the kernel route builds it, batch_inv_scan."""
    from halo2tpu_torch.fields import jfield as tjf
    spec, jspec = (FR, jjf.FR) if field == "fr" else (tjf.FQ, jjf.FQ)
    rng_v = np.random.default_rng(700 + n + cols)
    vals = [1 + int.from_bytes(rng_v.bytes(32), "big") % (spec.p - 1)
            for _ in range(n * cols)]
    v = spec.encode(vals, "cpu").reshape(cols, n, 8)
    j0 = jnp.asarray(convert.to_jax_limbs(v[0]))
    fwd = np.asarray(jjf._prefix_prod(jspec, j0))
    rev = np.asarray(jnp.flip(jjf._prefix_prod(jspec, jnp.flip(j0, 0)), 0))
    rng = np.random.default_rng(n)
    waves = (660, 1) if cols == 1 and n < 1 << 15 else (660,)
    got = {}
    for reverse in (False, True):
        for mode, (exclusive, totals) in MODES.items():
            want = cuda_field.prodscan_plain(spec, v, reverse, exclusive,
                                             totals)
            for wave in waves:
                out = _stream_schedule(spec, v, reverse, exclusive, totals,
                                       rng, wave)
                assert torch.equal(out, want), (reverse, mode, wave)
            got[reverse, mode] = out
    _same(got[False, "full"][0], fwd)
    _same(got[True, "full"][0], rev)
    _same(got[False, "totals"][0], fwd[-1])
    _same(got[True, "totals"][0], fwd[-1])
    total_inv = tjf.mont_pow(spec, mont_mul_plain(
        spec, got[False, "exclusive"][0, -1], v[0, -1]), spec.p - 2)
    inv = mont_mul_plain(spec, mont_mul_plain(
        spec, got[False, "exclusive"][0], got[True, "exclusive"][0]),
        total_inv)
    _same(inv, jjf.batch_inv_scan(jspec, j0))
