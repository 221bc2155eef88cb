"""The linear scan (ops/cuda_field.py::linscan, on CPU tensors its plain
version) and the engine methods built on it and on field programs
(TorchEngine.div_linear, eval_polys, weighted_sum) against halo2tpu's
_prefix_sum_mod, suffix_sum_mod, _div_linear_jit, _eval_group_jit and
_wsum_jit (XLA on CPU), at n in {1, 2, 3, 16, 1000, 2^12}, multipliers 1,
p - 1 and random, one and several columns; and the field_linscan kernel's
schedule (csrc/field_linscan.cu at cuda_field.scan_shapes: the padded
chunks, each thread's run, the block scan with its powers, the carry pass
and the rescan, forward and reverse), written out in torch, against the
plain scan.  Exact equality of raw Montgomery limbs: these are
finite-field values."""
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


# -- the kernel's schedule, written out in torch -----------------------------

def _fold(x, v, a_m):
    """x * a + v (a_m: a's Montgomery form, None for a = 1)."""
    return add_plain(FR, x if a_m is None else mont_mul_plain(FR, x, a_m), v)


def _pass(v, n, nb, run, threads, totals, reverse, exclusive, carry, a):
    """One launch of field_linscan_kernel over v (C, n, 8): grid (nb, C),
    `threads` threads a block, each `run` elements; logical position q = j
    + pad with pad = nb * chunk - n zeros first; j is row j (forward) or
    row n - 1 - j (reverse).  Returns the block totals (C, nb, 8) or the
    output (C, n, 8)."""
    C = v.shape[0]
    chunk = threads * run
    pad = nb * chunk - n
    assert 0 <= pad < chunk
    a_m = None if a == 1 else _mont(a)
    steps = [None if a == 1 else _mont(pow(a, run << k, R))
             for k in range(threads.bit_length() - 1)]
    rows = torch.arange(n)
    order = rows.flip(0) if reverse else rows            # row of each j
    seq = torch.cat([torch.zeros((C, pad, 8), dtype=torch.int32),
                     v[:, order]], 1).reshape(C, nb, threads, run, 8)
    T = torch.zeros((C, nb, threads, 8), dtype=torch.int32)
    for s in range(run):
        T = _fold(T, seq[:, :, :, s], a_m)
    cin = (torch.zeros((C, nb, 8), dtype=torch.int32) if carry is None
           else carry)
    if carry is not None:
        T = T.clone()
        T[:, :, 0] = add_plain(FR, T[:, :, 0], cin if a == 1 else
                               mont_mul_plain(FR, cin, steps[0]))
    for k, step in enumerate(steps):
        d = 1 << k
        prev = T[:, :, :threads - d]
        T = torch.cat([T[:, :, :d], add_plain(
            FR, T[:, :, d:],
            prev if a == 1 else mont_mul_plain(FR, prev, step))], 2)
    if totals:
        return T[:, :, -1]
    X = torch.cat([cin[:, :, None], T[:, :, :-1]], 2)
    outs = []
    for s in range(run):
        if exclusive:
            outs.append(X)
        X = _fold(X, seq[:, :, :, s], a_m)
        if not exclusive:
            outs.append(X)
    q = torch.stack(outs, 3).reshape(C, nb * chunk, 8)[:, pad:]
    out = torch.empty_like(q)
    out[:, order] = q
    return out


def _schedule(v, a, reverse, exclusive, totals, threads):
    """The C entry h2_field_linscan: one launch for one block, else block
    totals, their scan with multiplier a^chunk (one block, run2 a thread,
    exclusive) and the scan with each block's carry."""
    n = v.shape[1]
    run, nb, run2 = cuda_field.scan_shapes(n, a == 1)
    if nb == 1:
        out = _pass(v, n, 1, run, threads, totals, reverse, exclusive, None,
                    a)
        return out[:, 0] if totals else out
    tot = _pass(v, n, nb, run, threads, True, reverse, False, None, a)
    A = pow(a, threads * run, R)
    if totals:
        return _pass(tot, nb, 1, run2, threads, True, False, False, None,
                     A)[:, 0]
    carry = _pass(tot, nb, 1, run2, threads, False, False, True, None, A)
    return _pass(v, n, nb, run, threads, False, reverse, exclusive, carry, a)


MODES = {"full": (False, False), "exclusive": (True, False),
         "totals": (False, True)}


def test_scan_shapes_cover_the_rows():
    for n in [1, 3, 1000, 1 << 15, (1 << 20) + 1, 1 << 22]:
        for one in (False, True):
            run, nb, run2 = cuda_field.scan_shapes(n, one)
            chunk = cuda_field.SCAN_THREADS * run
            assert (nb - 1) * chunk < n <= nb * chunk
            assert run2 * cuda_field.SCAN_THREADS >= nb


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("mult", ["one", "random"])
@pytest.mark.parametrize("n,threads", [(1000, 256), (1 << 12, 256),
                                       (5000, 256), (3, 4), (1000, 4),
                                       (1, 4)],
                         ids=["1000", "4096", "5000", "3-t4", "1000-t4",
                              "1-t4"])
def test_scan_schedule_matches_plain(monkeypatch, n, threads, mult, mode):
    """The kernel's schedule at its 256 threads a block (one to five
    blocks a column) and at 4 (up to 63 blocks, the carry pass with runs of
    16 totals a thread), two columns, forward and reverse, equals the
    plain scan."""
    monkeypatch.setattr(cuda_field, "SCAN_THREADS", threads)
    a = MULTS[mult]
    exclusive, totals = MODES[mode]
    v, _ = _pair(_vals(500 + n, 2 * n), (2, n))
    for reverse in (False, True):
        want = linscan_plain(FR, v, a, reverse, exclusive, totals)
        got = _schedule(v, a, reverse, exclusive, totals, threads)
        assert torch.equal(got, want), (reverse, cuda_field.scan_shapes(
            n, a == 1))
