"""The NTT's entries (forward, inverse, the coset pre-scale and the h-chunk
post-scale) against halo2tpu's ntt / intt and jfield.mont_mul composed as
JaxEngine composes them (halo2tpu/plonk/engine.py: coeff_to_part_stack,
parts_to_h_chunks), on CPU tensors (the plain versions); and the NTT
kernel's schedule (csrc/ntt.cu at ops/ntt.py::pass_shapes's passes:
bit-reversed loads, in-place radix-2 stages with the kernel's twiddle
indices, the twiddles between passes, the fused scales and the output
placement), written out in torch, against the plain entries.  Exact
equality: these are finite-field values."""
from functools import lru_cache

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo2tpu.fields import jfield as jjf
from halo2tpu.fields.bn254 import fr_root_of_unity
from halo2tpu.ops import ntt as jntt
from halo2tpu_torch import convert
from halo2tpu_torch.fields.bn254 import R
from halo2tpu_torch.fields.jfield import FR, add, mont_mul, neg, sub
from halo2tpu_torch.ops import ntt as tntt

torch.set_num_threads(1)

ENTRIES = ("ntt", "intt", "coset", "h_chunk")
C_MAX = 8
SHIFT = 7               # the coset's generator power (a part's shift)


def _pows(c: int, n: int) -> torch.Tensor:
    p = [1] * n
    for i in range(1, n):
        p[i] = p[i - 1] * c % R
    return FR.encode(p, "cpu")


def _jax(t):
    return jnp.asarray(convert.to_jax_limbs(t))


@lru_cache(maxsize=None)
def _case(k: int):
    """(stack (n, C_MAX, 8), pre, post, plan, {entry: halo2tpu's output})
    at n = 2^k: JAX transforms all C_MAX columns at once."""
    n = 1 << k
    rng = np.random.default_rng(70 + k)
    vals = [int.from_bytes(rng.bytes(32), "big") % R
            for _ in range(n * C_MAX)]
    a = FR.encode(vals, "cpu").reshape(n, C_MAX, 8)
    pre, post = _pows(SHIFT, n), _pows(pow(SHIFT, -1, R), n)
    a_j = _jax(a)
    plan_j = jntt.get_plan(n, fr_root_of_unity(k))

    def rows(v):
        return jnp.broadcast_to(_jax(v)[:, None, :], a_j.shape)

    ref = {"ntt": jntt.ntt(plan_j, a_j),
           "intt": jntt.intt(plan_j, a_j),
           "coset": jntt.ntt(plan_j, jjf.mont_mul(jjf.FR, a_j, rows(pre))),
           "h_chunk": jjf.mont_mul(jjf.FR, jntt.intt(plan_j, a_j),
                                   rows(post))}
    plan = tntt.get_plan(n, fr_root_of_unity(k), "cpu")
    return a, pre, post, plan, {e: np.asarray(v) for e, v in ref.items()}


def _port(entry, plan, a, pre, post):
    if entry == "ntt":
        return tntt.ntt(plan, a)
    if entry == "intt":
        return tntt.intt(plan, a)
    if entry == "coset":
        return tntt.ntt(plan, a, pre=pre)
    return tntt.intt(plan, a, post=post)


@pytest.mark.parametrize("entry", ENTRIES)
@pytest.mark.parametrize("k", [4, 6, 8, 10])
def test_entry_matches_jax_engine(k, entry):
    """C = 1, 3 and 8 columns and the batch-less (n, 8) shape."""
    a, pre, post, plan, ref = _case(k)
    for C in (1, 3, C_MAX):
        got = _port(entry, plan, a[:, :C].contiguous(), pre, post)
        assert got.shape == (1 << k, C, 8)
        assert np.array_equal(convert.to_jax_limbs(got), ref[entry][:, :C])
    got = _port(entry, plan, a[:, 0].contiguous(), pre, post)
    assert np.array_equal(convert.to_jax_limbs(got), ref[entry][:, 0])


# -- the kernel's schedule --------------------------------------------------

def _bitrev(r: torch.Tensor, bits: int) -> torch.Tensor:
    out = torch.zeros_like(r)
    for b in range(bits):
        out |= ((r >> b) & 1) << (bits - 1 - b)
    return out


def _kernel_schedule(plan, a, pre=None, post=None, scale=None):
    """csrc/ntt.cu::ntt_pass_kernel for every pass of pass_shapes, in
    torch: a pass reads its input as L rows of W lines."""
    n = plan.n
    C = a.numel() // (n * 8)
    passes = tntt.pass_shapes(plan.logn, C)
    x = a.reshape(-1, 8)
    for i, (log_l, W, S, twiddle) in enumerate(passes):
        L = 1 << log_l
        first, last = i == 0, i == len(passes) - 1
        r = torch.arange(L)[:, None]                  # position in a line
        g = torch.arange(W)[None, :]                  # line
        rows_per_line = W // C
        m = x.reshape(L, W, 8)
        if first and pre is not None:
            m = mont_mul(FR, m, pre[r * rows_per_line + g // C])
        y = torch.empty_like(m)
        y[_bitrev(torch.arange(L), log_l)] = m
        for s in range(1, log_l + 1):
            half = 1 << (s - 1)
            bi = torch.arange(L // 2)
            mm = bi & (half - 1)
            ii = ((bi >> (s - 1)) << s) | mm
            jj = ii + half
            w = plan.tw_flat[mm << (plan.logn - s)][:, None]
            u, v = y[ii], mont_mul(FR, y[jj], w)
            y[ii], y[jj] = add(FR, u, v), sub(FR, u, v)
        if twiddle:
            t = (g // C) * r
            w = plan.tw_flat[t & (n // 2 - 1)]
            y = mont_mul(FR, y, torch.where((t >= n // 2)[..., None],
                                            neg(FR, w), w))
        if last and scale is not None:
            y = mont_mul(FR, y, scale)
        if last and post is not None:
            y = mont_mul(FR, y, post[r * rows_per_line + g // C])
        o = (g // S) * (L * S) + r * S + g % S
        out = torch.empty_like(x)
        out[o.reshape(-1)] = y.reshape(-1, 8)
        x = out
    return x.reshape(a.shape)


def test_pass_shapes():
    """One pass up to 2^10 points; beyond, lines of 2^ceil(k/2) points,
    then 2^floor(k/2), every pass covering the whole stack."""
    assert tntt.pass_shapes(10, 3) == [(10, 3, 3, False)]
    assert tntt.pass_shapes(15, 64) == [(8, 64 << 7, 64, True),
                                        (7, 64 << 8, 64 << 8, False)]
    for k in range(1, 21):
        for log_l, W, S, _ in tntt.pass_shapes(k, 5):
            assert log_l <= tntt.NTT_MAX_LOG_L and (W << log_l) == 5 << k


@pytest.mark.parametrize("entry", ENTRIES)
@pytest.mark.parametrize("k", [1, 4, 10, 11, 12])
def test_kernel_schedule_matches_plain(k, entry):
    n = 1 << k
    rng = np.random.default_rng(90 + k)
    plan = tntt.get_plan(n, fr_root_of_unity(k), "cpu")
    inv_plan = tntt.get_plan(n, pow(fr_root_of_unity(k), -1, R), "cpu")
    pre, post = _pows(SHIFT, n), _pows(pow(SHIFT, -1, R), n)
    for C in (1, 3):
        vals = [int.from_bytes(rng.bytes(32), "big") % R
                for _ in range(n * C)]
        a = FR.encode(vals, "cpu").reshape(n, C, 8)
        want = _port(entry, plan, a, pre, post)
        if entry in ("ntt", "coset"):
            got = _kernel_schedule(plan, a,
                                   pre=pre if entry == "coset" else None)
        else:
            got = _kernel_schedule(inv_plan, a, scale=inv_plan.n_inv,
                                   post=post if entry == "h_chunk" else None)
        assert torch.equal(got, want)
