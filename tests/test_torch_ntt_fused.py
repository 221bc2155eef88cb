"""The NTT's entries (forward, inverse, the coset pre-scale and the h-chunk
post-scale) against halo2tpu's ntt / intt and jfield.mont_mul composed as
JaxEngine composes them (halo2tpu/plonk/engine.py: coeff_to_part_stack,
parts_to_h_chunks), on CPU tensors (the plain versions); and the NTT
kernel's schedule (csrc/ntt.cu at ops/ntt.py::pass_shapes's passes and
lines_per_block's blocks: bit-reversed loads, rounds of three radix-2
stages in a thread's 2^3 registers, or one in 2^1, with the shared-memory
exchanges
between them, the staged twiddle indices, the skipped unit twiddles, the
twiddles between passes, the fused scales and the output placement),
written out in torch, against the plain entries.  Exact
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


def _kernel_schedule(plan, a, pre=None, post=None, scale=None, rb=None):
    """csrc/ntt.cu::ntt_pass_kernel for every pass of pass_shapes, in
    torch, every block and thread at once: a pass reads its input as L rows
    of W lines; a block takes 2^lpb lines (lines_per_block), elements e =
    position * 2^lpb + line; a thread holds 2^RB of them (reg_bits): in
    round i thread q holds the elements base | j << lo (j < 2^RB, RB zero
    bits inserted into q at lo), runs the
    round's stages in registers (a product only where the twiddle index m
    is not 0, from the block's staged table omega^(u n / L)), and exchanges
    them through the block's shared memory; round 0 loads bit-reversed
    rows with the pre-scale, the last round stores with the between-pass
    twiddle (none at t = 0), the scale, the post-scale and the output
    placement.  rb: the register bits of every pass (the kernel builds
    both 1 and 3), else reg_bits's.  Returns (output, products run,
    products skipped)."""
    n = plan.n
    C = a.numel() // (n * 8)
    x = a.reshape(-1, 8)
    ran = skipped = 0
    passes = tntt.pass_shapes(plan.logn, C)
    for i, (log_l, W, S, twiddle) in enumerate(passes):
        first, last = i == 0, i == len(passes) - 1
        RB = rb or tntt.reg_bits(log_l, W)
        R = 1 << RB
        lpb = tntt.lines_per_block(log_l, W, RB)
        elems = 1 << (log_l + lpb)
        blocks = -(-W >> lpb)
        T = elems // R
        assert elems <= tntt.NTT_BLOCK_ELEMS and elems >= R
        twl = plan.tw_flat[torch.arange(1 << (log_l - 1))
                           << (plan.logn - log_l)]
        rows_per_line = W // C
        q = torch.arange(T)[None, :, None]              # (1, T, 1)
        j = torch.arange(R)[None, None, :]              # (1, 1, R)
        blk = torch.arange(blocks)[:, None, None]       # (blocks, 1, 1)
        smem = torch.zeros((blocks, elems, 8), dtype=x.dtype)
        out = torch.empty_like(x)
        rounds = -(-log_l // RB)
        for rnd in range(rounds):
            s0 = rnd * RB
            r = min(RB, log_l - s0)
            lo = min(lpb + s0, lpb + log_l - RB)
            base = (q & ((1 << lo) - 1)) | ((q >> lo) << (lo + RB))
            e = (base | (j << lo)).expand(blocks, T, R)  # (blocks, T, R)
            g = (blk << lpb) + (e & ((1 << lpb) - 1))
            pos = e >> lpb
            live = g < W
            if rnd == 0:
                row = _bitrev(pos, log_l)
                regs = torch.zeros((blocks, T, R, 8), dtype=x.dtype)
                regs[live] = x[(row * W + g)[live]]
                if first and pre is not None:
                    pr = row * rows_per_line + g // C
                    regs[live] = mont_mul(FR, regs[live], pre[pr[live]])
                    ran += int(live.sum())
            else:
                regs = smem[blk.expand(blocks, T, R), e]
            for jb in range(RB - r, RB):
                s = lo + jb - lpb + 1
                for jl in range(R):
                    if jl & (1 << jb):
                        continue
                    jh = jl | (1 << jb)
                    m = pos[:, :, jl] & ((1 << (s - 1)) - 1)
                    u, v = regs[:, :, jl].clone(), regs[:, :, jh].clone()
                    mul = m != 0
                    v[mul] = mont_mul(FR, v[mul], twl[m[mul] << (log_l - s)])
                    ran += int((mul & live[:, :, jl]).sum())
                    skipped += int((~mul & live[:, :, jl]).sum())
                    regs[:, :, jl] = add(FR, u, v)
                    regs[:, :, jh] = sub(FR, u, v)
            if rnd + 1 < rounds:
                smem[blk.expand(blocks, T, R), e] = regs
                continue
            k = pos
            y = regs[live]
            gl, kl = g[live], k[live]
            if twiddle:
                t = (gl // C) * kl
                mul = t != 0
                w = plan.tw_flat[t & (n // 2 - 1)]
                w = torch.where((t >= n // 2)[:, None], neg(FR, w), w)
                y[mul] = mont_mul(FR, y[mul], w[mul])
                ran += int(mul.sum())
                skipped += int((~mul).sum())
            if last and scale is not None:
                y = mont_mul(FR, y, scale)
            if last and post is not None:
                y = mont_mul(FR, y, post[kl * rows_per_line + gl // C])
            out[(gl // S) * (S << log_l) + kl * S + gl % S] = y
        x = out
    return x.reshape(a.shape), ran, skipped


def test_pass_shapes():
    """One pass up to 2^10 points; beyond, lines of 2^ceil(k/2) points,
    then 2^floor(k/2), every pass covering the whole stack."""
    assert tntt.pass_shapes(10, 3) == [(10, 3, 3, False)]
    assert tntt.pass_shapes(15, 64) == [(8, 64 << 7, 64, True),
                                        (7, 64 << 8, 64 << 8, False)]
    for k in range(1, 21):
        for log_l, W, S, _ in tntt.pass_shapes(k, 5):
            assert log_l <= tntt.NTT_MAX_LOG_L and (W << log_l) == 5 << k
    # eight elements a thread from 2^19 elements on (2^15 x 16), else two
    assert [tntt.reg_bits(8, C << 7) for C in (1, 15, 16, 64)] == [1, 1, 3, 3]
    assert tntt.lines_per_block(8, 64 << 7) == 2
    assert tntt.lines_per_block(8, 1 << 7) == 0
    assert tntt.lines_per_block(1, 1, 3) == 2


@pytest.mark.parametrize("entry", ENTRIES)
@pytest.mark.parametrize("k", [1, 4, 10, 11, 12])
def test_kernel_schedule_matches_plain(k, entry):
    n = 1 << k
    rng = np.random.default_rng(90 + k)
    plan = tntt.get_plan(n, fr_root_of_unity(k), "cpu")
    inv_plan = tntt.get_plan(n, pow(fr_root_of_unity(k), -1, R), "cpu")
    pre, post = _pows(SHIFT, n), _pows(pow(SHIFT, -1, R), n)
    for C in (1, 3, 5):
        vals = [int.from_bytes(rng.bytes(32), "big") % R
                for _ in range(n * C)]
        a = FR.encode(vals, "cpu").reshape(n, C, 8)
        want = _port(entry, plan, a, pre, post)
        passes = tntt.pass_shapes(k, C)
        pre_n = n * C if entry == "coset" else 0
        for rb in (1, 3):
            if entry in ("ntt", "coset"):
                got, ran, skipped = _kernel_schedule(
                    plan, a, pre=pre if entry == "coset" else None, rb=rb)
            else:
                got, ran, skipped = _kernel_schedule(
                    inv_plan, a, scale=inv_plan.n_inv,
                    post=post if entry == "h_chunk" else None, rb=rb)
            assert torch.equal(got, want)
            # every stage butterfly ran its product or skipped a unit
            # twiddle (and the between-pass twiddle: one an element of the
            # first pass)
            assert ran + skipped == (n // 2) * k * C + pre_n + (
                n * C if len(passes) == 2 else 0)
            assert skipped >= C * sum(((1 << p[0]) - 1) * (n >> p[0])
                                      for p in passes)
