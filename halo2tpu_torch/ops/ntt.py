"""Radix-2 NTT over Fr on torch tensors.  Port of halo2tpu/ops/ntt.py.

`ntt` and `intt` transform axis 0 of an (n, 8) or (n, C, 8) Montgomery
stack (the C columns together) into natural order, with an optional
per-row scale fused in: `pre` multiplies the input of the forward
transform (a coset NTT), `post` the output of the inverse after its 1 / n.
A CUDA tensor takes the kernel (csrc/ntt.cu, `ntt_kernel`): one pass for n
<= 2^NTT_MAX_LOG_L, else two (a four-step split, `pass_shapes`).  A CPU
tensor takes the plain versions: the Stockham loop `_ntt_run` (log2 n
stages of slice + butterfly + concatenate, the twiddles subsampled from one
flat half-size table) composed with jfield.mont_mul for the scales.

`ntt_kernel` counts its launches (one a pass) and keeps `shapes`, a
histogram of (n, C, passes) a transform; `_ntt_run.cuda_calls` counts the
plain loop's runs on CUDA tensors.
"""
from __future__ import annotations

from collections import Counter

import torch

from ..fields.bn254 import R, inv_mod
from ..fields.jfield import (FR, NLIMB, add, device_of, ints_to_limbs,
                             mont_mul, sub)

# a kernel pass transforms lines of at most 2^NTT_MAX_LOG_L points; a block
# holds at most NTT_BLOCK_ELEMS elements of whole lines, a thread 2^3 of
# them in registers in a pass of at least NTT_WIDE_ELEMS elements, else 2^1
# (csrc/ntt.cu)
NTT_MAX_LOG_L = 10
NTT_BLOCK_ELEMS = 1024
NTT_WIDE_ELEMS = 1 << 19
NTT_MIN_BLOCKS = 264


class NTTPlan:
    """Twiddles omega^t (t < n/2, Montgomery) and 1/n on one device."""

    def __init__(self, n: int, omega: int, device="cuda"):
        assert n & (n - 1) == 0 and n >= 2
        self.n = n
        self.omega = omega
        self.logn = n.bit_length() - 1
        self.device = device_of(device)
        assert pow(omega, n, R) == 1 and pow(omega, n // 2, R) != 1
        tws = [FR.r % R] * (n // 2)
        for t in range(1, n // 2):
            tws[t] = tws[t - 1] * omega % R
        self.tw_flat = torch.from_numpy(ints_to_limbs(tws)).to(self.device)
        self.n_inv = torch.from_numpy(
            ints_to_limbs([inv_mod(n, R) * FR.r % R])[0]).to(
            self.device)


_PLANS: dict = {}


def get_plan(n: int, omega: int, device="cuda") -> NTTPlan:
    key = (n, omega % R, device_of(device))
    if key not in _PLANS:
        _PLANS[key] = NTTPlan(n, omega, device)
    return _PLANS[key]


def _inverse_plan(plan_fwd: NTTPlan) -> NTTPlan:
    """The inverse-omega plan, kept on the forward plan after the first
    call (an inverse of one column is a few tens of microseconds)."""
    inv = getattr(plan_fwd, "_inverse", None)
    if inv is None:
        inv = get_plan(plan_fwd.n, inv_mod(plan_fwd.omega, R),
                       plan_fwd.device)
        plan_fwd._inverse = inv
    return inv


def _ntt_run(plan: NTTPlan, a):
    """Invariant: x flat-indexed as [(j, c)] = flat[j*m + c] holds the j-th
    input of a size-2l sub-DFT for output group c.  A stage computes
    E = x0 + x1 (even outputs) and O = (x0 - x1) * w_{2l}^j (odd outputs)
    and appends the branch bit as the next output-index bit."""
    if a.is_cuda:
        _ntt_run.cuda_calls += 1
    n = plan.n
    batch = a.shape[1:-1]
    ones = (1,) * len(batch)
    x = a
    l, m = n // 2, 1
    for _ in range(plan.logn):
        x0 = x[:l * m]
        x1 = x[l * m:]
        stride = n // (2 * l)
        w = plan.tw_flat[::stride][:l]                      # (l, 8)
        w = w[:, None, :].expand(l, m, 8).reshape((l * m,) + ones + (8,))
        e = add(FR, x0, x1)
        o = mont_mul(FR, sub(FR, x0, x1), w)
        eg = e.reshape((l, m) + batch + (8,))
        og = o.reshape((l, m) + batch + (8,))
        x = torch.cat([eg, og], dim=1).reshape((n,) + batch + (8,))
        l //= 2
        m *= 2
    return x


_ntt_run.cuda_calls = 0


def _rows(v, a):
    """An (n, 8) per-row vector shaped to broadcast over a's columns."""
    return v.reshape((v.shape[0],) + (1,) * (a.dim() - 2) + (NLIMB,))


def ntt_plain(plan: NTTPlan, a, pre=None):
    """The forward transform of ntt() in plain torch: the pre-scale, then
    the Stockham loop."""
    if pre is not None:
        a = mont_mul(FR, a, _rows(pre, a))
    return _ntt_run(plan, a)


def intt_plain(plan_fwd: NTTPlan, a, post=None):
    """The inverse of intt() in plain torch: the Stockham loop over the
    inverse-omega plan, 1 / n, then the post-scale."""
    inv_plan = _inverse_plan(plan_fwd)
    out = mont_mul(FR, _ntt_run(inv_plan, a), inv_plan.n_inv)
    if post is not None:
        out = mont_mul(FR, out, _rows(post, out))
    return out


def pass_shapes(logn: int, C: int) -> list:
    """The kernel's passes over an (2^logn, C) stack, in order: (log2 L,
    lines W, output group S, twiddle) each (csrc/ntt.cu::NttPass).  Up to
    2^NTT_MAX_LOG_L points, one pass over the C columns.  Beyond, with n1 =
    2^ceil(logn / 2) and n2 = n / n1: n2 C lines of n1 points (a line per
    row class j mod n2 and column), then the twiddles omega^(j2 k1); then
    n1 C lines of n2 points, written in natural order."""
    if logn <= NTT_MAX_LOG_L:
        return [(logn, C, C, False)]
    l1 = (logn + 1) // 2
    l2 = logn - l1
    return [(l1, C << l2, C, True), (l2, C << l1, C << l1, False)]


def reg_bits(log_l: int, lines: int) -> int:
    """log2 of the elements a thread of the kernel's pass holds
    (csrc/ntt.cu::h2_ntt_pass): 3 from NTT_WIDE_ELEMS elements on, else
    1."""
    return 3 if lines << log_l >= NTT_WIDE_ELEMS else 1


def lines_per_block(log_l: int, lines: int, rb: int | None = None) -> int:
    """log2 of the lines a block of the kernel's pass takes
    (csrc/ntt.cu::h2_ntt_pass): as many as fill NTT_BLOCK_ELEMS, fewer
    while the grid would have under NTT_MIN_BLOCKS blocks, but at least
    one thread's 2^rb elements (rb: reg_bits unless given)."""
    log_lpb = 0
    while (2 << (log_l + log_lpb)) <= NTT_BLOCK_ELEMS:
        log_lpb += 1
    while log_lpb > 0 and -(-lines >> log_lpb) < NTT_MIN_BLOCKS:
        log_lpb -= 1
    if rb is None:
        rb = reg_bits(log_l, lines)
    return max(log_lpb, rb - log_l)


def ntt_kernel(plan: NTTPlan, a, pre=None, post=None, scale=None):
    """One transform of a CUDA (n, ..., 8) int32 stack by the kernel, one
    launch a pass: pre multiplies row j of the input, scale (8,) and then
    post row k of the output (pre and post are (n, 8))."""
    from .._build import check, lib
    if a.dtype != torch.int32 or a.shape[0] != plan.n or a.dim() < 2 or (
            a.shape[-1] != NLIMB):
        raise ValueError(f"ntt: expected an ({plan.n}, ..., 8) int32 stack, "
                         f"got {tuple(a.shape)} {a.dtype}")
    vecs = [v for v in (pre, post, scale) if v is not None]
    if any(t.device != a.device for t in [plan.tw_flat, *vecs]) or (
            a.device.type != "cuda"):
        raise ValueError(f"ntt: stack on {a.device}, plan on "
                         f"{plan.device}, scales on "
                         f"{[str(v.device) for v in vecs]}")
    for v, shape in ((pre, (plan.n, NLIMB)), (post, (plan.n, NLIMB)),
                     (scale, (NLIMB,))):
        if v is not None and (tuple(v.shape) != shape
                              or v.dtype != torch.int32):
            raise ValueError(f"ntt: a scale of shape {tuple(v.shape)} "
                             f"{v.dtype}, expected {shape} int32")
    a = a.contiguous()
    pre, post, scale = (None if v is None else v.contiguous()
                        for v in (pre, post, scale))
    C = a.numel() // (plan.n * NLIMB)
    out = torch.empty_like(a)
    passes = pass_shapes(plan.logn, C)
    src = a
    stream = torch.cuda.current_stream(a.device).cuda_stream
    for i, (log_l, lines, group, twiddle) in enumerate(passes):
        last = i == len(passes) - 1
        dst = out if last else torch.empty_like(a)
        check(lib().h2_ntt_pass(
            src.data_ptr(), dst.data_ptr(), plan.tw_flat.data_ptr(),
            pre.data_ptr() if pre is not None and i == 0 else None,
            post.data_ptr() if post is not None and last else None,
            scale.data_ptr() if scale is not None and last else None,
            lines, C, group, int(twiddle), plan.logn, log_l,
            FR.mod_words_ptr, stream), "ntt")
        ntt_kernel.launches += 1
        src = dst
    ntt_kernel.shapes[(plan.n, C, len(passes))] += 1
    return out


ntt_kernel.launches = 0
ntt_kernel.shapes = Counter()


def ntt(plan: NTTPlan, a, pre=None):
    """Forward in-order NTT over axis 0: out[i] = sum_j pre[j] a[j]
    omega^(ij), pre an optional (n, 8) per-row scale (a coset)."""
    if a.device.type == "cpu":
        return ntt_plain(plan, a, pre)
    return ntt_kernel(plan, a, pre=pre)


def intt(plan_fwd: NTTPlan, a, post=None):
    """Inverse NTT using the inverse-omega plan + 1/n scaling, then an
    optional (n, 8) per-row scale post."""
    if a.device.type == "cpu":
        return intt_plain(plan_fwd, a, post)
    inv_plan = _inverse_plan(plan_fwd)
    return ntt_kernel(inv_plan, a, post=post, scale=inv_plan.n_inv)
