"""Radix-2 NTT over Fr on torch tensors.  Port of halo2tpu/ops/ntt.py.

Stockham autosort DIF over axis 0 of (n, ..., 8) Montgomery tensors
(interior axes are batch columns): log2(n) stages of slice + butterfly +
concatenate, with the twiddles subsampled from one flat half-size table.
Plain torch; the butterflies' multiplies go through jfield.mont_mul and so
reach the mont_mul kernel on CUDA tensors.
"""
from __future__ import annotations

import torch

from ..fields.bn254 import R, inv_mod
from ..fields.jfield import FR, add, device_of, ints_to_limbs, mont_mul, sub


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
        self.tw_flat = torch.from_numpy(ints_to_limbs(tws).copy()).to(
            self.device)
        self.n_inv = torch.from_numpy(
            ints_to_limbs([inv_mod(n, R) * FR.r % R])[0].copy()).to(
            self.device)


_PLANS: dict = {}


def get_plan(n: int, omega: int, device="cuda") -> NTTPlan:
    key = (n, omega % R, device_of(device))
    if key not in _PLANS:
        _PLANS[key] = NTTPlan(n, omega, device)
    return _PLANS[key]


def _ntt_run(plan: NTTPlan, a):
    """Invariant: x flat-indexed as [(j, c)] = flat[j*m + c] holds the j-th
    input of a size-2l sub-DFT for output group c.  A stage computes
    E = x0 + x1 (even outputs) and O = (x0 - x1) * w_{2l}^j (odd outputs)
    and appends the branch bit as the next output-index bit."""
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


def ntt(plan: NTTPlan, a):
    """Forward in-order NTT over axis 0: out[i] = sum_j a[j] omega^(ij)."""
    return _ntt_run(plan, a)


def intt(plan_fwd: NTTPlan, a):
    """Inverse NTT using the inverse-omega plan + 1/n scaling."""
    inv_plan = get_plan(plan_fwd.n, inv_mod(plan_fwd.omega, R),
                        plan_fwd.device)
    return mont_mul(FR, _ntt_run(inv_plan, a), inv_plan.n_inv)
