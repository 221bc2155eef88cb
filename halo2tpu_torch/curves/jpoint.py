"""Batched BN254 G1 arithmetic on torch tensors: Jacobian coordinates over
Montgomery Fq.  Port of halo2tpu/curves/jpoint.py.

Points are (..., 3, 8) int32 tensors: coordinates X, Y, Z along axis -2.
Identity = Z == 0 (X = Y = Montgomery 1 by convention).  The formulas and
lane rules are those of the Pallas point kernels (halo2tpu/ops/pallas_ec.py)
— identity operands, inverses and equal points (doubling) are all handled —
so these functions, built on the plain field operations, are the plain
reference of the CUDA point kernels in ops/cuda_ec.py and agree with them
coordinate for coordinate.
"""
from __future__ import annotations

import torch

from ..fields.bn254 import Q, fq_inv
from ..fields.jfield import FQ, is_zero, eq, device_of
# the plain field operations: these formulas are the point kernels' reference
from ..ops.cuda_field import add_plain as add, mont_mul_plain
from ..ops.cuda_field import sub_plain as sub


def affine_to_device(points, device="cuda") -> torch.Tensor:
    """Host affine points (x, y) or None -> (n, 3, 8) tensor."""
    xs, ys, zs = [], [], []
    for p in points:
        if p is None:
            xs.append(1)
            ys.append(1)
            zs.append(0)
        else:
            xs.append(p[0])
            ys.append(p[1])
            zs.append(1)
    d = device_of(device)
    return torch.stack([FQ.encode(xs, d), FQ.encode(ys, d),
                        FQ.encode(zs, d)], dim=-2)


def device_to_affine(arr) -> list:
    """(..., 3, 8) -> host affine points (one device read)."""
    flat = FQ.decode(arr.reshape(-1, 8))
    out = []
    for x, y, z in zip(flat[0::3], flat[1::3], flat[2::3]):
        if z == 0:
            out.append(None)
        else:
            zi = fq_inv(z)
            zi2 = zi * zi % Q
            out.append((x * zi2 % Q, y * zi2 % Q * zi % Q))
    return out


def identity_points(shape_prefix, device="cuda") -> torch.Tensor:
    """(*shape_prefix, 3, 8) identity points (1, 1, 0), Montgomery coords."""
    d = device_of(device)
    one = FQ.const("one_mont", d)
    ident = torch.stack([one, one, torch.zeros_like(one)])
    return ident.expand(tuple(shape_prefix) + (3, 8)).contiguous()


def _mul(x, y):
    return mont_mul_plain(FQ, x, y)


def _mulk(xs, ys):
    """k independent field products in one call (stacked on a new axis)."""
    return list(_mul(torch.stack(xs), torch.stack(ys)).unbind(0))


def _dbl(x):
    return add(FQ, x, x)


def _psel(mask, a, b):
    return torch.where(mask[..., None, None], a, b)


def pdbl(p):
    """Jacobian doubling, identity-safe (z = 0 -> z3 = 0)."""
    x, y, z = p[..., 0, :], p[..., 1, :], p[..., 2, :]
    a, b, z3 = _mulk([x, y, _dbl(y)], [x, y, z])
    xb = add(FQ, x, b)
    c, xb2 = _mulk([b, xb], [b, xb])
    d = _dbl(sub(FQ, xb2, add(FQ, a, c)))
    e = add(FQ, _dbl(a), a)
    f = _mul(e, e)
    x3 = sub(FQ, f, _dbl(d))
    c8 = _dbl(_dbl(_dbl(c)))
    y3 = sub(FQ, _mul(e, sub(FQ, d, x3)), c8)
    return torch.stack([x3, y3, z3], dim=-2)


def _identity_like(p):
    return identity_points(p.shape[:-2], p.device)


def padd(p, q):
    """Full Jacobian addition: identity operands, inverses (-> identity) and
    equal points (-> doubling).  Both identity: the result is q."""
    x1, y1, z1 = p[..., 0, :], p[..., 1, :], p[..., 2, :]
    x2, y2, z2 = q[..., 0, :], q[..., 1, :], q[..., 2, :]
    z1z1, z2z2 = _mulk([z1, z2], [z1, z2])
    u1, u2, t1, t2 = _mulk([x1, x2, y1, y2], [z2z2, z1z1, z2, z1])
    s1, s2 = _mulk([t1, t2], [z2z2, z1z1])
    h = sub(FQ, u2, u1)
    hh = _dbl(h)
    zz = add(FQ, z1, z2)
    rr = _dbl(sub(FQ, s2, s1))
    i, zzsq, r2 = _mulk([hh, zz, rr], [hh, zz, rr])
    j, v = _mulk([h, u1], [i, i])
    x3 = sub(FQ, sub(FQ, r2, j), _dbl(v))
    rvx, s1j, z3 = _mulk([rr, s1, sub(FQ, sub(FQ, zzsq, z1z1), z2z2)],
                         [sub(FQ, v, x3), j, h])
    y3 = sub(FQ, rvx, _dbl(s1j))
    out = torch.stack([x3, y3, z3], dim=-2)

    p_inf = is_zero(z1)
    q_inf = is_zero(z2)
    same_x = eq(u1, u2)
    same_y = eq(s1, s2)
    out = _psel(same_x & ~same_y, _identity_like(out), out)
    out = _psel(q_inf, p, out)
    out = _psel(p_inf, q, out)
    need_dbl = same_x & same_y & ~p_inf & ~q_inf
    if bool(need_dbl.any()):
        out = _psel(need_dbl, pdbl(p), out)
    return out


def padd_mixed(p, q):
    """Jacobian p += affine q (madd-2007-bl) where q's Z is nonzero; other
    lanes keep p.  p at infinity gives (x2, y2, 1), p == -q the identity
    and p == q the doubling."""
    X1, Y1, Z1 = p[..., 0, :], p[..., 1, :], p[..., 2, :]
    x2, y2, z2 = q[..., 0, :], q[..., 1, :], q[..., 2, :]
    valid = ~is_zero(z2)
    Z1Z1, t0 = _mulk([Z1, y2], [Z1, Z1])
    U2, S2 = _mulk([x2, t0], [Z1Z1, Z1Z1])
    H = sub(FQ, U2, X1)
    s2y1 = sub(FQ, S2, Y1)
    r = _dbl(s2y1)
    ZH = add(FQ, Z1, H)
    HH, rr, zh2 = _mulk([H, r, ZH], [H, r, ZH])
    i = _dbl(_dbl(HH))
    J, V = _mulk([H, X1], [i, i])
    X3 = sub(FQ, sub(FQ, rr, J), _dbl(V))
    y3a, y3b = _mulk([r, Y1], [sub(FQ, V, X3), J])
    Y3 = sub(FQ, y3a, _dbl(y3b))
    Z3 = sub(FQ, sub(FQ, zh2, Z1Z1), HH)
    out = torch.stack([X3, Y3, Z3], dim=-2)

    same_x = is_zero(H)
    same_y = is_zero(s2y1)
    p_inf = is_zero(Z1)
    out = _psel(same_x & ~same_y, _identity_like(out), out)
    one = FQ.const("one_mont", p.device).expand(x2.shape)
    out = _psel(p_inf, torch.stack([x2, y2, one], dim=-2), out)
    out = _psel(valid, out, p)
    need_dbl = same_x & same_y & ~p_inf & valid
    if bool(need_dbl.any()):
        out = _psel(need_dbl, pdbl(p), out)
    return out
