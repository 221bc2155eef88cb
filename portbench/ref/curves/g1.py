"""Host-side BN254 G1 arithmetic (python ints, Jacobian coordinates).

Golden reference for the JAX batched point kernels (curves/jpoint.py) and the
workhorse for small verifier-side MSMs (the on-chain verifier's ec ops are EVM
precompiles 0x06/0x07; see contract.sol:161-188 — these are their host twins).

Points are affine tuples (x, y) with None for the identity, or Jacobian
triples (X, Y, Z) with Z=0 for the identity; curve y^2 = x^3 + 3 over Fq.
"""
from __future__ import annotations

from ..fields.bn254 import Q, R, fq_inv

Affine = tuple[int, int] | None


def is_on_curve(p: Affine) -> bool:
    if p is None:
        return True
    x, y = p
    return (y * y - (x * x * x + 3)) % Q == 0


def to_jacobian(p: Affine) -> tuple[int, int, int]:
    if p is None:
        return (1, 1, 0)
    return (p[0], p[1], 1)


def from_jacobian(p: tuple[int, int, int]) -> Affine:
    x, y, z = p
    if z == 0:
        return None
    zinv = fq_inv(z)
    zinv2 = zinv * zinv % Q
    return (x * zinv2 % Q, y * zinv2 % Q * zinv % Q)


def jac_double(p: tuple[int, int, int]) -> tuple[int, int, int]:
    x, y, z = p
    if z == 0 or y == 0:
        return (1, 1, 0)
    a = x * x % Q
    b = y * y % Q
    c = b * b % Q
    d = 2 * ((x + b) * (x + b) - a - c) % Q
    e = 3 * a % Q
    f = e * e % Q
    x3 = (f - 2 * d) % Q
    y3 = (e * (d - x3) - 8 * c) % Q
    z3 = 2 * y * z % Q
    return (x3, y3, z3)


def jac_add(p: tuple[int, int, int], q: tuple[int, int, int]) -> tuple[int, int, int]:
    x1, y1, z1 = p
    x2, y2, z2 = q
    if z1 == 0:
        return q
    if z2 == 0:
        return p
    z1z1 = z1 * z1 % Q
    z2z2 = z2 * z2 % Q
    u1 = x1 * z2z2 % Q
    u2 = x2 * z1z1 % Q
    s1 = y1 * z2 * z2z2 % Q
    s2 = y2 * z1 * z1z1 % Q
    if u1 == u2:
        if s1 != s2:
            return (1, 1, 0)
        return jac_double(p)
    h = (u2 - u1) % Q
    i = (2 * h) * (2 * h) % Q
    j = h * i % Q
    rr = 2 * (s2 - s1) % Q
    v = u1 * i % Q
    x3 = (rr * rr - j - 2 * v) % Q
    y3 = (rr * (v - x3) - 2 * s1 * j) % Q
    z3 = ((z1 + z2) * (z1 + z2) - z1z1 - z2z2) % Q * h % Q
    return (x3, y3, z3)


def add(p: Affine, q: Affine) -> Affine:
    return from_jacobian(jac_add(to_jacobian(p), to_jacobian(q)))


def neg(p: Affine) -> Affine:
    if p is None:
        return None
    return (p[0], (Q - p[1]) % Q)


def scalar_mul(p: Affine, k: int) -> Affine:
    k %= R
    if p is None or k == 0:
        return None
    acc = (1, 1, 0)
    base = to_jacobian(p)
    while k:
        if k & 1:
            acc = jac_add(acc, base)
        base = jac_double(base)
        k >>= 1
    return from_jacobian(acc)


def msm(points: list[Affine], scalars: list[int]) -> Affine:
    """Small host-side MSM (Pippenger, window 8). Verifier-scale only."""
    assert len(points) == len(scalars)
    pairs = [(p, s % R) for p, s in zip(points, scalars) if p is not None and s % R != 0]
    if not pairs:
        return None
    c = 8
    windows = (254 + c - 1) // c
    acc = (1, 1, 0)
    for w in range(windows - 1, -1, -1):
        for _ in range(c):
            acc = jac_double(acc)
        buckets: dict[int, tuple[int, int, int]] = {}
        for p, s in pairs:
            d = (s >> (w * c)) & ((1 << c) - 1)
            if d:
                jp = to_jacobian(p)
                buckets[d] = jac_add(buckets[d], jp) if d in buckets else jp
        # running-sum bucket reduction
        running = (1, 1, 0)
        tot = (1, 1, 0)
        for d in range(max(buckets) if buckets else 0, 0, -1):
            if d in buckets:
                running = jac_add(running, buckets[d])
            tot = jac_add(tot, running)
        acc = jac_add(acc, tot)
    return from_jacobian(acc)
