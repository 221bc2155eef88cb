"""Host-side BN254 optimal-ate pairing.

Only the *verifier* needs pairings (one 2-pairing product per proof — the
EVM precompile 0x08 call at contract.sol:190-207), so a clear, slow,
python-int implementation is the right tool; the prover never pairs.

Representation: Fq12 as the flat polynomial ring Fq[w]/(w^12 - 18 w^6 + 82)
(equivalent to the 1-1-2 tower with u^2=-1, xi=9+u, v^3=xi, w^2=v).
G2 points over Fq2 are "twisted" into Fq12 coordinates, after which the
Miller loop uses generic line functions.  Algorithm structure follows the
classic textbook ate pairing (cf. py_ecc), reimplemented from the math.
"""
from __future__ import annotations

from ..fields.bn254 import Q, R, G2_GEN_X, G2_GEN_Y, inv_mod

# ---------------------------------------------------------------------------
# Fq2 (minimal: needed to validate/negate G2 inputs), as pairs (c0, c1): c0+c1*u
# ---------------------------------------------------------------------------

def fq2_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    return ((a0 * b0 - a1 * b1) % Q, (a0 * b1 + a1 * b0) % Q)


def fq2_add(a, b):
    return ((a[0] + b[0]) % Q, (a[1] + b[1]) % Q)


def fq2_sub(a, b):
    return ((a[0] - b[0]) % Q, (a[1] - b[1]) % Q)


def fq2_neg(a):
    return ((-a[0]) % Q, (-a[1]) % Q)


def g2_is_on_curve(p) -> bool:
    """y^2 = x^3 + 3/(9+u) over Fq2; p = ((x0,x1),(y0,y1)) or None."""
    if p is None:
        return True
    x, y = p
    # b2 = 3 / (9 + u)
    inv = _fq2_inv((9, 1))
    b2 = fq2_mul((3, 0), inv)
    lhs = fq2_mul(y, y)
    rhs = fq2_add(fq2_mul(x, fq2_mul(x, x)), b2)
    return lhs == rhs


def _fq2_inv(a):
    a0, a1 = a
    d = inv_mod((a0 * a0 + a1 * a1) % Q, Q)
    return (a0 * d % Q, (-a1) * d % Q)


# ---------------------------------------------------------------------------
# Fq12 = Fq[w] / (w^12 - 18 w^6 + 82): elements are tuples of 12 ints
# ---------------------------------------------------------------------------

DEG = 12
# modulus polynomial coefficients for reduction: w^12 = 18 w^6 - 82
_MOD_LOW = [82, 0, 0, 0, 0, 0, -18, 0, 0, 0, 0, 0]  # w^12 + sum(c_i w^i) = 0

FQ12_ONE = (1,) + (0,) * 11
FQ12_ZERO = (0,) * 12


def f12_add(a, b):
    return tuple((x + y) % Q for x, y in zip(a, b))


def f12_sub(a, b):
    return tuple((x - y) % Q for x, y in zip(a, b))


def f12_neg(a):
    return tuple((-x) % Q for x in a)


def f12_scale(a, k: int):
    return tuple(x * k % Q for x in a)


def f12_mul(a, b):
    t = [0] * (2 * DEG - 1)
    for i, ai in enumerate(a):
        if ai == 0:
            continue
        for j, bj in enumerate(b):
            t[i + j] += ai * bj
    # reduce degrees 22..12
    for i in range(2 * DEG - 2, DEG - 1, -1):
        c = t[i]
        if c == 0:
            continue
        t[i] = 0
        t[i - 6] += 18 * c
        t[i - 12] -= 82 * c
    return tuple(x % Q for x in t[:DEG])


def f12_square(a):
    return f12_mul(a, a)


def f12_pow(a, n: int):
    result = FQ12_ONE
    base = a
    while n:
        if n & 1:
            result = f12_mul(result, base)
        base = f12_mul(base, base)
        n >>= 1
    return result


def _poly_divmod(a: list[int], b: list[int]) -> list[int]:
    """Remainder of a / b over Fq (dense int lists, b monic-izable)."""
    a = a[:]
    db = len(b) - 1
    while len(b) > 1 and b[-1] == 0:
        b = b[:-1]
        db -= 1
    binv = inv_mod(b[db], Q)
    for i in range(len(a) - 1, db - 1, -1):
        c = a[i] * binv % Q
        if c == 0:
            continue
        for j in range(db + 1):
            a[i - db + j] = (a[i - db + j] - c * b[j]) % Q
    return a[:db]


def f12_inv(a):
    """Inverse via extended Euclid on polynomials over Fq."""
    mod = [82, 0, 0, 0, 0, 0, -18 % Q, 0, 0, 0, 0, 0, 1]
    lm, hm = [1] + [0] * 12, [0] * 13
    low, high = list(a) + [0], mod[:]
    while _deg(low) > 0:
        r = _poly_div(high, low)
        nm = [(hm[i] - sum(r[j] * lm[i - j] for j in range(len(r)) if 0 <= i - j < len(lm))) % Q
              for i in range(13)]
        new = [(high[i] - sum(r[j] * low[i - j] for j in range(len(r)) if 0 <= i - j < len(low))) % Q
               for i in range(13)]
        lm, low, hm, high = nm, new, lm, low
    c = inv_mod(low[0], Q)
    return tuple(x * c % Q for x in lm[:DEG])


def _deg(p) -> int:
    d = 0
    for i, c in enumerate(p):
        if c % Q:
            d = i
    return d


def _poly_div(a, b):
    """Quotient of a/b (floor) over Fq."""
    dega, degb = _deg(a), _deg(b)
    temp = [x % Q for x in a]
    out = [0] * (dega - degb + 1)
    binv = inv_mod(b[degb] % Q, Q)
    for i in range(dega - degb, -1, -1):
        c = temp[degb + i] * binv % Q
        out[i] = c
        for j in range(degb + 1):
            temp[i + j] = (temp[i + j] - c * (b[j] % Q)) % Q
    return out


# ---------------------------------------------------------------------------
# Twist: G2 (over Fq2) -> curve over Fq12
# ---------------------------------------------------------------------------
# An Fq2 element a0 + a1*u embeds into Fq12 via u = w^6 - 9:
#   a0 + a1*u = (a0 - 9 a1) + a1 * w^6.
# The D-twist then maps (x, y) -> (x * w^2, y * w^3), moving points of
# E'(Fq2): y^2 = x^3 + 3/(9+u) onto E(Fq12): y^2 = x^3 + 3.

def _fq2_to_fq12(a) -> tuple:
    a0, a1 = a
    out = [0] * 12
    out[0] = (a0 - 9 * a1) % Q
    out[6] = a1 % Q
    return tuple(out)


def twist(p):
    if p is None:
        return None
    x, y = p
    x12 = _fq2_to_fq12(x)
    y12 = _fq2_to_fq12(y)
    w2 = tuple(1 if i == 2 else 0 for i in range(12))
    w3 = tuple(1 if i == 3 else 0 for i in range(12))
    return (f12_mul(x12, w2), f12_mul(y12, w3))


def _g1_to_fq12(p):
    if p is None:
        return None
    return (tuple([p[0]] + [0] * 11), tuple([p[1]] + [0] * 11))


# ---------------------------------------------------------------------------
# Miller loop (points in affine Fq12 coordinates)
# ---------------------------------------------------------------------------

ATE_LOOP_COUNT = 29793968203157093288  # 6t + 2 for t = 4965661367192848881
LOG_ATE = 63


def _linefunc(p1, p2, t):
    """Evaluate the line through p1,p2 at t (all affine Fq12 points)."""
    x1, y1 = p1
    x2, y2 = p2
    xt, yt = t
    if x1 != x2:
        num = f12_sub(y2, y1)
        den = f12_sub(x2, x1)
        m = f12_mul(num, f12_inv(den))
        return f12_sub(f12_mul(m, f12_sub(xt, x1)), f12_sub(yt, y1))
    if y1 == y2:
        num = f12_scale(f12_mul(x1, x1), 3)
        den = f12_scale(y1, 2)
        m = f12_mul(num, f12_inv(den))
        return f12_sub(f12_mul(m, f12_sub(xt, x1)), f12_sub(yt, y1))
    return f12_sub(xt, x1)


def _ec_double(p):
    x, y = p
    m = f12_mul(f12_scale(f12_mul(x, x), 3), f12_inv(f12_scale(y, 2)))
    nx = f12_sub(f12_mul(m, m), f12_scale(x, 2))
    ny = f12_sub(f12_mul(m, f12_sub(x, nx)), y)
    return (nx, ny)


def _ec_add(p, q):
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2 and y1 == y2:
        return _ec_double(p)
    if x1 == x2:
        return None
    m = f12_mul(f12_sub(y2, y1), f12_inv(f12_sub(x2, x1)))
    nx = f12_sub(f12_mul(m, m), f12_add(x1, x2))
    ny = f12_sub(f12_mul(m, f12_sub(x1, nx)), y1)
    return (nx, ny)


def miller_loop(q12, p12):
    """f_{ate}(Q, P) for twisted Q and embedded P, with the BN final two
    Frobenius line additions."""
    if q12 is None or p12 is None:
        return FQ12_ONE
    r12 = q12
    f = FQ12_ONE
    for i in range(LOG_ATE, -1, -1):
        f = f12_mul(f12_mul(f, f), _linefunc(r12, r12, p12))
        r12 = _ec_double(r12)
        if ATE_LOOP_COUNT & (1 << i):
            f = f12_mul(f, _linefunc(r12, q12, p12))
            r12 = _ec_add(r12, q12)
    # Frobenius endomorphism applications: pi(Q), pi^2(Q)
    q1 = (f12_pow(q12[0], Q), f12_pow(q12[1], Q))
    nq2 = (f12_pow(q1[0], Q), f12_neg(f12_pow(q1[1], Q)))
    f = f12_mul(f, _linefunc(r12, q1, p12))
    r12 = _ec_add(r12, q1)
    f = f12_mul(f, _linefunc(r12, nq2, p12))
    return f


_FINAL_EXP = (Q ** 12 - 1) // R


def final_exponentiation(f):
    return f12_pow(f, _FINAL_EXP)


def pairing(p, q2) -> tuple:
    """e(P, Q) for P in G1 (affine ints) and Q in G2 (affine Fq2 pairs).
    Returns an Fq12 element; e is bilinear and nondegenerate."""
    if p is None or q2 is None:
        return FQ12_ONE
    return final_exponentiation(miller_loop(twist(q2), _g1_to_fq12(p)))


def pairing_check(pairs) -> bool:
    """prod e(P_i, Q_i) == 1 — the EVM 0x08 precompile semantics
    (contract.sol:190-207)."""
    f = FQ12_ONE
    for p, q2 in pairs:
        if p is None or q2 is None:
            continue
        f = f12_mul(f, miller_loop(twist(q2), _g1_to_fq12(p)))
    return final_exponentiation(f) == FQ12_ONE


G2_GEN = (G2_GEN_X, G2_GEN_Y)


def g2_neg(p):
    if p is None:
        return None
    return (p[0], fq2_neg(p[1]))


def g2_add(p, q):
    """Affine G2 addition over Fq2."""
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2:
        if y1 != y2:
            return None
        num = fq2_mul((3, 0), fq2_mul(x1, x1))
        den = fq2_mul((2, 0), y1)
        m = fq2_mul(num, _fq2_inv(den))
    else:
        m = fq2_mul(fq2_sub(y2, y1), _fq2_inv(fq2_sub(x2, x1)))
    nx = fq2_sub(fq2_mul(m, m), fq2_add(x1, x2))
    ny = fq2_sub(fq2_mul(m, fq2_sub(x1, nx)), y1)
    return (nx, ny)


def g2_scalar_mul(p, k: int):
    k %= R
    acc = None
    base = p
    while k:
        if k & 1:
            acc = g2_add(acc, base)
        base = g2_add(base, base)
        k >>= 1
    return acc
