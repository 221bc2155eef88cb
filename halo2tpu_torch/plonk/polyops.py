"""Host-side (python-int) polynomial ops over Fr.

Golden reference twin of the JAX engine (ops/ntt.py etc.); used directly by
keygen and by the host prover engine for small circuits / tests.
"""
from __future__ import annotations

from ..fields.bn254 import R, inv_mod


def bit_reverse_permute(a: list[int]) -> list[int]:
    n = len(a)
    bits = n.bit_length() - 1
    out = [0] * n
    for i in range(n):
        j = int(format(i, f"0{bits}b")[::-1], 2) if bits else 0
        out[j] = a[i]
    return out


def ntt(a, omega: int) -> list[int]:
    """In-order forward NTT: out[i] = sum_j a[j] omega^(ij)."""
    a = bit_reverse_permute(list(a))
    n = len(a)
    m = 1
    while m < n:
        w_m = pow(omega, n // (2 * m), R)
        for k in range(0, n, 2 * m):
            w = 1
            for j in range(m):
                t = w * a[k + j + m] % R
                u = a[k + j]
                a[k + j] = (u + t) % R
                a[k + j + m] = (u - t) % R
                w = w * w_m % R
        m *= 2
    return a


def intt(a, omega: int) -> list[int]:
    n = len(a)
    out = ntt(a, inv_mod(omega, R))
    n_inv = inv_mod(n, R)
    return [x * n_inv % R for x in out]


def lagrange_to_coeff(values, omega: int) -> list[int]:
    return intt(values, omega)


def coeff_to_lagrange(coeffs, omega: int) -> list[int]:
    return ntt(coeffs, omega)


def eval_poly(coeffs, x: int) -> int:
    acc = 0
    for c in reversed(list(coeffs)):
        acc = (acc * x + c) % R
    return acc


def part_shift(domain, q: int) -> int:
    """Shift c_q = g * omega_ext^q of extended-coset part q.

    The extended coset {g*omega_ext^j} splits into step = extended_n/n
    interleaved cosets of the order-n subgroup: rows j = q + step*t carry
    the points c_q * omega^t.  Expression rotations are always multiples of
    step, so they never cross parts — the basis of the part-wise quotient
    evaluation (n-sized working set instead of extended_n * columns)."""
    return domain.coset_shift * pow(domain.extended_omega, q, R) % R


def coeff_to_part(coeffs, domain, q: int) -> list[int]:
    """Values of a degree-<n poly on extended-coset part q: scale coeffs by
    c_q^i, forward n-NTT."""
    c = part_shift(domain, q)
    scaled, cp = [], 1
    for v in coeffs:
        scaled.append(v * cp % R)
        cp = cp * c % R
    scaled += [0] * (domain.n - len(scaled))
    return ntt(scaled, domain.omega)


def parts_to_h_chunks(parts, domain, qpd: int) -> list[list[int]]:
    """Inverse of the part decomposition for the quotient poly h (degree
    < step*n): given h's values on every part, return its first qpd
    n-coefficient chunks (chunk s = coeffs [s*n, (s+1)*n)).

    Derivation: with c_q = g*w_ext^q, alpha = w_ext^n (primitive step-th
    root), G = g^n:
      u_q[r] := INTT_n(part_q)[r] * c_q^-r = sum_s h_{r+ns} G^s alpha^(qs)
      h chunk s = (G^-s / step) * sum_q alpha^(-qs) u_q
    """
    n, step = domain.n, domain.extended_n // domain.n
    alpha = pow(domain.extended_omega, n, R)
    alpha_inv = inv_mod(alpha, R)
    g_n_inv = inv_mod(pow(domain.coset_shift, n, R), R)
    step_inv = inv_mod(step, R)
    us = []
    for q, part in enumerate(parts):
        u = intt(part, domain.omega)
        ci = inv_mod(part_shift(domain, q), R)
        cp = 1
        for r in range(n):
            u[r] = u[r] * cp % R
            cp = cp * ci % R
        us.append(u)
    chunks = []
    for s in range(qpd):
        coef = [pow(alpha_inv, q * s, R) * pow(g_n_inv, s, R) * step_inv % R
                for q in range(step)]
        chunk = [0] * n
        for q in range(step):
            cq, uq = coef[q], us[q]
            for r in range(n):
                chunk[r] = (chunk[r] + cq * uq[r]) % R
        chunks.append(chunk)
    return chunks


def coeff_to_extended_coset(coeffs, domain) -> list[int]:
    """Evaluate an n-degree poly on the coset g*<omega_ext> of the extended
    domain: scale coeffs by g^i, pad to extended_n, forward NTT."""
    g = domain.coset_shift
    scaled = []
    gp = 1
    for c in coeffs:
        scaled.append(c * gp % R)
        gp = gp * g % R
    scaled += [0] * (domain.extended_n - len(scaled))
    return ntt(scaled, domain.extended_omega)


def extended_coset_to_coeff(values, domain) -> list[int]:
    coeffs = intt(values, domain.extended_omega)
    ginv = inv_mod(domain.coset_shift, R)
    gp = 1
    out = []
    for c in coeffs:
        out.append(c * gp % R)
        gp = gp * ginv % R
    return out
