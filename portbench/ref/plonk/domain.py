"""Evaluation domains (radix-2 subgroups of Fr*) for polynomial arithmetic.

Mirrors halo2's EvaluationDomain: base domain of n=2^k rows with generator
omega = 7^((r-1)/2^k), plus an extended domain (>= n * (degree-1)) evaluated
over a multiplicative coset for the quotient computation.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

from ..fields.bn254 import R, FR_GENERATOR, fr_root_of_unity, inv_mod


@dataclass(frozen=True)
class Domain:
    k: int
    n: int
    omega: int
    omega_inv: int
    n_inv: int
    # extended (coset) domain for quotient computation
    extended_k: int
    extended_n: int
    extended_omega: int
    extended_omega_inv: int
    extended_n_inv: int
    # coset shift g (any element outside the 2^extended_k subgroup)
    coset_shift: int
    quotient_poly_degree: int  # number of h chunks = degree - 1


@lru_cache(maxsize=None)
def make_domain(k: int, degree: int) -> Domain:
    n = 1 << k
    omega = fr_root_of_unity(k)
    quotient_poly_degree = degree - 1
    extended_k = k
    while (1 << extended_k) < n * quotient_poly_degree:
        extended_k += 1
    extended_n = 1 << extended_k
    extended_omega = fr_root_of_unity(extended_k)
    return Domain(
        k=k,
        n=n,
        omega=omega,
        omega_inv=inv_mod(omega, R),
        n_inv=inv_mod(n, R),
        extended_k=extended_k,
        extended_n=extended_n,
        extended_omega=extended_omega,
        extended_omega_inv=inv_mod(extended_omega, R),
        extended_n_inv=inv_mod(extended_n, R),
        coset_shift=FR_GENERATOR,
        quotient_poly_degree=quotient_poly_degree,
    )


def rotate_omega(domain: Domain, x: int, rotation: int) -> int:
    """x * omega^rotation (rotation may be negative)."""
    if rotation >= 0:
        return x * pow(domain.omega, rotation, R) % R
    return x * pow(domain.omega_inv, -rotation, R) % R
