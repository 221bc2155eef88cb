"""KZG structured reference string (powers-of-tau), dev-mode setup.

Equivalent of halo2's ParamsKZG::setup (the reference never ships an SRS;
tests regenerate params — SURVEY §5.4).  Dev setup uses a seed-derived tau
(NOT for production).  Cached on disk: keygen at k=15 is expensive.

g[i]          = [tau^i] G1           (coefficient-basis commitments)
g_lagrange[i] = [L_i(tau)] G1        (Lagrange-basis commitments)
g2, s_g2      = G2, [tau] G2         (verifier pairing side, contract.sol:195-204)
"""
from __future__ import annotations

import hashlib
import os
import pickle

import numpy as np

from ..fields.bn254 import G1_GEN, R, batch_inv, fr_root_of_unity, inv_mod
from ..curves import g1 as G1
from ..curves.pairing import G2_GEN, g2_scalar_mul

_CACHE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", ".cache")


class FixedBaseTable:
    """Window-8 fixed-base multiples table for fast many-scalar-muls of one base."""

    def __init__(self, base, bits: int = 256, window: int = 8):
        self.window = window
        self.tables = []
        cur = G1.to_jacobian(base)
        for _w in range(0, bits, window):
            row = [(1, 1, 0)]
            acc = (1, 1, 0)
            for _ in range((1 << window) - 1):
                acc = G1.jac_add(acc, cur)
                row.append(acc)
            self.tables.append(row)
            for _ in range(window):
                cur = G1.jac_double(cur)

    def mul(self, scalar: int):
        scalar %= R
        acc = (1, 1, 0)
        w = self.window
        for t in self.tables:
            if scalar == 0:
                break
            d = scalar & ((1 << w) - 1)
            if d:
                acc = G1.jac_add(acc, t[d])
            scalar >>= w
        return G1.from_jacobian(acc)


class SRS:
    def __init__(self, k: int, g, g_lagrange, g2, s_g2, tau=None):
        self.k = k
        self.n = 1 << k
        self.g = g                    # list of affine (x, y)
        self.g_lagrange = g_lagrange  # list of affine (x, y)
        self.g2 = g2
        self.s_g2 = s_g2
        self.tau = tau  # kept for dev-mode debugging only

    def commit(self, coeffs) -> G1.Affine:
        """Commit to a coefficient-form polynomial (host MSM; the production
        path uses the JAX engine's MSM with the same g)."""
        return G1.msm(self.g[: len(coeffs)], list(coeffs))

    def commit_lagrange(self, values) -> G1.Affine:
        return G1.msm(self.g_lagrange[: len(values)], list(values))


def setup(k: int, seed: bytes = b"halo2tpu-dev-srs", cache: bool = True,
          keep_tau: bool = False) -> SRS:
    """Dev-mode trusted setup.  `tau` (the toxic waste) is discarded — and
    never pickled — unless keep_tau=True is passed explicitly for debugging
    (a production SRS would be loaded from a ceremony transcript instead)."""
    os.makedirs(_CACHE_DIR, exist_ok=True)
    path = os.path.join(_CACHE_DIR, f"srs_torch_k{k}_{hashlib.sha256(seed).hexdigest()[:12]}.pkl")
    if cache and os.path.exists(path):
        with open(path, "rb") as f:
            srs = pickle.load(f)
        if not keep_tau:
            srs.tau = None
        elif srs.tau is None:
            srs.tau = int.from_bytes(hashlib.sha512(seed).digest(), "big") % R
        return srs

    n = 1 << k
    tau = int.from_bytes(hashlib.sha512(seed).digest(), "big") % R
    table = FixedBaseTable(G1_GEN)

    # powers of tau
    powers = [1] * n
    for i in range(1, n):
        powers[i] = powers[i - 1] * tau % R
    g = [table.mul(p) for p in powers]

    # Lagrange scalars: L_i(tau) = omega^i (tau^n - 1) / (n (tau - omega^i))
    omega = fr_root_of_unity(k)
    omega_pows = [1] * n
    for i in range(1, n):
        omega_pows[i] = omega_pows[i - 1] * omega % R
    tau_n_minus_1 = (pow(tau, n, R) - 1) % R
    n_inv = inv_mod(n, R)
    denoms = [(tau - w) % R for w in omega_pows]
    inv_denoms = batch_inv(denoms)
    lag_scalars = [w * tau_n_minus_1 % R * n_inv % R * d % R
                   for w, d in zip(omega_pows, inv_denoms)]
    g_lagrange = [table.mul(s) for s in lag_scalars]

    s_g2 = g2_scalar_mul(G2_GEN, tau)
    srs = SRS(k, g, g_lagrange, G2_GEN, s_g2, tau=None)
    if cache:
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            pickle.dump(srs, f)
        os.replace(tmp, path)
    if keep_tau:
        srs.tau = tau
    return srs
