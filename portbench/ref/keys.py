"""The verifying key, worked out again by the reference.

The dev SRS (`srs_seed` of a configuration) is made from a known tau, so
the commitment to a Lagrange-basis column f is [f(tau)] G1 with
f(tau) = sum_i f_i L_i(tau).  The reference computes every fixed and
permutation (sigma) column's f(tau) from its own synthesis of the
circuit (the frozen copy in this package), commits by one scalar
multiplication each, and hashes the key as the program's keygen does
(k, column counts, then every commitment's x and y, Keccak-256).  The
discrete logs f(tau) are kept: the verifier folds the key's commitments
into one scalar with them.
"""
from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass

import numpy as np

from .curves import g1 as G1
from .fields.bn254 import (FR_DELTA, G1_GEN, R, batch_inv, fr_root_of_unity,
                           inv_mod, to_bytes_be)
from .ops.keccak import keccak256
from .plonk.circuit import Assignment, ConstraintSystem
from .plonk.domain import Domain, make_domain


def dev_tau(srs_seed: str) -> int:
    """The toxic waste of the dev SRS made from srs_seed (plonk/srs.py's
    rule: SHA-512 of the seed, big-endian, mod r)."""
    return int.from_bytes(hashlib.sha512(srs_seed.encode()).digest(),
                          "big") % R


def lagrange_at(tau: int, k: int) -> list[int]:
    """[L_i(tau)] for the 2^k-row domain: omega^i (tau^n - 1) / (n (tau -
    omega^i))."""
    n = 1 << k
    omega = fr_root_of_unity(k)
    w = [1] * n
    for i in range(1, n):
        w[i] = w[i - 1] * omega % R
    common = (pow(tau, n, R) - 1) * inv_mod(n, R) % R
    inv = batch_inv([(tau - x) % R for x in w])
    return [x * common % R * d % R for x, d in zip(w, inv)]


def permutation_mapping(cs: ConstraintSystem, n: int, copies) -> np.ndarray:
    """(ncols, n, 2) int32: cell (j, i) goes to (j', i'): the identity,
    then each copy swaps the images of its two cells (halo2's cycle
    merge, in the order the copies were made)."""
    cols = cs.permutation_columns
    pos = {c: j for j, c in enumerate(cols)}
    m = np.empty((len(cols), n, 2), dtype=np.int32)
    for j in range(len(cols)):
        m[j, :, 0] = j
        m[j, :, 1] = np.arange(n)
    for (ca, ra), (cb, rb) in copies:
        ja, jb = pos[ca], pos[cb]
        tmp = m[ja, ra].copy()
        m[ja, ra] = m[jb, rb]
        m[jb, rb] = tmp
    return m


@dataclass
class RefKey:
    k: int
    domain: Domain
    cs: ConstraintSystem
    fixed_logs: list[int]          # f(tau) of each fixed column
    sigma_logs: list[int]          # sigma(tau) of each permutation column
    fixed_commitments: list
    sigma_commitments: list
    transcript_repr: int


def _commit(log: int):
    return G1.scalar_mul(G1_GEN, log) if log % R else None


def _hex_point(p):
    return None if p is None else [hex(p[0]), hex(p[1])]


def transcript_repr(k: int, cs: ConstraintSystem, commitments) -> int:
    h = bytearray()
    for v in (k, cs.num_advice, cs.num_fixed, cs.num_instance):
        h += v.to_bytes(4, "big")
    for c in commitments:
        h += b"\x00" * 64 if c is None else to_bytes_be(c[0]) + to_bytes_be(
            c[1])
    return int.from_bytes(keccak256(bytes(h)), "big") % R


def column_logs(circuit, k: int, tau: int):
    """(cs, fixed f(tau), sigma(tau)) from one synthesis of circuit."""
    cs = ConstraintSystem()
    config = circuit.configure(cs)
    n = 1 << k
    asn = Assignment(cs, n)
    circuit.synthesize(config, asn)
    lag = lagrange_at(tau, k)
    fixed = []
    for col in asn.fixed:
        acc = 0
        for i, v in enumerate(col.tolist()):
            if v:
                acc += int(v) * lag[i]
        fixed.append(acc % R)
    m = permutation_mapping(cs, n, asn.copies)
    omega = fr_root_of_unity(k)
    w = [1] * n
    for i in range(1, n):
        w[i] = w[i - 1] * omega % R
    deltas = [pow(FR_DELTA, j, R) for j in range(m.shape[0])]
    sigma = []
    for j in range(m.shape[0]):
        acc = 0
        for c, r, l_ in zip(m[j, :, 0].tolist(), m[j, :, 1].tolist(), lag):
            acc += deltas[c] * w[r] % R * l_
        sigma.append(acc % R)
    return cs, fixed, sigma


def _source_digest() -> str:
    """Hash of this package's sources: an edited reference never reads a
    key that an older one cached."""
    here = os.path.dirname(os.path.abspath(__file__))
    h = hashlib.sha256()
    for root, dirs, files in os.walk(here):
        dirs[:] = sorted(d for d in dirs if d != "__pycache__")
        for f in sorted(files):
            if f.endswith(".py"):
                p = os.path.join(root, f)
                h.update(os.path.relpath(p, here).encode())
                with open(p, "rb") as fh:
                    h.update(fh.read())
    return h.hexdigest()[:16]


def reference_key(circuit, k: int, srs_seed: str, cache_dir: str | None,
                  tag: str) -> RefKey:
    """The RefKey of circuit at 2^k rows under the dev SRS of srs_seed.
    The column logs are cached as JSON in cache_dir under tag and a hash
    of this package's sources; the constraint system is configured anew."""
    tau = dev_tau(srs_seed)
    path = None
    logs = fc = sc = None
    if cache_dir:
        path = os.path.join(cache_dir, f"refkey_{tag}_{_source_digest()}.json")
        if os.path.exists(path):
            with open(path) as f:
                raw = json.load(f)
            logs = tuple([int(v, 16) for v in raw[key]]
                         for key in ("fixed", "sigma"))
            fc, sc = ([None if p is None else (int(p[0], 16), int(p[1], 16))
                       for p in raw[key]] for key in ("fixed_c", "sigma_c"))
    if logs is None:
        _, fixed, sigma = column_logs(circuit, k, tau)
        logs = (fixed, sigma)
        fc = [_commit(v) for v in fixed]
        sc = [_commit(v) for v in sigma]
        if path:
            os.makedirs(cache_dir, exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            with open(tmp, "w") as f:
                json.dump({"fixed": [hex(v) for v in fixed],
                           "sigma": [hex(v) for v in sigma],
                           "fixed_c": [_hex_point(p) for p in fc],
                           "sigma_c": [_hex_point(p) for p in sc]}, f)
            os.replace(tmp, path)
    cs = ConstraintSystem()
    circuit.configure(cs)
    fixed, sigma = logs
    return RefKey(k=k, domain=make_domain(k, cs.degree()), cs=cs,
                  fixed_logs=fixed, sigma_logs=sigma, fixed_commitments=fc,
                  sigma_commitments=sc,
                  transcript_repr=transcript_repr(k, cs, fc + sc))
