"""BN254 field constants and host-side (python int) modular arithmetic.

Host-side golden reference for every TPU kernel, and the arithmetic used in
protocol bookkeeping (transcript, SHPLONK interpolation, keygen) where sizes
are tiny.

Constants mirror halo2curves `bn256` (used by the reference via
anon-aadhaar-halo2/Cargo.toml:19 and pinned numerically by
anon-aadhaar-halo2/solidity_verifier_contract/contract.sol:210-211,440).
"""
from __future__ import annotations

# Base field modulus q (coordinates of G1/G2). contract.sol:210
Q = 21888242871839275222246405745257275088696311157297823662689037894645226208583
# Scalar field modulus r (circuit values). contract.sol:211
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617

# Multiplicative generator of Fr* (halo2curves bn256::Fr::MULTIPLICATIVE_GENERATOR)
FR_GENERATOR = 7
# 2-adicity of r - 1
FR_S = 28
assert (R - 1) % (1 << FR_S) == 0 and (R - 1) % (1 << (FR_S + 1)) != 0

# DELTA: generator of the order-(r-1)/2^S subgroup, used to index permutation
# columns with distinct cosets.  Value pinned by contract.sol:440.
FR_DELTA = 4131629893567559867359510883348571134090853742863529169391034518566172092834
assert pow(FR_GENERATOR, (R - 1) >> FR_S, R) != 1
assert FR_DELTA == pow(FR_GENERATOR, 1 << FR_S, R)

# G1 generator (x=1, y=2), curve y^2 = x^3 + 3 over Fq. contract.sol:82
G1_GEN = (1, 2)
B_COEFF = 3

# G2 generator over Fq2 (standard BN254 / EIP-197 value), y^2 = x^3 + 3/(9+u)
G2_GEN_X = (
    10857046999023057135944570762232829481370756359578518086990519993285655852781,  # c0
    11559732032986387107991004021392285783925812861821192530917403151452391805634,  # c1
)
G2_GEN_Y = (
    8495653923123431417604973247489272438418190587263600148770280649306958101930,
    4082367875863433681332203403145435568316851327593401208105741076214120093531,
)

# BN parameter t such that q = 36t^4+36t^3+24t^2+6t+1
BN_T = 4965661367192848881


def fr(x: int) -> int:
    return x % R


def fq(x: int) -> int:
    return x % Q


def inv_mod(a: int, m: int) -> int:
    if a % m == 0:
        raise ZeroDivisionError("inverse of zero")
    return pow(a, -1, m)


def fr_inv(a: int) -> int:
    return inv_mod(a, R)


def fq_inv(a: int) -> int:
    return inv_mod(a, Q)


def fr_root_of_unity(k: int) -> int:
    """Primitive 2^k-th root of unity in Fr, matching halo2's
    EvaluationDomain (root = GENERATOR^((r-1)/2^k))."""
    assert k <= FR_S
    return pow(FR_GENERATOR, (R - 1) >> k, R)


def batch_inv(vals: list[int], m: int = R) -> list[int]:
    """Montgomery batched inversion. Zero inputs map to zero (halo2 semantics
    are 'must not be zero'; callers guarantee)."""
    n = len(vals)
    out = [0] * n
    prefix = [1] * (n + 1)
    for i, v in enumerate(vals):
        prefix[i + 1] = prefix[i] * (v if v != 0 else 1) % m
    inv = inv_mod(prefix[n], m)
    for i in range(n - 1, -1, -1):
        v = vals[i]
        if v == 0:
            out[i] = 0
        else:
            out[i] = prefix[i] * inv % m
            inv = inv * v % m
    return out


def to_bytes_be(x: int) -> bytes:
    return x.to_bytes(32, "big")


def from_bytes_be(b: bytes) -> int:
    return int.from_bytes(b, "big")
