"""RSA chip (SURVEY L4) — TPU-first re-design of the reference's
`RSAConfig`/`RSAInstructions` (anon-aadhaar-halo2/src/chip.rs,
src/instructions.rs:7-38) plus the key/signature value types
(anon-aadhaar-halo2/src/lib.rs:52-173).

Verifies RSASSA-PKCS1-v1_5 signatures over SHA-256 digests in-circuit:
modpow by the public exponent, then the limb-wise encoded-message equality
chain against the fixed DigestInfo/padding constants (chip.rs:110-236).
The chip is 64-bit-limb specific (the padding constants are 64-bit words).
"""
from __future__ import annotations

from dataclasses import dataclass

from .biguint import AssignedBigUint, BigUintChip
from .flexgate import AssignedValue

# PKCS#1 v1.5 + SHA-256 DigestInfo encoded-message constants, little-endian
# 64-bit words (chip.rs:141-234).  em = 0x00 || 0x01 || 0xff.. || 0x00 ||
# DigestInfo(SHA-256) || H.
PREFIX_WORD_1 = 217300885422736416    # DigestInfo bytes, words 4..6
PREFIX_WORD_2 = 938447882527703397
PREFIX_LOW_24 = 3158320               # low 32 bits of word 6
FF_HIGH_32 = 4294967295               # high 32 bits of word 6 (start of PS)
FF_WORD = 18446744073709551615        # PS filler words
TOP_WORD = 562949953421311            # 0x00 || 0x01 || 0xff^6 top word


@dataclass
class RSAPublicKey:
    """n, and e either fixed (int) or variable (witness)."""
    n: int
    e: int
    e_is_fixed: bool = True


@dataclass
class RSASignature:
    c: int


@dataclass
class AssignedRSAPublicKey:
    n: AssignedBigUint
    e: "AssignedValue | int"
    e_is_fixed: bool


@dataclass
class AssignedRSASignature:
    c: AssignedBigUint


class RSAChip:
    def __init__(self, big: BigUintChip, default_bits: int, exp_bits: int):
        assert big.limb_bits == 64, "PKCS#1 constants assume 64-bit limbs"
        self.big = big
        self.gate = big.gate
        self.rng = big.rng
        self.default_bits = default_bits
        self.exp_bits = exp_bits

    # -- assignment (chip.rs:36-70) -------------------------------------------
    def assign_public_key(self, pk: RSAPublicKey) -> AssignedRSAPublicKey:
        n = self.big.assign_integer(pk.n, self.default_bits)
        if pk.e_is_fixed:
            return AssignedRSAPublicKey(n, pk.e, True)
        e = self.gate.load_witness(pk.e)
        self.rng.range_check(e, self.exp_bits)
        return AssignedRSAPublicKey(n, e, False)

    def assign_signature(self, sig: RSASignature) -> AssignedRSASignature:
        return AssignedRSASignature(
            self.big.assign_integer(sig.c, self.default_bits))

    # -- modpow (chip.rs:81-96) -----------------------------------------------
    def modpow_public_key(self, x: AssignedBigUint,
                          pk: AssignedRSAPublicKey) -> AssignedBigUint:
        self.big.assert_in_field(x, pk.n)
        if pk.e_is_fixed:
            return self.big.pow_mod_fixed_exp(x, pk.e, pk.n)
        return self.big.pow_mod(x, pk.e, pk.n, self.exp_bits)

    # -- pkcs1v15 (chip.rs:110-236) -------------------------------------------
    def verify_pkcs1v15_signature(self, pk: AssignedRSAPublicKey,
                                  hashed_msg: list,
                                  sig: AssignedRSASignature) -> AssignedValue:
        """hashed_msg: 4 cells of 64-bit LE words of the SHA-256 digest.
        Returns a boolean cell (1 = valid)."""
        assert len(hashed_msg) == 4
        gate = self.gate
        powed = self.modpow_public_key(sig.c, pk)
        is_eq = gate.load_constant(1)
        # 1. digest words
        for limb, h in zip(powed.limbs[:4], hashed_msg):
            is_eq = gate.and_(is_eq, gate.is_equal(limb, h))
        # 2. DigestInfo prefix
        for i, word in ((4, PREFIX_WORD_1), (5, PREFIX_WORD_2)):
            is_eq = gate.and_(
                is_eq, gate.is_equal(powed.limbs[i], gate.load_constant(word)))
        # word 6 splits 32/32: prefix tail | 0xFFFFFFFF
        w6 = powed.limbs[6]
        lo_v, hi_v = w6.value & 0xFFFFFFFF, w6.value >> 32
        lo = gate.load_witness(lo_v)
        self.rng.range_check(lo, 32)
        hi = gate.load_witness(hi_v)
        self.rng.range_check(hi, 32)
        rec = gate.mul_add(hi, gate.load_constant(1 << 32), lo)
        gate.assert_equal(rec, w6)
        is_eq = gate.and_(
            is_eq, gate.is_equal(lo, gate.load_constant(PREFIX_LOW_24)))
        # 3. PS = 0xff.. filler and the 0x00 || 0x01 top word
        is_eq = gate.and_(
            is_eq, gate.is_equal(hi, gate.load_constant(FF_HIGH_32)))
        num_limbs = self.default_bits // 64
        ff = gate.load_constant(FF_WORD)
        for limb in powed.limbs[7:num_limbs - 1]:
            is_eq = gate.and_(is_eq, gate.is_equal(limb, ff))
        is_eq = gate.and_(
            is_eq,
            gate.is_equal(powed.limbs[num_limbs - 1],
                          gate.load_constant(TOP_WORD)))
        return is_eq
