"""The port's circuits at the inputs its tests, chip_smoke.py,
profile_proof.py and the README prove, and the pins their proofs are held
to.

- golden_circuits(): the six small circuits of
  tests/golden/torch_port_proofs.json (Square, Timestamp, the RangeHarness,
  Identity, Nullifier and the QR extractor harness) with k, instances and
  rng seed.
- rsa_circuit(): RSA-SHA256 over RSA_MESSAGE, signed with the pinned
  2048-bit key of tests/golden/rsa_key_2048.json; its k=15 proof at seed 4
  hashes to RSA_PROOF_SHA256.
- composite_circuit(): the composite Aadhaar circuit at k=15 over the full
  1137-byte golden QR, the first COMPOSITE_SIGNED_LEN bytes signed with the
  same key; its proof at seed 8 hashes to COMPOSITE_PROOF_SHA256.
- MOCK_TAMPER: the cells the mock prover's golden failure list tampers.

Imports only the standard library and halo2tpu_torch (no JAX, no
halo2tpu, no CUDA), so that it runs where neither JAX nor `cryptography`
is installed: the RSA signatures are made here in plain integers.
"""
from __future__ import annotations

import hashlib
import json
import os

from halo2tpu_torch.circuits.aadhaar_qr import (AadhaarParams,
                                                AadhaarQRVerifierCircuit,
                                                AadhaarWitness)
from halo2tpu_torch.circuits.conditional_secrets import IdentityCircuit
from halo2tpu_torch.circuits.nullifier import NullifierCircuit
from halo2tpu_torch.circuits.rsa_sha256 import RSASha256Circuit
from halo2tpu_torch.circuits.signal import SquareCircuit
from halo2tpu_torch.circuits.timestamp import TimestampCircuit
from halo2tpu_torch.gadgets.flexgate import FlexGateConfig, GateChip
from halo2tpu_torch.gadgets.qr_extractor import ExtractorChip, ExtractorConfig
from halo2tpu_torch.gadgets.range import RangeChip, RangeStrategyConfig
from halo2tpu_torch.plonk.circuit import Circuit, ConstraintSystem

ROOT = os.path.dirname(os.path.abspath(__file__))

# the proofs' bytes at their seeds (RSA-SHA256 k=15, seed 4; the composite
# k=15, seed 8), unchanged since the kernels that prove them were ported.
# halo2tpu's HostEngine proof of the RSA circuit at the same seed has the
# same sha256 (tests/golden/rsa_k15_host_proof.json, which
# tests/test_torch_rsa_golden.py holds to this pin)
RSA_PROOF_SHA256 = ("2567c205a68a04a28dbd9df0fc0d98e9"
                    "7a3589709dfd10e98b87a76f3b2cbeb9")
# the message rsa_circuit signs
RSA_MESSAGE = bytes(range(256)) * 4
COMPOSITE_PROOF_SHA256 = ("d7ee4f98ff4892a518e5757eda473410"
                          "864e3126f606cb9a17a2c3f51361afa1")
# the tamper of rsa_circuit()'s witness, (advice column, row, value)
# written after synthesis: a gate cell that is also copied (a gate and
# two copy failures) and row 0 of range_48's lookup column, far outside
# its table (a lookup and a copy failure).  halo2tpu's MockProver gives
# tests/golden/mock_k15_failures.json for it
MOCK_TAMPER = ((0, 100, 7), (48, 0, 1 << 200))


def _configured_cs(circuit) -> ConstraintSystem:
    """circuit's ConstraintSystem (configure only)."""
    cs = ConstraintSystem()
    circuit.configure(cs)
    return cs


# -- the golden circuits -----------------------------------------------------

def _range_harness():
    """The lookup-bearing RangeHarness of tests/test_gadgets.py: a 6-bit
    range check of 45 over 4 advice and 2 lookup columns."""

    class RangeHarness(Circuit):
        def configure(self, cs):
            gcfg = FlexGateConfig.configure(cs, 4)
            return gcfg, RangeStrategyConfig.configure(cs, gcfg, 6, 2)

        def synthesize(self, config, asn):
            gcfg, rcfg = config
            gate = GateChip(gcfg, asn)
            rng = RangeChip(rcfg, gate, asn)
            rng.load_table()
            rng.range_check(gate.load_witness(45), 6)

    return RangeHarness()


def mini_qr() -> bytes:
    """The synthetic 18-delimiter QR of tests/test_aadhaar_composite.py
    (the reference's field layout, a 45-byte photo holding a 255): field 2
    holds refid and timestamp digits, 4 the birth date, 5 the gender, 11
    the pincode, 13 the state."""
    fields = [b"86", b"3", b"1234" + b"20240718" + b"12" + b"4557",
              b"Sumit Kumar", b"01-01-1984", b"M", b"CO X", b"East", b"",
              b"B-31", b"", b"110051", b"KN", b"Delhi", b"RSP", b"GN",
              b"KN2", b"1234"]
    photo = bytes((i * 13 + 7) % 256 for i in range(45))
    photo = photo[:20] + b"\xff" + photo[21:]
    return b"\xff".join(fields) + b"\xff" + photo


def _extractor_harness(data: bytes):
    """The QR extractor over `data` (tests/test_qr_extractor.py's harness
    with 4-bit lookups): the year through the qr_delim lookup (delimiter
    2) and its four digits through qr_access, the gender byte after
    delimiter 5 through both."""

    class ExtractorHarness(Circuit):
        def configure(self, cs):
            gcfg = FlexGateConfig.configure(cs, 8)
            rcfg = RangeStrategyConfig.configure(cs, gcfg, 4, 1)
            return gcfg, rcfg, ExtractorConfig.configure(cs)

        def synthesize(self, config, asn):
            gcfg, rcfg, ecfg = config
            gate = GateChip(gcfg, asn)
            rng = RangeChip(rcfg, gate, asn)
            rng.load_table()
            ext = ExtractorChip(ecfg, gate, asn)
            ext.load_data([gate.load_witness(b) for b in data])
            year = ext.packed_digits(ext.delimiter_pos1(2), [5, 6, 7, 8], rng)
            gender = ext.access_offset(ext.delimiter_pos1(5), 1)
            assert (year.value, gender.value) == (2024, ord("M"))

    return ExtractorHarness()


IDENTITY_ARGS = dict(
    reveal_age_above_18=True, age_above_18=1, qr_data_age_above_18=1,
    reveal_gender=True, gender=77, qr_data_gender=77,
    reveal_pincode=True, pincode=110051, qr_data_pincode=110051,
    reveal_state=True, state=[68, 101, 108, 104, 105],
    qr_data_state=[68, 101, 108, 104, 105])
# the nullifier's photo: 124 bytes, 4 packed field elements
NULLIFIER_PHOTO = bytes((i * 7 + 3) % 256 for i in range(124))


def golden_circuits():
    """name -> (circuit, k, instances, rng_seed): the port's circuits of
    tests/golden/torch_port_proofs.json."""
    sq = SquareCircuit(5)
    nul = NullifierCircuit(12345678, NULLIFIER_PHOTO)
    return {
        "square_k4": (sq, 4, sq.instances(), 11),
        "timestamp_k6": (TimestampCircuit(2023, 7, 8, 12, 34, 56), 6, [], 27),
        "range_k7": (_range_harness(), 7, [], 22),
        "identity_k4": (IdentityCircuit(**IDENTITY_ARGS), 4, [], 5),
        "nullifier_k10": (nul, 10, nul.instances(), 31),
        "extractor_k8": (_extractor_harness(mini_qr()), 8, [], 33),
    }


# -- RSA-SHA256 and the composite at k=15 ------------------------------------

def _pkcs1v15_sha256_sign(p: int, q: int, e: int, msg: bytes) -> int:
    """RSASSA-PKCS1-v1_5 SHA-256 signature (RFC 8017 section 8.2.1) with
    the pinned key, in plain integers."""
    n = p * q
    d = pow(e, -1, (p - 1) * (q - 1))
    prefix = bytes.fromhex("3031300d060960864801650304020105000420")
    t = prefix + hashlib.sha256(msg).digest()
    k = (n.bit_length() + 7) // 8
    em = b"\x00\x01" + b"\xff" * (k - len(t) - 3) + b"\x00" + t
    return pow(int.from_bytes(em, "big"), d, n)


def _golden(name: str):
    with open(os.path.join(ROOT, "tests/golden", name)) as f:
        return json.load(f)


def rsa_circuit():
    """RSA-SHA256 over RSA_MESSAGE with the pinned key (k=15)."""
    key = _golden("rsa_key_2048.json")
    sig = _pkcs1v15_sha256_sign(key["p"], key["q"], key["e"], RSA_MESSAGE)
    return RSASha256Circuit(RSA_MESSAGE, key["p"] * key["q"], sig)


COMPOSITE_SEED = 12345678        # nullifier seed and signal of halo2tpu's
COMPOSITE_SIGNAL = 4294967295    # slow test (tests/test_aadhaar_composite.py)
COMPOSITE_SIGNED_LEN = 700
# the golden QR's fields (tests/test_qr_extractor.py)
COMPOSITE_FIELDS = {"gender": ord("M"), "pincode": 110051,
                    "state_packed": int.from_bytes(b"Delhi" + bytes(11),
                                                   "little")}


def composite_circuit():
    """The composite Aadhaar circuit at the default AadhaarParams (k=15)
    over the full 1137-byte golden QR, the first 700 bytes signed with the
    pinned key."""
    qr = bytes(_golden("qr_msg.json")["msg"])
    key = _golden("rsa_key_2048.json")
    sig = _pkcs1v15_sha256_sign(key["p"], key["q"], key["e"],
                                qr[:COMPOSITE_SIGNED_LEN])
    w = AadhaarWitness(qr, key["p"] * key["q"], sig,
                       nullifier_seed=COMPOSITE_SEED,
                       signal_hash=COMPOSITE_SIGNAL)
    return AadhaarQRVerifierCircuit(w, AadhaarParams(
        signed_len=COMPOSITE_SIGNED_LEN))
