"""The composite Aadhaar k=15 proof's golden
(tests/golden/composite_k15_host_proof.json): the sha256 of halo2tpu's
HostEngine proof of port_circuits.composite_circuit()'s circuit at rng_seed 8,
held to port_circuits.py's literal pin COMPOSITE_PROOF_SHA256 (the port's
proof on the card must have it) and to the inputs port_circuits signs.
halo2tpu's circuit and the port's, built from those inputs, have the same
instances.

Run as a script, it proves the circuit again with halo2tpu alone (host
keygen and the host prover over python ints: slow, run it in the
background), prints each phase's time and the record it would keep, and
exits non-zero unless the proof verifies and has the pinned sha256.  It
never writes the golden:
    JAX_PLATFORMS=cpu python tests/test_torch_composite_golden.py
"""
import hashlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import port_circuits  # noqa: E402

GOLDEN = os.path.join(ROOT, "tests/golden/composite_k15_host_proof.json")


def _qr() -> bytes:
    with open(os.path.join(ROOT, "tests/golden/qr_msg.json")) as f:
        return bytes(json.load(f)["msg"])


def _halo2tpu_circuit():
    """halo2tpu's AadhaarQRVerifierCircuit over port_circuits' QR, key,
    signature, nullifier seed and signal."""
    from halo2tpu.circuits.aadhaar_qr import (AadhaarParams,
                                              AadhaarQRVerifierCircuit,
                                              AadhaarWitness)
    with open(os.path.join(ROOT, "tests/golden/rsa_key_2048.json")) as f:
        key = json.load(f)
    qr = _qr()
    sig = port_circuits._pkcs1v15_sha256_sign(
        key["p"], key["q"], key["e"], qr[:port_circuits.COMPOSITE_SIGNED_LEN])
    w = AadhaarWitness(qr, key["p"] * key["q"], sig,
                       nullifier_seed=port_circuits.COMPOSITE_SEED,
                       signal_hash=port_circuits.COMPOSITE_SIGNAL)
    return AadhaarQRVerifierCircuit(w, AadhaarParams(
        signed_len=port_circuits.COMPOSITE_SIGNED_LEN))


def test_composite_host_golden_is_the_card_pin():
    with open(GOLDEN) as f:
        g = json.load(f)
    assert g["sha256"] == port_circuits.COMPOSITE_PROOF_SHA256
    assert (g["k"], g["rng_seed"], g["engine"], g["verifies"]) == (
        15, 8, "host", True)
    assert g["qr_sha256"] == hashlib.sha256(_qr()).hexdigest()
    assert (g["signed_len"], g["nullifier_seed"], g["signal_hash"]) == (
        port_circuits.COMPOSITE_SIGNED_LEN, port_circuits.COMPOSITE_SEED,
        port_circuits.COMPOSITE_SIGNAL)


def test_composite_host_golden_circuit_is_chip_smokes():
    """The golden's circuit (halo2tpu's) and the port's card circuit take
    the same public inputs: the nullifier seed, signal, pubkey hash,
    nullifier, timestamp and the revealed fields."""
    assert _halo2tpu_circuit().instances() == (
        port_circuits.composite_circuit().instances())


def main() -> int:
    import time
    from halo2tpu.plonk.keygen import keygen
    from halo2tpu.plonk.prover import create_proof
    from halo2tpu.plonk.srs import setup
    from halo2tpu.plonk.verifier import verify_proof
    c = _halo2tpu_circuit()
    srs = setup(15)
    t0 = time.perf_counter()
    pk, vk = keygen(c, 15, srs)
    t1 = time.perf_counter()
    print(f"keygen {t1 - t0:.1f} s", flush=True)
    proof = create_proof(pk, srs, c, c.instances(), rng_seed=8,
                         engine="host")
    t2 = time.perf_counter()
    ok = verify_proof(vk, srs, c.instances(), proof)
    t3 = time.perf_counter()
    print(f"keygen {t1 - t0:.1f} s, proof {t2 - t1:.1f} s, verify "
          f"{t3 - t2:.1f} s, {len(proof)} bytes, verifies {ok}")
    new = {
        "circuit": "halo2tpu.circuits.aadhaar_qr.AadhaarQRVerifierCircuit "
                   "as port_circuits.composite_circuit() builds the port's: "
                   "the 1137-byte QR tests/golden/qr_msg.json, its first "
                   "700 bytes signed with tests/golden/rsa_key_2048.json "
                   "by port_circuits._pkcs1v15_sha256_sign, "
                   "AadhaarParams(signed_len=700)",
        "k": 15,
        "srs": "halo2tpu.plonk.srs.setup(15) (the dev SRS)",
        "keygen": "halo2tpu.plonk.keygen.keygen(circuit, 15, srs) "
                  "(engine=None: host ints)",
        "prover": "halo2tpu.plonk.prover.create_proof(pk, srs, circuit, "
                  "circuit.instances(), rng_seed=8, engine='host')",
        "rng_seed": 8,
        "engine": "host",
        "qr_sha256": hashlib.sha256(_qr()).hexdigest(),
        "signed_len": port_circuits.COMPOSITE_SIGNED_LEN,
        "nullifier_seed": port_circuits.COMPOSITE_SEED,
        "signal_hash": port_circuits.COMPOSITE_SIGNAL,
        "proof_bytes": len(proof),
        "sha256": hashlib.sha256(proof).hexdigest(),
        "verifies": ok,
    }
    print(json.dumps(new, indent=1))
    same = new["sha256"] == port_circuits.COMPOSITE_PROOF_SHA256
    print(f"sha256 {new['sha256']}: "
          + ("the pin's" if same else f"differs from the pin "
             f"{port_circuits.COMPOSITE_PROOF_SHA256}"))
    return 0 if ok and same else 1


if __name__ == "__main__":
    sys.exit(main())
