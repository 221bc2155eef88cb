"""The RSA-SHA256 k=15 proof's golden (tests/golden/rsa_k15_host_proof.json):
the sha256 of halo2tpu's HostEngine proof of port_circuits.rsa_circuit()'s
circuit at rng_seed 4, held to port_circuits.py's literal pin
RSA_PROOF_SHA256 (the port's proof on the card must have it) and to the
inputs port_circuits signs.  halo2tpu's circuit and the port's, built from
those inputs, have the same instances.

Run as a script, it proves the circuit again with halo2tpu alone (host
keygen and the host prover over python ints: slow, run it in the
background), prints each phase's time and the record it would keep, and
exits non-zero unless the proof verifies and has the golden's sha256.  It
never writes the golden:
    JAX_PLATFORMS=cpu python tests/test_torch_rsa_golden.py
"""
import hashlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import port_circuits  # noqa: E402

GOLDEN = os.path.join(ROOT, "tests/golden/rsa_k15_host_proof.json")


def _halo2tpu_circuit():
    """halo2tpu's RSASha256Circuit over port_circuits' message, key and
    signature."""
    from halo2tpu.circuits.rsa_sha256 import RSASha256Circuit
    with open(os.path.join(ROOT, "tests/golden/rsa_key_2048.json")) as f:
        key = json.load(f)
    sig = port_circuits._pkcs1v15_sha256_sign(key["p"], key["q"], key["e"],
                                              port_circuits.RSA_MESSAGE)
    return RSASha256Circuit(port_circuits.RSA_MESSAGE, key["p"] * key["q"],
                            sig)


def test_rsa_host_golden_is_the_card_pin():
    with open(GOLDEN) as f:
        g = json.load(f)
    assert g["sha256"] == port_circuits.RSA_PROOF_SHA256
    assert (g["k"], g["rng_seed"], g["engine"], g["verifies"]) == (
        15, 4, "host", True)
    assert g["message_sha256"] == hashlib.sha256(
        port_circuits.RSA_MESSAGE).hexdigest()


def test_rsa_host_golden_circuit_is_chip_smokes():
    """The golden's circuit (halo2tpu's) and the port's card circuit take
    the same public inputs: the modulus limbs and the message hash."""
    assert _halo2tpu_circuit().instances() == (
        port_circuits.rsa_circuit().instances())


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
    proof = create_proof(pk, srs, c, c.instances(), rng_seed=4,
                         engine="host")
    t2 = time.perf_counter()
    ok = verify_proof(vk, srs, c.instances(), proof)
    t3 = time.perf_counter()
    print(f"keygen {t1 - t0:.1f} s, proof {t2 - t1:.1f} s, verify "
          f"{t3 - t2:.1f} s, {len(proof)} bytes, verifies {ok}")
    with open(GOLDEN) as f:
        g = json.load(f)
    new = dict(g, sha256=hashlib.sha256(proof).hexdigest(),
               proof_bytes=len(proof), verifies=ok,
               message_sha256=hashlib.sha256(
                   port_circuits.RSA_MESSAGE).hexdigest())
    print(json.dumps(new, indent=1))
    same = new["sha256"] == g["sha256"]
    print(f"sha256 {new['sha256']}: "
          + ("the golden's" if same else f"differs from the golden's "
             f"{g['sha256']}"))
    return 0 if ok and same else 1


if __name__ == "__main__":
    sys.exit(main())
