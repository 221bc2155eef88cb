"""Witness-level parity at the scale of the card's circuits, with no proof:
the composite Aadhaar circuit at the mini-QR parameters (K = 14, as
tests/test_aadhaar_composite.py runs it) and RSA-SHA256 at
port_circuits.py's k=15 parameters.  The port's copy and halo2tpu's
circuit must give the same structure digest, synthesized advice and fixed
columns, instances and permutation mapping.

At the benchmark's two configurations, synthesis as a proof runs it
(`recording=False`) on two of its requests: the same advice columns and
the same stats (the chips' fills from `finalize` and `occupancy`)."""
import functools
import json
import os

import numpy as np
import pytest

import port_circuits
from halo2tpu.circuits import aadhaar_qr as jax_aadhaar
from halo2tpu.circuits.rsa_sha256 import RSASha256Circuit as JaxRSA
from halo2tpu.plonk import circuit as jax_circuit
from halo2tpu.plonk import keygen as jax_keygen
from halo2tpu.circuits import rsa_sha256 as jax_rsa_sha256
from halo2tpu_torch.circuits import aadhaar_qr, rsa_sha256
from halo2tpu_torch.plonk import circuit, keygen
from portbench import manifest, traffic

# tests/test_aadhaar_composite.py's MINI_PARAMS, signing the whole QR
MINI = dict(max_signed_len=160, max_photo=62, max_state=16, num_advice=48,
            num_lookup_advice=12, lookup_bits=12, sha_lanes=16)
CASES = {"composite_mini": 14, "rsa_sha256": 15}


def _key():
    with open(os.path.join(port_circuits.ROOT,
                           "tests/golden/rsa_key_2048.json")) as f:
        key = json.load(f)
    return key["p"], key["q"], key["e"]


def _circuits(case):
    """(halo2tpu's circuit, the port's) for a case, same witness."""
    if case == "rsa_sha256":
        port = port_circuits.rsa_circuit()
        return JaxRSA(port.msg, port.n, port.sig), port
    p, q, e = _key()
    qr = port_circuits.mini_qr()
    sig = port_circuits._pkcs1v15_sha256_sign(p, q, e, qr)
    pair = []
    for mod in (jax_aadhaar, aadhaar_qr):
        w = mod.AadhaarWitness(qr, p * q, sig, nullifier_seed=12345678,
                               signal_hash=4294967295)
        params = mod.AadhaarParams(signed_len=len(qr), **MINI)
        pair.append(mod.AadhaarQRVerifierCircuit(w, params))
    return tuple(pair)


def _synthesize(c, pkg_circuit, pkg_keygen, n):
    cs = pkg_circuit.ConstraintSystem()
    config = c.configure(cs)
    asn = pkg_circuit.Assignment(cs, n)
    c.synthesize(config, asn)
    return {"digest": pkg_keygen.cs_structure_digest(c),
            "advice": [col.tolist() for col in asn.advice],
            "fixed": [col.tolist() for col in asn.fixed],
            "instances": (c.instances(),
                          [col.tolist() for col in asn.instance]),
            "permutation": pkg_keygen.build_permutation_mapping(
                cs, n, asn.copies)}


@functools.lru_cache(maxsize=1)
def _witnesses(case):
    n = 1 << CASES[case]
    cj, c = _circuits(case)
    assert type(c).__module__.startswith("halo2tpu_torch.")
    return (_synthesize(cj, jax_circuit, jax_keygen, n),
            _synthesize(c, circuit, keygen, n))


@pytest.mark.parametrize("part", ["digest", "advice", "fixed", "instances",
                                  "permutation"])
@pytest.mark.parametrize("case", list(CASES))
def test_witness_matches_halo2tpu(case, part):
    want, got = (w[part] for w in _witnesses(case))
    if part == "permutation":
        assert got.shape == want.shape and np.array_equal(got, want)
    else:
        assert got == want


def test_composite_mini_outputs_match_halo2tpu():
    cj, c = _circuits("composite_mini")
    want = jax_aadhaar.native_outputs(cj.w, cj.p)
    assert aadhaar_qr.native_outputs(c.w, c.p) == want
    assert c.instances() == cj.instances()
    assert want["gender"] == ord("M") and want["pincode"] == 110051


def test_mini_qr_is_the_composite_tests_qr():
    from test_aadhaar_composite import build_mini_qr
    assert port_circuits.mini_qr() == build_mini_qr()


# the benchmark's configurations: (cell, halo2tpu's module, the port's)
BENCH = {"aadhaar_qr_k15": ("aadhaar_k15.fresh_users", jax_aadhaar,
                            aadhaar_qr),
         "rsa_sha256_k15": ("rsa_k15.fresh_messages", jax_rsa_sha256,
                            rsa_sha256)}


def _proof_time(c, pkg_circuit, n):
    cs = pkg_circuit.ConstraintSystem()
    config = c.configure(cs)
    asn = pkg_circuit.Assignment(cs, n, recording=False)
    c.synthesize(config, asn)
    return [col.tolist() for col in asn.advice], c.stats


@functools.lru_cache(maxsize=1)
def _bench_witnesses(name):
    """[(halo2tpu's (advice, stats), the port's)] for two requests of the
    configuration's cell, seed 20260419."""
    cell_name, jax_mod, port_mod = BENCH[name]
    cell = manifest.cell(manifest.load(), cell_name)
    config, mix = cell["config"], cell["mix"]
    assert config["name"] == name
    fam = manifest.family(config["family"])
    n = 1 << config["k"]
    return [tuple(_proof_time(fam.circuit(config, req, mod), pkg, n)
                  for mod, pkg in ((jax_mod, jax_circuit),
                                   (port_mod, circuit)))
            for req in traffic.requests(mix, config, fam, 20260419, 2)]


@pytest.mark.parametrize("part", ["advice", "stats"])
@pytest.mark.parametrize("name", list(BENCH))
def test_proof_time_synthesis_matches_halo2tpu(name, part):
    i = ["advice", "stats"].index(part)
    pairs = _bench_witnesses(name)
    for want, got in pairs:
        assert got[i] == want[i]
    # two requests, two witnesses, one layout
    assert pairs[0][1][0] != pairs[1][1][0]
    assert pairs[0][1][1] == pairs[1][1][1]
