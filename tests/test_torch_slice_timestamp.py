"""The port's whole slice on the Timestamp circuit (k=6, permutation only):
byte-identical to halo2tpu's HostEngine proof and to the golden file.  The
port proves its own copy of the circuit (port_circuits.golden_circuits())."""
import json
import os

import pytest
import torch

from port_circuits import golden_circuits
from halo2tpu.circuits.timestamp import TimestampCircuit
from halo2tpu.plonk.keygen import keygen as jax_keygen
from halo2tpu.plonk.prover import create_proof as jax_create_proof
from halo2tpu.plonk.srs import setup as jax_setup
from halo2tpu.plonk.verifier import verify_proof as jax_verify_proof
from halo2tpu_torch.plonk.keygen import keygen
from halo2tpu_torch.plonk.prover import create_proof
from halo2tpu_torch.plonk.srs import setup
from halo2tpu_torch.plonk.verifier import verify_proof

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "torch_port_proofs.json")
K, SEED = 6, 27


@pytest.fixture(scope="module")
def proofs():
    cj = TimestampCircuit(2023, 7, 8, 12, 34, 56)
    c, k, inst, seed = golden_circuits()["timestamp_k6"]
    assert (k, inst, seed) == (K, [], SEED)
    srs_j, srs = jax_setup(K, cache=False), setup(K, cache=False)
    pk_j, vk_j = jax_keygen(cj, K, srs_j)
    pk_t, vk_t = keygen(c, K, srs, device="cpu")
    assert vk_t.transcript_repr == vk_j.transcript_repr
    host = jax_create_proof(pk_j, srs_j, cj, [], rng_seed=SEED,
                            engine="host")
    port = create_proof(pk_t, srs, c, [], rng_seed=SEED, device="cpu")
    return (srs_j, vk_j), (srs, vk_t), host, port


def test_timestamp_k6_byte_parity_and_verifies(proofs):
    (srs_j, vk_j), (srs, vk_t), host, port = proofs
    assert port == host
    assert jax_verify_proof(vk_j, srs_j, [], port)
    assert verify_proof(vk_t, srs, [], port)


def test_timestamp_k6_matches_golden(proofs):
    with open(GOLDEN) as f:
        golden = json.load(f)["timestamp_k6"]
    assert (golden["k"], golden["rng_seed"]) == (K, SEED)
    assert proofs[3].hex() == golden["proof"]
