"""The port's whole slice on the Timestamp circuit (k=6, permutation only):
byte-identical to halo2tpu's HostEngine proof and to the golden file."""
import json
import os

import pytest
import torch

from halo2tpu.circuits.timestamp import TimestampCircuit
from halo2tpu.plonk.keygen import keygen as jax_keygen
from halo2tpu.plonk.prover import create_proof as jax_create_proof
from halo2tpu.plonk.srs import setup
from halo2tpu.plonk.verifier import verify_proof
from halo2tpu_torch.plonk.keygen import keygen
from halo2tpu_torch.plonk.prover import create_proof

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "torch_port_proofs.json")
K, SEED = 6, 27


@pytest.fixture(scope="module")
def proofs():
    c = TimestampCircuit(2023, 7, 8, 12, 34, 56)
    srs = setup(K, cache=False)
    pk_j, vk_j = jax_keygen(c, K, srs)
    pk_t, vk_t = keygen(c, K, srs)
    assert vk_t.transcript_repr == vk_j.transcript_repr
    host = jax_create_proof(pk_j, srs, c, [], rng_seed=SEED, engine="host")
    port = create_proof(pk_t, srs, c, [], rng_seed=SEED)
    return srs, vk_j, host, port


def test_timestamp_k6_byte_parity_and_verifies(proofs):
    srs, vk, host, port = proofs
    assert port == host
    assert verify_proof(vk, srs, [], port)


def test_timestamp_k6_matches_golden(proofs):
    with open(GOLDEN) as f:
        golden = json.load(f)["timestamp_k6"]
    assert (golden["k"], golden["rng_seed"]) == (K, SEED)
    assert proofs[3].hex() == golden["proof"]
