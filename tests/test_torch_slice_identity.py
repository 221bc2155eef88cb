"""The port's whole prover on IdentityCircuit at k=4 (conditional_secrets:
the reveal flags, one degree-3 gate over 20 advice columns): byte-identical
to halo2tpu's HostEngine proof and to the golden file, and both verifiers
accept it."""
import json

import pytest
import torch

from halo2tpu.plonk.verifier import verify_proof as jax_verify_proof
from halo2tpu_torch.plonk.verifier import verify_proof
from test_torch_golden import GOLDEN, prove_both

torch.set_num_threads(1)

NAME = "identity_k4"


@pytest.fixture(scope="module")
def proofs():
    return prove_both(NAME)


def test_identity_k4_byte_parity_and_verifies(proofs):
    (srs_j, vk_j), (srs, vk_t), host, port, inst = proofs
    assert port == host
    assert jax_verify_proof(vk_j, srs_j, inst, port)
    assert verify_proof(vk_t, srs, inst, port)


def test_identity_k4_matches_golden(proofs):
    with open(GOLDEN) as f:
        golden = json.load(f)[NAME]
    assert proofs[3].hex() == golden["proof"]
