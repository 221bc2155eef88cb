"""The port's whole prover on NullifierCircuit at k=10 (Poseidon over a
seed and a 124-byte photo): byte-identical to halo2tpu's HostEngine proof
and to the golden file, and both verifiers accept it.  The circuit has
degree 6 (the x^5 S-box), so it takes the composite's quotient path: an
extended domain of 8 parts, 5 h chunks and permutation chunks of length
4."""
import json

import pytest
import torch

from halo2tpu.plonk.verifier import verify_proof as jax_verify_proof
from halo2tpu_torch.plonk.verifier import verify_proof
from test_torch_golden import GOLDEN, prove_both

torch.set_num_threads(1)

NAME = "nullifier_k10"


@pytest.fixture(scope="module")
def proofs():
    return prove_both(NAME)


def test_nullifier_k10_takes_the_8_part_path(proofs):
    d, cs = proofs[1][1].domain, proofs[1][1].cs
    assert (cs.degree(), d.extended_n // d.n, d.quotient_poly_degree) == (
        6, 8, 5)
    assert cs.permutation_chunk_len() == 4


def test_nullifier_k10_byte_parity_and_verifies(proofs):
    (srs_j, vk_j), (srs, vk_t), host, port, inst = proofs
    assert port == host
    assert jax_verify_proof(vk_j, srs_j, inst, port)
    assert verify_proof(vk_t, srs, inst, port)


def test_nullifier_k10_rejects_another_nullifier(proofs):
    (srs_j, vk_j), (srs, vk_t), _, port, inst = proofs
    bad = [list(inst[0])]
    bad[0][1] ^= 1
    assert not verify_proof(vk_t, srs, bad, port)
    assert not jax_verify_proof(vk_j, srs_j, bad, port)


def test_nullifier_k10_matches_golden(proofs):
    with open(GOLDEN) as f:
        golden = json.load(f)[NAME]
    assert proofs[3].hex() == golden["proof"]
