"""The port's whole slice on a lookup-bearing circuit (RangeHarness, k=7:
compression, permuted pairs, lookup grand products): byte-identical to
halo2tpu's HostEngine proof and to the golden file.  The port proves its
own copy of the circuit (chip_smoke.golden_circuits())."""
import json

import pytest
import torch

from halo2tpu.plonk.verifier import verify_proof as jax_verify_proof
from halo2tpu_torch.plonk.verifier import verify_proof
from test_torch_golden import GOLDEN, prove_both

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def proofs():
    return prove_both("range_k7")


def test_range_k7_byte_parity_and_verifies(proofs):
    (srs_j, vk_j), (srs, vk_t), host, port, _ = proofs
    assert port == host
    assert jax_verify_proof(vk_j, srs_j, [], port)
    assert verify_proof(vk_t, srs, [], port)


def test_range_k7_matches_golden(proofs):
    with open(GOLDEN) as f:
        golden = json.load(f)["range_k7"]
    assert proofs[3].hex() == golden["proof"]
