"""The port's whole slice on a lookup-bearing circuit (RangeHarness, k=7:
compression, permuted pairs, lookup grand products): byte-identical to
halo2tpu's HostEngine proof and to the golden file."""
import json
import os

import pytest
import torch

from chip_smoke import golden_circuits
from halo2tpu.plonk.keygen import keygen as jax_keygen
from halo2tpu.plonk.prover import create_proof as jax_create_proof
from halo2tpu.plonk.srs import setup
from halo2tpu.plonk.verifier import verify_proof
from halo2tpu_torch.plonk.keygen import keygen
from halo2tpu_torch.plonk.prover import create_proof

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "torch_port_proofs.json")


@pytest.fixture(scope="module")
def proofs():
    c, k, inst, seed = golden_circuits()["range_k7"]
    srs = setup(k, cache=False)
    pk_j, vk_j = jax_keygen(c, k, srs)
    pk_t, vk_t = keygen(c, k, srs)
    assert vk_t.fixed_commitments == vk_j.fixed_commitments
    assert vk_t.permutation_commitments == vk_j.permutation_commitments
    host = jax_create_proof(pk_j, srs, c, inst, rng_seed=seed, engine="host")
    port = create_proof(pk_t, srs, c, inst, rng_seed=seed)
    return srs, vk_j, host, port


def test_range_k7_byte_parity_and_verifies(proofs):
    srs, vk, host, port = proofs
    assert port == host
    assert verify_proof(vk, srs, [], port)


def test_range_k7_matches_golden(proofs):
    with open(GOLDEN) as f:
        golden = json.load(f)["range_k7"]
    assert proofs[3].hex() == golden["proof"]
