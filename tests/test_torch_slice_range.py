"""The port's whole slice on a lookup-bearing circuit (RangeHarness, k=7:
compression, permuted pairs, lookup grand products): byte-identical to
halo2tpu's HostEngine proof and to the golden file.  The port proves its
own copy of the circuit (chip_smoke.golden_circuits())."""
import json
import os

import pytest
import torch

from chip_smoke import golden_circuits
from halo2tpu.plonk.keygen import keygen as jax_keygen
from halo2tpu.plonk.prover import create_proof as jax_create_proof
from halo2tpu.plonk.srs import setup as jax_setup
from halo2tpu.plonk.verifier import verify_proof as jax_verify_proof
from halo2tpu_torch.plonk.keygen import keygen
from halo2tpu_torch.plonk.prover import create_proof
from halo2tpu_torch.plonk.srs import setup
from halo2tpu_torch.plonk.verifier import verify_proof
from test_torch_golden import jax_golden_circuits

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "torch_port_proofs.json")


@pytest.fixture(scope="module")
def proofs():
    cj, k, inst, seed = jax_golden_circuits()["range_k7"]
    c, k_t, inst_t, seed_t = golden_circuits()["range_k7"]
    assert (k_t, inst_t, seed_t) == (k, inst, seed)
    srs_j, srs = jax_setup(k, cache=False), setup(k, cache=False)
    pk_j, vk_j = jax_keygen(cj, k, srs_j)
    pk_t, vk_t = keygen(c, k, srs, device="cpu")
    assert vk_t.fixed_commitments == vk_j.fixed_commitments
    assert vk_t.permutation_commitments == vk_j.permutation_commitments
    assert vk_t.transcript_repr == vk_j.transcript_repr
    host = jax_create_proof(pk_j, srs_j, cj, inst, rng_seed=seed,
                            engine="host")
    port = create_proof(pk_t, srs, c, inst_t, rng_seed=seed, device="cpu")
    return (srs_j, vk_j), (srs, vk_t), host, port


def test_range_k7_byte_parity_and_verifies(proofs):
    (srs_j, vk_j), (srs, vk_t), host, port = proofs
    assert port == host
    assert jax_verify_proof(vk_j, srs_j, [], port)
    assert verify_proof(vk_t, srs, [], port)


def test_range_k7_matches_golden(proofs):
    with open(GOLDEN) as f:
        golden = json.load(f)["range_k7"]
    assert proofs[3].hex() == golden["proof"]
