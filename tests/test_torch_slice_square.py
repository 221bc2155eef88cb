"""The port's whole slice (keygen + create_proof on TorchEngine) against
halo2tpu on the Square circuit: byte-identical proofs, equal keys.  Each
package proves its own copy of the circuit, with the same parameters."""
import json
import os

import numpy as np
import pytest
import torch

from halo2tpu.circuits.signal import SquareCircuit as JaxSquareCircuit
from halo2tpu.plonk.keygen import keygen as jax_keygen
from halo2tpu.plonk.prover import create_proof as jax_create_proof
from halo2tpu.plonk.srs import setup as jax_setup
from halo2tpu.plonk.verifier import verify_proof as jax_verify_proof
from halo2tpu_torch.circuits.signal import SquareCircuit
from halo2tpu_torch.plonk.keygen import keygen
from halo2tpu_torch.plonk.prover import create_proof
from halo2tpu_torch.plonk.srs import setup
from halo2tpu_torch.plonk.verifier import verify_proof

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "torch_port_proofs.json")


@pytest.fixture(scope="module")
def square_k3():
    cj, c = JaxSquareCircuit(5), SquareCircuit(5)
    srs_j, srs = jax_setup(3, cache=False), setup(3, cache=False)
    return (cj, srs_j, jax_keygen(cj, 3, srs_j),
            c, srs, keygen(c, 3, srs, device="cpu"))


def test_keygen_matches_halo2tpu(square_k3):
    _, _, (pk_j, vk_j), _, _, (pk_t, vk_t) = square_k3
    assert vk_t.fixed_commitments == vk_j.fixed_commitments
    assert vk_t.permutation_commitments == vk_j.permutation_commitments
    assert vk_t.transcript_repr == vk_j.transcript_repr
    assert all(np.array_equal(a, b)
               for a, b in zip(pk_t.fixed_values, pk_j.fixed_values))
    assert np.array_equal(pk_t.perm_mapping, pk_j.perm_mapping)


def test_square_k3_byte_parity_and_verifies(square_k3):
    cj, srs_j, (pk_j, vk_j), c, srs, (pk_t, vk_t) = square_k3
    want = jax_create_proof(pk_j, srs_j, cj, cj.instances(), rng_seed=9,
                            engine="host")
    got = create_proof(pk_t, srs, c, c.instances(), rng_seed=9, device="cpu")
    assert got == want
    assert jax_verify_proof(vk_j, srs_j, cj.instances(), got)
    assert verify_proof(vk_t, srs, c.instances(), got)


def test_square_k4_matches_golden():
    with open(GOLDEN) as f:
        golden = json.load(f)["square_k4"]
    c = SquareCircuit(5)
    k = golden["k"]
    srs = setup(k, cache=False)
    pk, _ = keygen(c, k, srs, device="cpu")
    proof = create_proof(pk, srs, c, c.instances(),
                         rng_seed=golden["rng_seed"], device="cpu")
    assert proof.hex() == golden["proof"]


@pytest.mark.slow
def test_square_k3_matches_jax_engine(square_k3):
    cj, srs_j, (pk_j, _), c, srs, (pk_t, _) = square_k3
    want = jax_create_proof(pk_j, srs_j, cj, cj.instances(), rng_seed=9,
                            engine="jax")
    assert create_proof(pk_t, srs, c, c.instances(), rng_seed=9,
                        device="cpu") == want
