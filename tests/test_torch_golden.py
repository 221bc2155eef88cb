"""tests/golden/torch_port_proofs.json is what halo2tpu's HostEngine proves
today: the file that carries halo2tpu's answer to the GPU machine (which
has no JAX) must not drift from it."""
import json
import os

import pytest

from chip_smoke import golden_circuits
from halo2tpu.plonk.keygen import keygen
from halo2tpu.plonk.prover import create_proof
from halo2tpu.plonk.srs import setup

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "torch_port_proofs.json")


@pytest.mark.parametrize("name", ["square_k4", "timestamp_k6", "range_k7"])
def test_golden_file_matches_halo2tpu_host_proof(name):
    with open(GOLDEN) as f:
        golden = json.load(f)[name]
    c, k, inst, seed = golden_circuits()[name]
    assert (golden["k"], golden["rng_seed"]) == (k, seed)
    srs = setup(k, cache=False)
    pk, _ = keygen(c, k, srs)
    proof = create_proof(pk, srs, c, inst, rng_seed=seed, engine="host")
    assert proof.hex() == golden["proof"]
