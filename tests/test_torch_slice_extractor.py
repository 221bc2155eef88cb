"""The port's whole prover on the QR extractor harness over the mini QR at
k=8 (port_circuits._extractor_harness): byte-identical to halo2tpu's
HostEngine proof and to the golden file, and both verifiers accept it.
Its lookups are pairs whose table is advice (qr_access: position and data
byte; qr_delim: delimiter index and position), beside a 4-bit fixed range
table: the table has repeated and zero rows, is compressed by theta and
permuted by TorchEngine.permute_lookup."""
import json

import pytest
import torch

from halo2tpu.plonk.verifier import verify_proof as jax_verify_proof
from halo2tpu_torch.plonk.expression import AdviceQuery, collect_queries
from halo2tpu_torch.plonk.verifier import verify_proof
from test_torch_golden import GOLDEN, prove_both

torch.set_num_threads(1)

NAME = "extractor_k8"


@pytest.fixture(scope="module")
def proofs():
    return prove_both(NAME)


def test_extractor_k8_has_advice_table_pair_lookups(proofs):
    lookups = {lk.name: lk for lk in proofs[1][1].cs.lookups}
    for name in ("qr_access", "qr_delim"):
        assert len(lookups[name].pairs) == 2
        table: set = set()
        for _, tab in lookups[name].pairs:
            collect_queries(tab, table)
        assert any(isinstance(q, AdviceQuery) for q in table), name


def test_extractor_k8_byte_parity_and_verifies(proofs):
    (srs_j, vk_j), (srs, vk_t), host, port, inst = proofs
    assert port == host
    assert jax_verify_proof(vk_j, srs_j, inst, port)
    assert verify_proof(vk_t, srs, inst, port)


def test_extractor_k8_matches_golden(proofs):
    with open(GOLDEN) as f:
        golden = json.load(f)[NAME]
    assert proofs[3].hex() == golden["proof"]
