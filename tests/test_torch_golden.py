"""tests/golden/torch_port_proofs.json is what halo2tpu's HostEngine proves
today for its own circuits, built with the parameters of
port_circuits.golden_circuits() (which builds the port's copies): the file
that carries halo2tpu's answer to the GPU machine (which has no JAX) must
not drift from it.  The port's side, its own circuits proving these bytes
on the CPU, is in tests/test_torch_slice_{square,timestamp,range,identity,
nullifier,extractor}.py (the last four through prove_both below)."""
import json
import os

import pytest

from port_circuits import (IDENTITY_ARGS, NULLIFIER_PHOTO, golden_circuits,
                           mini_qr)
from halo2tpu.circuits.conditional_secrets import IdentityCircuit
from halo2tpu.circuits.nullifier import NullifierCircuit
from halo2tpu.circuits.signal import SquareCircuit
from halo2tpu.circuits.timestamp import TimestampCircuit
from halo2tpu.gadgets.flexgate import FlexGateConfig, GateChip
from halo2tpu.gadgets.qr_extractor import ExtractorChip, ExtractorConfig
from halo2tpu.gadgets.range import RangeChip, RangeStrategyConfig
from halo2tpu.plonk.circuit import Circuit
from halo2tpu.plonk.keygen import keygen
from halo2tpu.plonk.prover import create_proof
from halo2tpu.plonk.srs import setup

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "torch_port_proofs.json")


class RangeHarness(Circuit):
    """halo2tpu's copy of port_circuits' RangeHarness: a 6-bit range check
    of 45 over 4 advice and 2 lookup columns."""

    def configure(self, cs):
        gcfg = FlexGateConfig.configure(cs, 4)
        return gcfg, RangeStrategyConfig.configure(cs, gcfg, 6, 2)

    def synthesize(self, config, asn):
        gcfg, rcfg = config
        gate = GateChip(gcfg, asn)
        rng = RangeChip(rcfg, gate, asn)
        rng.load_table()
        rng.range_check(gate.load_witness(45), 6)


class ExtractorHarness(Circuit):
    """halo2tpu's copy of port_circuits' extractor harness: the year and the
    gender of the mini QR through the qr_delim and qr_access lookups."""

    def __init__(self, data: bytes):
        self.data = data

    def configure(self, cs):
        gcfg = FlexGateConfig.configure(cs, 8)
        rcfg = RangeStrategyConfig.configure(cs, gcfg, 4, 1)
        return gcfg, rcfg, ExtractorConfig.configure(cs)

    def synthesize(self, config, asn):
        gcfg, rcfg, ecfg = config
        gate = GateChip(gcfg, asn)
        rng = RangeChip(rcfg, gate, asn)
        rng.load_table()
        ext = ExtractorChip(ecfg, gate, asn)
        ext.load_data([gate.load_witness(b) for b in self.data])
        year = ext.packed_digits(ext.delimiter_pos1(2), [5, 6, 7, 8], rng)
        gender = ext.access_offset(ext.delimiter_pos1(5), 1)
        assert (year.value, gender.value) == (2024, ord("M"))


def jax_golden_circuits():
    """name -> (halo2tpu circuit, k, instances, rng_seed), the same
    circuits and parameters as port_circuits.golden_circuits()."""
    sq = SquareCircuit(5)
    nul = NullifierCircuit(12345678, NULLIFIER_PHOTO)
    return {
        "square_k4": (sq, 4, sq.instances(), 11),
        "timestamp_k6": (TimestampCircuit(2023, 7, 8, 12, 34, 56), 6, [], 27),
        "range_k7": (RangeHarness(), 7, [], 22),
        "identity_k4": (IdentityCircuit(**IDENTITY_ARGS), 4, [], 5),
        "nullifier_k10": (nul, 10, nul.instances(), 31),
        "extractor_k8": (ExtractorHarness(mini_qr()), 8, [], 33),
    }


GOLDEN_NAMES = list(jax_golden_circuits())


@pytest.mark.parametrize("name", GOLDEN_NAMES)
def test_golden_file_matches_halo2tpu_host_proof(name):
    with open(GOLDEN) as f:
        golden = json.load(f)[name]
    c, k, inst, seed = jax_golden_circuits()[name]
    port_c, port_k, port_inst, port_seed = golden_circuits()[name]
    assert type(port_c).__module__ != type(c).__module__
    assert (golden["k"], golden["rng_seed"]) == (k, seed)
    assert (port_k, port_inst, port_seed) == (k, inst, seed)
    srs = setup(k, cache=False)
    pk, _ = keygen(c, k, srs)
    proof = create_proof(pk, srs, c, inst, rng_seed=seed, engine="host")
    assert proof.hex() == golden["proof"]


def prove_both(name):
    """Keygen and proof of golden circuit `name` twice on the CPU: halo2tpu's
    circuit with its HostEngine, the port's copy with device="cpu".  Checks
    that the vks agree; returns ((srs, vk) of halo2tpu, (srs, vk) of the
    port, host proof, port proof, instances)."""
    from halo2tpu_torch.plonk.keygen import keygen as port_keygen
    from halo2tpu_torch.plonk.prover import create_proof as port_prove
    from halo2tpu_torch.plonk.srs import setup as port_setup
    cj, k, inst, seed = jax_golden_circuits()[name]
    c, k_t, inst_t, seed_t = golden_circuits()[name]
    assert (k_t, inst_t, seed_t) == (k, inst, seed)
    srs_j, srs = setup(k, cache=False), port_setup(k, cache=False)
    pk_j, vk_j = keygen(cj, k, srs_j)
    pk_t, vk_t = port_keygen(c, k, srs, device="cpu")
    assert vk_t.fixed_commitments == vk_j.fixed_commitments
    assert vk_t.permutation_commitments == vk_j.permutation_commitments
    assert vk_t.transcript_repr == vk_j.transcript_repr
    host = create_proof(pk_j, srs_j, cj, inst, rng_seed=seed, engine="host")
    port = port_prove(pk_t, srs, c, inst_t, rng_seed=seed, device="cpu")
    return (srs_j, vk_j), (srs, vk_t), host, port, inst
