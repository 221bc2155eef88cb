"""tests/golden/torch_port_proofs.json is what halo2tpu's HostEngine proves
today for its own circuits, built with the parameters of
chip_smoke.golden_circuits() (which builds the port's copies): the file
that carries halo2tpu's answer to the GPU machine (which has no JAX) must
not drift from it.  The port's side, its own circuits proving these bytes
on the CPU, is in tests/test_torch_slice_{square,timestamp,range}.py."""
import json
import os

import pytest

from chip_smoke import golden_circuits
from halo2tpu.circuits.signal import SquareCircuit
from halo2tpu.circuits.timestamp import TimestampCircuit
from halo2tpu.gadgets.flexgate import FlexGateConfig, GateChip
from halo2tpu.gadgets.range import RangeChip, RangeStrategyConfig
from halo2tpu.plonk.circuit import Circuit
from halo2tpu.plonk.keygen import keygen
from halo2tpu.plonk.prover import create_proof
from halo2tpu.plonk.srs import setup

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "torch_port_proofs.json")


class RangeHarness(Circuit):
    """halo2tpu's copy of chip_smoke's RangeHarness: a 6-bit range check
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


def jax_golden_circuits():
    """name -> (halo2tpu circuit, k, instances, rng_seed), the same
    circuits and parameters as chip_smoke.golden_circuits()."""
    sq = SquareCircuit(5)
    return {
        "square_k4": (sq, 4, sq.instances(), 11),
        "timestamp_k6": (TimestampCircuit(2023, 7, 8, 12, 34, 56), 6, [], 27),
        "range_k7": (RangeHarness(), 7, [], 22),
    }


@pytest.mark.parametrize("name", ["square_k4", "timestamp_k6", "range_k7"])
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
