"""gadgets/placement.py on the CPU: the heap's least-filled column equals
min's over seeded region sizes with many ties, each of the four chips that
place through it stops at the same fill with the same error as halo2tpu's,
the constant tables equal the pow they replace, and a traced proof counts
in `placements` every region its chips placed, once."""
import random

import pytest
import torch

from halo2tpu.gadgets import flexgate as jax_flexgate
from halo2tpu.gadgets import range as jax_range
from halo2tpu.gadgets import sha256 as jax_sha256
from halo2tpu.plonk import circuit as jax_circuit
from halo2tpu_torch.fields.bn254 import R
from halo2tpu_torch.gadgets import flexgate, placement, range as range_, sha256
from halo2tpu_torch.plonk import circuit
from halo2tpu_torch.plonk.keygen import keygen
from halo2tpu_torch.plonk.prover import create_proof
from halo2tpu_torch.plonk.srs import setup
from halo2tpu_torch.plonk.verifier import verify_proof
from halo2tpu_torch.utils import trace
from test_torch_trace import HostCommitEngine

torch.set_num_threads(1)


@pytest.mark.parametrize("columns", [1, 16, 32, 80])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_least_filled_is_mins_column(columns, seed):
    """Sizes from a small set (0 among them), so fills tie often."""
    rng = random.Random(f"placement/{columns}/{seed}")
    sizes = rng.choice([[0, 1, 4], [4], [1, 2, 3, 4, 7], [3, 6, 9, 12]])
    alloc = placement.LeastFilled(columns)
    fill = [0] * columns
    ties = 0
    for _ in range(3000):
        want = min(range(columns), key=fill.__getitem__)
        ties += fill.count(fill[want]) > 1
        assert alloc.least() == (want, fill[want])
        n = rng.choice(sizes)
        alloc.take(n)
        fill[want] += n
        assert alloc.fill == fill
    assert alloc.placed == 3000
    assert columns == 1 or ties > 1000


def _chips(pkg, n):
    """(gate, range, sha) chips of one package over 4 advice, 2 lookup
    columns and 2 SHA lanes, on an Assignment of n rows."""
    fg, rg, sh, circ = pkg
    cs = circ.ConstraintSystem()
    gcfg = fg.FlexGateConfig.configure(cs, 4)
    rcfg = rg.RangeStrategyConfig.configure(cs, gcfg, 4, 2)
    scfg = sh.Sha256Config.configure(cs, 2)
    asn = circ.Assignment(cs, n)
    gate = fg.GateChip(gcfg, asn)
    return gate, rg.RangeChip(rcfg, gate, asn), sh.Sha256Chip(scfg, gate, asn)


PORT = (flexgate, range_, sha256, circuit)
JAX = (jax_flexgate, jax_range, jax_sha256, jax_circuit)


def _fill_until_exhausted(pkg, site):
    """Places regions at one call site until it refuses: (the error's type
    and message, the fills then)."""
    fg = pkg[0]
    gate, rng, sha = _chips(pkg, 64)
    sizes = random.Random(f"exhaust/{site}")
    cell = gate.load_witness(5)
    try:
        while True:
            k = sizes.choice([1, 2, 3, 5])
            if site == "assign_region":
                gate.assign_region([fg.Witness(i) for i in range(k)], [])
            elif site == "inner_product":
                gate.inner_product([fg.Witness(1)] * k, [fg.Const(2)] * k)
            elif site == "_lookup_cell":
                rng._lookup_cell(cell)
            else:
                sha._lane_rows(4 * k)
    except (OverflowError, AssertionError) as e:
        return (type(e), str(e)), (list(gate.col_fill), list(rng._cursor),
                                   list(sha._fill))
    raise AssertionError("unreachable")


@pytest.mark.parametrize("site", ["assign_region", "inner_product",
                                  "_lookup_cell", "_lane_rows"])
def test_exhaustion_matches_halo2tpu(site):
    got = _fill_until_exhausted(PORT, site)
    assert got == _fill_until_exhausted(JAX, site)
    assert got[0][0] is (OverflowError if site in ("assign_region",
                                                   "inner_product")
                         else AssertionError)


def test_pow2_consts_equal_pow():
    table = placement.pow2_consts()
    assert len(table) == placement.WORD_BITS == 32
    for i, c in enumerate(table):
        assert type(c) is flexgate.Const and c.value == pow(2, i, R)
    assert placement.pow2_consts() is table    # built once


def test_delim_inverses_equal_fermat():
    for v in range(255):
        inv = placement.delim_inverse(v)
        assert inv == pow((v - 255) % R, R - 2, R)
        assert inv * (v - 255) % R == 1
    # outside the table: today's pow
    for v in (255, 256, 1000, R - 1, 1 << 200):
        assert placement.delim_inverse(v) == pow((v - 255) % R, R - 2, R)


class PlacementHarness(circuit.Circuit):
    """Every chip that places regions, ending in both occupancy reports,
    which share the gate's columns."""

    def configure(self, cs):
        gcfg = flexgate.FlexGateConfig.configure(cs, 4)
        return (gcfg, range_.RangeStrategyConfig.configure(cs, gcfg, 6, 2),
                sha256.Sha256Config.configure(cs, 2))

    def synthesize(self, config, asn):
        gcfg, rcfg, scfg = config
        gate = flexgate.GateChip(gcfg, asn)
        rng = range_.RangeChip(rcfg, gate, asn)
        sha = sha256.Sha256Chip(scfg, gate, asn)
        rng.load_table()
        a, b = gate.load_witness(45), gate.load_witness(1000)
        rng.range_check(gate.add(a, b), 12)
        x = gate.inner_product([a, b, a], [flexgate.Const(3)] * 3)
        wa, _ = sha.decompose(gate.load_witness(0x1234), 32)
        wb, _ = sha.decompose(gate.load_witness(0xF00F), 32)
        bits = sha.xor3_bits(wa.bits[:8], wb.bits[:8], wa.bits[8:16])
        sha._pack_sum([bits], [x])
        self.stats = {**rng.finalize(), **sha.occupancy()}


def test_a_traced_proof_counts_each_placed_region_once(monkeypatch):
    regions = []
    for cls, name in ((flexgate.GateChip, "assign_region"),
                      (flexgate.GateChip, "inner_product"),
                      (range_.RangeChip, "_lookup_cell"),
                      (sha256.Sha256Chip, "_lane_rows")):
        def counted(self, *args, _fn=getattr(cls, name), _name=name):
            regions.append(_name)
            return _fn(self, *args)
        monkeypatch.setattr(cls, name, counted)
    c, k = PlacementHarness(), 7
    srs = setup(k, cache=False)
    pk, vk = keygen(c, k, srs, device="cpu")
    regions.clear()
    eng = HostCommitEngine(pk.vk.domain, srs, "cpu")
    proof = create_proof(pk, srs, c, [], rng_seed=3, engine=eng,
                         tracer=trace.Tracer())
    rec = trace.recent()[-1]
    assert set(regions) == {"assign_region", "inner_product",
                            "_lookup_cell", "_lane_rows"}
    assert rec.counters["placements"] == len(regions)
    assert verify_proof(vk, srs, [], proof)
