"""Nullifier circuit: in-circuit Poseidon of (nullifier_seed, photo).

Realizes the reference's dead-code intent — `nullifier.rs` (never compiled,
placeholder gate) plus the photo packing sketched in
`extractors/photo_extractor.rs:42-45,129-139` (31 bytes per field element)
— as real constraints.  The reference's *working* nullifier is computed
natively outside any circuit (lib.rs:890-912); that byte-per-element variant
stays available in `halo2tpu.ops.poseidon.hash_elements` and both are
cross-checked in tests.

Public inputs: [nullifier_seed, nullifier].
"""
from __future__ import annotations

from ..fields.bn254 import R
from ..gadgets.flexgate import Const, FlexGateConfig, GateChip
from ..gadgets.poseidon import PoseidonChip, PoseidonConfig
from ..gadgets.range import RangeChip, RangeStrategyConfig
from ..ops.poseidon import hash_elements
from ..plonk.circuit import Circuit, ConstraintSystem

BYTES_PER_ELEM = 31


def pack_photo(photo: bytes) -> list[int]:
    """31 bytes -> one field element, little-endian over chunks."""
    out = []
    for i in range(0, len(photo), BYTES_PER_ELEM):
        chunk = photo[i:i + BYTES_PER_ELEM]
        out.append(int.from_bytes(chunk, "little"))
    return out


def native_nullifier(seed: int, photo: bytes) -> int:
    """Host-side value of this circuit's nullifier (packed-photo variant)."""
    return hash_elements([seed] + pack_photo(photo))


class NullifierCircuit(Circuit):
    def __init__(self, nullifier_seed: int, photo: bytes,
                 num_advice: int = 8, lookup_bits: int = 8,
                 num_lookup: int = 2):
        self.seed = nullifier_seed % R
        self.photo = photo
        self.num_advice = num_advice
        self.lookup_bits = lookup_bits
        self.num_lookup = num_lookup
        self.stats = None

    def configure(self, cs: ConstraintSystem):
        gcfg = FlexGateConfig.configure(cs, self.num_advice)
        rcfg = RangeStrategyConfig.configure(
            cs, gcfg, self.lookup_bits, self.num_lookup)
        pcfg = PoseidonConfig.configure(cs)
        instance = cs.instance_column()
        cs.enable_equality(instance)
        return {"gate": gcfg, "range": rcfg, "poseidon": pcfg,
                "instance": instance}

    def synthesize(self, config, asn) -> None:
        gate = GateChip(config["gate"], asn)
        rng = RangeChip(config["range"], gate, asn)
        rng.load_table()
        pos = PoseidonChip(config["poseidon"], gate, asn)

        seed = gate.load_witness(self.seed)
        byte_cells = []
        for b in self.photo:
            c = gate.load_witness(b)
            rng.range_check(c, 8)
            byte_cells.append(c)
        packed = []
        for i in range(0, len(byte_cells), BYTES_PER_ELEM):
            chunk = byte_cells[i:i + BYTES_PER_ELEM]
            packed.append(gate.inner_product(
                chunk, [Const(1 << (8 * j)) for j in range(len(chunk))]))
        digest = pos.hash([seed] + packed)

        asn.copy((seed.col, seed.row), (config["instance"], 0))
        asn.copy((digest.col, digest.row), (config["instance"], 1))
        self.stats = pos.occupancy()

    def instances(self):
        return [[self.seed, native_nullifier(self.seed, self.photo)]]
