"""RSA-SHA256 circuit — the flagship Aadhaar signature-verification circuit.

Re-design of the reference's `TestRSASignatureWithHashCircuit1`
(anon-aadhaar-halo2/src/lib.rs:256-397) and `RSASignatureVerifier`
(lib.rs:178-246): SHA-256 digest of the signed message, digest bytes packed
into 64-bit limbs, then in-circuit RSASSA-PKCS1-v1_5 verification against
the public key.  Public inputs: the 32 public-modulus limbs and the 32
digest bytes (lib.rs:316-319,389-394).

Reference constants (lib.rs:263-274): BITS_LEN=2048, MSG_LEN=1024,
DEFAULT_E=65537, LOOKUP_BITS=12, k=15.  Here the message length is a
constructor parameter (the SHA chip is block-parametric).
"""
from __future__ import annotations

from dataclasses import dataclass

from ..fields.bn254 import R
from ..gadgets.biguint import BigUintChip
from ..gadgets.flexgate import Const, FlexGateConfig, GateChip
from ..gadgets.range import RangeChip, RangeStrategyConfig
from ..gadgets.rsa import RSAChip, RSAPublicKey, RSASignature
from ..gadgets.sha256 import Sha256Chip, Sha256Config
from ..plonk.circuit import Circuit, ConstraintSystem

BITS_LEN = 2048
LIMB_BITS = 64
NUM_LIMBS = BITS_LEN // LIMB_BITS
DEFAULT_E = 65537
EXP_BITS = 17


@dataclass
class RSASha256Params:
    num_advice: int = 48
    num_lookup_advice: int = 12
    lookup_bits: int = 12
    sha_lanes: int = 16
    # Dynamic-length SHA-256 (default, matching the reference's
    # `Sha256DynamicConfig` with max 1024, anon-aadhaar-halo2/src/lib.rs:264,
    # 308-315): ONE vk serves any message length <= max_msg_len.  Set None
    # for the legacy static path (message length baked into the vk).
    max_msg_len: int | None = 1024


class RSASha256Circuit(Circuit):
    """Proves: sha256(msg) = H and sig^e = pkcs1v15_pad(H) mod n."""

    def __init__(self, msg: bytes, n: int, sig: int,
                 params: RSASha256Params | None = None):
        self.msg = msg
        self.n = n
        self.sig = sig
        self.p = params or RSASha256Params()
        self.stats = None

    def configure(self, cs: ConstraintSystem):
        p = self.p
        gcfg = FlexGateConfig.configure(cs, p.num_advice)
        rcfg = RangeStrategyConfig.configure(
            cs, gcfg, p.lookup_bits, p.num_lookup_advice)
        scfg = Sha256Config.configure(cs, p.sha_lanes)
        n_instance = cs.instance_column()
        hash_instance = cs.instance_column()
        cs.enable_equality(n_instance)
        cs.enable_equality(hash_instance)
        return {"gate": gcfg, "range": rcfg, "sha": scfg,
                "n_instance": n_instance, "hash_instance": hash_instance}

    def synthesize(self, config, asn) -> None:
        gate = GateChip(config["gate"], asn)
        rng = RangeChip(config["range"], gate, asn)
        rng.load_table()
        sha = Sha256Chip(config["sha"], gate, asn)
        big = BigUintChip(gate, rng, LIMB_BITS)
        rsa = RSAChip(big, BITS_LEN, EXP_BITS)

        # message bytes: witnessed and 8-bit range-checked (soundness of the
        # byte->word packing inside the sha chip)
        if self.p.max_msg_len is not None:
            from ..gadgets.sha256 import pad_dynamic
            buf = pad_dynamic(self.msg, self.p.max_msg_len)
            data_cells = []
            for b in buf:
                c = gate.load_witness(b)
                rng.range_check(c, 8)
                data_cells.append(c)
            mlen_cell = gate.load_witness(len(self.msg))
            digest = sha.digest_dynamic(data_cells, mlen_cell,
                                        self.p.max_msg_len)
        else:
            msg_cells = []
            for b in self.msg:
                c = gate.load_witness(b)
                rng.range_check(c, 8)
                msg_cells.append(c)
            digest = sha.digest(msg_cells, self.msg)  # 32 BE byte cells

        # digest bytes -> 4 LE u64 words (reference reverses then packs,
        # lib.rs:222-239)
        rev = digest[::-1]
        words = []
        for i in range(4):
            words.append(gate.inner_product(
                rev[8 * i:8 * i + 8],
                [Const(1 << (8 * j)) for j in range(8)]))

        pk = rsa.assign_public_key(RSAPublicKey(self.n, DEFAULT_E))
        s = rsa.assign_signature(RSASignature(self.sig))
        ok = rsa.verify_pkcs1v15_signature(pk, words, s)
        gate.assert_is_const(ok, 1)

        # public inputs
        for i, limb in enumerate(pk.n.limbs):
            asn.copy((limb.col, limb.row), (config["n_instance"], i))
        for i, byte in enumerate(digest):
            asn.copy((byte.col, byte.row), (config["hash_instance"], i))

        self.stats = {**rng.finalize(), **sha.occupancy()}

    def layout_tag(self) -> str:
        """Everything the synthesized LAYOUT depends on beyond the
        constraint system (keygen cache safety; see cs_structure_digest)."""
        p = self.p
        mlen = "dyn" if p.max_msg_len is not None else len(self.msg)
        return (f"rsa,{p.num_advice},{p.num_lookup_advice},{p.lookup_bits},"
                f"{p.sha_lanes},{p.max_msg_len},{mlen}")

    def instances(self):
        n_limbs = [(self.n >> (LIMB_BITS * i)) & ((1 << LIMB_BITS) - 1)
                   for i in range(NUM_LIMBS)]
        import hashlib
        h = hashlib.sha256(self.msg).digest()
        return [n_limbs, list(h)]
