"""Composite Aadhaar QR verifier — ONE circuit proving the full protocol.

Realizes the reference's dead-code intent (`aadhaar_verifier_circuit.rs` —
a composite circuit struct that never compiled; `qr_data_extractor.rs:9-28`
— the intended single-circuit public-input layout) as a working circuit.
The reference's flagship test instead runs five separate MockProver passes
with native extraction between them (lib.rs:649-1053); here everything is
in-circuit and bound to one witness:

  1. RSA-SHA256: sha256(qr_data[:signed_len]) verified under the issuer key
     (pkcs1v15), lib.rs:211-245 semantics.
  2. Field extraction from the 255-delimited QR payload (timestamp, DOB,
     gender, pincode, state, photo) via the lookup-based extractor chip.
  3. Age computation + reveal-flag gating (conditional_secrets.rs semantics;
     the reveal flags gate the exposed outputs).
  4. Nullifier = Poseidon(seed, photo packed 31 bytes/element, zero-padded
     to the static max_photo) — the vk must be shape-static, so the
     in-circuit nullifier pads with zeros (the reference's native nullifier
     hashes byte-per-element with dynamic length, lib.rs:890-912; both are
     provided natively and cross-checked in tests).
  5. IST -> UTC timestamp conversion (timestamp.rs math - 19800 s, the
     extractors/timstamp_extractor.rs:158 intent).
  6. signal_hash squared in-circuit (signal.rs front-running guard).

Public instance column (qr_data_extractor.rs:19-28 order):
  [nullifier_seed, signal_hash, pubkey_hash, nullifier, timestamp,
   age_above_18, gender, pincode, state_packed]
where gender/pincode/state are multiplied by their reveal flags and
age_above_18 = reveal_age * (age > 18).
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..fields.bn254 import R
from ..gadgets.biguint import BigUintChip
from ..gadgets.flexgate import Const, FlexGateConfig, GateChip, Witness
from ..gadgets.poseidon import PoseidonChip, PoseidonConfig
from ..gadgets.qr_extractor import ExtractorChip, ExtractorConfig
from ..gadgets.range import RangeChip, RangeStrategyConfig
from ..gadgets.rsa import RSAChip, RSAPublicKey, RSASignature
from ..gadgets.sha256 import Sha256Chip, Sha256Config
from ..ops.poseidon import hash_elements
from ..plonk.circuit import Circuit, ConstraintSystem
from .timestamp import DAYS_TILL_PREV_MONTH

BITS_LEN = 2048
LIMB_BITS = 64
DEFAULT_E = 65537
IST_OFFSET = 19800


@dataclass
class AadhaarParams:
    signed_len: int = 700          # bytes covered by the signature (lib.rs:860)
    # Dynamic-length SHA-256 (the reference's Sha256DynamicConfig semantics,
    # anon-aadhaar-halo2/src/lib.rs:308-315): ONE vk serves any signed length
    # <= max_signed_len — the actual length is a witness, bound to the
    # signature by the in-circuit FIPS padding.  704 keeps the same 12
    # compression blocks as the static 700-byte path; set None to bake the
    # length into the vk (legacy static mode).
    max_signed_len: int | None = 704
    max_photo: int = 960           # static photo capacity (31-byte packing)
    max_state: int = 16
    num_advice: int = 80
    num_lookup_advice: int = 16
    lookup_bits: int = 12
    sha_lanes: int = 32


@dataclass
class AadhaarWitness:
    qr_data: bytes
    n: int
    sig: int
    nullifier_seed: int
    signal_hash: int
    reveal_age: bool = True
    reveal_gender: bool = True
    reveal_pincode: bool = True
    reveal_state: bool = True
    # dynamic mode: bytes of qr_data the signature covers (defaults to
    # params.signed_len); must be <= params.max_signed_len
    signed_len: int | None = None


def packed_photo_elements(photo: bytes, max_photo: int) -> list[int]:
    """Photo bytes zero-padded to max_photo, packed 31 LE bytes/element."""
    padded = photo + b"\x00" * (max_photo - len(photo))
    return [int.from_bytes(padded[i:i + 31], "little")
            for i in range(0, max_photo, 31)]


def native_outputs(w: AadhaarWitness, p: AadhaarParams) -> dict:
    """Host-side recomputation of every public output (the golden model;
    mirrors the reference's native extraction, lib.rs:745-850)."""
    data = w.qr_data
    delims = [i for i, b in enumerate(data) if b == 255][:18]

    def digits(lo, cnt):
        return int(bytes(data[lo:lo + cnt]).decode())

    d2, d4, d5, d11, d13, d14, d18 = (delims[i] for i in
                                      (1, 3, 4, 10, 12, 13, 17))
    year = digits(d2 + 5, 4)
    month = digits(d2 + 9, 2)
    day = digits(d2 + 11, 2)
    hour = digits(d2 + 13, 2)
    bday = digits(d4 + 1, 2)
    bmonth = digits(d4 + 4, 2)
    byear = digits(d4 + 7, 4)
    age = year - byear - 1
    if bmonth > month or (bmonth == month and bday > day):
        age += 1
    gender = data[d5 + 1]
    pincode = digits(d11 + 1, 6)
    state = data[d13 + 1:d14]
    photo = data[d18 + 1:]
    leaps = (year - 1969) // 4 - (year - 1901) // 100 + (year - 1601) // 400
    days = (year - 1970) * 365 + leaps + DAYS_TILL_PREV_MONTH[month - 1] + day - 1
    timestamp = days * 86400 + hour * 3600 - IST_OFFSET
    nullifier = hash_elements(
        [w.nullifier_seed] + packed_photo_elements(photo, p.max_photo))
    n_limbs = [(w.n >> (64 * i)) & ((1 << 64) - 1) for i in range(32)]
    pubkey_hash = hash_elements(n_limbs)
    state_packed = int.from_bytes(
        state + b"\x00" * (p.max_state - len(state)), "little")
    return {
        "age": age, "above18": 1 if age > 18 else 0,
        "gender": gender, "pincode": pincode, "state_packed": state_packed,
        "timestamp": timestamp, "nullifier": nullifier,
        "pubkey_hash": pubkey_hash, "photo": photo,
    }


class AadhaarQRVerifierCircuit(Circuit):
    def __init__(self, w: AadhaarWitness, params: AadhaarParams | None = None):
        self.w = w
        self.p = params or AadhaarParams()
        self.stats = None

    def configure(self, cs: ConstraintSystem):
        p = self.p
        gcfg = FlexGateConfig.configure(cs, p.num_advice)
        rcfg = RangeStrategyConfig.configure(
            cs, gcfg, p.lookup_bits, p.num_lookup_advice)
        scfg = Sha256Config.configure(cs, p.sha_lanes)
        ecfg = ExtractorConfig.configure(cs)
        pcfg = PoseidonConfig.configure(cs)
        inst = cs.instance_column()
        cs.enable_equality(inst)
        return {"gate": gcfg, "range": rcfg, "sha": scfg, "ext": ecfg,
                "poseidon": pcfg, "instance": inst}

    # -- helpers --------------------------------------------------------------
    def _masked_suffix(self, gate, rng, ext, start_pos1, length_cell,
                       max_len):
        """Bytes at positions start_pos1+j for j < length, zero elsewhere.
        Validity flags are witnessed booleans constrained monotone
        non-increasing with sum == length (cheaper than per-j comparisons)."""
        length = length_cell.value
        flags = []
        prev = None
        for j in range(max_len):
            v = 1 if j < length else 0
            c = gate.load_witness(v)
            gate.assert_bit(c)
            if prev is not None:
                # monotone: flag[j] == 1 requires flag[j-1] == 1
                notp = gate.not_(prev)
                gate.assign_region(
                    [Const(0), notp, c, Const(0)], [0])
            flags.append(c)
            prev = c
        total = gate.sum(flags)
        gate.assert_equal(total, length_cell)
        out = []
        one = gate.load_constant(1)
        for j, f in enumerate(flags):
            pos1 = gate.add(start_pos1, gate.load_constant(j))
            pos1_eff = gate.select(pos1, one, f)
            b = ext.access(pos1_eff)
            out.append(gate.mul(b, f))
        return out

    def synthesize(self, config, asn) -> None:
        w, p = self.w, self.p
        data = w.qr_data
        data_len = len(data)
        gate = GateChip(config["gate"], asn)
        rng = RangeChip(config["range"], gate, asn)
        rng.load_table()
        sha = Sha256Chip(config["sha"], gate, asn)
        ext = ExtractorChip(config["ext"], gate, asn)
        pos = PoseidonChip(config["poseidon"], gate, asn)
        big = BigUintChip(gate, rng, LIMB_BITS)
        rsa = RSAChip(big, BITS_LEN, 17)

        # 0. witness all QR bytes, 8-bit checked
        byte_cells = []
        for b in data:
            c = gate.load_witness(b)
            rng.range_check(c, 8)
            byte_cells.append(c)

        # 1. RSA-SHA256 over the signed prefix.  Dynamic mode (default):
        # the signed length is a WITNESS — the buffer's message prefix is
        # bound to the QR byte cells under the s-indicator, and the FIPS
        # length field (hence the signature) pins the exact length.
        if p.max_signed_len is not None:
            from ..gadgets.sha256 import pad_dynamic
            slen = w.signed_len if w.signed_len is not None else p.signed_len
            assert slen <= p.max_signed_len and slen <= data_len
            buf = pad_dynamic(bytes(data[:slen]), p.max_signed_len)
            data_cells = []
            for b in buf:
                c = gate.load_witness(b)
                rng.range_check(c, 8)
                data_cells.append(c)
            mlen_cell = gate.load_witness(slen)
            digest = sha.digest_dynamic(data_cells, mlen_cell,
                                        p.max_signed_len,
                                        bind_cells=byte_cells)
        else:
            digest = sha.digest(byte_cells[:p.signed_len],
                                bytes(data[:p.signed_len]))
        rev = digest[::-1]
        words = [gate.inner_product(rev[8 * i:8 * i + 8],
                                    [Const(1 << (8 * j)) for j in range(8)])
                 for i in range(4)]
        pk = rsa.assign_public_key(RSAPublicKey(w.n, DEFAULT_E))
        sg = rsa.assign_signature(RSASignature(w.sig))
        ok = rsa.verify_pkcs1v15_signature(pk, words, sg)
        gate.assert_is_const(ok, 1)

        # 2. extraction
        ext.load_data(byte_cells)
        d2 = ext.delimiter_pos1(2)
        year = ext.packed_digits(d2, [5, 6, 7, 8], rng)
        month = ext.packed_digits(d2, [9, 10], rng)
        day = ext.packed_digits(d2, [11, 12], rng)
        hour = ext.packed_digits(d2, [13, 14], rng)
        d4 = ext.delimiter_pos1(4)
        bday = ext.packed_digits(d4, [1, 2], rng)
        bmonth = ext.packed_digits(d4, [4, 5], rng)
        byear = ext.packed_digits(d4, [7, 8, 9, 10], rng)
        d5 = ext.delimiter_pos1(5)
        gender = ext.access_offset(d5, 1)
        d11 = ext.delimiter_pos1(11)
        pincode = ext.packed_digits(d11, [1, 2, 3, 4, 5, 6], rng)
        d13 = ext.delimiter_pos1(13)
        d14 = ext.delimiter_pos1(14)
        d18 = ext.delimiter_pos1(18)

        # state bytes (masked to its delimiter span), packed LE
        state_len = gate.sub(gate.sub(d14, d13), gate.load_constant(1))
        state_bytes = self._masked_suffix(
            gate, rng, ext, gate.add(d13, gate.load_constant(1)),
            state_len, p.max_state)
        state_packed = gate.inner_product(
            state_bytes, [Const(pow(256, j, R)) for j in range(p.max_state)])

        # 3. age + reveal gating (conditional_secrets.rs semantics)
        age_by_year = gate.sub(gate.sub(year, byear), gate.load_constant(1))
        gt_m = rng.is_less_than(month, bmonth, 7)
        eq_m = gate.is_equal(bmonth, month)
        gt_d = rng.is_less_than(day, bday, 7)
        inc = gate.add(gt_m, gate.mul(eq_m, gt_d))
        age = gate.add(age_by_year, inc)
        above18 = rng.is_less_than(gate.load_constant(18), age, 8)

        r_age = gate.load_witness(1 if w.reveal_age else 0)
        r_gender = gate.load_witness(1 if w.reveal_gender else 0)
        r_pin = gate.load_witness(1 if w.reveal_pincode else 0)
        r_state = gate.load_witness(1 if w.reveal_state else 0)
        for r in (r_age, r_gender, r_pin, r_state):
            gate.assert_bit(r)
        out_above18 = gate.mul(r_age, above18)
        out_gender = gate.mul(r_gender, gender)
        out_pin = gate.mul(r_pin, pincode)
        out_state = gate.mul(r_state, state_packed)

        # 4. nullifier over the photo suffix
        photo_len = gate.sub(gate.load_constant(data_len + 1), gate.add(
            d18, gate.load_constant(1)))
        photo_bytes = self._masked_suffix(
            gate, rng, ext, gate.add(d18, gate.load_constant(1)),
            photo_len, p.max_photo)
        packed = []
        for i in range(0, p.max_photo, 31):
            chunk = photo_bytes[i:i + 31]
            packed.append(gate.inner_product(
                chunk, [Const(1 << (8 * j)) for j in range(len(chunk))]))
        seed = gate.load_witness(w.nullifier_seed)
        nullifier = pos.hash([seed] + packed)

        # pubkey binding
        pubkey_hash = pos.hash(list(pk.n.limbs))

        # 5. timestamp (IST -> UTC)
        def div_const(x, dv, q_bits, r_bits):
            qv, rv = divmod(x.value, dv)
            q = gate.load_witness(qv)
            r = gate.load_witness(rv)
            rng.range_check(q, q_bits)
            rng.range_check(r, r_bits)
            rec = gate.mul_add(q, gate.load_constant(dv), r)
            gate.assert_equal(rec, x)
            # r < dv
            rng.check_less_than(r, gate.load_constant(dv), r_bits + 1)
            return q

        y69 = gate.sub(year, gate.load_constant(1969))
        y01 = gate.sub(year, gate.load_constant(1901))
        y01b = gate.sub(year, gate.load_constant(1601))
        l4 = div_const(y69, 4, 10, 2)
        l100 = div_const(y01, 100, 8, 7)
        l400 = div_const(y01b, 400, 8, 9)
        leaps = gate.sub(gate.add(l4, l400), l100)
        month_m1 = gate.sub(month, gate.load_constant(1))
        ind = gate.idx_to_indicator(month_m1, 12)
        mdays = gate.inner_product(
            ind, [Const(v) for v in DAYS_TILL_PREV_MONTH])
        y70 = gate.sub(year, gate.load_constant(1970))
        days = gate.inner_product(
            [y70, leaps, mdays, day, gate.load_constant(1)],
            [Const(365), Const(1), Const(1), Const(1), Const(R - 1)])
        timestamp = gate.inner_product(
            [days, hour, gate.load_constant(1)],
            [Const(86400), Const(3600), Const(R - IST_OFFSET)])

        # 6. signal binding
        signal = gate.load_witness(w.signal_hash)
        gate.mul(signal, signal)

        # public outputs
        outs = [seed, signal, pubkey_hash, nullifier, timestamp,
                out_above18, out_gender, out_pin, out_state]
        for i, cell in enumerate(outs):
            asn.copy((cell.col, cell.row), (config["instance"], i))

        self.stats = {**rng.finalize(), **sha.occupancy(), **pos.occupancy()}

    def layout_tag(self) -> str:
        """Layout determinants beyond the constraint system (keygen cache
        safety): params, QR byte count, and — static SHA mode only — the
        baked signed length."""
        p = self.p
        slen = "dyn" if p.max_signed_len is not None else p.signed_len
        return (f"aadhaar,{p.max_signed_len},{p.max_photo},{p.max_state},"
                f"{p.num_advice},{p.num_lookup_advice},{p.lookup_bits},"
                f"{p.sha_lanes},{len(self.w.qr_data)},{slen}")

    def instances(self):
        w, p = self.w, self.p
        o = native_outputs(w, p)
        return [[
            w.nullifier_seed, w.signal_hash, o["pubkey_hash"], o["nullifier"],
            o["timestamp"],
            o["above18"] if w.reveal_age else 0,
            o["gender"] if w.reveal_gender else 0,
            o["pincode"] if w.reveal_pincode else 0,
            o["state_packed"] if w.reveal_state else 0,
        ]]
