"""SHA-256 circuit gadget (SURVEY N12) — replaces the reference's zkemail
`Sha256DynamicConfig` dependency (anon-aadhaar-halo2/src/lib.rs:308-315,221).

NOT a port of zkemail's table16-style chip: instead of spread/lookup
compression we use four tiny custom row-gates, replicated across `num_lanes`
lanes of 4 advice columns each:

    q_xor3:  u3 = u0 (+) u1 (+) u2          (bitwise xor, degree-3 poly)
    q_ch:    u3 = u2 + u0*(u1 - u2)         (choose)
    q_maj:   u3 = u0*u1 + u2*(u0 + u1) - 2*u0*u1*u2
    q_dec:   u3 = 2*u3[-1] + u0,  u0 boolean   (MSB-first bit accumulator)
    q_dec0:  u3 = u0,             u0 boolean   (first row of a run)

A 32-bit word is bound to its bits by one q_dec run (one row per bit, the
final accumulator copy-constrained to the word cell); sigma/ch/maj terms are
one row per bit; word-level sums and the mod-2^32 carry split live in the
flex-gate region.  Everything else (schedule, 64 rounds, Merkle-Damgard
chaining) is standard FIPS 180-4.

The reference circuit digests fixed-size test messages (700/1024 bytes,
lib.rs:310); here the padded message length is likewise a static circuit
parameter (dynamic in-circuit length selection is a planned extension).
"""
from __future__ import annotations

from ..fields.bn254 import R
from ..plonk.circuit import Assignment, Column, ConstraintSystem
from .flexgate import AssignedValue, Const, FlexGateConfig, GateChip, Witness
from .placement import LeastFilled, pow2_consts, report
from .sha_words import CH, MAJ, XOR, WordLanes, rotr

H0 = [0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
      0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19]

K256 = [
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2,
]


def pad_message(msg: bytes) -> bytes:
    """FIPS 180-4 padding."""
    bitlen = len(msg) * 8
    out = msg + b"\x80"
    out += b"\x00" * ((56 - len(out) % 64) % 64)
    return out + bitlen.to_bytes(8, "big")


def dynamic_buffer_blocks(max_len: int) -> int:
    """Number of 64-byte blocks in a dynamic digest buffer that can hold any
    padded message of up to max_len bytes."""
    return (max_len + 9 + 63) // 64


def pad_dynamic(msg: bytes, max_len: int) -> bytes:
    """FIPS padding zero-extended to the full dynamic buffer (witness gen)."""
    nb = dynamic_buffer_blocks(max_len)
    padded = pad_message(msg)
    assert len(padded) <= nb * 64, "message exceeds dynamic buffer"
    return padded + b"\x00" * (nb * 64 - len(padded))


class Sha256Config:
    def __init__(self, cs: ConstraintSystem, num_lanes: int):
        self.num_lanes = num_lanes
        self.lanes = []
        for _ in range(num_lanes):
            u = [cs.advice_column() for _ in range(4)]
            for c in u:
                cs.enable_equality(c)
            q_xor = cs.fixed_column()
            q_ch = cs.fixed_column()
            q_maj = cs.fixed_column()
            q_dec = cs.fixed_column()
            q_dec0 = cs.fixed_column()
            u0, u1, u2, u3 = (cs.query_advice(c, 0) for c in u)
            u3p = cs.query_advice(u[3], -1)
            qx = cs.query_fixed(q_xor, 0)
            qc = cs.query_fixed(q_ch, 0)
            qm = cs.query_fixed(q_maj, 0)
            qd = cs.query_fixed(q_dec, 0)
            qd0 = cs.query_fixed(q_dec0, 0)
            xor3 = (u0 + u1 + u2
                    - (u0 * u1 + u1 * u2 + u2 * u0) * 2
                    + u0 * u1 * u2 * 4)
            cs.create_gate(f"sha_xor3_{u[0].index}", qx * (xor3 - u3))
            cs.create_gate(f"sha_ch_{u[0].index}",
                           qc * (u2 + u0 * (u1 - u2) - u3))
            maj = u0 * u1 + u2 * (u0 + u1) - u0 * u1 * u2 * 2
            cs.create_gate(f"sha_maj_{u[0].index}", qm * (maj - u3))
            cs.create_gate(f"sha_dec_{u[0].index}", [
                qd * (u3p * 2 + u0 - u3),
                (qd + qd0) * (u0 * u0 - u0),
            ])
            cs.create_gate(f"sha_dec0_{u[0].index}", qd0 * (u0 - u3))
            self.lanes.append({
                "u": u, "q_xor": q_xor, "q_ch": q_ch, "q_maj": q_maj,
                "q_dec": q_dec, "q_dec0": q_dec0,
            })

    @classmethod
    def configure(cls, cs: ConstraintSystem, num_lanes: int = 8):
        return cls(cs, num_lanes)


class _Word:
    """A 32-bit word cell plus (optionally) its bit cells, LSB-first."""
    __slots__ = ("cell", "bits")

    def __init__(self, cell: AssignedValue, bits=None):
        self.cell = cell
        self.bits = bits

    @property
    def value(self):
        return self.cell.value


class Sha256Chip:
    def __init__(self, cfg: Sha256Config, gate: GateChip, asn: Assignment):
        self.cfg = cfg
        self.gate = gate
        self.asn = asn
        self.cols = LeastFilled(cfg.num_lanes)
        self._fill = self.cols.fill
        self.rows_used = 0
        self._zero = None
        # direct array/handle caches: the bitop/decompose runs are the
        # synthesis hot loop (~100k rows x 8 Assignment method calls each);
        # every sha lane column has enable_equality (Sha256Config), so
        # appending copies directly is statically safe (cf. flexgate's
        # assign_region fast path)
        self._lane_arrs = [
            {"u": [asn.advice[c.index] for c in lane["u"]],
             "q_xor": asn.fixed[lane["q_xor"].index],
             "q_ch": asn.fixed[lane["q_ch"].index],
             "q_maj": asn.fixed[lane["q_maj"].index],
             "q_dec": asn.fixed[lane["q_dec"].index],
             "q_dec0": asn.fixed[lane["q_dec0"].index]}
            for lane in cfg.lanes]
        self._copies = asn.copies
        self._rec = asn.recording
        # the hash path's word-level emitter (gadgets/sha_words.py)
        self._words = WordLanes(self)

    # -- custom-region emitters ----------------------------------------------
    def _lane_rows(self, n: int):
        li, start = self.cols.least()
        assert start + n <= self.asn.usable, "sha lanes exhausted"
        self.cols.take(n)
        self.rows_used += n
        return li, start

    _BITFNS = {"q_xor": lambda x, y, z: x ^ y ^ z,
               "q_ch": lambda x, y, z: z ^ (x & (y ^ z)),
               "q_maj": lambda x, y, z: (x & y) | (z & (x | y))}

    def _bitop_run(self, qname: str, triples):
        """One row per (x, y, z) input triple; returns output cells."""
        li, start = self._lane_rows(len(triples))
        lane = self.cfg.lanes[li]
        arrs = self._lane_arrs[li]
        u0a, u1a, u2a, u3a = arrs["u"]
        qa = arrs[qname]
        u0c, u1c, u2c, u3c = lane["u"]
        fn = self._BITFNS[qname]
        append = self._copies.append
        rec = self._rec
        out = []
        row = start
        for x, y, z in triples:
            ov = fn(x.value, y.value, z.value)
            u0a[row] = x.value
            u1a[row] = y.value
            u2a[row] = z.value
            u3a[row] = ov
            qa[row] = 1
            if rec:
                append(((x.col, x.row), (u0c, row)))
                append(((y.col, y.row), (u1c, row)))
                append(((z.col, z.row), (u2c, row)))
            out.append(AssignedValue(u3c, row, ov))
            row += 1
        return out

    def xor3_bits(self, xs, ys, zs):
        return self._bitop_run("q_xor", list(zip(xs, ys, zs)))

    def ch_bits(self, es, fs, gs):
        return self._bitop_run("q_ch", list(zip(es, fs, gs)))

    def maj_bits(self, as_, bs, cs):
        return self._bitop_run("q_maj", list(zip(as_, bs, cs)))

    def decompose(self, cell: AssignedValue, nbits: int):
        """Bind `cell` (< 2^nbits) to its bits via a q_dec accumulator run.
        Returns (low_word, bits_lsb_of_low32, carry_cell_or_None):
        for nbits > 32, low_word = cell - carry*2^32 is returned as a fresh
        flex-gate cell with its 32 bits; carry = top (nbits-32) bits."""
        v = cell.value
        assert v < (1 << nbits)
        li, start = self._lane_rows(nbits)
        lane = self.cfg.lanes[li]
        arrs = self._lane_arrs[li]
        u = lane["u"]
        u0a, u3a = arrs["u"][0], arrs["u"][3]
        qda, qd0a = arrs["q_dec"], arrs["q_dec0"]
        bit_cells = []
        acc = 0
        carry_cell = None
        for i in range(nbits):
            row = start + i
            bit = (v >> (nbits - 1 - i)) & 1
            acc = acc * 2 + bit
            u0a[row] = bit
            u3a[row] = acc
            (qd0a if i == 0 else qda)[row] = 1
            bit_cells.append(AssignedValue(u[0], row, bit))
            if nbits > 32 and i == nbits - 32 - 1:
                carry_cell = AssignedValue(u[3], row, acc)
        last = AssignedValue(u[3], start + nbits - 1, acc)
        self._copies.append(((cell.col, cell.row), (last.col, last.row)))
        bits_lsb = bit_cells[::-1]
        if nbits <= 32:
            return _Word(cell, bits_lsb[:32]), None
        low_v = v & 0xFFFFFFFF
        low = self.gate.assign_region(
            [Witness(low_v), carry_cell, Const(1 << 32), cell], [0])[0]
        return _Word(low, bits_lsb[:32]), carry_cell

    # -- helpers --------------------------------------------------------------
    def _zero_cell(self):
        if self._zero is None:
            self._zero = self.gate.load_zero()
        return self._zero

    def _rotr(self, bits, r):
        """bits is LSB-first; ROTR^r(w) bit i = w bit (i+r) mod 32."""
        return [bits[(i + r) % 32] for i in range(32)]

    def _shr(self, bits, s):
        z = self._zero_cell()
        return [bits[i + s] if i + s < 32 else z for i in range(32)]

    def _pack_sum(self, bit_groups, extra_cells):
        """sum_g sum_i 2^i * g[i]  +  sum extra_cells, one inner product."""
        vals, coeffs = [], []
        pow2 = pow2_consts()
        for g in bit_groups:
            vals.extend(g)
            coeffs.extend(pow2[:len(g)])
        for c in extra_cells:
            vals.append(c)
            coeffs.append(Const(1))
        return self.gate.inner_product(vals, coeffs)

    # -- compression ----------------------------------------------------------
    def _load_state_words(self, words):
        """words: list of 8 cells; decompose each to get bits."""
        return [_Word(*self._words.decompose(c, 32)) for c in words]

    def compress_block(self, state, w_words):
        """state: 8 _Word (with bits); w_words: 16 _Word message words.
        Returns new state as 8 _Word (with bits).  The bits are
        sha_words.Bits (a word's value and place): the runs and regions
        are the per-cell code's, emitted by word."""
        g = self.gate
        ws = self._words    # the per-cell runs and regions, by word
        w = list(w_words)
        for t in range(16, 64):
            x, y = w[t - 15].bits, w[t - 2].bits
            s0b = ws.bitop(XOR, rotr(x, 7), rotr(x, 18), ws.shr(x, 3))
            s1b = ws.bitop(XOR, rotr(y, 17), rotr(y, 19), ws.shr(y, 10))
            total = ws.pack([s0b, s1b], [w[t - 7].cell, w[t - 16].cell])
            w.append(_Word(*ws.decompose(total, 34)))

        a, b, c, d, e, f, gg, h = state
        for t in range(64):
            eb, ab = e.bits, a.bits
            sig1 = ws.bitop(XOR, rotr(eb, 6), rotr(eb, 11), rotr(eb, 25))
            ch = ws.bitop(CH, rotr(eb), rotr(f.bits), rotr(gg.bits))
            sig0 = ws.bitop(XOR, rotr(ab, 2), rotr(ab, 13), rotr(ab, 22))
            mj = ws.bitop(MAJ, rotr(ab), rotr(b.bits), rotr(c.bits))
            t1 = ws.pack([sig1, ch],
                         [h.cell, w[t].cell, g.load_constant(K256[t])])
            t2 = ws.pack([sig0, mj], [])
            new_e = _Word(*ws.decompose(g.add(d.cell, t1), 35))
            new_a = _Word(*ws.decompose(g.add(t1, t2), 35))
            a, b, c, d, e, f, gg, h = new_a, a, b, c, new_e, e, f, gg
        return [_Word(*ws.decompose(g.add(s.cell, v.cell), 33))
                for s, v in zip(state, (a, b, c, d, e, f, gg, h))]

    # -- public API -----------------------------------------------------------
    def digest(self, msg_cells: list, msg: bytes):
        """msg_cells: byte cells for `msg` (values must match; byte range
        checks are the caller's concern — byte cells packed into words here
        are bound by the q_dec bit runs).  Pads in-circuit with constant
        cells.  Returns 32 digest byte cells (big-endian order)."""
        padded = pad_message(msg)
        g = self.gate
        pad_cells = [g.load_constant(bv) for bv in padded[len(msg):]]
        cells = list(msg_cells) + pad_cells
        assert len(cells) == len(padded) and len(padded) % 64 == 0

        # pack bytes into 16 words per block: word = b0<<24|b1<<16|b2<<8|b3
        state = self._load_state_words(
            [g.load_constant(h) for h in H0])
        for blk in range(len(padded) // 64):
            w_words = []
            for i in range(16):
                bs = cells[blk * 64 + i * 4: blk * 64 + i * 4 + 4]
                word_cell = g.inner_product(
                    bs, [Const(1 << 24), Const(1 << 16), Const(1 << 8),
                         Const(1)])
                w_words.append(_Word(*self._words.decompose(word_cell, 32)))
            state = self.compress_block(state, w_words)

        # digest bytes: each state word -> 4 big-endian byte cells, bound by
        # an 8-bit-per-byte split of the word bits (bits are already boolean
        # -> bytes are implied sums; emit as inner products of bit cells).
        out = []
        for word in state:
            out.extend(self._words.byte_cells(word.bits))
        self._words.flush()
        return out

    def digest_dynamic(self, data_cells: list, mlen_cell, max_len: int,
                       bind_cells: list | None = None):
        """ONE vk serves any message length <= max_len — realizes the
        reference's `Sha256DynamicConfig` capability
        (anon-aadhaar-halo2/src/lib.rs:308-315): the constraint structure
        depends only on max_len, the actual length is a witness.

        data_cells: byte cells for the FULL B-block buffer
        (B = dynamic_buffer_blocks(max_len); values from pad_dynamic).
        mlen_cell: cell holding the true message byte length.
        The caller must range-check every data cell to 8 bits (as with
        `digest`, byte range checks are the caller's concern).

        In-circuit padding verification:
          - s_i = indicator(i < mlen): boolean, monotone non-increasing,
            sum_i s_i = mlen (binds the vector to mlen_cell)
          - data[mlen] = 0x80:   (s_{i-1} - s_i) * (data_i - 0x80) = 0
          - all other pad bytes zero: data_i * (1 - s_{i-1} - l_i) = 0
            (s_i + t_i = s_{i-1}; l_i marks the final block's length field)
          - fb one-hot over blocks with  mlen + 8 - 64*F in [0, 64)
            (F = selected block index), so fb = final block of the padding
          - big-endian length field of the final block packs to 8*mlen
          - digest = one-hot select of the per-block chained states

        bind_cells: optional external byte cells (e.g. the QR payload a
        composite circuit also extracts from); adds s_i * (data_i - bind_i)
        = 0 for each provided cell, so the dynamic buffer's message prefix
        is copy-equivalent to the caller's bytes WITHOUT static wiring that
        would bake the length into the vk.

        Returns 32 digest byte cells (big-endian order).
        """
        g = self.gate
        nb = dynamic_buffer_blocks(max_len)
        total = nb * 64
        assert len(data_cells) == total, "need the full dynamic buffer"
        mlen = mlen_cell.value
        assert mlen + 9 <= total

        # s indicators
        s_cells = []
        for i in range(total):
            s = g.load_witness(1 if i < mlen else 0)
            g.assert_bit(s)
            s_cells.append(s)
        for i in range(total - 1):
            g.assert_bit(g.sub(s_cells[i], s_cells[i + 1]))
        g.assert_equal(g.sum(s_cells), mlen_cell)

        if bind_cells is not None:
            assert len(bind_cells) >= mlen, "bind_cells shorter than message"
            for i, bc in enumerate(bind_cells[:total]):
                diff = g.sub(data_cells[i], bc)
                g.assert_is_const(g.mul(s_cells[i], diff), 0)
            if len(bind_cells) < total:
                # message must fit inside the bound bytes: s is monotone
                # non-increasing, so one zero pins mlen <= len(bind_cells)
                g.assert_is_const(s_cells[len(bind_cells)], 0)

        # final-block one-hot + index
        final_blk = (mlen + 8) // 64
        fb_cells = []
        for b in range(nb):
            f = g.load_witness(1 if b == final_blk else 0)
            g.assert_bit(f)
            fb_cells.append(f)
        g.assert_is_const(g.sum(fb_cells), 1)
        f_idx = g.linear_combination(fb_cells, list(range(nb)))
        # d = mlen + 8 - 64*F in [0, 64)
        d = g.linear_combination(
            [mlen_cell, f_idx, g.load_constant(1)], [1, R - 64, 8])
        g.num_to_bits(d, 6)

        # length-field flags l_i (positions 56..63 of the final block)
        one = g.load_constant(1)
        for i in range(total):
            s_prev = s_cells[i - 1] if i > 0 else one
            t_i = g.sub(s_prev, s_cells[i])
            # data[mlen] = 0x80
            diff80 = g.sub(data_cells[i], g.load_constant(0x80))
            g.assert_is_const(g.mul(t_i, diff80), 0)
            # zero padding: data_i * (1 - s_{i-1} - l_i) = 0
            blk, pos = divmod(i, 64)
            if pos >= 56:
                coeff = g.sub(g.sub(one, s_prev), fb_cells[blk])
            else:
                coeff = g.sub(one, s_prev)
            g.assert_is_const(g.mul(data_cells[i], coeff), 0)

        # length field packs to 8*mlen in the selected block
        len_packed = []
        for b in range(nb):
            len_packed.append(g.inner_product(
                data_cells[b * 64 + 56: b * 64 + 64],
                [Const(1 << (8 * (7 - j))) for j in range(8)]))
        sel_len = g.select_by_indicator(len_packed, fb_cells)
        g.assert_equal(sel_len, g.linear_combination([mlen_cell], [8]))

        # compress every block; snapshot state after each
        state = self._load_state_words([g.load_constant(h) for h in H0])
        block_states = []
        for blk in range(nb):
            w_words = []
            for i in range(16):
                bs = data_cells[blk * 64 + i * 4: blk * 64 + i * 4 + 4]
                word_cell = g.inner_product(
                    bs, [Const(1 << 24), Const(1 << 16), Const(1 << 8),
                         Const(1)])
                w_words.append(_Word(*self._words.decompose(word_cell, 32)))
            state = self.compress_block(state, w_words)
            block_states.append(state)

        # one-hot select the digest state, then re-bind bits for byte output
        out = []
        for j in range(8):
            sel = g.select_by_indicator(
                [st[j].cell for st in block_states], fb_cells)
            _, bits = self._words.decompose(sel, 32)
            out.extend(self._words.byte_cells(bits))
        self._words.flush()
        return out

    def occupancy(self) -> dict:
        """Rows and lane fills; adds the regions the lanes and the gate
        columns placed to the traced proof's `placements`, and the lane
        rows the word-level emitter wrote to its `sha_bulk_rows`."""
        report(self.gate.cols, self.cols)
        self._words.report()
        return {"sha_rows": self.rows_used, "lane_fill": list(self._fill)}
