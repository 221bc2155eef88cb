"""BigUint gadget chip (SURVEY L4/N11) — TPU-first re-design of the
reference's `BigUintConfig`/`BigUintInstructions`
(anon-aadhaar-halo2/src/big_uint/chip.rs, .../instructions.rs:9-233).

Semantics preserved (they define soundness):
  * Fresh integers: little-endian limbs, each range-checked < 2^limb_bits.
  * Muled integers: limb-convolution products whose limbs may overflow up to
    ~2*limb_bits + log2(n) bits; compared via the EqualWhenCarried carry
    chain (chip.rs:513-610, after circom-bigint) and re-normalized by
    `refresh` (chip.rs:87-145).
  * mul_mod proves r = a*b mod n by witnessing (q, r) natively and
    constraining a*b == q*n + r limb-wise (chip.rs:355-413).

TPU-first departures:
  * witness values are plain python ints carried alongside cells (no
    Value<BigUint> plumbing); witness generation is host-side and cheap —
    the prover kernels are the hot path;
  * addition carries are constrained boolean (they are provably 0/1 since
    fresh limbs < 2^w), instead of the reference's full limb-width range
    check on each carry (chip.rs:215) — strictly tighter and cheaper;
  * the limb convolution in `mul` is emitted as one inner_product region
    per output limb, a dense static layout the vectorized prover consumes.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..fields.bn254 import R
from .flexgate import AssignedValue, Const, GateChip, Witness
from .range import RangeChip


@dataclass
class AssignedBigUint:
    """Little-endian limbed integer. `muled=False` ⇒ every limb has been
    range-checked < 2^limb_bits ("Fresh"); `muled=True` ⇒ limbs may
    overflow ("Muled", product of fresh integers)."""
    limbs: list
    value: int
    muled: bool = False

    @property
    def num_limbs(self) -> int:
        return len(self.limbs)


class RefreshAux:
    """Carry-growth table for refreshing a product of (num_limbs_l ×
    num_limbs_r)-limb integers (reference semantics: big_uint/mod.rs:97-168).

    increased_limbs_vec[i] = how many extra limbs the i-th overflowed limb
    spills into when fully carried, computed on the all-max-limb worst case.
    """

    def __init__(self, limb_bits: int, num_limbs_l: int, num_limbs_r: int):
        self.limb_bits = limb_bits
        self.num_limbs_l = num_limbs_l
        self.num_limbs_r = num_limbs_r
        w = limb_bits
        max_limb = (1 << w) - 1
        d = num_limbs_l + num_limbs_r - 1
        lmax = [max_limb] * num_limbs_l + [0] * (d - num_limbs_l)
        rmax = [max_limb] * num_limbs_r + [0] * (d - num_limbs_r)
        muled = [sum(lmax[j] * rmax[i - j] for j in range(i + 1))
                 for i in range(d)]
        inc = []
        cur = 0
        while cur <= d:
            if cur >= len(muled):
                muled.append(0)
            v = muled[cur]
            nbits = v.bit_length()
            nchunks = max(1, (nbits + w - 1) // w)
            inc.append(nchunks - 1)
            for j in range(nchunks):
                if len(muled) <= cur + j:
                    muled.append(0)
                muled[cur + j] += (v >> (j * w)) & max_limb
            muled[cur] -= v
            cur += 1
        self.increased_limbs_vec = inc


class BigUintChip:
    """Bound to (gate chip, range chip) for one synthesize pass."""

    def __init__(self, gate: GateChip, rng: RangeChip, limb_bits: int):
        self.gate = gate
        self.rng = rng
        self.limb_bits = limb_bits

    # -- helpers --------------------------------------------------------------
    def _div_mod_unsafe(self, a: AssignedValue, m: int):
        """(q, r) with a == q*m + r enforced by one gate; ranges NOT checked
        (caller's responsibility) — chip.rs:761-791."""
        # The witness int may represent a negative field value in the
        # EqualWhenCarried chain; it never does here because callers offset
        # by muled_limb_max first.
        q_v, r_v = divmod(a.value, m)
        cells = self.gate.assign_region(
            [Witness(r_v), Witness(q_v), Const(m % R), a], [0])
        return cells[1], cells[0]

    def _limbs_of(self, v: int, num_limbs: int) -> list[int]:
        w = self.limb_bits
        return [(v >> (i * w)) & ((1 << w) - 1) for i in range(num_limbs)]

    def _extend(self, a: AssignedBigUint, n: int) -> AssignedBigUint:
        if a.num_limbs >= n:
            return a
        zero = self.gate.load_zero()
        return AssignedBigUint(
            a.limbs + [zero] * (n - a.num_limbs), a.value, a.muled)

    # -- assignment -----------------------------------------------------------
    def assign_integer(self, value: int, bit_len: int) -> AssignedBigUint:
        """Witness limbs, each range-checked to limb_bits (chip.rs:40-64)."""
        w = self.limb_bits
        assert bit_len % w == 0
        num_limbs = bit_len // w
        assert 0 <= value < (1 << bit_len)
        limbs = []
        for lv in self._limbs_of(value, num_limbs):
            c = self.gate.load_witness(lv)
            self.rng.range_check(c, w)
            limbs.append(c)
        return AssignedBigUint(limbs, value)

    def assign_constant(self, value: int,
                        num_limbs: int | None = None) -> AssignedBigUint:
        w = self.limb_bits
        if num_limbs is None:
            num_limbs = max(1, (value.bit_length() + w - 1) // w)
        limbs = [self.gate.load_constant(lv)
                 for lv in self._limbs_of(value, num_limbs)]
        return AssignedBigUint(limbs, value)

    def max_value(self, num_limbs: int) -> AssignedBigUint:
        return self.assign_constant(
            (1 << (self.limb_bits * num_limbs)) - 1, num_limbs)

    # -- structure ------------------------------------------------------------
    def refresh(self, a: AssignedBigUint, aux: RefreshAux) -> AssignedBigUint:
        """Muled -> Fresh carry decomposition (chip.rs:87-145)."""
        assert a.muled and aux.limb_bits == self.limb_bits
        assert a.num_limbs == aux.num_limbs_l + aux.num_limbs_r - 1
        inc = aux.increased_limbs_vec
        nfresh = len(inc)
        zero = self.gate.load_zero()
        out = list(a.limbs) + [zero] * (nfresh - a.num_limbs)
        limb_max = 1 << self.limb_bits
        for i in range(nfresh):
            limb = out[i]
            for j in range(inc[i] + 1):
                q, r = self._div_mod_unsafe(limb, limb_max)
                if j == 0:
                    out[i] = r
                else:
                    out[i + j] = self.gate.add(out[i + j], r)
                limb = q
            self.gate.assert_is_const(limb, 0)
        for c in out:
            self.rng.range_check(c, self.limb_bits)
        return AssignedBigUint(out, a.value)

    def select(self, a: AssignedBigUint, b: AssignedBigUint,
               sel: AssignedValue) -> AssignedBigUint:
        assert a.num_limbs == b.num_limbs
        limbs = [self.gate.select(x, y, sel) for x, y in zip(a.limbs, b.limbs)]
        return AssignedBigUint(
            limbs, a.value if sel.value == 1 else b.value,
            a.muled or b.muled)

    # -- add / sub ------------------------------------------------------------
    def add(self, a: AssignedBigUint, b: AssignedBigUint) -> AssignedBigUint:
        """Carry-chain addition; output has max(n1,n2)+1 limbs
        (chip.rs:172-235)."""
        w = self.limb_bits
        n = max(a.num_limbs, b.num_limbs)
        a, b = self._extend(a, n), self._extend(b, n)
        out = []
        carry = self.gate.load_zero()
        for i in range(n):
            s = self.gate.add(self.gate.add(a.limbs[i], b.limbs[i]), carry)
            sv = s.value
            c_v, carry_v = sv & ((1 << w) - 1), sv >> w
            c = self.gate.load_witness(c_v)
            self.rng.range_check(c, w)
            nc = self.gate.load_witness(carry_v)
            self.gate.assert_bit(nc)
            rec = self.gate.mul_add(nc, self.gate.load_constant(1 << w), c)
            self.gate.assert_equal(rec, s)
            out.append(c)
            carry = nc
        out.append(carry)
        return AssignedBigUint(out, a.value + b.value)

    def sub_unsafe(self, a: AssignedBigUint, b: AssignedBigUint):
        """Borrow-chain subtraction. Returns (diff, is_overflow); diff is
        correct iff a >= b (chip.rs:249-274)."""
        w = self.limb_bits
        n = max(a.num_limbs, b.num_limbs)
        a, b = self._extend(a, n), self._extend(b, n)
        av, bv = a.value, b.value
        out = []
        borrow = self.gate.load_zero()
        bor_v = 0
        base = self.gate.load_constant(1 << w)
        for i in range(n):
            ai, bi = a.limbs[i].value, b.limbs[i].value
            d_v = ai - bi - bor_v
            nb_v = 1 if d_v < 0 else 0
            d_v += nb_v << w
            d = self.gate.load_witness(d_v)
            self.rng.range_check(d, w)
            nb = self.gate.load_witness(nb_v)
            self.gate.assert_bit(nb)
            # d + b_i + borrow == a_i + nb * 2^w
            lhs = self.gate.add(self.gate.add(d, b.limbs[i]), borrow)
            rhs = self.gate.mul_add(nb, base, a.limbs[i])
            self.gate.assert_equal(lhs, rhs)
            out.append(d)
            borrow, bor_v = nb, nb_v
        value = av - bv if av >= bv else (av - bv) % (1 << (w * n))
        return AssignedBigUint(out, value), borrow

    # -- multiplication -------------------------------------------------------
    def mul(self, a: AssignedBigUint, b: AssignedBigUint) -> AssignedBigUint:
        """Truncated limb convolution, no carries -> Muled
        (chip.rs:276-293; halo2-ecc mul_no_carry)."""
        assert not a.muled and not b.muled
        n1, n2 = a.num_limbs, b.num_limbs
        d = n1 + n2 - 1
        a_e, b_e = self._extend(a, d), self._extend(b, d)
        out = []
        for k in range(d):
            xs = [a_e.limbs[j] for j in range(k + 1)]
            ys = [b_e.limbs[k - j] for j in range(k + 1)]
            out.append(self.gate.inner_product(xs, ys))
        return AssignedBigUint(out, a.value * b.value, muled=True)

    def square(self, a: AssignedBigUint) -> AssignedBigUint:
        return self.mul(a, a)

    # -- modular arithmetic ---------------------------------------------------
    def add_mod(self, a: AssignedBigUint, b: AssignedBigUint,
                n: AssignedBigUint) -> AssignedBigUint:
        """(a + b) mod n via conditional subtraction (chip.rs:304-319).
        Requires a, b < n."""
        added = self.add(a, b)
        subed, is_over = self.sub_unsafe(added, n)
        res = self.select(added, subed, is_over)
        return AssignedBigUint(res.limbs[:-1], res.value % n.value)

    def sub_mod(self, a: AssignedBigUint, b: AssignedBigUint,
                n: AssignedBigUint) -> AssignedBigUint:
        """(a - b) mod n (chip.rs:322-341). Requires a, b < n."""
        subed1, over1 = self.sub_unsafe(a, b)
        added = self.add(a, n)
        subed2, over2 = self.sub_unsafe(added, b)
        self.gate.assert_is_const(over2, 0)
        n_l = max(subed1.num_limbs, subed2.num_limbs)
        res = self.select(self._extend(subed2, n_l),
                          self._extend(subed1, n_l), over1)
        return AssignedBigUint(res.limbs[:-1], (a.value - b.value) % n.value)

    def mul_mod(self, a: AssignedBigUint, b: AssignedBigUint,
                n: AssignedBigUint) -> AssignedBigUint:
        """r = a*b mod n with witnessed quotient: constrain
        a*b == q*n + r limb-wise over Muled limbs (chip.rs:355-413).
        Requires a, b < n."""
        w = self.limb_bits
        n1, n2 = a.num_limbs, b.num_limbs
        assert n1 == n.num_limbs
        full = a.value * b.value
        q_big, r_big = divmod(full, n.value)
        q = self.assign_integer(q_big, n2 * w)
        r = self.assign_integer(r_big, n1 * w)
        ab = self.mul(a, b)
        qn = self.mul(q, n)
        d = n1 + n2 - 1
        limbs = []
        for i in range(d):
            if i < n1:
                limbs.append(self.gate.add(qn.limbs[i], r.limbs[i]))
            else:
                limbs.append(qn.limbs[i])
        qn_r = AssignedBigUint(limbs, qn.value + r_big, muled=True)
        eq = self.is_equal_muled(ab, qn_r, n1, n2)
        self.gate.assert_is_const(eq, 1)
        return r

    def square_mod(self, a: AssignedBigUint,
                   n: AssignedBigUint) -> AssignedBigUint:
        return self.mul_mod(a, a, n)

    def pow_mod(self, a: AssignedBigUint, e: AssignedValue,
                n: AssignedBigUint, exp_bits: int) -> AssignedBigUint:
        """Variable-exponent square-and-multiply with per-bit select
        (chip.rs:426-451)."""
        e_bits = self.gate.num_to_bits(e, exp_bits)
        num_limbs = a.num_limbs
        assert num_limbs == n.num_limbs
        acc = self._extend(self.assign_constant(1), num_limbs)
        sq = a
        for bit in e_bits:
            muled = self.mul_mod(acc, sq, n)
            acc = self.select(muled, acc, bit)
            sq = self.square_mod(sq, n)
        return acc

    def pow_mod_fixed_exp(self, a: AssignedBigUint, e: int,
                          n: AssignedBigUint) -> AssignedBigUint:
        """Fixed-exponent square-and-multiply — only multiplies on set bits
        (chip.rs:454-490); e=65537 ⇒ 17 square_mod + 1 mul_mod."""
        num_limbs = a.num_limbs
        assert num_limbs == n.num_limbs
        acc = self._extend(self.assign_constant(1), num_limbs)
        sq = a
        for i in range(e.bit_length()):
            cur = sq
            sq = self.square_mod(cur, n)
            if (e >> i) & 1:
                acc = self.mul_mod(acc, cur, n)
        return acc

    # -- comparisons ----------------------------------------------------------
    def is_zero(self, a: AssignedBigUint) -> AssignedValue:
        """Limb-sum is-zero (sound: sum < n*2^w << R) (chip.rs:493-500)."""
        return self.gate.is_zero(self.gate.sum(a.limbs))

    def is_equal_fresh(self, a: AssignedBigUint,
                       b: AssignedBigUint) -> AssignedValue:
        assert a.num_limbs == b.num_limbs
        eq = self.gate.load_constant(1)
        for x, y in zip(a.limbs, b.limbs):
            eq = self.gate.and_(eq, self.gate.is_equal(x, y))
        return eq

    def muled_limb_max(self, min_n: int) -> int:
        m = (1 << self.limb_bits) - 1
        return min_n * m * m + m

    def is_equal_muled(self, a: AssignedBigUint, b: AssignedBigUint,
                       num_limbs_l: int, num_limbs_r: int) -> AssignedValue:
        """EqualWhenCarried over overflowed limbs (chip.rs:513-610):
        propagate carries of (a_i - b_i + limb_max_offset), tracking the
        accumulated offset; equal iff every low window matches and the final
        carry equals the leftover accumulated offset."""
        w = self.limb_bits
        min_n = min(num_limbs_l, num_limbs_r)
        offset = self.muled_limb_max(min_n)
        carry_bits = (2 * offset).bit_length() - w
        d = num_limbs_l + num_limbs_r - 1
        limb_max = 1 << w
        gate = self.gate
        carry = gate.load_zero()
        acc_extra = gate.load_zero()
        eq = gate.load_constant(1)
        for i in range(d):
            diff = gate.sub(a.limbs[i], b.limbs[i])
            s = gate.sum([diff, carry, gate.load_constant(offset)])
            new_carry, c = self._div_mod_unsafe(s, limb_max)
            acc_extra = gate.add(acc_extra, gate.load_constant(offset))
            q_acc, mod_acc = self._div_mod_unsafe(acc_extra, limb_max)
            eq = gate.and_(eq, gate.is_equal(c, mod_acc))
            acc_extra = q_acc
            if i < d - 1:
                self.rng.range_check(new_carry, carry_bits)
            else:
                eq = gate.and_(eq, gate.is_equal(new_carry, acc_extra))
            carry = new_carry
        return eq

    def is_less_than(self, a: AssignedBigUint,
                     b: AssignedBigUint) -> AssignedValue:
        _, over = self.sub_unsafe(a, b)
        return over

    def is_less_than_or_equal(self, a, b) -> AssignedValue:
        lt = self.is_less_than(a, b)
        eq = self.is_equal_fresh(self._extend(a, b.num_limbs),
                                 self._extend(b, a.num_limbs))
        return self.gate.or_(lt, eq)

    def is_greater_than(self, a, b) -> AssignedValue:
        return self.gate.not_(self.is_less_than_or_equal(a, b))

    def is_greater_than_or_equal(self, a, b) -> AssignedValue:
        return self.gate.not_(self.is_less_than(a, b))

    def is_in_field(self, a: AssignedBigUint,
                    n: AssignedBigUint) -> AssignedValue:
        return self.is_less_than(a, n)

    # -- assertions -----------------------------------------------------------
    def assert_equal_fresh(self, a, b) -> None:
        self.gate.assert_is_const(self.is_equal_fresh(a, b), 1)

    def assert_equal_muled(self, a, b, n1, n2) -> None:
        self.gate.assert_is_const(self.is_equal_muled(a, b, n1, n2), 1)

    def assert_in_field(self, a, n) -> None:
        self.gate.assert_is_const(self.is_in_field(a, n), 1)
