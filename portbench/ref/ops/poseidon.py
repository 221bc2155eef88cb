"""Native Poseidon sponge over BN254 Fr (SURVEY N13).

Reference counterpart: the PSE `poseidon` crate (rev 7ebccbf, pinned in
anon-aadhaar-halo2/Cargo.lock:818-820), used natively by the reference's
flagship test to compute the nullifier (anon-aadhaar-halo2/src/lib.rs:890-912):

    Poseidon::<Fr, 5, 4>::new(8, 57); update(seed ++ photo_bytes); squeeze()

Parameter generation follows the canonical Grain-LFSR procedure from the
Poseidon paper's `generate_parameters_grain.sage` (the same algorithm PSE
poseidon and halo2_gadgets implement):

  * 80-bit LFSR seeded with (field_tag=0b01, sbox_tag=0b0000, n, t, R_F,
    R_P, 30 ones); 160 warm-up clocks discarded; output bits pass a
    pairwise rejection filter (emit b2 iff b1 == 1).
  * (R_F + R_P) rows of t round constants, each sampled as n MSB-first
    bits with rejection resampling until < modulus.
  * MDS = Cauchy matrix 1/(x_i + y_j) with x, y sampled WITHOUT rejection
    (n bits reduced mod p), regenerated until all 2t values are distinct.

The permutation here is the *specification* form (ARK -> S-box -> MDS each
round; partial rounds S-box lane 0 only).  PSE's runtime uses the
algebraically-equivalent "optimized" constant schedule; outputs are equal.

Sponge semantics (PSE `Poseidon::new/update/squeeze`):
  * initial state = [2^64, 0, ..., 0]  (capacity tag in lane 0)
  * absorb RATE elements per permutation by addition into lanes 1..=RATE
  * squeeze pads the pending chunk with a single 1 and returns state[1].
"""
from __future__ import annotations

from functools import lru_cache

from ..fields.bn254 import R

T = 5
RATE = 4
R_F = 8
R_P = 57
CAPACITY_TAG = 1 << 64


class GrainLFSR:
    """80-bit Grain LFSR bit stream used for Poseidon parameter derivation."""

    def __init__(self, n_bits: int, t: int, r_f: int, r_p: int):
        bits: list[int] = []

        def push(value: int, width: int) -> None:
            for i in range(width - 1, -1, -1):
                bits.append((value >> i) & 1)

        push(0b01, 2)       # field tag: prime field
        push(0b0000, 4)     # sbox tag: x^alpha
        push(n_bits, 12)    # field size in bits
        push(t, 12)         # state width
        push(r_f, 10)
        push(r_p, 10)
        bits.extend([1] * 30)
        assert len(bits) == 80
        self.state = bits
        for _ in range(160):
            self._clock()

    def _clock(self) -> int:
        s = self.state
        new = s[62] ^ s[51] ^ s[38] ^ s[23] ^ s[13] ^ s[0]
        s.pop(0)
        s.append(new)
        return new

    def next_bit(self) -> int:
        # Pairwise rejection: emit the second bit of a pair iff the first is 1.
        while True:
            b1 = self._clock()
            b2 = self._clock()
            if b1:
                return b2

    def next_int(self, n_bits: int) -> int:
        v = 0
        for _ in range(n_bits):
            v = (v << 1) | self.next_bit()
        return v

    def next_field_element(self, modulus: int, n_bits: int) -> int:
        while True:
            v = self.next_int(n_bits)
            if v < modulus:
                return v

    def next_field_element_without_rejection(self, modulus: int,
                                             n_bits: int) -> int:
        return self.next_int(n_bits) % modulus


@lru_cache(maxsize=None)
def generate_parameters(t: int = T, r_f: int = R_F, r_p: int = R_P,
                        modulus: int = R, n_bits: int = 254):
    """(round_constants, mds): r_f+r_p rows of t constants; t x t Cauchy MDS."""
    grain = GrainLFSR(n_bits, t, r_f, r_p)
    rcs = tuple(
        tuple(grain.next_field_element(modulus, n_bits) for _ in range(t))
        for _ in range(r_f + r_p))
    while True:
        xs = [grain.next_field_element_without_rejection(modulus, n_bits)
              for _ in range(t)]
        ys = [grain.next_field_element_without_rejection(modulus, n_bits)
              for _ in range(t)]
        if len(set(xs + ys)) == 2 * t:
            break
    mds = tuple(tuple(pow(xs[i] + ys[j], modulus - 2, modulus)
                      for j in range(t)) for i in range(t))
    return rcs, mds


def _sbox(v: int, modulus: int) -> int:
    v2 = v * v % modulus
    return v2 * v2 % modulus * v % modulus


def permute(state: list[int], t: int = T, r_f: int = R_F, r_p: int = R_P,
            modulus: int = R) -> list[int]:
    """Specification-form Poseidon permutation (ARK -> S-box -> MDS)."""
    rcs, mds = generate_parameters(t, r_f, r_p, modulus)
    half = r_f // 2
    s = [v % modulus for v in state]
    for rnd in range(r_f + r_p):
        x = [(s[i] + rcs[rnd][i]) % modulus for i in range(t)]
        if half <= rnd < half + r_p:
            x[0] = _sbox(x[0], modulus)
        else:
            x = [_sbox(v, modulus) for v in x]
        s = [sum(mds[j][i] * x[i] for i in range(t)) % modulus
             for j in range(t)]
    return s


class Poseidon:
    """PSE-style sponge: new() -> update(elements) -> squeeze()."""

    def __init__(self, t: int = T, rate: int = RATE, r_f: int = R_F,
                 r_p: int = R_P, modulus: int = R):
        self.t, self.rate, self.r_f, self.r_p = t, rate, r_f, r_p
        self.modulus = modulus
        self.state = [CAPACITY_TAG % modulus] + [0] * (t - 1)
        self.absorbing: list[int] = []

    def _perm_with_input(self, chunk: list[int]) -> None:
        assert len(chunk) <= self.rate
        for i, el in enumerate(chunk):
            self.state[1 + i] = (self.state[1 + i] + el) % self.modulus
        self.state = permute(self.state, self.t, self.r_f, self.r_p,
                             self.modulus)

    def update(self, elements) -> None:
        pending = self.absorbing + [e % self.modulus for e in elements]
        while len(pending) >= self.rate:
            self._perm_with_input(pending[:self.rate])
            pending = pending[self.rate:]
        self.absorbing = pending

    def squeeze(self) -> int:
        self._perm_with_input(self.absorbing + [1])
        self.absorbing = []
        return self.state[1]


def hash_elements(elements, t: int = T, rate: int = RATE, r_f: int = R_F,
                  r_p: int = R_P, modulus: int = R) -> int:
    """One-shot sponge hash (the reference's native nullifier recipe)."""
    sponge = Poseidon(t, rate, r_f, r_p, modulus)
    sponge.update(list(elements))
    return sponge.squeeze()


def nullifier(nullifier_seed: int, photo_bytes: bytes,
              modulus: int = R) -> int:
    """Byte-per-element nullifier exactly as anon-aadhaar-halo2/src/lib.rs:895-912:
    Poseidon::<Fr,5,4>::new(8,57); update([seed] ++ [Fr::from(b) for b in photo]).
    """
    return hash_elements([nullifier_seed] + list(photo_bytes),
                         modulus=modulus)
