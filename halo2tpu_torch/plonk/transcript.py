"""Keccak256 Fiat-Shamir transcript, byte-exact to the on-chain verifier.

The contract's transcript (contract.sol:89-112):
  - absorb: write 32-byte big-endian words (scalars mod r; EC points as x,y
    in Fq) into a running buffer whose first word is the previous keccak state
    (initially the vk digest is the first absorbed word).
  - squeeze: challenge = keccak256(state_word || absorbed...) mod r; the raw
    hash becomes the first word of the next buffer.
  - squeeze_cont (no new absorptions): keccak256(prev_hash || 0x01) mod r.
"""
from __future__ import annotations

from ..fields.bn254 import R, to_bytes_be
from ..ops.keccak import keccak256
from ..utils import trace


class KeccakTranscript:
    def __init__(self):
        self.buf = bytearray()
        self._absorbed = 0  # absorptions since last squeeze

    def common_scalar(self, v: int) -> None:
        self.buf += to_bytes_be(v % R)
        self._absorbed += 1

    def common_point(self, p) -> None:
        """p: affine (x, y) over Fq, or None (identity) encoded as (0, 0).

        The EVM contract rejects (0,0) via its on-curve check
        (contract.sol:77-87); identity only arises for degenerate
        constraint-free circuits (e.g. the reference's timestamp circuit,
        whose gates are all commented out), which the contract was never
        generated for.  Our generic verifier accepts it there."""
        x, y = p if p is not None else (0, 0)
        self.buf += to_bytes_be(x)
        self.buf += to_bytes_be(y)
        self._absorbed += 1

    def squeeze_challenge(self) -> int:
        """Squeeze a challenge.  If nothing was absorbed since the previous
        squeeze this is automatically the contract's squeeze_challenge_cont
        (append 0x01; contract.sol:106-112)."""
        rec = trace.current()
        with rec.span("transcript.squeeze"):
            if self._absorbed == 0:
                self.buf.append(1)
            rec.count("keccak_bytes", len(self.buf))
            h = keccak256(self.buf)
            self.buf = bytearray(h)
            self._absorbed = 0
            return int.from_bytes(h, "big") % R


class ProofWriter(KeccakTranscript):
    """Prover transcript: absorbs AND serializes proof bytes."""

    def __init__(self):
        super().__init__()
        self.proof = bytearray()

    def write_point(self, p) -> None:
        self.common_point(p)
        x, y = p if p is not None else (0, 0)
        self.proof += to_bytes_be(x)
        self.proof += to_bytes_be(y)

    def write_scalar(self, v: int) -> None:
        self.common_scalar(v)
        self.proof += to_bytes_be(v % R)


class ProofReader(KeccakTranscript):
    """Verifier transcript: reads proof bytes while absorbing."""

    def __init__(self, proof: bytes):
        super().__init__()
        self.proof = proof
        self.off = 0

    def read_point(self):
        x = int.from_bytes(self.proof[self.off:self.off + 32], "big")
        y = int.from_bytes(self.proof[self.off + 32:self.off + 64], "big")
        self.off += 64
        p = None if (x, y) == (0, 0) else (x, y)
        self.common_point(p)
        return p

    def read_scalar(self) -> int:
        v = int.from_bytes(self.proof[self.off:self.off + 32], "big")
        self.off += 32
        self.common_scalar(v)
        return v
