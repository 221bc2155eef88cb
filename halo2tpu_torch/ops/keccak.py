"""Keccak-256 (the pre-NIST-padding variant used by Ethereum).

Used by the Fiat-Shamir transcript (plonk/transcript.py), which must match the
on-chain verifier's `keccak256` squeezes byte-for-byte
(anon-aadhaar-halo2/solidity_verifier_contract/contract.sol:89-112), by
keygen's digests and by the EVM interpreter's keccak256 opcode.

Keccak-f[1600] with rate 1088 / capacity 512 and 0x01 domain padding
(Ethereum keccak256, NOT sha3-256's 0x06 padding).  `keccak256` runs the
permutation in C (csrc/host_keccak.c, in the host library that
_build.host_lib() builds); `keccak256_plain` is the same hash in pure Python,
kept as the reference the tests hold the C code to.
"""
from __future__ import annotations

import ctypes

from .. import _build

_ROUND_CONSTANTS = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

_ROTATIONS = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]

_MASK = (1 << 64) - 1


def _rotl(x: int, n: int) -> int:
    return ((x << n) | (x >> (64 - n))) & _MASK


def _keccak_f(state: list[int]) -> None:
    """In-place Keccak-f[1600] permutation on 25 lanes (state[x + 5*y])."""
    for rc in _ROUND_CONSTANTS:
        # theta
        c = [state[x] ^ state[x + 5] ^ state[x + 10] ^ state[x + 15] ^ state[x + 20]
             for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                state[x + 5 * y] ^= d[x]
        # rho + pi
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rotl(state[x + 5 * y], _ROTATIONS[x][y])
        # chi
        for x in range(5):
            for y in range(5):
                state[x + 5 * y] = b[x + 5 * y] ^ ((~b[(x + 1) % 5 + 5 * y]) & b[(x + 2) % 5 + 5 * y] & _MASK)
        # iota
        state[0] ^= rc


def keccak256_plain(data: bytes) -> bytes:
    rate = 136  # bytes (1088 bits)
    state = [0] * 25
    # absorb
    padded = bytearray(data)
    pad_len = rate - (len(padded) % rate)
    padded += b"\x00" * pad_len
    padded[len(data)] |= 0x01
    padded[-1] |= 0x80
    for off in range(0, len(padded), rate):
        block = padded[off:off + rate]
        for i in range(rate // 8):
            state[i] ^= int.from_bytes(block[8 * i:8 * i + 8], "little")
        _keccak_f(state)
    # squeeze (one block is enough for 32 bytes)
    out = b"".join(state[i].to_bytes(8, "little") for i in range(4))
    return out


def keccak256(data: bytes | bytearray) -> bytes:
    """keccak256 in C (csrc/host_keccak.c), reading data in place."""
    if isinstance(data, bytearray):
        data = (ctypes.c_char * len(data)).from_buffer(data)
    out = ctypes.create_string_buffer(32)
    _build.host_lib().keccak256(data, len(data), out)
    return out.raw
