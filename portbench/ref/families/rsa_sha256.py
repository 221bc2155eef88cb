"""RSA-SHA256's public instances: the modulus in 32 limbs of 64 bits
(least significant first), then the 32 bytes of sha256(msg)."""
from __future__ import annotations

import hashlib

from ..circuits import rsa_sha256 as classes


def instances(config, request) -> list[list[int]]:
    n = request["n"]
    return [[(n >> (64 * i)) & ((1 << 64) - 1) for i in range(32)],
            list(hashlib.sha256(request["msg"]).digest())]
