"""What the families share: the signer's key and PKCS#1 v1.5 signing."""
from __future__ import annotations

import hashlib
import json
import os

from ..manifest import ROOT

SHA256_PREFIX = bytes.fromhex("3031300d060960864801650304020105000420")


def load_signer(rel_path: str) -> dict:
    """{"n", "e", "d"} of the RSA key file (p, q, e) at rel_path."""
    with open(os.path.join(ROOT, rel_path)) as f:
        k = json.load(f)
    p, q, e = int(k["p"]), int(k["q"]), int(k["e"])
    return {"n": p * q, "e": e, "d": pow(e, -1, (p - 1) * (q - 1))}


def sign(key: dict, msg: bytes) -> int:
    """RSASSA-PKCS1-v1_5 with SHA-256 (RFC 8017 section 8.2.1)."""
    t = SHA256_PREFIX + hashlib.sha256(msg).digest()
    k = (key["n"].bit_length() + 7) // 8
    em = b"\x00\x01" + b"\xff" * (k - len(t) - 3) + b"\x00" + t
    return pow(int.from_bytes(em, "big"), key["d"], key["n"])
