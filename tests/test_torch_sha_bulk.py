"""The SHA-256 chip's word-level witness (gadgets/sha_words.py) against
halo2tpu's per-cell chip, synthesis only, at k = 15: digest_dynamic over a
1024-byte buffer at message lengths from empty to full, and digest over
one static message.  Each case holds the port to halo2tpu's advice (as
keygen records it and as a proof synthesizes it), fixed columns, copies
in order and lane fills, the digest bytes to hashlib's, and a traced
proof-time synthesis's `sha_bulk_rows` to the chip's SHA lane rows: the
word-level emitter wrote every run."""
import functools
import hashlib

import pytest

from halo2tpu.gadgets import flexgate as jax_flexgate
from halo2tpu.gadgets import sha256 as jax_sha256
from halo2tpu.plonk import circuit as jax_circuit
from halo2tpu_torch.gadgets import flexgate, sha256
from halo2tpu_torch.plonk import circuit
from halo2tpu_torch.utils import trace

K = 15
MAX_LEN = 1024
GATE_COLUMNS, LANES = 32, 16
CASES = [("dynamic", n) for n in (0, 55, 56, 64, 119, 700, 1024)]
CASES.append(("static", 150))
CHECKS = ["advice", "proof_advice", "fixed", "copies", "lane_fill",
          "digest", "sha_bulk_rows"]


def _message(n: int) -> bytes:
    return bytes((i * 151 + 7 * (i >> 8)) % 256 for i in range(n))


def _synthesize(pkg, case, recording: bool):
    """(Assignment, Sha256Chip, digest byte values) of one package's
    chips over the case's message."""
    fg, sh, circ = pkg
    kind, n = case
    msg = _message(n)
    cs = circ.ConstraintSystem()
    gcfg = fg.FlexGateConfig.configure(cs, GATE_COLUMNS)
    scfg = sh.Sha256Config.configure(cs, LANES)
    asn = circ.Assignment(cs, 1 << K, recording=recording)
    gate = fg.GateChip(gcfg, asn)
    sha = sh.Sha256Chip(scfg, gate, asn)
    if kind == "dynamic":
        cells = [gate.load_witness(b)
                 for b in sh.pad_dynamic(msg, MAX_LEN)]
        out = sha.digest_dynamic(cells, gate.load_witness(n), MAX_LEN)
    else:
        out = sha.digest([gate.load_witness(b) for b in msg], msg)
    return asn, sha, [c.value for c in out]


def _copies(asn):
    return [tuple((c.kind, c.index, row) for c, row in pair)
            for pair in asn.copies]


@functools.lru_cache(maxsize=1)
def _results(case):
    """check -> (halo2tpu's, the port's) for one case."""
    jasn, jsha, jdigest = _synthesize(
        (jax_flexgate, jax_sha256, jax_circuit), case, True)
    pkg = (flexgate, sha256, circuit)
    asn, sha, digest = _synthesize(pkg, case, True)
    with trace.proof(trace.Tracer(), lambda: None) as rec:
        pasn, psha, pdigest = _synthesize(pkg, case, False)
        rows = psha.occupancy()["sha_rows"]
    want_advice = [col.tolist() for col in jasn.advice]
    return {
        "advice": (want_advice, [col.tolist() for col in asn.advice]),
        "proof_advice": (want_advice,
                         [col.tolist() for col in pasn.advice]),
        "fixed": ([col.tolist() for col in jasn.fixed],
                  [col.tolist() for col in asn.fixed]),
        "copies": (_copies(jasn), _copies(asn)),
        "lane_fill": ((jsha.occupancy(),) * 2,
                      (sha.occupancy(), psha.occupancy())),
        "digest": ((list(hashlib.sha256(_message(case[1])).digest()),) * 3,
                   (jdigest, digest, pdigest)),
        "sha_bulk_rows": (rows, rec.counters["sha_bulk_rows"]),
    }


@pytest.mark.parametrize("case,check", [
    (case, check) for case in CASES for check in CHECKS],
    ids=lambda v: "-".join(map(str, v)) if isinstance(v, tuple) else v)
def test_word_level_sha_matches_halo2tpu(case, check):
    want, got = _results(case)[check]
    assert got == want
    if check == "proof_advice":
        # Python ints, as synthesize.rows and the C packer read them
        assert all(type(v) is int for col in got for v in col)
    if check == "sha_bulk_rows":
        assert got > 0
