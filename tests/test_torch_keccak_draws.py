"""The prover's host byte loops in C: keccak256 (csrc/host_keccak.c) against
the pure-Python keccak256_plain and halo2tpu's keccak256, the transcript's
squeezes against the hashing they did before, and the random polynomial's
bulk draw (prover._rng_field_limbs16 through jfield.reduce_be256) against n
calls of _rng_field: the same values, the generator left in the same
state, the same tensor and the same bytes to the device."""
import random

import numpy as np
import pytest
import torch

from halo2tpu.ops.keccak import keccak256 as jax_keccak
from halo2tpu_torch.fields import jfield
from halo2tpu_torch.fields.bn254 import Q, R
from halo2tpu_torch.ops.keccak import keccak256, keccak256_plain
from halo2tpu_torch.plonk.engine import TorchEngine
from halo2tpu_torch.plonk.prover import _rng_field, _rng_field_limbs16
from halo2tpu_torch.plonk.srs import setup
from halo2tpu_torch.plonk.transcript import ProofWriter
from halo2tpu_torch.utils import trace

torch.set_num_threads(1)

EMPTY = "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470"
SEED = 2**33 + 19       # above 32 bits, as the benchmark's seeds are


# -- keccak256 ---------------------------------------------------------------

def test_keccak_known_vector():
    assert keccak256(b"").hex() == EMPTY
    assert keccak256_plain(b"").hex() == EMPTY


@pytest.mark.parametrize("length", [0, 1, 135, 136, 137, 271, 272, 273,
                                    64 * 1024])
def test_keccak_matches_plain_and_halo2tpu(length):
    data = random.Random(SEED + length).randbytes(length)
    want = keccak256_plain(data)
    assert want == jax_keccak(data)
    assert keccak256(data) == want
    assert keccak256(bytearray(data)) == want


def test_keccak_reads_a_bytearray_in_place():
    buf = bytearray(random.Random(SEED).randbytes(300))
    before = bytes(buf)
    assert keccak256(buf) == keccak256_plain(before)
    assert buf == before
    buf += b"\x00"              # the buffer is free to resize again
    assert keccak256(buf) == keccak256_plain(before + b"\x00")


def test_transcript_squeezes_hash_what_they_did_before():
    """Absorb, squeeze, squeeze again with nothing absorbed (the
    contract's squeeze_challenge_cont), absorb a point: each challenge is
    keccak256_plain of the previous hash and the words absorbed since, the
    keccak_bytes counter their length."""
    rng = random.Random(SEED)
    t = ProofWriter()
    state, hashed = b"", 0
    with trace.proof(trace.Tracer(), lambda: None) as rec:
        for step in range(6):
            words = b""
            if step != 2:
                for _ in range(step + 1):
                    v = rng.randrange(R)
                    t.write_scalar(v)
                    words += v.to_bytes(32, "big")
                p = (rng.randrange(Q), rng.randrange(Q))
                t.write_point(p)
                words += p[0].to_bytes(32, "big") + p[1].to_bytes(32, "big")
            data = state + (words if words else b"\x01")
            h = keccak256_plain(data)
            assert t.squeeze_challenge() == int.from_bytes(h, "big") % R
            state, hashed = h, hashed + len(data)
    assert rec.counters["keccak_bytes"] == hashed


# -- the random polynomial's bulk draw ---------------------------------------

@pytest.mark.parametrize("n", [1, 16, 2**15])
def test_bulk_draw_matches_single_draws(n):
    single = np.random.default_rng(SEED + n)
    bulk = np.random.default_rng(SEED + n)
    want = [_rng_field(single) for _ in range(n)]
    got = _rng_field_limbs16(bulk, n)
    assert got.shape == (n, 16) and got.dtype == np.dtype("<u2")
    assert jfield.limbs_to_ints(got) == want
    assert _rng_field(bulk) == _rng_field(single)


@pytest.mark.parametrize("mod", [R, Q])
def test_reduce_be256_edges(mod):
    words = [0, 1, mod - 1, mod, mod + 1, 2 * mod, 5 * mod - 1, 5 * mod,
             (1 << 256) // mod * mod, 2**255, 2**256 - 1]
    rng = random.Random(SEED)
    words += [rng.getrandbits(256) for _ in range(64)]
    raw = b"".join(w.to_bytes(32, "big") for w in words)
    out = np.empty((len(words), 16), "<u2")
    jfield.reduce_be256(raw + b"\xff" * 7, mod, out)   # a tail is not read
    assert jfield.limbs_to_ints(out) == [w % mod for w in words]


def test_reduce_be256_checks_its_arguments():
    raw = bytes(64)
    with pytest.raises(ValueError):
        jfield.reduce_be256(raw, R, np.empty((2, 8), "<u4"))
    with pytest.raises(ValueError):
        jfield.reduce_be256(raw, R, np.empty((3, 16), "<u2"))
    with pytest.raises(ValueError):
        jfield.reduce_be256(raw, 2**64 - 59, np.empty((2, 16), "<u2"))


def test_random_poly_tensor_and_traffic_unchanged():
    """The bulk draw through from_packed_stack gives the tensor, and the
    count of bytes sent to the device, that from_ints gave the draws."""
    from halo2tpu_torch.plonk.domain import make_domain
    eng = TorchEngine(make_domain(6, 3), setup(6, cache=False), "cpu")
    n = eng.d.n
    with trace.proof(trace.Tracer(), lambda: None) as old:
        rng = np.random.default_rng(SEED)
        want = eng.from_ints([_rng_field(rng) for _ in range(n)])
    with trace.proof(trace.Tracer(), lambda: None) as new:
        rng = np.random.default_rng(SEED)
        got = eng.from_packed_stack([_rng_field_limbs16(rng, n)])[0]
    assert torch.equal(got, want)
    assert new.counters["h2d_bytes"] == old.counters["h2d_bytes"] == 32 * n
