"""The traffic generator: deterministic per seed, the same sizes for every
seed, and requests that the frozen reference accepts."""
from __future__ import annotations

import hashlib

import numpy as np
import pytest

from portbench import manifest, traffic
from portbench.families.common import SHA256_PREFIX
from portbench.ref.plonk.circuit import Assignment, ConstraintSystem

CELLS = [w["name"] for w in manifest.load()["workloads"]]
BIG_SEED = 2**33 + 12345


def _cell(name):
    c = manifest.cell(manifest.load(), name)
    return c["config"], c["mix"], manifest.family(c["config"]["family"])


def _small(mix, pool=6):
    return {**mix, "pool": pool, "warmup": 1}


@pytest.mark.parametrize("name", CELLS)
def test_same_seed_same_requests(name):
    cfg, mix, fam = _cell(name)
    a = traffic.run_requests(_small(mix), cfg, fam, BIG_SEED)
    b = traffic.run_requests(_small(mix), cfg, fam, BIG_SEED)
    c = traffic.run_requests(_small(mix), cfg, fam, BIG_SEED + 1)
    assert a == b
    assert a[1] != c[1]


@pytest.mark.parametrize("name", CELLS)
def test_every_seed_sends_the_same_sizes(name):
    cfg, mix, fam = _cell(name)
    for key, (lo, hi) in mix["stratified"].items():
        sizes = [traffic.stratified(lo, hi, mix["pool"],
                                    traffic.rng_for(mix["name"], s, key))
                 for s in (1, BIG_SEED)]
        assert sorted(sizes[0]) == sorted(sizes[1])
        assert min(sizes[0]) == lo and max(sizes[0]) == hi


def _pkcs1_ok(n, e, sig, msg):
    em = pow(sig, e, n).to_bytes((n.bit_length() + 7) // 8, "big")
    t = SHA256_PREFIX + hashlib.sha256(msg).digest()
    return em == b"\x00\x01" + b"\xff" * (len(em) - len(t) - 3) + b"\x00" + t


@pytest.mark.parametrize("name", CELLS)
def test_requests_are_valid_under_the_reference(name):
    cfg, mix, fam = _cell(name)
    ref = manifest.ref_family(cfg["family"])
    warm, pool = traffic.run_requests(_small(mix), cfg, fam, BIG_SEED)
    e = 65537
    for r in warm + pool:
        # the program's own instances are the reference's
        assert fam.program_circuit(cfg, r).instances() == ref.instances(
            cfg, r)
        if cfg["family"] == "aadhaar_qr":
            qr = r["qr"]
            assert len(qr) == cfg["qr_bytes"]
            delims = [i for i, b in enumerate(qr) if b == 255]
            assert len(r["truth"]["photo"]) == len(qr) - delims[17] - 1
            assert len(r["truth"]["photo"]) <= cfg["params"]["max_photo"]
            assert 255 not in qr[:delims[17]].replace(b"\xff", b"")
            assert r["signed_len"] <= cfg["params"]["max_signed_len"]
            assert 10 <= r["truth"]["year"] - r["truth"]["byear"] <= 80
            assert _pkcs1_ok(r["n"], e, r["sig"], qr[:r["signed_len"]])
        else:
            assert len(r["msg"]) <= cfg["params"]["max_msg_len"]
            assert _pkcs1_ok(r["n"], e, r["sig"], r["msg"])


@pytest.mark.parametrize("name", CELLS)
def test_one_key_serves_every_request(name):
    """Two requests of different sizes lay the circuit out alike: the same
    fixed columns and copies (what the proving key is made of)."""
    cfg, mix, fam = _cell(name)
    ref = manifest.ref_family(cfg["family"])
    _, pool = traffic.run_requests(_small(mix, 2), cfg, fam, BIG_SEED)
    layouts = []
    for r in pool:
        c = fam.circuit(cfg, r, ref.classes)
        cs = ConstraintSystem()
        config = c.configure(cs)
        asn = Assignment(cs, 1 << cfg["k"])
        c.synthesize(config, asn)
        layouts.append((np.stack(asn.fixed), asn.copies))
    assert np.array_equal(layouts[0][0], layouts[1][0])
    assert layouts[0][1] == layouts[1][1]
