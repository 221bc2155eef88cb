"""The prover's tracing (halo2tpu_torch/utils/trace.py) on the CPU: a
traced proof is byte-identical to an untraced one, its caller's tracer
sees the 11 phases and nothing else, its record's spans nest, its
counters count the encodes and the blocking reads, a failed proof leaves
no record active, and under torch.profiler each span is an annotation
inside its phase's."""
import json
import os
import tempfile
from collections import Counter, deque

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke
from halo2tpu_torch.circuits.signal import SquareCircuit
from halo2tpu_torch.fields import jfield
from halo2tpu_torch.plonk.engine import TorchEngine
from halo2tpu_torch.plonk.keygen import keygen
from halo2tpu_torch.plonk.prover import create_proof
from halo2tpu_torch.plonk.srs import setup
from halo2tpu_torch.utils import trace
from portbench.tracing import PhaseTracer

torch.set_num_threads(1)

PHASES = ["synthesize", "advice_ntt", "commit_advice", "lookups_permute",
          "commit_lookup_permuted", "grand_products", "commit_z",
          "quotient", "commit_h", "evals", "shplonk"]
SUB_SPANS = {"instances", "synthesize.circuit", "synthesize.rows",
             "advice_ntt.encode", "advice_ntt.intt", "z_intt", "random_poly",
             "h_fold", "transcript.squeeze", "shplonk.combine",
             "shplonk.evals", "shplonk.divide", "shplonk.commit"}


class HostCommitEngine(TorchEngine):
    """TorchEngine with each commitment made by the SRS's host MSM: the
    same points (so the same proof) without the CPU's slow plain fold."""

    def _commit(self, ctx, vecs, value_bits=None, blind_start=None):
        return [self.srs.commit_lagrange(self.to_ints(v)) for v in vecs]


class CallLog:
    """An outer tracer that logs every call it gets."""

    def __init__(self):
        self.calls = []

    def phase(self, name):
        self.calls.append(("phase", name))
        return trace.NULL.phase(name)

    def __getattr__(self, name):
        self.calls.append((name,))
        raise AttributeError(name)


def _circuit(name):
    if name == "square_k3":
        c = SquareCircuit(5)
        return c, 3, c.instances(), 9
    return chip_smoke.golden_circuits()[name]


@pytest.fixture(scope="module")
def keys():
    out = {}
    for name in ("square_k3", "range_k7"):
        c, k, inst, seed = _circuit(name)
        srs = setup(k, cache=False)
        pk, _ = keygen(c, k, srs, device="cpu")
        out[name] = (c, inst, seed, srs, pk)
    return out


def _prove(keys, name="square_k3", engine=HostCommitEngine, **kw):
    c, inst, seed, srs, pk = keys[name]
    eng = engine(pk.vk.domain, srs, "cpu")
    return create_proof(pk, srs, c, inst, rng_seed=seed, engine=eng, **kw)


def _count_io(mp, seen):
    """Patch the field encodings and decodings, the host packer and the
    lookup check to add to seen: bytes encoded, decodes, lookup checks
    that read a flag, values packed and those of them at or above 2^30
    (the packer's long path)."""
    fs = jfield.FieldSpec
    enc, packed, narrow, dec = (fs.encode, fs.encode_packed,
                                fs.encode_narrow_stack, fs.decode)
    check = TorchEngine.check_lookup_fails

    def encode(self, vals, device="cuda"):
        seen["bytes"] += 32 * len(vals)
        return enc(self, vals, device)

    def encode_packed(self, u16, device="cuda"):
        seen["bytes"] += np.asarray(u16).nbytes
        return packed(self, u16, device)

    def encode_narrow_stack(self, main, tail, split, device="cuda"):
        seen["bytes"] += 4 * np.asarray(main).size + np.asarray(tail).nbytes
        return narrow(self, main, tail, split, device)

    def decode(self, arr):
        seen["decodes"] += 1
        return dec(self, arr)

    def check_lookup_fails(fails):
        seen["checks"] += bool(fails)
        return check(fails)

    def counted(pack):
        def counted_pack(vals, out):
            seen["packed"] += len(out)
            seen["long"] += sum(int(v) >= 1 << 30 for v in vals[:len(out)])
            return pack(vals, out)
        return counted_pack

    for name, fn in (("encode", encode), ("encode_packed", encode_packed),
                     ("encode_narrow_stack", encode_narrow_stack),
                     ("decode", decode)):
        mp.setattr(fs, name, fn)
    for name in ("pack_limbs16", "pack_u16"):
        mp.setattr(jfield, name, counted(getattr(jfield, name)))
    mp.setattr(TorchEngine, "check_lookup_fails",
               staticmethod(check_lookup_fails))


@pytest.fixture(scope="module")
def traced(keys):
    """Two traced proofs with a logging outer tracer, their records and
    what the field encodings, decodings and lookup checks made."""
    seen = {"bytes": 0, "decodes": 0, "checks": 0, "packed": 0, "long": 0}
    mp = pytest.MonkeyPatch()
    _count_io(mp, seen)
    try:
        logs, records, counts = [], [], []
        for _ in range(2):
            before = dict(seen)
            log = CallLog()
            _prove(keys, tracer=log)
            logs.append(log.calls)
            records.append(trace.recent()[-1])
            counts.append({k: seen[k] - before[k] for k in seen})
    finally:
        mp.undo()
    return logs, records, counts


@pytest.mark.parametrize("name,engine", [("square_k3", TorchEngine),
                                         ("range_k7", HostCommitEngine)])
def test_a_traced_proof_is_byte_identical(keys, name, engine):
    plain = _prove(keys, name, engine)
    assert _prove(keys, name, engine, tracer=trace.Tracer()) == plain


def test_the_outer_tracer_sees_the_phases_alone(traced):
    logs, _, _ = traced
    for calls in logs:
        assert calls == [("phase", p) for p in PHASES]


def test_spans_nest_and_carry_the_request_id(traced):
    _, records, _ = traced
    for rec in records:
        assert trace.current() is trace.NULL_RECORD
        names = {s.name for s in rec.spans}
        assert names == set(PHASES) | SUB_SPANS
        assert [s.name for s in rec.spans if s.parent is None
                and s.name in PHASES] == PHASES
        assert rec.start <= rec.spans[0].start and rec.spans[-1].end <= rec.end
        for i, s in enumerate(rec.spans):
            assert s.start <= s.host_end <= s.end
            kids = [c for c in rec.spans if c.parent == i]
            assert sum(c.end - c.start for c in kids) <= s.end - s.start
            for c in kids:
                assert s.start <= c.start and c.end <= s.end
            if "." in s.name and s.name != "transcript.squeeze":
                assert rec.spans[s.parent].name == s.name.split(".")[0]
    # the record carries the request id: the process's sequence number
    assert records[1].request == records[0].request + 1


def test_counters_count_the_encodes_and_decodes(traced):
    _, records, counts = traced
    for rec, seen in zip(records, counts):
        assert rec.counters["h2d_bytes"] == seen["bytes"] > 0
        assert rec.counters["d2h_reads"] == seen["decodes"] > 0
        assert seen["checks"] == 0      # the Square circuit has no lookups
        assert rec.counters["keccak_bytes"] > 0
    assert records[0].counters == records[1].counters


def test_counters_count_the_packed_values(traced):
    """pack_values counts every value the host packer wrote in the proof
    (advice, instances, the random polynomial, SHPLONK's interpolants),
    pack_long_values those that took its long path."""
    _, records, counts = traced
    for rec, seen in zip(records, counts):
        assert rec.counters["pack_values"] == seen["packed"] > 0
        assert rec.counters["pack_long_values"] == seen["long"] > 0
        assert seen["long"] <= seen["packed"]


def test_the_lookup_check_is_a_counted_read(keys, monkeypatch):
    """A circuit with lookups reads their failure flags once a proof,
    beside its decodes, and d2h_reads counts that read too."""
    seen = {"bytes": 0, "decodes": 0, "checks": 0, "packed": 0, "long": 0}
    _count_io(monkeypatch, seen)
    _prove(keys, "range_k7", tracer=trace.Tracer())
    rec = trace.recent()[-1]
    assert seen["checks"] == 1 and seen["decodes"] > 0
    assert rec.counters["d2h_reads"] == seen["decodes"] + 1
    assert rec.counters["h2d_bytes"] == seen["bytes"]


def test_one_record_a_traced_proof_and_none_untraced(keys):
    n0 = len(trace.recent())
    _prove(keys)
    assert len(trace.recent()) == n0
    _prove(keys, tracer=trace.Tracer())
    _prove(keys, tracer=trace.Tracer())
    first, rec = trace.recent()[-2:]
    assert len(trace.recent()) == n0 + 2
    assert rec.request == first.request + 1


def test_a_failed_proof_leaves_no_record_active(keys, monkeypatch):
    monkeypatch.setattr(trace, "_RECENT", deque(maxlen=trace.RECENT))
    c, inst, seed, srs, pk = keys["square_k3"]

    class Broken:
        def synthesize(self, config, asn):
            assert trace.current() is not trace.NULL_RECORD
            raise RuntimeError("no witness")

    tr = trace.Tracer()
    with pytest.raises(RuntimeError, match="no witness"):
        create_proof(pk, srs, Broken(), inst, rng_seed=seed,
                     engine=HostCommitEngine(pk.vk.domain, srs, "cpu"),
                     tracer=tr)
    assert trace.current() is trace.NULL_RECORD
    (rec,) = trace.recent()
    assert [s.name for s in rec.spans] == ["instances", "synthesize",
                                           "synthesize.circuit"]
    assert all(s.end is not None for s in rec.spans)
    assert list(tr.phases) == ["synthesize"]


def test_spans_are_annotations_inside_their_phases(keys):
    pt = PhaseTracer(annotate=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            pt.next_proof()
            _prove(keys, tracer=pt)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    marks = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "user_annotation"]
    count = Counter(name for name, _, _ in marks)
    assert all(count[p] == 2 for p in PHASES)
    assert set(count) == set(PHASES) | SUB_SPANS
    phases = [m for m in marks if m[0] in PHASES]
    for name, s, e in marks:
        head = name.split(".")[0]
        if head in PHASES and name != head:
            assert any(p == head and ps <= s and e <= pe
                       for p, ps, pe in phases), name
        if name in SUB_SPANS:   # inside a phase or clear of every phase
            assert all(e <= ps or pe <= s or (ps <= s and e <= pe)
                       for _, ps, pe in phases), name
