"""The readers of the program's spans and counters (synth_circuit_s,
advice_encode_s, random_poly_s, transcript_s, shplonk_commit_s, h2d_mb,
d2h_reads) on made-up records, and on a traced run of the Square cell."""
from __future__ import annotations

from collections import deque
from types import SimpleNamespace

import pytest

from halo2tpu_torch.utils import trace
from portbench import manifest
from portbench.tests.cells import run_square

NEW = ("synth_circuit_s", "advice_encode_s", "random_poly_s", "transcript_s",
       "shplonk_commit_s", "h2d_mb", "d2h_reads")


def _span(name, start, end, parent=None):
    return SimpleNamespace(name=name, parent=parent, start=start,
                           host_end=end, end=end)


def _record(scale):
    """A made-up proof's record: each span's seconds times scale."""
    spans = [_span("synthesize", 0.0, 10 * scale),
             _span("synthesize.circuit", 0.0, 8 * scale, 0),
             _span("advice_ntt", 10 * scale, 16 * scale),
             _span("advice_ntt.encode", 10 * scale, 15 * scale, 2),
             _span("transcript.squeeze", 16 * scale, 17 * scale),
             _span("random_poly", 17 * scale, 20 * scale),
             _span("shplonk", 20 * scale, 30 * scale),
             _span("transcript.squeeze", 20 * scale, 22 * scale, 6),
             _span("shplonk.commit", 22 * scale, 25 * scale, 6),
             _span("shplonk.commit", 26 * scale, 30 * scale, 6)]
    return SimpleNamespace(spans=spans, counters={
        "h2d_bytes": 3_000_000 * scale, "d2h_reads": 40})


# each metric on records of scale 1 and 2 over 2 completed proofs
WANT = {"synth_circuit_s": (8 + 16) / 2, "advice_encode_s": (5 + 10) / 2,
        "random_poly_s": (3 + 6) / 2, "transcript_s": (3 + 6) / 2,
        "shplonk_commit_s": (7 + 14) / 2, "h2d_mb": (3 + 6) / 2,
        "d2h_reads": 40.0}


def _ctx(n_phases, proofs):
    return SimpleNamespace(phases=[{"synthesize": 1.0}] * n_phases,
                           proofs=proofs)


@pytest.mark.parametrize("name", NEW)
def test_reader_gives_the_mean_over_completed_proofs(monkeypatch, name):
    monkeypatch.setattr(trace, "recent", lambda: [_record(1), _record(2)])
    read = manifest.metric_reader(name)
    assert read(_ctx(2, 2)) == pytest.approx(WANT[name])
    # a failed proof's record counts in the sum, not in the divisor
    assert read(_ctx(2, 1)) == pytest.approx(2 * WANT[name])


@pytest.mark.parametrize("name", NEW)
@pytest.mark.parametrize("records,phases", [(0, 0), (0, 2), (1, 2), (3, 2)])
def test_reader_gives_none_unless_one_record_a_traced_proof(
        monkeypatch, name, records, phases):
    monkeypatch.setattr(trace, "recent",
                        lambda: [_record(1) for _ in range(records)])
    assert manifest.metric_reader(name)(_ctx(phases, max(phases, 1))) is None


@pytest.mark.parametrize("name", NEW)
def test_reader_gives_none_for_a_program_without_records(monkeypatch, name):
    monkeypatch.delattr(trace, "recent")
    assert manifest.metric_reader(name)(_ctx(2, 2)) is None


def test_a_traced_run_reports_them_nested_in_the_phases(
        tmp_path, monkeypatch):
    monkeypatch.setattr(trace, "_RECENT", deque(maxlen=trace.RECENT))
    rc, res = run_square(str(tmp_path), trace=True)
    assert rc == 0 and res["correct"] is True
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(NEW) <= set(got)
    assert 0 < got["synth_circuit_s"] <= got["synthesize_s"]
    assert 0 < got["advice_encode_s"] <= got["advice_ntt_s"]
    assert 0 < got["shplonk_commit_s"] <= got["shplonk_s"]
    assert 0 < got["random_poly_s"] <= got["prover_rest_s"]
    assert got["transcript_s"] > 0 and got["h2d_mb"] > 0
    assert got["d2h_reads"] == int(got["d2h_reads"]) > 0
    assert res["metrics"]["h2d_mb"]["unit"] == "MB"
