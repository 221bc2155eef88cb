"""BENCHMARK.json against the contract's shape rules, and every part of a
cell found by its name."""
from __future__ import annotations

import copy
import json
import os

import pytest

from portbench import manifest
from portbench.tests.cells import DATA, square_manifest


def test_benchmark_json_is_valid():
    m = manifest.load()
    assert m["command"] == ["python3", "portbench/run.py"]
    assert m["paths"] == ["portbench"]
    assert {e["name"] for e in m["end_to_end"]} == {"proof_s", "setup_s"}
    for e in m["end_to_end"]:
        assert 0.01 <= e["bound"] <= 0.25
    for e in m["per_layer"]:
        assert e["moves"] in ("proof_s", "setup_s")
    assert all(w["chips"] == 1 for w in m["workloads"])


def test_every_named_part_exists():
    m = manifest.load()
    for w in m["workloads"]:
        cell = manifest.cell(m, w["name"])
        assert cell["config"]["name"] == w["config"]
        assert cell["mix"]["name"] == w["traffic"]
        manifest.family(cell["config"]["family"])
        manifest.ref_family(cell["config"]["family"])
        for e in cell["per_layer"]:
            assert callable(manifest.metric_reader(e["name"]))
        reports = {e["name"] for e in cell["end_to_end"]}
        assert "setup_s" in reports and len(reports) >= 2
        assert {e["moves"] for e in cell["per_layer"]} <= reports
    for c in m["configs"]:
        assert json.load(open(os.path.join(manifest.ROOT, c["file"])))[
            "reduced"] == c["reduced"]


@pytest.mark.parametrize("bad", ["has space", "comma,", "slash/", "é",
                                 "", "x" * 65, ".lead"])
def test_bad_names_are_refused(bad):
    m = copy.deepcopy(manifest.load())
    m["workloads"][0]["name"] = bad
    with pytest.raises(manifest.ManifestError):
        manifest.validate(m)


@pytest.mark.parametrize("unit", ["tokens per second", "µs", "", "x" * 17])
def test_bad_units_are_refused(unit):
    m = copy.deepcopy(manifest.load())
    m["per_layer"][0]["unit"] = unit
    with pytest.raises(manifest.ManifestError):
        manifest.validate(m)


def test_extra_key_is_refused():
    m = copy.deepcopy(manifest.load())
    m["per_layer"][0]["why"] = "no such key"
    with pytest.raises(manifest.ManifestError):
        manifest.validate(m)


def test_new_files_are_found_without_edits(tmp_path):
    # a configuration and a mix that live outside the benchmark's folders
    m = square_manifest()
    cell = manifest.cell(m, "square_k4.squares", DATA)
    assert cell["config"]["family"] == "square"
    assert cell["mix"]["name"] == "squares"
    # a metric file that no code names
    (tmp_path / "answer_s.py").write_text(
        "def read(ctx):\n    return 42.0 if ctx.proofs else None\n")
    read = manifest.metric_reader("answer_s", str(tmp_path))

    class Ctx:
        proofs = 3
    assert read(Ctx()) == 42.0
