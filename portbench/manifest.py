"""BENCHMARK.json: loading, the contract's name rules, and finding each
part of a cell by its name.

A cell names a configuration (its JSON file is given in `configs`) and a
traffic mix (`portbench/traffic/<mix>.json`); a configuration names its
circuit family (`portbench/families/<family>.py` for the program's side,
`portbench/ref/families/<family>.py` for the reference's); a per-layer
metric is read by `portbench/metrics/<name>.py`.  Adding a cell, a mix, a
configuration or a metric adds files and entries and edits none.
"""
from __future__ import annotations

import importlib.util
import json
import os
import re

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
METRIC_KEYS = {"end_to_end": {"name", "unit", "better", "bound", "source"},
               "per_layer": {"name", "unit", "better", "source", "layer",
                             "moves"}}


class ManifestError(ValueError):
    pass


def _line(text, what: str) -> None:
    if not isinstance(text, str) or not 1 <= len(text) <= 200 or any(
            c in text for c in "\n\r\t"):
        raise ManifestError(f"{what}: 1 to 200 characters on one line")


def _name(v, what: str) -> None:
    if not isinstance(v, str) or not NAME_RE.match(v):
        raise ManifestError(f"{what}: bad name {v!r}")


def validate(m: dict) -> None:
    """Raise ManifestError where m breaks the contract's shape rules."""
    if set(m) != TOP_KEYS:
        raise ManifestError(f"keys {sorted(m)}")
    for key, keys in (("configs", {"name", "source", "file", "reduced",
                                   "why"}),
                      ("workloads", {"name", "config", "traffic", "chips",
                                     "why"})):
        seen = set()
        for e in m[key]:
            if set(e) != keys:
                raise ManifestError(f"{key} entry keys {sorted(e)}")
            _name(e["name"], key)
            if e["name"] in seen:
                raise ManifestError(f"{key}: {e['name']} twice")
            seen.add(e["name"])
            _line(e["why"], f"{e['name']}.why")
    configs = {c["name"] for c in m["configs"]}
    for c in m["configs"]:
        _line(c["source"], f"{c['name']}.source")
        for r in c["reduced"]:
            _name(r, f"{c['name']}.reduced")
    pairs = set()
    for w in m["workloads"]:
        _name(w["config"], "config")
        _name(w["traffic"], "traffic")
        if w["config"] not in configs or w["chips"] not in (1, 4):
            raise ManifestError(f"{w['name']}: config or chips")
        if (w["config"], w["traffic"]) in pairs:
            raise ManifestError(f"{w['name']}: pair twice")
        pairs.add((w["config"], w["traffic"]))
    cells = {w["name"] for w in m["workloads"]}
    e2e = {e["name"] for e in m["end_to_end"]}
    seen = set()
    for kind in ("end_to_end", "per_layer"):
        for e in m[kind]:
            if set(e) - {"workloads"} != METRIC_KEYS[kind]:
                raise ManifestError(f"{kind} entry keys {sorted(e)}")
            if kind == "end_to_end" and not 0.01 <= e["bound"] <= 0.25:
                raise ManifestError(f"{e['name']}: bound {e['bound']}")
            _name(e["name"], kind)
            if e["name"] in seen:
                raise ManifestError(f"metric {e['name']} twice")
            seen.add(e["name"])
            if not UNIT_RE.match(e["unit"]) or e["better"] not in (
                    "lower", "higher") or e["source"] not in SOURCES:
                raise ManifestError(f"{e['name']}: unit, better or source")
            if not set(e.get("workloads", cells)) <= cells:
                raise ManifestError(f"{e['name']}: unknown cell")
            if kind == "per_layer":
                _line(e["layer"], f"{e['name']}.layer")
                if e["moves"] not in e2e:
                    raise ManifestError(f"{e['name']} moves {e['moves']}")


def load(path: str | None = None) -> dict:
    with open(path or os.path.join(ROOT, "BENCHMARK.json")) as f:
        m = json.load(f)
    validate(m)
    return m


def _read_json(rel: str) -> dict:
    with open(os.path.join(ROOT, rel)) as f:
        return json.load(f)


TRAFFIC_DIR = os.path.join(PKG, "traffic")


def cell(m: dict, workload: str, traffic_dir: str = TRAFFIC_DIR) -> dict:
    """Everything a run of one cell needs, found by name: the cell, its
    configuration and mix (as dicts), and the metrics it reports."""
    w = next((w for w in m["workloads"] if w["name"] == workload), None)
    if w is None:
        raise ManifestError(f"no workload {workload!r}")
    centry = next(c for c in m["configs"] if c["name"] == w["config"])
    config = _read_json(centry["file"])
    with open(os.path.join(traffic_dir, f"{w['traffic']}.json")) as f:
        mix = json.load(f)

    def mine(e):
        return workload in e.get("workloads", [workload])
    return {"workload": w, "config": config, "mix": mix,
            "end_to_end": [e for e in m["end_to_end"] if mine(e)],
            "per_layer": [e for e in m["per_layer"] if mine(e)]}


def _load_file(path: str, modname: str):
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


METRICS_DIR = os.path.join(PKG, "metrics")


def metric_reader(name: str, metrics_dir: str = METRICS_DIR):
    """<metrics_dir>/<name>.py's read(ctx)."""
    return _load_file(os.path.join(metrics_dir, f"{name}.py"),
                      f"portbench_metric_{name}").read


def family(name: str):
    """The program's side of a circuit family."""
    return importlib.import_module(f"portbench.families.{name}")


def ref_family(name: str):
    """The reference's side of a circuit family."""
    return importlib.import_module(f"portbench.ref.families.{name}")
