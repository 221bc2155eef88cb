"""Helpers of the harness's tests: a manifest with a cell of the Square
circuit, which proves on the CPU in seconds, and a run of it."""
from __future__ import annotations

import copy
import os

from portbench import harness, manifest

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
CELL = "square_k4.squares"


def square_manifest() -> dict:
    m = copy.deepcopy(manifest.load())
    m["configs"].append({"name": "square_k4", "source": "signal.rs",
                         "file": "portbench/tests/data/square_k4.json",
                         "reduced": [], "why": "the harness's tests"})
    m["workloads"].append({"name": CELL, "config": "square_k4",
                           "traffic": "squares", "chips": 1,
                           "why": "the harness's tests"})
    for e in m["per_layer"]:
        e["workloads"].append(CELL)
    manifest.validate(m)
    return m


def run_square(cache_root: str, seed: int = 12345678901, seconds=0.1,
               trace=False, fault=None, log=None):
    """One CPU run of the Square cell with its caches under cache_root."""
    os.environ["HALO2TPU_CACHE"] = os.path.join(cache_root, "msm")
    return harness.run_cell(square_manifest(), CELL, seed, seconds, trace,
                            device="cpu", require_card=False, fault=fault,
                            cache_root=cache_root, traffic_dir=DATA,
                            log=log or (lambda obj: None))
