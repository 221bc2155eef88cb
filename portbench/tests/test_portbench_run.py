"""Whole runs of a small cell on the CPU: the result line, the checks
that decide `correct` and each fault they must catch, the caches, and the
process's modules."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import types

import pytest

from portbench import harness, manifest
from portbench.tests.cells import run_square

RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]
CHECKS = ["bad_key", "bad_instances", "bad_proofs", "failed_proofs",
          "no_proofs"]


@pytest.fixture(scope="module")
def cache_root(tmp_path_factory):
    return str(tmp_path_factory.mktemp("portbench_cache"))


def test_a_sound_run_and_its_last_line(cache_root):
    logs = []
    rc, res = run_square(cache_root, log=logs.append)
    assert rc == 0 and res["correct"] is True
    assert list(res)[:5] == RESULT_KEYS and list(res)[-1] == "checks"
    assert list(res["checks"]) == CHECKS
    assert all(c == {"value": 0, "limit": 0} for c in res["checks"].values())
    assert set(res["metrics"]) == {"proof_s", "setup_s"}
    for v in res["metrics"].values():
        assert v["value"] > 0 and v["unit"] == "s"
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    run = logs[0]
    assert run["proofs"] == len(run["proof_seconds"]) >= 1
    assert run["affinity"] >= 1 and run["cpu_share"] > 0
    json.dumps(res)


def test_the_first_run_of_a_checkout_records_its_setup_apart(tmp_path):
    first, second = [], []
    run_square(str(tmp_path), log=first.append)
    run_square(str(tmp_path), log=second.append)
    built = first[0]["built"]
    assert any(f.startswith("pk3_torch_pb_square_k4_") for f in built)
    assert any(f.startswith("refkey_pb_square_k4_") for f in os.listdir(
        tmp_path / ".cache" / "portbench"))
    assert second[0]["built"] == []
    assert "key_load_s" in first[0]["setup_parts"]


def test_a_traced_run_reports_the_per_layer_metrics(cache_root):
    rc, res = run_square(cache_root, trace=True)
    assert rc == 0 and res["correct"] is True
    # no card: the device's metrics find nothing to read and are left out
    assert {"synthesize_s", "advice_ntt_s", "commit_s", "quotient_s",
            "shplonk_s", "prover_rest_s", "gc_s", "key_load_s",
            "warmup_s"} <= set(res["metrics"])
    assert not {"kernel_ms", "device_idle", "ntt_roofline",
                "msm_roofline"} & set(res["metrics"])
    assert "proof_s" not in res["metrics"]


@pytest.mark.parametrize("fault,seconds,caught", [
    ("instance", 0.1, {"bad_instances", "bad_proofs"}),   # the control
    # a step that returns its last answer: a window of two proofs or more
    ("stale", 15.0, {"bad_proofs"}),
    ("flip", 0.1, {"bad_proofs"}),  # an answer altered where it is made
])
def test_each_fault_makes_correct_false(cache_root, fault, seconds, caught):
    rc, res = run_square(cache_root, seconds=seconds, fault=fault)
    assert rc == 0 and res["correct"] is False
    assert {k for k, v in res["checks"].items() if v["value"]} == caught


def test_pk_cache_key_names_every_parameter():
    from halo2tpu_torch.circuits.rsa_sha256 import (RSASha256Circuit,
                                                    RSASha256Params)
    from halo2tpu_torch.plonk.keygen import cs_structure_digest
    m = manifest.load()
    cfg = manifest.cell(m, "rsa_k15.fresh_messages")["config"]
    narrow = json.loads(json.dumps(cfg))
    narrow["params"].update(num_advice=48, num_lookup_advice=12)
    keys = {harness.pk_cache_key(c) for c in (cfg, narrow)}
    assert len(keys) == 2 and "rsa_sha256_chip_smoke" not in keys
    files = set()
    for c in (cfg, narrow):
        circuit = RSASha256Circuit(b"x", 3, 1, RSASha256Params(**c["params"]))
        files.add(f"pk3_torch_{harness.pk_cache_key(c)}_"
                  f"{cs_structure_digest(circuit)}_k{c['k']}.pkl")
    assert len(files) == 2


def test_forbidden_modules_are_named(monkeypatch):
    assert "halo2tpu_torch" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "halo2tpu.plonk", types.ModuleType("x"))
    assert harness.forbidden_modules() == ["halo2tpu", "jax"]


def test_a_run_loads_neither_jax_nor_halo2tpu(tmp_path):
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from portbench.tests.cells import run_square\n"
            "from portbench.harness import forbidden_modules\n"
            "rc, res = run_square(%r)\n"
            "assert rc == 0 and res['correct']\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
            "print(forbidden_modules())\n" % (manifest.ROOT, str(tmp_path)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, env={**os.environ,
                                                      "JAX_PLATFORMS": ""})
    assert out.returncode == 0, out.stderr[-2000:]
    mods = eval(out.stdout.strip().splitlines()[-2])
    assert "halo2tpu_torch" in mods
    assert not set(mods) & set(harness.FORBIDDEN)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _run_py(cwd, *args):
    return subprocess.run(
        [sys.executable, "portbench/run.py", *args], cwd=cwd,
        capture_output=True, text=True, timeout=300)


def test_without_a_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _run_py(manifest.ROOT, "--workload", "aadhaar_k15.fresh_users",
                  "--seed", str(2**33), "--seconds", "1", "--trace", "0")
    assert out.returncode != 0
    assert '"correct"' not in out.stdout


def test_without_the_program_no_result(tmp_path):
    shutil.copy(os.path.join(manifest.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(manifest.ROOT, "portbench"),
                    tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from portbench.tests.cells import run_square\n"
            "rc, res = run_square(%r)\n"
            "print(res)\n" % (str(tmp_path), str(tmp_path / "c")))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and "halo2tpu_torch" in out.stderr
    assert '"correct"' not in out.stdout and "correct" not in out.stdout


@pytest.mark.cuda
def test_the_control_fails_on_the_card():
    """The control at the composite cell's size: proofs made for an
    altered public input must fail the reference."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = _run_py(manifest.ROOT, "--workload", "aadhaar_k15.fresh_users",
                  "--seed", str(2**33 + 7), "--seconds", "5", "--trace", "0",
                  "--fault", "instance")
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is False
    assert res["checks"]["bad_proofs"]["value"] == res["attempted"]


def test_the_reference_imports_nothing_of_the_program():
    """portbench/ref imports only the standard library, numpy and itself."""
    import ast
    allowed = set(sys.stdlib_module_names) | {"numpy"}
    here = os.path.join(manifest.PKG, "ref")
    for root, _, files in os.walk(here):
        for f in files:
            if not f.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(root, f)).read())
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and not node.level:
                    names = [node.module]
                else:
                    continue
                for n in names:
                    assert n.split(".")[0] in allowed, (f, n)
