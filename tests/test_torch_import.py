"""halo2tpu_torch stands alone: it imports and proves without jax, without
halo2tpu, without CUDA, nvcc or triton; its entry points ask for the card
unless the caller passes device="cpu", and never fall back to the CPU."""
import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(1)

_PROVE_K3 = """
import sys
import torch
torch.set_num_threads(1)
import halo2tpu_torch
from halo2tpu_torch.circuits.signal import SquareCircuit
from halo2tpu_torch.plonk.srs import setup
from halo2tpu_torch.plonk.verifier import verify_proof
from halo2tpu_torch.plonk.keygen import keygen
from halo2tpu_torch.plonk.prover import create_proof
import halo2tpu_torch.plonk.sharded
import halo2tpu_torch.parallel.mesh, halo2tpu_torch.parallel.ntt
import halo2tpu_torch.parallel.msm, halo2tpu_torch.parallel.dcn
import halo2tpu_torch.parallel.pipeline, halo2tpu_torch.parallel.scaling_report
c = SquareCircuit(5)
srs = setup(3, cache=False)
pk, vk = keygen(c, 3, srs, device="cpu")
proof = create_proof(pk, srs, c, c.instances(), rng_seed=9, device="cpu")
assert verify_proof(vk, srs, c.instances(), proof)
assert not verify_proof(vk, srs, c.instances(), proof[:-1])
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
loaded = sorted(m for m in sys.modules
                if m == "halo2tpu" or m.startswith("halo2tpu."))
assert not loaded, loaded
print("STANDALONE-OK", len(proof))
"""


def test_proof_without_jax_subprocess():
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", _PROVE_K3], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "STANDALONE-OK 1120" in res.stdout


def test_import_needs_no_cuda_nvcc_or_triton():
    code = ("import sys, halo2tpu_torch, halo2tpu_torch.plonk.prover, "
            "halo2tpu_torch.plonk.verifier, halo2tpu_torch.ops.cuda_ec, "
            "halo2tpu_torch.ops.msm, halo2tpu_torch.convert, "
            "halo2tpu_torch.ops.poseidon, halo2tpu_torch.gadgets.poseidon, "
            "halo2tpu_torch.gadgets.qr_extractor, "
            "halo2tpu_torch.circuits.nullifier, "
            "halo2tpu_torch.circuits.conditional_secrets, "
            "halo2tpu_torch.circuits.aadhaar_qr, "
            "halo2tpu_torch.plonk.sharded, halo2tpu_torch.parallel.mesh, "
            "halo2tpu_torch.parallel.ntt, halo2tpu_torch.parallel.msm, "
            "halo2tpu_torch.parallel.dcn, halo2tpu_torch.parallel.pipeline, "
            "halo2tpu_torch.parallel.scaling_report, "
            "halo2tpu_torch.plonk.mock, halo2tpu_torch.evm.verifier\n"
            "assert 'triton' not in sys.modules and 'jax' not in sys.modules\n"
            "from halo2tpu_torch import _build\n"
            "assert _build._lib is None and _build._host_lib is None\n")
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]


def _imports_of(path):
    """Every module name an import statement in `path` names."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_and_chip_smoke_import_nothing_of_halo2tpu():
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(os.path.join(ROOT, "halo2tpu_torch")):
        paths += [os.path.join(d, f) for f in files if f.endswith(".py")]
    assert len(paths) > 30
    for rel in ("ops/poseidon.py", "gadgets/poseidon.py",
                "gadgets/qr_extractor.py", "circuits/nullifier.py",
                "circuits/conditional_secrets.py", "circuits/aadhaar_qr.py",
                "plonk/sharded.py", "parallel/mesh.py", "parallel/ntt.py",
                "parallel/msm.py", "parallel/dcn.py", "parallel/pipeline.py",
                "parallel/scaling_report.py", "plonk/mock.py", "evm/yul.py",
                "evm/verifier.py"):
        assert os.path.join(ROOT, "halo2tpu_torch", rel) in paths, rel
    bad = [(os.path.relpath(p, ROOT), m) for p in paths
           for m in _imports_of(p)
           if m == "halo2tpu" or m.startswith("halo2tpu.") or m == "jax"
           or m.startswith("jax.")]
    assert not bad, bad


def test_cuda_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    from halo2tpu_torch.fields.jfield import FR
    from halo2tpu_torch.plonk.domain import make_domain
    from halo2tpu_torch.plonk.engine import TorchEngine
    from halo2tpu_torch.plonk.srs import setup
    with pytest.raises(RuntimeError, match="CUDA"):
        FR.encode([1, 2], "cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchEngine(make_domain(3, 3), setup(3, cache=False),
                    device="cuda")


def test_entry_points_default_to_the_card():
    """With no CUDA, every entry point called without device= raises:
    the default is the card, never the CPU."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    from halo2tpu_torch.circuits.signal import SquareCircuit
    from halo2tpu_torch.curves.jpoint import affine_to_device
    from halo2tpu_torch.fields.bn254 import G1_GEN
    from halo2tpu_torch.fields.jfield import FR
    from halo2tpu_torch.ops.msm import MSMContext
    from halo2tpu_torch.ops.ntt import get_plan
    from halo2tpu_torch.parallel.dcn import make_mesh2d
    from halo2tpu_torch.parallel.mesh import make_mesh
    from halo2tpu_torch.parallel.scaling_report import run_report
    from halo2tpu_torch.plonk.domain import make_domain
    from halo2tpu_torch.plonk.engine import TorchEngine
    from halo2tpu_torch.plonk.keygen import keygen
    from halo2tpu_torch.plonk.mock import MockProver
    from halo2tpu_torch.plonk.prover import create_proof
    from halo2tpu_torch.plonk.srs import setup
    c, srs = SquareCircuit(5), setup(3, cache=False)
    pk, _ = keygen(c, 3, srs, device="cpu")
    calls = {
        "keygen": lambda: keygen(c, 3, srs),
        "create_proof": lambda: create_proof(pk, srs, c, c.instances()),
        "TorchEngine": lambda: TorchEngine(make_domain(3, 3), srs),
        "MSMContext": lambda: MSMContext([G1_GEN] * 4),
        "affine_to_device": lambda: affine_to_device([G1_GEN]),
        "get_plan": lambda: get_plan(8, make_domain(3, 3).omega),
        "make_mesh": lambda: make_mesh(1),
        "make_mesh2d": lambda: make_mesh2d(1, 1),
        "run_report": lambda: run_report((1,), 4, 64),
        "FieldSpec.encode": lambda: FR.encode([1]),
        "MockProver.run": lambda: MockProver.run(4, c, c.instances()),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
            pytest.fail(f"{name} ran without CUDA")
