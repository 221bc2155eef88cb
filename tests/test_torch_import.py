"""halo2tpu_torch imports and proves without jax, CUDA, nvcc or triton, and
never falls back to the CPU when CUDA is asked for."""
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
from halo2tpu.circuits.signal import SquareCircuit
from halo2tpu.plonk.srs import setup
from halo2tpu.plonk.verifier import verify_proof
from halo2tpu_torch.plonk.keygen import keygen
from halo2tpu_torch.plonk.prover import create_proof
c = SquareCircuit(5)
srs = setup(3, cache=False)
pk, vk = keygen(c, 3, srs)
proof = create_proof(pk, srs, c, c.instances(), rng_seed=9)
assert verify_proof(vk, srs, c.instances(), proof)
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
print("NOJAX-OK", len(proof))
"""


def test_proof_without_jax_subprocess():
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", _PROVE_K3], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "NOJAX-OK 1120" in res.stdout


def test_import_needs_no_cuda_nvcc_or_triton():
    code = ("import sys, halo2tpu_torch, halo2tpu_torch.plonk.prover, "
            "halo2tpu_torch.ops.cuda_ec, halo2tpu_torch.convert\n"
            "assert 'triton' not in sys.modules and 'jax' not in sys.modules\n"
            "from halo2tpu_torch import _build\n"
            "assert _build._lib is None\n")
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]


def test_cuda_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    from halo2tpu.plonk.domain import make_domain
    from halo2tpu.plonk.srs import setup
    from halo2tpu_torch.fields.jfield import FR
    from halo2tpu_torch.plonk.engine import TorchEngine
    with pytest.raises(RuntimeError, match="CUDA"):
        FR.encode([1, 2], "cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchEngine(make_domain(3, 3), setup(3, cache=False),
                    device="cuda")
