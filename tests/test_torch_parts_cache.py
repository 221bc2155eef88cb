"""The prover's cache of fixed and sigma part values (prover._PkState) takes
its budget from HALO2TPU_PARTS_CACHE_MB (default 4600 MiB), as halo2tpu's
does.  Under a small budget the parts are recomputed at every proof, and
the proof bytes stay the same."""
import pytest
import torch

from halo2tpu_torch.circuits.signal import SquareCircuit
from halo2tpu_torch.plonk import prover
from halo2tpu_torch.plonk.engine import TorchEngine
from halo2tpu_torch.plonk.keygen import keygen
from halo2tpu_torch.plonk.srs import setup

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def key():
    c, srs = SquareCircuit(5), setup(3, cache=False)
    pk, _ = keygen(c, 3, srs, device="cpu")
    return c, srs, pk


def _two_proofs(key):
    """Two proofs on one engine (the second finds the pk state warm), and
    that state."""
    c, srs, pk = key
    pk.__dict__.pop("_torch_state_cache", None)
    eng = TorchEngine(pk.vk.domain, srs, "cpu")
    proofs = [prover.create_proof(pk, srs, c, c.instances(), rng_seed=s,
                                  engine=eng) for s in (7, 7)]
    return proofs, prover._get_state(pk, eng)


def test_zero_budget_recomputes_parts_same_bytes(key, monkeypatch):
    monkeypatch.delenv("HALO2TPU_PARTS_CACHE_MB", raising=False)
    want, st = _two_proofs(key)
    assert any(st._fixed_parts) and st.parts_cached_bytes > 0
    monkeypatch.setenv("HALO2TPU_PARTS_CACHE_MB", "0")
    got, st = _two_proofs(key)
    assert got == want and got[0] == got[1]
    assert st.parts_cached_bytes == 0
    assert all(p is None for p in st._fixed_parts + st._sigma_parts)


@pytest.mark.parametrize("mb,budget", [(None, 4600 << 20), ("7", 7 << 20)])
def test_budget_is_read_from_the_environment(key, monkeypatch, mb, budget):
    c, srs, pk = key
    if mb is None:
        monkeypatch.delenv("HALO2TPU_PARTS_CACHE_MB", raising=False)
    else:
        monkeypatch.setenv("HALO2TPU_PARTS_CACHE_MB", mb)
    st = prover._PkState(pk, TorchEngine(pk.vk.domain, srs, "cpu"))
    assert (st._parts_budget, st.parts_cached_bytes) == (budget, 0)
