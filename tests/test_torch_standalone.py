"""The port's copies of halo2tpu's host modules give the same values as the
originals: the SRS, the circuits' structure digests, the vk digest and the
verifier's verdicts."""
import numpy as np
import pytest
import torch

from halo2tpu.circuits.signal import SquareCircuit as JaxSquare
from halo2tpu.circuits.timestamp import TimestampCircuit as JaxTimestamp
from halo2tpu.ops.keccak import keccak256 as jax_keccak
from halo2tpu.plonk.keygen import cs_structure_digest as jax_digest
from halo2tpu.plonk.keygen import keygen as jax_keygen
from halo2tpu.plonk.prover import create_proof as jax_create_proof
from halo2tpu.plonk.srs import setup as jax_setup
from halo2tpu.plonk.verifier import verify_proof as jax_verify_proof
from halo2tpu_torch.circuits.signal import SquareCircuit
from halo2tpu_torch.circuits.timestamp import TimestampCircuit
from halo2tpu_torch.ops.keccak import keccak256
from halo2tpu_torch.plonk.keygen import cs_structure_digest, keygen
from halo2tpu_torch.plonk.srs import setup
from halo2tpu_torch.plonk.verifier import verify_proof

from chip_smoke import golden_circuits
from test_torch_golden import GOLDEN_NAMES, jax_golden_circuits

torch.set_num_threads(1)


def test_setup_k4_matches_halo2tpu():
    a, b = setup(4, cache=False), jax_setup(4, cache=False)
    assert (a.k, a.n) == (b.k, b.n)
    assert a.g == b.g and a.g_lagrange == b.g_lagrange
    assert a.g2 == b.g2 and a.s_g2 == b.s_g2


def test_keccak_matches_halo2tpu():
    rng = np.random.default_rng(91)
    for m in (0, 1, 135, 136, 137, 1000):
        data = rng.bytes(m)
        assert keccak256(data) == jax_keccak(data)


@pytest.mark.parametrize("name", GOLDEN_NAMES)
def test_structure_digest_matches_halo2tpu(name):
    c = golden_circuits()[name][0]
    cj = jax_golden_circuits()[name][0]
    assert cs_structure_digest(c) == jax_digest(cj)


def test_vk_digest_matches_halo2tpu():
    for c, cj, k in ((SquareCircuit(5), JaxSquare(5), 3),
                     (TimestampCircuit(2023, 7, 8, 12, 34, 56),
                      JaxTimestamp(2023, 7, 8, 12, 34, 56), 6)):
        _, vk = keygen(c, k, setup(k, cache=False), device="cpu")
        _, vkj = jax_keygen(cj, k, jax_setup(k, cache=False))
        assert vk.transcript_repr == vkj.transcript_repr


def test_verifier_verdicts_match_halo2tpu():
    """A HostEngine proof, one byte flipped, and truncated: both verifiers
    say the same, each with its own package's vk and SRS."""
    cj, c = JaxSquare(5), SquareCircuit(5)
    srs_j, srs = jax_setup(3, cache=False), setup(3, cache=False)
    pk_j, vk_j = jax_keygen(cj, 3, srs_j)
    _, vk = keygen(c, 3, srs, device="cpu")
    proof = jax_create_proof(pk_j, srs_j, cj, cj.instances(), rng_seed=5,
                             engine="host")
    flipped = bytearray(proof)
    flipped[100] ^= 1
    cases = {"good": proof, "flipped": bytes(flipped),
             "truncated": proof[:-32]}
    verdicts = {name: (verify_proof(vk, srs, c.instances(), p),
                       jax_verify_proof(vk_j, srs_j, cj.instances(), p))
                for name, p in cases.items()}
    assert verdicts == {"good": (True, True), "flipped": (False, False),
                        "truncated": (False, False)}


def test_cache_files_are_the_ports_own(tmp_path, monkeypatch):
    """keygen_cached and setup write file names halo2tpu never uses, each
    through a temporary file; a second call loads what the first wrote."""
    from halo2tpu_torch.plonk import keygen as tkeygen
    from halo2tpu_torch.plonk import srs as tsrs
    monkeypatch.setattr(tsrs, "_CACHE_DIR", str(tmp_path))
    srs = tsrs.setup(3)
    assert [p.name for p in tmp_path.iterdir()] == [
        "srs_torch_k3_466a732dc4c3.pkl"]
    assert tsrs.setup(3).g_lagrange == srs.g_lagrange
    c = SquareCircuit(5)
    pk, vk = tkeygen.keygen_cached(c, 3, srs, cache_key="sq", device="cpu",
                                   cache_dir=str(tmp_path / "pk"))
    names = [p.name for p in (tmp_path / "pk").iterdir()]
    assert names == [f"pk3_torch_sq_{cs_structure_digest(c)}_k3.pkl"]
    pk2, vk2 = tkeygen.keygen_cached(c, 3, srs, cache_key="sq",
                                     cache_dir=str(tmp_path / "pk"))
    assert type(pk2) is tkeygen.ProvingKey
    assert vk2.transcript_repr == vk.transcript_repr
