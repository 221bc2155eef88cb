"""The port's copy of the native Poseidon sponge (ops/poseidon.py) against
halo2tpu's: the Grain-LFSR parameters, the permutation, the sponge and the
nullifier recipe, and the regression vectors tests/test_poseidon.py pins."""
import numpy as np
import pytest

from halo2tpu.ops import poseidon as jax_poseidon
from halo2tpu_torch.fields.bn254 import R
from halo2tpu_torch.ops.poseidon import (Poseidon, generate_parameters,
                                         hash_elements, nullifier, permute)

# the pins of tests/test_poseidon.py
RC00 = 0x2A4203A01C69B91A87E05F81737E9947C9E709C9C258B39A640351D11BFB77CB
MDS00 = 0x14C2C125FBDFEBB54922BAF600A990C07624F037CD6344CC2F5CAC0C46A8858B
H12 = 0x0F8AF9F52112F09E0F203855E953C7A95743F267DD1803EF31702DC9D0BE71F8
H1TO8 = 0x095288862EE7711E4DA09EEA9FA10BE2E4F006C84B5F5EFE9BB802679EC732A5
NULLIFIER_0_31 = 0x0EC09F1637F1698A236FF1914C145C6CFDAB417E330D25C193BB154425520809


def _elements(seed: int, m: int) -> list:
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % R for _ in range(m)]


def test_parameters_match_halo2tpu_and_pins():
    rcs, mds = generate_parameters()
    assert (rcs, mds) == jax_poseidon.generate_parameters()
    assert len(rcs) == 8 + 57 and all(len(row) == 5 for row in rcs)
    assert (rcs[0][0], mds[0][0]) == (RC00, MDS00)


@pytest.mark.parametrize("t,r_f,r_p", [(3, 8, 57), (5, 8, 60)])
def test_other_widths_match_halo2tpu(t, r_f, r_p):
    assert generate_parameters(t, r_f, r_p) == (
        jax_poseidon.generate_parameters(t, r_f, r_p))


def test_permutation_matches_halo2tpu():
    for seed in range(3):
        state = _elements(seed, 5)
        assert permute(list(state)) == jax_poseidon.permute(list(state))


@pytest.mark.parametrize("m", [0, 1, 2, 3, 4, 5, 8, 9, 33])
def test_hash_elements_matches_halo2tpu(m):
    vals = _elements(100 + m, m)
    assert hash_elements(vals) == jax_poseidon.hash_elements(vals)


def test_regression_vectors():
    assert hash_elements([1, 2]) == H12
    assert hash_elements(list(range(1, 9))) == H1TO8
    assert nullifier(12345678, bytes(range(32))) == NULLIFIER_0_31


def test_incremental_sponge_and_nullifier_match_halo2tpu():
    vals = _elements(7, 11)
    s, sj = Poseidon(), jax_poseidon.Poseidon()
    for lo, hi in ((0, 2), (2, 7), (7, 11)):
        s.update(vals[lo:hi])
        sj.update(vals[lo:hi])
    assert s.squeeze() == sj.squeeze() == hash_elements(vals)
    photo = bytes((i * 7 + 3) % 256 for i in range(124))
    assert nullifier(12345678, photo) == jax_poseidon.nullifier(12345678,
                                                                photo)
