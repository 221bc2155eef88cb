"""The on-disk MSM window table (MSMContext.table) is a best-effort cache:
a file that cannot be read, or of the wrong shape or dtype, is rebuilt and
replaced, and a cache directory that cannot be written is skipped.  In each
case the commitments equal those of a run with no cache."""
import os

import numpy as np
import pytest
import torch

from halo2tpu_torch.fields.bn254 import R
from halo2tpu_torch.ops.msm import TABLE_W, MSMContext
from halo2tpu_torch.plonk.srs import setup

torch.set_num_threads(1)

TAG = "test8"


@pytest.fixture(scope="module")
def bases_and_want():
    bases = setup(3, cache=False).g_lagrange
    rng = np.random.default_rng(8)
    vectors = [[int.from_bytes(rng.bytes(32), "big") % R for _ in range(8)]
               for _ in range(2)]
    want = MSMContext(bases, device="cpu").commit_batch(vectors)
    return bases, vectors, want


def _commit(bases, vectors):
    return MSMContext(bases, cache_tag=TAG, device="cpu").commit_batch(
        vectors)


def _path(d):
    return os.path.join(str(d), f"msm_table_torch_{TAG}.npy")


def _is_table(path) -> bool:
    a = np.load(path)
    return a.shape == (TABLE_W, 8, 3, 8) and a.dtype == np.int32


@pytest.mark.parametrize("bad", ["garbage", "truncated", "wrong_shape",
                                 "wrong_dtype"])
def test_bad_table_file_is_rebuilt(bad, bases_and_want, tmp_path,
                                   monkeypatch):
    bases, vectors, want = bases_and_want
    monkeypatch.setenv("HALO2TPU_CACHE", str(tmp_path))
    path = _path(tmp_path)
    if bad == "garbage":
        with open(path, "wb") as f:
            f.write(b"\x00not a numpy file" * 64)
    elif bad == "truncated":
        np.save(path, np.zeros((TABLE_W, 8, 3, 8), np.int32))
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) // 2)
    elif bad == "wrong_shape":
        np.save(path, np.zeros((TABLE_W, 4, 3, 8), np.int32))
    else:
        np.save(path, np.zeros((TABLE_W, 8, 3, 8), np.int64))
    assert _commit(bases, vectors) == want
    assert _is_table(path)                  # replaced by the rebuilt table
    assert _commit(bases, vectors) == want  # and read back
    assert sorted(os.listdir(tmp_path)) == [os.path.basename(path)]


def test_unwritable_cache_dir_is_skipped(bases_and_want, tmp_path,
                                         monkeypatch):
    """The cache path lies under a regular file, so no directory can be
    made there (whoever runs the test)."""
    bases, vectors, want = bases_and_want
    blocker = tmp_path / "blocker"
    blocker.write_bytes(b"")
    monkeypatch.setenv("HALO2TPU_CACHE", str(blocker / "cache"))
    assert _commit(bases, vectors) == want
    assert sorted(os.listdir(tmp_path)) == ["blocker"]


def test_read_only_cache_dir_is_skipped(bases_and_want, tmp_path,
                                        monkeypatch):
    bases, vectors, want = bases_and_want
    ro = tmp_path / "ro"
    ro.mkdir()
    ro.chmod(0o500)
    try:
        monkeypatch.setenv("HALO2TPU_CACHE", str(ro))
        assert _commit(bases, vectors) == want
        leftovers = [f for f in os.listdir(ro) if f.endswith(".tmp.npy")]
        assert not leftovers
    finally:
        ro.chmod(0o700)


def test_good_table_file_is_used(bases_and_want, tmp_path, monkeypatch):
    """A table written by one context is read by the next, which builds
    nothing."""
    from halo2tpu_torch.ops import msm
    bases, vectors, want = bases_and_want
    monkeypatch.setenv("HALO2TPU_CACHE", str(tmp_path))
    assert _commit(bases, vectors) == want

    def no_build(points):
        raise AssertionError("the table was rebuilt")

    monkeypatch.setattr(msm, "precompute_window_table", no_build)
    assert _commit(bases, vectors) == want
