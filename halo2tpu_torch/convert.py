"""Convert state between halo2tpu (JAX, 16-bit limbs) and this port (32-bit
limbs).  Both keep field elements in Montgomery form with R = 2^256, so the
16 16-bit limbs and the 8 32-bit limbs of one element are the same
little-endian bytes: every conversion here is a relayout, no arithmetic.

JAX arrays are passed as numpy arrays (np.asarray of a jax.Array); this
module imports no jax.
"""
from __future__ import annotations

import numpy as np
import torch

from .fields.jfield import NLIMB, limbs16_to_limbs
from .ops.msm import TABLE_W


def from_jax_limbs(arr) -> torch.Tensor:
    """(..., 16) 16-bit limbs (uint16 or uint32 holding 16-bit values) ->
    (..., 8) int32 tensor."""
    return torch.from_numpy(limbs16_to_limbs(np.asarray(arr)).copy())


def to_jax_limbs(t: torch.Tensor) -> np.ndarray:
    """(..., 8) int32 tensor -> (..., 16) uint32 array of 16-bit limbs (the
    halo2tpu compute layout)."""
    a = np.ascontiguousarray(t.detach().cpu().numpy()).view("<u4")
    return a.view("<u2").reshape(a.shape[:-1] + (2 * NLIMB,)).astype(
        np.uint32)


def points_from_limb_major(lm) -> torch.Tensor:
    """halo2tpu limb-major points (3, 16, L) -> port points (L, 3, 8)."""
    lm = np.asarray(lm)
    return from_jax_limbs(np.transpose(lm, (2, 0, 1)))


def points_to_limb_major(t: torch.Tensor) -> np.ndarray:
    """Port points (L, 3, 8) -> halo2tpu limb-major (3, 16, L) uint32."""
    return np.ascontiguousarray(np.transpose(to_jax_limbs(t), (1, 2, 0)))


def msm_table_from_jax(arr) -> torch.Tensor:
    """halo2tpu MSM window table (3, TABLE_W, 16, npad) uint16 (the
    .cache/msm_table_<tag>.npy format) -> port table (TABLE_W, npad, 3, 8)
    int32."""
    arr = np.asarray(arr)
    if arr.ndim != 4 or arr.shape[0] != 3 or arr.shape[1] != TABLE_W:
        raise ValueError(f"not a halo2tpu MSM table: shape {arr.shape}")
    return from_jax_limbs(np.transpose(arr, (1, 3, 0, 2)))


def msm_table_to_jax(t: torch.Tensor) -> np.ndarray:
    """Port table (TABLE_W, npad, 3, 8) -> halo2tpu (3, TABLE_W, 16, npad)
    uint16."""
    return np.ascontiguousarray(np.transpose(
        to_jax_limbs(t).astype(np.uint16), (2, 0, 3, 1)))


def load_jax_msm_table(path: str, device="cuda") -> torch.Tensor:
    """Read a halo2tpu .cache/msm_table_<tag>.npy into a port table."""
    return msm_table_from_jax(np.load(path, mmap_mode="r")).to(device)
