"""Build and load the port's CUDA kernels.

Every `csrc/*.cu` file is compiled with nvcc into one shared library with a
plain C interface (no PyTorch headers, so the build takes seconds), at first
use, into `halo2tpu_torch/build/`.  The library is loaded with ctypes.  A
failed build or load raises: there is no fallback.

Each C entry point launches on the stream it is given and returns
`cudaGetLastError()`; `check()` raises when that is not 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD = os.path.join(_HERE, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
_SIGNATURES = {
    # name: argtypes (pointers, then sizes, then modulus words and stream)
    "h2_mont_mul": [_P, _P, _P, _I64, _P, _P],
    "h2_fold_mixed": [_P, _P, _P, _P, _I64, _I32, _I32, _I64, _I32, _I32, _P,
                      _P],
    "h2_fold_mixed_tiled": [_P, _P, _P, _P, _I64, _I32, _P, _P],
    "h2_fold_add": [_P, _P, _P, _I64, _P, _P],
    "h2_fold_dbl": [_P, _P, _I64, _P, _P],
}

_lib = None
build_seconds: float | None = None   # wall time of this process's build


def _sources() -> list[str]:
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built from the checkout's sources on the
    first call (the file name carries a hash of the sources and flags)."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in srcs:
        with open(path, "rb") as f:
            h.update(f.read())
    so = os.path.join(BUILD, f"libhalo2tpu_kernels_{h.hexdigest()[:12]}.so")
    if not os.path.exists(so):
        os.makedirs(BUILD, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               *[s for s in srcs if s.endswith(".cu")]]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
        os.replace(tmp, so)
        build_seconds = time.perf_counter() - t0
    else:
        build_seconds = 0.0
    loaded = ctypes.CDLL(so)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(loaded, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib = loaded
    return _lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
