"""Build and load the port's CUDA kernels.

Every `csrc/*.cu` file is compiled with nvcc (one process per file, all
started together) and linked into one shared library with a plain C
interface (no PyTorch headers, so the build takes seconds), at first use,
into `halo2tpu_torch/build/`.  The library is loaded with ctypes.  A failed
build or load raises: there is no fallback.

ptxas reports each kernel's registers, stack and spills (`-Xptxas -v`); the
report is kept beside the library and parsed into `resources`.

Each C entry point launches on the stream it is given and returns
`cudaGetLastError()`; `check()` raises when that is not 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD = os.path.join(_HERE, "build")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]
# the __global__ functions of csrc/, as ptxas names them (mangled)
KERNELS = ("mont_mul_kernel", "fold_mixed_kernel", "fold_mixed_tiled_kernel",
           "fold_add_kernel", "fold_dbl_kernel")

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
    "h2_fold_dbl": [_P, _P, _I64, _I32, _P, _P],
}

_lib = None
build_seconds: float | None = None   # wall time of this process's build
resources: dict = {}                 # kernel -> parse_ptxas() entry


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


def parse_ptxas(text: str) -> dict:
    """`-Xptxas -v` output -> {kernel: {"registers", "spill_store_bytes",
    "spill_load_bytes", "spill_bytes", "stack_bytes", "smem_bytes",
    "lines"}} for the kernels named in KERNELS (matched by their
    length-prefixed mangled name, e.g. `17fold_mixed_kernel`); a kernel
    templated on one bool is listed as `name<true>` and `name<false>`."""
    out: dict = {}
    cur = None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$.]+)'?", line)
        if m:
            cur = next((k for k in KERNELS if f"{len(k)}{k}" in m.group(1)),
                       None)
            if cur is not None:
                flag = re.search(f"{len(cur)}{cur}ILb([01])E", m.group(1))
                if flag:
                    cur += "<true>" if flag.group(1) == "1" else "<false>"
                out.setdefault(cur, {"lines": []})
        if cur is None:
            continue
        entry = out[cur]
        if line.strip() and line.strip() not in entry["lines"]:
            entry["lines"].append(line.strip())
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            entry["stack_bytes"] = int(m.group(1))
            entry["spill_store_bytes"] = int(m.group(2))
            entry["spill_load_bytes"] = int(m.group(3))
            entry["spill_bytes"] = int(m.group(2)) + int(m.group(3))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            entry["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            entry["smem_bytes"] = int(s.group(1)) if s else 0
    return out


def _compile(so: str, srcs: list[str]) -> str:
    """Build `so` from the .cu sources; returns ptxas's report."""
    os.makedirs(BUILD, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    cus = [s for s in srcs if s.endswith(".cu")]
    objs = [os.path.join(BUILD, f"{os.path.basename(s)}.{tag}.o")
            for s in cus]
    procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", src, "-o", obj],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(cus, objs)]
    report = []
    for proc, src in zip(procs, cus):
        text = proc.communicate()[0]
        if proc.returncode != 0:
            for p in procs:
                p.kill()
                p.wait()
            raise RuntimeError(f"nvcc failed on {src} ({proc.returncode}):"
                               f"\n{text}")
        report.append(text)
    tmp = f"{so}.{tag}"
    cmd = [_nvcc(), *ARCH, "-shared", "-o", tmp, *objs]
    res = subprocess.run(cmd, capture_output=True, text=True)
    for obj in objs:
        os.remove(obj)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                           f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
    with open(f"{so}.ptxas.txt", "w") as f:
        f.write("".join(report))
    os.replace(tmp, so)
    return "".join(report)


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built from the checkout's sources on the
    first call (the file name carries a hash of the sources and flags)."""
    global _lib, build_seconds, resources
    if _lib is not None:
        return _lib
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in srcs:
        with open(path, "rb") as f:
            h.update(f.read())
    so = os.path.join(BUILD, f"libhalo2tpu_kernels_{h.hexdigest()[:12]}.so")
    if not os.path.exists(so):
        t0 = time.perf_counter()
        report = _compile(so, srcs)
        build_seconds = time.perf_counter() - t0
    else:
        report = ""
        if os.path.exists(f"{so}.ptxas.txt"):
            with open(f"{so}.ptxas.txt") as f:
                report = f.read()
        build_seconds = 0.0
    resources = parse_ptxas(report)
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
