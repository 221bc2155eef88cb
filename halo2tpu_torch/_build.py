"""Build and load the port's CUDA kernels.

Every `csrc/*.cu` file is compiled with nvcc (one process per file, all
started together) and linked into one shared library with a plain C
interface (no PyTorch headers, so the build takes seconds), at first use,
into `halo2tpu_torch/build/`.  The library is loaded with ctypes.  A failed
build or load raises: there is no fallback.

ptxas reports each kernel's registers, stack and spills (`-Xptxas -v`); the
report is kept beside the library and parsed into `resources`.  `sass()`
counts each kernel's machine instructions (`cuobjdump -sass`).

Each C entry point launches on the stream it is given and returns
`cudaGetLastError()`; `check()` raises when that is not 0.

`host_lib()` builds `csrc/host_pack.c` (the packing of Python ints into
the limb wire, against CPython's API, and the reduction of random words
into it) and `csrc/host_keccak.c` (the transcript's Keccak-256) with the
host C compiler into one library, so it builds and runs on a machine
without CUDA too, and loads it with ctypes.PyDLL (calls hold the
interpreter lock).  It raises as `lib()` does: there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import sys
import sysconfig
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD = os.path.join(_HERE, "build")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]
# the __global__ functions of csrc/, as ptxas names them (mangled)
KERNELS = ("mont_mul_kernel", "mont_pow_kernel", "mont_chain_kernel",
           "field_prog_kernel",
           "field_addsub_kernel", "field_linscan_kernel",
           "field_linscan_stream_kernel", "ntt_pass_kernel",
           "fold_mixed_kernel", "fold_mixed_tiled_kernel",
           "fold_mixed_tiled_rows_kernel", "fold_add_kernel",
           "fold_add_tree_kernel", "fold_dbl_kernel", "fold_horner_kernel")

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
_SIGNATURES = {
    # name: argtypes (pointers, then sizes, then modulus words and stream)
    "h2_mont_mul": [_P, _P, _P, _I64, _P, _P],
    "h2_mont_pow": [_P, _P, _I64, _P, _I32, _P, _P],
    "h2_mont_chain": [_P, _P, _P, _I64, _I32, _I32, _P, _P],
    "h2_field_prog": [_P, _P, _I32, _I32, _P, _P, _P, _I64, _I32, _P, _P],
    "h2_field_addsub": [_P, _I64, _I64, _P, _I64, _I64, _P, _I64, _I32, _P,
                        _P],
    "h2_field_linscan": [_P, _I64, _I64, _P, _I64, _I64, _I32, _I64, _I32,
                         _I32, _I32, _I32, _P, _P, _P, _P, _P,
                         ctypes.c_ulonglong, ctypes.c_uint, _P, _P],
    "h2_field_linscan_stream": [_P, _I64, _I64, _P, _I64, _I64, _I32, _I64,
                                _I32, _I32, _I32, _P, _P, _P,
                                ctypes.c_ulonglong, ctypes.c_uint, _P, _P],
    "h2_ntt_pass": [_P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I32, _I32,
                    _I32, _P, _P],
    "h2_fold_mixed": [_P, _P, _P, _P, _I64, _I32, _I32, _I64, _I32, _I32, _P,
                      _P],
    "h2_fold_mixed_tiled": [_P, _P, _P, _P, _I64, _I32, _P, _P],
    "h2_fold_mixed_tiled_rows": [_P, _P, _P, _P, _I64, _I32, _I32, _I64,
                                 _I32, _I32, _P, _P],
    "h2_fold_add": [_P, _P, _P, _I64, _P, _P],
    "h2_fold_add_tree": [_P, _P, _P, _P, _I64, _I32, _I64, _P, _P],
    "h2_fold_dbl": [_P, _P, _I64, _I32, _P, _P],
    "h2_fold_horner": [_P, _P, _I32, _I32, _I32, _P, _P],
}

HOST_SRCS = [os.path.join(CSRC, f) for f in ("host_pack.c", "host_keccak.c")]
HOST_FLAGS = ["-O2", "-shared", "-fPIC"]

_lib = None
_host_lib = None
library: str | None = None           # path of the loaded library
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
    templated on one bool is listed as `name<true>` and `name<false>`, one
    templated on one int as `name<3>`."""
    out: dict = {}
    cur = None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$.]+)'?", line)
        if m:
            cur = _demangle(m.group(1), KERNELS)
            if cur is not None:
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


def _demangle(mangled: str, names) -> str | None:
    """The name of `names` that a mangled symbol holds (its length-prefixed
    form), with `<true>` / `<false>` for a template on one bool and `<n>`
    for one on an int; else None."""
    name = next((k for k in names if f"{len(k)}{k}" in mangled), None)
    if name is not None:
        flag = re.search(f"{len(name)}{name}IL([bi])([0-9]+)E", mangled)
        if flag and flag.group(1) == "b":
            name += "<true>" if flag.group(2) == "1" else "<false>"
        elif flag:
            name += f"<{flag.group(2)}>"
    return name


def parse_sass(text: str) -> dict:
    """`cuobjdump -sass` output -> {kernel: [copy, ...]} for the kernels of
    KERNELS.  A copy: its "instructions" (every one but NOP, the padding
    after the last branch), "imad" (those on the integer multiply-add pipe:
    IMAD with any suffix, IMAD.MOV included) and "imad_wide" (IMAD.WIDE,
    32 x 32 -> 64 bits), and "parts": the kernel's body, then each device
    function it calls out of line (ptxas puts them after the body in the
    kernel's own code, from each CALL's target address), with the same
    counts and "body_calls", the CALL sites in the body that reach it."""
    out: dict = {}
    copies = []
    for line in text.splitlines():
        m = re.match(r"\s*Function\s*:\s*(\S+)", line)
        if m:
            name = _demangle(m.group(1), KERNELS)
            if name is not None:
                copies.append((name, []))
            else:
                copies.append((None, None))
            continue
        m = re.match(r"\s*/\*([0-9a-fA-F]+)\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9_.]*)(?:\s+(0x[0-9a-fA-F]+))?", line)
        if not copies or copies[-1][1] is None or not m or (
                m.group(2) == "NOP"):
            continue
        target = (int(m.group(3), 16) if m.group(2).startswith("CALL")
                  and m.group(3) else None)
        copies[-1][1].append((int(m.group(1), 16), m.group(2), target))
    for name, ins in copies:
        if name is None:
            continue
        starts = sorted({0} | {t for _, _, t in ins if t is not None})
        parts = [{"address": a, "body_calls": 0, "instructions": 0,
                  "imad": 0, "imad_wide": 0} for a in starts]
        for addr, op, target in ins:
            part = parts[max(i for i, a in enumerate(starts) if a <= addr)]
            part["instructions"] += 1
            part["imad"] += op.startswith("IMAD")
            part["imad_wide"] += op.startswith("IMAD.WIDE")
            if target is not None and part is parts[0]:
                parts[starts.index(target)]["body_calls"] += 1
        copy = {k: sum(p[k] for p in parts)
                for k in ("instructions", "imad", "imad_wide")}
        copy["parts"] = parts
        out.setdefault(name, []).append(copy)
    return out


def sass() -> dict:
    """parse_sass() of the loaded library, through the toolkit's
    cuobjdump (beside nvcc)."""
    lib()
    tool = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    res = subprocess.run([tool, "-sass", library], capture_output=True,
                         text=True, check=True)
    return parse_sass(res.stdout)


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
    global _lib, library, build_seconds, resources
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
    _lib, library = loaded, so
    return _lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def host_lib() -> ctypes.PyDLL:
    """The host library (csrc/host_pack.c, csrc/host_keccak.c), built
    with `cc` on the first call into a file named by a hash of its
    sources, the flags and the Python version.  The packers take
    (sequence, pointer, count) and return the count of values that took
    the long path (ssize_t); reduce_be256 takes (words, count, modulus,
    out) and keccak256 (data, length, out32)."""
    global _host_lib
    if _host_lib is not None:
        return _host_lib
    h = hashlib.sha256()
    for src in HOST_SRCS:
        with open(src, "rb") as f:
            h.update(f.read())
    h.update(" ".join(HOST_FLAGS).encode() + sys.version.encode())
    so = os.path.join(BUILD, f"libhalo2tpu_host_{h.hexdigest()[:12]}.so")
    if not os.path.exists(so):
        os.makedirs(BUILD, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = ["cc", *HOST_FLAGS, f"-I{sysconfig.get_paths()['include']}",
               *HOST_SRCS, "-o", tmp]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"cc failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
        os.replace(tmp, so)
    loaded = ctypes.PyDLL(so)
    for name in ("pack_limbs16", "pack_u16"):
        fn = getattr(loaded, name)
        fn.argtypes = [ctypes.py_object, _P, ctypes.c_ssize_t]
        fn.restype = ctypes.c_ssize_t
    loaded.reduce_be256.argtypes = [_P, ctypes.c_ssize_t, _P, _P]
    loaded.reduce_be256.restype = None
    loaded.keccak256.argtypes = [_P, ctypes.c_size_t, _P]
    loaded.keccak256.restype = None
    _host_lib = loaded
    return _host_lib
