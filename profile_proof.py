#!/usr/bin/env python3
"""Time and profile warm k=15 proofs of a halo2tpu_torch tree on one
NVIDIA GPU.

    python3 profile_proof.py [--tree DIR] [--circuit rsa|composite]

Imports halo2tpu_torch from DIR (default: this file's directory), so that
two trees (a commit and its parent, unpacked with `git archive`) can be
compared in one run on one card.  Proves chip_smoke.rsa_circuit() (1024-
byte message, pinned key; seed 4) or chip_smoke.composite_circuit() (the
composite Aadhaar circuit over the golden QR; seed 8): setup(15), keygen,
a cold proof, WARM warm proofs with the prover's phase times, then one
more warm proof under torch.profiler.  Prints one JSON line: the card's
name and power limit, the warm proof seconds and every phase's seconds of
each warm proof, the launches of each kernel wrapper the tree counts (per
warm proof) with mont_mul's lane histogram, and from the profiled proof
the CUDA kernels the card ran (the tree's own and torch's), the device
busy share, and the sha256 of the proof bytes (the proof must verify).
Without CUDA it exits non-zero.

`profile_run` (also used by chip_smoke.py) profiles any call.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
GPU_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARK = "profiled_call"
WARM = 2


def _union_us(spans) -> float:
    """Total length of the union of (start, end) spans."""
    total, end = 0.0, None
    for s, e in sorted(spans):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def busy_from_trace(events) -> dict:
    """Chrome-trace events of one profiled call (marked MARK) -> the CUDA
    kernels that ran in it, their device time, and the share of the call's
    wall time in which the device ran a kernel, a copy or a memset."""
    mark = next(e for e in events if e.get("name") == MARK
                and e.get("cat") == "user_annotation")
    t0, t1 = mark["ts"], mark["ts"] + mark["dur"]
    gpu = [e for e in events if e.get("cat") in GPU_CATS
           and e["ts"] < t1 and e["ts"] + e.get("dur", 0) > t0]
    kernels = [e for e in gpu if e["cat"] == "kernel"]
    spans = [(max(e["ts"], t0), min(e["ts"] + e.get("dur", 0), t1))
             for e in gpu]
    busy = _union_us(spans)
    return {"cuda_kernels": len(kernels),
            "kernel_ms": sum(e.get("dur", 0) for e in kernels) / 1e3,
            "device_busy_ms": busy / 1e3, "window_ms": (t1 - t0) / 1e3,
            "busy_share": busy / (t1 - t0)}


def profile_run(fn, workdir: str):
    """fn() under torch.profiler (CPU and CUDA activity), ended by a CUDA
    synchronize; returns (fn's result, busy_from_trace of its trace).  The
    trace file is written under workdir and removed."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    os.makedirs(workdir, exist_ok=True)
    path = os.path.join(workdir, f"trace_{os.getpid()}.json")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(MARK):
            out = fn()
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.remove(path)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    return out, busy_from_trace(events)


def _wrappers() -> dict:
    """The kernel wrappers of the imported tree that count launches."""
    import importlib
    out = {}
    for mod, names in (("ops.cuda_field", ("mont_mul", "mont_pow",
                                           "add_sub")),
                       ("ops.field_prog", ("field_prog",)),
                       ("ops.ntt", ("ntt_kernel",)),
                       ("ops.cuda_ec", ("fold_mixed", "fold_add",
                                        "fold_add_any", "fold_add_tree",
                                        "fold_horner", "fold_dbl_any"))):
        try:
            m = importlib.import_module(f"halo2tpu_torch.{mod}")
        except ImportError:
            continue
        for name in names:
            w = getattr(m, name, None)
            if w is not None and hasattr(w, "launches"):
                out[name] = w
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=HERE)
    ap.add_argument("--circuit", choices=("rsa", "composite"),
                    default="rsa")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_proof: CUDA is not available", file=sys.stderr)
        return 1
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, HERE)
    sys.path.insert(0, tree)
    import chip_smoke
    from halo2tpu_torch.plonk.engine import TorchEngine
    from halo2tpu_torch.plonk.keygen import keygen
    from halo2tpu_torch.plonk.prover import create_proof
    from halo2tpu_torch.plonk.srs import setup
    from halo2tpu_torch.plonk.verifier import verify_proof
    from halo2tpu_torch.utils.trace import Tracer
    import halo2tpu_torch
    if not halo2tpu_torch.__file__.startswith(tree):
        raise RuntimeError(f"imported {halo2tpu_torch.__file__}, not {tree}")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    workdir = os.path.join(tree, ".cache", "profile_proof")
    os.environ["HALO2TPU_CACHE"] = workdir    # no on-disk MSM table
    if args.circuit == "rsa":
        c, seed = chip_smoke.rsa_circuit(), 4
    else:
        c, seed = chip_smoke.composite_circuit(), 8
    inst = c.instances()
    out = {"tree": tree, "circuit": args.circuit, "nvidia_smi": smi}
    try:
        t0 = time.perf_counter()
        srs = setup(15)
        pk, vk = keygen(c, 15, srs, device="cuda")
        out["setup_keygen_s"] = time.perf_counter() - t0
        eng = TorchEngine(vk.domain, srs, "cuda")
        t0 = time.perf_counter()
        create_proof(pk, srs, c, inst, rng_seed=3, engine=eng)
        out["cold_proof_s"] = time.perf_counter() - t0
        wrappers = _wrappers()
        warm, phases = [], []
        for _ in range(WARM):
            tr = Tracer("warm")
            for w in wrappers.values():
                w.launches = 0
                w.shapes.clear()
            t0 = time.perf_counter()
            create_proof(pk, srs, c, inst, rng_seed=seed, engine=eng,
                         tracer=tr)
            warm.append(time.perf_counter() - t0)
            phases.append(dict(tr.phases))
        out["warm_proof_s"], out["phases_s"] = warm, phases
        out["launches_per_warm_proof"] = {n: w.launches
                                          for n, w in wrappers.items()}
        out["mont_mul_lanes"] = {str(k[0]): v for k, v in sorted(
            wrappers["mont_mul"].shapes.items())}
        proof, prof = profile_run(
            lambda: create_proof(pk, srs, c, inst, rng_seed=seed,
                                 engine=eng), workdir)
        out["profiled_warm_proof"] = prof
        if not verify_proof(vk, srs, inst, proof):
            raise AssertionError("profile_proof: the proof does not verify")
        out["proof_sha256"] = hashlib.sha256(proof).hexdigest()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
