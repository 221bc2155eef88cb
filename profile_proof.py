#!/usr/bin/env python3
"""Time and profile warm k=15 proofs of a halo2tpu_torch tree on one
NVIDIA GPU.

    python3 profile_proof.py [--tree DIR] [--circuit rsa|composite]
    python3 profile_proof.py [--tree DIR] --kernels

Imports halo2tpu_torch from DIR (default: this file's directory), so that
two trees (a commit and its parent, unpacked with `git archive`) can be
compared in one run on one card.  Proves port_circuits.rsa_circuit()
(1024-byte message, pinned key; seed 4) or
port_circuits.composite_circuit() (the composite Aadhaar circuit over the
golden QR; seed 8): setup(15), keygen,
a cold proof, WARM warm proofs with the prover's phase times, then one
more warm proof under torch.profiler.  Prints one JSON line: the card's
name and power limit, the warm proof seconds and every phase's seconds of
each warm proof, the launches of each kernel wrapper the tree counts (per
warm proof) with mont_mul's lane histogram, and from the profiled proof
the CUDA kernels the card ran (the tree's own and torch's; the count and
device ms of each of the tree's own kernels by name), the device busy
share, and the sha256 of the proof bytes (the proof must verify).  On
stderr it prints each warm proof's record, for a tree that keeps one
(halo2tpu_torch/utils/trace.py): the span tree with each span's host,
wait and self seconds, the time outside the top-level spans, and the
counters.  Without CUDA it exits non-zero.

With --kernels it times, instead of a proof, the calls whose kernels a
tree may have changed, at a k=15 proof's shapes, through the tree's own
entry points (so that a commit and its parent compare in one run): the
NTT's coset and h-chunk entries at 2^15 rows x 64, 34 and 1 columns,
fold_horner at 1, 48, 200 and 392 lanes x 32 planes x 8 doublings and 8 x
254 x 1, field_prog on the RSA-SHA256 and the composite part programs at
2^15 rows
(the tree's part_program, random leaves and challenges), add and mont_mul
at 32,768 lanes, and the engine's div_linear (2^15 rows), eval_polys (16
polys of 2^15 rows at one point) and weighted_sum (64 vectors of 2^15
rows), the linear scan itself at the prefix and suffix sums, a
div_linear and that evaluation group, fold_add_tree at the warm proof's
tail shapes (256 x 256, 64 x 1024, 32 x 2048, 96 x 1024) and at 65,536
lanes in groups of 2-128, the engine's grand_products over 80 vectors of
2^15 rows and, for a tree that has it, the product scan over them and
over one Fq column of 255 x 16, 255 x 1024 and 2^22 lanes (keygen's batch
inversions), and for a tree that splits field programs the part programs at every
sub-program count G.  Each is the median of ROUNDS rounds of CUDA-event means (kernels)
or of synchronized wall times (engine calls); one JSON line.

`profile_run` (also used by chip_smoke.py) profiles any call through
portbench/tracing.py's profiler and trace reduction.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import time

from portbench.tracing import profiled, reduce_trace

HERE = os.path.dirname(os.path.abspath(__file__))
WARM = 2


def record_lines(rec) -> list[str]:
    """A proof's record as text: the span tree, each span's host seconds
    (to its synchronize), wait on the device and self seconds (less its
    children), then the wall outside the top-level spans and the
    counters."""
    depth, lines, top = {}, [], 0.0
    for i, s in enumerate(rec.spans):
        depth[i] = 0 if s.parent is None else depth[s.parent] + 1
        child = sum(c.end - c.start for c in rec.spans if c.parent == i)
        if s.parent is None:
            top += s.end - s.start
        lines.append(f"{'  ' * depth[i]}{s.name}: host "
                     f"{s.host_end - s.start:.4f} wait "
                     f"{s.end - s.host_end:.4f} self "
                     f"{s.end - s.start - child:.4f}")
    wall = rec.end - rec.start
    return ([f"proof {rec.request}: wall {wall:.4f} s"] + lines
            + [f"outside the spans {wall - top:.4f}",
               f"counters {json.dumps(dict(rec.counters))}"])


def busy_from_trace(events, names=()) -> dict:
    """Chrome-trace events of one profiled call (portbench/tracing.py::
    profiled) -> the CUDA kernels that ran in it, their device time, the
    share of the call's wall time in which the device ran a kernel, a copy
    or a memset (reduce_trace's busy union), and for each of `names` (the
    port's __global__ functions) its kernels' count and summed device
    ms."""
    red = reduce_trace(events, ())
    kernels = red["kernels"]
    by_name = {}
    for k in names:
        mine = [d for name, d in kernels if re.search(rf"\b{k}\b", name)]
        if mine:
            by_name[k] = {"kernels": len(mine), "ms": sum(mine) * 1e3}
    return {"cuda_kernels": len(kernels), "kernels_by_name": by_name,
            "kernel_ms": sum(d for _, d in kernels) * 1e3,
            "device_busy_ms": red["busy_s"] * 1e3,
            "window_ms": red["window_s"] * 1e3,
            "busy_share": red["busy_s"] / red["window_s"]}


def profile_run(fn):
    """fn() under torch.profiler (CPU and CUDA activity), ended by a CUDA
    synchronize; returns (fn's result, busy_from_trace of its trace)."""
    from halo2tpu_torch._build import KERNELS
    out, events = profiled(fn)
    return out, busy_from_trace(events, KERNELS)


def _wrappers() -> dict:
    """The kernel wrappers of the imported tree that count launches."""
    import importlib
    out = {}
    for mod, names in (("ops.cuda_field", ("mont_mul", "mont_pow",
                                           "add_sub", "linscan", "prodscan")),
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


ROUNDS = 5
# vectors of the grand products timed by --kernels (the composite proof's
# permutation chunks and lookups are about 80)
GP_COLUMNS = 80


def _median_event_ms(fn, iters: int) -> float:
    """Median over ROUNDS of the CUDA-event mean ms of fn() over iters."""
    import statistics
    import torch
    fn()
    times = []
    for _ in range(ROUNDS):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / iters)
    return statistics.median(times)


def _median_wall_ms(fn, iters: int) -> float:
    """Median over ROUNDS of the mean synchronized wall ms of fn()."""
    import statistics
    import torch
    fn()
    times = []
    for _ in range(ROUNDS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / iters * 1e3)
    return statistics.median(times)


def kernel_times(chip_smoke, port_circuits, device="cuda",
                 n: int = 1 << 15) -> dict:
    """The --kernels timings of the imported tree (see the docstring), at
    n rows on `device`."""
    import torch
    from halo2tpu_torch.fields import jfield
    from halo2tpu_torch.ops import cuda_field
    from halo2tpu_torch.ops.field_prog import field_prog
    from halo2tpu_torch.plonk.engine import TorchEngine
    dev = torch.device(device)
    g = torch.Generator().manual_seed(7)
    out = {}
    for case, circuit in (("rsa", port_circuits.rsa_circuit()),
                          ("composite", port_circuits.composite_circuit())):
        prog, by_key, consts, _ = chip_smoke._field_prog_case(circuit, g, n,
                                                              dev)
        leaves = [by_key[k] for k in prog.leaf_keys]
        out[f"field_prog_{case}_part_ms"] = _median_event_ms(
            lambda: field_prog(jfield.FR, prog, leaves, consts, n), 10)
        out[f"field_prog_{case}_part_groups"] = getattr(prog, "groups", 1)
        if hasattr(prog, "groups"):     # a tree that splits programs
            from halo2tpu_torch.fields.bn254 import R
            from halo2tpu_torch.ops.field_prog import G_MAX
            from halo2tpu_torch.plonk.quotient import part_program
            cs_ = port_circuits._configured_cs(circuit)
            for G in range(1, G_MAX + 1):
                p = part_program(cs_, n, groups=G)
                c = jfield.FR.encode([(i * 7919 + 1) % R for i in range(
                    len(p.const_keys))], dev)
                x = [by_key[k] for k in p.leaf_keys]
                out[f"field_prog_{case}_part_ms_by_groups"] = {
                    **out.get(f"field_prog_{case}_part_ms_by_groups", {}),
                    G: _median_event_ms(
                        lambda: field_prog(jfield.FR, p, x, c, n), 10)}
    from halo2tpu_torch.fields.bn254 import fr_root_of_unity
    from halo2tpu_torch.ops import cuda_ec, ntt as tntt
    k = n.bit_length() - 1
    plan = tntt.get_plan(n, fr_root_of_unity(k), dev)
    pre = chip_smoke._rand_fe(g, n, dev)
    for C in (64, 34, 1):
        a = chip_smoke._rand_fe(g, n * C, dev).reshape(n, C, 8)
        iters = 20 if C > 1 else 200
        out[f"ntt_coset_{n}x{C}_ms"] = _median_event_ms(
            lambda: tntt.ntt(plan, a, pre=pre), iters)
        out[f"ntt_inverse_{n}x{C}_ms"] = _median_event_ms(
            lambda: tntt.intt(plan, a, post=pre), iters)
    for B, planes, times in ((1, 32, 8), (48, 32, 8), (200, 32, 8),
                             (392, 32, 8), (8, 254, 1)):
        parts = chip_smoke._rand_points(g, B * planes, dev).reshape(
            B, planes, 3, 8)
        out[f"fold_horner_B{B}_P{planes}_x{times}_ms"] = _median_event_ms(
            lambda: cuda_ec.fold_horner(parts, times), 5)
    x, y = chip_smoke._rand_fe(g, n, dev), chip_smoke._rand_fe(g, n, dev)
    out[f"add_L{n}_ms"] = _median_event_ms(
        lambda: cuda_field.add(jfield.FR, x, y), 2000)
    out[f"mont_mul_L{n}_ms"] = _median_event_ms(
        lambda: cuda_field.mont_mul(jfield.FR, x, y), 2000)

    # the tails, and 65,536 lanes in groups of 2-128 (one round more each:
    # what a round costs)
    for G, W in ((256, 256), (64, 1024), (32, 2048), (96, 1024),
                 *((65536 // w, w) for w in (2, 4, 8, 16, 32, 64, 128))):
        acc = chip_smoke._rand_points(g, G * W, dev)
        out[f"fold_add_tree_{G}x{W}_ms"] = _median_event_ms(
            lambda: cuda_ec.fold_add_tree(acc, G, W), 50)

    class Eng:                       # the engine methods, with no SRS
        _encode = TorchEngine._encode
        _enc_scalar = TorchEngine._enc_scalar
        _wsum = TorchEngine._wsum
        div_linear = TorchEngine.div_linear
        eval_polys = TorchEngine.eval_polys
        weighted_sum = TorchEngine.weighted_sum
        grand_products = TorchEngine.grand_products
        gp_chunk = getattr(TorchEngine, "gp_chunk", None)

        def __init__(self):
            self.device = dev
            self._scalar_cache = {}

    eng = Eng()
    a = 0x1234567890ABCDEF1234567890ABCDEF
    polys = [chip_smoke._rand_fe(g, n, dev) for _ in range(16)]
    vecs = [chip_smoke._rand_fe(g, n, dev) for _ in range(64)]
    coefs = list(range(3, 3 + 64))
    out[f"div_linear_L{n}_ms"] = _median_wall_ms(
        lambda: eng.div_linear(x, a), 20)
    # the linear scan's calls through the tree's own wrapper, CUDA events:
    # the sums, a div_linear and an evaluation group
    stack = torch.stack(polys)
    for name, args in ((f"linscan_prefix_sum_L{n}_ms", (x, 1)),
                       (f"linscan_suffix_sum_L{n}_ms", (x, 1, True)),
                       (f"linscan_div_linear_L{n}_ms", (x, a, True, True)),
                       (f"linscan_eval_16x{n}_ms", (stack, a, True, False,
                                                    True))):
        out[name] = _median_event_ms(
            lambda args=args: cuda_field.linscan(jfield.FR, *args), 200)
    del stack
    out[f"eval_polys_16x{n}_ms"] = _median_wall_ms(
        lambda: eng.eval_polys([(p, a) for p in polys]), 20)
    out[f"weighted_sum_64x{n}_ms"] = _median_wall_ms(
        lambda: eng.weighted_sum(vecs, coefs), 20)
    del polys, vecs
    nums = list(chip_smoke._rand_fe(g, GP_COLUMNS * n, dev).reshape(
        GP_COLUMNS, n, 8))
    dens = list(chip_smoke._rand_fe(g, GP_COLUMNS * n, dev).reshape(
        GP_COLUMNS, n, 8))
    out[f"grand_products_{GP_COLUMNS}x{n}_ms"] = _median_wall_ms(
        lambda: eng.grand_products(nums, dens), 5)
    if hasattr(cuda_field, "prodscan"):
        stack = torch.stack(dens)
        out[f"prodscan_{GP_COLUMNS}x{n}_ms"] = _median_event_ms(
            lambda: cuda_field.prodscan(jfield.FR, stack), 20)
        del stack, nums, dens
        # keygen's batch inversions over Fq (the window tables of k = 4, 10
        # and 15): the exclusive prefix product of one column
        for m in (255 * 16, 255 * 1024, 1 << 22):
            z = chip_smoke._rand_fe(g, m, dev)
            out[f"prodscan_fq_exclusive_L{m}_ms"] = _median_event_ms(
                lambda: cuda_field.prodscan(jfield.FQ, z, exclusive=True),
                200 if m < 1 << 20 else 20)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=HERE)
    ap.add_argument("--circuit", choices=("rsa", "composite"),
                    default="rsa")
    ap.add_argument("--kernels", action="store_true",
                    help="time the kernels' calls instead of a proof")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_proof: CUDA is not available", file=sys.stderr)
        return 1
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, HERE)
    sys.path.insert(0, tree)
    import chip_smoke
    import port_circuits
    from halo2tpu_torch.plonk.engine import TorchEngine
    from halo2tpu_torch.plonk.keygen import keygen
    from halo2tpu_torch.plonk.prover import create_proof
    from halo2tpu_torch.plonk.srs import setup
    from halo2tpu_torch.plonk.verifier import verify_proof
    from halo2tpu_torch.utils import trace
    from halo2tpu_torch.utils.trace import Tracer
    import halo2tpu_torch
    if not halo2tpu_torch.__file__.startswith(tree):
        raise RuntimeError(f"imported {halo2tpu_torch.__file__}, not {tree}")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    if args.kernels:
        print(json.dumps({"tree": tree, "nvidia_smi": smi,
                          **kernel_times(chip_smoke, port_circuits)}))
        return 0
    workdir = os.path.join(tree, ".cache", "profile_proof")
    os.environ["HALO2TPU_CACHE"] = workdir    # no on-disk MSM table
    if args.circuit == "rsa":
        c, seed = port_circuits.rsa_circuit(), 4
    else:
        c, seed = port_circuits.composite_circuit(), 8
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
            tr = Tracer()
            for w in wrappers.values():
                w.launches = 0
                w.shapes.clear()
            t0 = time.perf_counter()
            create_proof(pk, srs, c, inst, rng_seed=seed, engine=eng,
                         tracer=tr)
            warm.append(time.perf_counter() - t0)
            phases.append(dict(tr.phases))
            if hasattr(trace, "recent"):    # a tree that keeps records
                for line in record_lines(trace.recent()[-1]):
                    print("profile_proof: " + line, file=sys.stderr)
        out["warm_proof_s"], out["phases_s"] = warm, phases
        out["launches_per_warm_proof"] = {n: w.launches
                                          for n, w in wrappers.items()}
        out["mont_mul_lanes"] = {str(k[0]): v for k, v in sorted(
            wrappers["mont_mul"].shapes.items())}
        proof, prof = profile_run(
            lambda: create_proof(pk, srs, c, inst, rng_seed=seed,
                                 engine=eng))
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
