#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (halo2tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, run in order, each of which raises on failure (non-zero exit):
  1. build   the card's name and power limit; build the CUDA kernels.
  2. kernels each kernel against its plain torch version, bitwise, at the
             prover's main-path shapes; kernel and plain times.
  3. golden  Square k=4, Timestamp k=6 and RangeHarness k=7 proven with
             TorchEngine(device="cuda"), byte-equal to
             tests/golden/torch_port_proofs.json (made by halo2tpu).
  4. slice   RSA-SHA256 at k=15 (1024-byte message, pinned key): setup,
             keygen, a cold and a warm proof with phase times, verification,
             determinism, every kernel's launch count > 0, peak memory.
The line before the last is the kernels JSON; the last line is
{"ok": true, "device": {...}}.  Without CUDA the script exits non-zero.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


# -- phase 2: kernels against their plain versions ---------------------------

def _timed(fn, iters: int, warmup: int = 2):
    """Mean ms per call of fn() over `iters` calls (CUDA events), after
    `warmup` calls; returns (ms, last result).  Kernel timings use enough
    calls to span tens of milliseconds, past the card's clock ramp."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        out = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters, out


def _max_abs_err(a, b) -> int:
    """Largest |difference| between two int32 limb tensors (0 = equal)."""
    import torch
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def _rand_fe(g, n: int, dev):
    """n random canonical field elements (< 2^252 < q, r) as (n, 8) int32."""
    import torch
    x = torch.randint(-2**31, 2**31, (n, 8), generator=g, dtype=torch.int64)
    x[:, 7] &= 0x0FFFFFFF
    return x.to(torch.int32).to(dev)


def phase_kernels(report: dict) -> None:
    import torch
    from halo2tpu.fields.bn254 import Q, R
    from halo2tpu_torch.fields import jfield
    from halo2tpu_torch.ops import cuda_ec, cuda_field
    from halo2tpu_torch.ops.msm import TABLE_W

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(7)

    def record(name, replaces, source, err, ms, plain_ms, **extra):
        if err != 0:
            raise AssertionError(f"{name}: kernel != plain (max |diff| "
                                 f"{err})")
        report[name] = {"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "max_abs_err": err,
                        "ms": ms, "plain_ms": plain_ms, **extra}
        log(f"kernel {name}: bitwise equal to plain; kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms")

    # mont_mul, Fr and Fq: 2^20 random lanes + every pair of the edge
    # operands.  One kernel and one launch count; ms / plain_ms are Fr's
    n = 1 << 20
    err, times = 0, {}
    for spec, p, fname in ((jfield.FR, R, "fr"), (jfield.FQ, Q, "fq")):
        edge = [p - 1, p - 2, 1, (1 << 254) % p]
        ea = torch.from_numpy(jfield.ints_to_limbs(
            [x for x in edge for _ in edge]).copy())
        eb = torch.from_numpy(jfield.ints_to_limbs(
            [y for _ in edge for y in edge]).copy())
        a = torch.cat([_rand_fe(g, n, dev), ea.to(dev)])
        b = torch.cat([_rand_fe(g, n, dev), eb.to(dev)])
        ms, got = _timed(lambda: cuda_field.mont_mul(spec, a, b), 1000)
        plain_ms, want = _timed(lambda: cuda_field.mont_mul_plain(spec, a, b),
                                3)
        rinv = pow(1 << 256, -1, p)
        edge_got = jfield.limbs_to_ints(got[n:].cpu().numpy())
        if edge_got != [x * y * rinv % p for x in edge for y in edge]:
            raise AssertionError(f"mont_mul {fname}: edge operands wrong")
        err = max(err, _max_abs_err(got, want))
        times[fname] = (ms, plain_ms)
        log(f"mont_mul {fname}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    record("mont_mul", "halo2tpu/ops/pallas_field.py:347",
           "halo2tpu_torch/csrc/mont_mul.cu", err, *times["fr"],
           fq_ms=times["fq"][0], fq_plain_ms=times["fq"][1])

    # fold_mixed at k=15's row step: P=32 planes, B=8, C=256, npad=2^15
    P, B, C, npad = 32, 8, 256, 1 << 15
    L = P * B * C
    fq1 = jfield.FQ.const("one_mont", dev)
    table = torch.empty((TABLE_W, npad, 3, 8), dtype=torch.int32, device=dev)
    for w in range(TABLE_W):
        table[w, :, :2] = _rand_fe(g, 2 * npad, dev).reshape(npad, 2, 8)
        table[w, :, 2] = fq1
    table[0, :, 2] = 0                           # digit 0: identity entries
    scal = _rand_fe(g, B * npad, dev).reshape(B, npad, 8)
    acc = torch.stack([_rand_fe(g, L, dev), _rand_fe(g, L, dev),
                       _rand_fe(g, L, dev)], dim=1)
    # special lanes of row 0 (lane = (plane * B + b) * C + c, base = c)
    from halo2tpu_torch.ops.cuda_ec import window_digits
    digs = window_digits(scal[:, :C], P).reshape(-1)      # (L,) digit
    lane = torch.arange(L, device=dev)
    ent = table[digs, lane % C]                           # gathered points
    special = {"equal": 0, "inverse": 1, "acc_identity": 2}
    for kind, off in special.items():
        sel = lane[(lane % 7 == off) & (digs != 0)][:512]
        if kind == "equal":
            acc[sel, 0], acc[sel, 1], acc[sel, 2] = (
                ent[sel, 0], ent[sel, 1], fq1)
        elif kind == "inverse":
            acc[sel, 0] = ent[sel, 0]
            acc[sel, 1] = jfield.neg(jfield.FQ, ent[sel, 1])
            acc[sel, 2] = fq1
        else:
            acc[sel, 2] = 0
    masked = int((digs == 0).sum())
    if masked == 0:
        raise AssertionError("fold_mixed check has no masked lanes")
    # the main path's launch: all rows of the batch (the special lanes sit
    # in row 0), against one plain run of the same rows
    rows = npad // C
    ms, got = _timed(
        lambda: cuda_ec.fold_mixed(acc, table, scal, C, P, 0, rows), 20)
    plain_ms, want = _timed(
        lambda: cuda_ec.fold_mixed_plain(acc, table, scal, C, P, 0, rows), 1,
        warmup=0)
    row_ms, _ = _timed(
        lambda: cuda_ec.fold_mixed(acc, table, scal, C, P, 0, 1), 500)
    log(f"fold_mixed: {rows} rows in one launch, {masked} masked lanes in "
        f"row 0; one row alone {row_ms:.4f} ms")
    record("fold_mixed", "halo2tpu/ops/pallas_ec.py:218",
           "halo2tpu_torch/csrc/ec_fold.cu", _max_abs_err(got, want), ms,
           plain_ms, rows=rows, one_row_ms=row_ms)
    del table

    # fold_add_any at an unaligned lane count, with identity / inverse /
    # doubling lanes; fold_dbl_any at a window-table-build width
    La = 2 * 32768 + 37
    pa = torch.stack([_rand_fe(g, La, dev) for _ in range(3)], dim=1)
    qa = torch.stack([_rand_fe(g, La, dev) for _ in range(3)], dim=1)
    qa[0:64] = pa[0:64]                                   # doubling
    qa[64:128, 1] = jfield.neg(jfield.FQ, pa[64:128, 1])  # inverse
    qa[64:128, 0], qa[64:128, 2] = pa[64:128, 0], pa[64:128, 2]
    pa[128:192, 2] = 0                                    # p identity
    qa[160:256, 2] = 0                                    # q identity
    ms, got = _timed(lambda: cuda_ec.fold_add_any(pa, qa), 500)
    plain_ms, want = _timed(lambda: cuda_ec.fold_add_any_plain(pa, qa), 3)
    record("fold_add_any", "halo2tpu/ops/pallas_ec.py:341",
           "halo2tpu_torch/csrc/ec_fold.cu", _max_abs_err(got, want), ms,
           plain_ms)
    Ld = 1 << 20
    pd = torch.stack([_rand_fe(g, Ld, dev) for _ in range(3)], dim=1)
    pd[:1024, 2] = 0
    ms, got = _timed(lambda: cuda_ec.fold_dbl_any(pd), 200)
    plain_ms, want = _timed(lambda: cuda_ec.fold_dbl_any_plain(pd), 3)
    record("fold_dbl_any", "halo2tpu/ops/pallas_ec.py:375",
           "halo2tpu_torch/csrc/ec_fold.cu", _max_abs_err(got, want), ms,
           plain_ms)
    torch.cuda.empty_cache()


# -- phase 3: golden proofs --------------------------------------------------

def _range_harness():
    """The lookup-bearing RangeHarness of tests/test_gadgets.py: a 6-bit
    range check of 45 over 4 advice and 2 lookup columns."""
    from halo2tpu.gadgets.flexgate import FlexGateConfig, GateChip
    from halo2tpu.gadgets.range import RangeChip, RangeStrategyConfig
    from halo2tpu.plonk.circuit import Circuit

    class RangeHarness(Circuit):
        def configure(self, cs):
            gcfg = FlexGateConfig.configure(cs, 4)
            return gcfg, RangeStrategyConfig.configure(cs, gcfg, 6, 2)

        def synthesize(self, config, asn):
            gcfg, rcfg = config
            gate = GateChip(gcfg, asn)
            rng = RangeChip(rcfg, gate, asn)
            rng.load_table()
            rng.range_check(gate.load_witness(45), 6)

    return RangeHarness()


def golden_circuits():
    """name -> (circuit, k, instances, rng_seed): the circuits of
    tests/golden/torch_port_proofs.json."""
    from halo2tpu.circuits.signal import SquareCircuit
    from halo2tpu.circuits.timestamp import TimestampCircuit
    sq = SquareCircuit(5)
    rh = _range_harness()
    return {
        "square_k4": (sq, 4, sq.instances(), 11),
        "timestamp_k6": (TimestampCircuit(2023, 7, 8, 12, 34, 56), 6, [], 27),
        "range_k7": (rh, 7, [], 22),
    }


def phase_golden(device="cuda") -> None:
    from halo2tpu.plonk.srs import setup
    from halo2tpu.plonk.verifier import verify_proof
    from halo2tpu_torch.plonk.keygen import keygen
    from halo2tpu_torch.plonk.prover import create_proof
    with open(os.path.join(ROOT, "tests/golden/torch_port_proofs.json")) as f:
        golden = json.load(f)
    for name, (c, k, inst, seed) in golden_circuits().items():
        srs = setup(k)
        t0 = time.perf_counter()
        pk, vk = keygen(c, k, srs, device=device)
        proof = create_proof(pk, srs, c, inst, rng_seed=seed, device=device)
        dt = time.perf_counter() - t0
        if proof.hex() != golden[name]["proof"]:
            raise AssertionError(f"golden {name}: proof bytes differ")
        if not verify_proof(vk, srs, inst, proof):
            raise AssertionError(f"golden {name}: proof does not verify")
        log(f"golden {name}: byte-identical, verifies ({dt:.2f} s keygen + "
            "proof)")


# -- phase 4: the RSA-SHA256 k=15 slice --------------------------------------

def _pkcs1v15_sha256_sign(p: int, q: int, e: int, msg: bytes) -> int:
    """RSASSA-PKCS1-v1_5 SHA-256 signature (RFC 8017 section 8.2.1) with
    the pinned key, in plain integers."""
    n = p * q
    d = pow(e, -1, (p - 1) * (q - 1))
    prefix = bytes.fromhex("3031300d060960864801650304020105000420")
    t = prefix + hashlib.sha256(msg).digest()
    k = (n.bit_length() + 7) // 8
    em = b"\x00\x01" + b"\xff" * (k - len(t) - 3) + b"\x00" + t
    return pow(int.from_bytes(em, "big"), d, n)


def rsa_circuit():
    from halo2tpu.circuits.rsa_sha256 import RSASha256Circuit
    with open(os.path.join(ROOT, "tests/golden/rsa_key_2048.json")) as f:
        key = json.load(f)
    msg = bytes(range(256)) * 4
    sig = _pkcs1v15_sha256_sign(key["p"], key["q"], key["e"], msg)
    return RSASha256Circuit(msg, key["p"] * key["q"], sig)


def phase_slice(report: dict, cache_dir: str) -> None:
    import torch
    from halo2tpu.plonk.srs import setup
    from halo2tpu.plonk.verifier import verify_proof
    from halo2tpu.utils.trace import Tracer
    from halo2tpu_torch.ops import cuda_ec, cuda_field
    from halo2tpu_torch.plonk.engine import TorchEngine
    from halo2tpu_torch.plonk.keygen import keygen_cached
    from halo2tpu_torch.plonk.prover import create_proof

    k = 15
    c = rsa_circuit()
    t0 = time.perf_counter()
    srs = setup(k)
    log(f"slice: setup(15) {time.perf_counter() - t0:.1f} s")

    wrappers = {"mont_mul": cuda_field.mont_mul,
                "fold_mixed": cuda_ec.fold_mixed,
                "fold_add_any": cuda_ec.fold_add_any,
                "fold_dbl_any": cuda_ec.fold_dbl_any}
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pk, vk = keygen_cached(c, k, srs, cache_key="rsa_sha256_chip_smoke",
                           device="cuda", cache_dir=cache_dir)
    kg = time.perf_counter() - t0
    eng = TorchEngine(vk.domain, srs, "cuda")
    log(f"slice: keygen {kg:.1f} s (window table built in this run)")
    t0 = time.perf_counter()
    cold_proof = create_proof(pk, srs, c, c.instances(), rng_seed=3,
                              engine=eng)
    cold = time.perf_counter() - t0
    tr = Tracer("rsa_sha256_proof")
    t0 = time.perf_counter()
    proof = create_proof(pk, srs, c, c.instances(), rng_seed=4, engine=eng,
                         tracer=tr)
    warm = time.perf_counter() - t0
    again = create_proof(pk, srs, c, c.instances(), rng_seed=4, engine=eng)
    launches = {name: w.launches for name, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    phases = {p: round(v, 3) for p, v in tr.phases.items()}
    log(f"slice: cold proof {cold:.2f} s, warm proof {warm:.2f} s")
    log(f"slice: warm phases {json.dumps(phases)}")
    log(f"slice: peak CUDA memory {peak / 2**30:.2f} GiB")
    log(f"slice: launches over keygen + 3 proofs {json.dumps(launches)}")
    if again != proof:
        raise AssertionError("slice: same seed gave different proof bytes")
    if not verify_proof(vk, srs, c.instances(), proof):
        raise AssertionError("slice: warm proof does not verify")
    if not verify_proof(vk, srs, c.instances(), cold_proof):
        raise AssertionError("slice: cold proof does not verify")
    missing = [name for name, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"slice: kernels never launched: {missing}")
    log("slice: proofs verify; same seed, same bytes")
    for name, entry in report.items():
        entry["launches"] = launches[name]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    smi = nvidia_smi()
    log(f"nvidia-smi: {smi}")
    t0 = time.perf_counter()
    from halo2tpu_torch import _build
    _build.lib()
    log(f"build: kernels built and loaded in {time.perf_counter() - t0:.1f} s"
        f" (nvcc {_build.build_seconds:.1f} s)")

    cache_dir = os.path.join(ROOT, ".cache", "chip_smoke")
    shutil.rmtree(cache_dir, ignore_errors=True)
    os.environ["HALO2TPU_CACHE"] = cache_dir      # no on-disk MSM table
    report: dict = {}
    try:
        phase_kernels(report)
        phase_golden()
        phase_slice(report, cache_dir)
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)
    if "jax" in sys.modules:
        raise RuntimeError("the port's run loaded jax")
    log(f"nvidia-smi: {smi}")
    print(json.dumps({"kernels": list(report.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
