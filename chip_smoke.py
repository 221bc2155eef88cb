#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (halo2tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, run in order, each of which raises on failure (non-zero exit):
  1. build   the card's name and power limit; build the CUDA kernels.
  2. kernels each kernel against its plain torch version, bitwise, at the
             main paths' shapes; kernel and plain times beside the bound
             (the least time the card could take for the same work).
  3. golden  Square k=4, Timestamp k=6 and RangeHarness k=7 (the port's
             own circuits) proven with TorchEngine(device="cuda"),
             byte-equal to tests/golden/torch_port_proofs.json (made by
             halo2tpu's HostEngine).
  4. slice   RSA-SHA256 at k=15 (1024-byte message, pinned key): setup,
             keygen, a cold and a warm proof with phase times, verification,
             determinism, launches per warm proof, peak memory.
  5. msm     the bit-serial msm() over the 2^15 Lagrange bases of phase 4's
             SRS, 8 scalar vectors, equal to the windowed commits of the
             same vectors (phase 4's MSMContext) and, at n = 256, to the
             host G1.msm; wall times, peak memory.
The launch counts of phases 4 and 5 are each zeroed just before the phase
and read just after; every kernel of a path must have launched in it.  The
port imports nothing of JAX or of halo2tpu; the script raises if either
was loaded.  The line before the last is the kernels JSON; the last line
is {"ok": true, "device": {...}}.  Without CUDA the script exits non-zero.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3, NVIDIA's data sheet
IMAD_PER_SM_CLOCK = 64        # 32-bit integer multiplies, compute cap. 9.0
# One CIOS Montgomery product (csrc/field.cuh::fe_mul): 8 rounds of 8
# a*b and 8 m*p products of 32 x 32 -> 64 bits, each counted as two 32-bit
# multiplies (its low and high halves), plus one 32-bit m = t0 * inv.  A
# squaring needs only the 36 distinct a_i*a_j of a*a (8 * 9 / 2) beside the
# 64 of the reduction; the bound counts that least work, though
# field.cuh::fe_sqr runs the full product today.
MUL32_PER_MONT = 8 * (8 + 8) * 2 + 8
MUL32_PER_SQR = (36 + 64) * 2 + 8


def _mul32(mults: int, squares: int) -> int:
    return mults * MUL32_PER_MONT + squares * MUL32_PER_SQR


# 32-bit multiplies per lane of the point formulas in csrc/ec_fold.cu
MIXED_ADD = _mul32(7, 4)  # pt_add_mixed (madd-2007-bl), generic lane
MIXED_PRE = _mul32(3, 1)  # pt_add_mixed up to the acc == +-P test
ADD = _mul32(11, 5)       # pt_add (add-2007-bl), generic lane
ADD_PRE = _mul32(6, 2)    # pt_add up to the u1 == u2 test
DBL = _mul32(2, 5)        # pt_dbl (dbl-2009-l)
POINT_BYTES = 96          # (3, 8) int32


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi(query: str = "name,power.limit") -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


class Card:
    """The rates the bound is taken against: HBM bytes/s from the data
    sheet; 32-bit multiplies/s = SMs x 64 per clock x the max SM clock."""

    def __init__(self):
        import torch
        self.sms = torch.cuda.get_device_properties(0).multi_processor_count
        mhz = nvidia_smi("clocks.max.sm").splitlines()[0].split()[0]
        self.sm_hz = float(mhz) * 1e6
        self.mul32_per_s = self.sms * IMAD_PER_SM_CLOCK * self.sm_hz

    def bound(self, nbytes: float, mul32: float) -> dict:
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = mul32 / self.mul32_per_s * 1e3
        return {"bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bound_bytes": nbytes, "bound_mul32": mul32}


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


def _rand_points(g, n: int, dev):
    import torch
    return torch.stack([_rand_fe(g, n, dev) for _ in range(3)], dim=1)


def _add_pairs(La: int, dev, g):
    """(p, q, mul32) for a fold_add check over La lanes: doubling lanes
    0-63, inverse 64-127, p identity 128-191, q identity 160-255, generic
    after; mul32 counts the products these lanes need."""
    from halo2tpu_torch.fields import jfield
    p = _rand_points(g, La, dev)
    q = _rand_points(g, La, dev)
    q[0:64] = p[0:64]                                       # doubling
    q[64:128, 1] = jfield.neg(jfield.FQ, p[64:128, 1])      # inverse
    q[64:128, 0], q[64:128, 2] = p[64:128, 0], p[64:128, 2]
    p[128:192, 2] = 0                                       # p identity
    q[160:256, 2] = 0                                       # q identity
    return p, q, 64 * (ADD_PRE + DBL) + 64 * ADD_PRE + (La - 256) * ADD


def phase_kernels(report: dict, card: Card) -> None:
    import torch
    from halo2tpu_torch.fields import jfield
    from halo2tpu_torch.fields.bn254 import Q, R
    from halo2tpu_torch.ops import cuda_ec, cuda_field
    from halo2tpu_torch.ops.cuda_ec import window_digits
    from halo2tpu_torch.ops.msm import SCALAR_BITS, TABLE_W

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(7)

    def record(name, replaces, source, err, ms, plain_ms, bound, **extra):
        if err != 0:
            raise AssertionError(f"{name}: kernel != plain (max |diff| "
                                 f"{err})")
        report[name] = {"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": 0,
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        **bound, "library_ms": None, **extra}
        log(f"kernel {name}: bitwise equal to plain; kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, bound {bound['bound_ms']:.4f} ms "
            f"({bound['bound_by']})")

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
    lanes = a.shape[0]
    record("mont_mul", "halo2tpu/ops/pallas_field.py:347",
           "halo2tpu_torch/csrc/mont_mul.cu", err, *times["fr"],
           card.bound(3 * lanes * 32, lanes * MUL32_PER_MONT),
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
    acc = _rand_points(g, L, dev)
    # special lanes of row 0 (lane = (plane * B + b) * C + c, base = c)
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
            inverse_lanes = sel
        else:
            acc[sel, 2] = 0
    masked = int((digs == 0).sum())
    if masked == 0:
        raise AssertionError("fold_mixed check has no masked lanes")
    # the work these inputs need: every (lane, row) with a nonzero digit is
    # a generic mixed add, except row 0's acc-identity lanes (no product),
    # equal lanes (the pre-test products, then a doubling) and inverse
    # lanes (the pre-test products only, then an identity acc whose next add
    # takes the point without a product)
    all_digs = window_digits(scal, P)                     # (P, B, npad)
    rows = npad // C
    active = all_digs.reshape(P * B, rows, C).permute(0, 2, 1).reshape(L, rows)
    active = active != 0
    adds = int(active.sum())
    later = int(active[inverse_lanes, 1:].any(dim=1).sum())
    mul32 = ((adds - 1536 - later) * MIXED_ADD + 512 * (MIXED_PRE + DBL)
             + 512 * MIXED_PRE)
    entries = torch.unique(all_digs.to(torch.int64) * npad
                           + torch.arange(npad, device=dev))
    n_entries = int((entries >= npad).sum())              # digit != 0
    fm_bound = card.bound(2 * L * POINT_BYTES + scal.numel() * 4
                          + n_entries * POINT_BYTES, mul32)
    del all_digs, active, entries
    # the main path's launch: all rows of the batch (the special lanes sit
    # in row 0), against one plain run of the same rows
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
           plain_ms, fm_bound, rows=rows, one_row_ms=row_ms)
    del table, got, want
    torch.cuda.empty_cache()

    # fold_mixed_tiled at msm()'s full width: L = 254 * 8 * 256 lanes, one
    # row of C = 256 bases (base 255 the identity), about half the lanes
    # masked; 512 lanes each of equal, inverse and acc-identity
    Bm = 8
    Lt = SCALAR_BITS * Bm * C
    pts_c = _rand_points(g, C, dev)
    pts_c[:, 2] = fq1
    pts_c[C - 1, 2] = 0
    bits = torch.randint(0, 2, (Lt,), generator=g, dtype=torch.uint8).to(dev)
    acc = _rand_points(g, Lt, dev)
    lane = torch.arange(Lt, device=dev)
    live = (bits != 0) & (lane % C != C - 1)
    base = pts_c[lane % C]
    sel = {off: lane[(lane % 7 == off) & live][:512] for off in range(3)}
    acc[sel[0]] = base[sel[0]]                                  # equal
    acc[sel[1]] = base[sel[1]]                                  # inverse
    acc[sel[1], 1] = jfield.neg(jfield.FQ, base[sel[1], 1])
    acc[sel[2], 2] = 0                                          # acc identity
    del base
    live_n = int(live.sum())
    mul32 = ((live_n - 1536) * MIXED_ADD + 512 * (MIXED_PRE + DBL)
             + 512 * MIXED_PRE)
    ms, got = _timed(lambda: cuda_ec.fold_mixed_tiled(acc, pts_c, bits), 200)
    plain_ms, want = _timed(
        lambda: cuda_ec.fold_mixed_tiled_plain(acc, pts_c, bits), 1)
    log(f"fold_mixed_tiled: {Lt} lanes, C = {C}, {Lt - int((bits != 0).sum())}"
        f" masked lanes, {live_n} adds")
    record("fold_mixed_tiled", "halo2tpu/ops/pallas_ec.py:291",
           "halo2tpu_torch/csrc/ec_fold.cu", _max_abs_err(got, want), ms,
           plain_ms, card.bound(2 * Lt * POINT_BYTES + Lt + C * POINT_BYTES,
                                mul32), lanes=Lt, C=C)
    del acc, bits, got, want
    torch.cuda.empty_cache()

    # fold_add at the first tail round of msm() (254 * 8 * 128 lanes, a
    # whole number of 512-lane tiles), with doubling, inverse and identity
    # lanes; an unaligned L is refused
    La = SCALAR_BITS * Bm * C // 2
    pa, qa, mul32 = _add_pairs(La, dev, g)
    ms, got = _timed(lambda: cuda_ec.fold_add(pa, qa), 200)
    plain_ms, want = _timed(lambda: cuda_ec.fold_add_plain(pa, qa), 3)
    try:
        cuda_ec.fold_add(pa[:La - 1], qa[:La - 1])
    except ValueError:
        pass
    else:
        raise AssertionError("fold_add took an unaligned lane count")
    record("fold_add", "halo2tpu/ops/pallas_ec.py:240",
           "halo2tpu_torch/csrc/ec_fold.cu", _max_abs_err(got, want), ms,
           plain_ms, card.bound(3 * La * POINT_BYTES, mul32), lanes=La)

    # fold_add_any at an unaligned lane count, same special lanes;
    # fold_dbl_any at a window-table-build width (no branch: every lane,
    # identity or not, does the doubling's 2 products and 5 squarings)
    La = 2 * 32768 + 37
    pa, qa, mul32 = _add_pairs(La, dev, g)
    ms, got = _timed(lambda: cuda_ec.fold_add_any(pa, qa), 500)
    plain_ms, want = _timed(lambda: cuda_ec.fold_add_any_plain(pa, qa), 3)
    record("fold_add_any", "halo2tpu/ops/pallas_ec.py:341",
           "halo2tpu_torch/csrc/ec_fold.cu", _max_abs_err(got, want), ms,
           plain_ms, card.bound(3 * La * POINT_BYTES, mul32))
    Ld = 1 << 20
    pd = _rand_points(g, Ld, dev)
    pd[:1024, 2] = 0
    ms, got = _timed(lambda: cuda_ec.fold_dbl_any(pd), 200)
    plain_ms, want = _timed(lambda: cuda_ec.fold_dbl_any_plain(pd), 3)
    record("fold_dbl_any", "halo2tpu/ops/pallas_ec.py:375",
           "halo2tpu_torch/csrc/ec_fold.cu", _max_abs_err(got, want), ms,
           plain_ms, card.bound(2 * Ld * POINT_BYTES, Ld * DBL))
    torch.cuda.empty_cache()


# -- launch counts -----------------------------------------------------------

def _wrappers() -> dict:
    from halo2tpu_torch.ops import cuda_ec, cuda_field
    return {"mont_mul": cuda_field.mont_mul,
            "fold_mixed": cuda_ec.fold_mixed,
            "fold_mixed_tiled": cuda_ec.fold_mixed_tiled,
            "fold_add": cuda_ec.fold_add,
            "fold_add_any": cuda_ec.fold_add_any,
            "fold_dbl_any": cuda_ec.fold_dbl_any}


def _zero_counts() -> None:
    for w in _wrappers().values():
        w.launches = 0


def _counts() -> dict:
    return {name: w.launches for name, w in _wrappers().items()}


def _record_path(report: dict, path: str, counts: dict, kernels) -> None:
    """Add one path's counts to the report; every kernel of the path must
    have launched in it."""
    missing = [k for k in kernels if counts[k] == 0]
    if missing:
        raise AssertionError(f"{path}: kernels never launched: {missing}")
    for name, n in counts.items():
        if n:
            entry = report[name]
            entry["launches"] += n
            entry.setdefault("launches_by_path", {})[path] = n


# -- phase 3: golden proofs --------------------------------------------------

def _range_harness():
    """The lookup-bearing RangeHarness of tests/test_gadgets.py: a 6-bit
    range check of 45 over 4 advice and 2 lookup columns."""
    from halo2tpu_torch.gadgets.flexgate import FlexGateConfig, GateChip
    from halo2tpu_torch.gadgets.range import RangeChip, RangeStrategyConfig
    from halo2tpu_torch.plonk.circuit import Circuit

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
    """name -> (circuit, k, instances, rng_seed): the port's circuits of
    tests/golden/torch_port_proofs.json."""
    from halo2tpu_torch.circuits.signal import SquareCircuit
    from halo2tpu_torch.circuits.timestamp import TimestampCircuit
    sq = SquareCircuit(5)
    rh = _range_harness()
    return {
        "square_k4": (sq, 4, sq.instances(), 11),
        "timestamp_k6": (TimestampCircuit(2023, 7, 8, 12, 34, 56), 6, [], 27),
        "range_k7": (rh, 7, [], 22),
    }


def phase_golden() -> None:
    from halo2tpu_torch.plonk.keygen import keygen
    from halo2tpu_torch.plonk.prover import create_proof
    from halo2tpu_torch.plonk.srs import setup
    from halo2tpu_torch.plonk.verifier import verify_proof
    with open(os.path.join(ROOT, "tests/golden/torch_port_proofs.json")) as f:
        golden = json.load(f)
    for name, (c, k, inst, seed) in golden_circuits().items():
        srs = setup(k)
        t0 = time.perf_counter()
        pk, vk = keygen(c, k, srs, device="cuda")
        proof = create_proof(pk, srs, c, inst, rng_seed=seed, device="cuda")
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
    from halo2tpu_torch.circuits.rsa_sha256 import RSASha256Circuit
    with open(os.path.join(ROOT, "tests/golden/rsa_key_2048.json")) as f:
        key = json.load(f)
    msg = bytes(range(256)) * 4
    sig = _pkcs1v15_sha256_sign(key["p"], key["q"], key["e"], msg)
    return RSASha256Circuit(msg, key["p"] * key["q"], sig)


def phase_slice(report: dict, cache_dir: str):
    """Returns (srs, engine) for phase 5."""
    import torch
    from halo2tpu_torch.plonk.engine import TorchEngine
    from halo2tpu_torch.plonk.keygen import keygen_cached
    from halo2tpu_torch.plonk.prover import create_proof
    from halo2tpu_torch.plonk.srs import setup
    from halo2tpu_torch.plonk.verifier import verify_proof
    from halo2tpu_torch.utils.trace import Tracer

    k = 15
    c = rsa_circuit()
    t0 = time.perf_counter()
    srs = setup(k)
    log(f"slice: setup(15) {time.perf_counter() - t0:.1f} s")

    _zero_counts()
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
    before = _counts()
    t0 = time.perf_counter()
    proof = create_proof(pk, srs, c, c.instances(), rng_seed=4, engine=eng,
                         tracer=tr)
    warm = time.perf_counter() - t0
    per_warm = {n: v - before[n] for n, v in _counts().items()}
    again = create_proof(pk, srs, c, c.instances(), rng_seed=4, engine=eng)
    launches = _counts()
    peak = torch.cuda.max_memory_allocated()
    phases = {p: round(v, 3) for p, v in tr.phases.items()}
    log(f"slice: cold proof {cold:.2f} s, warm proof {warm:.2f} s")
    log(f"slice: warm phases {json.dumps(phases)}")
    log(f"slice: peak CUDA memory {peak / 2**30:.2f} GiB")
    log(f"slice: launches over keygen + 3 proofs {json.dumps(launches)}")
    log(f"slice: launches per warm proof {json.dumps(per_warm)}")
    if again != proof:
        raise AssertionError("slice: same seed gave different proof bytes")
    if not verify_proof(vk, srs, c.instances(), proof):
        raise AssertionError("slice: warm proof does not verify")
    if not verify_proof(vk, srs, c.instances(), cold_proof):
        raise AssertionError("slice: cold proof does not verify")
    _record_path(report, "rsa_k15_keygen_and_3_proofs", launches,
                 ("mont_mul", "fold_mixed", "fold_add", "fold_add_any",
                  "fold_dbl_any"))
    for name, n in per_warm.items():
        report[name]["launches_per_warm_proof"] = n
    log("slice: proofs verify; same seed, same bytes")
    return srs, eng


# -- phase 5: the bit-serial msm() -------------------------------------------

def _median_s(fn, runs: int = 3):
    """Median wall seconds of fn() over `runs` calls, each ended by a CUDA
    synchronize; returns (seconds, last result)."""
    import torch
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times), out


def phase_msm(report: dict, srs, eng) -> None:
    import numpy as np
    import torch
    from halo2tpu_torch.curves import g1 as G1
    from halo2tpu_torch.curves.jpoint import affine_to_device
    from halo2tpu_torch.fields.bn254 import R
    from halo2tpu_torch.ops.msm import msm

    n, B = 1 << 15, 8
    rng = np.random.default_rng(15)

    def full(m):
        return [int.from_bytes(rng.bytes(32), "big") % R for _ in range(m)]

    edge = [0] * n
    for i in range(0, n, 997):
        edge[i] = R - 1
        edge[i + 1] = 1
    vectors = ([full(n) for _ in range(B - 3)]
               + [[int(v) for v in rng.integers(0, 256, n)], [0] * n, edge])
    pts = affine_to_device(srs.g_lagrange[:n], "cuda")
    ctx = eng._msm_lagrange                   # phase 4's windowed context
    if ctx.n != n:
        raise AssertionError(f"msm: phase 4's context holds {ctx.n} bases")

    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()  # phase 4's engine, the bases
    _zero_counts()
    got = msm(pts, vectors)                   # the path's launch counts
    launches = _counts()
    peak = torch.cuda.max_memory_allocated()
    want = ctx.commit_batch(vectors)
    if got != want:
        bad = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
        raise AssertionError(f"msm: vectors {bad} differ from the windowed "
                             "commits")
    if got[B - 2] is not None:
        raise AssertionError("msm: the zero vector is not the identity")
    msm_s, _ = _median_s(lambda: msm(pts, vectors))
    win_s, _ = _median_s(lambda: ctx.commit_batch(vectors))
    log(f"msm: n = {n}, B = {B}: equal to the windowed commits; msm() "
        f"{msm_s * 1e3:.1f} ms, windowed commit_batch {win_s * 1e3:.1f} ms "
        "(median of 3 wall times)")
    log(f"msm: peak CUDA memory {peak / 2**30:.2f} GiB, of which "
        f"{resident / 2**30:.2f} GiB was resident before the call")
    log(f"msm: launches {json.dumps(launches)}")
    # mont_mul: device_to_affine's one Montgomery decode
    _record_path(report, "msm_n32768_b8", launches,
                 ("mont_mul", "fold_mixed_tiled", "fold_add", "fold_add_any",
                  "fold_dbl_any"))

    m = 256
    small = [v[:m] for v in vectors]
    got = msm(affine_to_device(srs.g_lagrange[:m], "cuda"), small)
    if got != [G1.msm(srs.g_lagrange[:m], v) for v in small]:
        raise AssertionError("msm: n = 256 differs from the host G1.msm")
    log(f"msm: n = {m}, B = {B}: equal to the host G1.msm")
    report["fold_mixed_tiled"].update(msm_ms=msm_s * 1e3,
                                      windowed_commit_ms=win_s * 1e3,
                                      msm_peak_gib=peak / 2**30,
                                      msm_resident_gib=resident / 2**30)


def _loaded_reference() -> list:
    """Modules of JAX or of the JAX package (halo2tpu) in this process."""
    return sorted(m for m in sys.modules
                  if m in ("jax", "halo2tpu") or m.startswith(("jax.",
                                                               "halo2tpu.")))


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
    card = Card()
    log(f"bound: {card.sms} SMs x {IMAD_PER_SM_CLOCK} x "
        f"{card.sm_hz / 1e6:.0f} MHz = {card.mul32_per_s:.4g} 32-bit "
        f"multiplies/s; {HBM_BYTES_PER_S:.4g} B/s")

    cache_dir = os.path.join(ROOT, ".cache", "chip_smoke")
    shutil.rmtree(cache_dir, ignore_errors=True)
    os.environ["HALO2TPU_CACHE"] = cache_dir      # no on-disk MSM table
    report: dict = {}
    try:
        phase_kernels(report, card)
        phase_golden()
        srs, eng = phase_slice(report, cache_dir)
        phase_msm(report, srs, eng)
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)
    loaded = _loaded_reference()
    if loaded:
        raise RuntimeError(f"the port's run loaded {loaded[:5]}")
    log(f"nvidia-smi: {smi}")
    print(json.dumps({"kernels": list(report.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
