#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (halo2tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, run in order, each of which raises on failure (non-zero exit):
  1. build   the card's name and power limit; build the CUDA kernels (one
             nvcc a source, in parallel) and print each kernel's registers
             and spills as ptxas reports them (at most MAX_REGISTERS, no
             spill) and its SASS instruction counts (cuobjdump), from
             which fold_add's instruction bound is taken after phase 2.
  2. kernels each kernel against its plain torch version, bitwise, at the
             main paths' shapes (fe_pow at 1, 16, 80 and 4,097 lanes with
             exponents 0, 1, 2 and p - 2, Fr and Fq, timed at 1, 80 and
             4,097 lanes; field_prog on the
             RSA-SHA256 and the composite part programs at 2^15 rows,
             split into sub-programs as the prover compiles them, also
             against the per-op route it replaces, at most
             1/FIELD_PROG_OVER_CHAIN of its time at the RSA part, and
             timed beside the one-program kernel (G = 1); the weighted
             sum program over 64 vectors against its mont_mul and
             tree-sum chain; field_linscan at n = 1, 3, 1000 and 2^20
             (the sum, a multiplier and the product scan, every
             direction and output, one launch a call) and the product
             scan over Fr and Fq at odd n, one column and 80, timed at a
             div_linear of 2^15 rows, an evaluation group of 16 x 2^15,
             the suffix and prefix sums, the grand products' product
             scans over 80 columns of 2^15 rows (each against the chain
             it replaces, and at runs of 4, 16 and 64 beside the rule's
             32), keygen's batch inversions over Fq (the exclusive
             product scan of 255 x 16, 255 x 1024 and 2^22 lanes, also at
             the run the rule did not pick, 4 or 32) and 2^20 rows; the
             NTT's
             forward, inverse, coset and h-chunk entries at n = 2^4-2^10
             with C = 1, 3, 8 columns and batch-less, and (timed) at n =
             2^15 with C = 64, 60, 34 and 1, 2^10 x 3 and 2^20 x 1; add /
             sub / neg over Fr and Fq at
             the edge values and broadcast operands, timed at 32,768 and
             2^20 lanes and a 64-column stack plus a per-row operand;
             fold_mixed at the three widths of a k=15 commit,
             fold_dbl_any at 2^20 lanes once and 16 lanes 8 times,
             fold_add at msm()'s and a warm proof's widths, fold_add_tree
             at the warm proof's four tail shapes and msm()'s (one tree
             launch each; also with the switch to four threads an add a
             round earlier and later) and at one group of 2 and 65,536,
             fold_horner at both Horner combines (B = 8 x 32 planes x 8
             doublings and 254 x 1) and at the proofs' lane counts 1, 48,
             200 and 392, fold_mixed_tiled_rows at
             msm()'s full shape); kernel times as the median, min and max of
             3 rounds timed in turns, plain times, and the bound (the least
             time the card could take for the same work; beside it for
             fe_pow, fold_horner and fold_add_tree the latency floor,
             their critical path of dependent squarings and products at
             the latency of one, which the mont_chain probe measures at
             one lane).  The tree, Horner and scan entries and the
             one-lane fe_pow are also timed against the chains of
             launches they replace, and must not be slower;
             msm()'s tail also in one tree launch (the route ADD_WAVE is
             held against).
  3. golden  Square k=4, Timestamp k=6, RangeHarness k=7, Identity k=4,
             Nullifier k=10 (degree 6: 8 quotient parts) and the QR
             extractor harness k=8 (pair lookups over advice tables), the
             port's own circuits, proven with TorchEngine(device="cuda"),
             byte-equal to tests/golden/torch_port_proofs.json (made by
             halo2tpu's HostEngine).
  4. slice   RSA-SHA256 at k=15 (1024-byte message, pinned key): setup,
             keygen, a cold and a warm proof with phase times, verification,
             determinism, launches and kernel shapes per warm proof (no
             windowed fold_mixed launch under ops/msm.py's LANE_TARGET
             lanes unless it is one row; at most ADD_LAUNCHES_PER_PROOF
             launches of the add kernel's entries and no fold_dbl_any; one
             field_prog launch a quotient part, counted apart from the
             weighted-sum programs; at most MONT_MUL_ONE_LANE_PER_PROOF
             one-lane mont_mul and ADDSUB_PER_PROOF field_addsub launches;
             FE_POW_PER_PROOF fe_pow launch and at most
             GRAND_PRODUCT_LAUNCHES launches of the port's kernels in
             the grand products; no run of the plain NTT loop, the plain
             scans, the blocked prefix-product routes or the
             field-program interpreter on the card), peak memory; one more
             warm proof under torch.profiler (every CUDA kernel the card
             ran and the device busy share, profile_proof.profile_run);
             the warm proof's sha256, held to RSA_PROOF_SHA256; the
             field programs the warm proof ran (its part, compressions and
             weighted sums) at its row counts, bitwise against the
             interpreter.
  5. msm     the bit-serial msm() over the 2^15 Lagrange bases of phase 4's
             SRS, 8 scalar vectors, equal to the windowed commits of the
             same vectors (phase 4's MSMContext) and, at n = 256, to the
             host G1.msm; wall times, peak memory; one row-fold launch, at
             most ADD_LAUNCHES_PER_MSM add-kernel launches, no fold_dbl_any.
  6. composite  the composite Aadhaar circuit (RSA-SHA256, QR extraction,
             Poseidon nullifier, reveal flags, timestamp, signal) at the
             default AadhaarParams, k=15, over the full 1137-byte golden
             QR (700 bytes signed with the pinned key), on phase 4's SRS:
             instances against the native outputs, keygen, a cold and two
             warm proofs with phase times (same seed, same bytes), one more
             under torch.profiler, verification, a tampered nullifier seed
             rejected, launches and shapes per warm proof (one field_prog
             launch for each of the 8 quotient parts, the grand
             products' launches and fe_pow as in phase 4, no run of a
             plain loop on the card), the part program's size, the part
             cache's bytes, peak memory and the sha256, held to
             COMPOSITE_PROOF_SHA256; its field programs checked as in
             phase 4.
  7. sharded  the multi-device prover (plonk/sharded.py, parallel/*) on
             D shards of cuda:0: the flat four-step at 2^15 x 1 and 2^18
             (the composite's extended domain), forward and inverse, D =
             1, 2, 4, 8, bitwise equal to one ntt call and timed beside
             it; the sharded MSM at phase 5's inputs (D = 4) against
             msm(); the prove core at n1 = 128, n2 = 256, D = 4 against
             the single-device NTT, gate and MSM; the golden circuits at
             D = 2 and 4 byte-equal to the golden file; RSA-SHA256 k=15
             on ShardedTorchEngine with D = 4 shards of cuda:0 (phase 4's
             pk and SRS): a cold and a warm proof, one more under
             torch.profiler, launches by kernel beside TorchEngine's,
             verification and the sha256, held to RSA_PROOF_SHA256; no
             plain loop on the card; then every kernel of that warm proof
             at each shape it launched it with (the shard's row counts,
             the four-step's 128- and 256-point lines, the fold lanes
             and tail trees of the commits), on new random inputs,
             bitwise against its plain version; with more than one card the
             four-step and Timestamp k=6 again with one shard a card; the
             scaling report (parallel/scaling_report.py) as one line.
             Shards of one card measure the sharding's mechanics, not a
             speed-up.
  8. mock    the mock prover (plonk/mock.py) on the card at k=15:
             RSA-SHA256 and the composite satisfied (MockProver.run, each
             part's wall time: synthesis, the column encoding, gates,
             copies, lookups), RSA with MOCK_TAMPER written after
             synthesis equal to tests/golden/mock_k15_failures.json
             (halo2tpu's list), the composite with nullifier_seed ^ 1
             failing; field_prog launches and shapes, no plain loop on
             the card, and mont_mul at every lane count it ran (a
             product and a squaring) and every field program it ran at
             2^15 rows, each bitwise against its plain version.
The launch counts of phases 4, 5, 6, 7 (its RSA proofs) and 8 are each
zeroed just before the path and read just after; every kernel of a path
must have launched in it.  The port imports nothing of JAX or of
halo2tpu; the script raises if either was loaded.  The line before the last is the kernels JSON; the last
line is {"ok": true, "device": {...}}.  Without CUDA the script exits
non-zero.
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
ISSUE_PER_SM_CLOCK = 4        # warp instructions: one a scheduler a clock
# One CIOS Montgomery product (csrc/field.cuh::fe_mul): 8 rounds of 8
# a*b and 8 m*p products of 32 x 32 -> 64 bits, each counted as two 32-bit
# multiplies (its low and high halves), plus one 32-bit m = t0 * inv.  A
# squaring (field.cuh::fe_sqr) takes only the 36 distinct a_i*a_j of a*a
# (28 cross products and 8 squares) beside the 64 of the reduction.
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
# registers a thread of any kernel may take (4 blocks of 128 threads an SM),
# with no spills
MAX_REGISTERS = 128
# launches of the add kernel's entries (fold_add, fold_add_any,
# fold_add_tree, fold_horner) allowed per warm RSA k=15 proof and per msm()
ADD_KERNEL = ("fold_add", "fold_add_any", "fold_add_tree", "fold_horner")
ADD_LAUNCHES_PER_PROOF = 100
ADD_LAUNCHES_PER_MSM = 4
# field_prog at the RSA part takes at most this fraction of the per-op
# route it replaces; a warm RSA k=15 proof launches it once a quotient part
# and mont_mul at one lane at most MONT_MUL_ONE_LANE_PER_PROOF times
FIELD_PROG_OVER_CHAIN = 20
MONT_MUL_ONE_LANE_PER_PROOF = 500
# launches of the port's kernels allowed in TorchEngine.grand_products a
# warm proof (three product scans, four mont_mul and one fe_pow), and the
# fe_pow launches a warm proof makes (the grand products' one inversion)
GRAND_PRODUCT_LAUNCHES = 10
FE_POW_PER_PROOF = 1
# field_addsub launches allowed per warm RSA k=15 proof: the lanewise
# numerators, SHPLONK's adds and the h fold (the scans and tree sums that
# were most of them run as field_linscan and field programs)
ADDSUB_PER_PROOF = 150
SOURCES = {"mont_mul": "halo2tpu_torch/csrc/mont_mul.cu",
           "fe_pow": "halo2tpu_torch/csrc/mont_mul.cu",
           "field_prog": "halo2tpu_torch/csrc/field_prog.cu",
           "ntt": "halo2tpu_torch/csrc/ntt.cu",
           "field_addsub": "halo2tpu_torch/csrc/field_addsub.cu",
           "field_linscan": "halo2tpu_torch/csrc/field_linscan.cu",
           "prodscan": "halo2tpu_torch/csrc/field_linscan.cu"}
# the proofs' bytes at their seeds (RSA-SHA256 k=15, seed 4; the composite
# k=15, seed 8), unchanged since the kernels that prove them were ported.
# halo2tpu's HostEngine proof of the RSA circuit at the same seed has the
# same sha256 (tests/golden/rsa_k15_host_proof.json, which
# tests/test_torch_rsa_golden.py holds to this pin)
RSA_PROOF_SHA256 = ("2567c205a68a04a28dbd9df0fc0d98e9"
                    "7a3589709dfd10e98b87a76f3b2cbeb9")
# the message rsa_circuit signs
RSA_MESSAGE = bytes(range(256)) * 4
COMPOSITE_PROOF_SHA256 = ("d7ee4f98ff4892a518e5757eda473410"
                          "864e3126f606cb9a17a2c3f51361afa1")
# phase 8's tamper of rsa_circuit()'s witness, (advice column, row, value)
# written after synthesis: a gate cell that is also copied (a gate and
# two copy failures) and row 0 of range_48's lookup column, far outside
# its table (a lookup and a copy failure).  halo2tpu's MockProver gives
# tests/golden/mock_k15_failures.json for it
MOCK_TAMPER = ((0, 100, 7), (48, 0, 1 << 200))


def log(msg: str) -> None:
    print(msg, flush=True)


def _issue_bound(sass: dict, card: "Card", lanes: int) -> dict:
    """The least time fold_add's instructions take at `lanes` lanes, from
    its SASS counts (phase 1): a generic lane runs the kernel's body once
    (its untaken branches counted too; fe_sqr is inlined there) and the
    function the body calls most, fe_mul, at each of its call sites.
    issue_ms: every instruction at ISSUE_PER_SM_CLOCK warp instructions an
    SM a clock; imad_ms: the IMAD ones at IMAD_PER_SM_CLOCK / 32.  Both at
    the max SM clock, so both are lower bounds."""
    body, *called = sass["fold_add_kernel"][0]["parts"]
    mul = max(called, key=lambda p: p["body_calls"])
    per_lane = {k: body[k] + mul["body_calls"] * mul[k]
                for k in ("instructions", "imad", "imad_wide")}
    warps = -(-lanes // 32)
    clocks = card.sms * card.sm_hz
    return {"sass_per_lane": per_lane, "fe_mul_calls": mul["body_calls"],
            "issue_ms": warps * per_lane["instructions"]
            / (clocks * ISSUE_PER_SM_CLOCK) * 1e3,
            "imad_ms": warps * per_lane["imad"]
            / (clocks * IMAD_PER_SM_CLOCK / 32) * 1e3}


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


ROUNDS = 3   # kernel timings: this many rounds, every case once a round


def _time_in_turns(cases: dict) -> dict:
    """cases: name -> (fn, iters).  Times each case once a round, in turns
    across cases, ROUNDS rounds; returns name -> {ms (median), ms_min,
    ms_max}."""
    runs: dict = {name: [] for name in cases}
    for _ in range(ROUNDS):
        for name, (fn, iters) in cases.items():
            runs[name].append(_timed(fn, iters)[0])
    return {name: {"ms": statistics.median(v), "ms_min": min(v),
                   "ms_max": max(v)} for name, v in runs.items()}


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


def _mixed_case(g, table, scal, P: int, C: int, card: "Card"):
    """(acc, bound) for a fold_mixed check of P planes over the B scalar
    vectors `scal` at width C, all npad // C rows.  Row 0 holds 512 lanes
    each whose acc equals, negates or lacks (identity) its entry; lanes
    with digit 0 in a row are masked there."""
    import torch
    from halo2tpu_torch.fields import jfield
    from halo2tpu_torch.ops.cuda_ec import window_digits
    B, npad = scal.shape[0], scal.shape[1]
    L, rows = P * B * C, npad // C
    dev = table.device
    fq1 = jfield.FQ.const("one_mont", dev)
    acc = _rand_points(g, L, dev)
    digs = window_digits(scal[:, :C], P).reshape(-1)      # (L,) row-0 digit
    if not bool((digs == 0).any()):
        raise AssertionError(f"fold_mixed P{P} C{C}: no masked lane in row 0")
    lane = torch.arange(L, device=dev)
    ent = table[digs, lane % C]                           # gathered points
    for off in range(3):
        sel = lane[(lane % 7 == off) & (digs != 0)][:512]
        if off == 0:                                      # equal
            acc[sel, 0], acc[sel, 1], acc[sel, 2] = (
                ent[sel, 0], ent[sel, 1], fq1)
        elif off == 1:                                    # inverse
            acc[sel, 0] = ent[sel, 0]
            acc[sel, 1] = jfield.neg(jfield.FQ, ent[sel, 1])
            acc[sel, 2] = fq1
            inverse_lanes = sel
        else:                                             # acc identity
            acc[sel, 2] = 0
    # the work these inputs need: every (lane, row) with a nonzero digit is
    # a generic mixed add, except row 0's acc-identity lanes (no product),
    # equal lanes (the pre-test products, then a doubling) and inverse
    # lanes (the pre-test products only, then an identity acc whose next add
    # takes the point without a product)
    all_digs = window_digits(scal, P)                     # (P, B, npad)
    active = all_digs.reshape(P * B, rows, C).permute(0, 2, 1).reshape(L, rows)
    active = active != 0
    adds = int(active.sum())
    later = int(active[inverse_lanes, 1:].any(dim=1).sum())
    mul32 = ((adds - 1536 - later) * MIXED_ADD + 512 * (MIXED_PRE + DBL)
             + 512 * MIXED_PRE)
    entries = torch.unique(all_digs.to(torch.int64) * npad
                           + torch.arange(npad, device=dev))
    n_entries = int((entries >= npad).sum())              # digit != 0
    bound = card.bound(2 * L * POINT_BYTES + scal.numel() * 4
                       + n_entries * POINT_BYTES, mul32)
    return acc, bound


def _tree_case(g, G: int, W: int, dev):
    """(acc, mul32) for a fold_add_tree check of G groups of W lanes: group
    0 holds a doubling pair (lanes 0 and W/2), an inverse pair (1 and 1 +
    W/2), an identity p (lane 2) and an identity q (3 + W/2).  mul32 counts
    the products these lanes need: W - 1 adds a group, generic but for
    those four and the second-round add of the inverse pair's identity."""
    from halo2tpu_torch.fields import jfield
    acc = _rand_points(g, G * W, dev)
    h = W // 2
    acc[h] = acc[0]                                       # doubling
    acc[1 + h] = acc[1]                                   # inverse
    acc[1 + h, 1] = jfield.neg(jfield.FQ, acc[1, 1])
    acc[2, 2] = 0                                         # p identity
    acc[3 + h, 2] = 0                                     # q identity
    return acc, (G * (W - 1) - 5) * ADD + (ADD_PRE + DBL) + ADD_PRE


def _tree_chain(W: int) -> dict:
    """fold_add_tree's critical path at width W: one add a round, each a
    squaring and four products on the slot schedule (ec_fold.cu::
    tree_add4; a one-thread round's pt_add is longer)."""
    rounds = W.bit_length() - 1
    return {"squarings": rounds, "products": 4 * rounds}


def _horner_case(g, B: int, P: int, times: int, dev):
    """(partials, mul32, chain) for a fold_horner check: (B, P, 3, 8)
    random points; lane 1's partials all the identity, lane 2's top 3
    planes and every fifth plane (lane 0 has none).  mul32: every doubling
    (no branch), and an add for each identity-free partial after a lane's
    first (the first add, onto the identity, and adds of an identity
    partial take no product).  chain: the squarings and products on the
    longest lane's critical path (pt_dbl: b = Y^2, c or (X + b)^2, e (d -
    X3); pt_add: Y1 Z2, S1, r^2, r (v - X3))."""
    parts = _rand_points(g, B * P, dev).reshape(B, P, 3, 8)
    if B > 1:
        parts[1, :, 2] = 0
    if B > 2:
        parts[2, -3:, 2] = 0
        parts[2, ::5, 2] = 0
    live = (parts[:, :, 2] != 0).any(dim=-1).sum(dim=1)       # (B,)
    adds = int((live - 1).clamp(min=0).sum())
    most = max(int(live.max()) - 1, 0)
    chain = {"squarings": P * times * 2 + most, "products": P * times + 3 * most}
    return parts, B * P * times * DBL + adds * ADD, chain


LATENCY_STEPS = 4000


class _Latency:
    """The latency of one dependent Montgomery product and of a squaring on
    the card, the unit of the latency floors: one lane of the mont_chain
    probe (cuda_field.mont_chain, over Fq; Fr's code is the same) timed at
    LATENCY_STEPS // 4 and LATENCY_STEPS // 4 + LATENCY_STEPS steps, the
    difference over LATENCY_STEPS (the launch cancels); and the rate of
    independent products at 1,024 lanes an SM, the same way."""

    def __init__(self, card: "Card", dev, g):
        from halo2tpu_torch.fields.jfield import FQ
        from halo2tpu_torch.ops.cuda_field import mont_chain, mont_chain_plain
        x, y = _rand_fe(g, 2, dev), _rand_fe(g, 2, dev)
        for sq in (False, True):
            err = _max_abs_err(mont_chain(FQ, x, y, 5, sq),
                               mont_chain_plain(FQ, x, y, 5, sq))
            if err:
                raise AssertionError(f"mont_chain (square={sq}): kernel != "
                                     f"plain ({err})")

        def per_step_ms(xx, yy, sq, s0, s1):
            t = [statistics.median(
                _timed(lambda n=n: mont_chain(FQ, xx, yy, n, sq), 3)[0]
                for _ in range(3)) for n in (s0, s1)]
            return (t[1] - t[0]) / (s1 - s0)

        lo = LATENCY_STEPS // 4
        self.mul_us = per_step_ms(x[:1], y[:1], False, lo,
                                  lo + LATENCY_STEPS) * 1e3
        self.sqr_us = per_step_ms(x[:1], y[:1], True, lo,
                                  lo + LATENCY_STEPS) * 1e3
        self.rate_lanes = card.sms * 1024
        xs, ys = _rand_fe(g, self.rate_lanes, dev), _rand_fe(
            g, self.rate_lanes, dev)
        self.rate_per_s = self.rate_lanes / (
            per_step_ms(xs, ys, False, 200, 1000) / 1e3)

    def floor(self, bound: dict, chain: dict) -> dict:
        """bound (Card.bound's: bytes or operations) with the chain's
        latency floor beside it: its squarings and products in sequence."""
        ms = (chain["squarings"] * self.sqr_us
              + chain["products"] * self.mul_us) / 1e3
        return {**bound, "latency_floor_ms": ms, "floor_chain": chain}

    def summary(self) -> dict:
        return {"product_us": self.mul_us, "squaring_us": self.sqr_us,
                "rate_lanes": self.rate_lanes,
                "products_per_s": self.rate_per_s}


def _rows_case(g, B: int, C: int, card: "Card", dev, n: int = 1 << 15):
    """(acc, points, scalars, bound, extra) for a fold_mixed_tiled_rows
    check over n bases (msm()'s 2^15 by default; base n - 1 the identity), B
    random scalar vectors (bits 252-253 clear), 254 * B * C lanes.  512
    lanes each whose acc equals, negates or lacks (identity) the base of
    their first live row (bit set, base not the identity).  The bound
    counts a mixed add per live (lane, row), the pre-test products and a
    doubling for equal lanes, the pre-test products for inverse lanes (whose
    next live row then costs nothing), none for the identity lanes' first
    add; extra holds the live adds and the adds that warps run (32 x their
    busiest lane's count, summed)."""
    import torch
    from halo2tpu_torch.fields import jfield
    from halo2tpu_torch.ops.msm import SCALAR_BITS
    rows = n // C
    points = _rand_points(g, n, dev)
    points[:, 2] = jfield.FQ.const("one_mont", dev)
    points[n - 1, 2] = 0
    scalars = _rand_fe(g, B * n, dev).reshape(B, n, 8)
    L = SCALAR_BITS * B * C
    acc = _rand_points(g, L, dev)
    lane = torch.arange(L, device=dev)
    c = lane % C
    bit, b = (lane // C) // B, (lane // C) % B
    first = torch.full((L,), -1, dtype=torch.int64, device=dev)
    count = torch.zeros(L, dtype=torch.int64, device=dev)
    for r in range(rows - 1, -1, -1):
        word = scalars[b, r * C + c, bit // 32].to(torch.int64) & 0xFFFFFFFF
        live = (((word >> (bit % 32)) & 1) == 1) & (points[r * C + c, 2]
                                                   != 0).any(dim=-1)
        first = torch.where(live, r, first)
        count += live
    base = points[(first * C + c).clamp(min=0)]
    sel = {off: lane[(lane % 7 == off) & (first >= 0)][:512]
           for off in range(3)}
    acc[sel[0]] = base[sel[0]]                                  # equal
    acc[sel[1]] = base[sel[1]]                                  # inverse
    acc[sel[1], 1] = jfield.neg(jfield.FQ, base[sel[1], 1])
    acc[sel[2], 2] = 0                                          # identity
    adds = int(count.sum())
    later = int((count[sel[1]] > 1).sum())
    mul32 = ((adds - 1536 - later) * MIXED_ADD + 512 * (MIXED_PRE + DBL)
             + 512 * MIXED_PRE)
    bound = card.bound(2 * L * POINT_BYTES + scalars.numel() * 4
                       + n * POINT_BYTES, mul32)
    warp_adds = 32 * int(count.reshape(-1, 32).max(dim=1).values.sum())
    return acc, points, scalars, bound, {"adds": adds, "warp_adds": warp_adds}


def _chain_case(cases: dict, name: str, fn, want, iters: int) -> None:
    """Queue fn(), the chain of launches an entry replaces, for the timing
    rounds after holding its result bitwise to the entry's (`want`)."""
    err = _max_abs_err(fn(), want)
    if err != 0:
        raise AssertionError(f"{name}: the chain != the entry (max |diff| "
                             f"{err})")
    cases[name] = (fn, iters)


# -- the per-op route a quotient part took before field_prog ----------------
# (the chain of launches that phase 2 holds the field_prog kernel against:
# each gate poly, rule and compression one field op a launch, then the
# engine's weighted y-reduction and the 1 / Z_H scale)

def _op_l0_one_minus_z(jf, FR, l0, z):
    return jf.mont_mul(FR, l0, jf.sub(FR, jf.one_like(FR, z), z))


def _op_llast_zz(jf, FR, l_last, z):
    return jf.mont_mul(FR, l_last, jf.sub(FR, jf.mont_mul(FR, z, z), z))


def _op_perm_product(jf, FR, z, l_active, cvals, sigmas, bds, beta, gamma,
                     wq):
    import torch
    lhs, rhs = torch.roll(z, -1, 0), z
    for c, s, bd in zip(cvals, sigmas, bds):
        t1 = jf.add(FR, c, jf.mont_mul(FR, s, beta))
        lhs = jf.mont_mul(FR, lhs, jf.add(FR, t1, gamma))
        t2 = jf.add(FR, c, jf.mont_mul(FR, wq, bd))
        rhs = jf.mont_mul(FR, rhs, jf.add(FR, t2, gamma))
    return jf.mont_mul(FR, jf.sub(FR, lhs, rhs), l_active)


def _op_lookup_rules(jf, FR, zc, ac, sc, comp_in, comp_tb, l0, l_last,
                     l_active, beta, gamma):
    import torch
    v1 = _op_l0_one_minus_z(jf, FR, l0, zc)
    v2 = _op_llast_zz(jf, FR, l_last, zc)
    z_next, a_prev = torch.roll(zc, -1, 0), torch.roll(ac, 1, 0)
    lhs = jf.mont_mul(FR, z_next, jf.mont_mul(
        FR, jf.add(FR, ac, beta), jf.add(FR, sc, gamma)))
    rhs = jf.mont_mul(FR, zc, jf.mont_mul(
        FR, jf.add(FR, comp_in, beta), jf.add(FR, comp_tb, gamma)))
    v3 = jf.mont_mul(FR, jf.sub(FR, lhs, rhs), l_active)
    a_minus_s = jf.sub(FR, ac, sc)
    v4 = jf.mont_mul(FR, l0, a_minus_s)
    v5 = jf.mont_mul(FR, jf.mont_mul(FR, a_minus_s, jf.sub(FR, ac, a_prev)),
                     l_active)
    return v1, v2, v3, v4, v5


def _op_engine(device):
    """The TorchEngine methods the per-op route calls, with no SRS."""
    from halo2tpu_torch.plonk.engine import TorchEngine

    class OpEngine:
        _encode = TorchEngine._encode
        _enc_scalar = TorchEngine._enc_scalar
        _wsum = TorchEngine._wsum
        weighted_sum = TorchEngine.weighted_sum
        scale = TorchEngine.scale
        add = TorchEngine.add

        def __init__(self):
            self.device = device
            self._scalar_cache = {}

    return OpEngine()


def per_op_part(eng, cs, n: int, leaf, ch: dict, zh_inv: int):
    """A quotient part's hv / Z_H the way the prover computed it before
    field_prog: leaf(key) gives the part's vectors under the part
    program's leaf keys (plonk/quotient.py)."""
    import torch
    from halo2tpu_torch.fields import jfield as jf
    from halo2tpu_torch.fields.bn254 import FR_DELTA, R
    from halo2tpu_torch.fields.jfield import FR
    from halo2tpu_torch.plonk.quotient import _perm_layout, _val_fn_for

    def value(expr):
        fn, leaves = _val_fn_for(expr)
        return fn(*[eng._enc_scalar(v) if kind == "const" else leaf((kind, v))
                    for kind, v in leaves])

    def compress(exprs):
        vals = [value(e) for e in exprs]
        k = len(vals)
        return vals[0] if k == 1 else eng.weighted_sum(
            vals, [pow(ch["theta"], k - 1 - i, R) for i in range(k)])

    l0, l_last, l_active = (leaf((k,)) for k in ("l0", "l_last", "l_active"))
    beta_e, gamma_e = eng._enc_scalar(ch["beta"]), eng._enc_scalar(ch["gamma"])
    values = [value(poly) for gate in cs.gates for poly in gate.polys]
    chunks = _perm_layout(cs)
    if chunks:
        b = cs.blinding_factors()
        perm_cols = cs.permutation_columns
        zs = [leaf(("z", j)) for j in range(len(chunks))]
        values.append(_op_l0_one_minus_z(jf, FR, l0, zs[0]))
        values.append(_op_llast_zz(jf, FR, l_last, zs[-1]))
        for j in range(1, len(chunks)):
            prev = torch.roll(zs[j - 1], -((-(b + 1)) % n), 0)
            values.append(jf.mont_mul(FR, l0, jf.sub(FR, zs[j], prev)))
        gidx = 0
        for j, chunk in enumerate(chunks):
            bds = [eng._enc_scalar(ch["beta"] * pow(FR_DELTA, gidx + i, R) % R)
                   for i in range(len(chunk))]
            values.append(_op_perm_product(
                jf, FR, zs[j], l_active, [leaf((c.kind, c.index))
                                          for c in chunk],
                [leaf(("sigma", perm_cols.index(c))) for c in chunk], bds,
                beta_e, gamma_e, leaf(("wq",))))
            gidx += len(chunk)
    for li, lk in enumerate(cs.lookups):
        values.extend(_op_lookup_rules(
            jf, FR, *[leaf(("lookup", li, k)) for k in range(3)],
            compress([p[0] for p in lk.pairs]),
            compress([p[1] for p in lk.pairs]), l0, l_last, l_active, beta_e,
            gamma_e))
    N = len(values)
    hv = eng.weighted_sum(values, [pow(ch["y"], N - 1 - i, R)
                                   for i in range(N)])
    return eng.scale(hv, zh_inv)


# -- the chains of launches the scan and the weighted sum replace ------------
# (the prover's routes before field_linscan and the sum program: one add
# launch a scan or tree-sum round, one mont_mul launch a power-vector round)

def _chain_tree_sum(arr, dim: int = 0):
    """Sum mod r over `dim` by halving rounds of add launches."""
    import torch
    from halo2tpu_torch.fields import jfield as jf
    while arr.shape[dim] > 1:
        half = arr.shape[dim] // 2
        head = jf.add(jf.FR, arr.narrow(dim, 0, half),
                      arr.narrow(dim, half, half))
        arr = head if 2 * half == arr.shape[dim] else torch.cat(
            [head, arr.narrow(dim, 2 * half, arr.shape[dim] - 2 * half)],
            dim)
    return arr.select(dim, 0)


def _chain_wsum(stacked, coefs):
    """sum_i coefs[i] stacked[i]: one product launch and a tree sum."""
    from halo2tpu_torch.fields import jfield as jf
    return _chain_tree_sum(jf.mont_mul(jf.FR, stacked, coefs[:, None]))


def _chain_scan(v, reverse: bool = False):
    """The prefix (suffix) sum along axis 0 in Hillis-Steele rounds, one
    add launch and a cat a round (and a flip each side for a suffix)."""
    import torch
    from halo2tpu_torch.fields import jfield as jf
    x = torch.flip(v, [0]) if reverse else v
    n, shift = x.shape[0], 1
    while shift < n:
        x = torch.cat([x[:shift], jf.add(jf.FR, x[shift:], x[:n - shift])])
        shift *= 2
    return torch.flip(x, [0]) if reverse else x


def _chain_div_linear(vec, a: int):
    """vec(X) / (X - a): power vectors of a and 1/a (doubling rounds of
    mont_mul) around a suffix sum."""
    import torch
    from halo2tpu_torch.fields import jfield as jf
    from halo2tpu_torch.fields.bn254 import R
    from halo2tpu_torch.plonk.engine import _powers
    a_e, ainv_e = jf.FR.encode([a, pow(a, -1, R)], vec.device)
    n = vec.shape[0]
    S = _chain_scan(jf.mont_mul(jf.FR, vec, _powers(a_e, n)), reverse=True)
    out = jf.mont_mul(jf.FR, torch.cat([S[1:], torch.zeros_like(S[:1])]),
                      _powers(ainv_e, n))
    return jf.mont_mul(jf.FR, out, ainv_e)


def _chain_eval(stacked, x: int):
    """(P, n, 8) polys at x: a power vector, one product, a tree sum."""
    from halo2tpu_torch.fields import jfield as jf
    from halo2tpu_torch.plonk.engine import _powers
    pows = _powers(jf.FR.encode([x], stacked.device)[0], stacked.shape[1])
    return _chain_tree_sum(jf.mont_mul(jf.FR, stacked, pows), 1)


def _configured_cs(circuit):
    """circuit's ConstraintSystem (configure only)."""
    from halo2tpu_torch.plonk.circuit import ConstraintSystem
    cs = ConstraintSystem()
    circuit.configure(cs)
    return cs


def _field_prog_case(circuit, g, n: int, card: "Card", dev):
    """A circuit's part program at n rows on random leaves (strided column
    views of one stack, as coeff_to_part_stack returns them) and random
    challenges: (program, leaves by key, consts, ch, zh_inv, cs, bound)."""
    import torch
    from halo2tpu_torch.fields.bn254 import R
    from halo2tpu_torch.fields.jfield import FR
    from halo2tpu_torch.plonk.quotient import const_value, part_program
    cs = _configured_cs(circuit)
    prog = part_program(cs, n)
    m = len(prog.leaf_keys)
    stack = _rand_fe(g, n * m, dev).reshape(n, m, 8)
    by_key = dict(zip(prog.leaf_keys, stack.unbind(1)))
    vals = torch.randint(0, 2**62, (5, 4), generator=g, dtype=torch.int64)
    ch_vals = [sum(int(w) << (62 * i) for i, w in enumerate(row)) % R
               for row in vals.tolist()]
    ch = dict(zip(("theta", "beta", "gamma", "y"), ch_vals))
    zh_inv = ch_vals[4]
    consts = FR.encode([const_value(k, ch, zh_inv) for k in prog.const_keys],
                       dev)
    ops = prog.op_counts()
    products = ops["MUL"] + ops["HORNER"]
    bound = card.bound((m + 1) * n * 32 + prog.code.nbytes
                       + consts.numel() * 4,
                       n * (products * MUL32_PER_MONT
                            + ops["SQR"] * MUL32_PER_SQR))
    return prog, by_key, consts, ch, zh_inv, cs, bound


def _ntt_entries(tntt, plan, a, pre, post):
    """The NTT's four entries on stack a: (entry, kernel call, plain call,
    scale products a row and column, per-row vectors read)."""
    return [("coset", lambda: tntt.ntt(plan, a, pre=pre),
             lambda: tntt.ntt_plain(plan, a, pre=pre), 1, 1),
            ("forward", lambda: tntt.ntt(plan, a),
             lambda: tntt.ntt_plain(plan, a), 0, 0),
            ("inverse", lambda: tntt.intt(plan, a),
             lambda: tntt.intt_plain(plan, a), 1, 0),
            ("h_chunk", lambda: tntt.intt(plan, a, post=post),
             lambda: tntt.intt_plain(plan, a, post=post), 2, 1)]


def _occupancy(registers: int, smem: int, threads: int) -> int:
    """Blocks an SM can hold (H100: 65,536 registers allocated 256 a warp,
    228 KB of shared memory with 1 KB reserved a block, 32 blocks, 2,048
    threads)."""
    warps = threads // 32
    regs = -(-registers * 32 // 256) * 256 * warps
    return min(65536 // regs, 233472 // (smem + 1024), 32, 2048 // threads)


def phase_kernels(report: dict, card: Card) -> None:
    import torch
    from halo2tpu_torch import _build
    from halo2tpu_torch.fields import jfield
    from halo2tpu_torch.fields.bn254 import Q, R
    from halo2tpu_torch.curves.jpoint import identity_points
    from halo2tpu_torch.fields.bn254 import fr_root_of_unity
    from halo2tpu_torch.ops import cuda_ec, cuda_field
    from halo2tpu_torch.ops import ntt as tntt
    from halo2tpu_torch.ops.field_prog import (field_prog, field_prog_plain,
                                               groups_for, sum_program)
    from halo2tpu_torch.ops.msm import SCALAR_BITS, TABLE_W
    from halo2tpu_torch.plonk.quotient import const_value, part_program

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(7)
    cases: dict = {}       # case name -> (kernel call, iterations)
    checks: dict = {}      # kernel -> [{case, max_abs_err, plain_ms, ...}]

    def check(name, timing, fn, plain, iters, bound, plain_runs=3, **extra):
        """fn() against plain() on the same inputs, bitwise; queue fn() for
        the timing rounds.  A plain version timed over several runs gets
        one warm-up run (its first call sets up the torch ops it uses)."""
        _, got = _timed(fn, 1, warmup=0)
        plain_ms, want = _timed(plain, plain_runs,
                                warmup=1 if plain_runs > 1 else 0)
        err = _max_abs_err(got, want)
        if err != 0:
            raise AssertionError(f"{timing}: kernel != plain (max |diff| "
                                 f"{err})")
        cases[timing] = (fn, iters)
        checks.setdefault(name, []).append(
            {"case": timing, "max_abs_err": err, "plain_ms": plain_ms,
             **bound, **extra})

    # mont_mul, Fr and Fq: 2^20 random lanes + every pair of the edge
    # operands, and the squaring (both operands one buffer).  One kernel
    # and one launch count; the entry's ms / plain_ms are Fr's product
    n = 1 << 20
    for spec, p, fname in ((jfield.FR, R, "fr"), (jfield.FQ, Q, "fq")):
        edge = [p - 1, p - 2, 1, (1 << 254) % p]
        ea = torch.from_numpy(jfield.ints_to_limbs(
            [x for x in edge for _ in edge]))
        eb = torch.from_numpy(jfield.ints_to_limbs(
            [y for _ in edge for y in edge]))
        a = torch.cat([_rand_fe(g, n, dev), ea.to(dev)])
        b = torch.cat([_rand_fe(g, n, dev), eb.to(dev)])
        rinv = pow(1 << 256, -1, p)
        got = cuda_field.mont_mul(spec, a, b)
        if jfield.limbs_to_ints(got[n:].cpu().numpy()) != [
                x * y * rinv % p for x in edge for y in edge]:
            raise AssertionError(f"mont_mul {fname}: edge operands wrong")
        got = cuda_field.mont_mul(spec, a, a)
        if jfield.limbs_to_ints(got[n:].cpu().numpy()) != [
                x * x * rinv % p for x in edge for _ in edge]:
            raise AssertionError(f"mont_mul {fname}: edge squares wrong")
        lanes = a.shape[0]
        check("mont_mul", f"mont_mul {fname}",
              lambda s=spec, x=a, y=b: cuda_field.mont_mul(s, x, y),
              lambda s=spec, x=a, y=b: cuda_field.mont_mul_plain(s, x, y),
              1000, card.bound(3 * lanes * 32, lanes * MUL32_PER_MONT),
              lanes=lanes)
        check("mont_mul", f"mont_mul {fname} square",
              lambda s=spec, x=a: cuda_field.mont_mul(s, x, x),
              lambda s=spec, x=a: cuda_field.mont_mul_plain(s, x, x),
              1000, card.bound(2 * lanes * 32, lanes * MUL32_PER_SQR),
              lanes=lanes)
    # and at the two lane counts a warm proof launches most (phase 4's
    # histogram: 32,768 lanes and one lane), launched back to back through
    # the wrapper as the proof launches them
    for lanes in (32768, 1):
        a, b = _rand_fe(g, lanes, dev), _rand_fe(g, lanes, dev)
        check("mont_mul", f"mont_mul fr L{lanes}",
              lambda x=a, y=b: cuda_field.mont_mul(jfield.FR, x, y),
              lambda x=a, y=b: cuda_field.mont_mul_plain(jfield.FR, x, y),
              2000, card.bound(3 * lanes * 32, lanes * MUL32_PER_MONT),
              lanes=lanes)

    lat = _Latency(card, dev, g)
    log(f"kernels: one dependent Montgomery product takes "
        f"{lat.mul_us:.4f} us, a squaring {lat.sqr_us:.4f} us (one lane of "
        f"mont_chain, {LATENCY_STEPS} steps beyond the first "
        f"{LATENCY_STEPS // 4}); independent products "
        f"{lat.rate_per_s:.4g}/s at {lat.rate_lanes} lanes, "
        f"{lat.rate_per_s * MUL32_PER_MONT / card.mul32_per_s:.3f} of the "
        "multiply bound")

    # fe_pow (cuda_field.mont_pow), Fr and Fq: exponents 0, 1, 2 and p - 2
    # at 1, 16, 80 and 4,097 lanes (the edge values 0, 1, p - 1 and R mod p
    # first), bitwise against the plain version; timed with p - 2 (a proof's
    # inversions) at 1, 80 (the grand products' one inversion of an RSA
    # proof) and 4,097 lanes, at one lane also against the chain it
    # replaces (one mont_mul launch a squaring or product)
    def chain_pow(spec, a, e):
        result, base = spec.const("one_mont", dev).expand(a.shape), a
        while e:
            if e & 1:
                result = cuda_field.mont_mul(spec, result, base)
            e >>= 1
            if e:
                base = cuda_field.mont_mul(spec, base, base)
        return result

    for spec, p, fname in ((jfield.FR, R, "fr"), (jfield.FQ, Q, "fq")):
        edge = torch.from_numpy(jfield.ints_to_limbs(
            [0, 1, p - 1, (1 << 256) % p])).to(dev)
        a = torch.cat([edge, _rand_fe(g, 4093, dev)])
        for lanes in (1, 16, 80, 4097):
            for e in (0, 1, 2, p - 2):
                err = _max_abs_err(cuda_field.mont_pow(spec, a[:lanes], e),
                                   cuda_field.mont_pow_plain(spec, a[:lanes],
                                                             e))
                if err:
                    raise AssertionError(f"fe_pow {fname} L{lanes} e={e}: "
                                         f"kernel != plain ({err})")
        e = p - 2
        sq, mul = e.bit_length() - 1, bin(e).count("1")
        for lanes in (1, 80, 4097):
            x = _rand_fe(g, lanes, dev)
            name = f"fe_pow {fname} L{lanes} p-2"
            extra = ({"chain_launches": sq + mul,
                      "chain_case": f"{name} chain"} if lanes == 1 else {})
            check("fe_pow", name, lambda s=spec, x=x, e=e:
                  cuda_field.mont_pow(s, x, e),
                  lambda s=spec, x=x, e=e: cuda_field.mont_pow_plain(s, x, e),
                  200 if lanes < 4097 else 50,
                  lat.floor(card.bound(64 * lanes, lanes * (
                      sq * MUL32_PER_SQR + mul * MUL32_PER_MONT)),
                            {"squarings": sq, "products": 1}),
                  plain_runs=3 if lanes == 1 else 1, lanes=lanes,
                  squarings=sq, products=mul, **extra)
            if lanes == 1:
                _chain_case(cases, f"{name} chain",
                            lambda s=spec, x=x, e=e: chain_pow(s, x, e),
                            cuda_field.mont_pow(spec, x, e), 20)

    # field_prog: the RSA-SHA256 and the composite part programs at n =
    # 2^15 rows (a k=15 proof's part), split into groups_for(n) sub-programs
    # as the prover compiles them, bitwise against the plain interpreter
    # and against the per-op route it replaces, timed against that route,
    # the one-program kernel (G = 1, one warp a row as before the split)
    # and the bound; the loads the program makes beside the bytes bound
    n_q = 1 << 15
    res = _build.resources.get("field_prog_kernel", {})
    op_eng = _op_engine(dev)
    for case, circuit in (("rsa", rsa_circuit()),
                          ("composite", composite_circuit())):
        prog, by_key, consts, ch, zh_inv, cs, bound = _field_prog_case(
            circuit, g, n_q, card, dev)
        leaves = [by_key[k] for k in prog.leaf_keys]
        G = prog.groups
        smem = G * prog.slots * 8 * 32 * 4
        blocks = _occupancy(res.get("registers", 255), smem, 32 * G)
        grid = -(-n_q // 32)
        name = f"field_prog {case} part"
        check("field_prog", name,
              lambda p=prog, x=leaves, c=consts: field_prog(
                  jfield.FR, p, x, c, n_q),
              lambda p=prog, x=leaves, c=consts: field_prog_plain(
                  jfield.FR, p, x, c, n_q),
              10, bound, plain_runs=1, rows=n_q,
              instructions=int(prog.code.shape[0]), slots=prog.slots,
              groups=G, leaves=len(leaves), ops=prog.op_counts(),
              load_bytes=prog.op_counts()["LOAD"] * n_q * 32,
              threads_per_block=32 * G, shared_bytes_per_block=smem,
              blocks_per_sm=blocks, grid_blocks=grid,
              warps_per_sm=min(grid, blocks * card.sms) * G / card.sms,
              chain_case=f"{name} chain", alt_case=f"{name} one program",
              alt_key="one_program")
        _chain_case(cases, f"{name} chain",
                    lambda c=cs, k=by_key, h=ch, z=zh_inv: per_op_part(
                        op_eng, c, n_q, k.__getitem__, h, z),
                    field_prog(jfield.FR, prog, leaves, consts, n_q), 2)
        one = part_program(cs, n_q, groups=1)
        one_consts = jfield.FR.encode([const_value(k, ch, zh_inv)
                                       for k in one.const_keys], dev)
        one_leaves = [by_key[k] for k in one.leaf_keys]
        _chain_case(cases, f"{name} one program",
                    lambda p=one, x=one_leaves, c=one_consts: field_prog(
                        jfield.FR, p, x, c, n_q),
                    field_prog(jfield.FR, prog, leaves, consts, n_q), 10)

    # the engine's weighted sum as a field program (sum_program) over 64
    # vectors of 2^15 rows, against the chain it replaces (one mont_mul
    # launch, then halving rounds of add launches)
    vecs = [_rand_fe(g, n_q, dev) for _ in range(64)]
    coefs = _rand_fe(g, 64, dev)
    sprog = sum_program(64, groups_for(n_q))
    check("field_prog", "field_prog sum 64 x 32768",
          lambda: field_prog(jfield.FR, sprog, vecs, coefs, n_q),
          lambda: field_prog_plain(jfield.FR, sprog, vecs, coefs, n_q), 50,
          card.bound(65 * n_q * 32 + 64 * 32, 64 * n_q * MUL32_PER_MONT),
          rows=n_q, groups=sprog.groups, terms=64,
          chain_case="field_prog sum 64 x 32768 chain")
    _chain_case(cases, "field_prog sum 64 x 32768 chain",
                lambda: _chain_wsum(torch.stack(vecs), coefs),
                field_prog(jfield.FR, sprog, vecs, coefs, n_q), 50)

    # the NTT (ops/ntt.py, csrc/ntt.cu): forward, inverse, coset (the
    # quotient's pre-scale) and h-chunk (inverse and post-scale) entries,
    # bitwise against the plain Stockham loop and its scales, at every shape
    # the proofs transform: k = 4-10 (the golden circuits) at C = 1, 3 and
    # 8 and the batch-less (n, 8); k = 15 at a stack chunk of 64 columns,
    # the composite's 60-column tail, RSA's 34 and one column, k = 10 at 3
    # columns and k = 20 at one, also timed (the main path's shape first:
    # the quotient's coset NTT of 64 columns)
    ntt_checked = 0
    timed_ntt = [(15, 64), (15, 60), (15, 34), (15, 1), (10, 3), (20, 1)]
    for k, C in ([(k, C) for k in (4, 6, 8, 10) for C in (1, 3, 8, None)
                  if (k, C) != (10, 3)] + timed_ntt):
        n = 1 << k
        plan = tntt.get_plan(n, fr_root_of_unity(k), dev)
        a = _rand_fe(g, n * (C or 1), dev).reshape(
            (n, 8) if C is None else (n, C, 8))
        pre, post = _rand_fe(g, n, dev), _rand_fe(g, n, dev)
        cols = C or 1
        for entry, fn, plain, scales, vec in _ntt_entries(tntt, plan, a, pre,
                                                          post):
            if (k, C) not in timed_ntt:
                err = _max_abs_err(fn(), plain())
                if err:
                    raise AssertionError(f"ntt {entry} n={n} C={C}: kernel "
                                         f"!= plain ({err})")
                ntt_checked += 1
                continue
            products = cols * ((n // 2) * k + scales * n)
            nbytes = (2 * n * cols + n // 2 + vec * n + 1) * 32
            passes = tntt.pass_shapes(k, cols)
            check("ntt", f"ntt {entry} n{n} C{cols}", fn, plain,
                  20 if n * cols >= 1 << 19 else 500,
                  card.bound(nbytes, products * MUL32_PER_MONT), plain_runs=1,
                  n=n, C=cols, entry=entry, passes=len(passes),
                  reg_bits=[tntt.reg_bits(p[0], p[1]) for p in passes])
            ntt_checked += 1
    log(f"kernels: ntt bitwise equal to its plain version in {ntt_checked} "
        f"cases (4 entries, {ntt_checked // 4} shapes)")

    # field add / sub / neg (cuda_field.add_sub, csrc/field_addsub.cu),
    # Fr and Fq, the edge values 0, 1 and p - 1 first, bitwise against the
    # plain versions; timed at 32,768 lanes (a scan round and tree-sum step
    # at k=15), at a stack of 64 columns with a broadcast per-row operand
    # (a coset column times its row), and at 2^20 lanes
    for spec, p, fname in ((jfield.FR, R, "fr"), (jfield.FQ, Q, "fq")):
        edge = torch.from_numpy(jfield.ints_to_limbs(
            [0, 1, p - 1])).to(dev)
        x = torch.cat([edge.repeat_interleave(3, 0), _rand_fe(g, 4087, dev)])
        y = torch.cat([edge.repeat(3, 1), _rand_fe(g, 4087, dev)])
        for op, fn, plain in (("add", cuda_field.add, cuda_field.add_plain),
                              ("sub", cuda_field.sub, cuda_field.sub_plain)):
            for xx, yy in ((x, y), (x, y[:1]), (y[:1], x)):
                err = _max_abs_err(fn(spec, xx, yy), plain(spec, xx, yy))
                if err:
                    raise AssertionError(f"field_addsub {op} {fname}: kernel "
                                         f"!= plain ({err})")
        if _max_abs_err(cuda_field.neg(spec, x),
                        cuda_field.neg_plain(spec, x)):
            raise AssertionError(f"field_addsub neg {fname}: kernel != plain")
    entries = {"add": (cuda_field.add, cuda_field.add_plain),
               "sub": (cuda_field.sub, cuda_field.sub_plain),
               "neg": (cuda_field.neg, cuda_field.neg_plain)}
    for lanes, op, bcast, iters in ((32768, "add", False, 2000),
                                    (32768 * 64, "add", True, 200),
                                    (1 << 20, "add", False, 200),
                                    (1 << 20, "sub", False, 200),
                                    (1 << 20, "neg", False, 200)):
        x = _rand_fe(g, lanes, dev)
        if bcast:
            x = x.reshape(32768, 64, 8)
            y = _rand_fe(g, 32768, dev).reshape(32768, 1, 8)
        else:
            y = _rand_fe(g, lanes, dev)
        args = (x,) if op == "neg" else (x, y)
        fn, plain = entries[op]
        check("field_addsub",
              f"field_addsub {op} L{lanes}" + (" + (n, 1)" if bcast else ""),
              lambda f=fn, a=args: f(jfield.FR, *a),
              lambda f=plain, a=args: f(jfield.FR, *a), iters,
              card.bound(sum(a.numel() for a in args) * 4 + lanes * 32, 0),
              lanes=lanes, op=op, broadcast=bcast)

    # the scans (cuda_field.linscan and prodscan, csrc/field_linscan.cu),
    # Fr: bitwise against the plain scans at the edge sizes 1, 3, 1000 and
    # 2^20, forward and reverse, the sum, a random multiplier a and the
    # product, every x, the exclusive x and the total, each one launch;
    # timed at the proof's shapes (a div_linear of 2^15 rows, the main
    # path's, first; an evaluation group of 16 polys of 2^15 rows; the
    # suffix and prefix sums at 2^15; the grand products' scans over 80
    # columns of 2^15 rows; a total and a full scan at 2^20), against its
    # bound and the chain of launches each replaces (the engine's routes
    # before this kernel: must not be slower)
    a_r = int(torch.randint(1, 2**62, (1,), generator=g)) ** 4 % R

    def scan_of(kind, a):
        if kind == "prod":
            return (lambda x, r, e, t: cuda_field.prodscan(jfield.FR, x, r, e,
                                                           t),
                    lambda x, r, e, t: cuda_field.prodscan_plain(
                        jfield.FR, x, r, e, t))
        return (lambda x, r, e, t: cuda_field.linscan(jfield.FR, x, a, r, e,
                                                      t),
                lambda x, r, e, t: cuda_field.linscan_plain(jfield.FR, x, a,
                                                            r, e, t))

    def at_run(run, f, *args):
        """f(*args) with the product scan's kernel at runs of `run` (its
        rule's runs swapped out)."""
        saved = cuda_field.STREAM_RUN_SHORT, cuda_field.STREAM_RUN_LONG
        cuda_field.STREAM_RUN_SHORT = cuda_field.STREAM_RUN_LONG = run
        try:
            return f(*args)
        finally:
            cuda_field.STREAM_RUN_SHORT, cuda_field.STREAM_RUN_LONG = saved

    scan_kinds = (("one", 1), ("a", a_r), ("prod", 1))
    for n in (1, 3, 1000, 1 << 20):
        v = _rand_fe(g, n, dev)
        for kind, a in scan_kinds:
            fn, plain = scan_of(kind, a)
            for reverse in (False, True):
                for exclusive, totals in ((False, False), (True, False),
                                          (False, True)):
                    before = (cuda_field.linscan.launches
                              + cuda_field.prodscan.launches)
                    got = fn(v, reverse, exclusive, totals)
                    if (cuda_field.linscan.launches
                            + cuda_field.prodscan.launches != before + 1):
                        raise AssertionError(f"field_linscan n={n} {kind}: "
                                             "not one launch")
                    err = _max_abs_err(got, plain(v, reverse, exclusive,
                                                  totals))
                    if err:
                        raise AssertionError(
                            f"field_linscan n={n} {kind} a={a} reverse="
                            f"{reverse} exclusive={exclusive} totals="
                            f"{totals}: kernel != plain ({err})")
    # the product scan over Fr and Fq (keygen's window table) at odd n, one
    # column and 80, forward and reverse, every output
    for spec in (jfield.FR, jfield.FQ):
        for n, cols in ((255, 80), (4097, 1), (4097, 80), (n_q + 3, 1),
                        (n_q + 3, 80)):
            r = _rand_fe(g, n * cols, dev).reshape(cols, n, 8)
            for reverse in (False, True):
                for exclusive, totals in ((False, False), (True, False),
                                          (False, True)):
                    err = _max_abs_err(
                        cuda_field.prodscan(spec, r, reverse, exclusive,
                                            totals),
                        cuda_field.prodscan_plain(spec, r, reverse,
                                                  exclusive, totals))
                    if err:
                        raise AssertionError(
                            f"prodscan p={spec.p % 1000} {cols} x {n} "
                            f"reverse={reverse} exclusive={exclusive} "
                            f"totals={totals}: kernel != plain ({err})")
            del r
    log("kernels: field_linscan bitwise equal to its plain versions at n = "
        "1, 3, 1000, 2^20 (sum, linear, product; 2 directions, 3 outputs), "
        "one launch a call; the product scan over Fr and Fq at 255 x 80, "
        "4097 x 1 and 80, 32771 x 1 and 80")
    v = _rand_fe(g, n_q, dev)
    polys = _rand_fe(g, 16 * n_q, dev).reshape(16, n_q, 8)
    big = _rand_fe(g, 1 << 20, dev)
    gp = _rand_fe(g, 80 * n_q, dev).reshape(80, n_q, 8)

    def chain_prefix_prod(x):
        """The grand products' prefix-product route before the product
        scan: jfield._prefix_prod_plain over (rows, columns), blocked
        mont_mul launches."""
        return jfield._prefix_prod_plain(jfield.FR, x.transpose(0, 1)
                                         ).transpose(0, 1)

    # keygen's window tables (ops/msm.py::precompute_window_table): one
    # batch inversion over 255 x 16 (k = 4), 255 x 1024 (k = 10) and 128 x
    # 2^15 (k = 15) Fq lanes, whose exclusive prefix product is timed here
    tables = {m: _rand_fe(g, m, dev) for m in (255 * 16, 255 * 1024, 1 << 22)}
    scan_cases = (
        ("div_linear L32768", v, "a", a_r, True, True, False,
         lambda: _chain_div_linear(v, a_r)),
        ("eval 16 x 32768", polys, "a", a_r, True, False, True,
         lambda: _chain_eval(polys, a_r)),
        ("suffix sum L32768", v, "one", 1, True, False, False,
         lambda: _chain_scan(v, reverse=True)),
        ("prefix sum L32768", v, "one", 1, False, False, False,
         lambda: _chain_scan(v)),
        ("prodscan 80 x 32768", gp, "prod", 1, False, False, False,
         lambda: chain_prefix_prod(gp)),
        ("prodscan exclusive reverse 80 x 32768", gp, "prod", 1, True, True,
         False, None),
        *((f"prodscan fq exclusive L{m}", t, "prod fq", 1, False, True,
           False, None) for m, t in tables.items()),
        ("total L1048576", big, "a", a_r, False, False, True, None),
        ("full L1048576", big, "a", a_r, False, False, False, None))
    for label, x, kind, a, reverse, exclusive, totals, chain in scan_cases:
        elems = x.numel() // 8
        cols = x.shape[0] if x.dim() == 3 else 1
        out_bytes = cols * 32 if totals else elems * 32
        kernel = "prodscan" if kind.startswith("prod") else "field_linscan"
        name = label if kernel == "prodscan" else f"field_linscan {label}"
        extra = {"chain_case": f"{name} chain"} if chain else {}
        if kernel == "prodscan":
            run, nb = cuda_field.stream_shapes(elems // cols, cols,
                                               cuda_field._stream_wave(dev))
        else:
            run, nb = cuda_field.scan_shapes(elems // cols, kind, cols,
                                             cuda_field._scan_wave(dev))
        if kind == "prod fq":
            fn = lambda x, r, e, t: cuda_field.prodscan(jfield.FQ, x, r, e, t)
            plain = lambda x, r, e, t: cuda_field.prodscan_plain(
                jfield.FQ, x, r, e, t)
        else:
            fn, plain = scan_of(kind, a)
        check(kernel, name,
              lambda x=x, f=fn, r=reverse, e=exclusive, t=totals:
                  f(x, r, e, t),
              lambda x=x, f=plain, r=reverse, e=exclusive, t=totals:
                  f(x, r, e, t),
              200 if elems < 1 << 20 else 20,
              card.bound(elems * 32 + out_bytes,
                         0 if kind == "one" else elems * MUL32_PER_MONT),
              plain_runs=1, rows=elems // cols, columns=cols, kind=kind,
              reverse=reverse, exclusive=exclusive, totals=totals, run=run,
              blocks_per_column=nb, blocks=nb * cols, launches_per_call=1,
              **extra)
        if chain:
            _chain_case(cases, f"{name} chain", chain,
                        fn(x, reverse, exclusive, totals), 20)
        if kernel != "prodscan":
            continue
        # the product scans also at the runs the rule did not pick: 4 (its
        # short runs, for grids that fit one wave), 16, 32 (its long ones)
        # and 64 at 80 x 2^15, 4 or 32 at keygen's single columns
        alts = ((4, 16, 32, 64) if cols > 1 else (4, 32))
        checks[kernel][-1]["alts"] = {}
        for k in alts:
            if k == run:
                continue
            case = f"{name} run {k}"
            checks[kernel][-1]["alts"][f"run_{k}"] = case
            _chain_case(cases, case,
                        lambda x=x, f=fn, r=reverse, e=exclusive, t=totals,
                        k=k: at_run(k, f, x, r, e, t),
                        fn(x, reverse, exclusive, totals),
                        200 if elems < 1 << 20 else 20)
    del tables

    # fold_mixed at the widths ops/msm.py::fold_width gives a k=15 commit
    # (npad = 2^15, one shared table and 8 scalar vectors): a full batch
    # (P=32, B=8, C=256, 128 rows: the main path's launch), narrow advice
    # columns (P=8, B=8, C=1024, 32 rows) and a coefficient commit (P=32,
    # B=1, C=2048, 16 rows), all rows in one launch, each against one plain
    # run of the same rows
    npad = 1 << 15
    fq1 = jfield.FQ.const("one_mont", dev)
    table = torch.empty((TABLE_W, npad, 3, 8), dtype=torch.int32, device=dev)
    for w in range(TABLE_W):
        table[w, :, :2] = _rand_fe(g, 2 * npad, dev).reshape(npad, 2, 8)
        table[w, :, 2] = fq1
    table[0, :, 2] = 0                           # digit 0: identity entries
    scal = _rand_fe(g, 8 * npad, dev).reshape(8, npad, 8)
    for P, B, C, iters in ((32, 8, 256, 20), (8, 8, 1024, 50),
                           (32, 1, 2048, 100)):
        sc = scal[:B]
        acc, bound = _mixed_case(g, table, sc, P, C, card)
        rows = npad // C
        check("fold_mixed", f"fold_mixed P{P} B{B} C{C}",
              lambda a=acc, s=sc, P=P, C=C, rows=rows: cuda_ec.fold_mixed(
                  a, table, s, C, P, 0, rows),
              lambda a=acc, s=sc, P=P, C=C, rows=rows:
                  cuda_ec.fold_mixed_plain(a, table, s, C, P, 0, rows),
              iters, bound, plain_runs=1, P=P, B=B, C=C, rows=rows,
              lanes=P * B * C)
    del acc
    torch.cuda.empty_cache()

    # fold_mixed_tiled at msm()'s full width: L = 254 * 8 * 256 lanes, one
    # row of C = 256 bases (base 255 the identity), about half the lanes
    # masked; 512 lanes each of equal, inverse and acc-identity
    Bm, C = 8, 256
    Lt = SCALAR_BITS * Bm * C
    pts_c = _rand_points(g, C, dev)
    pts_c[:, 2] = fq1
    pts_c[C - 1, 2] = 0
    bits = torch.randint(0, 2, (Lt,), generator=g, dtype=torch.uint8).to(dev)
    acc_t = _rand_points(g, Lt, dev)
    lane = torch.arange(Lt, device=dev)
    live = (bits != 0) & (lane % C != C - 1)
    base = pts_c[lane % C]
    sel = {off: lane[(lane % 7 == off) & live][:512] for off in range(3)}
    acc_t[sel[0]] = base[sel[0]]                                # equal
    acc_t[sel[1]] = base[sel[1]]                                # inverse
    acc_t[sel[1], 1] = jfield.neg(jfield.FQ, base[sel[1], 1])
    acc_t[sel[2], 2] = 0                                        # acc identity
    del base
    live_n = int(live.sum())
    mul32 = ((live_n - 1536) * MIXED_ADD + 512 * (MIXED_PRE + DBL)
             + 512 * MIXED_PRE)
    check("fold_mixed_tiled", "fold_mixed_tiled",
          lambda: cuda_ec.fold_mixed_tiled(acc_t, pts_c, bits),
          lambda: cuda_ec.fold_mixed_tiled_plain(acc_t, pts_c, bits), 200,
          card.bound(2 * Lt * POINT_BYTES + Lt + C * POINT_BYTES, mul32),
          plain_runs=1, lanes=Lt, C=C,
          masked=Lt - int((bits != 0).sum()), adds=live_n)

    # fold_add at the first tail round of msm() (254 * 8 * 128 lanes, a
    # whole number of 512-lane tiles), with doubling, inverse and identity
    # lanes; an unaligned L is refused
    La = SCALAR_BITS * Bm * C // 2
    pa, qa, mul32 = _add_pairs(La, dev, g)
    check("fold_add", "fold_add", lambda: cuda_ec.fold_add(pa, qa),
          lambda: cuda_ec.fold_add_plain(pa, qa), 200,
          card.bound(3 * La * POINT_BYTES, mul32), lanes=La)
    try:
        cuda_ec.fold_add(pa[:La - 1], qa[:La - 1])
    except ValueError:
        pass
    else:
        raise AssertionError("fold_add took an unaligned lane count")
    # and at 32,768 lanes, the first round of a warm proof's 256 x 256 tail
    # (before fold_add_tree, a lanewise fold_add launch)
    pw, qw, mul32 = _add_pairs(32768, dev, g)
    check("fold_add", "fold_add L32768", lambda: cuda_ec.fold_add(pw, qw),
          lambda: cuda_ec.fold_add_plain(pw, qw), 500,
          card.bound(3 * 32768 * POINT_BYTES, mul32), lanes=32768)

    # fold_add_any at an unaligned lane count, same special lanes;
    # fold_dbl_any at a window-table-build width with times=1 (no branch:
    # every lane, identity or not, does the doubling's 2 products and 5
    # squarings) and at a Horner step's shape, 16 lanes doubled 8 times
    Lb = 2 * 32768 + 37
    pb, qb, mul32 = _add_pairs(Lb, dev, g)
    check("fold_add_any", "fold_add_any",
          lambda: cuda_ec.fold_add_any(pb, qb),
          lambda: cuda_ec.fold_add_any_plain(pb, qb), 500,
          card.bound(3 * Lb * POINT_BYTES, mul32), lanes=Lb)
    for Ld, times, iters in ((1 << 20, 1, 200), (16, 8, 2000)):
        pd = _rand_points(g, Ld, dev)
        pd[:max(1, Ld // 1024), 2] = 0
        check("fold_dbl_any", f"fold_dbl_any L{Ld} x{times}",
              lambda p=pd, t=times: cuda_ec.fold_dbl_any(p, times=t),
              lambda p=pd, t=times: cuda_ec.fold_dbl_any_plain(p, t), iters,
              card.bound(2 * Ld * POINT_BYTES, Ld * times * DBL),
              lanes=Ld, times=times)

    # fold_add_tree at the warm proof's tail shapes (G groups x width: the
    # 65,536-lane fold_mixed launches at C = 256, 1024 and 2048, and the
    # 98,304-lane one) and msm()'s (2032 x 256: two lanewise rounds, then
    # one tree launch), each one launch of the tree kernel, also timed
    # against the chain of lanewise add launches it replaces and with the
    # switch to four threads an add a round earlier (a slot limit of two
    # waves) and a round later (half a wave); beside its bound the latency
    # floor of its rounds (tree_add4's critical path each); and bitwise at
    # one group of 2 and of 65,536 lanes
    def chain_tree(acc, G, W):
        while W > 1:
            a4 = acc.reshape(G, W, 3, 8)
            acc = cuda_ec.fold_add_any(a4[:, :W // 2].reshape(-1, 3, 8),
                                       a4[:, W // 2:].reshape(-1, 3, 8))
            W //= 2
        return acc

    def tree_at(acc, G, W, limit):
        cuda_ec.TREE_SLOT_LIMIT = limit
        try:
            return cuda_ec.fold_add_tree(acc, G, W)
        finally:
            cuda_ec.TREE_SLOT_LIMIT = None

    wave = cuda_ec.tree_slot_limit(dev)
    for G, W in ((1, 2), (1, 1 << 16)):
        acc, _ = _tree_case(g, G, W, dev) if W > 8 else (
            _rand_points(g, 2, dev), 0)
        err = _max_abs_err(cuda_ec.fold_add_tree(acc, G, W),
                           cuda_ec.fold_add_tree_plain(acc, G, W))
        if err:
            raise AssertionError(f"fold_add_tree {G}x{W}: kernel != plain "
                                 f"({err})")
    for G, W, iters in ((256, 256, 200), (64, 1024, 200), (32, 2048, 200),
                        (96, 1024, 200), (SCALAR_BITS * Bm, C, 100)):
        acc, mul32 = _tree_case(g, G, W, dev)
        name = f"fold_add_tree {G}x{W}"
        slots = cuda_ec.tree_round_slots(G, W, wave)
        alts = {"slot_switch_a_round_earlier": f"{name} limit x2",
                "slot_switch_a_round_later": f"{name} limit x0.5"}
        check("fold_add_tree", name,
              lambda a=acc, G=G, W=W: cuda_ec.fold_add_tree(a, G, W),
              lambda a=acc, G=G, W=W: cuda_ec.fold_add_tree_plain(a, G, W),
              iters, lat.floor(card.bound((G * W + G) * POINT_BYTES, mul32),
                               _tree_chain(W)),
              plain_runs=1, groups=G, width=W, chain_case=f"{name} chain",
              slot_limit=wave, one_thread_rounds=slots.count(False),
              slot_rounds=slots.count(True), alts=alts)
        _chain_case(cases, f"{name} chain",
                    lambda a=acc, G=G, W=W: chain_tree(a, G, W),
                    cuda_ec.fold_add_tree(acc, G, W), iters)
        for factor, case in ((2, alts["slot_switch_a_round_earlier"]),
                             (0.5, alts["slot_switch_a_round_later"])):
            _chain_case(cases, case,
                        lambda a=acc, G=G, W=W, lim=int(wave * factor):
                            tree_at(a, G, W, lim),
                        cuda_ec.fold_add_tree(acc, G, W), iters)

    # msm()'s tail also with every round in the tree kernel (one launch, no
    # lanewise round of ADD_WAVE adds or more): the route the wave rule is
    # held against
    def tree_only(acc, G, W):
        wave, cuda_ec.ADD_WAVE = cuda_ec.ADD_WAVE, G * W
        try:
            return cuda_ec.fold_add_tree(acc, G, W)
        finally:
            cuda_ec.ADD_WAVE = wave

    checks["fold_add_tree"][-1]["alts"]["one_launch"] = f"{name} one launch"
    _chain_case(cases, f"{name} one launch",
                lambda a=acc, G=G, W=W: tree_only(a, G, W),
                cuda_ec.fold_add_tree(acc, G, W), iters)

    # fold_horner at the windowed combine (B = 8, 32 digit planes, 8
    # doublings a plane) and msm()'s (254 bit planes, 1 doubling), each
    # also timed against its chain of fold_dbl_any and fold_add_any launches
    def chain_horner(parts, times):
        acc = identity_points((parts.shape[0],), dev)
        for d in range(parts.shape[1] - 1, -1, -1):
            acc = cuda_ec.fold_add_any(cuda_ec.fold_dbl_any(acc, times),
                                       parts[:, d].contiguous())
        return acc

    for B, P, times, iters in ((Bm, 32, 8, 20), (1, 32, 8, 20),
                               (48, 32, 8, 20), (200, 32, 8, 20),
                               (392, 32, 8, 20), (Bm, SCALAR_BITS, 1, 10)):
        parts, mul32, chain = _horner_case(g, B, P, times, dev)
        name = f"fold_horner B{B} P{P} x{times}"
        extra = {"chain_case": f"{name} chain"} if B == Bm else {}
        check("fold_horner", name,
              lambda p=parts, t=times: cuda_ec.fold_horner(p, t),
              lambda p=parts, t=times: cuda_ec.fold_horner_plain(p, t),
              iters, lat.floor(card.bound((B * P + B) * POINT_BYTES, mul32),
                               chain),
              plain_runs=1, lanes=B, planes=P, times=times, **extra)
        if B == Bm:
            _chain_case(cases, f"{name} chain",
                        lambda p=parts, t=times: chain_horner(p, t),
                        cuda_ec.fold_horner(parts, times),
                        max(2, iters // 4))

    # fold_mixed_tiled_rows at msm()'s full shape, all 128 rows in one
    # launch, against one plain run of the same rows
    acc_r, pts_r, sc_r, bound, extra = _rows_case(g, Bm, C, card, dev)
    n_r = pts_r.shape[0]
    check("fold_mixed_tiled_rows", "fold_mixed_tiled_rows",
          lambda: cuda_ec.fold_mixed_tiled_rows(acc_r, pts_r, sc_r, C, 0,
                                                n_r // C),
          lambda: cuda_ec.fold_mixed_tiled_rows_plain(acc_r, pts_r, sc_r, C,
                                                      0, n_r // C),
          5, bound, plain_runs=1, lanes=acc_r.shape[0], C=C, rows=n_r // C,
          **extra)

    log(f"kernels: every kernel bitwise equal to its plain version; timing "
        f"{len(cases)} cases, {ROUNDS} rounds in turns")
    times = _time_in_turns(cases)
    replaces = {"mont_mul": "halo2tpu/ops/pallas_field.py:347",
                "fe_pow": "halo2tpu/fields/jfield.py:331",
                "field_prog": "halo2tpu/plonk/quotient.py:258",
                "ntt": "halo2tpu/ops/ntt.py:69",
                "field_addsub": "halo2tpu/fields/jfield.py:283",
                "field_linscan": "halo2tpu/fields/jfield.py:400",
                "prodscan": "halo2tpu/fields/jfield.py:419",
                "fold_mixed": "halo2tpu/ops/pallas_ec.py:218",
                "fold_mixed_tiled": "halo2tpu/ops/pallas_ec.py:291",
                "fold_mixed_tiled_rows": "halo2tpu/ops/pallas_ec.py:291",
                "fold_add": "halo2tpu/ops/pallas_ec.py:240",
                "fold_add_any": "halo2tpu/ops/pallas_ec.py:341",
                "fold_add_tree": "halo2tpu/ops/pallas_ec.py:326",
                "fold_horner": "halo2tpu/ops/msm.py:312",
                "fold_dbl_any": "halo2tpu/ops/pallas_ec.py:375"}
    for name, rows in checks.items():
        for row in rows:
            row.update(times[row["case"]])
            log(f"kernel {row['case']}: kernel {row['ms']:.4f} ms (median "
                f"of {ROUNDS}, {row['ms_min']:.4f}-{row['ms_max']:.4f}), "
                f"plain {row['plain_ms']:.4f} ms, bound "
                f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
            if "chain_case" in row:
                ch = times[row.pop("chain_case")]
                row.update(chain_ms=ch["ms"], chain_ms_min=ch["ms_min"],
                           chain_ms_max=ch["ms_max"])
                log(f"kernel {row['case']}: the chain of launches it "
                    f"replaces {ch['ms']:.4f} ms ({ch['ms_min']:.4f}-"
                    f"{ch['ms_max']:.4f})")
                if row["ms"] > ch["ms"]:
                    raise AssertionError(f"{row['case']}: slower than the "
                                         "chain of launches it replaces")
            if "alt_case" in row:
                row.setdefault("alts", {})[row.pop("alt_key", "one_launch")] \
                    = row.pop("alt_case")
            for key, case in row.pop("alts", {}).items():
                alt = times[case]
                row.update({f"{key}_ms": alt["ms"],
                            f"{key}_ms_min": alt["ms_min"],
                            f"{key}_ms_max": alt["ms_max"]})
                log(f"kernel {row['case']}: {key.replace('_', ' ')} "
                    f"{alt['ms']:.4f} ms ({alt['ms_min']:.4f}-"
                    f"{alt['ms_max']:.4f})")
        main = rows[0]                  # the main path's shape comes first
        report[name] = {
            "name": name, "route": "cuda",
            "source": SOURCES.get(name, "halo2tpu_torch/csrc/ec_fold.cu"),
            "replaces": replaces[name], "launches": 0,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None, "ms_min": main["ms_min"],
            "ms_max": main["ms_max"], "cases": rows}
    for name in ("fe_pow", "fold_horner", "fold_add_tree"):
        report[name].update(
            latency_floor_ms=report[name]["cases"][0]["latency_floor_ms"],
            product_latency=lat.summary())
    for row in (report["fe_pow"]["cases"] + report["fold_horner"]["cases"]
                + report["fold_add_tree"]["cases"]):
        log(f"kernel {row['case']}: latency floor "
            f"{row['latency_floor_ms']:.4f} ms ({row['floor_chain']}), "
            f"kernel / floor {row['ms'] / row['latency_floor_ms']:.2f}, "
            f"kernel / bound {row['ms'] / row['bound_ms']:.2f}")
    for row in report["field_linscan"]["cases"] + report["prodscan"][
            "cases"]:
        log(f"kernel {row['case']}: kernel / bound "
            f"{row['ms'] / row['bound_ms']:.2f} ({row['bound_by']}), "
            f"{row['blocks']} blocks of runs of {row['run']}")
    for row in report["ntt"]["cases"]:
        log(f"kernel {row['case']}: kernel / bound "
            f"{row['ms'] / row['bound_ms']:.2f}, register bits "
            f"{row['reg_bits']} a pass")
    fp = report["field_prog"]
    if fp["ms"] * FIELD_PROG_OVER_CHAIN > fp["cases"][0]["chain_ms"]:
        raise AssertionError(f"field_prog: {fp['ms']:.4f} ms, more than "
                             f"1/{FIELD_PROG_OVER_CHAIN} of the per-op route "
                             f"({fp['cases'][0]['chain_ms']:.4f} ms)")
    for row in fp["cases"][:2]:
        log(f"kernel {row['case']}: {row['instructions']} instructions in "
            f"{row['groups']} sub-programs, {row['slots']} slots, "
            f"{row['ops']}; {row['shared_bytes_per_block']} bytes of shared "
            f"memory a block of {row['threads_per_block']} threads, "
            f"{row['blocks_per_sm']} blocks an SM fit, {row['grid_blocks']} "
            f"blocks in the grid, {row['warps_per_sm']:.2f} warps an SM; "
            f"loads {row['load_bytes']} bytes against the bound's "
            f"{row['bound_bytes']}")
    del table
    torch.cuda.empty_cache()


# -- launch counts -----------------------------------------------------------

def _wrappers() -> dict:
    from halo2tpu_torch.ops import cuda_ec, cuda_field, ntt
    from halo2tpu_torch.ops.field_prog import field_prog
    return {"mont_mul": cuda_field.mont_mul,
            "fe_pow": cuda_field.mont_pow,
            "field_prog": field_prog,
            "ntt": ntt.ntt_kernel,
            "field_addsub": cuda_field.add_sub,
            "field_linscan": cuda_field.linscan,
            "prodscan": cuda_field.prodscan,
            "fold_mixed": cuda_ec.fold_mixed,
            "fold_mixed_tiled": cuda_ec.fold_mixed_tiled,
            "fold_mixed_tiled_rows": cuda_ec.fold_mixed_tiled_rows,
            "fold_add": cuda_ec.fold_add,
            "fold_add_any": cuda_ec.fold_add_any,
            "fold_add_tree": cuda_ec.fold_add_tree,
            "fold_horner": cuda_ec.fold_horner,
            "fold_dbl_any": cuda_ec.fold_dbl_any}


def _plain_loops() -> dict:
    """The plain loops a kernel replaced, each counting its runs on CUDA
    tensors: the NTT's Stockham loop, the scan's add rounds (the
    prefix/suffix sums, div_linear and evaluations before field_linscan),
    the product scan's rounds and the blocked mont_mul routes of the prefix
    product and the batch inversion (the grand products and keygen's
    window table before the product scan), and the field-program
    interpreter (the weighted sums' tree-sum rounds before the sum
    program)."""
    from halo2tpu_torch.fields import jfield
    from halo2tpu_torch.ops import cuda_field, field_prog, ntt
    return {"ntt._ntt_run": ntt._ntt_run,
            "cuda_field.linscan_plain": cuda_field.linscan_plain,
            "cuda_field.prodscan_plain": cuda_field.prodscan_plain,
            "jfield._prefix_prod_plain": jfield._prefix_prod_plain,
            "jfield.batch_inv_scan_plain": jfield.batch_inv_scan_plain,
            "field_prog.field_prog_plain": field_prog.field_prog_plain}


def _zero_counts() -> None:
    for w in _wrappers().values():
        w.launches = 0
        w.shapes.clear()
    for f in _plain_loops().values():
        f.cuda_calls = 0


def _check_no_plain_loops(path: str) -> None:
    """No transform, scan or weighted sum of the path ran its plain loop
    on the card."""
    ran = {k: f.cuda_calls for k, f in _plain_loops().items()
           if f.cuda_calls}
    if ran:
        raise AssertionError(f"{path}: plain loops ran on CUDA tensors: "
                             f"{ran}")


def _counts() -> dict:
    return {name: w.launches for name, w in _wrappers().items()}


def _shapes() -> dict:
    """Each kernel's shape histogram, a copy: name -> Counter."""
    return {name: w.shapes.copy() for name, w in _wrappers().items()}


SHAPE_KEYS = {"mont_mul": "lanes", "fe_pow": "lanes",
              "field_prog": "program x rows x instructions x groups",
              "ntt": "n x C x passes", "field_addsub": "lanes x op",
              "field_linscan": "n x columns x output x kind",
              "prodscan": "n x columns x output x kind",
              "fold_mixed": "lanes x C x rows",
              "fold_dbl_any": "lanes x times", "fold_mixed_tiled": "lanes",
              "fold_mixed_tiled_rows": "lanes x C x rows",
              "fold_add": "lanes", "fold_add_any": "lanes",
              "fold_add_tree": "groups x width",
              "fold_horner": "lanes x planes x times"}
# the __global__ function (csrc/, _build.KERNELS) behind each wrapper
KERNEL_OF = {"mont_mul": "mont_mul_kernel<false>",
             "fe_pow": "mont_pow_kernel",
             "field_prog": "field_prog_kernel",
             "ntt": "ntt_pass_kernel<3>",
             "field_addsub": "field_addsub_kernel",
             "field_linscan": "field_linscan_kernel<1>",
             "prodscan": "field_linscan_stream_kernel",
             "fold_mixed": "fold_mixed_kernel",
             "fold_mixed_tiled": "fold_mixed_tiled_kernel",
             "fold_mixed_tiled_rows": "fold_mixed_tiled_rows_kernel",
             "fold_add": "fold_add_kernel", "fold_add_any": "fold_add_kernel",
             "fold_add_tree": "fold_add_tree_kernel",
             "fold_horner": "fold_horner_kernel",
             "fold_dbl_any": "fold_dbl_kernel"}


def _count_grand_products(eng) -> list:
    """Wrap eng.grand_products so that each call appends the launches of
    the port's kernels it made; returns that list."""
    inner, calls = eng.grand_products, []

    def counted(nums, dens):
        before = _counts()
        out = inner(nums, dens)
        calls.append(sum(n - before[k] for k, n in _counts().items()))
        return out

    eng.grand_products = counted
    return calls


def _check_grand_products(path: str, per_warm: dict, gp_launches: int):
    if (gp_launches > GRAND_PRODUCT_LAUNCHES
            or per_warm["fe_pow"] != FE_POW_PER_PROOF):
        raise AssertionError(f"{path}: grand_products launched {gp_launches} "
                             f"kernels and fe_pow {per_warm['fe_pow']} in a "
                             "warm proof")
    log(f"{path}: a warm proof's grand_products launch {gp_launches} of the "
        f"port's kernels; fe_pow {per_warm['fe_pow']}")


def _field_prog_by_program(hist) -> dict:
    """field_prog launches by program name ("part": a quotient part,
    "sum": a weighted sum) from its shape histogram."""
    out: dict = {}
    for key, n in hist.items():
        out[key[0]] = out.get(key[0], 0) + n
    return out


def _shape_table(hist) -> dict:
    """Counter of shape tuples -> {"lanes x ...": launches}, JSON-ready."""
    return {" x ".join(map(str, k)): n for k, n in sorted(hist.items())}


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


def mini_qr() -> bytes:
    """The synthetic 18-delimiter QR of tests/test_aadhaar_composite.py
    (the reference's field layout, a 45-byte photo holding a 255): field 2
    holds refid and timestamp digits, 4 the birth date, 5 the gender, 11
    the pincode, 13 the state."""
    fields = [b"86", b"3", b"1234" + b"20240718" + b"12" + b"4557",
              b"Sumit Kumar", b"01-01-1984", b"M", b"CO X", b"East", b"",
              b"B-31", b"", b"110051", b"KN", b"Delhi", b"RSP", b"GN",
              b"KN2", b"1234"]
    photo = bytes((i * 13 + 7) % 256 for i in range(45))
    photo = photo[:20] + b"\xff" + photo[21:]
    return b"\xff".join(fields) + b"\xff" + photo


def _extractor_harness(data: bytes):
    """The QR extractor over `data` (tests/test_qr_extractor.py's harness
    with 4-bit lookups): the year through the qr_delim lookup (delimiter
    2) and its four digits through qr_access, the gender byte after
    delimiter 5 through both."""
    from halo2tpu_torch.gadgets.flexgate import FlexGateConfig, GateChip
    from halo2tpu_torch.gadgets.qr_extractor import (ExtractorChip,
                                                     ExtractorConfig)
    from halo2tpu_torch.gadgets.range import RangeChip, RangeStrategyConfig
    from halo2tpu_torch.plonk.circuit import Circuit

    class ExtractorHarness(Circuit):
        def configure(self, cs):
            gcfg = FlexGateConfig.configure(cs, 8)
            rcfg = RangeStrategyConfig.configure(cs, gcfg, 4, 1)
            return gcfg, rcfg, ExtractorConfig.configure(cs)

        def synthesize(self, config, asn):
            gcfg, rcfg, ecfg = config
            gate = GateChip(gcfg, asn)
            rng = RangeChip(rcfg, gate, asn)
            rng.load_table()
            ext = ExtractorChip(ecfg, gate, asn)
            ext.load_data([gate.load_witness(b) for b in data])
            year = ext.packed_digits(ext.delimiter_pos1(2), [5, 6, 7, 8], rng)
            gender = ext.access_offset(ext.delimiter_pos1(5), 1)
            assert (year.value, gender.value) == (2024, ord("M"))

    return ExtractorHarness()


IDENTITY_ARGS = dict(
    reveal_age_above_18=True, age_above_18=1, qr_data_age_above_18=1,
    reveal_gender=True, gender=77, qr_data_gender=77,
    reveal_pincode=True, pincode=110051, qr_data_pincode=110051,
    reveal_state=True, state=[68, 101, 108, 104, 105],
    qr_data_state=[68, 101, 108, 104, 105])
# the nullifier's photo: 124 bytes, 4 packed field elements
NULLIFIER_PHOTO = bytes((i * 7 + 3) % 256 for i in range(124))


def golden_circuits():
    """name -> (circuit, k, instances, rng_seed): the port's circuits of
    tests/golden/torch_port_proofs.json."""
    from halo2tpu_torch.circuits.conditional_secrets import IdentityCircuit
    from halo2tpu_torch.circuits.nullifier import NullifierCircuit
    from halo2tpu_torch.circuits.signal import SquareCircuit
    from halo2tpu_torch.circuits.timestamp import TimestampCircuit
    sq = SquareCircuit(5)
    rh = _range_harness()
    nul = NullifierCircuit(12345678, NULLIFIER_PHOTO)
    return {
        "square_k4": (sq, 4, sq.instances(), 11),
        "timestamp_k6": (TimestampCircuit(2023, 7, 8, 12, 34, 56), 6, [], 27),
        "range_k7": (rh, 7, [], 22),
        "identity_k4": (IdentityCircuit(**IDENTITY_ARGS), 4, [], 5),
        "nullifier_k10": (nul, 10, nul.instances(), 31),
        "extractor_k8": (_extractor_harness(mini_qr()), 8, [], 33),
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
    sig = _pkcs1v15_sha256_sign(key["p"], key["q"], key["e"], RSA_MESSAGE)
    return RSASha256Circuit(RSA_MESSAGE, key["p"] * key["q"], sig)


def phase_slice(report: dict, cache_dir: str):
    """Returns (srs, engine) for phase 5."""
    import torch
    from halo2tpu_torch.plonk.engine import TorchEngine
    from halo2tpu_torch.plonk.keygen import keygen_cached
    from halo2tpu_torch.plonk.prover import create_proof
    from halo2tpu_torch.plonk.srs import setup
    from halo2tpu_torch.plonk.verifier import verify_proof
    from halo2tpu_torch.ops.msm import LANE_TARGET
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
    gp_calls = _count_grand_products(eng)
    log(f"slice: keygen {kg:.1f} s (window table built in this run)")
    t0 = time.perf_counter()
    cold_proof = create_proof(pk, srs, c, c.instances(), rng_seed=3,
                              engine=eng)
    cold = time.perf_counter() - t0
    tr = Tracer()
    before, shapes_before = _counts(), _shapes()
    t0 = time.perf_counter()
    proof = create_proof(pk, srs, c, c.instances(), rng_seed=4, engine=eng,
                         tracer=tr)
    warm = time.perf_counter() - t0
    per_warm = {n: v - before[n] for n, v in _counts().items()}
    warm_shapes = {n: h - shapes_before[n] for n, h in _shapes().items()}
    again = create_proof(pk, srs, c, c.instances(), rng_seed=4, engine=eng)
    launches = _counts()
    peak = torch.cuda.max_memory_allocated()
    # one more warm proof under torch.profiler: every CUDA kernel the card
    # ran (the port's and torch's own) and the device busy share
    from profile_proof import profile_run
    profiled, prof = profile_run(
        lambda: create_proof(pk, srs, c, c.instances(), rng_seed=4,
                             engine=eng), cache_dir)
    sha = hashlib.sha256(proof).hexdigest()
    phases = {p: round(v, 3) for p, v in tr.phases.items()}
    log(f"slice: cold proof {cold:.2f} s, warm proof {warm:.2f} s")
    log(f"slice: warm phases {json.dumps(phases)}")
    log("slice: warm commit and SHPLONK phases " + json.dumps(
        {p: v for p, v in phases.items()
         if p.startswith("commit_") or p == "shplonk"}))
    for name, hist in warm_shapes.items():
        log(f"slice: warm proof shapes {name} ({SHAPE_KEYS[name]}: "
            f"launches) {json.dumps(_shape_table(hist))}")
    # every windowed launch over more than one row reaches the lane target
    # (ops/msm.py::fold_width); one row means C = npad
    narrow = [k for k in warm_shapes["fold_mixed"]
              if k[0] < LANE_TARGET and k[2] > 1]
    if narrow:
        raise AssertionError(f"slice: fold_mixed launches under "
                             f"{LANE_TARGET} lanes: {narrow}")
    adds = sum(per_warm[k] for k in ADD_KERNEL)
    if adds > ADD_LAUNCHES_PER_PROOF or per_warm["fold_dbl_any"]:
        raise AssertionError(f"slice: {adds} add-kernel and "
                             f"{per_warm['fold_dbl_any']} fold_dbl_any "
                             "launches in a warm proof")
    parts = vk.domain.extended_n // vk.domain.n
    one_lane = warm_shapes["mont_mul"][(1,)]
    by_prog = _field_prog_by_program(warm_shapes["field_prog"])
    if (by_prog.get("part", 0) != parts
            or one_lane > MONT_MUL_ONE_LANE_PER_PROOF
            or per_warm["field_addsub"] > ADDSUB_PER_PROOF):
        raise AssertionError(f"slice: field_prog launches {by_prog} ({parts} "
                             f"parts), {one_lane} one-lane mont_mul and "
                             f"{per_warm['field_addsub']} field_addsub "
                             "launches in a warm proof")
    _check_grand_products("slice", per_warm, gp_calls[1])
    log(f"slice: peak CUDA memory {peak / 2**30:.2f} GiB")
    log(f"slice: a warm proof launches field_addsub "
        f"{per_warm['field_addsub']}, mont_mul {per_warm['mont_mul']}, "
        f"field_linscan {per_warm['field_linscan']}, prodscan "
        f"{per_warm['prodscan']}, field_prog {by_prog}")
    log(f"slice: launches over keygen + 3 proofs {json.dumps(launches)}")
    log(f"slice: launches per warm proof {json.dumps(per_warm)}; mont_mul "
        f"at one lane {one_lane}, at 32,768 lanes "
        f"{warm_shapes['mont_mul'][(32768,)]}; fe_pow (one an inversion) "
        f"{per_warm['fe_pow']}")
    log(f"slice: profiled warm proof {json.dumps(prof)}")
    log(f"slice: CUDA kernels per warm proof {prof['cuda_kernels']}, device "
        f"busy share {prof['busy_share']:.4f}")
    log(f"slice: warm proof sha256 {sha}")
    if again != proof or profiled != proof:
        raise AssertionError("slice: same seed gave different proof bytes")
    if sha != RSA_PROOF_SHA256:
        raise AssertionError(f"slice: proof sha256 {sha}, expected "
                             f"{RSA_PROOF_SHA256}")
    _check_no_plain_loops("slice")
    if not verify_proof(vk, srs, c.instances(), proof):
        raise AssertionError("slice: warm proof does not verify")
    if not verify_proof(vk, srs, c.instances(), cold_proof):
        raise AssertionError("slice: cold proof does not verify")
    _record_path(report, "rsa_k15_keygen_and_3_proofs", launches,
                 ("mont_mul", "fe_pow", "field_prog", "ntt", "field_addsub",
                  "field_linscan", "prodscan", "fold_mixed", "fold_add",
                  "fold_add_any", "fold_add_tree", "fold_horner",
                  "fold_dbl_any"))
    # the warm proof's field programs (its part program, compressions and
    # weighted sums) at the rows it ran them over, against the interpreter
    checked = _path_shape_checks(
        "slice", {"field_prog": warm_shapes["field_prog"]},
        _path_programs(eng, pk), None, "cuda")
    log(f"slice: the warm proof's field programs bitwise equal to the "
        f"interpreter at each of their {checked['field_prog']} shapes")
    report["ntt"].update(advice_ntt_s=tr.phases["advice_ntt"],
                         quotient_s=tr.phases["quotient"])
    report["prodscan"].update(
        grand_products_launches_per_warm_proof=gp_calls[1],
        grand_products_s=tr.phases["grand_products"])
    report["field_prog"].update(warm_proof_s=warm,
                                warm_launches_by_program=by_prog,
                                quotient_s=tr.phases["quotient"],
                                profiled_warm_proof=prof,
                                proof_sha256=sha)
    for name, n in per_warm.items():
        report[name]["launches_per_warm_proof"] = n
        if name in warm_shapes:
            report[name]["warm_proof_shapes"] = _shape_table(
                warm_shapes[name])
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


MSM_N, MSM_B = 1 << 15, 8


def msm_vectors() -> list:
    """Phase 5's MSM_B scalar vectors of MSM_N: random ones, bytes, zeros
    and the edge values R - 1 and 1."""
    import numpy as np
    from halo2tpu_torch.fields.bn254 import R
    n, B = MSM_N, MSM_B
    rng = np.random.default_rng(15)

    def full(m):
        return [int.from_bytes(rng.bytes(32), "big") % R for _ in range(m)]

    edge = [0] * n
    for i in range(0, n, 997):
        edge[i] = R - 1
        edge[i + 1] = 1
    return ([full(n) for _ in range(B - 3)]
            + [[int(v) for v in rng.integers(0, 256, n)], [0] * n, edge])


def phase_msm(report: dict, srs, eng) -> None:
    import torch
    from halo2tpu_torch.curves import g1 as G1
    from halo2tpu_torch.curves.jpoint import affine_to_device
    from halo2tpu_torch.ops.msm import msm

    n, B = MSM_N, MSM_B
    vectors = msm_vectors()
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
    adds = sum(launches[k] for k in ADD_KERNEL)
    if (launches["fold_mixed_tiled_rows"] + launches["fold_mixed_tiled"] != 1
            or adds > ADD_LAUNCHES_PER_MSM or launches["fold_dbl_any"]):
        raise AssertionError(f"msm: expected one row-fold launch, at most "
                             f"{ADD_LAUNCHES_PER_MSM} add-kernel launches and "
                             "no fold_dbl_any")
    # mont_mul: device_to_affine's one Montgomery decode; fold_add: the
    # tail's two lanewise rounds of at least a wave of adds
    _record_path(report, "msm_n32768_b8", launches,
                 ("mont_mul", "fold_mixed_tiled_rows", "fold_add",
                  "fold_add_tree", "fold_horner"))

    m = 256
    small = [v[:m] for v in vectors]
    got = msm(affine_to_device(srs.g_lagrange[:m], "cuda"), small)
    if got != [G1.msm(srs.g_lagrange[:m], v) for v in small]:
        raise AssertionError("msm: n = 256 differs from the host G1.msm")
    log(f"msm: n = {m}, B = {B}: equal to the host G1.msm")
    report["fold_mixed_tiled_rows"].update(
        msm_ms=msm_s * 1e3, windowed_commit_ms=win_s * 1e3,
        msm_peak_gib=peak / 2**30, msm_resident_gib=resident / 2**30)


# -- phase 6: the composite Aadhaar circuit at k=15 --------------------------

COMPOSITE_SEED = 12345678        # nullifier seed and signal of halo2tpu's
COMPOSITE_SIGNAL = 4294967295    # slow test (tests/test_aadhaar_composite.py)
COMPOSITE_SIGNED_LEN = 700
# the golden QR's fields (tests/test_qr_extractor.py)
COMPOSITE_FIELDS = {"gender": ord("M"), "pincode": 110051,
                    "state_packed": int.from_bytes(b"Delhi" + bytes(11),
                                                   "little")}


def composite_circuit():
    """The composite Aadhaar circuit at the default AadhaarParams (k=15)
    over the full 1137-byte golden QR, the first 700 bytes signed with the
    pinned key."""
    from halo2tpu_torch.circuits.aadhaar_qr import (AadhaarParams,
                                                    AadhaarQRVerifierCircuit,
                                                    AadhaarWitness)
    with open(os.path.join(ROOT, "tests/golden/qr_msg.json")) as f:
        qr = bytes(json.load(f)["msg"])
    with open(os.path.join(ROOT, "tests/golden/rsa_key_2048.json")) as f:
        key = json.load(f)
    sig = _pkcs1v15_sha256_sign(key["p"], key["q"], key["e"],
                                qr[:COMPOSITE_SIGNED_LEN])
    w = AadhaarWitness(qr, key["p"] * key["q"], sig,
                       nullifier_seed=COMPOSITE_SEED,
                       signal_hash=COMPOSITE_SIGNAL)
    return AadhaarQRVerifierCircuit(w, AadhaarParams(
        signed_len=COMPOSITE_SIGNED_LEN))


def _check_composite_instances(c) -> None:
    """The public instances are the native outputs, field by field, and
    hold the golden QR's gender, pincode and state."""
    from halo2tpu_torch.circuits.aadhaar_qr import (native_outputs,
                                                    packed_photo_elements)
    from halo2tpu_torch.ops.poseidon import hash_elements
    w, p = c.w, c.p
    o = native_outputs(w, p)
    want = [w.nullifier_seed, w.signal_hash, o["pubkey_hash"],
            o["nullifier"], o["timestamp"], o["above18"], o["gender"],
            o["pincode"], o["state_packed"]]
    qr = w.qr_data
    if len(qr) != 1137 or c.instances() != [want]:
        raise AssertionError("composite: instances differ from the native "
                             "outputs")
    if {k: o[k] for k in COMPOSITE_FIELDS} != COMPOSITE_FIELDS:
        raise AssertionError(f"composite: fields {o} are not the QR's")
    photo = qr[[i for i, b in enumerate(qr) if b == 255][17] + 1:]
    nullifier = hash_elements([COMPOSITE_SEED] + packed_photo_elements(
        photo, p.max_photo))
    if o["nullifier"] != nullifier or o["above18"] != 1:
        raise AssertionError("composite: nullifier or age flag is wrong")


def phase_composite(report: dict, srs, cache_dir: str) -> None:
    """Keygen, a cold and two warm proofs of the composite circuit on the
    card, on phase 4's SRS (and, through it, its MSM window table)."""
    import torch
    from halo2tpu_torch.plonk.engine import TorchEngine
    from halo2tpu_torch.plonk.keygen import keygen
    from halo2tpu_torch.plonk.prover import _get_state, create_proof
    from halo2tpu_torch.plonk.verifier import verify_proof
    from halo2tpu_torch.utils.trace import Tracer

    k = 15
    t0 = time.perf_counter()
    c = composite_circuit()
    _check_composite_instances(c)
    inst = c.instances()
    log(f"composite: instances equal the native outputs "
        f"({time.perf_counter() - t0:.1f} s)")

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    kg_tr = Tracer()
    t0 = time.perf_counter()
    pk, vk = keygen(c, k, srs, device="cuda", tracer=kg_tr)
    torch.cuda.synchronize()
    kg = time.perf_counter() - t0
    cs, d = vk.cs, vk.domain
    parts = d.extended_n // d.n
    log(f"composite: keygen {kg:.1f} s "
        f"{json.dumps({p: round(v, 3) for p, v in kg_tr.phases.items()})}; "
        f"degree {cs.degree()}, {parts} parts, {cs.num_advice} advice, "
        f"{cs.num_fixed} fixed, {len(cs.permutation_columns)} permutation "
        f"columns in {cs.num_permutation_chunks()} chunks of "
        f"{cs.permutation_chunk_len()}, {len(cs.lookups)} lookups")
    eng = TorchEngine(d, srs, "cuda")
    gp_calls = _count_grand_products(eng)
    t0 = time.perf_counter()
    cold_proof = create_proof(pk, srs, c, inst, rng_seed=7, engine=eng)
    cold = time.perf_counter() - t0
    tr = Tracer()
    before, shapes_before = _counts(), _shapes()
    t0 = time.perf_counter()
    proof = create_proof(pk, srs, c, inst, rng_seed=8, engine=eng, tracer=tr)
    warm = time.perf_counter() - t0
    per_warm = {n: v - before[n] for n, v in _counts().items()}
    warm_shapes = {n: h - shapes_before[n] for n, h in _shapes().items()}
    t0 = time.perf_counter()
    again = create_proof(pk, srs, c, inst, rng_seed=8, engine=eng)
    warm2 = time.perf_counter() - t0
    launches = _counts()
    peak = torch.cuda.max_memory_allocated()
    from profile_proof import profile_run
    profiled, prof = profile_run(
        lambda: create_proof(pk, srs, c, inst, rng_seed=8, engine=eng),
        cache_dir)
    st = _get_state(pk, eng)
    prog = st.quotient_program
    sha = hashlib.sha256(proof).hexdigest()
    phases = {p: round(v, 3) for p, v in tr.phases.items()}
    log(f"composite: cold proof {cold:.2f} s, warm proofs {warm:.2f} s, "
        f"{warm2:.2f} s; proof {len(proof)} bytes")
    log(f"composite: warm phases {json.dumps(phases)}")
    log(f"composite: part program {prog.code.shape[0]} instructions in "
        f"{prog.groups} sub-programs {json.dumps(prog.op_counts())}, "
        f"{prog.slots} slots, "
        f"{len(prog.leaf_keys)} leaves, {len(prog.const_keys)} constants")
    log(f"composite: part cache holds {st.parts_cached_bytes} bytes of "
        f"fixed and sigma parts (budget left {st._parts_budget} bytes)")
    log(f"composite: peak CUDA memory {peak / 2**30:.2f} GiB "
        f"({peak} bytes)")
    for name, hist in warm_shapes.items():
        if hist:
            log(f"composite: warm proof shapes {name} ({SHAPE_KEYS[name]}: "
                f"launches) {json.dumps(_shape_table(hist))}")
    log(f"composite: launches over keygen + 3 proofs {json.dumps(launches)}")
    log(f"composite: launches per warm proof {json.dumps(per_warm)}")
    log(f"composite: profiled warm proof {json.dumps(prof)}")
    log(f"composite: CUDA kernels per warm proof {prof['cuda_kernels']}, "
        f"device busy share {prof['busy_share']:.4f}")
    log(f"composite: warm proof sha256 {sha}")
    if sha != COMPOSITE_PROOF_SHA256:
        raise AssertionError(f"composite: proof sha256 {sha}, expected "
                             f"{COMPOSITE_PROOF_SHA256}")
    _check_no_plain_loops("composite")
    _check_grand_products("composite", per_warm, gp_calls[1])
    by_prog = _field_prog_by_program(warm_shapes["field_prog"])
    log(f"composite: a warm proof launches field_addsub "
        f"{per_warm['field_addsub']}, mont_mul {per_warm['mont_mul']}, "
        f"field_linscan {per_warm['field_linscan']}, prodscan "
        f"{per_warm['prodscan']}, field_prog {by_prog}")
    if by_prog.get("part", 0) != parts or parts != 8:
        raise AssertionError(f"composite: field_prog launches {by_prog} in a "
                             f"warm proof, {parts} parts")
    if again != proof or profiled != proof:
        raise AssertionError("composite: same seed gave different bytes")
    if not verify_proof(vk, srs, inst, proof):
        raise AssertionError("composite: warm proof does not verify")
    if not verify_proof(vk, srs, inst, cold_proof):
        raise AssertionError("composite: cold proof does not verify")
    bad = [list(inst[0])]
    bad[0][0] ^= 1
    if verify_proof(vk, srs, bad, proof):
        raise AssertionError("composite: verifies with nullifier_seed ^ 1")
    _record_path(report, "composite_k15_keygen_and_3_proofs", launches,
                 ("mont_mul", "fe_pow", "field_prog", "ntt", "field_addsub",
                  "field_linscan", "prodscan", "fold_mixed", "fold_add_tree",
                  "fold_horner"))
    # the warm proof's field programs (its part program, the pair lookups'
    # compressions, the weighted sums), as phase 4 checks RSA's
    checked = _path_shape_checks(
        "composite", {"field_prog": warm_shapes["field_prog"]},
        _path_programs(eng, pk), None, "cuda")
    log(f"composite: the warm proof's field programs bitwise equal to the "
        f"interpreter at each of their {checked['field_prog']} shapes")
    for name, n in per_warm.items():
        report[name]["composite_launches_per_warm_proof"] = n
    report["prodscan"].update(
        composite_grand_products_launches_per_warm_proof=gp_calls[1],
        composite_grand_products_s=tr.phases["grand_products"])
    report["ntt"].update(composite_advice_ntt_s=tr.phases["advice_ntt"],
                         composite_quotient_s=tr.phases["quotient"])
    report["field_prog"].update(
        composite_warm_launches_by_program=by_prog, composite_keygen_s=kg, composite_cold_proof_s=cold,
        composite_warm_proof_s=[warm, warm2], composite_phases=phases,
        composite_peak_bytes=peak,
        composite_parts_cached_bytes=st.parts_cached_bytes,
        composite_program={"instructions": int(prog.code.shape[0]),
                           "groups": prog.groups,
                           "slots": prog.slots,
                           "leaves": len(prog.leaf_keys)},
        composite_profiled_warm_proof=prof, composite_proof_sha256=sha)
    log("composite: proofs verify, nullifier_seed ^ 1 is rejected; same "
        "seed, same bytes")


# -- phase 7: the multi-device prover on shards of the card ------------------

SHARDED_DS = (1, 2, 4, 8)        # shards of one card in the four-step checks
SHARDED_PROOF_D = 4              # shards of the RSA proofs
# kernels the sharded RSA proofs must launch (the commitments take the
# bit-serial fold: no windowed fold_mixed, no fold_dbl_any)
SHARDED_KERNELS = ("mont_mul", "fe_pow", "field_prog", "ntt",
                   "field_addsub", "field_linscan", "prodscan",
                   "fold_mixed_tiled_rows", "fold_add_tree", "fold_horner")


def _card_mesh(d: int, devices=None):
    """d shards of cuda:0, or one shard a device of `devices`."""
    import torch
    from halo2tpu_torch.parallel.mesh import Mesh
    return Mesh(devices or [torch.device("cuda", 0)] * d)


def _wall_ms(fn, devs, runs: int = 5) -> float:
    """Median wall ms of fn() over `runs` calls after one, each ended by a
    synchronize of every device of the mesh."""
    import torch

    def once():
        t0 = time.perf_counter()
        fn()
        for d in dict.fromkeys(devs):
            torch.cuda.synchronize(d)
        return (time.perf_counter() - t0) * 1e3

    once()
    return statistics.median(once() for _ in range(runs))


def _sharded_four_step(meshes: dict) -> list:
    """_FlatFourStep at 2^15 x 1 and 2^18 (the composite's extended
    domain), forward and inverse, on each mesh, bitwise against one ntt
    kernel call; wall ms of each beside that call's."""
    import torch
    from halo2tpu_torch.fields.bn254 import R, fr_root_of_unity, inv_mod
    from halo2tpu_torch.ops import ntt as tntt
    from halo2tpu_torch.plonk.sharded import _FlatFourStep
    g = torch.Generator().manual_seed(70)
    rows = []
    for k in (15, 18):
        n, omega = 1 << k, fr_root_of_unity(k)
        x = _rand_fe(g, n, "cuda")
        plan = tntt.get_plan(n, omega, "cuda")
        for inverse in (False, True):
            single = ((lambda: tntt.intt(plan, x)) if inverse
                      else (lambda: tntt.ntt(plan, x)))
            want = single()
            row = {"n": n, "inverse": inverse,
                   "ntt_ms": _wall_ms(single, [x.device])}
            for label, mesh in meshes.items():
                fs = (_FlatFourStep(mesh, "shard", n, inv_mod(omega, R),
                                    scale=inv_mod(n, R)) if inverse
                      else _FlatFourStep(mesh, "shard", n, omega))
                blocks = mesh.split(x)
                got = torch.cat([b.to(x.device) for b in fs(blocks)])
                if _max_abs_err(got, want):
                    raise AssertionError(f"sharded: four-step {label} at n "
                                         f"= {n} differs from ntt")
                ms = _wall_ms(lambda: fs(blocks), mesh.flat)
                row[label] = {"ms": ms, "over_ntt": ms / row["ntt_ms"]}
            rows.append(row)
            way = "inverse" if inverse else "forward"
            log(f"sharded: four-step n = {n} {way} bitwise equal to ntt; "
                f"wall ms {json.dumps(row)}")
    return rows


def _path_programs(eng, pk) -> list:
    """The field programs a proof on eng runs: the programs its
    run_program ran as it ran them (a sharded engine's with their
    rotations in the leaves), its compressions, the quotient's part
    program and the weighted sums."""
    from halo2tpu_torch.plonk.engine import _SUM_PROGRAMS
    state = pk._torch_state_cache[eng.state_key]
    return ([flat for _, flat, _ in getattr(eng, "_unrotated", {}).values()]
            + list(eng._compress.values()) + [state.quotient_program]
            + list(_SUM_PROGRAMS.values()))


def _path_shape_checks(path: str, hist: dict, programs: list, card: "Card",
                       dev) -> dict:
    """Each kernel of a path at every shape the path launched it with (hist:
    kernel -> Counter of SHAPE_KEYS tuples), on new random inputs of that
    shape, bitwise against its plain version: both directions of a scan,
    the NTT with and without its fused scale, a product and a squaring,
    every field program of `programs` with a field_prog shape the path
    ran whose rotations its rows can hold, at those rows.  Returns the
    shapes checked by kernel; raises on a difference or on a shape no
    case here can build."""
    import torch
    from halo2tpu_torch.fields import jfield
    from halo2tpu_torch.fields.bn254 import R, fr_root_of_unity
    from halo2tpu_torch.ops import cuda_ec, cuda_field
    from halo2tpu_torch.ops import ntt as tntt
    from halo2tpu_torch.ops.field_prog import (LOAD, field_prog,
                                               field_prog_plain)
    from halo2tpu_torch.ops.msm import SCALAR_BITS
    FR = jfield.FR
    g = torch.Generator().manual_seed(72)

    def rand_a() -> int:
        return int(torch.randint(1, 2**62, (1,), generator=g)) ** 4 % R

    def plain_mont_mul(a, b, chunk: int = 1 << 22):
        """mont_mul_plain by chunks of lanes: its (lanes, 16, 16) float64
        products take 2 KiB a lane (the mock's column encodings run 8.3 M
        lanes and more)."""
        return torch.cat([cuda_field.mont_mul_plain(FR, a[i:i + chunk],
                                                    b[i:i + chunk])
                          for i in range(0, a.shape[0], chunk)])

    def pairs(name, key):
        """(label, kernel call, plain call) at one shape of kernel name."""
        if name == "mont_mul":
            a, b = (_rand_fe(g, key[0], dev) for _ in range(2))
            return [("product", lambda: cuda_field.mont_mul(FR, a, b),
                     lambda: plain_mont_mul(a, b)),
                    ("square", lambda: cuda_field.mont_mul(FR, a, a),
                     lambda: plain_mont_mul(a, a))]
        if name == "fe_pow":
            a = _rand_fe(g, key[0], dev)
            return [(f"e {e}", lambda e=e: cuda_field.mont_pow(FR, a, e),
                     lambda e=e: cuda_field.mont_pow_plain(FR, a, e))
                    for e in (R - 2, rand_a())]
        if name == "field_addsub":
            op = cuda_field._OP_NAMES.index(key[1])
            a, b = (_rand_fe(g, key[0], dev) for _ in range(2))
            plain = cuda_field._PLAIN[op]
            args = ([(a,)] if op == cuda_field.NEG
                    else [(a, b), (a, b[:1])])
            return [(f"operands {[tuple(x.shape) for x in xs]}",
                     lambda xs=xs: cuda_field.add_sub(FR, op, *xs),
                     lambda xs=xs: plain(FR, *xs)) for xs in args]
        if name == "ntt":
            n, C = key[0], key[1]
            x = _rand_fe(g, n * C, dev).reshape(n, C, 8)
            plan = tntt.get_plan(n, fr_root_of_unity(n.bit_length() - 1),
                                 dev)
            sc = _rand_fe(g, 1, dev)[0]
            return [("forward", lambda: tntt.ntt_kernel(plan, x),
                     lambda: tntt.ntt_plain(plan, x)),
                    ("scaled", lambda: tntt.ntt_kernel(plan, x, scale=sc),
                     lambda: cuda_field.mont_mul_plain(
                         FR, tntt.ntt_plain(plan, x), sc))]
        if name in ("field_linscan", "prodscan"):
            n, cols, mode, kind = key
            v = _rand_fe(g, cols * n, dev).reshape(cols, n, 8)
            ex, tot = mode == "exclusive", mode == "totals"
            if kind == "prod":
                return [(f"reverse {r}",
                         lambda r=r: cuda_field.prodscan(FR, v, r, ex, tot),
                         lambda r=r: cuda_field.prodscan_plain(FR, v, r, ex,
                                                               tot))
                        for r in (False, True)]
            a = 1 if kind == "one" else rand_a()
            return [(f"reverse {r}",
                     lambda r=r: cuda_field.linscan(FR, v, a, r, ex, tot),
                     lambda r=r: cuda_field.linscan_plain(FR, v, a, r, ex,
                                                          tot))
                    for r in (False, True)]
        if name == "fold_mixed_tiled_rows":
            L, C, rows = key
            acc, pts, sc, _, _ = _rows_case(g, L // (SCALAR_BITS * C), C,
                                            card, dev, n=C * rows)
            return [("rows", lambda: cuda_ec.fold_mixed_tiled_rows(
                        acc, pts, sc, C, 0, rows),
                     lambda: cuda_ec.fold_mixed_tiled_rows_plain(
                        acc, pts, sc, C, 0, rows))]
        if name == "fold_add_tree":
            G, W = key
            acc = (_tree_case(g, G, W, dev)[0] if W > 8
                   else _rand_points(g, G * W, dev))
            return [("tree", lambda: cuda_ec.fold_add_tree(acc, G, W),
                     lambda: cuda_ec.fold_add_tree_plain(acc, G, W))]
        if name == "fold_horner":
            B, P, times = key
            parts = _horner_case(g, B, P, times, dev)[0]
            return [("horner", lambda: cuda_ec.fold_horner(parts, times),
                     lambda: cuda_ec.fold_horner_plain(parts, times))]
        if name == "field_prog":
            prog_name, n, size, groups = key
            # a program compiled for more rows may hold a rotation the
            # kernel cannot take at n (it wants each rot in [0, n))
            progs = {id(p): p for p in programs
                     if (p.name, p.code.shape[0], p.groups)
                     == (prog_name, size, groups)
                     and (p.code[p.code[:, 0] == LOAD, 3] < n).all()}
            if not progs:
                raise AssertionError(f"{path}: no program of the path has "
                                     f"the field_prog shape {key}")
            return program_pairs(list(progs.values()), n)
        raise AssertionError(f"{path}: no shape check for kernel {name}")

    def program_pairs(progs, n):
        """Each program at n rows, its inputs made as its turn comes."""
        for i, prog in enumerate(progs):
            leaves = [_rand_fe(g, n, dev) for _ in prog.leaf_keys]
            consts = _rand_fe(g, len(prog.const_keys), dev)
            yield (f"program {i} of {len(progs)}",
                   lambda: field_prog(FR, prog, leaves, consts, n),
                   lambda: field_prog_plain(FR, prog, leaves, consts, n))

    # these launches and plain runs are comparisons: no path's counts
    wrappers, loops = _wrappers(), _plain_loops()
    saved = ({n: (w.launches, w.shapes.copy()) for n, w in wrappers.items()},
             {n: f.cuda_calls for n, f in loops.items()})
    checked = {}
    try:
        for name, counter in hist.items():
            for key in sorted(counter):
                for label, fn, plain in pairs(name, key):
                    got, want = fn(), plain()
                    err = (_max_abs_err(got, want) if got.numel()
                           else int(got.shape != want.shape))
                    if err:
                        raise AssertionError(
                            f"{path}: {name} at {SHAPE_KEYS[name]} {key} "
                            f"({label}): kernel != plain ({err})")
            if counter:
                checked[name] = len(counter)
    finally:
        for n, w in wrappers.items():
            w.launches = saved[0][n][0]
            w.shapes.clear()
            w.shapes.update(saved[0][n][1])
        for n, f in loops.items():
            f.cuda_calls = saved[1][n]
    return checked


def phase_sharded(report: dict, srs, cache_dir: str) -> None:
    """The multi-device prover (plonk/sharded.py, parallel/*) on D shards of
    cuda:0 (and, on a machine with several cards, one shard a card)."""
    import numpy as np
    import torch
    from halo2tpu_torch.curves.jpoint import affine_to_device
    from halo2tpu_torch.fields.bn254 import R, fr_root_of_unity
    from halo2tpu_torch.fields.jfield import FR, ints_to_limbs
    from halo2tpu_torch.ops import ntt as tntt
    from halo2tpu_torch.ops.msm import (_bit_partials, _partials_to_affine,
                                        msm)
    from halo2tpu_torch.parallel.msm import sharded_bit_partials
    from halo2tpu_torch.parallel.pipeline import make_sharded_prove_core
    from halo2tpu_torch.parallel.scaling_report import run_report
    from halo2tpu_torch.plonk.keygen import keygen, keygen_cached
    from halo2tpu_torch.plonk.prover import create_proof
    from halo2tpu_torch.plonk.sharded import ShardedTorchEngine
    from halo2tpu_torch.plonk.srs import setup
    from halo2tpu_torch.plonk.verifier import verify_proof
    from halo2tpu_torch.utils.trace import Tracer

    torch.cuda.empty_cache()
    out = report["ntt"].setdefault("sharded", {})
    meshes = {f"D{d}": _card_mesh(d) for d in SHARDED_DS}
    out["four_step"] = _sharded_four_step(meshes)

    # the sharded MSM at phase 5's inputs against msm()
    n, B, D = MSM_N, MSM_B, SHARDED_PROOF_D
    vectors = msm_vectors()
    pts = affine_to_device(srs.g_lagrange[:n], "cuda")
    limbs = torch.from_numpy(np.stack([ints_to_limbs(
        [v % R for v in s_]) for s_ in vectors])).to("cuda")
    mesh = meshes[f"D{D}"]
    want = msm(pts, vectors)

    def sharded_msm():
        return _partials_to_affine(sharded_bit_partials(mesh, pts, limbs))

    if sharded_msm() != want:
        raise AssertionError("sharded: the sharded MSM differs from msm()")
    # msm() encodes its python-int scalars on the host; the sharded MSM
    # and msm()'s device part take the same limbs
    msm_ms = {"msm": _wall_ms(lambda: msm(pts, vectors), mesh.flat, 3),
              "msm_from_limbs": _wall_ms(lambda: _partials_to_affine(
                  _bit_partials(pts, limbs)), mesh.flat, 3),
              f"sharded_D{D}": _wall_ms(sharded_msm, mesh.flat, 3)}
    log(f"sharded: sharded_bit_partials n = {n}, B = {B}, D = {D}: the "
        f"points of msm(); wall ms {json.dumps(msm_ms)}")
    report["fold_mixed_tiled_rows"]["sharded_msm_ms"] = msm_ms

    # the prove core at n1 = 128, n2 = 256, D = 4 against one device
    n1, n2 = 128, 256
    omega = fr_root_of_unity(15)
    g = torch.Generator().manual_seed(71)
    x = _rand_fe(g, n1 * n2, "cuda")
    fn, shardings, tw = make_sharded_prove_core(mesh, n1, n2, omega)
    args = [s_.put(a) for a, s_ in zip((tw, x.reshape(n1, n2, 8), pts,
                                        limbs[:1]), shardings)]
    gate, partials = fn(*args)
    ev = tntt.ntt(tntt.get_plan(n1 * n2, omega, "cuda"), x)
    want_gate = FR.decode(ev)
    got = gate.gather().transpose(0, 1).reshape(-1, 8)
    if FR.decode(got) != [v * v % R for v in want_gate]:
        raise AssertionError("sharded: the prove core's gate differs")
    if _partials_to_affine(partials) != want[:1]:
        raise AssertionError("sharded: the prove core's MSM differs")
    log("sharded: prove core n1 = 128, n2 = 256, D = 4: the single-device "
        "NTT, gate and MSM")

    # the golden circuits at D = 2 and 4 (each mesh a new engine)
    with open(os.path.join(ROOT, "tests/golden/torch_port_proofs.json")) as f:
        golden = json.load(f)
    for name, (c, k, inst, seed) in golden_circuits().items():
        gsrs = setup(k)
        pk, vk = keygen(c, k, gsrs, device="cuda")
        for d in (2, 4):
            t0 = time.perf_counter()
            eng = ShardedTorchEngine(vk.domain, gsrs, meshes[f"D{d}"])
            proof = create_proof(pk, gsrs, c, inst, rng_seed=seed,
                                 engine=eng)
            if proof.hex() != golden[name]["proof"]:
                raise AssertionError(f"sharded: golden {name} at D = {d}: "
                                     "proof bytes differ")
            if not verify_proof(vk, gsrs, inst, proof):
                raise AssertionError(f"sharded: golden {name} at D = {d} "
                                     "does not verify")
            log(f"sharded: golden {name} at D = {d}: byte-identical, "
                f"verifies ({time.perf_counter() - t0:.2f} s)")

    # RSA-SHA256 at k=15 on D shards of cuda:0: phase 4's pk (from its
    # cache file) and SRS
    c = rsa_circuit()
    pk, vk = keygen_cached(c, 15, srs, cache_key="rsa_sha256_chip_smoke",
                           device="cuda", cache_dir=cache_dir)
    eng = ShardedTorchEngine(vk.domain, srs, mesh)
    _check_no_plain_loops("sharded checks")
    _zero_counts()
    t0 = time.perf_counter()
    cold_proof = create_proof(pk, srs, c, c.instances(), rng_seed=3,
                              engine=eng)
    cold = time.perf_counter() - t0
    tr = Tracer()
    before, shapes_before = _counts(), _shapes()
    t0 = time.perf_counter()
    proof = create_proof(pk, srs, c, c.instances(), rng_seed=4, engine=eng,
                         tracer=tr)
    warm = time.perf_counter() - t0
    launches = _counts()
    per_warm = {k_: v - before[k_] for k_, v in launches.items()}
    warm_shapes = {k_: h - shapes_before[k_] for k_, h in _shapes().items()}
    _check_no_plain_loops("sharded")
    from profile_proof import profile_run
    profiled, prof = profile_run(
        lambda: create_proof(pk, srs, c, c.instances(), rng_seed=4,
                             engine=eng), cache_dir)
    sha = hashlib.sha256(proof).hexdigest()
    phases = {p: round(v, 3) for p, v in tr.phases.items()}
    single = {k_: report[k_].get("launches_per_warm_proof", 0)
              for k_ in per_warm}
    log(f"sharded: RSA k=15 on {D} shards of cuda:0: cold proof {cold:.2f} "
        f"s, warm proof {warm:.2f} s (TorchEngine, phase 4: "
        f"{report['field_prog']['warm_proof_s']:.2f} s)")
    log(f"sharded: warm phases {json.dumps(phases)}")
    log(f"sharded: launches per warm proof {json.dumps(per_warm)}; "
        f"TorchEngine's (phase 4) {json.dumps(single)}")
    for name, hist in warm_shapes.items():
        if hist:
            log(f"sharded: warm proof shapes {name} ({SHAPE_KEYS[name]}: "
                f"launches) {json.dumps(_shape_table(hist))}")
    log(f"sharded: profiled warm proof {json.dumps(prof)}; TorchEngine's "
        f"(phase 4) CUDA kernels "
        f"{report['field_prog']['profiled_warm_proof']['cuda_kernels']}")
    log(f"sharded: warm proof sha256 {sha}")
    if sha != RSA_PROOF_SHA256 or profiled != proof:
        raise AssertionError(f"sharded: RSA proof sha256 {sha}, expected "
                             f"{RSA_PROOF_SHA256}")
    if not verify_proof(vk, srs, c.instances(), proof):
        raise AssertionError("sharded: RSA warm proof does not verify")
    if not verify_proof(vk, srs, c.instances(), cold_proof):
        raise AssertionError("sharded: RSA cold proof does not verify")
    _record_path(report, f"rsa_k15_sharded_d{D}_2_proofs", launches,
                 SHARDED_KERNELS)
    # every kernel of the warm proof at each shape it launched it with
    checked = _path_shape_checks("sharded", warm_shapes,
                                 _path_programs(eng, pk), Card(), "cuda")
    log("sharded: every kernel of the warm proof bitwise equal to its "
        f"plain version at each of its shapes {json.dumps(checked)}")
    out["shapes_checked"] = checked
    for name, n_ in per_warm.items():
        report[name]["sharded_launches_per_warm_proof"] = n_
    out.update(rsa_d=D, rsa_cold_proof_s=cold, rsa_warm_proof_s=warm,
               rsa_phases=phases, rsa_profiled_warm_proof=prof,
               rsa_proof_sha256=sha, msm_ms=msm_ms)
    del eng, pk

    # one shard a card, where there are several
    cards = torch.cuda.device_count()
    if cards > 1:
        m = 1 << (cards.bit_length() - 1)
        devs = [torch.device("cuda", i) for i in range(m)]
        out["cards"] = _sharded_four_step({f"cards{m}": _card_mesh(m, devs)})
        c, k, inst, seed = golden_circuits()["timestamp_k6"]
        gsrs = setup(k)
        pk, vk = keygen(c, k, gsrs, device="cuda")
        eng = ShardedTorchEngine(vk.domain, gsrs, _card_mesh(m, devs))
        proof = create_proof(pk, gsrs, c, inst, rng_seed=seed, engine=eng)
        if proof.hex() != golden["timestamp_k6"]["proof"]:
            raise AssertionError(f"sharded: Timestamp on {m} cards differs")
        log(f"sharded: Timestamp k=6 on {m} cards, one shard a card: "
            "byte-identical")
    else:
        log("sharded: one card: no run with one shard a card")

    rep = run_report()
    log(json.dumps(rep))
    out["scaling_report"] = rep
    log("sharded: four-step, MSM, prove core, golden and RSA proofs on "
        "shards of the card equal the single-device results")


# -- phase 8: the mock prover on the card ------------------------------------

MOCK_K = 15


def _mock_verify(label: str, mp, launched: dict) -> list:
    """mp.verify() on the card: its failures as {"kind", "detail"} dicts;
    logs each part's wall time and the field_prog launches, and keeps the
    programs it ran in `launched` (by identity)."""
    from halo2tpu_torch.ops.field_prog import field_prog
    before = field_prog.launches
    fails = [{"kind": f.kind, "detail": f.detail} for f in mp.verify()]
    for prog in mp.programs:
        launched[id(prog)] = prog
    times = {p: round(v, 4) for p, v in mp.times.items()}
    log(f"mock: {label}: {len(fails)} failures, field_prog launches "
        f"{field_prog.launches - before}, wall s {json.dumps(times)}")
    for f in fails:
        log(f"  [{f['kind']}] {f['detail']}")
    return fails


def phase_mock(report: dict) -> None:
    """The mock prover (plonk/mock.py) on the card at k = 15: RSA-SHA256
    and the composite satisfied, RSA with MOCK_TAMPER equal to halo2tpu's
    list (tests/golden/mock_k15_failures.json), the composite with a wrong
    nullifier seed failing; mont_mul at each lane count and every field
    program it ran against their plain versions."""
    import torch
    from halo2tpu_torch.ops.field_prog import field_prog
    from halo2tpu_torch.plonk.mock import MockProver
    with open(os.path.join(ROOT, "tests/golden/mock_k15_failures.json")) as f:
        golden = json.load(f)
    if [tuple(t) for t in golden["tamper"]] != list(MOCK_TAMPER):
        raise AssertionError("mock: the golden's tamper is not MOCK_TAMPER")
    torch.cuda.empty_cache()
    rsa, comp = rsa_circuit(), composite_circuit()
    inst = comp.instances()
    wrong = [list(inst[0])]
    wrong[0][0] ^= 1
    launched: dict = {}
    _zero_counts()
    t0 = time.perf_counter()
    mp = MockProver.run(MOCK_K, rsa, rsa.instances(), device="cuda")
    rsa_ok = _mock_verify("rsa k=15 satisfied", mp, launched)
    rsa_times = dict(mp.times)
    for col, row, value in MOCK_TAMPER:
        mp.asn.advice[col][row] = value
    rsa_bad = _mock_verify("rsa k=15 with MOCK_TAMPER", mp, launched)
    mp = MockProver.run(MOCK_K, comp, inst, device="cuda")
    comp_ok = _mock_verify("composite k=15 satisfied", mp, launched)
    comp_times = dict(mp.times)
    mp = MockProver(mp.cs, mp.asn, wrong, mp.n, device="cuda")
    comp_bad = _mock_verify("composite k=15 nullifier_seed ^ 1", mp,
                            launched)
    wall = time.perf_counter() - t0
    counts, shapes = _counts(), _shapes()
    _check_no_plain_loops("mock")
    log(f"mock: four runs in {wall:.2f} s; launches {json.dumps(counts)}")
    log(f"mock: field_prog shapes ({SHAPE_KEYS['field_prog']}: launches) "
        f"{json.dumps(_shape_table(shapes['field_prog']))}")
    if rsa_ok or comp_ok:
        raise AssertionError("mock: a flagship circuit is not satisfied")
    if rsa_bad != golden["failures"]:
        raise AssertionError("mock: the tampered RSA list differs from "
                             "tests/golden/mock_k15_failures.json")
    if not comp_bad:
        raise AssertionError("mock: nullifier_seed ^ 1 gives no failure")
    _record_path(report, "mock_k15", counts, ("mont_mul", "field_prog"))
    # mont_mul at every lane count the phase launched it with (the column
    # encoding, FR.encode and FR.decode), and every field program it ran
    t0 = time.perf_counter()
    checked = _path_shape_checks(
        "mock", {k: shapes[k] for k in ("mont_mul", "field_prog")},
        list(launched.values()), None, "cuda")
    log(f"mock: mont_mul at lanes {sorted(k[0] for k in shapes['mont_mul'])}"
        f" and the {len(launched)} field programs it ran bitwise equal to "
        f"their plain versions, shapes by kernel {json.dumps(checked)} "
        f"({time.perf_counter() - t0:.1f} s)")
    report["field_prog"]["mock"] = {
        "rsa_k15_s": rsa_times, "composite_k15_s": comp_times,
        "four_runs_s": wall, "programs": len(launched),
        "shapes_checked": checked,
        "launches": counts["field_prog"],
        "launches_by_program": _field_prog_by_program(shapes["field_prog"]),
        "tampered_failures": len(rsa_bad),
        "wrong_instance_failures": len(comp_bad)}
    log("mock: RSA and the composite satisfied at k=15; the tampered list "
        "is halo2tpu's; a wrong nullifier seed fails")


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
    for kernel, res in sorted(_build.resources.items()):
        log(f"build: {kernel}: {res.get('registers')} registers, "
            f"{res.get('spill_bytes')} bytes spilled (stores + loads), "
            f"{res.get('stack_bytes')} bytes stack, {res.get('smem_bytes')} "
            "bytes shared")
        for line in res["lines"]:
            log(f"  {line}")
    over = {k: (r.get("registers"), r.get("spill_bytes"))
            for k, r in _build.resources.items()
            if r.get("registers", 0) > MAX_REGISTERS or r.get("spill_bytes")}
    if over:
        raise AssertionError(f"build: kernels over {MAX_REGISTERS} registers "
                             f"or spilling: {over}")
    sass = _build.sass()
    for kernel, copies in sorted(sass.items()):
        for c in copies:
            log(f"build: {kernel}: SASS {c['instructions']} instructions, "
                f"{c['imad']} IMAD, {c['imad_wide']} IMAD.WIDE; body and "
                "called functions (calls from the body): " + "; ".join(
                    f"{p['instructions']}, {p['imad']}, {p['imad_wide']} "
                    f"({p['body_calls']})" for p in c["parts"]))
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
        for name, entry in report.items():
            res = _build.resources[KERNEL_OF[name]]
            entry["registers"] = res["registers"]
            entry["spill_bytes"] = res["spill_bytes"]
            entry["sass"] = sass[KERNEL_OF[name]]
        ntt1 = _build.resources["ntt_pass_kernel<1>"]
        report["ntt"].update(registers_rb1=ntt1["registers"],
                             spill_bytes_rb1=ntt1["spill_bytes"])
        scans = {"sum": _build.resources["field_linscan_kernel<0>"],
                 "linear": _build.resources["field_linscan_kernel<1>"],
                 "product": _build.resources["field_linscan_stream_kernel"]}
        report["field_linscan"].update(
            registers_by_kind={k: r["registers"] for k, r in scans.items()},
            spill_bytes_by_kind={k: r["spill_bytes"]
                                 for k, r in scans.items()})
        for kernel in ("ntt_pass_kernel<3>", "ntt_pass_kernel<1>",
                       "fold_horner_kernel", "fold_add_tree_kernel",
                       "field_linscan_kernel<0>", "field_linscan_kernel<1>",
                       "field_linscan_stream_kernel", "mont_chain_kernel",
                       "mont_pow_kernel"):
            res = _build.resources[kernel]
            log(f"kernel {kernel}: {res['registers']} registers, "
                f"{res['spill_bytes']} bytes spilled, {res['smem_bytes']} "
                "bytes shared")
        add = report["fold_add"]
        add.update(_issue_bound(sass, card, add["cases"][0]["lanes"]))
        log(f"kernel fold_add: {add['sass_per_lane']} SASS instructions a "
            f"generic lane ({add['fe_mul_calls']} fe_mul calls); at "
            f"{add['cases'][0]['lanes']} lanes the issue "
            f"takes at least {add['issue_ms']:.4f} ms, the IMAD pipe "
            f"{add['imad_ms']:.4f} ms, against {add['ms']:.4f} ms measured")
        phase_golden()
        srs, eng = phase_slice(report, cache_dir)
        phase_msm(report, srs, eng)
        del eng
        phase_composite(report, srs, cache_dir)
        phase_sharded(report, srs, cache_dir)
        phase_mock(report)
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
