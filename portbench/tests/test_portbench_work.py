"""The roofline counts at hand-worked shapes, and the trace reduction."""
from __future__ import annotations

import pytest

from portbench import peaks, tracing, work


def test_peaks_are_chip_smokes():
    assert peaks.MUL32_PER_MONT == 264 and peaks.MUL32_PER_SQR == 208
    assert peaks.MUL32_PER_S == pytest.approx(132 * 64 * 1.98e9)


def test_ntt_count_at_one_shape():
    # one transform of 4 columns of 2^3 rows: 4 * 3 = 12 products a
    # column, 48 in all; 8 * 4 elements read and written
    nbytes, mul = work.ntt_work({(8, 4, 1): 1})
    assert mul == 48 * 264
    assert nbytes == 2 * 8 * 4 * 32
    # two such transforms, and the pass count plays no part
    assert work.ntt_work({(8, 4, 2): 2}) == (2 * nbytes, 2 * mul)


def test_msm_count_at_one_shape():
    # 4 bases of 2-bit scalars: window 1 -> 2 windows, 8 mixed adds,
    # 2 * 1 * 2 full adds, 1 doubling; window 2 -> 4 mixed adds,
    # 2 * 3 full adds, no doubling.
    w1 = peaks.mul32(8 * 7 + 4 * 11 + 2, 8 * 4 + 4 * 5 + 5)
    w2 = peaks.mul32(4 * 7 + 6 * 11, 4 * 4 + 6 * 5)
    m, s = work.msm_ops([(4, 2)])
    assert peaks.mul32(m, s) == min(w1, w2) == w2
    nbytes, mul = work.msm_work([[(4, 2)]])
    assert nbytes == 4 * (64 + 32) + 64 and mul == w2


def test_msm_count_of_a_wide_commitment():
    m, s = work.msm_ops([(1 << 15, 254)])
    # Pippenger near its best window (c about 12): some 21 windows of
    # 32,768 mixed adds and 8,190 full adds
    assert 20 * (1 << 15) * 7 < m < 24 * (1 << 15) * 7 + 24 * 8190 * 11


def test_proof_commitments_follow_the_constraint_system():
    from portbench.ref.circuits.signal import SquareCircuit
    from portbench.ref.plonk.circuit import ConstraintSystem
    cs = ConstraintSystem()
    SquareCircuit(3, True).configure(cs)
    got = work.proof_commitments(cs, 4, [2, 4])
    u = 16 - (cs.blinding_factors() + 1)
    assert got[:2] == [[(u, 2), (16 - u, 254)], [(u, 4), (16 - u, 254)]]
    # z chunks, the random polynomial, the quotient's pieces, W and W'
    assert len(got) == 2 + cs.num_permutation_chunks() + 1 + (
        cs.degree() - 1) + 2


def test_busy_union_and_idle_by_phase():
    ev = [{"name": tracing.WINDOW_MARK, "cat": "user_annotation",
           "ts": 0, "dur": 100},
          {"name": "synthesize", "cat": "user_annotation", "ts": 0,
           "dur": 40},
          {"name": "quotient", "cat": "user_annotation", "ts": 50,
           "dur": 30},
          {"name": "k1", "cat": "kernel", "ts": 10, "dur": 10},
          {"name": "k2", "cat": "kernel", "ts": 15, "dur": 10},
          {"name": "Memcpy HtoD", "cat": "gpu_memcpy", "ts": 60, "dur": 5}]
    red = tracing.reduce_trace(ev, {"synthesize", "quotient"})
    assert red["busy_s"] == pytest.approx(20e-6)
    assert red["window_s"] == pytest.approx(100e-6)
    idle = red["idle_by_phase"]
    assert idle["synthesize"] == pytest.approx(25e-6)
    assert idle["quotient"] == pytest.approx(25e-6)
    assert idle[tracing.OUTSIDE] == pytest.approx(30e-6)
    assert tracing.kernel_seconds(red["kernels"], ["k1"]) == pytest.approx(
        10e-6)
    assert tracing.kernel_seconds(red["kernels"], ["k3"]) is None
    assert tracing.top({"a": 1.0, "b": 3.0, "c": 2.0}, 2) == [
        ["b", 3.0], ["c", 2.0]]
