"""The window's arithmetic."""
from __future__ import annotations

import pytest

from portbench import window


def test_closes_at_the_first_proof_past_the_length():
    assert not window.closes(50.9, 51)
    assert window.closes(51.0, 51)
    assert window.closes(53.2, 51)


def test_closes_only_after_the_least_proofs():
    assert not window.closes(55.0, 51, ended=9, min_proofs=10)
    assert window.closes(55.0, 51, ended=10, min_proofs=10)
    assert not window.closes(20.0, 51, ended=12, min_proofs=10)


def test_summary_counts_all_the_time_over_completed_proofs():
    s = window.summary(10.0, [14.0, 18.5, 23.0, 27.0], failed=1)
    assert s["window_s"] == pytest.approx(17.0)
    assert (s["attempted"], s["completed"], s["failed"]) == (4, 3, 1)
    assert s["proof_s"] == pytest.approx(17.0 / 3)


def test_summary_without_a_completed_proof():
    s = window.summary(0.0, [5.0], failed=1)
    assert s["proof_s"] is None and s["completed"] == 0


def test_proof_seconds():
    assert window.proof_seconds(1.0, [2.5, 4.0, 7.0]) == pytest.approx(
        [1.5, 1.5, 3.0])
