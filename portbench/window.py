"""The measured window's arithmetic.

The window opens after set-up and warm-up.  One client sends a request
and waits for its proof: a closed loop.  The window closes when the first
proof completes after `seconds` have passed and at least the mix's
`min_proofs` have ended, so it always ends on a finished proof, never
cuts one, and holds enough proofs for a mean.  proof_s is the window's
wall time over the proofs completed in it; a failed proof's time stays
in the window and the proof counts in `failed`.
"""
from __future__ import annotations


def closes(elapsed: float, seconds: float, ended: int = 1,
           min_proofs: int = 1) -> bool:
    """Whether the window closes at a proof that ends `elapsed` seconds
    after it opened, as the `ended`-th proof of the window."""
    return elapsed >= seconds and ended >= min_proofs


def summary(t_open: float, ends: list, failed: int) -> dict:
    """ends: each proof's end time (the last is the close); failed: how
    many of them raised.  -> window_s, attempted, completed and proof_s
    (None when nothing completed)."""
    window_s = ends[-1] - t_open if ends else 0.0
    done = len(ends) - failed
    return {"window_s": window_s, "attempted": len(ends), "failed": failed,
            "completed": done,
            "proof_s": window_s / done if done > 0 else None}


def proof_seconds(t_open: float, ends: list) -> list:
    """Each proof's own seconds, from the previous end (or the open)."""
    starts = [t_open] + ends[:-1]
    return [e - s for s, e in zip(starts, ends)]
