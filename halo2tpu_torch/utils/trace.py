"""Structured tracing/profiling (SURVEY §5.1) — replaces the reference's
println!-based timing (anon-aadhaar-halo2/src/lib.rs:370-375,884-1051) with
phase timers, counters, and JSON reporting.

Usage:
    tr = Tracer()
    with tr.phase("commit_advice"):
        ...
    tr.count("msm_points", n)
    tr.report()   # dict;  tr.dump() -> one JSON line on stderr
"""
from __future__ import annotations

import json
import sys
import time
from collections import defaultdict
from contextlib import contextmanager


class Tracer:
    def __init__(self, name: str = "halo2tpu"):
        self.name = name
        self.phases: dict[str, float] = defaultdict(float)
        self.calls: dict[str, int] = defaultdict(int)
        self.counters: dict[str, int] = defaultdict(int)
        self._t0 = time.time()
        self._stack: list[tuple[str, float]] = []

    @contextmanager
    def phase(self, name: str):
        start = time.time()
        self._stack.append((name, start))
        try:
            yield
        finally:
            self._stack.pop()
            self.phases[name] += time.time() - start
            self.calls[name] += 1

    def count(self, name: str, inc: int = 1) -> None:
        self.counters[name] += inc

    def report(self) -> dict:
        return {
            "name": self.name,
            "wall_s": round(time.time() - self._t0, 4),
            "phases_s": {k: round(v, 4) for k, v in
                         sorted(self.phases.items(), key=lambda kv: -kv[1])},
            "calls": dict(self.calls),
            "counters": dict(self.counters),
        }

    def dump(self, file=None) -> None:
        print(json.dumps(self.report()), file=file or sys.stderr, flush=True)


class NullTracer:
    """No-op stand-in so hot paths can trace unconditionally."""

    @contextmanager
    def phase(self, name: str):
        yield

    def count(self, name: str, inc: int = 1) -> None:
        pass

    def report(self) -> dict:
        return {}

    def dump(self, file=None) -> None:
        pass


NULL = NullTracer()
