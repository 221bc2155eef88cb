"""What a traced run (--trace 1) records, and how the trace is reduced.

- PhaseTracer is the `tracer=` the prover accepts: it keeps each phase's
  host seconds per proof (each phase ends in the engine's synchronize)
  and, under the profiler, marks the phase as a user annotation so that
  the device's idle gaps can be put down to the phase open at the time.
- GcTimer sums the garbage collector's passes (gc.callbacks).
- profiled() runs a call under torch.profiler (CPU and CUDA activity),
  writes the Chrome trace under TMPDIR, reads it back and deletes it.
- busy_union / reduce_trace: the union of the device's kernel, copy and
  memset spans (profile_proof.py's busy_from_trace), the kernels' time by
  name, and the idle gaps by phase.
"""
from __future__ import annotations

import gc
import json
import os
import re
import tempfile
import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext

GPU_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW_MARK = "portbench_window"
OUTSIDE = "outside_phases"


class PhaseTracer:
    """The prover's tracer interface (phase, count), one dict of phase
    seconds a proof."""

    def __init__(self, annotate: bool = False):
        self.proofs: list[dict] = []
        self.counters = defaultdict(int)
        self._annotate = annotate

    def next_proof(self) -> None:
        self.proofs.append(defaultdict(float))

    @contextmanager
    def phase(self, name: str):
        mark = nullcontext()
        if self._annotate:
            from torch.profiler import record_function
            mark = record_function(name)
        start = time.perf_counter()
        with mark:
            try:
                yield
            finally:
                self.proofs[-1][name] += time.perf_counter() - start

    def count(self, name: str, inc: int = 1) -> None:
        self.counters[name] += inc


class GcTimer:
    """Seconds spent in the garbage collector, and passes by generation,
    while registered."""

    def __init__(self):
        self.seconds = 0.0
        self.passes = [0, 0, 0]
        self._t = None

    def _cb(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.seconds += time.perf_counter() - self._t
            self.passes[info["generation"]] += 1
            self._t = None

    def __enter__(self):
        gc.callbacks.append(self._cb)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._cb)


def profiled(fn):
    """fn() under torch.profiler, ended by a CUDA synchronize -> (fn's
    result, the trace's events).  The trace file lives under TMPDIR only
    while it is read."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW_MARK):
            out = fn()
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(prefix="portbench_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.remove(path)
    return out, trace["traceEvents"] if isinstance(trace, dict) else trace


def busy_union(spans) -> float:
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


def _merged(spans):
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce_trace(events, phase_names) -> dict:
    """Chrome-trace events of a profiled window -> the device's busy
    seconds, the window's seconds (its user annotation), every device
    operation's seconds by the profiler's name, and the idle seconds by the
    phase open at the time (OUTSIDE where none is)."""
    mark = next((e for e in events if e.get("name") == WINDOW_MARK
                 and e.get("cat") == "user_annotation"), None)
    if mark is None:
        return {}
    t0, t1 = mark["ts"], mark["ts"] + mark["dur"]
    gpu = [e for e in events if e.get("cat") in GPU_CATS
           and e["ts"] < t1 and e["ts"] + e.get("dur", 0) > t0]
    spans = [(max(e["ts"], t0), min(e["ts"] + e.get("dur", 0), t1))
             for e in gpu]
    by_op = defaultdict(float)
    for e in gpu:
        by_op[e.get("name", "?")] += e.get("dur", 0) / 1e6
    kernels = [(e.get("name", ""), e.get("dur", 0) / 1e6) for e in gpu
               if e["cat"] == "kernel"]
    phases = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                    if e.get("cat") == "user_annotation"
                    and e.get("name") in phase_names)
    busy = _merged(spans)
    gaps, prev = [], t0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if prev < t1:
        gaps.append((prev, t1))
    idle = defaultdict(float)
    for gs, ge in gaps:
        covered = 0.0
        for ps, pe, name in phases:
            if pe <= gs:
                continue
            if ps >= ge:
                break
            ov = min(pe, ge) - max(ps, gs)
            if ov > 0:
                idle[name] += ov / 1e6
                covered += ov
        idle[OUTSIDE] += (ge - gs - covered) / 1e6
    return {"busy_s": sum(e - s for s, e in busy) / 1e6,
            "window_s": (t1 - t0) / 1e6, "kernels": kernels,
            "device_ops": dict(by_op), "idle_by_phase": dict(idle),
            "gpu_events": len(gpu)}


def kernel_seconds(kernels, names) -> float | None:
    """Summed seconds of the kernels whose profiler name holds one of
    names as a word; None when none ran."""
    pat = re.compile(r"\b(" + "|".join(map(re.escape, names)) + r")\b")
    mine = [d for n, d in kernels if pat.search(n)]
    return sum(mine) if mine else None


def top(d: dict, count: int = 10) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
            [:count]]
