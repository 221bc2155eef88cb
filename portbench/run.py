#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1> [--fault instance|stale|flip]

The cells, their configurations, traffic mixes and metrics are in
BENCHMARK.json at the root of the checkout.  --trace 0 measures the
cell's end-to-end metrics; --trace 1 runs the same window under
torch.profiler and the prover's phase tracer and reports its per-layer
metrics.  The last line of standard output is the result (one JSON
object); the lines before it describe the run; the last lines of standard
error give each number that decides `correct` beside its limit.  --fault
breaks the timed path on purpose: the control, and the harness's tests.

Exits non-zero, printing no result, without as many CUDA devices as the
cell asks for, or if JAX or halo2tpu was loaded by the time the window
closed.  Caches (the kernels' build, the SRS, the proving keys, the MSM
tables, the reference's keys) live in fixed folders inside the checkout.
"""
from __future__ import annotations

import os
import sys
import time

_STARTED = time.time()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    import argparse
    import json
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from portbench import harness, manifest
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--fault", choices=harness.FAULTS, default=None)
    args = ap.parse_args(argv)
    started = min(harness.process_start(), _STARTED)
    rc, result = harness.run_cell(manifest.load(), args.workload, args.seed,
                                  args.seconds, bool(args.trace),
                                  fault=args.fault, started=started)
    if rc == 0:
        print(json.dumps(result), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
