"""1 -> N device scaling report for the sharded NTT and MSM.  Port of
halo2tpu/parallel/scaling_report.py.

    python -m halo2tpu_torch.parallel.scaling_report

Prints ONE JSON line:
    {"devices": [1, 2, 4, 8], "backend": ..., "ntt": {...}, "msm": {...},
     "ntt_efficiency": {...}, "msm_efficiency": {...}, "device": {...}}
with per-device-count median step seconds (unrounded) and parallel
efficiency (t_1 / (N * t_N)), and the devices it ran on.

Where fewer CUDA devices exist than the largest count, every mesh is that
many shards of the first card, and "device" says so ("shards_of_one":
true).  Such a line measures the cost of the sharding mechanics (the block
exchanges and the smaller launches), not a speed-up: the shards share one
card.  SCALING_NTT_K sets the NTT size (default 2^14).
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch


def _median_time(fn, devs, iters=3, warmup=1) -> float:
    def sync():
        for d in dict.fromkeys(devs):
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    for _ in range(warmup):
        fn()
        sync()
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        sync()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def run_report(dev_counts=(1, 2, 4, 8), ntt_k=14, msm_n=1 << 10,
               device="cuda") -> dict:
    from ..curves import g1 as G1
    from ..curves.jpoint import affine_to_device
    from ..fields.bn254 import G1_GEN, R, fr_root_of_unity
    from ..fields.jfield import FR, device_of, ints_to_limbs
    from .mesh import Mesh
    from .msm import sharded_bit_partials
    from .ntt import make_sharded_ntt

    kind = torch.device(device).type
    if kind == "cuda":
        device_of("cuda")
        have = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
        name = torch.cuda.get_device_name(have[0])
    else:
        have, name = [torch.device(kind)], kind
    one = len(have) < max(dev_counts)
    rng = np.random.default_rng(0)

    # shared inputs
    n = 1 << ntt_k
    n1 = 1 << (ntt_k // 2)
    n2 = n // n1
    omega = fr_root_of_unity(ntt_k)
    vals = [int.from_bytes(rng.bytes(31), "big") % R for _ in range(256)]
    x_mat = FR.encode(vals, have[0]).repeat(-(-n // 256), 1)[:n].reshape(
        n1, n2, 8)

    base = G1.scalar_mul(G1_GEN, 7)
    pts = [base]
    for _ in range(63):
        pts.append(G1.add(pts[-1], G1_GEN))
    pts = (pts * -(-msm_n // 64))[:msm_n]
    points = affine_to_device(pts, have[0])
    scalars = torch.from_numpy(ints_to_limbs(
        [int.from_bytes(rng.bytes(31), "big") % R for _ in range(msm_n)]
    )).reshape(1, msm_n, 8).to(have[0])

    report = {"devices": list(dev_counts), "backend": kind, "ntt": {},
              "msm": {}, "device": {"name": name, "count": len(have),
                                    "shards_of_one": one}}
    for nd in dev_counts:
        mesh = Mesh([have[0]] * nd if one else have[:nd], ("shard",))
        ntt = make_sharded_ntt(mesh, n1, n2, omega)
        report["ntt"][str(nd)] = _median_time(lambda: ntt(x_mat), mesh.flat)
        report["msm"][str(nd)] = _median_time(
            lambda: sharded_bit_partials(mesh, points, scalars,
                                         fold_width=128), mesh.flat)

    for key in ("ntt", "msm"):
        t1 = report[key].get("1")
        if t1:
            report[key + "_efficiency"] = {
                d: round(t1 / (int(d) * t), 3)
                for d, t in report[key].items()}
    return report


if __name__ == "__main__":
    ks = int(os.environ.get("SCALING_NTT_K", "14"))
    print(json.dumps(run_report(ntt_k=ks)))
    sys.stdout.flush()
