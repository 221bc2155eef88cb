"""One run of one cell: set-up, warm-up, the measured window, the checks
that decide `correct`, and the result line.

    rc, result = run_cell(manifest, workload, seed, seconds, trace)

The window calls nothing but the program's create_proof.  Everything a
request needs (its QR or message, signature, circuit and public instances)
is made in set-up; every check runs after the window has closed, once the
device's peak memory is read and the program's state is freed.
"""
from __future__ import annotations

import gc
import hashlib
import json
import os
import resource
import subprocess
import sys
import time
import traceback
from types import SimpleNamespace

from . import manifest, traffic, window
from .tracing import GcTimer, PhaseTracer, profiled, reduce_trace, top

FORBIDDEN = ("jax", "jaxlib", "flax", "halo2tpu")
FAULTS = ("instance", "stale", "flip")
PHASES = ("synthesize", "advice_ntt", "commit_advice", "lookups_permute",
          "commit_lookup_permuted", "grand_products", "commit_z",
          "quotient", "commit_h", "evals", "shplonk")


def process_start() -> float:
    """time.time() at which this process started (from /proc), or now."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - start_ticks / os.sysconf(
            "SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


def pk_cache_key(config: dict) -> str:
    """The proving key's cache key: the configuration's name and a hash of
    every parameter in its file, so configurations that differ in any
    width never share a key file."""
    h = hashlib.sha256(json.dumps(config, sort_keys=True).encode())
    return f"pb_{config['name']}_{h.hexdigest()[:12]}"


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _smi() -> str | None:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,power.draw,"
             "clocks.sm,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


def _files(dirs) -> set:
    out = set()
    for d in dirs:
        if os.path.isdir(d):
            out |= {os.path.join(d, f) for f in os.listdir(d)}
    return out


def _cpu_s() -> float:
    r = resource.getrusage(resource.RUSAGE_SELF)
    return r.ru_utime + r.ru_stime


def _alter_last(instances):
    """The public inputs with the last one changed (+1 mod r)."""
    from .ref.fields.bn254 import R
    out = [list(col) for col in instances]
    col = next(c for c in reversed(out) if c)
    col[-1] = (col[-1] + 1) % R
    return out


def _advice_bits(circuit, k: int) -> list:
    """Each advice column's width, the bit length of its largest value
    (the prover's rule), from the reference's own synthesis."""
    from .ref.plonk.circuit import Assignment, ConstraintSystem
    cs = ConstraintSystem()
    config = circuit.configure(cs)
    asn = Assignment(cs, 1 << k, recording=False)
    circuit.synthesize(config, asn)
    return [int(max(col.tolist())).bit_length() for col in asn.advice]


def run_cell(m: dict, workload: str, seed: int, seconds: float,
             trace: bool, *, device: str = "cuda", require_card: bool = True,
             fault: str | None = None, cache_root: str | None = None,
             traffic_dir: str = manifest.TRAFFIC_DIR, log=None,
             started: float | None = None):
    """-> (exit code, result dict or None).  device "cpu" with
    require_card=False runs a small cell on the CPU (the harness's own
    tests).  fault breaks the timed path on purpose (FAULTS): the control
    and the tests that show `correct` come out false."""
    t_start = started if started is not None else process_start()
    log = log or (lambda obj: print("portbench: " + json.dumps(obj),
                                    flush=True))
    parts = {"start_s": time.time() - t_start}
    t = time.perf_counter()
    cell = manifest.cell(m, workload, traffic_dir)
    cfg, mix = cell["config"], cell["mix"]
    chips = cell["workload"]["chips"]
    import torch
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if require_card and have < chips:
        print(f"portbench: {workload} needs {chips} CUDA device(s), this "
              f"machine has {have}", file=sys.stderr)
        return 2, None
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"fault {fault!r}: one of {FAULTS}")
    root = cache_root or manifest.ROOT
    cache_dir = os.path.join(root, ".cache", "portbench")
    k = cfg["k"]
    fam = manifest.family(cfg["family"])

    from halo2tpu_torch.plonk.engine import TorchEngine
    from halo2tpu_torch.plonk.keygen import keygen_cached
    from halo2tpu_torch.plonk.prover import create_proof
    from halo2tpu_torch.plonk.srs import setup
    import halo2tpu_torch
    pkg_cache = os.path.join(os.path.dirname(os.path.dirname(
        halo2tpu_torch.__file__)), ".cache")
    watched = [cache_dir, pkg_cache, os.environ.get("HALO2TPU_CACHE", ""),
               os.path.join(os.path.dirname(halo2tpu_torch.__file__),
                            "build")]
    before = _files(watched)
    parts["imports_s"] = time.perf_counter() - t

    t = time.perf_counter()
    if device == "cuda":
        from halo2tpu_torch import _build
        _build.lib()
    parts["kernels_s"] = time.perf_counter() - t
    t = time.perf_counter()
    srs = setup(k, seed=cfg["srs_seed"].encode(),
                cache=cache_root is None)
    kreq = traffic.requests({**mix, "name": f"{mix['name']}.keygen"}, cfg,
                            fam, 0, 1)[0]
    pk, vk = keygen_cached(fam.program_circuit(cfg, kreq), k, srs,
                           cache_key=pk_cache_key(cfg), device=device,
                           cache_dir=cache_dir)
    eng = TorchEngine(vk.domain, srs, device)
    parts["key_load_s"] = time.perf_counter() - t

    t = time.perf_counter()
    warm, pool = traffic.run_requests(mix, cfg, fam, seed)
    jobs = []
    for r in warm + pool:
        c = fam.program_circuit(cfg, r)
        jobs.append((r, c, c.instances()))
    parts["requests_s"] = time.perf_counter() - t
    t = time.perf_counter()
    for r, c, inst in jobs[:len(warm)]:
        create_proof(pk, srs, c, inst, rng_seed=r["rng_seed"], engine=eng)
    parts["warmup_s"] = time.perf_counter() - t
    jobs = jobs[len(warm):]
    built = sorted(os.path.basename(f) for f in _files(watched) - before)
    gc.collect()
    smi_before = _smi() if device == "cuda" else None
    if device == "cuda":
        torch.cuda.synchronize()

    tracer = PhaseTracer(annotate=trace and device == "cuda")
    ntt_mod = None
    if trace:
        from halo2tpu_torch.ops import ntt as ntt_mod
        shapes0 = dict(getattr(ntt_mod.ntt_kernel, "shapes", {}))
    ends, failed, answers, errors = [], 0, [], []

    def loop():
        nonlocal failed
        prev = None
        i = 0
        t_open = time.perf_counter()
        while True:
            r, c, inst = jobs[i % len(jobs)]
            if fault == "instance":
                inst = _alter_last(inst)
            if trace:
                tracer.next_proof()
            try:
                proof = create_proof(pk, srs, c, inst,
                                     rng_seed=r["rng_seed"], engine=eng,
                                     tracer=tracer if trace else None)
            except Exception:          # a failed proof stays in the window
                failed += 1
                errors.append(traceback.format_exc(limit=3))
                proof = None
            if fault == "stale" and prev is not None:
                proof, prev = prev, proof
            elif fault == "stale":
                prev = proof
            if fault == "flip" and proof is not None:
                proof = bytearray(proof)
                proof[-129] ^= 1
                proof = bytes(proof)
            end = time.perf_counter()
            ends.append(end)
            answers.append((i % len(jobs), inst, proof))
            i += 1
            if window.closes(end - t_open, seconds, i,
                             mix.get("min_proofs", 1)):
                return t_open

    setup_s = time.time() - t_start
    cpu0 = _cpu_s()
    trace_events = None
    with GcTimer() as gct:
        if trace and device == "cuda":
            t_open, trace_events = profiled(loop)
        else:
            t_open = loop()
    cpu_s = _cpu_s() - cpu0
    w = window.summary(t_open, ends, failed)
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    smi_after = _smi() if device == "cuda" else None
    kind = torch.cuda.get_device_name() if device == "cuda" else device
    if trace and ntt_mod is not None:
        shapes1 = dict(getattr(ntt_mod.ntt_kernel, "shapes", {}))
        ntt_shapes = {key: v - shapes0.get(key, 0)
                      for key, v in shapes1.items() if v > shapes0.get(key, 0)}
    else:
        ntt_shapes = None
    log({"workload": workload, "seed": seed, "seconds": seconds,
         "trace": int(trace), "fault": fault,
         "proof_seconds": window.proof_seconds(t_open, ends),
         "proofs": w["completed"], "failed": failed,
         "window_s": w["window_s"], "cpu_share": cpu_s / w["window_s"],
         "affinity": len(os.sched_getaffinity(0)),
         "gc_s": gct.seconds, "gc_passes": gct.passes,
         "proof_phases": [dict(d) for d in tracer.proofs],
         "setup_s": setup_s, "setup_parts": parts, "built": built,
         "nvidia_smi_before": smi_before, "nvidia_smi_after": smi_after})
    for e in errors[:3]:
        print(e, file=sys.stderr)

    found = forbidden_modules()
    if found:
        print(f"portbench: the process has loaded {found}", file=sys.stderr)
        return 3, None

    # -- the checks, after the window, with the program's state freed -----
    phases = tracer.proofs
    del eng, pk, jobs
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    from .ref.keys import dev_tau, reference_key
    from .ref.verify import verify
    ref = manifest.ref_family(cfg["family"])
    rkey = reference_key(fam.circuit(cfg, kreq, ref.classes), k,
                         cfg["srs_seed"], cache_dir, pk_cache_key(cfg))
    tau = dev_tau(cfg["srs_seed"])
    bad_key = (sum(a != b for a, b in zip(vk.fixed_commitments,
                                          rkey.fixed_commitments))
               + sum(a != b for a, b in zip(vk.permutation_commitments,
                                            rkey.sigma_commitments))
               + (len(vk.fixed_commitments) != len(rkey.fixed_commitments))
               + (len(vk.permutation_commitments)
                  != len(rkey.sigma_commitments))
               + (vk.transcript_repr != rkey.transcript_repr))
    bad_inst = bad_proofs = 0
    reasons = []
    want_cache = {}
    for idx, inst, proof in answers:
        if idx not in want_cache:
            want_cache[idx] = ref.instances(cfg, pool[idx])
        want = want_cache[idx]
        if inst != want:
            bad_inst += 1
        if proof is not None:
            why = verify(rkey, tau, want, proof)
            if why:
                bad_proofs += 1
                reasons.append(why)
    check_s = time.perf_counter() - t
    checks = {"bad_key": bad_key, "bad_instances": bad_inst,
              "bad_proofs": bad_proofs, "failed_proofs": failed,
              "no_proofs": int(w["completed"] == 0)}
    correct = all(v == 0 for v in checks.values())

    result = {"correct": correct, "attempted": w["attempted"],
              "failed": failed, "metrics": {}}
    if not trace:
        values = {"proof_s": w["proof_s"], "setup_s": setup_s}
        units = {e["name"]: e["unit"] for e in cell["end_to_end"]}
        result["metrics"] = {n: {"value": values[n], "unit": units[n]}
                             for n in units if values.get(n) is not None}
    dev = {"platform": "gpu" if device == "cuda" else device, "kind": kind,
           "count": chips, "memory_peak_bytes": peak}
    result["device"] = dev
    if trace:
        red = (reduce_trace(trace_events, set(PHASES))
               if trace_events is not None else {})
        t = time.perf_counter()
        commitments = None
        if red:
            commitments = []
            from .work import proof_commitments
            for idx, _, proof in answers:
                if proof is None:
                    continue
                bits = _advice_bits(fam.circuit(cfg, pool[idx],
                                                ref.classes), k)
                commitments += proof_commitments(rkey.cs, k, bits)
        ctx = SimpleNamespace(
            proofs=w["completed"], window_s=w["window_s"],
            proof_seconds=window.proof_seconds(t_open, ends), phases=phases,
            trace=red, gc_s=gct.seconds, setup=parts,
            ntt_shapes=ntt_shapes, msm_commitments=commitments)
        for e in cell["per_layer"]:
            v = manifest.metric_reader(e["name"])(ctx)
            if v is not None:
                result["metrics"][e["name"]] = {"value": v, "unit": e["unit"]}
        if red:
            dev["busy_s"] = red["busy_s"]
            dev["window_s"] = red["window_s"]
            result["breakdown"] = {
                "device_ops": top(red["device_ops"]),
                "idle_gaps": top(red["idle_by_phase"])}
        log({"trace_events": red.get("gpu_events"),
             "work_count_s": time.perf_counter() - t})
    limits = {n: 0 for n in checks}
    result["checks"] = {n: {"value": v, "limit": limits[n]}
                        for n, v in checks.items()}
    log({"check_s": check_s, "reasons": reasons[:5]})
    for n, v in checks.items():
        print(f"check {n} {v} limit {limits[n]}", file=sys.stderr)
    return 0, result
