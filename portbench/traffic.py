"""The one traffic generator.  A mix is a data file,
`portbench/traffic/<mix>.json`, of parameters; this module draws a run's
requests from it and the run's seed, and the configuration's circuit
family (`portbench/families/<family>.py`, `make_request`) turns each draw
into the request a user sends.

Every mix is a closed loop of `clients` clients (one today): a client sends
its next request when the previous proof is done.  A run draws
`warmup` requests for the warm-up and a pool of `pool` requests for the
window, all in set-up; the window takes them in order and starts again at
the first if it ever runs through the pool, and holds at least
`min_proofs` proofs (window.py).

Values a mix gives as a range [lo, hi] of whole numbers that set a
request's size (`stratified`) are not drawn independently: the pool gets
evenly spaced values over the range, shuffled by the seed, so every seed
sends the same sizes in another order.
"""
from __future__ import annotations

import hashlib
import random


def rng_for(mix_name: str, seed: int, stream: str) -> random.Random:
    """A generator of its own for each (mix, seed, stream); stable across
    platforms and Python versions (seeded with SHA-512 of the string)."""
    return random.Random(f"{mix_name}/{seed}/{stream}")


def stratified(lo: int, hi: int, count: int, rng: random.Random) -> list:
    """count whole numbers evenly spaced over [lo, hi], shuffled."""
    if count == 1:
        vals = [(lo + hi) // 2]
    else:
        vals = [lo + (hi - lo) * i // (count - 1) for i in range(count)]
    rng.shuffle(vals)
    return vals


def proof_seed(mix_name: str, seed: int, index: int) -> int:
    """The prover's rng seed for the index-th request of a run (64 bits)."""
    h = hashlib.sha256(f"{mix_name}/{seed}/proof/{index}".encode())
    return int.from_bytes(h.digest()[:8], "big")


def requests(mix: dict, config: dict, family, seed: int,
             count: int) -> list:
    """count requests of the mix for a run with this seed: each a dict
    the family made, with its prover rng seed under "rng_seed"."""
    name = mix["name"]
    ctx = family.run_context(mix, config, rng_for(name, seed, "run"))
    draws = {k: stratified(lo, hi, count, rng_for(name, seed, f"size/{k}"))
             for k, (lo, hi) in mix.get("stratified", {}).items()}
    rng = rng_for(name, seed, "requests")
    out = []
    for i in range(count):
        req = family.make_request(rng, mix, config, ctx,
                                  {k: v[i] for k, v in draws.items()})
        req["rng_seed"] = proof_seed(name, seed, i)
        out.append(req)
    return out


def run_requests(mix: dict, config: dict, family, seed: int):
    """(warm-up requests, the window's pool) for a run: the warm-up is drawn
    as requests of the seed's stream "warmup", so the pool is the same
    whatever the warm-up count."""
    warm = requests({**mix, "name": f"{mix['name']}.warmup"}, config, family,
                    seed, mix["warmup"])
    return warm, requests(mix, config, family, seed, mix["pool"])
