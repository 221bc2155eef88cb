"""The PLONKish prover on torch tensors: witness -> proof bytes.  Port of
halo2tpu/plonk/prover.py with the same transcript order and the same rng
draws, so a TorchEngine proof is byte-identical to halo2tpu's HostEngine
and JaxEngine proofs for the same witness and seed.

  absorb vk digest + instances
  phase 1: commit advice columns ................ -> theta
  lookups: commit permuted (A', S') pairs ....... -> beta, gamma
  phase 2: commit permutation z chunks, lookup
           products, vanishing random poly ...... -> y
  phase 3: commit quotient h chunks ............. -> x
  evals (advice, fixed, random, sigmas, perm z, lookups)
  SHPLONK multiopen ............................. zeta, nu, W, mu, W'

Tracer phases end with a CUDA synchronize on a CUDA engine, so their times
are device times, not enqueue times.
"""
from __future__ import annotations

from contextlib import contextmanager

import numpy as np
import torch

from ..fields.bn254 import R, FR_DELTA, inv_mod
from ..utils.trace import NULL
from . import polyops
from .circuit import Assignment
from .domain import rotate_omega
from .keygen import ProvingKey
from .shplonk import Query, shplonk_open
from .transcript import ProofWriter
from .engine import TorchEngine
from .quotient import compress_exprs, fold_quotient


def _rng_field(rng: np.random.Generator) -> int:
    return int.from_bytes(rng.bytes(32), "big") % R


class _PkState:
    """Engine-resident proving-key state, cached per (pk, engine device):
    n-domain Lagrange columns, coefficient polys, per-part Lagrange-selector
    vectors, Z_H constants and (within a byte budget) the witness-
    independent fixed/sigma part values."""

    parts_cache_bytes = 4600 << 20

    def __init__(self, pk: ProvingKey, eng):
        d = pk.vk.domain
        n = d.n
        step = d.extended_n // n
        b = pk.vk.cs.blinding_factors()
        self.fixed_lag = eng.from_packed_stack(pk.fixed_values)
        self.sigma_lag = eng.sigma_from_mapping(pk.perm_mapping)
        self.fixed_polys = eng.lagrange_to_coeff_stack(self.fixed_lag)
        self.sigma_polys = eng.lagrange_to_coeff_stack(self.sigma_lag)

        omega_pows = [1] * n
        for i in range(1, n):
            omega_pows[i] = omega_pows[i - 1] * d.omega % R
        self.omega_pows = eng.from_ints(omega_pows)

        def indicator(rows):
            vals = [0] * n
            for r_ in rows:
                vals[r_ % n] = 1
            return vals

        l_coeffs = eng.lagrange_to_coeff_stack(eng.from_ints_stack(
            [indicator([0]), indicator([n - (b + 1)]),
             [1] * (n - (b + 1)) + [0] * (b + 1)]))
        # part_l[q] = (l0, l_last, l_active) values on extended-coset part q
        self.part_l = [tuple(eng.coeff_to_part_stack(l_coeffs, q))
                       for q in range(step)]
        # Z_H is constant per part: (c_q^n - 1)^-1
        self.zh_inv = [
            inv_mod((pow(polyops.part_shift(d, q), n, R) - 1) % R, R)
            for q in range(step)]
        self._fixed_parts = [None] * step
        self._sigma_parts = [None] * step
        self._parts_budget = self.parts_cache_bytes

    def _cached_parts(self, eng, q, cache, polys):
        if cache[q] is None:
            parts = eng.coeff_to_part_stack(polys, q)
            if not parts:
                cache[q] = []
                return []
            est = sum(p.nelement() * p.element_size() for p in parts)
            if est > self._parts_budget:
                return parts            # over budget: recompute next proof
            cache[q] = list(torch.stack(parts).unbind(0))
            self._parts_budget -= est
        return cache[q]

    def fixed_parts(self, eng, q):
        return self._cached_parts(eng, q, self._fixed_parts, self.fixed_polys)

    def sigma_parts(self, eng, q):
        return self._cached_parts(eng, q, self._sigma_parts, self.sigma_polys)


def _get_state(pk: ProvingKey, eng) -> _PkState:
    cache = getattr(pk, "_torch_state_cache", None)
    if cache is None:
        cache = pk._torch_state_cache = {}
    key = (eng.name, eng.device)
    if key not in cache:
        cache[key] = _PkState(pk, eng)
    return cache[key]


@contextmanager
def _phase(tr, name: str, eng):
    with tr.phase(name):
        yield
        if eng.device.type == "cuda":
            torch.cuda.synchronize(eng.device)


def create_proof(pk: ProvingKey, srs, circuit, instances: list[list[int]],
                 rng_seed: int = 0, engine: TorchEngine | None = None,
                 device="cuda", tracer=None) -> bytes:
    """engine: a TorchEngine for pk's domain (reuse one across proofs to
    keep its pk state warm); None makes one on `device`."""
    tr = tracer or NULL
    vk = pk.vk
    cs = vk.cs
    d = vk.domain
    n = d.n
    b = cs.blinding_factors()
    u = n - (b + 1)  # unusable rows start
    rng = np.random.default_rng(rng_seed)

    eng = engine or TorchEngine(d, srs, device)
    assert eng.d.n == d.n and eng.d.extended_n == d.extended_n, (
        "engine domain mismatch: make one engine per circuit domain")
    st = _get_state(pk, eng)

    t = ProofWriter()
    t.common_scalar(vk.transcript_repr)

    # -- instances ---------------------------------------------------------
    for col in instances:
        assert len(col) <= u, "too many instance rows"
        for v in col:
            t.common_scalar(v)
    instance_ints = []
    for ci in range(cs.num_instance):
        vals = [0] * n
        col = instances[ci] if ci < len(instances) else []
        for i, v in enumerate(col):
            vals[i] = v % R
        instance_ints.append(vals)
    instance_values = eng.from_ints_stack(instance_ints)
    instance_polys = eng.lagrange_to_coeff_stack(instance_values)

    # -- phase 1: advice ---------------------------------------------------
    asn = Assignment(cs, n, recording=False)
    with _phase(tr, "synthesize", eng):
        circuit.synthesize(pk.config, asn)
        advice_ints = []
        advice_bits = []    # pre-blinding value bound -> narrow MSM planes
        for col in asn.advice:
            vals = col.tolist()
            advice_bits.append(max(vals).bit_length())
            for i in range(u, n):
                vals[i] = _rng_field(rng)
            advice_ints.append(vals)
    with _phase(tr, "advice_ntt", eng):
        advice_values = eng.from_ints_stack(advice_ints, reduced=True,
                                            bits=advice_bits, blind_start=u)
        advice_polys = eng.lagrange_to_coeff_stack(advice_values)
    del advice_ints
    with _phase(tr, "commit_advice", eng):
        for p in eng.commit_lagrange_batch(advice_values,
                                           value_bits=advice_bits,
                                           blind_start=u):
            t.write_point(p)
    tr.count("advice_columns", len(advice_values))

    theta = t.squeeze_challenge()
    lag_vals = {"advice": advice_values, "fixed": st.fixed_lag,
                "instance": instance_values}

    # -- lookups: permuted pairs -------------------------------------------
    lookup_state = []
    with _phase(tr, "lookups_permute", eng):
        ci_devs, ct_devs = [], []
        for lk in cs.lookups:
            ci_devs.append(compress_exprs(eng, [p[0] for p in lk.pairs],
                                          lag_vals, theta))
            ct_devs.append(compress_exprs(eng, [p[1] for p in lk.pairs],
                                          lag_vals, theta))
            lookup_state.append({})
        a_vecs, s_vecs, lookup_fails = eng.permute_lookup_batch(
            ci_devs, ct_devs, u, [lk.max_bits for lk in cs.lookups])
        raw_pairs = []      # (a_vec, s_vec) pre-blinding
        blind_lists = []    # aligned [blind_a, blind_s] per lookup
        for li, lk_s in enumerate(lookup_state):
            blind_a, blind_s = [], []
            for i in range(u, n):
                blind_a.append(_rng_field(rng))
                blind_s.append(_rng_field(rng))
            raw_pairs.append((a_vecs[li], s_vecs[li]))
            blind_lists.extend([blind_a, blind_s])
            lk_s["comp_input_dev"] = ci_devs[li]
            lk_s["comp_table_dev"] = ct_devs[li]
        lookup_perm_vecs = eng.set_rows_batch(
            [v for pair in raw_pairs for v in pair], u, blind_lists)
        for i, lk_s in enumerate(lookup_state):
            lk_s["a_vec"] = lookup_perm_vecs[2 * i]
            lk_s["s_vec"] = lookup_perm_vecs[2 * i + 1]
        eng.check_lookup_fails(lookup_fails)
    with _phase(tr, "commit_lookup_permuted", eng):
        perm_bits = [bb for lk in cs.lookups
                     for bb in (getattr(lk, "max_bits", None),) * 2]
        for p in eng.commit_lagrange_batch(lookup_perm_vecs,
                                           value_bits=perm_bits,
                                           blind_start=u):
            t.write_point(p)

    beta = t.squeeze_challenge()
    gamma = t.squeeze_challenge()

    # -- phase 2: permutation grand products -------------------------------
    chunk_len = cs.permutation_chunk_len()
    perm_cols = cs.permutation_columns
    chunks = [perm_cols[i:i + chunk_len]
              for i in range(0, len(perm_cols), chunk_len)]

    def col_values(col):
        if col.kind == "advice":
            return advice_values[col.index]
        if col.kind == "fixed":
            return st.fixed_lag[col.index]
        return instance_values[col.index]

    deltas = [pow(FR_DELTA, j, R) for j in range(len(perm_cols))]

    with _phase(tr, "grand_products", eng):
        gidx = 0
        chunk_cols, chunk_sigmas, chunk_deltas = [], [], []
        for chunk in chunks:
            chunk_cols.append([col_values(col) for col in chunk])
            chunk_sigmas.append([st.sigma_lag[perm_cols.index(col)]
                                 for col in chunk])
            chunk_deltas.append(deltas[gidx:gidx + len(chunk)])
            gidx += len(chunk)
        nums, dens = eng.perm_numden_chunks(chunk_cols, chunk_sigmas,
                                            st.omega_pows, beta, gamma,
                                            chunk_deltas)
        lk_nums, lk_dens = eng.lookup_numden(
            [lk_s["comp_input_dev"] for lk_s in lookup_state],
            [lk_s["comp_table_dev"] for lk_s in lookup_state],
            [lk_s["a_vec"] for lk_s in lookup_state],
            [lk_s["s_vec"] for lk_s in lookup_state], beta, gamma)
        prefixes = eng.grand_products(nums + lk_nums, dens + lk_dens)
        del nums, dens, lk_nums, lk_dens
        for lk_s in lookup_state:
            lk_s["comp_input_dev"] = lk_s["comp_table_dev"] = None

        # z chunks: one row read per permutation chunk, then every z vector
        # assembled in one batched pass
        perm_prefixes = prefixes[:len(chunks)]
        tails = eng.read_rows(perm_prefixes, u - 1) if chunks else []
        heads, blinds = [], []
        last_z = 1
        for tail in tails:
            blinds.append([_rng_field(rng) for _ in range(b)])
            heads.append(last_z)
            last_z = last_z * tail % R
        for _ in lookup_state:
            blinds.append([_rng_field(rng) for _ in range(b)])
            heads.append(1)
        all_z = eng.assemble_z_batch(prefixes, heads, n - b, blinds)
        z_values = all_z[:len(chunks)]
        lookup_z_vecs = all_z[len(chunks):]
    z_polys = eng.lagrange_to_coeff_stack(z_values)
    lookup_poly_stack = eng.lagrange_to_coeff_stack(
        lookup_z_vecs + [lk_s["a_vec"] for lk_s in lookup_state]
        + [lk_s["s_vec"] for lk_s in lookup_state])
    nlk = len(lookup_state)
    for i, lk_s in enumerate(lookup_state):
        lk_s["z_poly"] = lookup_poly_stack[i]
        lk_s["a_poly"] = lookup_poly_stack[nlk + i]
        lk_s["s_poly"] = lookup_poly_stack[2 * nlk + i]
    with _phase(tr, "commit_z", eng):
        for p in eng.commit_lagrange_batch(z_values + lookup_z_vecs):
            t.write_point(p)

    # vanishing random poly
    random_ints = [_rng_field(rng) for _ in range(n)]
    random_poly = eng.from_ints(random_ints)
    t.write_point(eng.commit_batch([random_poly])[0])

    y = t.squeeze_challenge()

    # -- phase 3: quotient (part-wise) -------------------------------------
    advice_values = None
    lag_vals["advice"] = None
    with _phase(tr, "quotient", eng):
        srcs = dict(
            advice_polys=advice_polys,
            instance_polys=instance_polys,
            z_polys=z_polys,
            lookup_polys=[(lk_s["z_poly"], lk_s["a_poly"], lk_s["s_poly"])
                          for lk_s in lookup_state],
        )
        ch = dict(theta=theta, beta=beta, gamma=gamma, y=y)
        h_chunks = fold_quotient(eng, cs, d, st, srcs, ch)
    with _phase(tr, "commit_h", eng):
        for p in eng.commit_batch(h_chunks):
            t.write_point(p)

    x = t.squeeze_challenge()
    xn = pow(x, n, R)

    # -- evaluations -------------------------------------------------------
    with _phase(tr, "evals", eng):
        x_next = rotate_omega(d, x, 1)
        x_last = rotate_omega(d, x, -(b + 1))
        x_prev = rotate_omega(d, x, -1)
        pairs = []
        for ci, rot in cs.advice_queries:
            pairs.append((advice_polys[ci], rotate_omega(d, x, rot)))
        for ci, rot in cs.fixed_queries:
            pairs.append((st.fixed_polys[ci], rotate_omega(d, x, rot)))
        pairs.append((random_poly, x))
        for sp in st.sigma_polys:
            pairs.append((sp, x))
        for j, zp in enumerate(z_polys):
            pairs.append((zp, x))
            pairs.append((zp, x_next))
            if j + 1 < len(z_polys):
                pairs.append((zp, x_last))
        for lk_s in lookup_state:
            pairs.extend([(lk_s["z_poly"], x), (lk_s["z_poly"], x_next),
                          (lk_s["a_poly"], x), (lk_s["a_poly"], x_prev),
                          (lk_s["s_poly"], x)])
        for v in eng.eval_polys(pairs):
            t.write_scalar(v)
    # -- multiopen queries (order pins SHPLONK set structure) --------------
    h_folded = eng.const_vec(0, n)
    for c in reversed(h_chunks):
        h_folded = eng.add(eng.scale(h_folded, xn), c)

    queries: list[Query] = []
    for ci, rot in cs.advice_queries:
        queries.append(Query(("advice", ci), advice_polys[ci], rot))
    for j, zp in enumerate(z_polys):
        queries.append(Query(("perm_z", j), zp, 0))
        queries.append(Query(("perm_z", j), zp, 1))
    for j in range(len(z_polys) - 2, -1, -1):
        queries.append(Query(("perm_z", j), z_polys[j], -(b + 1)))
    for li, lk_s in enumerate(lookup_state):
        queries.append(Query(("lk_z", li), lk_s["z_poly"], 0))
        queries.append(Query(("lk_a", li), lk_s["a_poly"], 0))
        queries.append(Query(("lk_s", li), lk_s["s_poly"], 0))
        queries.append(Query(("lk_a", li), lk_s["a_poly"], -1))
        queries.append(Query(("lk_z", li), lk_s["z_poly"], 1))
    for ci, rot in cs.fixed_queries:
        queries.append(Query(("fixed", ci), st.fixed_polys[ci], rot))
    for j, sp in enumerate(st.sigma_polys):
        queries.append(Query(("sigma", j), sp, 0))
    queries.append(Query(("h",), h_folded, 0))
    queries.append(Query(("random",), random_poly, 0))

    with _phase(tr, "shplonk", eng):
        shplonk_open(t, srs, d, queries, x, eng)
    return bytes(t.proof)
