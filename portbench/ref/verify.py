"""Verify a proof's bytes against the reference's key and the public
instances.

The steps are halo2's verifier as the program's own verifier (a port of
the reference contract, solidity_verifier_contract/contract.sol) takes
them: the Keccak transcript replayed from the key's hash and the
instances, every commitment on the curve, the quotient identity at x
(gates, permutation chunks, lookups) and the SHPLONK multi-opening.  One
step differs: the last pairing check e(A, [1]_2) = e(W', [tau]_2) holds
exactly when A = tau W' in G1, and the reference knows the dev SRS's tau.
So it checks A - tau W' = 0 with one multi-scalar multiplication, and
adds the key's commitments through their discrete logs (RefKey.*_logs)
to the generator's scalar instead of multiplying each point.
"""
from __future__ import annotations

from .curves import g1 as G1
from .fields.bn254 import FR_DELTA, G1_GEN, Q, R, batch_inv, inv_mod
from .plonk.domain import rotate_omega
from .plonk.transcript import ProofReader


def _expr_eval(expr, fixed, advice, instance):
    return expr.evaluate(
        constant=lambda c: c % R,
        fixed=lambda q: fixed[(q.column_index, q.rotation)],
        advice=lambda q: advice[(q.column_index, q.rotation)],
        instance=lambda q: instance[(q.column_index, q.rotation)],
        negate=lambda a: (-a) % R,
        add=lambda a, b: (a + b) % R,
        mul=lambda a, b: a * b % R,
    )


def verify(key, tau: int, instances: list[list[int]], proof: bytes) -> str:
    """'' when the proof verifies, else the first reason it does not."""
    cs = key.cs
    d = key.domain
    n = d.n
    b = cs.blinding_factors()
    num_chunks = cs.num_permutation_chunks()
    num_lookups = len(cs.lookups)
    if len(instances) != cs.num_instance:
        return "instance column count"

    t = ProofReader(proof)
    t.common_scalar(key.transcript_repr)
    for col in instances:
        for v in col:
            if not 0 <= v < R:
                return "instance out of range"
            t.common_scalar(v)
    try:
        advice_comms = [t.read_point() for _ in range(cs.num_advice)]
        theta = t.squeeze_challenge()
        lookup_perm = [(t.read_point(), t.read_point())
                       for _ in range(num_lookups)]
        beta = t.squeeze_challenge()
        gamma = t.squeeze_challenge()
        z_comms = [t.read_point() for _ in range(num_chunks)]
        lookup_z_comms = [t.read_point() for _ in range(num_lookups)]
        random_comm = t.read_point()
        y = t.squeeze_challenge()
        h_comms = [t.read_point() for _ in range(d.quotient_poly_degree)]
        x = t.squeeze_challenge()
        advice_evals = [t.read_scalar() for _ in cs.advice_queries]
        fixed_evals = [t.read_scalar() for _ in cs.fixed_queries]
        random_eval = t.read_scalar()
        sigma_evals = [t.read_scalar() for _ in key.sigma_logs]
        z_evals = []
        for j in range(num_chunks):
            zx, zn = t.read_scalar(), t.read_scalar()
            zl = t.read_scalar() if j + 1 < num_chunks else None
            z_evals.append((zx, zn, zl))
        lookup_evals = [tuple(t.read_scalar() for _ in range(5))
                        for _ in range(num_lookups)]
        zeta = t.squeeze_challenge()
        nu = t.squeeze_challenge()
        w_comm = t.read_point()
        mu = t.squeeze_challenge()
        w_prime = t.read_point()
    except (IndexError, ValueError):
        return "proof too short"
    if t.off != len(proof):
        return "proof length"
    points = (advice_comms + [p for pair in lookup_perm for p in pair]
              + z_comms + lookup_z_comms + [random_comm] + h_comms
              + [w_comm, w_prime])
    if not all(p is None or (max(p) < Q and G1.is_on_curve(p))
               for p in points):
        return "point off the curve"
    scalars = (advice_evals + fixed_evals + [random_eval] + sigma_evals
               + [v for z in z_evals for v in z if v is not None]
               + [v for e in lookup_evals for v in e])
    if any(v >= R for v in scalars):
        return "evaluation out of range"

    # Lagrange values at x
    xn = pow(x, n, R)
    max_inst = max([len(c) for c in instances], default=0)
    rots = list(range(-(b + 1), max(max_inst, 1)))
    wp = {r_: pow(d.omega, r_ % n, R) for r_ in rots}
    dens = [(x - wp[r_]) % R for r_ in rots]
    if any(v == 0 for v in dens):
        return "x in the domain"
    common = (xn - 1) % R * d.n_inv % R
    lag = {r_: common * wp[r_] % R * inv % R
           for r_, inv in zip(rots, batch_inv(dens))}
    l_0, l_last = lag[0], lag[-(b + 1)]
    l_blind = sum(lag[r_] for r_ in range(-b, 0)) % R
    l_active = (1 - l_last - l_blind) % R
    inst_evals = [sum(lag[i] * v for i, v in enumerate(col)) % R
                  for col in instances]

    # the quotient identity at x
    ev_fixed = dict(zip(cs.fixed_queries, fixed_evals))
    ev_advice = dict(zip(cs.advice_queries, advice_evals))
    ev_inst = {}
    for ci, rot in cs.instance_queries:
        if rot != 0:
            return "instance query at a rotation"
        ev_inst[(ci, rot)] = inst_evals[ci]

    def col_eval(col):
        table = {"advice": ev_advice, "fixed": ev_fixed}.get(col.kind,
                                                            ev_inst)
        return table[(col.index, 0)]

    acc = 0

    def fold(v):
        nonlocal acc
        acc = (acc * y + v) % R

    for gate in cs.gates:
        for poly in gate.polys:
            fold(_expr_eval(poly, ev_fixed, ev_advice, ev_inst))
    chunk_len = cs.permutation_chunk_len()
    perm_cols = cs.permutation_columns
    chunks = [perm_cols[i:i + chunk_len]
              for i in range(0, len(perm_cols), chunk_len)]
    if chunks:
        fold(l_0 * ((1 - z_evals[0][0]) % R) % R)
        zl = z_evals[-1][0]
        fold(l_last * ((zl * zl - zl) % R) % R)
        for j in range(1, num_chunks):
            fold(l_0 * ((z_evals[j][0] - z_evals[j - 1][2]) % R) % R)
        g = 0
        beta_x = beta * x % R
        for j, chunk in enumerate(chunks):
            lhs, rhs = z_evals[j][1], z_evals[j][0]
            for col in chunk:
                v = col_eval(col)
                lhs = lhs * ((v + beta * sigma_evals[g] + gamma) % R) % R
                rhs = rhs * ((v + pow(FR_DELTA, g, R) * beta_x + gamma)
                             % R) % R
                g += 1
            fold((lhs - rhs) * l_active % R)
    for lk, (lz, lz_next, la, la_prev, ls) in zip(cs.lookups, lookup_evals):
        def compress(exprs):
            c = 0
            for e in exprs:
                c = (c * theta + _expr_eval(e, ev_fixed, ev_advice,
                                            ev_inst)) % R
            return c
        cin = compress([p[0] for p in lk.pairs])
        ctb = compress([p[1] for p in lk.pairs])
        fold(l_0 * ((1 - lz) % R) % R)
        fold(l_last * ((lz * lz - lz) % R) % R)
        fold(((lz_next * ((la + beta) % R) % R * ((ls + gamma) % R)
               - lz * ((cin + beta) % R) % R * ((ctb + gamma) % R)) % R)
             * l_active % R)
        fold(l_0 * ((la - ls) % R) % R)
        fold(((la - ls) % R) * ((la - la_prev) % R) % R * l_active % R)
    quotient_eval = acc * inv_mod((xn - 1) % R, R) % R

    # the prover's queries: (poly id, rotation, evaluation, commitment),
    # where a commitment is ("pt", point), ("log", f(tau)) or ("h",)
    q = []
    for (ci, rot), e in zip(cs.advice_queries, advice_evals):
        q.append((("advice", ci), rot, e, ("pt", advice_comms[ci])))
    for j in range(num_chunks):
        q.append((("perm_z", j), 0, z_evals[j][0], ("pt", z_comms[j])))
        q.append((("perm_z", j), 1, z_evals[j][1], ("pt", z_comms[j])))
    for j in range(num_chunks - 2, -1, -1):
        q.append((("perm_z", j), -(b + 1), z_evals[j][2], ("pt", z_comms[j])))
    for li in range(num_lookups):
        lz, lz_next, la, la_prev, ls = lookup_evals[li]
        a_c, s_c = lookup_perm[li]
        q.append((("lk_z", li), 0, lz, ("pt", lookup_z_comms[li])))
        q.append((("lk_a", li), 0, la, ("pt", a_c)))
        q.append((("lk_s", li), 0, ls, ("pt", s_c)))
        q.append((("lk_a", li), -1, la_prev, ("pt", a_c)))
        q.append((("lk_z", li), 1, lz_next, ("pt", lookup_z_comms[li])))
    for (ci, rot), e in zip(cs.fixed_queries, fixed_evals):
        q.append((("fixed", ci), rot, e, ("log", key.fixed_logs[ci])))
    for j, e in enumerate(sigma_evals):
        q.append((("sigma", j), 0, e, ("log", key.sigma_logs[j])))
    q.append((("h",), 0, quotient_eval, ("h",)))
    q.append((("random",), 0, random_eval, ("pt", random_comm)))

    rot_of, comm_of, ev_of, order = {}, {}, {}, []
    for pid, rot, e, comm in q:
        if pid not in rot_of:
            rot_of[pid], comm_of[pid], ev_of[pid] = [], comm, {}
            order.append(pid)
        if rot not in rot_of[pid]:
            rot_of[pid].append(rot)
        ev_of[pid][rot] = e
    sets, index = [], {}
    for pid in order:
        rs = frozenset(rot_of[pid])
        if rs not in index:
            index[rs] = len(sets)
            sets.append((sorted(rs), []))
        sets[index[rs]][1].append(pid)

    set_points = [[rotate_omega(d, x, r_) for r_ in rs] for rs, _ in sets]
    z_mu = []
    for pts in set_points:
        zv = 1
        for pt in pts:
            zv = zv * ((mu - pt) % R) % R
        z_mu.append(zv)
    if any(v == 0 for v in z_mu):
        return "mu on a query point"
    d_norm = [z_mu[0] * zi % R for zi in batch_inv(z_mu)]

    # A = sum_k nu^k d_k (C_k - r_k(mu) G) - Z_0(mu) W + mu W'; check
    # A - tau W' = 0 as one MSM: proof points with their scalars, the
    # key's columns through their logs into the generator's scalar
    big_r, gen = 0, 0
    terms: dict = {}

    def add_term(p, s):
        if p is not None:
            terms[p] = (terms.get(p, 0) + s) % R

    nup = 1
    for (rs, pids), pts, dk in zip(sets, set_points, d_norm):
        comb = []
        for rot in rs:
            v, zp = 0, 1
            for pid in pids:
                v = (v + zp * ev_of[pid][rot]) % R
                zp = zp * zeta % R
            comb.append(v)
        r_mu = 0
        for i, (pt, v) in enumerate(zip(pts, comb)):
            num, den = 1, 1
            for j2, pt2 in enumerate(pts):
                if j2 != i:
                    num = num * ((mu - pt2) % R) % R
                    den = den * ((pt - pt2) % R) % R
            r_mu = (r_mu + v * num % R * inv_mod(den, R)) % R
        coef = nup * dk % R
        big_r = (big_r + coef * r_mu) % R
        zp = 1
        for pid in pids:
            s = coef * zp % R
            kind = comm_of[pid]
            if kind[0] == "pt":
                add_term(kind[1], s)
            elif kind[0] == "log":
                gen = (gen + s * kind[1]) % R
            else:                       # h = sum_i x^(n i) h_i
                xi = 1
                for hc in h_comms:
                    add_term(hc, s * xi % R)
                    xi = xi * xn % R
            zp = zp * zeta % R
        nup = nup * nu % R
    gen = (gen - big_r) % R
    add_term(w_comm, (-z_mu[0]) % R)
    add_term(w_prime, (mu - tau) % R)
    pts = list(terms) + [G1_GEN]
    if G1.msm(pts, [terms[p] for p in pts[:-1]] + [gen]) is not None:
        return "opening check"
    return ""
