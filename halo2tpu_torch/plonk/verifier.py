"""Proof verifier: a faithful, circuit-generic port of the reference's
on-chain verifier (solidity_verifier_contract/contract.sol).

Every step mirrors a contract region:
  - transcript re-derivation .......... contract.sol:216-305
  - lagrange/instance evals ........... contract.sol:357-435
  - quotient evaluation ............... contract.sol:437-512
  - quotient commitment fold .......... contract.sol:514-533
  - SHPLONK pairing input build ....... contract.sol:535-780
  - pairing ........................... contract.sol:810-817

The reference contract is specialized (codegen) to the Square circuit; this
implementation is generic over our vk, so it verifies every circuit in the
framework with identical math.
"""
from __future__ import annotations

from ..fields.bn254 import R, FR_DELTA, batch_inv, inv_mod
from ..curves import g1 as G1
from ..curves.pairing import g2_neg, pairing_check
from .domain import rotate_omega
from .keygen import VerifyingKey
from .transcript import ProofReader


def _expr_eval(expr, evals_fixed, evals_advice, evals_instance):
    return expr.evaluate(
        constant=lambda c: c % R,
        fixed=lambda q: evals_fixed[(q.column_index, q.rotation)],
        advice=lambda q: evals_advice[(q.column_index, q.rotation)],
        instance=lambda q: evals_instance[(q.column_index, q.rotation)],
        negate=lambda a: (-a) % R,
        add=lambda a, b: (a + b) % R,
        mul=lambda a, b: a * b % R,
    )


def verify_proof(vk: VerifyingKey, srs, instances: list[list[int]], proof: bytes,
                 debug: dict | None = None) -> bool:
    cs = vk.cs
    d = vk.domain
    n = d.n
    b = cs.blinding_factors()
    num_chunks = cs.num_permutation_chunks()
    num_lookups = len(cs.lookups)

    t = ProofReader(proof)
    t.common_scalar(vk.transcript_repr)
    for col in instances:
        for v in col:
            if v % R != v:
                return False
            t.common_scalar(v)

    try:
        advice_comms = [t.read_point() for _ in range(cs.num_advice)]
        for p in advice_comms:
            if not G1.is_on_curve(p):
                return False
        theta = t.squeeze_challenge()
        lookup_perm_comms = []
        for _ in range(num_lookups):
            a_c = t.read_point()
            s_c = t.read_point()
            lookup_perm_comms.append((a_c, s_c))
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
        sigma_evals = [t.read_scalar() for _ in vk.permutation_commitments]
        z_evals = []  # per set: (z_x, z_next, z_last|None)
        for j in range(num_chunks):
            zx = t.read_scalar()
            zn = t.read_scalar()
            zl = t.read_scalar() if j + 1 < num_chunks else None
            z_evals.append((zx, zn, zl))
        lookup_evals = []  # (z, z_next, a, a_prev, s)
        for _ in range(num_lookups):
            lookup_evals.append(tuple(t.read_scalar() for _ in range(5)))

        zeta = t.squeeze_challenge()
        nu = t.squeeze_challenge()
        w_comm = t.read_point()
        mu = t.squeeze_challenge()
        w_prime_comm = t.read_point()
        for p in ([a for pair in lookup_perm_comms for a in pair] + z_comms +
                  lookup_z_comms + [random_comm] + h_comms + [w_comm, w_prime_comm]):
            if not G1.is_on_curve(p):
                return False
    except (IndexError, ValueError):
        return False
    if t.off != len(proof):
        return False

    # ---- lagrange evaluations (contract.sol:357-435) ----------------------
    xn = pow(x, n, R)
    max_inst = max([len(c) for c in instances], default=0)
    rot_range = list(range(-(b + 1), max(max_inst, 1)))
    omega_pows = {rot: pow(d.omega, rot % (n), R) for rot in rot_range}
    denoms = [(x - omega_pows[rot]) % R for rot in rot_range]
    if any(v == 0 for v in denoms):
        return False
    inv_denoms = batch_inv(denoms)
    common = (xn - 1) % R * d.n_inv % R
    lag = {rot: common * omega_pows[rot] % R * inv % R
           for rot, inv in zip(rot_range, inv_denoms)}
    l_0 = lag[0]
    l_last = lag[-(b + 1)]
    l_blind = sum(lag[r_] for r_ in range(-b, 0)) % R
    l_active = (1 - l_last - l_blind) % R

    instance_col_evals = []
    for col in instances:
        instance_col_evals.append(sum(lag[i] * v for i, v in enumerate(col)) % R)

    # ---- quotient evaluation (contract.sol:437-512) -----------------------
    evals_fixed = {(ci, rot): e for (ci, rot), e in zip(cs.fixed_queries, fixed_evals)}
    evals_advice = {(ci, rot): e for (ci, rot), e in zip(cs.advice_queries, advice_evals)}
    evals_instance = {}
    for (ci, rot) in cs.instance_queries:
        if rot != 0:
            raise NotImplementedError("instance queries at nonzero rotation")
        evals_instance[(ci, rot)] = instance_col_evals[ci] if ci < len(instance_col_evals) else 0

    def col_eval(col):
        key = (col.index, 0)
        if col.kind == "advice":
            return evals_advice[key]
        if col.kind == "fixed":
            return evals_fixed[key]
        return evals_instance[key]

    acc_num = 0

    def fold(v):
        nonlocal acc_num
        acc_num = (acc_num * y + v) % R

    for gate in cs.gates:
        for poly in gate.polys:
            fold(_expr_eval(poly, evals_fixed, evals_advice, evals_instance))

    chunk_len = cs.permutation_chunk_len()
    perm_cols = cs.permutation_columns
    chunks = [perm_cols[i:i + chunk_len] for i in range(0, len(perm_cols), chunk_len)]
    if chunks:
        fold(l_0 * ((1 - z_evals[0][0]) % R) % R)
        zl = z_evals[-1][0]
        fold(l_last * ((zl * zl - zl) % R) % R)
        for j in range(1, num_chunks):
            fold(l_0 * ((z_evals[j][0] - z_evals[j - 1][2]) % R) % R)
        gidx = 0
        beta_x = beta * x % R
        for j, chunk in enumerate(chunks):
            lhs = z_evals[j][1]
            rhs = z_evals[j][0]
            for col in chunk:
                v = col_eval(col)
                lhs = lhs * ((v + beta * sigma_evals[gidx] + gamma) % R) % R
                rhs = rhs * ((v + pow(FR_DELTA, gidx, R) * beta_x + gamma) % R) % R
                gidx += 1
            fold((lhs - rhs) * l_active % R)

    for lk, (lz, lz_next, la, la_prev, ls) in zip(cs.lookups, lookup_evals):
        def compress(exprs):
            acc = 0
            for e in exprs:
                acc = (acc * theta + _expr_eval(e, evals_fixed, evals_advice,
                                                evals_instance)) % R
            return acc
        comp_in = compress([p[0] for p in lk.pairs])
        comp_tb = compress([p[1] for p in lk.pairs])
        fold(l_0 * ((1 - lz) % R) % R)
        fold(l_last * ((lz * lz - lz) % R) % R)
        fold(((lz_next * ((la + beta) % R) % R * ((ls + gamma) % R)
               - lz * ((comp_in + beta) % R) % R * ((comp_tb + gamma) % R)) % R)
             * l_active % R)
        fold(l_0 * ((la - ls) % R) % R)
        fold(((la - ls) % R) * ((la - la_prev) % R) % R * l_active % R)

    quotient_eval = acc_num * inv_mod((xn - 1) % R, R) % R

    # ---- folded quotient commitment (contract.sol:514-533) ----------------
    h_folded = None
    for c in reversed(h_comms):  # h = sum_i x^{n i} [h_i], Horner from last
        h_folded = G1.add(G1.scalar_mul(h_folded, xn), c)

    # ---- SHPLONK check (contract.sol:535-780) -----------------------------
    # rebuild queries in the prover's order: (poly_id, rotation, eval, comm)
    queries = []
    for (ci, rot), e in zip(cs.advice_queries, advice_evals):
        queries.append((("advice", ci), rot, e, advice_comms[ci]))
    for j in range(num_chunks):
        queries.append((("perm_z", j), 0, z_evals[j][0], z_comms[j]))
        queries.append((("perm_z", j), 1, z_evals[j][1], z_comms[j]))
    for j in range(num_chunks - 2, -1, -1):
        queries.append((("perm_z", j), -(b + 1), z_evals[j][2], z_comms[j]))
    for li in range(num_lookups):
        lz, lz_next, la, la_prev, ls = lookup_evals[li]
        a_c, s_c = lookup_perm_comms[li]
        queries.append((("lk_z", li), 0, lz, lookup_z_comms[li]))
        queries.append((("lk_a", li), 0, la, a_c))
        queries.append((("lk_s", li), 0, ls, s_c))
        queries.append((("lk_a", li), -1, la_prev, a_c))
        queries.append((("lk_z", li), 1, lz_next, lookup_z_comms[li]))
    for (ci, rot), e in zip(cs.fixed_queries, fixed_evals):
        queries.append((("fixed", ci), rot, e, vk.fixed_commitments[ci]))
    for j, e in enumerate(sigma_evals):
        queries.append((("sigma", j), 0, e, vk.permutation_commitments[j]))
    queries.append((("h",), 0, quotient_eval, h_folded))
    queries.append((("random",), 0, random_eval, random_comm))

    # group into rotation sets (same algorithm as the prover)
    poly_rotations: dict[tuple, list[int]] = {}
    poly_comm: dict[tuple, object] = {}
    poly_evals: dict[tuple, dict[int, int]] = {}
    order = []
    for pid, rot, e, comm in queries:
        if pid not in poly_rotations:
            poly_rotations[pid] = []
            poly_comm[pid] = comm
            poly_evals[pid] = {}
            order.append(pid)
        if rot not in poly_rotations[pid]:
            poly_rotations[pid].append(rot)
        poly_evals[pid][rot] = e
    sets = []
    set_index: dict[frozenset, int] = {}
    for pid in order:
        rots = frozenset(poly_rotations[pid])
        if rots not in set_index:
            set_index[rots] = len(sets)
            sets.append({"rotations": sorted(rots), "polys": []})
        sets[set_index[rots]]["polys"].append(pid)

    # r_k(mu), d_k, and combined commitments
    set_points = [[rotate_omega(d, x, rot) for rot in s_["rotations"]] for s_ in sets]
    z_mu = []
    for pts in set_points:
        zv = 1
        for pt in pts:
            zv = zv * ((mu - pt) % R) % R
        z_mu.append(zv)
    if any(v == 0 for v in z_mu):
        return False
    z0_mu = z_mu[0]
    z_mu_inv = batch_inv(z_mu)
    d_norm = [z0_mu * zi % R for zi in z_mu_inv]

    big_r = 0
    acc_comm = None
    nup = 1
    for s_, pts, dk in zip(sets, set_points, d_norm):
        # combined evals per point with zeta powers; barycentric r_k(mu)
        comb = []
        for rot, pt in zip(s_["rotations"], pts):
            v = 0
            zp = 1
            for pid in s_["polys"]:
                v = (v + zp * poly_evals[pid][rot]) % R
                zp = zp * zeta % R
            comb.append(v)
        # r_k(mu) by direct Lagrange interpolation at mu
        r_mu = 0
        for i, (pt, v) in enumerate(zip(pts, comb)):
            num_, den_ = 1, 1
            for j2, pt2 in enumerate(pts):
                if j2 == i:
                    continue
                num_ = num_ * ((mu - pt2) % R) % R
                den_ = den_ * ((pt - pt2) % R) % R
            r_mu = (r_mu + v * num_ % R * inv_mod(den_, R)) % R
        coef = nup * dk % R
        big_r = (big_r + coef * r_mu) % R
        # combined commitment
        c_k = None
        zp = 1
        for pid in s_["polys"]:
            c_k = G1.add(c_k, G1.scalar_mul(poly_comm[pid], zp))
            zp = zp * zeta % R
        acc_comm = G1.add(acc_comm, G1.scalar_mul(c_k, coef))
        nup = nup * nu % R

    from ..fields.bn254 import G1_GEN
    acc_comm = G1.add(acc_comm, G1.scalar_mul(G1_GEN, (-big_r) % R))
    acc_comm = G1.add(acc_comm, G1.scalar_mul(w_comm, (-z0_mu) % R))
    acc_comm = G1.add(acc_comm, G1.scalar_mul(w_prime_comm, mu))

    if debug is not None:
        debug.update(dict(
            theta=theta, beta=beta, gamma=gamma, y=y, x=x, zeta=zeta, nu=nu,
            mu=mu, quotient_eval=quotient_eval, big_r=big_r, acc_comm=acc_comm,
            sets=sets, z_mu=z_mu, d_norm=d_norm, l_0=l_0, l_last=l_last,
            l_blind=l_blind, instance_col_evals=instance_col_evals,
            w_comm=w_comm, w_prime_comm=w_prime_comm, h_folded=h_folded,
            poly_evals=poly_evals,
        ))

    # pairing: e(acc, [1]_2) * e(W', [-tau]_2) == 1
    return pairing_check([
        (acc_comm, srs.g2),
        (w_prime_comm, g2_neg(srs.s_g2)),
    ])
