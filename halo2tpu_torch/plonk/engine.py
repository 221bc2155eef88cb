"""TorchEngine: the prover's polynomial-arithmetic engine on torch tensors.
Port of halo2tpu/plonk/engine.py::JaxEngine (same method set, same values).

Vectors are (n, 8) int32 Montgomery limb tensors on the engine's device.
Every method keeps data on the device; the only device -> host reads in a
proof are commitment points, evaluations, one row per grand-product chunk
and the lookup failure flags.  Field multiplies go through jfield.mont_mul
(the mont_mul kernel on CUDA); commitments go through the windowed MSM
(the fold_mixed / fold_add_any / fold_dbl_any kernels on CUDA).
"""
from __future__ import annotations

import numpy as np
import torch

from ..curves import g1 as G1
from ..fields.bn254 import R, FR_DELTA, inv_mod
from . import polyops
from .domain import Domain
from ..fields import jfield
from ..fields.jfield import FR, NLIMB, device_of
from ..ops import ntt as tntt
from ..ops.msm import NUM_WINDOWS, MSMContext, points_tag


def _tree_sum(arr, dim: int = 0):
    """Sum mod r over `dim` by halving rounds."""
    while arr.shape[dim] > 1:
        half = arr.shape[dim] // 2
        head = jfield.add(FR, arr.narrow(dim, 0, half),
                          arr.narrow(dim, half, half))
        arr = head if 2 * half == arr.shape[dim] else torch.cat(
            [head, arr.narrow(dim, 2 * half, arr.shape[dim] - 2 * half)],
            dim)
    return arr.select(dim, 0)


def _powers(a_enc, n: int):
    """On-device [a^0 .. a^(n-1)] by doubling: a_enc (8,) Montgomery."""
    out = jfield.one_like(FR, a_enc)[None]
    step = a_enc[None]
    while out.shape[0] < n:
        out = torch.cat([out, jfield.mont_mul(FR, out, step)])
        step = jfield.mont_mul(FR, step, step)
    return out[:n]


def _pack_keys(plain):
    """(m, 8) plain limbs -> (m, 8) int64 words, most significant first
    (lexicographic row order == numeric order)."""
    return jfield.u64(plain).flip(-1)


_MSM_CTX_CACHE: dict = {}


def _shared_msm_ctx(srs, n: int, device) -> MSMContext:
    """MSM context over the first n Lagrange bases, shared process-wide per
    (SRS content, n, device): the window table is degree-independent."""
    bases = srs.g_lagrange[:n]
    key = (points_tag(bases), n, device)
    if key not in _MSM_CTX_CACHE:
        _MSM_CTX_CACHE[key] = MSMContext(bases, cache_tag=f"lag{n}_{key[0]}",
                                         device=device)
    return _MSM_CTX_CACHE[key]


class TorchEngine:
    """Torch engine: vectors are (n, 8) int32 Montgomery limb tensors on an
    explicit device.  device="cuda" with no CUDA raises."""

    name = "torch"
    stack_chunk = 64        # columns per batched NTT pass
    gp_chunk = 8            # vectors per grand-product pass
    numden_chunk = 16       # permutation chunks per numerator pass
    msm_batch = 8           # columns per MSM fold
    _NARROW_PLANES = 8      # digit planes of a bounded (<= 63-bit) column

    def __init__(self, domain: Domain, srs, device="cuda"):
        self.d = domain
        self.srs = srs
        self.device = device_of(device)
        self._plan = tntt.get_plan(domain.n, domain.omega, self.device)
        self._msm_lagrange = _shared_msm_ctx(srs, domain.n, self.device)
        self._scalar_cache = {}
        self._part_scale_cache = {}

    # -- representation ----------------------------------------------------
    def _encode(self, vals):
        return FR.encode(vals, self.device)

    def from_ints(self, vals):
        return self._encode(vals)

    def from_ints_stack(self, cols, reduced=False, bits=None,
                        blind_start=None):
        """Equal-length int columns -> list of (n, 8) vectors in one packed
        transfer.  Columns with bits <= 16 ride a u16 value wire with their
        full-width blinding tail (rows >= blind_start) patched in."""
        if not cols:
            return []
        out = [None] * len(cols)
        narrow = [i for i, b in enumerate(bits or [])
                  if b is not None and b <= 16] if blind_start else []
        rest = [i for i in range(len(cols)) if i not in set(narrow)]
        if narrow:
            n = len(cols[narrow[0]])
            main = np.zeros((len(narrow), n), "<u2")
            tails = []
            for j, i in enumerate(narrow):
                main[j, :blind_start] = cols[i][:blind_start]
                tails.append(jfield.ints_to_limbs16(cols[i][blind_start:]))
            enc = FR.encode_narrow_stack(main, np.stack(tails), blind_start,
                                         self.device)
            for j, i in enumerate(narrow):
                out[i] = enc[j]
        if rest:
            u16 = np.stack([jfield.ints_to_limbs16(
                cols[i] if reduced else [v % R for v in cols[i]])
                for i in rest])
            stacked = FR.encode_packed(u16, self.device)
            for j, i in enumerate(rest):
                out[i] = stacked[j]
        return out

    def from_packed_stack(self, arrs):
        if not arrs:
            return []
        stacked = FR.encode_packed(np.stack([np.asarray(a) for a in arrs]),
                                   self.device)
        return list(stacked.unbind(0))

    def to_ints(self, vec):
        return FR.decode(vec)

    def _enc_scalar(self, c):
        c %= R
        v = self._scalar_cache.get(c)
        if v is None:
            v = self._encode([c])[0]
            if len(self._scalar_cache) > 256:
                self._scalar_cache.clear()
            self._scalar_cache[c] = v
        return v

    def const_vec(self, c, n):
        return self._enc_scalar(c).expand(n, NLIMB)

    # -- elementwise -------------------------------------------------------
    def add(self, a, b):
        return jfield.add(FR, a, b)

    def sub(self, a, b):
        return jfield.sub(FR, a, b)

    def mul(self, a, b):
        return jfield.mont_mul(FR, a, b)

    def neg(self, a):
        return jfield.neg(FR, a)

    def scale(self, a, c):
        return jfield.mont_mul(FR, a, self._enc_scalar(c))

    def add_const(self, a, c):
        return jfield.add(FR, a, self._enc_scalar(c))

    def rotate(self, a, k):
        return torch.roll(a, -int(k % a.shape[0]), 0)

    # -- scalar access -----------------------------------------------------
    def read_rows(self, vecs, row):
        return FR.decode(torch.stack([v[row] for v in vecs]))

    def set_rows(self, vec, start, ints):
        if not ints:
            return vec
        out = vec.clone()
        out[start:start + len(ints)] = self._encode(ints)
        return out

    def assemble_z_batch(self, prefs, heads, blind_start, blind_lists):
        """z[j] = [head_j, head_j * pref_j[:-1]] with rows >= blind_start
        replaced by the blinding values."""
        if not prefs:
            return []
        heads_e = self._encode([h % R for h in heads])
        blinds = self._encode([v % R for b in blind_lists for v in b]
                              ).reshape(len(prefs), -1, NLIMB)
        scaled = jfield.mont_mul(FR, torch.stack(prefs), heads_e[:, None])
        z = torch.cat([heads_e[:, None], scaled[:, :-1]], dim=1)
        z[:, blind_start:blind_start + blinds.shape[1]] = blinds
        return list(z.unbind(0))

    def set_rows_batch(self, vecs, start, ints_lists):
        if not vecs:
            return []
        patches = self._encode([v % R for ints in ints_lists for v in ints]
                               ).reshape(len(vecs), -1, NLIMB)
        out = torch.stack(vecs)
        out[:, start:start + patches.shape[1]] = patches
        return list(out.unbind(0))

    # -- transforms --------------------------------------------------------
    def _stack_transform(self, vecs, fn):
        """Apply fn over (n, C, 8) stacks in bounded chunks."""
        out = []
        for i in range(0, len(vecs), self.stack_chunk):
            chunk = vecs[i:i + self.stack_chunk]
            res = fn(torch.stack(chunk, dim=1))
            out.extend(res.unbind(1))
        return out

    def lagrange_to_coeff(self, vec):
        return tntt.intt(self._plan, vec)

    def lagrange_to_coeff_stack(self, vecs):
        if not vecs:
            return []
        return self._stack_transform(vecs, lambda s: tntt.intt(self._plan, s))

    def coeff_to_lagrange_stack(self, vecs):
        if not vecs:
            return []
        return self._stack_transform(vecs, lambda s: tntt.ntt(self._plan, s))

    def _part_pows(self, c: int):
        """(n, 8) Montgomery powers c^i, cached per c."""
        key = c % R
        v = self._part_scale_cache.get(key)
        if v is None:
            v = _powers(self._enc_scalar(c), self.d.n)
            if len(self._part_scale_cache) > 96:
                self._part_scale_cache.clear()
            self._part_scale_cache[key] = v
        return v

    def coeff_to_part_stack(self, vecs, q):
        if not vecs:
            return []
        pows = self._part_pows(polyops.part_shift(self.d, q))[:, None]
        return self._stack_transform(
            vecs, lambda s: tntt.ntt(self._plan, jfield.mont_mul(FR, s, pows)))

    def parts_to_h_chunks(self, parts, qpd):
        d = self.d
        n, step = d.n, d.extended_n // d.n
        alpha_inv = inv_mod(pow(d.extended_omega, n, R), R)
        g_n_inv = inv_mod(pow(d.coset_shift, n, R), R)
        step_inv = inv_mod(step, R)
        us = []
        for q, part in enumerate(parts):
            u = self.lagrange_to_coeff(part)
            ci = inv_mod(polyops.part_shift(d, q), R)
            us.append(jfield.mont_mul(FR, u, self._part_pows(ci)))
        U = torch.stack(us)                                  # (step, n, 8)
        chunks = []
        for s in range(qpd):
            coefs = [pow(alpha_inv, q * s, R) * pow(g_n_inv, s, R)
                     * step_inv % R for q in range(step)]
            chunks.append(self._wsum(U, self._encode(coefs)))
        return chunks

    # -- lookups -----------------------------------------------------------
    def permute_lookup(self, ci_dev, ct_dev, usable):
        """halo2 permuted pair (A', S') and a failure flag, matching
        HostEngine.permute_lookup: A' = sorted inputs; S' puts one table
        copy under each first occurrence in A' and fills the other rows with
        the leftover table values in ascending order.  Rows >= usable are
        zero."""
        n = ci_dev.shape[0]
        a = _pack_keys(FR.from_mont(ci_dev[:usable]))
        t = _pack_keys(FR.from_mont(ct_dev[:usable]))
        uniq, ids = torch.unique(torch.cat([a, t]), dim=0,
                                 return_inverse=True)
        k = uniq.shape[0]
        ia, it = ids[:usable], ids[usable:]
        count_a = torch.bincount(ia, minlength=k)
        count_t = torch.bincount(it, minlength=k)
        fail = ((count_a > 0) & (count_t == 0)).any()
        sorted_ids = torch.sort(ia).values
        first = torch.ones_like(sorted_ids, dtype=torch.bool)
        first[1:] = sorted_ids[1:] != sorted_ids[:-1]
        left = (count_t - (count_a > 0).to(count_t.dtype)).clamp(min=0)
        rest = torch.repeat_interleave(
            torch.arange(k, device=ia.device), left)
        gaps = int((~first).sum())
        rest = torch.cat([rest, rest.new_zeros(max(0, gaps - rest.shape[0]))])
        s_ids = sorted_ids.clone()
        s_ids[~first] = rest[:gaps]
        words = uniq.flip(-1)                 # back to little-endian limbs
        ap = torch.zeros((n, NLIMB), dtype=torch.int32, device=ci_dev.device)
        sp = torch.zeros_like(ap)
        ap[:usable] = jfield.i32(words[sorted_ids])
        sp[:usable] = jfield.i32(words[s_ids])
        return FR.to_mont(ap), FR.to_mont(sp), fail

    def permute_lookup_batch(self, comp_ins, comp_tbs, usable, max_bits):
        """Every lookup's permuted pair; max_bits is not needed (each lookup
        is checked against its own table only)."""
        outs = [self.permute_lookup(ci, ct, usable)
                for ci, ct in zip(comp_ins, comp_tbs)]
        return ([o[0] for o in outs], [o[1] for o in outs],
                [o[2] for o in outs])

    @staticmethod
    def check_lookup_fails(fails):
        if fails and bool(torch.stack(fails).any()):
            raise ValueError("lookup failure: input value not in table")

    # -- evaluation --------------------------------------------------------
    def _wsum(self, stacked, coefs):
        """sum_i coefs[i] * stacked[i]: (m, n, 8) x (m, 8)."""
        return _tree_sum(jfield.mont_mul(FR, stacked, coefs[:, None]))

    def eval_polys(self, pairs):
        """[(poly, x), ...] -> evaluations; one stacked multiply + tree sum
        per distinct x (chunked to 2^22 rows), one decode at the end."""
        groups: dict[int, list[int]] = {}
        for i, (_, x) in enumerate(pairs):
            groups.setdefault(x % R, []).append(i)
        budget = 1 << 22
        results = []
        for x, idxs in groups.items():
            n = max(pairs[i][0].shape[0] for i in idxs)
            per = max(1, budget // n)
            pows = _powers(self._enc_scalar(x), n)
            for j in range(0, len(idxs), per):
                sub_idx = idxs[j:j + per]
                stacked = torch.stack([torch.nn.functional.pad(
                    pairs[i][0], (0, 0, 0, n - pairs[i][0].shape[0]))
                    for i in sub_idx])
                prod = jfield.mont_mul(FR, stacked, pows)
                results.append((_tree_sum(prod, 1), sub_idx))
        vals = FR.decode(torch.cat([r[0] for r in results]))
        out = [None] * len(pairs)
        vi = 0
        for _, idxs in results:
            for i in idxs:
                out[i] = vals[vi]
                vi += 1
        return out

    def div_linear(self, vec, a):
        """vec(X) / (X - a), zero-padded to the input length: power vectors
        + one suffix scan."""
        a %= R
        a_e = self._enc_scalar(a)
        ainv_e = self._enc_scalar(inv_mod(a, R))
        n = vec.shape[0]
        t = jfield.mont_mul(FR, vec, _powers(a_e, n))
        S = jfield.suffix_sum_mod(FR, t)
        Sshift = torch.cat([S[1:], torch.zeros_like(S[:1])])
        out = jfield.mont_mul(FR, Sshift, _powers(ainv_e, n))
        return jfield.mont_mul(FR, out, ainv_e)

    def weighted_sum(self, vecs, coefs):
        """sum_i coefs[i] * vecs[i] in chunks of 64 vectors."""
        assert len(vecs) == len(coefs) and vecs
        acc = None
        for i in range(0, len(vecs), 64):
            cenc = self._encode([c % R for c in coefs[i:i + 64]])
            part = self._wsum(torch.stack(vecs[i:i + 64]), cenc)
            acc = part if acc is None else jfield.add(FR, acc, part)
        return acc

    # -- grand products ----------------------------------------------------
    def grand_products(self, nums, dens):
        """Per-vector prefix products of num/den (one batch inversion per
        chunk of gp_chunk vectors)."""
        out = []
        for i in range(0, len(nums), self.gp_chunk):
            ns = torch.stack(nums[i:i + self.gp_chunk])
            ds = torch.stack(dens[i:i + self.gp_chunk])
            m, n = ns.shape[0], ns.shape[1]
            den_inv = jfield.batch_inv_scan(FR, ds.reshape(m * n, NLIMB))
            ratios = jfield.mont_mul(FR, ns, den_inv.reshape(m, n, NLIMB))
            pref = jfield._prefix_prod(FR, ratios.transpose(0, 1))
            out.extend(pref.transpose(0, 1).unbind(0))
        return out

    def perm_numden_chunks(self, chunk_cols, chunk_sigmas, omega_pows,
                           beta, gamma, chunk_deltas):
        """Every permutation chunk's numerator prod(col + beta delta_j
        omega^i + gamma) and denominator prod(col + beta sigma + gamma).
        Short chunks are padded with zero col/sigma/delta lanes (both
        factors are then gamma: the ratio is unchanged)."""
        if not chunk_cols:
            return [], []
        n = chunk_cols[0][0].shape[0]
        m = max(len(c) for c in chunk_cols)
        zero = torch.zeros((n, NLIMB), dtype=torch.int32, device=self.device)
        zero_s = torch.zeros(NLIMB, dtype=torch.int32, device=self.device)
        be, ge = self._enc_scalar(beta), self._enc_scalar(gamma)
        nums, dens = [], []
        for i in range(0, len(chunk_cols), self.numden_chunk):
            cc = chunk_cols[i:i + self.numden_chunk]
            cs = chunk_sigmas[i:i + self.numden_chunk]
            cd = chunk_deltas[i:i + self.numden_chunk]
            cols = torch.stack([torch.stack(list(c) + [zero] * (m - len(c)))
                                for c in cc])               # (K, m, n, 8)
            sigs = torch.stack([torch.stack(list(s) + [zero] * (m - len(s)))
                                for s in cs])
            bds = torch.stack([torch.stack(
                [self._enc_scalar(beta * dl % R) for dl in d]
                + [zero_s] * (m - len(d))) for d in cd])    # (K, m, 8)
            num = den = jfield.one_like(FR, cols[:, 0])
            for j in range(m):
                idp = jfield.mont_mul(FR, omega_pows, bds[:, j, None])
                num = jfield.mont_mul(FR, num, jfield.add(
                    FR, jfield.add(FR, cols[:, j], idp), ge))
                sg = jfield.mont_mul(FR, sigs[:, j], be)
                den = jfield.mont_mul(FR, den, jfield.add(
                    FR, jfield.add(FR, cols[:, j], sg), ge))
            nums.extend(num.unbind(0))
            dens.extend(den.unbind(0))
        return nums, dens

    def lookup_numden(self, comp_ins, comp_tbs, a_vecs, s_vecs, beta, gamma):
        """Per-lookup numerators (A + beta)(S + gamma) and denominators
        (A' + beta)(S' + gamma)."""
        if not comp_ins:
            return [], []
        be, ge = self._enc_scalar(beta), self._enc_scalar(gamma)
        nums = jfield.mont_mul(FR, jfield.add(FR, torch.stack(comp_ins), be),
                               jfield.add(FR, torch.stack(comp_tbs), ge))
        dens = jfield.mont_mul(FR, jfield.add(FR, torch.stack(a_vecs), be),
                               jfield.add(FR, torch.stack(s_vecs), ge))
        return list(nums.unbind(0)), list(dens.unbind(0))

    def sigma_from_mapping(self, mapping):
        """(ncols, n, 2) cell mapping -> sigma label columns delta^j' *
        omega^i' (two gathers + one multiply per chunk of columns)."""
        mapping = np.asarray(mapping)
        ncols, n = mapping.shape[0], mapping.shape[1]
        deltas = [1] * max(ncols, 1)
        for j in range(1, ncols):
            deltas[j] = deltas[j - 1] * FR_DELTA % R
        dpows = self._encode(deltas)
        opows = _powers(self._enc_scalar(self.d.omega), n)
        out = []
        for i in range(0, ncols, self.stack_chunk):
            mj = torch.from_numpy(
                mapping[i:i + self.stack_chunk].astype(np.int64)).to(
                self.device)
            labels = jfield.mont_mul(FR, dpows[mj[..., 0]], opows[mj[..., 1]])
            out.extend(labels.unbind(0))
        return out

    # -- commitments -------------------------------------------------------
    def commit_lagrange_batch(self, vecs, value_bits=None, blind_start=None):
        """value_bits[i]: bit bound of vec i's values on rows [0,
        blind_start): such columns fold only their live digit planes, with
        the full-width blinding tail folded separately.  None entries (or no
        blind_start) take the full fold."""
        return self._commit(self._msm_lagrange, vecs, value_bits,
                            blind_start)

    def commit_batch(self, vecs):
        """Coefficient-form commitments, through the Lagrange bases:
        commit_G(coeffs) == commit_Glag(NTT(coeffs))."""
        n = self.d.n
        evals = self.coeff_to_lagrange_stack(
            [torch.nn.functional.pad(v, (0, 0, 0, n - v.shape[0]))
             for v in vecs])
        return self._commit(self._msm_lagrange, evals)

    def _tail_ctx(self, c0: int) -> MSMContext:
        """MSM context over the last n - c0 Lagrange bases (the blinding
        rows of narrow columns), shared process-wide."""
        n = self.d.n
        assert (n - c0) & (n - c0 - 1) == 0, (
            f"tail MSM over {n - c0} bases: not a power of two")
        bases = self.srs.g_lagrange[c0:n]
        key = (points_tag(bases), "tail", c0, n, self.device)
        if key not in _MSM_CTX_CACHE:
            _MSM_CTX_CACHE[key] = MSMContext(bases, device=self.device)
        return _MSM_CTX_CACHE[key]

    def _commit(self, ctx: MSMContext, vecs, value_bits=None,
                blind_start=None):
        """Batched commitment.  Columns with a value bound split into a
        narrow-plane fold over rows [0, c0) plus a full-width fold of the
        tail rows [c0, n) over the tail bases; the two points add on the
        host."""
        npad = ctx.points.shape[0]
        P = self._NARROW_PLANES
        n_idx, f_idx = [], []
        for i in range(len(vecs)):
            b = value_bits[i] if value_bits is not None else None
            narrow = (b is not None and b <= 8 * P - 1
                      and blind_start is not None and npad == self.d.n)
            (n_idx if narrow else f_idx).append(i)

        def plain(idx):
            return FR.from_mont(torch.stack([
                torch.nn.functional.pad(vecs[j], (0, 0, 0,
                                                  npad - vecs[j].shape[0]))
                for j in idx]))

        parts, groups = [], []
        for i in range(0, len(f_idx), self.msm_batch):
            grp = f_idx[i:i + self.msm_batch]
            parts.append(ctx.partials(plain(grp)))
            groups.append([("main", j) for j in grp])
        if n_idx:
            c0 = (blind_start // 256) * 256
            tctx = self._tail_ctx(c0)
            for i in range(0, len(n_idx), self.msm_batch):
                grp = n_idx[i:i + self.msm_batch]
                limbs = plain(grp)
                main = limbs.clone()
                main[:, c0:] = 0
                mp = ctx.partials(main, planes=P)
                parts.append(torch.nn.functional.pad(
                    mp, (0, 0, 0, 0, 0, NUM_WINDOWS - P)))
                groups.append([("main", j) for j in grp])
                parts.append(tctx.partials(limbs[:, c0:].contiguous()))
                groups.append([("tail", j) for j in grp])
        if not parts:
            return []
        host_pts = ctx.finalize(parts)
        out = [None] * len(vecs)
        tails = {}
        pi = 0
        for grp in groups:
            for kind, j in grp:
                (out if kind == "main" else tails)[j] = host_pts[pi]
                pi += 1
        for j, tp in tails.items():
            out[j] = G1.add(out[j], tp)
        return out
