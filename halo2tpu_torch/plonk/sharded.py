"""Mesh-sharded prover engine: the whole create_proof pipeline over a mesh
of torch devices.  Port of halo2tpu/plonk/sharded.py.

halo2tpu's ShardedJaxEngine keeps JaxEngine's methods and lets GSPMD
partition them over row-sharded operands; PyTorch has no GSPMD, so
ShardedTorchEngine does explicitly what GSPMD did.  A vector is a
row-sharded value (parallel/mesh.py::Sharded): D contiguous blocks of its
n rows, block d on mesh.flat[d].

  * Elementwise work (add, sub, scale, the permutation and lookup
    numerators and denominators, weighted sums, the quotient's field
    programs) runs block by block on each block's device, through the same
    kernels as TorchEngine (a TorchEngine per device runs them).
  * A field program's rotated loads read rows of other blocks: before it
    runs, each (leaf, rotation) it loads gets a rotated copy (a cross-block
    `rotate`), and the program reads those at rotation 0
    (ops/field_prog.py::unrotated); the kernel and the arithmetic stay
    the same.  The lookups' theta-compressions (TorchEngine.compress_exprs)
    run as such programs too.
  * Scans cross blocks with a carry: the grand products' prefix products
    (each block's product scans, then a short exclusive product scan of
    the D block totals on the first device and one product a block),
    div_linear and eval_polys (each block's linear scan, then the blocks'
    totals combined with powers a^(block rows)).
  * NTTs run as the Bailey four-step (`_FlatFourStep`): device-local column
    NTTs, the twiddles, all-to-alls over the mesh, device-local row NTTs,
    flat natural order in and out.
  * Commitments take halo2tpu's sharded path: the uniform bit-serial MSM
    with its fold lanes split over the mesh (parallel/msm.py), in groups of
    msm_batch, fold width min(n, max(D, 128)).
  * The lookups' permuted pairs are sorted on one device: each lookup's
    compressed input and table are gathered onto the first device.

Exact canonical integer arithmetic throughout, so a sharded proof is
byte-identical to TorchEngine's (and halo2tpu's HostEngine's) for the same
witness and rng seed.  halo2tpu's HALO2TPU_SHARDED_HOST_COMMIT switch (host
commitments, for XLA:CPU's slow EC graphs) has no counterpart: the plain
CPU fold proves the test circuits in seconds.
"""
from __future__ import annotations

import torch

from ..fields.bn254 import R, inv_mod
from ..fields import jfield
from ..fields.jfield import FR, NLIMB
from ..ops.field_prog import field_prog, unrotated
from ..ops.msm import _partials_to_affine
from ..parallel.mesh import Mesh, Placement, Sharded, on_device
from ..parallel.msm import fold_lanes, lane_split
from ..parallel.ntt import ntt_plans, sharded_ntt_blocks, twiddle_matrix
from . import polyops
from .domain import Domain
from .engine import TorchEngine, _powers, _sum_program


def _pick_split(n: int, ndev: int) -> tuple[int, int]:
    """n = n1 * n2, both powers of two divisible by ndev, n1 ~ sqrt(n).
    n1 carries the output (k1) shard, n2 the input (j2) shard."""
    logn = n.bit_length() - 1
    logd = ndev.bit_length() - 1
    assert 1 << logd == ndev, "mesh size must be a power of two"
    assert logn >= 2 * logd, f"n=2^{logn} too small for {ndev}-device four-step"
    l1 = min(max(logn // 2, logd), logn - logd)
    return 1 << l1, 1 << (logn - l1)


class _FlatFourStep:
    """Four-step NTT over flat natural-order row-sharded vectors: called on
    D row blocks (n/D, ..., 8), one a device of the 1-D mesh (a list or a
    Sharded), it returns the transform's row blocks the same way; the
    dimensions between the first and the limbs are columns transformed
    together.  `scale` multiplies the result by a constant (1/n for the
    inverse), fused into the row NTTs.

    Any NTT gives the DFT's canonical values, so the output is bit-exact
    against the single-device `ntt`.

    Layout walk (D = mesh size, input/output flat natural row-sharded):
      x (n/D) block = j1-slice of the (n1, n2) matrix
      -> all_to_all: (n1, n2/D)    column NTT over j1 (local)
      -> twiddle w^(k1*j2)         (local block of the twiddle matrix)
      -> all_to_all: (n1/D, n2)    row NTT over j2 (local)
      -> all_to_all: (n2/D, n1)    flat natural k = k2*n1 + k1 block
    """

    def __init__(self, mesh: Mesh, axis: str, n: int, omega: int,
                 scale: int | None = None):
        if mesh.devices.ndim != 1:
            raise ValueError("the four-step runs over a 1-D mesh")
        self.mesh, self.n = mesh, n
        ndev = mesh.size
        self.n1, self.n2 = n1, n2 = _pick_split(n, ndev)
        self._plans = ntt_plans(mesh, n1, n2, omega)
        self._tw = Placement(mesh, (None, axis, None)).put(
            twiddle_matrix(n1, n2, omega)).blocks
        self._post = (None if scale is None else mesh.replicate(
            torch.from_numpy(jfield.ints_to_limbs(
                [scale * FR.r % R])[0])))

    def __call__(self, x):
        blocks = x.blocks if isinstance(x, Sharded) else x
        mesh, n, n1, n2 = self.mesh, self.n, self.n1, self.n2
        D = mesh.size
        cols = blocks[0].shape[1:-1]
        xs = mesh.all_to_all([b.reshape((n1 // D, n2) + cols + (NLIMB,))
                              for b in blocks], 1, 0)     # (n1, n2/D)
        ys = sharded_ntt_blocks(mesh, self._plans, self._tw, xs, self._post)
        out = [b.reshape((n // D,) + cols + (NLIMB,))
               for b in mesh.all_to_all(ys, 0, 1)]        # (n2/D, n1)
        if isinstance(x, Sharded):
            return Sharded(x.placement, out, x.shape)
        return out


class ShardedTorchEngine(TorchEngine):
    """TorchEngine with every vector row-sharded over a 1-D mesh.  The
    mesh's size must be a power of two D with n >= D^2."""

    name = "sharded"

    def __init__(self, domain: Domain, srs, mesh: Mesh, axis: str = "shard",
                 msm_batch: int = 8):
        if mesh.devices.ndim != 1:
            raise ValueError("ShardedTorchEngine takes a 1-D mesh")
        with on_device(mesh.first):
            super().__init__(domain, srs, mesh.first)
        self.mesh = mesh
        self.axis = axis
        self.msm_batch = msm_batch
        self._ndev = ndev = mesh.size
        self._devs = mesh.flat
        self.state_key = (self.name, tuple(self._devs))
        d = domain
        self._m = d.n // ndev
        self._rows = Placement(mesh, (axis, None))
        self._fwd_n = _FlatFourStep(mesh, axis, d.n, d.omega)
        self._inv_n = _FlatFourStep(mesh, axis, d.n, inv_mod(d.omega, R),
                                    scale=inv_mod(d.n, R))
        _pick_split(d.extended_n, ndev)
        self._local = {}
        for dev in dict.fromkeys(self._devs):
            with on_device(dev):
                self._local[dev] = TorchEngine(domain, srs, dev)
        self._rep_cache: dict = {}
        self._pows_cache: dict = {}
        self._unrotated: dict = {}
        self._lane_points: dict = {}

    def synchronize(self) -> None:
        for dev in dict.fromkeys(self._devs):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    # -- blocks --------------------------------------------------------------
    def _vec(self, blocks) -> Sharded:
        return Sharded(self._rows, blocks, (self.d.n, NLIMB))

    def _split(self, t) -> Sharded:
        """An (n, 8) tensor as a row-sharded vector."""
        return self._vec(self.mesh.split(t))

    def _gather(self, vec):
        return self.mesh.gather(vec.blocks)

    def _blocks(self, fn, *vecs) -> list:
        """fn(d, block d of each vec) on each block's device."""
        out = []
        for d, dev in enumerate(self._devs):
            with on_device(dev):
                out.append(fn(d, *[v.blocks[d] for v in vecs]))
        return out

    def _map(self, fn, *vecs) -> Sharded:
        return self._vec(self._blocks(fn, *vecs))

    def _stacks(self, vecs) -> list:
        """Per block, the vectors' blocks stacked: (len(vecs), m, 8)."""
        return self._blocks(lambda d, *bs: torch.stack(bs), *vecs)

    def _unstack(self, stacks) -> list:
        return [self._vec([s[j] for s in stacks])
                for j in range(stacks[0].shape[0])]

    def _rep_scalar(self, c) -> list:
        c %= R
        v = self._rep_cache.get(c)
        if v is None:
            if len(self._rep_cache) > 256:
                self._rep_cache.clear()
            v = self._rep_cache[c] = self.mesh.replicate(
                self._enc_scalar(c))
        return v

    def _patch_rows(self, stacks, start: int, patch) -> None:
        """Rows [start, start + L) of every stacked vector (stacks: per
        block (V, m, 8), written in place) set to patch (V, L, 8)."""
        m, L = self._m, patch.shape[1]
        for d, dev in enumerate(self._devs):
            lo, hi = max(start, d * m), min(start + L, (d + 1) * m)
            if lo < hi:
                stacks[d][:, lo - d * m:hi - d * m] = patch[
                    :, lo - start:hi - start].to(dev)

    # -- representation ------------------------------------------------------
    def _encode(self, vals):
        with on_device(self.device):
            return super()._encode(vals)

    def from_ints(self, vals):
        assert len(vals) == self.d.n, "sharded vectors hold n rows"
        return self._split(self._encode(vals))

    def from_ints_stack(self, cols, reduced=False, bits=None,
                        blind_start=None):
        with on_device(self.device):
            full = super().from_ints_stack(cols, reduced, bits, blind_start)
        return [self._split(v) for v in full]

    def from_packed_stack(self, arrs):
        with on_device(self.device):
            full = super().from_packed_stack(arrs)
        return [self._split(v) for v in full]

    def to_ints(self, vec):
        with on_device(self.device):
            return FR.decode(self._gather(vec))

    def const_vec(self, c, n):
        assert n == self.d.n, "sharded vectors hold n rows"
        return self._vec([e.expand(self._m, NLIMB)
                          for e in self._rep_scalar(c)])

    def nbytes(self, vec) -> int:
        return vec.nbytes()

    def compact(self, vecs) -> list:
        return self._unstack(self._stacks(vecs))

    def sigma_from_mapping(self, mapping):
        with on_device(self.device):
            full = super().sigma_from_mapping(mapping)
        return [self._split(v) for v in full]

    # -- elementwise ---------------------------------------------------------
    def add(self, a, b):
        return self._map(lambda d, x, y: jfield.add(FR, x, y), a, b)

    def sub(self, a, b):
        return self._map(lambda d, x, y: jfield.sub(FR, x, y), a, b)

    def mul(self, a, b):
        return self._map(lambda d, x, y: jfield.mont_mul(FR, x, y), a, b)

    def neg(self, a):
        return self._map(lambda d, x: jfield.neg(FR, x), a)

    def scale(self, a, c):
        e = self._rep_scalar(c)
        return self._map(lambda d, x: jfield.mont_mul(FR, x, e[d]), a)

    def add_const(self, a, c):
        e = self._rep_scalar(c)
        return self._map(lambda d, x: jfield.add(FR, x, e[d]), a)

    def rotate(self, a, k):
        """out[i] = a[(i + k) mod n]: block d takes its rows from the
        blocks k // m and k // m + 1 after it."""
        n, m, D = self.d.n, self._m, self._ndev
        k %= n
        if k == 0:
            return a
        q, r = divmod(k, m)
        out = []
        for d, dev in enumerate(self._devs):
            head = a.blocks[(d + q) % D][r:].to(dev)
            out.append(torch.cat([head, a.blocks[(d + q + 1) % D][:r].to(
                dev)]) if r else head)
        return self._vec(out)

    # -- scalar access -------------------------------------------------------
    def read_rows(self, vecs, row):
        d, off = divmod(row, self._m)
        with on_device(self._devs[d]):
            return FR.decode(torch.stack([v.blocks[d][off] for v in vecs]))

    def set_rows(self, vec, start, ints):
        if not ints:
            return vec
        patch = self._encode(ints)[None]
        m = self._m
        blocks = list(vec.blocks)
        for d in range(start // m, (start + len(ints) - 1) // m + 1):
            blocks[d] = blocks[d].clone()
        stacks = [b[None] for b in blocks]
        self._patch_rows(stacks, start, patch)
        return self._vec(blocks)

    def set_rows_batch(self, vecs, start, ints_lists):
        if not vecs:
            return []
        patches = self._encode([v % R for ints in ints_lists for v in ints]
                               ).reshape(len(vecs), -1, NLIMB)
        stacks = self._stacks(vecs)
        self._patch_rows(stacks, start, patches)
        return self._unstack(stacks)

    def assemble_z_batch(self, prefs, heads, blind_start, blind_lists):
        """z[j] = [head_j, head_j * pref_j[:-1]] (each block's first row is
        the previous block's last product), rows >= blind_start replaced
        by the blinding values."""
        if not prefs:
            return []
        heads_e = self._encode([h % R for h in heads])
        blinds = self._encode([v % R for b in blind_lists for v in b]
                              ).reshape(len(prefs), -1, NLIMB)
        hs = self.mesh.replicate(heads_e)
        scaled = self._blocks(lambda d, *ps: jfield.mont_mul(
            FR, torch.stack(ps), hs[d][:, None]), *prefs)
        z = []
        for d, dev in enumerate(self._devs):
            prev = (hs[0][:, None] if d == 0
                    else scaled[d - 1][:, -1:]).to(dev)
            z.append(torch.cat([prev, scaled[d][:, :-1]], 1))
        self._patch_rows(z, blind_start, blinds)
        return self._unstack(z)

    # -- transforms ----------------------------------------------------------
    def _transform(self, vecs, step, pows=None):
        """step (a _FlatFourStep) over the vectors in stacks of stack_chunk
        columns, each first multiplied row by row by pows (a vector)."""
        out = []
        for i in range(0, len(vecs), self.stack_chunk):
            chunk = vecs[i:i + self.stack_chunk]

            def stack(d, *bs):
                s = torch.stack(bs, 1)                     # (m, C, 8)
                if pows is not None:
                    s = jfield.mont_mul(FR, s, pows.blocks[d][:, None])
                return s

            res = step(self._blocks(stack, *chunk))
            out.extend(self._vec([r[:, j] for r in res])
                       for j in range(len(chunk)))
        return out

    def lagrange_to_coeff(self, vec):
        return self._transform([vec], self._inv_n)[0]

    def lagrange_to_coeff_stack(self, vecs):
        return self._transform(vecs, self._inv_n)

    def coeff_to_lagrange_stack(self, vecs):
        return self._transform(vecs, self._fwd_n)

    def _part_pows(self, c: int):
        """Row-sharded powers c^i, cached per c."""
        key = c % R
        v = self._pows_cache.get(key)
        if v is None:
            if len(self._pows_cache) > 96:
                self._pows_cache.clear()
            with on_device(self.device):
                full = _powers(self._enc_scalar(c), self.d.n)
            v = self._pows_cache[key] = self._split(full)
        return v

    def coeff_to_part_stack(self, vecs, q):
        """Part q's values: the coset powers multiplied in block by block,
        then the four-step."""
        return self._transform(vecs, self._fwd_n, pows=self._part_pows(
            polyops.part_shift(self.d, q)))

    def parts_to_h_chunks(self, parts, qpd):
        d = self.d
        n, step = d.n, d.extended_n // d.n
        alpha_inv = inv_mod(pow(d.extended_omega, n, R), R)
        g_n_inv = inv_mod(pow(d.coset_shift, n, R), R)
        step_inv = inv_mod(step, R)
        us = [self.mul(u, self._part_pows(inv_mod(polyops.part_shift(d, q),
                                                  R)))
              for q, u in enumerate(self._transform(parts, self._inv_n))]
        chunks = []
        for s in range(qpd):
            coefs = [pow(alpha_inv, q * s, R) * pow(g_n_inv, s, R)
                     * step_inv % R for q in range(step)]
            chunks.append(self._wsum(us, self._encode(coefs)))
        return chunks

    # -- lookups -------------------------------------------------------------
    def permute_lookup_batch(self, comp_ins, comp_tbs, usable, max_bits):
        """Every lookup's permuted pair, each sorted on the mesh's first
        device (its compressed input and table gathered there, the pair
        split again): the sort runs on one device."""
        a_vecs, s_vecs, fails = [], [], []
        with on_device(self.device):
            for ci, ct in zip(comp_ins, comp_tbs):
                a, s, fail = self.permute_lookup(self._gather(ci),
                                                 self._gather(ct), usable)
                a_vecs.append(self._split(a))
                s_vecs.append(self._split(s))
                fails.append(fail)
        return a_vecs, s_vecs, fails

    # -- evaluation ----------------------------------------------------------
    def run_program(self, prog, leaves, consts):
        """prog block by block: its rotated loads read rotated copies of
        their leaves (ops/field_prog.py::unrotated)."""
        got = self._unrotated.get(id(prog))
        if got is None or got[0] is not prog:
            got = self._unrotated[id(prog)] = (prog, *unrotated(prog))
        _, flat, extra = got
        leaves = list(leaves) + [self.rotate(leaves[leaf], rot)
                                 for leaf, rot in extra]
        cs = self.mesh.replicate(consts)
        return self._map(lambda d, *ls: field_prog(FR, flat, list(ls), cs[d],
                                                   self._m), *leaves)

    def _wsum(self, vecs, coefs):
        prog = _sum_program(len(vecs), self._m)
        cs = self.mesh.replicate(coefs)
        return self._map(lambda d, *ls: field_prog(FR, prog, list(ls), cs[d],
                                                   self._m), *vecs)

    def eval_polys(self, pairs):
        """For each distinct x: each block's reverse linear scan totals
        (the block's Horner value at x), then the D totals' own reverse
        scan with multiplier x^(block rows) on the first device."""
        groups: dict[int, list[int]] = {}
        for i, (_, x) in enumerate(pairs):
            groups.setdefault(x % R, []).append(i)
        per = max(1, (1 << 22) // self.d.n)
        results = []
        for x, idxs in groups.items():
            xm = pow(x, self._m, R)
            for j in range(0, len(idxs), per):
                sub = idxs[j:j + per]
                tots = self._blocks(lambda d, *ps: jfield.linscan(
                    FR, torch.stack(ps), x, reverse=True, totals=True).to(
                    self.device), *[pairs[i][0] for i in sub])
                with on_device(self.device):
                    results.append((jfield.linscan(
                        FR, torch.stack(tots, 1), xm, reverse=True,
                        totals=True), sub))
        with on_device(self.device):
            vals = FR.decode(torch.cat([r[0] for r in results]))
        out = [None] * len(pairs)
        vi = 0
        for _, idxs in results:
            for i in idxs:
                out[i] = vals[vi]
                vi += 1
        return out

    def div_linear(self, vec, a):
        """vec(X) / (X - a): each block's exclusive reverse linear scan,
        carrying C_d = sum over the later rows j >= the block's end e of
        vec_j a^(j - e) (the D block totals' exclusive reverse scan with
        multiplier a^(block rows)): a C_d added to the block's last row
        before the scan, and C_d its last output."""
        a %= R
        last = self._ndev - 1
        tots = self._blocks(lambda d, b: jfield.linscan(
            FR, b, a, reverse=True, totals=True).to(self.device), vec)
        with on_device(self.device):
            carry = jfield.linscan(FR, torch.stack(tots), pow(a, self._m, R),
                                   reverse=True, exclusive=True)
            a_carry = jfield.mont_mul(FR, carry, self._enc_scalar(a))
        carry = self.mesh.replicate(carry)
        a_carry = self.mesh.replicate(a_carry)

        def block(d, b):
            if d == last:
                return jfield.linscan(FR, b, a, reverse=True, exclusive=True)
            end = jfield.add(FR, b[-1:], a_carry[d][d:d + 1])
            out = jfield.linscan(FR, torch.cat([b[:-1], end]), a,
                                 reverse=True, exclusive=True)
            out[-1] = carry[d][d]
            return out

        return self._map(block, vec)

    # -- grand products ------------------------------------------------------
    def grand_products(self, nums, dens):
        """TorchEngine.grand_products with the scans cut at the blocks: each
        block's exclusive forward and reverse product scans of the stacked
        denominators; on the first device the D block totals' exclusive
        forward and reverse scans (each block's carries), the columns'
        totals and one Fermat inversion of them; per block den_inv =
        prefix * suffix * (carry in * carry out / total), the inclusive
        scan of num * den_inv, and its carry from the block totals.
        Products and inverses are canonical, so the bits are
        TorchEngine's."""
        if not nums:
            return []
        first = self.device

        def scans(d, *ds):
            den = torch.stack(ds)                          # (C, m, 8)
            pre = jfield.prodscan(FR, den, exclusive=True)
            suf = jfield.prodscan(FR, den, reverse=True, exclusive=True)
            tot = jfield.mont_mul(FR, pre[:, -1], den[:, -1])
            return pre, suf, tot.to(first)

        per = self._blocks(scans, *dens)
        with on_device(first):
            tots = torch.stack([p[2] for p in per], 1)     # (C, D, 8)
            cin = jfield.prodscan(FR, tots, exclusive=True)
            cout = jfield.prodscan(FR, tots, reverse=True, exclusive=True)
            total_inv = jfield.inv(FR, jfield.mont_mul(FR, cin[:, -1],
                                                       tots[:, -1]))
            f = jfield.mont_mul(FR, jfield.mont_mul(FR, cin, cout),
                                total_inv[:, None])
        fs = self.mesh.replicate(f)

        def ratios(d, *ns):
            pre, suf, _ = per[d]
            den_inv = jfield.mont_mul(FR, jfield.mont_mul(FR, pre, suf),
                                      fs[d][:, d, None])
            r = jfield.prodscan(FR, jfield.mont_mul(FR, torch.stack(ns),
                                                    den_inv))
            return r, r[:, -1].to(first)

        rs = self._blocks(ratios, *nums)
        del per
        with on_device(first):
            carry = jfield.prodscan(FR, torch.stack([r[1] for r in rs], 1),
                                    exclusive=True)        # (C, D, 8)
        cs = self.mesh.replicate(carry)
        out = []
        for d, dev in enumerate(self._devs):
            with on_device(dev):
                out.append(rs[d][0] if d == 0 else jfield.mont_mul(
                    FR, rs[d][0], cs[d][:, d, None]))
        return self._unstack(out)

    def perm_numden_chunks(self, chunk_cols, chunk_sigmas, omega_pows,
                           beta, gamma, chunk_deltas):
        if not chunk_cols:
            return [], []
        per = []
        for d, dev in enumerate(self._devs):
            with on_device(dev):
                per.append(self._local[dev].perm_numden_chunks(
                    [[v.blocks[d] for v in c] for c in chunk_cols],
                    [[v.blocks[d] for v in s] for s in chunk_sigmas],
                    omega_pows.blocks[d], beta, gamma, chunk_deltas))
        return ([self._vec(bs) for bs in zip(*[p[0] for p in per])],
                [self._vec(bs) for bs in zip(*[p[1] for p in per])])

    def lookup_numden(self, comp_ins, comp_tbs, a_vecs, s_vecs, beta, gamma):
        if not comp_ins:
            return [], []
        k = len(comp_ins)
        per = self._blocks(
            lambda d, *bs: self._local[self._devs[d]].lookup_numden(
                bs[:k], bs[k:2 * k], bs[2 * k:3 * k], bs[3 * k:], beta,
                gamma), *comp_ins, *comp_tbs, *a_vecs, *s_vecs)
        return ([self._vec(bs) for bs in zip(*[p[0] for p in per])],
                [self._vec(bs) for bs in zip(*[p[1] for p in per])])

    # -- commitments ---------------------------------------------------------
    def commit_lagrange_batch(self, vecs, value_bits=None, blind_start=None):
        """The uniform bit-serial path for every column (value bounds and
        narrow planes are a single-device optimisation)."""
        return self._commit(self._msm_lagrange, vecs)

    def commit_batch(self, vecs):
        return self._commit(self._msm_lagrange,
                            self.coeff_to_lagrange_stack(vecs))

    def _commit(self, ctx, vecs, value_bits=None, blind_start=None):
        """halo2tpu's sharded commit: groups of msm_batch columns (the last
        padded with zero columns), each one lane-sharded bit-serial fold
        (parallel/msm.py) at fold width min(npad, max(D, 128)); one Horner
        combine for all groups on the first device."""
        if not vecs:
            return []
        npad = ctx.points.shape[0]
        C = min(npad, max(self._ndev, 128))
        key = (id(ctx), C)
        pts = self._lane_points.get(key)
        if pts is None or pts[0] is not ctx:
            pts = self._lane_points[key] = (
                ctx, lane_split(self.mesh, [ctx.points], C, 0))
        parts = []
        for i in range(0, len(vecs), self.msm_batch):
            chunk = vecs[i:i + self.msm_batch]

            def plain(d, *bs):
                s = torch.zeros((self.msm_batch, self._m, NLIMB),
                                dtype=torch.int32, device=bs[0].device)
                s[:len(bs)] = torch.stack(bs)
                return FR.from_mont(s)

            sc = lane_split(self.mesh, self._blocks(plain, *chunk), C, 1)
            parts.append(fold_lanes(self.mesh, pts[1], sc, C // self._ndev))
        with on_device(self.device):
            return _partials_to_affine(torch.cat(parts))[:len(vecs)]
