"""In-circuit Poseidon gadget (SURVEY N13) — realizes the reference's
dead-code intent (anon-aadhaar-halo2/src/nullifier.rs: Poseidon-in-circuit with
a placeholder gate that was never finished) with real constraints.

TPU-first design: one permutation = 66 contiguous rows over T=5 dedicated
state columns; each round is ONE row-transition gate (degree-6 with the
selector), with the round constants in fixed columns:

    q_full:    s'_j = sum_i M[j][i] * (s_i + rc_i)^5
    q_partial: s'_j = M[j][0]*(s_0+rc_0)^5 + sum_{i>0} M[j][i]*(s_i+rc_i)

Same parameters as the native sponge (`halo2tpu.ops.poseidon`): T=5 RATE=4
R_F=8 R_P=57, grain-LFSR constants, PSE sponge semantics (2^64 capacity tag,
pad-with-1, squeeze state[1]) — so in-circuit digests equal the native
nullifier values (reference lib.rs:890-912).
"""
from __future__ import annotations

from ..fields.bn254 import R
from ..ops.poseidon import generate_parameters
from ..plonk.circuit import Assignment, ConstraintSystem
from .flexgate import AssignedValue, GateChip

T = 5
RATE = 4
R_F = 8
R_P = 57
NUM_ROUNDS = R_F + R_P
CAPACITY_TAG = 1 << 64


class PoseidonConfig:
    def __init__(self, cs: ConstraintSystem):
        self.state_cols = [cs.advice_column() for _ in range(T)]
        for c in self.state_cols:
            cs.enable_equality(c)
        self.rc_cols = [cs.fixed_column() for _ in range(T)]
        self.q_full = cs.fixed_column()
        self.q_partial = cs.fixed_column()

        rcs, mds = generate_parameters(T, R_F, R_P)
        self.rcs, self.mds = rcs, mds

        s = [cs.query_advice(c, 0) for c in self.state_cols]
        s_next = [cs.query_advice(c, 1) for c in self.state_cols]
        rc = [cs.query_fixed(c, 0) for c in self.rc_cols]
        qf = cs.query_fixed(self.q_full, 0)
        qp = cs.query_fixed(self.q_partial, 0)

        def pow5(e):
            e2 = e * e
            return e2 * e2 * e

        x = [s[i] + rc[i] for i in range(T)]
        full_polys = []
        part_polys = []
        for j in range(T):
            acc_f = None
            acc_p = None
            for i in range(T):
                m = mds[j][i] % R
                term_f = pow5(x[i]) * m
                term_p = (pow5(x[i]) if i == 0 else x[i]) * m
                acc_f = term_f if acc_f is None else acc_f + term_f
                acc_p = term_p if acc_p is None else acc_p + term_p
            full_polys.append(qf * (acc_f - s_next[j]))
            part_polys.append(qp * (acc_p - s_next[j]))
        cs.create_gate("poseidon_full", full_polys)
        cs.create_gate("poseidon_partial", part_polys)

    @classmethod
    def configure(cls, cs: ConstraintSystem):
        return cls(cs)


def _sbox(v: int) -> int:
    v2 = v * v % R
    v4 = v2 * v2 % R
    return v4 * v % R


class PoseidonChip:
    """Sponge over assigned cells.  `hash(cells)` returns the digest cell."""

    def __init__(self, cfg: PoseidonConfig, gate: GateChip, asn: Assignment):
        self.cfg = cfg
        self.gate = gate
        self.asn = asn
        self._row = 0
        self.permutations = 0

    def _assign_state_row(self, row: int, values):
        out = []
        for c, v in zip(self.cfg.state_cols, values):
            self.asn.assign_advice(c, row, v)
            out.append(AssignedValue(c, row, v % R))
        return out

    def permute_cells(self, state_cells):
        """state_cells: T cells; emits a 66-row permutation region and
        returns the T output cells (copy-constraining the inputs into
        row 0)."""
        cfg = self.cfg
        start = self._row
        assert start + NUM_ROUNDS + 1 <= self.asn.usable, "poseidon rows exhausted"
        half = R_F // 2
        vals = [c.value % R for c in state_cells]
        row_cells = self._assign_state_row(start, vals)
        for src, dst in zip(state_cells, row_cells):
            self.asn.copy((src.col, src.row), (dst.col, dst.row))
        for rnd in range(NUM_ROUNDS):
            row = start + rnd
            for ci, rc_col in enumerate(cfg.rc_cols):
                self.asn.assign_fixed(rc_col, row, cfg.rcs[rnd][ci])
            partial = half <= rnd < half + R_P
            self.asn.assign_fixed(
                cfg.q_partial if partial else cfg.q_full, row, 1)
            x = [(vals[i] + cfg.rcs[rnd][i]) % R for i in range(T)]
            if partial:
                x = [_sbox(x[0])] + x[1:]
            else:
                x = [_sbox(v) for v in x]
            vals = [sum(cfg.mds[j][i] * x[i] for i in range(T)) % R
                    for j in range(T)]
            out_cells = self._assign_state_row(row + 1, vals)
        self._row = start + NUM_ROUNDS + 1
        self.permutations += 1
        return out_cells

    def hash(self, cells) -> AssignedValue:
        """PSE sponge over the input cells (any length >= 1)."""
        g = self.gate
        state = [g.load_constant(CAPACITY_TAG)] + [g.load_zero()
                                                   for _ in range(RATE)]
        vals = list(cells)
        chunks = [vals[i:i + RATE] for i in range(0, len(vals), RATE)]
        if not chunks or len(chunks[-1]) == RATE:
            chunks.append([])
        chunks[-1] = chunks[-1] + [g.load_constant(1)]
        for ch in chunks:
            absorbed = [state[0]]
            for i in range(RATE):
                if i < len(ch):
                    absorbed.append(g.add(state[1 + i], ch[i]))
                else:
                    absorbed.append(state[1 + i])
            state = self.permute_cells(absorbed)
        return state[1]

    def occupancy(self) -> dict:
        return {"poseidon_rows": self._row,
                "poseidon_permutations": self.permutations}
