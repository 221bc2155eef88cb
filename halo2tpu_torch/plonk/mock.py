"""MockProver: the constraint-satisfiability checker (no crypto), on the
device.  Counterpart of halo2tpu/plonk/mock.py (halo2's dev::MockProver):
every gate polynomial on every usable row, the copy constraints and the
lookups' membership, with halo2tpu's failure list as its C++ gate
evaluator gives it (the same kinds, details, order and caps).

The columns go to the device once a verify(), as one stacked (C, n, 8)
Montgomery tensor: each column's values mod R as the engine's host limbs
(jfield.ints_to_limbs), then FR.to_mont, one mont_mul launch.  Each gate
polynomial is one field program (plonk/quotient.py::compile_program of
its expr_ir, cached by expression), run over all n rows by
ops/field_prog.py::field_prog, so a rotation wraps mod n as the native
evaluator's does; its failing rows are its nonzero rows below `usable`.  The check is exact:
each polynomial on its own, never a random combination of them, and a
lookup's membership is exact (torch.unique over the table's and the
inputs' limb rows), never a theta-compression.  Each part reads the device
once, and once more to decode the values of its failures.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..fields.bn254 import R
from ..fields.jfield import FR, NLIMB, device_of, ints_to_limbs
from ..ops.field_prog import field_prog
from .circuit import Assignment, Circuit, Column, ConstraintSystem
from .quotient import compile_program, const_value, expr_ir

# halo2tpu's caps: the failing rows kept for one gate polynomial (its
# native evaluator's max_fail), and the count of failures past which
# verify() returns
MAX_FAIL_ROWS = 8
MAX_FAILURES = 16

# compiled programs by (value tree, rows): gates repeat across runs
_PROGRAMS: dict = {}
_PROGRAMS_MAX = 4096


@dataclass
class MockFailure:
    kind: str
    detail: str


def _program(ir, n: int):
    """The field program of one value tree over n rows, cached."""
    key = (ir, n)
    prog = _PROGRAMS.get(key)
    if prog is None:
        if len(_PROGRAMS) >= _PROGRAMS_MAX:
            _PROGRAMS.clear()
        prog = _PROGRAMS[key] = compile_program([ir], n, name="mock")
    return prog


class GateEvaluator:
    """The advice, fixed and instance columns on the device, and
    expressions over them: the counterpart of halo2tpu's
    native.NativeGateEvaluator.  `programs` holds every field program it
    ran (chip_smoke.py holds each to the interpreter)."""

    def __init__(self, fixed_cols, advice_cols, instance_cols, nrows: int,
                 usable: int, device="cuda"):
        self.device = device_of(device)
        self.n = nrows
        self.usable = usable
        self.base = {"advice": 0, "fixed": len(advice_cols),
                     "instance": len(advice_cols) + len(fixed_cols)}
        cols = [*advice_cols, *fixed_cols, *instance_cols]
        limbs = np.zeros((len(cols), nrows, NLIMB), np.int32)
        for i, col in enumerate(cols):
            limbs[i] = ints_to_limbs([v % R for v in col])
        self.stack = FR.to_mont(torch.from_numpy(limbs).to(self.device))
        self.programs: list = []

    def synchronize(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def column(self, kind: str, index: int):
        return self.stack[self.base[kind] + index]

    def values(self, exprs) -> list:
        """Each expression's (n, 8) Montgomery values on all n rows: a lone
        column query at rotation 0 is its column, any other expression one
        field_prog launch (the constants of all of them encoded in one
        launch)."""
        irs = [expr_ir(e) for e in exprs]
        runs = [None if ir[0] == "load" and not ir[2] else _program(ir, self.n)
                for ir in irs]
        progs = [p for p in runs if p is not None]
        consts = [const_value(k, {}, 0) for p in progs for k in p.const_keys]
        table = FR.encode(consts, self.device) if consts else None
        out, at = [], 0
        for ir, prog in zip(irs, runs):
            if prog is None:
                out.append(self.column(*ir[1]))
                continue
            m = len(prog.const_keys)
            cst = (table[at:at + m] if m else
                   torch.zeros((0, NLIMB), dtype=torch.int32,
                               device=self.device))
            at += m
            self.programs.append(prog)
            out.append(field_prog(FR, prog, [self.column(*k)
                                             for k in prog.leaf_keys],
                                  cst, self.n))
        return out

    def fail_rows(self, polys, max_fail: int = MAX_FAIL_ROWS) -> list:
        """For each polynomial, its first max_fail rows below usable where
        it is nonzero, ascending; one read of the device for all."""
        if not polys:
            return []
        u = self.usable
        bad = torch.stack([(v[:u] != 0).any(-1) for v in self.values(polys)])
        bad &= bad.cumsum(1) <= max_fail
        out: list = [[] for _ in polys]
        for p, row in torch.nonzero(bad).tolist():
            out[p].append(row)
        return out

    def eval_poly(self, expr, max_fail: int = MAX_FAIL_ROWS) -> list:
        """Rows (within usable) where the poly evaluates nonzero."""
        return self.fail_rows([expr], max_fail)[0]

    def copy_failures(self, copies) -> list:
        """(i, va, vb) for each copy i whose two cells differ, values as
        canonical ints: both sides gathered from the stack, compared
        exactly, and only the differing pairs decoded."""
        if not copies:
            return []
        ends = dict(zip(("advice", "fixed", "instance"),
                        (self.base["fixed"], self.base["instance"],
                         self.stack.shape[0])))
        row0 = {Column(kind, i - self.base[kind]): i * self.n
                for kind in self.base
                for i in range(self.base[kind], ends[kind])}
        ia = np.fromiter((row0[c] + r for (c, r), _ in copies), np.int64,
                         len(copies))
        ib = np.fromiter((row0[c] + r for _, (c, r) in copies), np.int64,
                         len(copies))
        cells = torch.from_numpy(np.stack([ia, ib])).to(self.device)
        table = self.stack.reshape(-1, NLIMB)
        va, vb = table[cells[0]], table[cells[1]]
        bad = torch.nonzero((va != vb).any(-1)).flatten()
        idx = bad.tolist()
        if not idx:
            return []
        vals = FR.decode(torch.cat([va[bad], vb[bad]]))
        return list(zip(idx, vals[:len(idx)], vals[len(idx):]))

    def lookup_misses(self, lookups, cap: int) -> list:
        """For each lookup, [(row, input tuple), ...]: its first `cap` rows
        below usable whose input tuple is not a row of its table, exact
        (one torch.unique over the table's and the inputs' limb rows);
        only those rows' tuples are decoded."""
        if not lookups:
            return []
        u = self.usable
        exprs = [e for lk in lookups for pair in lk.pairs for e in pair]
        vals = iter(self.values(exprs))
        inputs, misses = [], []
        for lk in lookups:
            got = [next(vals)[:u] for _ in range(2 * len(lk.pairs))]
            inp, tab = torch.cat(got[0::2], 1), torch.cat(got[1::2], 1)
            ids = torch.unique(torch.cat([tab, inp]), dim=0,
                               return_inverse=True)[1]
            seen = torch.zeros(2 * u, dtype=torch.bool, device=self.device)
            seen[ids[:u]] = True
            inputs.append(inp)
            misses.append(~seen[ids[u:]])
        miss = torch.stack(misses)
        miss &= miss.cumsum(1) <= cap
        hits = torch.nonzero(miss).tolist()
        out: list = [[] for _ in lookups]
        if not hits:
            return out
        rows = torch.cat([inputs[li][r].reshape(-1, NLIMB) for li, r in hits])
        ints = iter(FR.decode(rows))
        for li, r in hits:
            out[li].append((r, tuple(next(ints)
                                     for _ in lookups[li].pairs)))
        return out


class MockProver:
    """halo2tpu's MockProver on `device` ("cuda" by default; without CUDA
    the constructor raises, it never falls back to the CPU).  `times`
    holds the wall seconds of the last run's parts: synthesize (run()),
    encode, gates, copies and lookups (verify())."""

    def __init__(self, cs: ConstraintSystem, asn: Assignment,
                 instances: list[list[int]], n: int, device="cuda"):
        self.device = device_of(device)
        self.cs = cs
        self.asn = asn
        self.n = n
        self.usable = cs.usable_rows(n)
        self.instance_values = []
        for ci in range(cs.num_instance):
            vals = [0] * n
            col = instances[ci] if ci < len(instances) else []
            for i, v in enumerate(col):
                vals[i] = v % R
            self.instance_values.append(vals)
        self.times: dict = {}
        self.programs: list = []

    @classmethod
    def run(cls, k: int, circuit: Circuit, instances: list[list[int]],
            device="cuda"):
        device = device_of(device)
        t0 = time.perf_counter()
        cs = ConstraintSystem()
        config = circuit.configure(cs)
        n = 1 << k
        asn = Assignment(cs, n)
        circuit.synthesize(config, asn)
        synth = time.perf_counter() - t0
        mp = cls(cs, asn, instances, n, device)
        mp.times["synthesize"] = synth
        return mp

    def _part(self, name: str, t0: float) -> float:
        now = time.perf_counter()
        self.times[name] = now - t0
        return now

    def verify(self) -> list[MockFailure]:
        failures: list[MockFailure] = []
        cs = self.cs
        self.times = {k: v for k, v in self.times.items()
                      if k == "synthesize"}
        t0 = time.perf_counter()
        ev = GateEvaluator(self.asn.fixed, self.asn.advice,
                           self.instance_values, self.n, self.usable,
                           self.device)
        self.programs = ev.programs
        ev.synchronize()
        t0 = self._part("encode", t0)

        polys = [(gate.name, gi, poly) for gate in cs.gates
                 for gi, poly in enumerate(gate.polys)]
        rows = ev.fail_rows([p for _, _, p in polys])
        t0 = self._part("gates", t0)
        for (name, gi, _), rs in zip(polys, rows):
            for row in rs:
                failures.append(MockFailure(
                    "gate", f"gate '{name}' poly {gi} row {row}"))
            if len(failures) > MAX_FAILURES:
                return failures

        copies = self.asn.copies
        for i, va, vb in ev.copy_failures(copies):
            (ca, ra), (cb, rb) = copies[i]
            failures.append(MockFailure(
                "copy", f"{ca}[{ra}]={va} != {cb}[{rb}]={vb}"))
        t0 = self._part("copies", t0)

        # verify() returns at the first lookup failure past MAX_FAILURES,
        # so no lookup can contribute more than this
        cap = max(1, MAX_FAILURES + 1 - len(failures))
        misses = ev.lookup_misses(cs.lookups, cap)
        self._part("lookups", t0)
        for lk, rows in zip(cs.lookups, misses):
            for row, tup in rows:
                failures.append(MockFailure(
                    "lookup",
                    f"lookup '{lk.name}' row {row}: {tup} not in table"))
                if len(failures) > MAX_FAILURES:
                    return failures
        return failures

    def assert_satisfied(self) -> None:
        failures = self.verify()
        if failures:
            msgs = "\n".join(f"  [{f.kind}] {f.detail}" for f in failures)
            raise AssertionError(f"circuit not satisfied:\n{msgs}")
