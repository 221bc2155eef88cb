"""Field programs: the CUDA kernel (csrc/field_prog.cu) that runs a flat
program of field operations for every row in one launch, and its plain
torch interpreter.

A program is G sub-programs, each a list of instructions (op, dst, a, b)
over a few slots, each slot one field element a row:

    LOAD   dst, leaf, rot   slot[dst] = leaves[leaf][(row + rot) mod n]
    CONST  dst, k           slot[dst] = consts[k]
    ADD / SUB / MUL dst, a, b;  NEG / SQR dst, a
    HORNER acc, v, k        slot[acc] = slot[acc] * consts[k] + slot[v]
    OUT    -, a             the sub-program's result res_g = slot[a]

and a combine, out[row] = (sum_g res_g * consts[comb[g]]) * consts[scale],
where a negative index takes no product.  The kernel runs sub-program g on
warp g of a block of 32 rows, so G warps share a row; `groups_for` picks G
from the row count.

plonk/quotient.py compiles a quotient part into one (`part_program`), and
`sum_program` is the engine's weighted sum sum_i c_i v_i.  `field_prog`
launches the kernel for CUDA tensors and takes `field_prog_plain` only for
CPU tensors; the plain version works on any device (chip_smoke.py compares
the two on the card; `field_prog_plain.cuda_calls` counts its runs on CUDA
tensors).  Beside its count of launches, `field_prog` keeps `shapes`, a
histogram of (program name, rows, instructions, groups).  Every field
value is canonical, so the kernel, the interpreter and any other order of
the same field operations give the same bits.
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field

import numpy as np
import torch

from .cuda_field import (NLIMB, add_plain, mont_mul_plain, neg_plain,
                         sub_plain)

LOAD, CONST, ADD, SUB, NEG, MUL, SQR, HORNER, OUT = range(9)
OP_NAMES = ("LOAD", "CONST", "ADD", "SUB", "NEG", "MUL", "SQR", "HORNER",
            "OUT")
# slots a sub-program may use: the kernel keeps them in shared memory, 1 KB
# a slot for a warp of 32 rows (16 KB a warp at S_MAX)
S_MAX = 16
# sub-programs (warps on a row) at most
G_MAX = 8
# G is chosen so that rows * G / 32 warps give about WARPS_PER_SM warps on
# each of the H100's SMS streaming multiprocessors: enough to hide the
# carry chains' latency (G = 4 at 2^15 rows)
SMS = 132
WARPS_PER_SM = 32


def groups_for(n: int) -> int:
    """Sub-programs for a program over n rows: round(SMS * WARPS_PER_SM *
    32 / n), within [1, G_MAX]."""
    return max(1, min(G_MAX, round(SMS * WARPS_PER_SM * 32 / max(n, 1))))


@dataclass
class Program:
    """code: (m, 4) int32 instructions, the sub-programs back to back,
    sub-program g at rows starts[g]:starts[g + 1], each ending in OUT;
    comb[g]: the constant its result is multiplied by (-1: none); scale:
    the constant the sum is multiplied by (-1: none); slots: the most any
    sub-program uses; leaf_keys and const_keys: what leaf i and constant k
    stand for (the compiler's names, resolved by its caller before each
    run); name: the caller's label in field_prog's shapes."""
    code: np.ndarray
    starts: list
    comb: list
    scale: int
    slots: int
    leaf_keys: list
    const_keys: list
    name: str = "program"
    _dev: dict = field(default_factory=dict, repr=False)

    @property
    def groups(self) -> int:
        return len(self.comb)

    def op_counts(self) -> dict:
        ops = Counter(self.code[:, 0].tolist())
        return {OP_NAMES[k]: ops.get(k, 0) for k in range(len(OP_NAMES))}

    def sub_code(self, g: int) -> np.ndarray:
        return self.code[self.starts[g]:self.starts[g + 1]]

    def device_tables(self, device):
        """(code, meta) on device: meta = starts, then comb (int32)."""
        t = self._dev.get(device)
        if t is None:
            meta = np.asarray(list(self.starts) + list(self.comb), np.int32)
            t = self._dev[device] = (torch.from_numpy(self.code).to(device),
                                     torch.from_numpy(meta).to(device))
        return t


def sum_program(m: int, groups: int = 1) -> Program:
    """sum_i c_i v_i over m leaves (leaf i = v_i, constant i = c_i), cut
    into `groups` sub-programs of consecutive terms (at most m), each a
    running sum of products in three slots."""
    groups = max(1, min(groups, m))
    code, starts = [], [0]
    for g in range(groups):
        lo, hi = g * m // groups, (g + 1) * m // groups
        code += [(LOAD, 0, lo, 0), (CONST, 1, lo, 0), (MUL, 0, 0, 1)]
        for i in range(lo + 1, hi):
            code += [(LOAD, 1, i, 0), (CONST, 2, i, 0), (MUL, 1, 1, 2),
                     (ADD, 0, 0, 1)]
        code.append((OUT, 0, 0, 0))
        starts.append(len(code))
    return Program(np.asarray(code, np.int32).reshape(-1, 4), starts,
                   [-1] * groups, -1, 3 if m > 1 else 2, list(range(m)),
                   list(range(m)), name="sum")


def unrotated(prog: Program) -> tuple:
    """prog with its rotations moved into the leaves: each LOAD of leaf l
    at rot != 0 reads a new leaf at rot 0, one new leaf a distinct (l,
    rot), appended after prog's.  Returns (the program, [(l, rot), ...] in
    the new leaves' order); the caller passes leaf l rotated by rot there,
    and each row then reads only its own row of every leaf."""
    code = prog.code.copy()
    extra: dict = {}
    for i in np.nonzero((code[:, 0] == LOAD) & (code[:, 3] != 0))[0]:
        key = (int(code[i, 2]), int(code[i, 3]))
        code[i, 2] = extra.setdefault(key, len(prog.leaf_keys) + len(extra))
        code[i, 3] = 0
    keys = list(prog.leaf_keys) + [("rot", l, r) for l, r in extra]
    return (Program(code, prog.starts, prog.comb, prog.scale, prog.slots,
                    keys, prog.const_keys, name=prog.name), list(extra))


def _run_sub(spec, code, slots: int, leaves, consts, n: int):
    """One sub-program in plain torch; returns its OUT value."""
    regs: list = [None] * slots
    out = None
    for op, d, a, b in code.tolist():
        if op == LOAD:
            x = leaves[a]
            regs[d] = torch.roll(x, -b, 0) if b else x
        elif op == CONST:
            regs[d] = consts[a].expand(n, NLIMB)
        elif op == ADD:
            regs[d] = add_plain(spec, regs[a], regs[b])
        elif op == SUB:
            regs[d] = sub_plain(spec, regs[a], regs[b])
        elif op == NEG:
            regs[d] = neg_plain(spec, regs[a])
        elif op == MUL:
            regs[d] = mont_mul_plain(spec, regs[a], regs[b])
        elif op == SQR:
            regs[d] = mont_mul_plain(spec, regs[a], regs[a])
        elif op == HORNER:
            regs[d] = add_plain(spec, mont_mul_plain(spec, regs[d],
                                                     consts[b]), regs[a])
        else:
            out = regs[a]
    return out


def field_prog_plain(spec, prog: Program, leaves, consts, n: int):
    """Interpret prog over n rows with torch field ops: leaves, (n, 8)
    int32 tensors (any strides); consts, (K, 8).  Each sub-program, then
    the kernel's combine.  Returns (n, 8)."""
    if consts.device.type == "cuda":
        field_prog_plain.cuda_calls += 1
    acc = None
    for g in range(prog.groups):
        r = _run_sub(spec, prog.sub_code(g), prog.slots, leaves, consts, n)
        if prog.comb[g] >= 0:
            r = mont_mul_plain(spec, r, consts[prog.comb[g]])
        acc = r if acc is None else add_plain(spec, acc, r)
    if prog.scale >= 0:
        acc = mont_mul_plain(spec, acc, consts[prog.scale])
    return acc.expand(n, NLIMB).contiguous()


field_prog_plain.cuda_calls = 0


def _check_leaf(x, n: int, dev) -> None:
    if x.device != dev or x.dtype != torch.int32:
        raise ValueError(f"field_prog: leaf on {x.device} ({x.dtype}), "
                         f"output on {dev}")
    if (x.dim() != 2 or x.shape[0] != n or x.shape[1] != NLIMB
            or x.stride(1) != 1 or x.stride(0) % 4 or x.data_ptr() % 16):
        raise ValueError(f"field_prog: leaf of shape {tuple(x.shape)}, "
                         f"strides {x.stride()}: need ({n}, 8) rows of "
                         "contiguous limbs, 16-byte aligned")


def _leaf_rows(leaves, n: int, dev) -> list:
    """(pointer, row stride) of each leaf, checked as _check_leaf checks
    it (which raises, naming the fault): a few attribute reads a leaf, as
    a weighted sum's host time is mostly this loop."""
    want = torch.Size((n, NLIMB))
    rows = []
    for x in leaves:
        st, p = x.stride(), x.data_ptr()
        if (x.shape != want or st[1] != 1 or st[0] % 4 or p % 16
                or x.dtype != torch.int32 or x.get_device() != dev.index):
            _check_leaf(x, n, dev)
        rows.append((p, st[0]))
    return rows


def field_prog(spec, prog: Program, leaves, consts, n: int):
    """Run prog over n rows.  A CUDA consts table launches the kernel once
    (leaves may be strided views: the kernel takes each as a pointer and a
    row stride); a CPU one takes field_prog_plain."""
    if consts.device.type == "cpu":
        return field_prog_plain(spec, prog, leaves, consts, n)
    if consts.device.type != "cuda":
        raise ValueError(f"field_prog: constants on {consts.device}")
    if len(leaves) != len(prog.leaf_keys) or consts.shape != (
            len(prog.const_keys), NLIMB) or consts.dtype != torch.int32:
        raise ValueError("field_prog: leaves or constants do not match the "
                         "program")
    if prog.slots > S_MAX or not 1 <= prog.groups <= G_MAX:
        raise ValueError(f"field_prog: {prog.slots} slots and "
                         f"{prog.groups} sub-programs, at most {S_MAX} and "
                         f"{G_MAX}")
    from .._build import check, lib
    dev = consts.device
    consts = consts.contiguous()
    # the leaf table goes up from pinned memory without a wait: a pageable
    # copy would hold the host until the stream drains, so no launch's
    # host work would overlap the kernel before it
    table = torch.tensor(_leaf_rows(leaves, n, dev) or [[0, 0]],
                         dtype=torch.int64,
                         pin_memory=True).to(dev, non_blocking=True)
    code, meta = prog.device_tables(dev)
    out = torch.empty((n, NLIMB), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    check(lib().h2_field_prog(code.data_ptr(), meta.data_ptr(), prog.groups,
                              prog.scale, table.data_ptr(),
                              consts.data_ptr(), out.data_ptr(), n,
                              prog.slots, spec.mod_words_ptr, stream),
          "field_prog")
    field_prog.launches += 1
    field_prog.shapes[(prog.name, n, code.shape[0], prog.groups)] += 1
    return out


field_prog.launches = 0
field_prog.shapes = Counter()
