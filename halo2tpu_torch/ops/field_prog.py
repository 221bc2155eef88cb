"""Field programs: the CUDA kernel (csrc/field_prog.cu) that runs a flat
program of field operations for every row in one launch, and its plain
torch interpreter.

A program is a list of instructions (op, dst, a, b) over a few slots, each
slot one field element a row:

    LOAD   dst, leaf, rot   slot[dst] = leaves[leaf][(row + rot) mod n]
    CONST  dst, k           slot[dst] = consts[k]
    ADD / SUB / MUL dst, a, b;  NEG / SQR dst, a
    HORNER acc, v, k        slot[acc] = slot[acc] * consts[k] + slot[v]
    OUT    -, a             out[row] = slot[a]

plonk/quotient.py compiles a quotient part into one (`part_program`).
`field_prog` launches the kernel for CUDA tensors and takes
`field_prog_plain` only for CPU tensors; the plain version works on any
device (chip_smoke.py compares the two on the card).  Beside its count of
launches, `field_prog` keeps `shapes`, a histogram of (rows, instructions).
Every field value is canonical, so the kernel, the interpreter and any
other order of the same field operations give the same bits.
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
# slots a program may use: the kernel keeps them in shared memory, 4 KB a
# slot for a block of 128 threads (64 KB at S_MAX)
S_MAX = 16


@dataclass
class Program:
    """code: (m, 4) int32 instructions; slots: how many it uses; leaf_keys
    and const_keys: what leaf i and constant k stand for (the compiler's
    names, resolved by its caller before each run)."""
    code: np.ndarray
    slots: int
    leaf_keys: list
    const_keys: list
    _dev: dict = field(default_factory=dict, repr=False)

    def op_counts(self) -> dict:
        ops = Counter(self.code[:, 0].tolist())
        return {OP_NAMES[k]: ops.get(k, 0) for k in range(len(OP_NAMES))}

    def device_code(self, device) -> torch.Tensor:
        t = self._dev.get(device)
        if t is None:
            t = self._dev[device] = torch.from_numpy(self.code).to(device)
        return t


def field_prog_plain(spec, prog: Program, leaves, consts, n: int):
    """Interpret prog over n rows with torch field ops: leaves, (n, 8)
    int32 tensors (any strides); consts, (K, 8).  Returns (n, 8)."""
    slots: list = [None] * prog.slots
    out = None
    for op, d, a, b in prog.code.tolist():
        if op == LOAD:
            x = leaves[a]
            slots[d] = torch.roll(x, -b, 0) if b else x
        elif op == CONST:
            slots[d] = consts[a].expand(n, NLIMB)
        elif op == ADD:
            slots[d] = add_plain(spec, slots[a], slots[b])
        elif op == SUB:
            slots[d] = sub_plain(spec, slots[a], slots[b])
        elif op == NEG:
            slots[d] = neg_plain(spec, slots[a])
        elif op == MUL:
            slots[d] = mont_mul_plain(spec, slots[a], slots[b])
        elif op == SQR:
            slots[d] = mont_mul_plain(spec, slots[a], slots[a])
        elif op == HORNER:
            slots[d] = add_plain(spec, mont_mul_plain(spec, slots[d],
                                                      consts[b]), slots[a])
        else:
            out = slots[a]
    return out.expand(n, NLIMB).contiguous()


def _check_leaf(x, n: int, dev) -> None:
    if x.device != dev or x.dtype != torch.int32:
        raise ValueError(f"field_prog: leaf on {x.device} ({x.dtype}), "
                         f"output on {dev}")
    if (x.dim() != 2 or x.shape[0] != n or x.shape[1] != NLIMB
            or x.stride(1) != 1 or x.stride(0) % 4 or x.data_ptr() % 16):
        raise ValueError(f"field_prog: leaf of shape {tuple(x.shape)}, "
                         f"strides {x.stride()}: need ({n}, 8) rows of "
                         "contiguous limbs, 16-byte aligned")


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
    if prog.slots > S_MAX:
        raise ValueError(f"field_prog: {prog.slots} slots, at most {S_MAX}")
    from .._build import check, lib
    dev = consts.device
    for x in leaves:
        _check_leaf(x, n, dev)
    consts = consts.contiguous()
    table = torch.tensor([[x.data_ptr(), x.stride(0)] for x in leaves]
                         or [[0, 0]], dtype=torch.int64).to(dev)
    code = prog.device_code(dev)
    out = torch.empty((n, NLIMB), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    check(lib().h2_field_prog(code.data_ptr(), code.shape[0],
                              table.data_ptr(), consts.data_ptr(),
                              out.data_ptr(), n, prog.slots,
                              spec.mod_words_ptr, stream), "field_prog")
    field_prog.launches += 1
    field_prog.shapes[(n, code.shape[0])] += 1
    return out


field_prog.launches = 0
field_prog.shapes = Counter()
