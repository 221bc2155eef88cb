"""G1 point folds: the CUDA kernels (csrc/ec_fold.cu) and their plain torch
versions.  Counterpart of halo2tpu/ops/pallas_ec.py:
fold_mixed (windowed row steps, table gather fused), fold_mixed_tiled (one
bit-serial row step) and fold_mixed_tiled_rows (all of msm()'s row steps in
one launch), fold_add (tile-aligned) and fold_add_any (one add kernel),
fold_add_tree (the MSM tails' halving rounds of that add), fold_horner (the
MSM Horner combine of halo2tpu/ops/msm.py), fold_dbl_any.

Layout: a point batch is (L, 3, 8) int32, lane-major — each thread of a
kernel loads its own 96 contiguous bytes.  The windowed table is
(W, npad, 3, 8): entry table[digit, base] is one affine point (Z =
Montgomery 1, or 0 for the identity entries: digit 0 and padded bases).

Each wrapper launches its kernel for CUDA tensors and takes the plain
version only for CPU tensors.  The plain versions are the curves/jpoint.py
formulas (plain field multiply), on any device; the plain version of an
entry that replaces a chain of launches is that chain.  Beside its count of
launches, each wrapper keeps `shapes`, a histogram of the shapes it
launched: (lanes, C, rows) for fold_mixed and fold_mixed_tiled_rows,
(lanes, times) for fold_dbl_any, (groups, width) for fold_add_tree,
(lanes, planes, times) for fold_horner, (lanes,) for the others.
"""
from __future__ import annotations

from collections import Counter

import torch

from ..curves import jpoint
from ..fields.jfield import FQ, u64

NLIMB = 8


def _check_points(name, *ts):
    for t in ts:
        if t.dtype != torch.int32 or t.dim() != 3 or t.shape[1:] != (3, NLIMB):
            raise ValueError(f"{name}: expected (L, 3, 8) int32 points, got "
                             f"{tuple(t.shape)} {t.dtype}")


def _launch_args(t):
    from .._build import lib
    return lib(), torch.cuda.current_stream(t.device).cuda_stream


def _on_cpu(*ts) -> bool:
    if all(t.device.type == "cpu" for t in ts):
        return True
    dev = ts[0].device
    if any(t.device != dev for t in ts) or dev.type != "cuda":
        raise ValueError(f"operands on {[str(t.device) for t in ts]}")
    return False


# -- fold_mixed: MSM row steps with the table gather fused in --------------

def window_digits(scalars, planes: int):
    """(B, C, 8) plain scalar limbs -> (planes, B, C) int64 8-bit digits
    (digit w = byte w of the little-endian scalar)."""
    s = u64(scalars)
    w = torch.arange(planes, device=scalars.device)
    words = s[..., w // 4]                             # (B, C, planes)
    digits = (words >> (8 * (w % 4))) & 0xFF
    return digits.permute(2, 0, 1)


def fold_mixed_plain(acc, table, scalars, C: int, planes: int, r0: int,
                     r1: int):
    """Plain version of fold_mixed: the same rows, one gather and one
    jpoint.padd_mixed per row."""
    npad = table.shape[1]
    L = acc.shape[0]
    lane = torch.arange(L, device=acc.device)
    c = lane % C
    for r in range(r0, r1):
        digs = window_digits(scalars[:, r * C:(r + 1) * C], planes)
        pts = table.reshape(-1, 3, NLIMB)[digs.reshape(-1) * npad + r * C + c]
        acc = jpoint.padd_mixed(acc, pts)
    return acc


def fold_mixed(acc, table, scalars, C: int, planes: int, r0: int, r1: int):
    """MSM row steps r in [r0, r1): lane l = g * C + c, g = plane * B + b,
    adds table[digit, r * C + c] where digit = byte `plane` of scalars[b,
    r * C + c].  acc (L, 3, 8) Jacobian, L = planes * B * C; table
    (W, npad, 3, 8) affine; scalars (B, npad, 8) plain limbs.  Lanes whose
    entry is the identity keep acc; acc == entry doubles; acc == -entry
    gives the identity (pallas_ec.py::_mixed_kernel lane rules)."""
    B, npad = scalars.shape[0], scalars.shape[1]
    _check_points("fold_mixed", acc)
    if table.dim() != 4 or table.shape[1:] != (npad, 3, NLIMB):
        raise ValueError(f"fold_mixed: table {tuple(table.shape)} does not "
                         f"match scalars {tuple(scalars.shape)}")
    if acc.shape[0] != planes * B * C or not (0 <= r0 <= r1 <= npad // C):
        raise ValueError("fold_mixed: lanes/rows do not match the shapes")
    if planes > 32 or scalars.shape[2] != NLIMB:
        raise ValueError("fold_mixed: at most 32 digit planes of 8 limbs")
    if _on_cpu(acc, table, scalars):
        return fold_mixed_plain(acc, table, scalars, C, planes, r0, r1)
    from .._build import check
    acc = acc.contiguous()
    table = table.contiguous()
    scalars = scalars.contiguous()
    if table.data_ptr() % 16:
        raise ValueError("fold_mixed: the table must be 16-byte aligned "
                         "(the kernel copies its entries in 16-byte pieces)")
    out = torch.empty_like(acc)
    lib, stream = _launch_args(acc)
    check(lib.h2_fold_mixed(acc.data_ptr(), out.data_ptr(), table.data_ptr(),
                            scalars.data_ptr(), acc.shape[0], C, B, npad, r0,
                            r1, FQ.mod_words_ptr, stream), "fold_mixed")
    fold_mixed.launches += 1
    fold_mixed.shapes[(acc.shape[0], C, r1 - r0)] += 1
    return out


fold_mixed.launches = 0
fold_mixed.shapes = Counter()


# -- fold_mixed_tiled: one bit-serial MSM row step --------------------------

def fold_mixed_tiled_plain(acc, pts_c, bits):
    """Plain version of fold_mixed_tiled: jpoint.padd_mixed over the bases
    broadcast to every lane, masked lanes given a Z = 0 point."""
    L, C = acc.shape[0], pts_c.shape[0]
    pts = pts_c.repeat(L // C, 1, 1)
    pts[:, 2] = torch.where((bits != 0)[:, None], pts[:, 2], 0)
    return jpoint.padd_mixed(acc, pts)


def fold_mixed_tiled(acc, pts_c, bits):
    """acc[l] += pts_c[l mod C] where bits[l] != 0: acc (L, 3, 8) Jacobian,
    pts_c (C, 3, 8) affine bases shared by every group of C lanes (C | L),
    bits (L,) uint8.  Lane rules of pallas_ec.py::_mixed_tiled_kernel:
    a zero bit or an identity base keeps acc, an identity acc takes the
    base, acc == -base gives the identity, acc == base doubles."""
    _check_points("fold_mixed_tiled", acc, pts_c)
    L, C = acc.shape[0], pts_c.shape[0]
    if C == 0 or L % C:
        raise ValueError(f"fold_mixed_tiled: C = {C} does not divide L = {L}")
    if bits.dtype != torch.uint8 or bits.shape != (L,):
        raise ValueError(f"fold_mixed_tiled: expected ({L},) uint8 bits, got "
                         f"{tuple(bits.shape)} {bits.dtype}")
    if _on_cpu(acc, pts_c, bits):
        return fold_mixed_tiled_plain(acc, pts_c, bits)
    from .._build import check
    acc = acc.contiguous()
    pts_c = pts_c.contiguous()
    bits = bits.contiguous()
    out = torch.empty_like(acc)
    lib, stream = _launch_args(acc)
    check(lib.h2_fold_mixed_tiled(acc.data_ptr(), out.data_ptr(),
                                  pts_c.data_ptr(), bits.data_ptr(), L, C,
                                  FQ.mod_words_ptr, stream),
          "fold_mixed_tiled")
    fold_mixed_tiled.launches += 1
    fold_mixed_tiled.shapes[(L,)] += 1
    return out


fold_mixed_tiled.launches = 0
fold_mixed_tiled.shapes = Counter()


def bit_masks(scalar_rows, nbits: int):
    """(B, C, 8) plain scalar limbs -> (nbits * B * C,) uint8 lane masks:
    lane (bit * B + b) * C + c holds bit `bit` of scalar [b, c]."""
    bit = torch.arange(nbits, device=scalar_rows.device)
    words = u64(scalar_rows)[..., bit // 32]              # (B, C, nbits)
    bits = (words >> (bit % 32)) & 1
    return bits.permute(2, 0, 1).reshape(-1).to(torch.uint8)


def fold_mixed_tiled_rows_plain(acc, points, scalars, C: int, r0: int,
                                r1: int):
    """Plain version of fold_mixed_tiled_rows: one fold_mixed_tiled_plain
    step a row, with that row's bit masks."""
    nbits = acc.shape[0] // (scalars.shape[0] * C)
    for r in range(r0, r1):
        acc = fold_mixed_tiled_plain(
            acc, points[r * C:(r + 1) * C],
            bit_masks(scalars[:, r * C:(r + 1) * C], nbits))
    return acc


def fold_mixed_tiled_rows(acc, points, scalars, C: int, r0: int, r1: int):
    """Bit-serial MSM rows r in [r0, r1) in one launch: lane l = (bit * B +
    b) * C + c adds points[r * C + c] where bit `bit` of scalars[b, r * C +
    c] is set.  acc (L, 3, 8) Jacobian, L = nbits * B * C (nbits <= 256);
    points (n, 3, 8) affine; scalars (B, n, 8) plain limbs.  Lane rules and
    row order of fold_mixed_tiled, one row after another."""
    _check_points("fold_mixed_tiled_rows", acc, points)
    L, n = acc.shape[0], points.shape[0]
    if scalars.dim() != 3 or scalars.shape[1:] != (n, NLIMB):
        raise ValueError(f"fold_mixed_tiled_rows: scalars "
                         f"{tuple(scalars.shape)} do not match {n} points")
    B = scalars.shape[0]
    if C <= 0 or n % C or B == 0 or L % (B * C) or L // (B * C) > 32 * NLIMB:
        raise ValueError(f"fold_mixed_tiled_rows: L = {L} is not nbits * B * "
                         f"C with nbits <= 256 (B = {B}, C = {C}, n = {n})")
    if not 0 <= r0 <= r1 <= n // C:
        raise ValueError(f"fold_mixed_tiled_rows: rows [{r0}, {r1}) outside "
                         f"[0, {n // C}]")
    if _on_cpu(acc, points, scalars):
        return fold_mixed_tiled_rows_plain(acc, points, scalars, C, r0, r1)
    from .._build import check
    acc = acc.contiguous()
    points = points.contiguous()
    scalars = scalars.contiguous()
    if points.data_ptr() % 16:
        raise ValueError("fold_mixed_tiled_rows: the points must be 16-byte "
                         "aligned (the kernel copies them in 16-byte pieces)")
    out = torch.empty_like(acc)
    lib, stream = _launch_args(acc)
    check(lib.h2_fold_mixed_tiled_rows(
        acc.data_ptr(), out.data_ptr(), points.data_ptr(),
        scalars.data_ptr(), L, C, B, n, r0, r1, FQ.mod_words_ptr, stream),
        "fold_mixed_tiled_rows")
    fold_mixed_tiled_rows.launches += 1
    fold_mixed_tiled_rows.shapes[(L, C, r1 - r0)] += 1
    return out


fold_mixed_tiled_rows.launches = 0
fold_mixed_tiled_rows.shapes = Counter()


# -- fold_add (tile-aligned entry) / fold_add_any / fold_dbl_any -----------

ADD_TILE = 512   # pallas_ec.py::TILE: fold_add takes whole tiles of lanes


def _launch_add(p, q, name):
    from .._build import check
    p = p.contiguous()
    q = q.contiguous()
    out = torch.empty_like(p)
    lib, stream = _launch_args(p)
    check(lib.h2_fold_add(p.data_ptr(), q.data_ptr(), out.data_ptr(),
                          p.shape[0], FQ.mod_words_ptr, stream), name)
    return out


def fold_add_plain(p, q):
    return jpoint.padd(p, q)


def fold_add(p, q):
    """Lanewise full Jacobian add over (L, 3, 8) with L % 512 == 0, the
    contract of pallas_ec.py::fold_add; the same add kernel as
    fold_add_any, with its own launch count."""
    _check_points("fold_add", p, q)
    if p.shape != q.shape:
        raise ValueError("fold_add: shape mismatch")
    if p.shape[0] % ADD_TILE:
        raise ValueError(f"fold_add: L = {p.shape[0]} is not a multiple of "
                         f"{ADD_TILE}")
    if _on_cpu(p, q):
        return fold_add_plain(p, q)
    out = _launch_add(p, q, "fold_add")
    fold_add.launches += 1
    fold_add.shapes[(p.shape[0],)] += 1
    return out


fold_add.launches = 0
fold_add.shapes = Counter()

fold_add_any_plain = fold_add_plain


def fold_add_any(p, q):
    """Lanewise full Jacobian add over (L, 3, 8), any L.  Whole 512-lane
    tiles go through fold_add and count there, as pallas_ec.py::fold_add_any
    launches the tile-aligned add itself."""
    _check_points("fold_add_any", p, q)
    if p.shape != q.shape:
        raise ValueError("fold_add_any: shape mismatch")
    if _on_cpu(p, q):
        return fold_add_any_plain(p, q)
    if p.shape[0] % ADD_TILE == 0:
        return fold_add(p, q)
    out = _launch_add(p, q, "fold_add_any")
    fold_add_any.launches += 1
    fold_add_any.shapes[(p.shape[0],)] += 1
    return out


fold_add_any.launches = 0
fold_add_any.shapes = Counter()


# -- fold_add_tree: the MSM tails -------------------------------------------

# Rounds of a tail with at least this many adds run as lanewise launches of
# the add kernel: 512 blocks of 128 threads, about one wave on an H100's
# 132 SMs (4 blocks an SM).  Smaller rounds go to fold_add_tree's kernel.
# At msm()'s tail (2032 groups of 256) two lanewise rounds and one tree
# launch beat one tree launch of all eight rounds, whose blocks hold one
# group each and leave most warps idle after the first round (measured on
# an H100).
ADD_WAVE = 1 << 16
TREE_LANES = 256   # lanes one block of the tree kernel sums: 128 threads
TREE_SLOTS = 4     # threads an add of a slot round

_TREE_COUNTERS: dict = {}
_TREE_WAVES: dict = {}


def tree_slot_limit(device) -> int:
    """A tree round runs each add on TREE_SLOTS threads when those fit in
    this many threads, else one add a thread: one wave of the add kernel
    on the card (SMs x 4 blocks x 128 threads, 67,584 on an H100)."""
    wave = _TREE_WAVES.get(device)
    if wave is None:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        wave = _TREE_WAVES[device] = sms * 4 * 128
    return wave


def tree_round_slots(G: int, width: int, limit: int) -> list:
    """For each round of a G x width tail in the tree kernel (round j adds
    G width / 2^(j+1) pairs), True where it runs an add on TREE_SLOTS
    threads, False where on one."""
    rounds = width.bit_length() - 1
    return [(G * width >> (j + 1)) * TREE_SLOTS <= limit
            for j in range(rounds)]


def _halve(acc, G: int, width: int, add):
    """One round: lane i + width/2 of each group added into lane i."""
    half = width // 2
    a4 = acc.reshape(G, width, 3, NLIMB)
    return add(a4[:, :half].reshape(G * half, 3, NLIMB),
               a4[:, half:].reshape(G * half, 3, NLIMB))


def fold_add_tree_plain(acc, G: int, width: int):
    """Plain version of fold_add_tree: the chain of lanewise rounds."""
    while width > 1:
        acc = _halve(acc, G, width, fold_add_any_plain)
        width //= 2
    return acc


def _tree_counters(G: int, device) -> torch.Tensor:
    """The tree kernel's per-group counters on `device`, zero between
    launches (the kernel zeroes what it counted)."""
    c = _TREE_COUNTERS.get(device)
    if c is None or c.numel() < G:
        c = torch.zeros(max(G, 1024), dtype=torch.int32, device=device)
        _TREE_COUNTERS[device] = c
    return c


def fold_add_tree(acc, G: int, width: int):
    """(G * width, 3, 8) -> (G, 3, 8): each group of `width` lanes (a power
    of two) summed by halving rounds, round j adding lane i + w/2 into lane
    i of the previous round's w lanes (the MSM tails).  Rounds of at least
    ADD_WAVE adds are lanewise fold_add_any launches (counted there); the
    rest (a width of at most 65,536 is left) run in one fold_add_tree
    launch, bitwise equal to the lanewise chain."""
    _check_points("fold_add_tree", acc)
    if (G <= 0 or width <= 0 or width & (width - 1)
            or acc.shape[0] != G * width):
        raise ValueError(f"fold_add_tree: {acc.shape[0]} lanes are not {G} "
                         f"groups of a power of two {width}")
    if _on_cpu(acc):
        return fold_add_tree_plain(acc, G, width)
    while width > 1 and G * width // 2 >= ADD_WAVE:
        acc = _halve(acc, G, width, fold_add_any)
        width //= 2
    if width == 1:
        return acc
    from .._build import check
    lib, stream = _launch_args(acc)
    acc = acc.contiguous()
    out = torch.empty((G, 3, NLIMB), dtype=acc.dtype, device=acc.device)
    partials = counters = None
    if width > TREE_LANES:
        partials = torch.empty((G * width // TREE_LANES, 3, NLIMB),
                               dtype=acc.dtype, device=acc.device)
        counters = _tree_counters(G, acc.device)
    check(lib.h2_fold_add_tree(
        acc.data_ptr(), out.data_ptr(),
        0 if partials is None else partials.data_ptr(),
        0 if counters is None else counters.data_ptr(), G, width,
        tree_slot_limit(acc.device), FQ.mod_words_ptr, stream),
        "fold_add_tree")
    fold_add_tree.launches += 1
    fold_add_tree.shapes[(G, width)] += 1
    return out


fold_add_tree.launches = 0
fold_add_tree.shapes = Counter()


# -- fold_horner: the MSM Horner combine ------------------------------------

def fold_horner_plain(partials, times: int):
    """Plain version of fold_horner: per plane, fold_dbl_any_plain `times`
    times, then fold_add_any_plain."""
    acc = jpoint.identity_points((partials.shape[0],), partials.device)
    for d in range(partials.shape[1] - 1, -1, -1):
        acc = fold_add_any_plain(fold_dbl_any_plain(acc, times),
                                 partials[:, d].contiguous())
    return acc


def fold_horner(partials, times: int):
    """(B, planes, 3, 8) -> (B, 3, 8): from the identity, top plane down,
    acc = 2^times * acc + partials[:, d], one thread a batch lane in one
    launch; bitwise equal to a fold_dbl_any(times) and a fold_add_any
    launch a plane (ops/msm.py's Horner combines: times = 8 over 32 digit
    planes, times = 1 over 254 bit planes)."""
    if partials.dim() != 4 or partials.shape[2:] != (3, NLIMB) or (
            partials.dtype != torch.int32):
        raise ValueError(f"fold_horner: expected (B, planes, 3, 8) int32 "
                         f"partials, got {tuple(partials.shape)} "
                         f"{partials.dtype}")
    if times < 1:
        raise ValueError(f"fold_horner: times = {times} < 1")
    if _on_cpu(partials):
        return fold_horner_plain(partials, times)
    from .._build import check
    partials = partials.contiguous()
    B, planes = partials.shape[0], partials.shape[1]
    out = torch.empty((B, 3, NLIMB), dtype=partials.dtype,
                      device=partials.device)
    lib, stream = _launch_args(partials)
    check(lib.h2_fold_horner(partials.data_ptr(), out.data_ptr(), B, planes,
                             times, FQ.mod_words_ptr, stream), "fold_horner")
    fold_horner.launches += 1
    fold_horner.shapes[(B, planes, times)] += 1
    return out


fold_horner.launches = 0
fold_horner.shapes = Counter()


def fold_dbl_any_plain(p, times: int = 1):
    for _ in range(times):
        p = jpoint.pdbl(p)
    return p


def fold_dbl_any(p, times: int = 1):
    """Lanewise Jacobian doubling over (L, 3, 8), any L, identity-safe,
    `times` times over (2^times * p) in one launch; bitwise equal to
    `times` chained doublings.  times=1 is pallas_ec.py::fold_dbl_any."""
    _check_points("fold_dbl_any", p)
    if times < 1:
        raise ValueError(f"fold_dbl_any: times = {times} < 1")
    if _on_cpu(p):
        return fold_dbl_any_plain(p, times)
    from .._build import check
    p = p.contiguous()
    out = torch.empty_like(p)
    lib, stream = _launch_args(p)
    check(lib.h2_fold_dbl(p.data_ptr(), out.data_ptr(), p.shape[0], times,
                          FQ.mod_words_ptr, stream), "fold_dbl_any")
    fold_dbl_any.launches += 1
    fold_dbl_any.shapes[(p.shape[0], times)] += 1
    return out


fold_dbl_any.launches = 0
fold_dbl_any.shapes = Counter()
